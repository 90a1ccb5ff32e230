"""Batched on-device self-play driver (port of selfplay.py:68-403).

G games advance in lockstep on one device: observation stacking, the MCTS
search, temperature action sampling, env step and auto-reset, for
`selfplay_chunk_moves` moves per `play` call (the JAX package's `scan` over
moves is a Python loop here). The host cuts the emitted per-move records
into complete `GameHistory` episodes at done boundaries.

The search is routed as the JAX driver routes it (`search_route`, decided
once per driver and kept in `SelfPlayDriver.search_route`): FC networks go to the fused
single-kernel search (ops/mcts_fused.py) unless `use_fused_search` is False
or, on the card, the search is too big for the kernel's shared memory;
everything else goes to the staged search (ops/mcts.py run_mcts), whose
descent and backprop run as kernels where SearchSpec.from_config engages
them: the planar kernels for trees that fit them (connect4), the stream
kernels for bigger ones (gomoku). `search_batch_leaves` > 1 runs the staged
search in multi-leaf rounds; FC networks on the fused search ignore it, as
the JAX driver's fused route does (JAX selfplay.py:99-113). A ResNet's batch
norms are folded into its convs once per play_chunk (`fold_bn_inference`),
the folded twin's activations in bfloat16 when `search_bf16_activations` is
on; the network computes at `compute_dtype`, as in the JAX driver.

Under `use_gumbel_mcts` every network runs the Gumbel search
(ops/gumbel.py run_gumbel_mcts) on the "staged" route, as the JAX driver
turns its fused search off under Gumbel (JAX selfplay.py:99-104): no kernel
runs on it. Its improved policy is the policy target; lanes play the
search's Gumbel-sampled action, or its greedy action past
`temperature_threshold` and at temperature 0 (JAX selfplay.py:181-197).
Exploration comes from the root Gumbel draw (gated by `add_noise`), drawn
from the driver's generator through `gumbel.sample_gumbel`, which tests
replace to inject the JAX driver's draws, as they replace
`mcts.sample_gamma` on the pUCT route.

Evaluation is folded in as greedy lanes: lanes [0, greedy_lanes) play at
temperature 0 inside the same batch and their episodes come back in
stats["eval_games"] (the reference's test-mode worker, self_play.py:54-90).

On a mesh (parallel/mesh.py; JAX selfplay.py:66-92, :280-325) the G lanes
split over dp: the rank at dp index i searches lanes [i * G/dp, (i+1) *
G/dp) on its own device, with its own generators (seeded seed + 100003 *
i, so the shards' games differ), and no collectives while it plays; its
mp peers (mp index > 0) search nothing. The greedy eval lanes are the
first lanes, on rank 0. After each play() the shards' games and stats
are gathered to rank 0, in lane order, so rank 0 returns what an
unsharded driver of G lanes returns; the other ranks return no games.
When dp does not divide G, self-play runs unsharded on rank 0, with JAX's
message.
"""

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.envs.core import where_state
from muzero_general_tpu_torch.models import activation_dtype, fold_bn
from muzero_general_tpu_torch.models.resnet import ResMuZero
from muzero_general_tpu_torch.ops import gumbel as gumbel_ops
from muzero_general_tpu_torch.ops import mcts as mcts_ops
from muzero_general_tpu_torch.ops import mcts_fused
from muzero_general_tpu_torch.ops.stacking import (
    push_history,
    reset_history,
    stack_observations,
)
from muzero_general_tpu_torch.parallel import distributed as dist_lib
from muzero_general_tpu_torch.replay import GameHistory


_log = logging.getLogger(__name__)

# Seed offset between the generators of two shards (and of two processes'
# self-play in multi-host training, JAX muzero.py:338).
SHARD_SEED_STRIDE = 100003


def shard_lanes(G, mesh):
    """(dp, lanes, first lane) of this rank's share of G lanes on `mesh`:
    G/dp lanes at dp_index * G/dp where dp divides G (mp index 0 only),
    else all G on rank 0 (JAX's message) and none elsewhere."""
    if mesh is None:
        return 1, G, 0
    dp = mesh.shape["dp"]
    if dp > 1 and G % dp:
        if mesh.rank == 0:
            print(f"[selfplay] parallel_games={G} not divisible by mesh dp={dp}; "
                  "running self-play unsharded.")
        dp = 1
    if mesh.mp_index != 0 or (dp == 1 and mesh.dp_index != 0):
        return dp, 0, 0
    return dp, G // dp, mesh.dp_index * (G // dp)


def idle_stats(K):
    """The play() stats of a rank that searches no lanes."""
    return {"env_steps": 0, "max_tree_depth": 0, "pred_values": np.zeros((K, 0), np.float32),
            "eval_games": []}


def gather_play(completed, stats, dp, G, K):
    """Merge the dp shards' play() results on rank 0, in lane order (JAX's
    records come back [K, G]-sharded, selfplay.py:321); the other ranks get
    no games and their own stats. `stats` None: a rank with no lanes."""
    if dp > 1:
        shards = dist_lib.gather_objects((completed, stats))
        if shards is not None:
            shards = [(c, st) for c, st in shards if st is not None]
            merged = dict(shards[0][1])
            merged.update(
                env_steps=K * G,
                max_tree_depth=max(st["max_tree_depth"] for _, st in shards),
                pred_values=np.concatenate([st["pred_values"] for _, st in shards], axis=-1))
            return [gh for c, _ in shards for gh in c], merged
        completed = []
    return completed, stats if stats is not None else idle_stats(K)


def search_route(config, device: torch.device) -> str:
    """"fused" or "staged", as the JAX driver routes (JAX selfplay.py:99-113).

    The fused single-kernel search takes FC networks (use_fused_search
    "auto" and True) whose search fits the kernel's shared memory
    (mcts_fused.fits_kernel) on the card; on the CPU its plain version has
    no such limit. False, every ResNet, FC searches too big for the kernel
    and the Gumbel search run staged."""
    fused = (
        config.network == "fullyconnected"
        and not config.use_gumbel_mcts
        and config.use_fused_search is not False
        and (device.type == "cpu" or mcts_fused.fits_kernel(config))
    )
    return "fused" if fused else "staged"


class SelfPlayCarry(NamedTuple):
    env_state: object  # batched env state [G, ...]
    obs_hist: torch.Tensor  # [G, n+1, C, H, W]
    act_hist: torch.Tensor  # [G, n+1] int32
    move_count: torch.Tensor  # [G] int32 moves played in current episode


class MoveRecord(NamedTuple):
    """Per-move emission, leading dims [K, G]."""

    observation: torch.Tensor  # [K, G, C, H, W] obs the move was taken from
    action: torch.Tensor  # [K, G]
    reward: torch.Tensor  # [K, G]
    done: torch.Tensor  # [K, G] bool — episode ended on this move
    to_play: torch.Tensor  # [K, G] player at the observation
    to_play_next: torch.Tensor  # [K, G] player at the post-move state
    child_visits: torch.Tensor  # [K, G, A]
    root_value: torch.Tensor  # [K, G]
    pred_value: torch.Tensor  # [K, G] network value at root
    max_tree_depth: torch.Tensor  # [K, G]


class SelfPlayDriver:
    """`G` lanes in all; `lanes` of them, from lane `lane0` on, searched by
    this rank (all G without a mesh)."""

    def __init__(self, env, network, config, num_games: Optional[int] = None,
                 seed: Optional[int] = None, greedy_lanes: int = 0, device=None, mesh=None):
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env is on {env.device}, driver on {self.device}")
        self.env = env
        self.network = network
        self.config = config
        self.G = num_games or config.parallel_games
        self.greedy_lanes = greedy_lanes
        self.mesh = mesh
        self.dp, self.lanes, self.lane0 = shard_lanes(self.G, mesh)
        self.spec = mcts_ops.SearchSpec.from_config(config, max(1, self.lanes), self.device)
        self.use_gumbel = bool(config.use_gumbel_mcts)
        if self.use_gumbel:
            self.gumbel_spec = gumbel_ops.GumbelSpec.from_config(config)
        self.search_route = search_route(config, self.device)
        self.use_fused = self.search_route == "fused"
        _log.info("self-play search route: %s (%s%s, %d simulations, %s)",
                  self.search_route, config.network, ", Gumbel" if self.use_gumbel else "",
                  config.num_simulations, self.device)
        if self.use_fused:
            self.fused_spec = mcts_fused.FusedSpec.from_config(config)
        # BN folding for the search path (ResNet only), once per play_chunk.
        self.fold_bn = (
            bool(getattr(config, "fold_bn_inference", True))
            and isinstance(network, ResMuZero)
        )
        self.act_dtype = activation_dtype(config)
        self.A = env.num_actions
        self._n = config.stacked_observations
        self._obs_shape = tuple(env.observation_shape)
        seed = config.seed if seed is None else seed
        if self.dp > 1:
            seed += SHARD_SEED_STRIDE * mesh.dp_index
        # Device draws (env resets, noise, action sampling) and the host draw
        # of each search's tie-jitter key, which needs no device sync.
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._seed_generator = torch.Generator().manual_seed(seed)
        self._carry = None
        # Per-lane lists of record slabs ([T, ...] arrays) awaiting a done cut
        self._pending = [[] for _ in range(self.lanes)]
        # Running reward of the greedy eval lane's in-progress episode
        self._eval_partial = 0.0

    def load_weights(self, state_dict):
        """Take a learner's weights: one load_state_dict into the driver's
        eval module, on its device. The next play_chunk folds or packs them
        for the search."""
        self.network.load_state_dict(state_dict)

    # ------------------------------------------------------------------
    def reset(self, start=None):
        """Start fresh episodes in every lane (`start`: optional explicit env
        start values for all G lanes, as env.reset takes them; a shard takes
        its lanes' rows)."""
        G, n = self.lanes, self._n
        if start is not None:
            start = start[self.lane0:self.lane0 + G]
        states = self.env.reset(G, self.generator, start)
        obs_hist = torch.zeros((G, n + 1) + self._obs_shape, device=self.device)
        obs_hist[:, 0] = self.env.observation(states)
        act_hist = torch.zeros((G, n + 1), dtype=torch.int32, device=self.device)
        move_count = torch.zeros((G,), dtype=torch.int32, device=self.device)
        self._carry = SelfPlayCarry(states, obs_hist, act_hist, move_count)
        self._pending = [[] for _ in range(G)]

    def _puct_move(self, carry, stacked, legal, to_play, temperature, add_noise, net):
        """The pUCT search of one move and its sampled actions: (policy
        target, action, search output)."""
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self._seed_generator))
        if self.use_fused:
            out = mcts_fused.run_mcts_fused(
                self.network, stacked, legal, to_play, self.generator,
                self.fused_spec, add_exploration_noise=add_noise, weights=net,
                seed=seed,
            )
        else:
            out = mcts_ops.run_mcts(
                net.initial_inference, net.recurrent_inference, stacked, legal,
                to_play, self.generator, self.spec,
                add_exploration_noise=add_noise, seed=seed,
            )
        policy_target = mcts_ops.visit_policy(out.root_visit_counts)
        # Per-lane temperature; drops to 0 after temperature_threshold moves
        # (reference self_play.py:151-157).
        action = mcts_ops.select_action(
            self.generator, out.root_visit_counts, legal, temperature
        )
        threshold = self.config.temperature_threshold
        if threshold:
            a_cold = mcts_ops.select_action(
                self.generator, out.root_visit_counts, legal, 0.0
            )
            action = torch.where(carry.move_count < threshold, action, a_cold)
        return policy_target, action, out

    def _one_move(self, carry, temperature, add_noise, net):
        """One move of every lane. `net`: the packed FusedWeights on the
        fused route, else the (folded) network the staged or Gumbel search
        runs."""
        env, config = self.env, self.config
        stacked = stack_observations(carry.obs_hist, carry.act_hist, self.A)
        legal = env.legal_actions_mask(carry.env_state)
        to_play = env.to_play(carry.env_state)
        if self.use_gumbel:
            out = gumbel_ops.run_gumbel_mcts(
                net.initial_inference, net.recurrent_inference, stacked, legal, to_play,
                self.generator, self.gumbel_spec, add_gumbel=add_noise,
            )
            policy_target = out.improved_policy
            # Exploration comes from the root Gumbel draw: lanes play the
            # search's action, or its greedy one past temperature_threshold
            # and at temperature 0 (JAX selfplay.py:181-197).
            threshold = config.temperature_threshold
            cold = temperature <= 0
            if threshold:
                cold = cold | (carry.move_count >= threshold)
            action = torch.where(cold, out.greedy_action, out.action)
        else:
            policy_target, action, out = self._puct_move(carry, stacked, legal, to_play,
                                                         temperature, add_noise, net)
        states2, reward, done = env.step(carry.env_state, action, self.generator)
        # Enforce max_moves so host episode cuts and env resets stay in
        # lockstep (reference self_play.py:129-131).
        done = done | (carry.move_count + 1 >= config.max_moves)
        record = MoveRecord(
            observation=carry.obs_hist[:, 0],
            action=action.to(torch.int32),
            reward=reward,
            done=done,
            to_play=to_play,
            to_play_next=env.to_play(states2),
            child_visits=policy_target,
            root_value=out.root_value,
            pred_value=out.root_predicted_value,
            max_tree_depth=out.max_tree_depth,
        )

        # Push history, then auto-reset finished lanes.
        obs_hist, act_hist = push_history(
            carry.obs_hist, carry.act_hist, env.observation(states2), action
        )
        fresh = env.reset(self.lanes, self.generator)
        states3 = where_state(done, fresh, states2)
        obs_hist, act_hist = reset_history(
            obs_hist, act_hist, env.observation(states3), done
        )
        move_count = torch.where(done, 0, carry.move_count + 1).to(torch.int32)
        return SelfPlayCarry(states3, obs_hist, act_hist, move_count), record

    @torch.no_grad()
    def play_chunk(self, temperature, num_moves: int, add_noise: bool = True):
        """Advance every lane `num_moves` moves; returns the MoveRecord
        ([K, G] tensors on the device). `temperature`: float or [G]."""
        if self._carry is None:
            self.reset()
        temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                      device=self.device)
        # The search's weights are prepared once per chunk, like the JAX
        # package's per-chunk fold: packed for the fused kernel, or the
        # ResNet's batch norms folded into its convs.
        if self.use_fused:
            net = mcts_fused.fused_weights(self.network, self.config.encoding_size)
        elif self.fold_bn:
            net = fold_bn(self.network, self.act_dtype)
        else:
            net = self.network
        records = []
        carry = self._carry
        for _ in range(num_moves):
            carry, record = self._one_move(carry, temperature, add_noise, net)
            records.append(record)
        self._carry = carry
        return MoveRecord(*(torch.stack(field) for field in zip(*records)))

    def play(self, temperature: float, num_moves: Optional[int] = None,
             add_noise: bool = True):
        """Advance all G games `num_moves` moves; return completed episodes.

        Returns (list[GameHistory], stats dict). Episodes of the greedy eval
        lanes (lane < greedy_lanes, played at temperature 0) are NOT in the
        returned list — they arrive in stats["eval_games"]. On a mesh rank 0
        returns every shard's (gather_play).
        """
        K = num_moves or self.config.selfplay_chunk_moves
        completed, stats = self._play_lanes(temperature, K, add_noise) if self.lanes else ([], None)
        return gather_play(completed, stats, self.dp, self.G, K)

    def _play_lanes(self, temperature, K, add_noise):
        """play() on this rank's lanes."""
        temp_vec = np.full((self.lanes,), temperature, np.float32)
        greedy = max(0, self.greedy_lanes - self.lane0)
        temp_vec[:greedy] = 0.0
        rec = self.play_chunk(torch.from_numpy(temp_vec), K, add_noise)
        rec = MoveRecord(*(field.cpu().numpy() for field in rec))

        completed = []
        eval_games = []
        stats = {
            "env_steps": K * self.lanes,
            "max_tree_depth": int(rec.max_tree_depth.max()),
            "pred_values": rec.pred_value,
            "eval_games": eval_games,
        }
        if greedy:
            done0 = np.flatnonzero(rec.done[:, 0])
            if done0.size:
                self._eval_partial = float(rec.reward[done0[-1] + 1 :, 0].sum())
            else:
                self._eval_partial += float(rec.reward[:, 0].sum())
            stats["eval_partial_reward"] = self._eval_partial
        for g in range(self.lanes):
            sink = eval_games if g < greedy else completed
            done_ks = np.flatnonzero(rec.done[:, g])
            start = 0
            for k in done_ks:
                self._pending[g].append(self._slab(rec, g, start, k + 1))
                sink.append(self._finish(g, rec.to_play_next[k, g]))
                start = k + 1
            if start < K:
                self._pending[g].append(self._slab(rec, g, start, K))
        return completed, stats

    @staticmethod
    def _slab(rec, g, a, b):
        return (
            rec.observation[a:b, g],
            rec.action[a:b, g],
            rec.reward[a:b, g],
            rec.to_play[a:b, g],
            rec.child_visits[a:b, g],
            rec.root_value[a:b, g],
        )

    def _finish(self, g, final_to_play) -> GameHistory:
        obs, act, rew, tp, cv, rv = (
            np.concatenate(parts) for parts in zip(*self._pending[g])
        )
        gh = GameHistory(
            observations=obs.astype(np.float32),
            actions=np.concatenate([[0], act]).astype(np.int32),
            rewards=np.concatenate([[0.0], rew]).astype(np.float32),
            to_play=np.concatenate([tp, [final_to_play]]).astype(np.int32),
            child_visits=cv.astype(np.float32),
            root_values=rv.astype(np.float32),
        )
        self._pending[g] = []
        return gh
