"""Host-path self-play driver for envs that cannot run on the device (port
of muzero_general_tpu/hostplay.py).

Same contract as selfplay.SelfPlayDriver (play() -> completed GameHistory
list + stats) but env transitions run on the host (envs/host.py: gymnasium,
Box2D, ALE, OpenSpiel) while the batched search for all N env instances
runs on the device each move (SURVEY.md §7 host/device split).

What of the JAX package's hostplay.py is where:
- the search (JAX :38-105) is ops/mcts.py `run_mcts` at
  `SearchSpec.from_config(config, batch_size=search_batch, device)`, where
  search_batch is the lanes one dispatch searches (G/2 under
  `host_pipeline`): on the card the planar descent and backprop kernels
  engage wherever the tree fits them, as JAX's Pallas gate does. A ResNet's
  batch norms are folded once per play() call (JAX folds them inside every
  dispatch; the weights, and so the fold, do not change within a call).
  The temperature-sampled action and the greedy one come from the same
  search (JAX :72-90);
- `_stacked`, `_dispatch`, `_host_phase` and `play` are JAX :107-250, with
  the same ring layout, episode cuts, `temperature_threshold` and
  `greedy_lanes`. Each dispatch packs its six outputs into one tensor and
  starts one copy of it to the host (JAX :159-162 pulls them in one
  device_get); on the card the copy lands in pinned memory behind a CUDA
  event, and the host phase waits on that event only, so under
  `host_pipeline` one half's search runs on the card while the host steps
  the other half's envs (CUDA launches are asynchronous, as JAX's jitted
  calls are). Nothing in a dispatch synchronizes the stream on the kernel
  route: the root noise and the kernels' tie-jitter keys are drawn on the
  host, and the inputs go to the card from pinned memory;
- randomness: JAX's PRNG key chain becomes a host torch.Generator (root
  noise, tie-jitter keys) and a device one (action sampling), both seeded
  with the driver's seed. `play(root_noise=...)` takes the root noise per
  dispatch instead (the tests inject JAX's Dirichlet draw).

The JAX driver shards its lanes over a dp mesh; the port runs on one
device, and a mesh with dp > 1 raises NotImplementedError (ROADMAP queue 1
item 9b).
"""

from typing import Optional

import numpy as np
import torch

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.models import activation_dtype, fold_bn
from muzero_general_tpu_torch.models.resnet import ResMuZero
from muzero_general_tpu_torch.ops import mcts as mcts_ops
from muzero_general_tpu_torch.replay import GameHistory


class HostSelfPlayDriver:
    def __init__(self, env_factory, network, config, num_games: Optional[int] = None,
                 seed: Optional[int] = None, mesh=None, greedy_lanes: int = 0, device=None):
        if mesh is not None and dict(getattr(mesh, "shape", {})).get("dp", 1) > 1:
            raise NotImplementedError(
                "sharding the host driver's lanes over a mesh is not ported yet "
                "(ROADMAP queue 1 item 9b)")
        self.device = resolve_device(device)
        self.config = config
        self.network = network
        self.G = num_games or config.parallel_games
        self.greedy_lanes = greedy_lanes
        base_seed = config.seed if seed is None else seed
        self.envs = [env_factory(seed=base_seed + i) for i in range(self.G)]
        env0 = self.envs[0]
        self.A = env0.num_actions
        self.obs_shape = tuple(env0.observation_shape)
        self.n = config.stacked_observations
        # `host_pipeline` splits an even fleet into two halves (JAX :38-47,
        # :193-199) that dispatch G/2-lane searches; the spec's kernel gate
        # sees the batch the device actually searches.
        self.pipelined = bool(config.host_pipeline) and self.G >= 2 and self.G % 2 == 0
        self.search_batch = self.G // 2 if self.pipelined else self.G
        self.spec = mcts_ops.SearchSpec.from_config(config, batch_size=self.search_batch,
                                                    device=self.device)
        # BN folding for the search (ResNet nets, e.g. atari), as selfplay.py.
        self.fold_bn = (bool(getattr(config, "fold_bn_inference", True))
                        and isinstance(network, ResMuZero))
        self.act_dtype = activation_dtype(config)
        self.generator = torch.Generator(device=self.device).manual_seed(base_seed)
        self.host_generator = torch.Generator().manual_seed(base_seed)
        self._pin = self.device.type == "cuda"

        # Rings: slot 0 = newest
        self._obs_hist = np.zeros((self.G, self.n + 1) + self.obs_shape, np.float32)
        self._act_hist = np.zeros((self.G, self.n + 1), np.int32)
        self._move_count = np.zeros(self.G, np.int32)
        self._records = [self._empty() for _ in range(self.G)]
        for g, env in enumerate(self.envs):
            self._obs_hist[g, 0] = env.reset()

    def load_weights(self, state_dict):
        """Take a learner's weights into the driver's eval module; the next
        play() folds them for the search."""
        self.network.load_state_dict(state_dict)

    def _empty(self):
        return {"obs": [], "act": [], "rew": [], "tp": [], "cv": [], "rv": []}

    def _host_tensor(self, shape, dtype=torch.float32):
        """A host tensor to fill and copy to the device: pinned on the card,
        so the copy runs asynchronously."""
        return torch.empty(shape, dtype=dtype, pin_memory=self._pin)

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, non_blocking=True)

    def _stacked(self, lo, hi):
        """Stack lanes [lo, hi)'s rings -> [hi-lo, C*(n+1)+n, H, W] (same
        layout as ops.stacking), into a host tensor."""
        obs, act = self._obs_hist[lo:hi], self._act_hist[lo:hi]
        B = hi - lo
        c, h, w = self.obs_shape
        parts = [obs[:, 0]]
        for k in range(1, self.n + 1):
            plane = np.broadcast_to(
                (act[:, k - 1, None, None, None] / self.A).astype(np.float32), (B, 1, h, w))
            parts.append(obs[:, k])
            parts.append(plane)
        out = self._host_tensor((B, c * (self.n + 1) + self.n, h, w))
        np.concatenate(parts, axis=1, out=out.numpy())
        return out

    @torch.no_grad()
    def _dispatch(self, net, lo, hi, temperature, add_noise, root_noise):
        """Build the [lo:hi) lane slice's inputs and launch its search,
        action selection and one copy of the packed outputs to the host
        (asynchronous on the card). Returns (host outputs, their CUDA event
        or None, to_play)."""
        B = hi - lo
        stacked = self._to_device(self._stacked(lo, hi))
        legal_np = np.stack([e.legal_actions_mask() for e in self.envs[lo:hi]])
        to_play = np.array([e.to_play() for e in self.envs[lo:hi]], np.int32)
        legal_h = self._host_tensor((B, self.A), torch.bool)
        legal_h.numpy()[...] = legal_np
        to_play_h = self._host_tensor((B,), torch.int32)
        to_play_h.numpy()[...] = to_play
        legal, to_play_t = self._to_device(legal_h), self._to_device(to_play_h)
        noise = None
        if add_noise:
            if root_noise is not None:
                noise = torch.from_numpy(np.array(root_noise(lo, hi), np.float32))
            else:
                noise = mcts_ops.sample_gamma(self.spec.dirichlet_alpha, (B, self.A),
                                              self.host_generator)
            if self._pin:
                noise = noise.pin_memory()
            noise = self._to_device(noise)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self.host_generator))
        out = mcts_ops.run_mcts(
            net.initial_inference, net.recurrent_inference, stacked, legal, to_play_t,
            self.generator, self.spec, add_exploration_noise=add_noise, root_noise=noise,
            seed=seed,
        )
        # One search per move: both the temperature-sampled action and the
        # greedy action (used past temperature_threshold, reference
        # self_play.py:151-157) come from the SAME search's visit counts.
        visits = out.root_visit_counts
        action = mcts_ops.select_action(self.generator, visits, legal, temperature)
        greedy = mcts_ops.select_action(self.generator, visits, legal, 0.0)
        packed = torch.cat([
            action[:, None].float(), greedy[:, None].float(), mcts_ops.visit_policy(visits),
            out.root_value[:, None].float(), out.root_predicted_value[:, None].float(),
            out.max_tree_depth[:, None].float()], dim=1)
        if not self._pin:
            return packed, None, to_play
        host = self._host_tensor(tuple(packed.shape))
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event, to_play

    def _host_phase(self, lo, hi, inflight, completed, eval_games):
        """Consume one half's finished search: select actions, step its envs,
        record, cut episodes. Returns (pv slice, max depth seen)."""
        host, event, to_play = inflight
        if event is not None:
            event.synchronize()  # this half's work only, not the other's
        out = host.numpy()
        A = self.A
        action = out[:, 0].astype(np.int64)
        greedy = out[:, 1].astype(np.int64)
        cv, rv, pv = out[:, 2:2 + A], out[:, 2 + A], out[:, 3 + A].copy()
        depth = out[:, 4 + A]
        tt = self.config.temperature_threshold
        if tt:
            # temperature 0 after the threshold (reference self_play.py:151-157)
            action = np.where(self._move_count[lo:hi] >= tt, greedy, action)
        if self.greedy_lanes:
            lanes = np.arange(lo, hi)
            action = np.where(lanes < self.greedy_lanes, greedy, action)

        for j, g in enumerate(range(lo, hi)):
            env = self.envs[g]
            obs_now = self._obs_hist[g, 0]
            obs2, reward, done = env.step(int(action[j]))
            p = self._records[g]
            p["obs"].append(obs_now.copy())
            p["act"].append(int(action[j]))
            p["rew"].append(float(reward))
            p["tp"].append(int(to_play[j]))
            p["cv"].append(cv[j].copy())
            p["rv"].append(float(rv[j]))
            self._move_count[g] += 1
            done = done or self._move_count[g] >= self.config.max_moves
            if done:
                sink = eval_games if g < self.greedy_lanes else completed
                sink.append(self._finish(g, env.to_play()))
                obs2 = env.reset()
                self._obs_hist[g] = 0
                self._act_hist[g] = 0
                self._move_count[g] = 0
            else:
                self._obs_hist[g, 1:] = self._obs_hist[g, :-1]
                self._act_hist[g, 1:] = self._act_hist[g, :-1]
                self._act_hist[g, 0] = action[j]
            self._obs_hist[g, 0] = obs2
        return pv, int(depth.max())

    def play(self, temperature: float, num_moves: Optional[int] = None,
             add_noise: bool = True, root_noise=None):
        """Same contract as SelfPlayDriver.play: greedy-lane episodes arrive
        in stats["eval_games"], never in the returned replay list.

        root_noise: optional callable (lo, hi) -> [hi - lo, A] Gamma draws
        of the Dirichlet root noise for one dispatch of lanes [lo, hi),
        called once per dispatch in dispatch order (default: drawn from the
        host generator).

        Double-buffered schedule (config.host_pipeline, opt-in): the env
        fleet is split in two halves, and while the device searches one
        half's batch the host steps the OTHER half's envs and assembles its
        next inputs — env transition time hides behind device search time
        instead of strictly alternating with it. Each lane still receives
        exactly one search per move with the same per-lane semantics; only
        the dispatch schedule changes.
        """
        K = num_moves or self.config.selfplay_chunk_moves
        completed = []
        eval_games = []
        max_depth_seen = 0
        halves = [(0, self.G // 2), (self.G // 2, self.G)] if self.pipelined else [(0, self.G)]
        net = fold_bn(self.network, self.act_dtype) if self.fold_bn else self.network

        def dispatch(lo, hi):
            return self._dispatch(net, lo, hi, temperature, add_noise, root_noise)

        # Prologue: one in-flight search per half.
        inflight = [dispatch(lo, hi) for lo, hi in halves]
        pv_parts = [None] * len(halves)
        for m in range(K):
            for h, (lo, hi) in enumerate(halves):
                pv, d = self._host_phase(lo, hi, inflight[h], completed, eval_games)
                pv_parts[h] = pv
                max_depth_seen = max(max_depth_seen, d)
                if m + 1 < K:
                    # Re-dispatch this half; the device overlaps it with the
                    # other half's host phase.
                    inflight[h] = dispatch(lo, hi)

        stats = {"env_steps": K * self.G, "max_tree_depth": max_depth_seen,
                 "pred_values": np.concatenate(pv_parts),
                 "eval_games": eval_games}
        if self.greedy_lanes:
            # Running reward of lane 0's in-progress eval episode (records
            # are cleared by _finish, so this is exactly the open episode).
            stats["eval_partial_reward"] = float(np.sum(self._records[0]["rew"]))
        return completed, stats

    def _finish(self, g, final_to_play) -> GameHistory:
        p = self._records[g]
        gh = GameHistory(
            observations=np.stack(p["obs"]).astype(np.float32),
            actions=np.concatenate([[0], p["act"]]).astype(np.int32),
            rewards=np.concatenate([[0.0], p["rew"]]).astype(np.float32),
            to_play=np.concatenate([p["tp"], [final_to_play]]).astype(np.int32),
            child_visits=np.stack(p["cv"]).astype(np.float32),
            root_values=np.asarray(p["rv"], np.float32),
        )
        self._records[g] = self._empty()
        return gh
