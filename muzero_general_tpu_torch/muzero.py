"""Orchestrator: the user-facing `MuZero` class, the training loop and the
CLI (port of muzero.py; reference muzero.py MuZero class :24-479, CLI menu
:622-712).

As in the JAX package, the reference's Ray actor fleet becomes one
synchronous loop: after each self-play chunk the learner catches up to
ratio * num_played_steps exactly, and SharedStorage is the 17-key
checkpoint dict held in the process. `device=None` means the CUDA card, and
without one `MuZero` raises unless the caller passes `device="cpu"`.

Several devices run as a mesh (parallel/), one process per device (a
rank), as PyTorch does it where JAX drives every device from one process:
- a device group of several devices (`devices`, or `split_resources_in`
  with `slice_index`), or mesh_dp/mesh_mp asking for more than one device
  of the fleet: train() spawns one rank per device of the mesh and returns
  rank 0's checkpoint (MuZero._train_on_ranks; JAX's single-process mesh,
  :244-313, :453-466);
- `distributed` (True: a launcher's environment; or a dict of
  parallel.distributed.initialize's arguments): this process is one rank
  of the multi-host layout (JAX :250-265, :326-350, :495-500, :571-581).
MuZero._train documents both layouts. A group of one device pins the
instance to it, as search.py uses it.

What of the JAX package's muzero.py is where:
- `two_player_reward_split` :40; `MuZero.__init__` :87-125, with
  `device` beside the JAX arguments (the device group :87-99 and the
  pinning of train/test :220-224, :758-763 are `self.device`);
  `_restore_state` :134-153 is a
  `trainer.Learner` restored by `checkpoint.restore_learner`; the
  checkpoint syncs :155-160 and :676-704 are `checkpoint.sync_state` and
  `checkpoint.sync_checkpoint`; `_make_driver` :163-175 (host envs get
  hostplay.HostSelfPlayDriver); `_reanalyse_sweep`
  :178-216 with the value function of :447-452; `train` is `train`/`_train`
  :219-753 and `test` is `test`/`_test` :756-808; `terminate_workers` :811;
  `load_model` :818-836; `load_model_menu` :862-882; `main` :885-939.
- Device replay (ops/device_replay.py) engages where JAX's does
  (:380-446): `device_replay` with `fused_train_steps` > 1, one process
  and no mesh. The completed games go to the ring on the card
  each loop in padded chunks of _DEV_K_PAD (:523-526); a train round of M
  steps then samples, trains and writes priorities back there (:594-606),
  and reanalyse mirrors its fresh values into the ring (:657-663). The
  host buffer keeps the counters, the checkpoints and reanalyse; its
  priorities are not written on that path, as in JAX.
- The Gumbel search (`use_gumbel_mcts`) runs in the self-play driver and in
  evaluate.py.
- `hyperparameter_search` :850-860 runs search.py's one_plus_one_search.
- `diagnose_model` :839-847 runs diagnose.py's DiagnoseModel on the
  checkpoint's weights.
"""

import copy
import functools
import json
import pathlib
import pickle
import socket
import sys
import time

import numpy as np
import torch

from muzero_general_tpu_torch import checkpoint as ckpt_lib
from muzero_general_tpu_torch import config as config_lib
from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.hostplay import HostSelfPlayDriver
from muzero_general_tpu_torch.logger import MetricsLogger
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax, params_to_jax
from muzero_general_tpu_torch.ops import device_replay as dr_lib
from muzero_general_tpu_torch.ops.support import support_to_scalar
from muzero_general_tpu_torch.parallel import distributed as dist_lib
from muzero_general_tpu_torch.parallel import mesh as mesh_lib
from muzero_general_tpu_torch.replay import GameHistory, ReplayBuffer
from muzero_general_tpu_torch.selfplay import SelfPlayDriver
from muzero_general_tpu_torch.trainer import Learner


def two_player_reward_split(gh: GameHistory, muzero_player: int):
    """MuZero-vs-opponent reward split (reference self_play.py:74-90)."""
    mz = sum(
        float(r)
        for i, r in enumerate(gh.rewards)
        if i > 0 and gh.to_play[i - 1] == muzero_player
    )
    opp = sum(
        float(r)
        for i, r in enumerate(gh.rewards)
        if i > 0 and gh.to_play[i - 1] != muzero_player
    )
    return mz, opp


def device_fleet(device=None):
    """The devices an instance may claim: every CUDA card (`cuda:i`), or
    the CPU when `device` asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return [torch.device("cpu")]
    resolve_device(device)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_group(devices=None, split_resources_in=1, slice_index=0, device=None):
    """The instance's device group (JAX muzero.py:94-99): `devices`, or the
    `slice_index`-th contiguous 1/split_resources_in slice of the fleet;
    None without either. One device pins the instance to it; several are
    the ranks of train()'s mesh, one rank a device (on the CPU a group may
    name the CPU more than once). The instance itself runs on the first."""
    if devices:
        group = [torch.device(d) for d in devices]
    elif split_resources_in > 1:
        fleet = device_fleet(device)
        per = max(1, len(fleet) // split_resources_in)
        lo = min(slice_index * per, len(fleet) - per)
        group = fleet[lo : lo + per]
    else:
        return None
    if len({d.type for d in group}) > 1:
        raise ValueError(f"a device group holds one kind of device, got {group}")
    want = torch.device(device) if device is not None else group[0]
    if want.type != group[0].type or want.index not in (None, group[0].index):
        raise ValueError(f"device={device} is not the device group's {group[0]}")
    return group


# The kernels the training loop's searches load (native/build.py).
SEARCH_KERNELS = ("mcts_fused", "mcts_kernels", "mcts_stream", "hidden_store")


def build_once(device):
    """Build the replay batch assembler and, for the card, the search
    kernels (one nvcc each, all together), so that ranks started after this
    only load them."""
    from muzero_general_tpu_torch.native import build

    build.build_replay_native()
    if device.type == "cuda":
        build.build_all(SEARCH_KERNELS)


def build_once_per_host(device):
    """Multi-host: the lowest rank on each host builds (build_once) while
    the others wait at a barrier."""
    import torch.distributed as dist

    host = socket.gethostname()
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, host)
    if hosts.index(host) == dist.get_rank():
        build_once(device)
    dist.barrier()


def _mesh_rank(game_name, config_cls, config_items, checkpoint, replay_state,
               log_in_tensorboard):
    """One rank of MuZero._train_on_ranks: the instance rebuilt from the
    config's items on the rank's device, trained. Rank 0 returns
    (checkpoint, phase_time), the others None."""
    config = config_cls()
    vars(config).update(config_items)
    mz = MuZero(game_name, config, device=dist_lib.device())
    mz.checkpoint, mz.replay_buffer_state = checkpoint, replay_state
    checkpoint = mz._train(log_in_tensorboard)
    return (checkpoint, mz.phase_time) if dist_lib.process_index() == 0 else None


# Completed games go to the device ring in chunks of this many (one padded
# save_games shape across loops; JAX muzero.py:388).
_DEV_K_PAD = 8


class DeviceRing:
    """Device replay in the training loop (JAX muzero.py:380-446): the ring
    on `device`, its fused train round for `learner` and its generator,
    seeded config.seed + 987654."""

    def __init__(self, config, learner, device):
        cfg = self.config = config
        self.device = device
        self.M = max(1, int(cfg.fused_train_steps))
        self.state = dr_lib.init_replay(int(cfg.replay_buffer_size), int(cfg.max_moves),
                                        tuple(cfg.observation_shape), len(cfg.action_space),
                                        device)
        self.train = dr_lib.make_device_train(learner, cfg, self.M)
        self.generator = torch.Generator(device=device).manual_seed(cfg.seed + 987654)

    def push(self, games):
        """Save completed host games into the ring (JAX :417-428)."""
        cfg = self.config
        for chunk, valid in dr_lib.pad_games_np(games, int(cfg.max_moves),
                                                tuple(cfg.observation_shape),
                                                len(cfg.action_space), _DEV_K_PAD):
            dr_lib.save_games(
                self.state, {k: torch.from_numpy(v).to(self.device) for k, v in chunk.items()},
                torch.from_numpy(valid).to(self.device), td_steps=cfg.td_steps,
                discount=cfg.discount, per_alpha=cfg.PER_alpha, use_per=bool(cfg.PER))

    def train_round(self):
        """M sampled batches, M learner steps, the write-backs: the last
        step's metrics."""
        return self.train(self.state, self.generator)

    def on_reanalysed(self, game_id, values):
        """Mirror a game's fresh root values into its slot, padded to
        max_moves, where the slot still holds it (JAX :434-446)."""
        padded = np.zeros((int(self.config.max_moves),), np.float32)
        padded[: len(values)] = values
        dr_lib.update_reanalysed_values(
            self.state, game_id % int(self.config.replay_buffer_size), game_id,
            torch.from_numpy(padded).to(self.device))


@torch.no_grad()
def reanalyse_values(network, observation, support_size):
    """The sweep's value function (JAX muzero.py:447-452): the decoded value
    of `initial_inference`, with the network in eval mode (batch norm on
    its running statistics). The network's mode is restored after."""
    training = network.training
    network.eval()
    try:
        return support_to_scalar(network.initial_inference(observation)[0], support_size)
    finally:
        network.train(training)


class MuZero:
    """Main class to manage MuZero (reference muzero.py:24-63 docstring API).

    Args:
        game_name: name of a module in muzero_general_tpu_torch/games.
        config: optional dict of overrides or a full MuZeroConfig instance.
        split_resources_in: claim only 1/N of the devices (device_group),
            so N instances can run at once (reference muzero.py:71-96,
            142-153; used by hyperparameter_search). Which 1/N contiguous
            slice is taken is `slice_index`.
        slice_index: which slice split_resources_in claims.
        devices: an explicit device group for this instance (overrides
            split_resources_in); search.py places concurrent experiments on
            disjoint groups this way. A group of several devices is the
            mesh train() runs on, one rank a device.
        distributed: multi-host training, this process one rank of it:
            True (a launcher's environment: MASTER_ADDR, MASTER_PORT,
            WORLD_SIZE, RANK, LOCAL_RANK) or a dict of
            parallel.distributed.initialize's arguments (coordinator_address,
            num_processes, process_id, local_device_ids, backend). Every
            rank constructs the same MuZero and calls train().
        device: the torch device everything runs on; None means the CUDA
            card (device.resolve_device). With a group, its first device;
            with `distributed`, the rank's ("cpu" runs the rank on the CPU).
    """

    def __init__(self, game_name, config=None, split_resources_in=1,
                 devices=None, slice_index=0, distributed=None, device=None):
        self._distributed = bool(distributed)
        if distributed:
            dist_lib.initialize_from_spec(distributed, device)
            device = dist_lib.device()
        self.game_name = game_name
        self._devices = device_group(devices, split_resources_in, slice_index, device)
        self.device = resolve_device(self._devices[0] if self._devices else device)
        game_module = config_lib.load_game_module(game_name)
        self.make_env = functools.partial(game_module.make_env, device=self.device)
        self.config = game_module.MuZeroConfig()

        if config:
            if isinstance(config, dict):
                config_lib.apply_overrides(self.config, config)
            else:
                self.config = config

        if self.config.results_path is None:
            self.config.results_path = self.config.default_results_path(game_name)
        # JSON/CLI overrides deliver results_path as a str.
        self.config.results_path = pathlib.Path(self.config.results_path)

        np.random.seed(self.config.seed)

        # The eval-mode network: self-play, evaluation and test() run it.
        self.network = MuZeroNetwork(self.config, self.device, seed=self.config.seed)
        self.checkpoint = ckpt_lib.initial_checkpoint()
        self.replay_buffer_state = None
        self.summary = str(self.network)
        # The initial weights, so the checkpoint is complete before training
        # (counterpart of reference CPUActor.get_initial_weights, muzero.py:120-122).
        self.checkpoint["weights"] = params_to_jax(self.network)
        # The last train() run's per-phase wall clock, in seconds, and its
        # device ring (None without device replay).
        self.phase_time = None
        self.device_ring = None

    # ------------------------------------------------------------------
    def _restore_state(self) -> Learner:
        """A learner holding the checkpoint's weights, optimizer state (if
        any) and training_step (JAX muzero.py:134-153)."""
        learner = Learner(self.config, self.device, seed=self.config.seed)
        ckpt_lib.restore_learner(learner, self.checkpoint)
        return learner

    def _make_driver(self, network, num_games=None, seed=None, mesh=None, greedy_lanes=0):
        """The device driver for device envs, the host driver otherwise (JAX
        muzero.py:163-175); `mesh` splits its lanes over dp."""
        env = self.make_env()
        if getattr(env, "host_env", False):
            return HostSelfPlayDriver(self.make_env, network, self.config, num_games=num_games,
                                      seed=seed, mesh=mesh, greedy_lanes=greedy_lanes,
                                      device=self.device)
        return SelfPlayDriver(env, network, self.config, num_games=num_games, seed=seed,
                              greedy_lanes=greedy_lanes, device=self.device, mesh=mesh)

    # ------------------------------------------------------------------
    def _reanalyse_sweep(self, replay, network, on_update=None):
        """Batched value refresh (reference Reanalyse actor,
        replay_buffer.py:328-373, re-designed as scheduled sweeps).

        Refreshes up to config.reanalyse_games_per_interval games round-robin
        with `network`'s values, in chunks of reanalyse_chunk_positions
        positions (the last one not padded: nothing is compiled).
        on_update(game_id, values) sees each refreshed game's values (device
        replay mirrors them into its ring). Returns the number of games
        refreshed.
        """
        picked, lengths, blocks = self._reanalyse_blocks(replay)
        values = [self._values(network, block) for block in blocks]
        return self._write_reanalysed(replay, picked, lengths, values, on_update)

    def _reanalyse_sweep_mesh(self, replay, learner, mesh):
        """The sweep on the single-process mesh (JAX :456-466): rank 0 picks
        the games (its replay holds them all) and scatters each chunk, a dp
        share of its rows to each rank where dp divides
        reanalyse_chunk_positions, else the whole chunk to every rank; each
        rank runs the learner's network on its rows, and rank 0 writes the
        gathered values back. Every rank must call it; rank 0 returns the
        number of games refreshed."""
        cfg = self.config
        n_proc, is_main = dist_lib.process_count(), dist_lib.process_index() == 0
        dp = mesh.shape["dp"] if int(cfg.reanalyse_chunk_positions) % mesh.shape["dp"] == 0 else 1
        mp = mesh.shape["mp"]
        parts = picked = lengths = None
        if is_main:
            picked, lengths, blocks = self._reanalyse_blocks(replay)
            parts = [[np.array_split(block, dp)[r // mp % dp] for block in blocks]
                     for r in range(n_proc)]
        mine = dist_lib.scatter_objects(parts)
        shards = dist_lib.gather_objects([self._values(learner.network, b) for b in mine])
        if not is_main:
            return 0
        values = [np.concatenate(rows) for rows in zip(*shards[: dp * mp : mp])]
        return self._write_reanalysed(replay, picked, lengths, values)

    def _reanalyse_blocks(self, replay):
        """The games the sweep refreshes, their position counts and their
        observations in chunks: (picked, lengths, [block [<= chunk, ...]])."""
        cfg = self.config
        picked = replay.reanalyse_pick(cfg.reanalyse_games_per_interval)
        if not picked:
            return [], [], []
        chunk = int(cfg.reanalyse_chunk_positions)
        obs_parts = [replay.reanalyse_observations(gh) for _, gh in picked]
        all_obs = np.concatenate(obs_parts)
        return picked, [len(o) for o in obs_parts], [
            all_obs[start : start + chunk] for start in range(0, all_obs.shape[0], chunk)]

    def _values(self, network, block):
        block = torch.from_numpy(block).to(self.device)
        return reanalyse_values(network, block, self.config.support_size).cpu().numpy()

    def _write_reanalysed(self, replay, picked, lengths, values, on_update=None):
        out = np.concatenate(values) if values else np.empty((0,), np.float32)
        off = 0
        for (gid, _), length in zip(picked, lengths):
            replay.update_reanalysed_values(gid, out[off : off + length])
            if on_update is not None:
                on_update(gid, out[off : off + length])
            off += length
        return len(picked)

    # ------------------------------------------------------------------
    def _mesh_devices(self):
        """The devices a mesh of this instance spans: its device group, or
        every device of its kind (device_fleet)."""
        return self._devices or device_fleet(self.device)

    def train(self, log_in_tensorboard=True):
        """Synchronous actor-learner training (reference muzero.py:132-208;
        JAX train/_train). Returns the checkpoint dict.

        One process without `distributed`: when the config's mesh
        (mesh_dp x mesh_mp, over the device group or the fleet; JAX
        mesh.py:131-155) spans more than one device, train() starts one
        rank per device of the mesh (_train_on_ranks) and returns rank 0's
        checkpoint; else it trains here, on one device. With `distributed`
        this process is one rank of the multi-host layout (see _train).
        """
        if dist_lib.process_count() == 1:
            shape = mesh_lib.mesh_shape(self.config, len(self._mesh_devices()))
            if shape is not None:
                return self._train_on_ranks(shape, log_in_tensorboard)
        return self._train(log_in_tensorboard)

    def _train_on_ranks(self, shape, log_in_tensorboard):
        """The single-process mesh (JAX's one process over a dp x mp mesh):
        one spawned rank per device of the mesh, meeting over a local TCP
        store. The kernels are built here first, so the ranks only load
        them. The instance's checkpoint (and network) become rank 0's."""
        dp, mp = shape
        devices = self._mesh_devices()[: dp * mp]
        build_once(devices[0])
        fresh = type(self.config)()
        items = {}
        for key, value in vars(self.config).items():
            try:
                pickle.dumps(value)
            except (pickle.PicklingError, AttributeError, TypeError) as err:
                # A game's own callable (lunarlander's ratio) is rebuilt
                # with the config in each rank; another cannot be sent.
                if getattr(value, "__code__", None) is not getattr(
                        getattr(fresh, key, None), "__code__", False):
                    raise ValueError(f"config.{key} cannot be sent to the mesh's ranks") from err
                continue
            items[key] = value
        results = dist_lib.launch(
            _mesh_rank, devices, self.game_name, type(self.config), items, self.checkpoint,
            self.replay_buffer_state, log_in_tensorboard)
        self.checkpoint, self.phase_time = results[0]
        self.network.load_state_dict(params_from_jax(self.checkpoint["weights"]))
        return self.checkpoint

    def _train(self, log_in_tensorboard=True):
        """The training loop of one process (JAX _train :230-753).

        Its layouts (JAX :244-350):
        - one device: everything here, as in JAX without a mesh;
        - a rank of the single-process mesh (`_train_on_ranks`): rank 0
          holds the one replay buffer, samples each global batch and
          scatters its rows to the ranks; self-play's G lanes split over
          dp and their games gather on rank 0; the reanalyse sweep's chunks
          split over dp where dp divides reanalyse_chunk_positions; rank 0
          decides STOP and the counters; only rank 0 logs, evaluates
          against an opponent and writes files. Device replay is off, as
          JAX's is under a mesh;
        - a rank of the multi-host layout (`distributed`): every rank plays
          its own parallel_games lanes, seeded seed + 100003 * rank, into
          its own replay buffer, which samples batch_size / n rows of each
          global batch; STOP, the played counters and buffer_ready are
          summed over the ranks (global_sum); rank 0 alone logs and writes.
        On a mesh whose dp does not divide batch_size, every rank takes the
        same unsharded step on the whole batch (JAX's message).
        """
        cfg = self.config
        cfg.results_path.mkdir(parents=True, exist_ok=True)
        n_proc = dist_lib.process_count()
        rank = dist_lib.process_index()
        is_main = rank == 0
        multi_host = n_proc > 1 and self._distributed
        spawned = n_proc > 1 and not multi_host

        learner = self._restore_state()

        mesh = None
        if multi_host:
            build_once_per_host(self.device)
            if int(getattr(cfg, "mesh_mp", 1) or 1) > 1:
                raise NotImplementedError(
                    "multi-host training requires mesh_mp=1 (params must be "
                    "fully replicated so hosts can read them locally)"
                )
            if cfg.batch_size % n_proc:
                raise ValueError(
                    f"batch_size={cfg.batch_size} not divisible by "
                    f"{n_proc} processes"
                )
            mesh = mesh_lib.mesh_from_config(cfg)
            if mesh is None or mesh.size != n_proc:
                raise ValueError(f"the mesh {mesh} must span all {n_proc} ranks")
        elif spawned:
            mesh = mesh_lib.create_mesh(*mesh_lib.mesh_shape(cfg, n_proc))
        train_mesh = (
            mesh if mesh is not None and cfg.batch_size % mesh.shape["dp"] == 0 else None
        )
        if mesh is not None and train_mesh is None and is_main:
            print(
                f"[train] batch_size={cfg.batch_size} not divisible by mesh "
                f"dp={mesh.shape['dp']}; training runs unsharded."
            )
        if train_mesh is not None:
            mesh_lib.shard_train_state(learner, train_mesh)

        # Evaluation rides lane 0 of the self-play driver at temperature 0
        # (the reference's test-mode worker, self_play.py:54-90); 2-player
        # games against a scripted opponent play a separate evaluation game
        # every few loops instead.
        needs_self_test_lane = not (
            len(cfg.players) > 1 and cfg.opponent not in (None, "self")
        )
        # Multi-host: self-play stays on this rank's device, seeded per
        # process so the ranks explore independently (JAX :326-339).
        driver = self._make_driver(
            self.network, seed=cfg.seed + 100003 * rank if multi_host else cfg.seed,
            mesh=mesh if spawned else None,
            greedy_lanes=1 if needs_self_test_lane else 0,
        )

        # Multi-host: each rank's replay holds its own games and gives a
        # 1/n_proc share of every global batch (JAX :345-350).
        replay_cfg = cfg
        if multi_host:
            replay_cfg = copy.copy(cfg)
            replay_cfg.batch_size = cfg.batch_size // n_proc
        if self.replay_buffer_state is not None:
            replay = ReplayBuffer(
                replay_cfg,
                self.replay_buffer_state["buffer"],
                self.replay_buffer_state["num_played_games"],
                self.replay_buffer_state["num_played_steps"],
            )
        else:
            replay = ReplayBuffer(replay_cfg)

        logger = (
            MetricsLogger(cfg.results_path, cfg, self.summary)
            if log_in_tensorboard and is_main else None
        )

        prefetcher = None
        if cfg.batch_prefetch and (is_main or multi_host):
            from muzero_general_tpu_torch.prefetch import BatchPrefetcher

            prefetcher = BatchPrefetcher(replay, depth=max(2, int(cfg.fused_train_steps)))

        def next_batches(n):
            if prefetcher is not None:
                return prefetcher.take(n)
            return [replay.get_batch() for _ in range(n)]

        def rank_rows(batch, axis):
            """The single-process mesh: scatter rank 0's global batch (on
            `axis`), each rank its dp index's rows (all of it unsharded)."""
            parts = None
            if is_main and train_mesh is None:
                parts = [batch] * n_proc
            elif is_main:
                mp = train_mesh.shape["mp"]
                split = {k: np.split(v, train_mesh.shape["dp"], axis=axis)
                         for k, v in batch.items()}
                parts = [{k: v[r // mp] for k, v in split.items()} for r in range(n_proc)]
            return dist_lib.scatter_objects(parts)

        M = max(1, int(cfg.fused_train_steps))
        # Device replay where JAX engages it (muzero.py:389-395: one process
        # and no mesh): the train round samples, trains and writes its
        # priorities back on the card.
        ring = (DeviceRing(cfg, learner, self.device)
                if getattr(cfg, "device_replay", False) and M > 1 and n_proc == 1 else None)
        self.device_ring = ring

        training_step = self.checkpoint["training_step"]
        if is_main:
            where = f"{n_proc} ranks on {mesh}" if mesh is not None else str(self.device)
            print(f"\nTraining {self.game_name} on {where}...\n")
        # Cooperative shutdown: the reference polls a `terminate` flag in
        # SharedStorage (muzero.py:352-353); here `touch <results_path>/STOP`
        # requests a graceful exit with a final checkpoint.
        stop_file = cfg.results_path / "STOP"
        t_start = time.time()
        phase_time = {"selfplay": 0.0, "test": 0.0, "train": 0.0,
                      "reanalyse": 0.0, "batch": 0.0, "checkpoint": 0.0}
        self.phase_time = phase_time
        loop_counter = 0
        # The checkpoint is synced at most once a loop, whenever
        # checkpoint_interval steps have passed since the last sync.
        last_ckpt_step = training_step
        last_metrics = None
        profiler = None
        try:
            while training_step < cfg.training_steps:
                stop = bool(self.checkpoint["terminate"] or stop_file.exists())
                if multi_host:
                    # A STOP on any rank stops them all together: a
                    # straggler would hang in the next all_reduce.
                    stop = dist_lib.global_sum(stop) > 0
                elif spawned:
                    stop = dist_lib.broadcast_object(stop)
                if stop:
                    break
                loop_counter += 1
                if cfg.profile_dir and loop_counter == 20 and is_main:
                    profiler = _start_profile(self.device)
                if cfg.profile_dir and loop_counter == 25 and profiler is not None:
                    _stop_profile(profiler, cfg.profile_dir)
                    profiler = None
                # The weights the loop starts with go to self-play (and, as
                # the driver runs self.network, to this loop's evaluation).
                driver.load_weights(learner.full_state_dict())
                temperature = cfg.visit_softmax_temperature_fn(training_step)

                # ---- self-play chunk (all G lanes advance K moves) -------
                t0 = time.time()
                games, stats = driver.play(temperature)
                phase_time["selfplay"] += time.time() - t0
                for gh in games:
                    replay.save_game(gh)
                if ring is not None and games:
                    ring.push(games)

                # ---- evaluation (reference test_mode worker) --------------
                t0 = time.time()
                use_opponent = (
                    len(cfg.players) > 1
                    and cfg.opponent not in (None, "self")
                    and cfg.opponent != "human"
                    and (is_main or multi_host)
                )
                test_games = stats.get("eval_games", [])
                eval_every = max(1, int(getattr(cfg, "eval_interval_loops", 4)))
                if use_opponent and loop_counter % eval_every == 1 % eval_every:
                    from muzero_general_tpu_torch.evaluate import play_against_opponent

                    test_games = [
                        play_against_opponent(
                            self.make_env(), self.network, cfg, cfg.opponent,
                            cfg.muzero_player,
                            seed=cfg.seed + cfg.num_workers + loop_counter,
                        )
                    ]
                phase_time["test"] += time.time() - t0
                for gh in test_games:
                    self.checkpoint["total_reward"] = float(gh.rewards.sum())
                    self.checkpoint["episode_length"] = len(gh)
                    vals = [v for v in gh.root_values if v]
                    self.checkpoint["mean_value"] = float(np.mean(vals)) if vals else 0
                    if len(cfg.players) > 1:
                        mz, opp = two_player_reward_split(gh, cfg.muzero_player)
                        self.checkpoint["muzero_reward"] = mz
                        self.checkpoint["opponent_reward"] = opp

                # ---- learner catches up to the exact ratio ----------------
                # config.ratio may be a callable schedule of the number of
                # self-played games (reference games/lunarlander.py:109).
                # With several ranks every rank derives the same target, so
                # they run the same steps and meet in each all_reduce.
                played_games = replay.num_played_games
                played_steps = replay.num_played_steps
                buffer_ready = bool(replay.buffer)
                if multi_host:
                    played_games = dist_lib.global_sum(played_games)
                    played_steps = dist_lib.global_sum(played_steps)
                    buffer_ready = dist_lib.global_sum(buffer_ready) == n_proc
                elif spawned:
                    played_games, played_steps, buffer_ready = dist_lib.broadcast_object(
                        (played_games, played_steps, buffer_ready))
                ratio = (
                    cfg.ratio(played_games)
                    if callable(cfg.ratio)
                    else (cfg.ratio if cfg.ratio else 1.0)
                )
                target = min(cfg.training_steps, int(ratio * played_steps))
                pending_priorities = []
                while training_step < target and buffer_ready:
                    t0 = time.time()
                    prev_step = training_step
                    if ring is not None and target - training_step >= M > 1:
                        # Device replay: sampling, M steps and the
                        # write-backs on the card, no host batches.
                        phase_time["batch"] += time.time() - t0
                        t0 = time.time()
                        metrics = ring.train_round()
                        training_step += M
                    elif target - training_step >= M > 1:
                        # Fused path: M batches, one call.
                        index_batches, batches = None, None
                        if is_main or multi_host:
                            parts = next_batches(M)
                            index_batches = [ib for ib, _ in parts]
                            batches = {k: np.stack([b[k] for _, b in parts])
                                       for k in parts[0][1]}
                        if spawned:
                            batches = rank_rows(batches, 1)
                        phase_time["batch"] += time.time() - t0
                        t0 = time.time()
                        metrics, priorities_m = learner.train_steps(batches)
                        training_step += M
                        if cfg.PER:
                            pending_priorities.append((priorities_m, index_batches))
                    else:
                        index_batch, batch = None, None
                        if is_main or multi_host:
                            index_batch, batch = next_batches(1)[0]
                        if spawned:
                            batch = rank_rows(batch, 0)
                        phase_time["batch"] += time.time() - t0
                        t0 = time.time()
                        metrics, priorities = learner.train_step(batch)
                        training_step += 1
                        if cfg.PER:
                            pending_priorities.append((priorities[None], [index_batch]))
                    if cfg.PER and len(pending_priorities) >= 4:
                        self._write_priorities(replay, pending_priorities, spawned, train_mesh)
                    phase_time["train"] += time.time() - t0
                    t0 = time.time()
                    if (
                        cfg.use_last_model_value
                        and (training_step // cfg.reanalyse_interval)
                        > (prev_step // cfg.reanalyse_interval)
                        and buffer_ready
                    ):
                        if spawned:
                            n = self._reanalyse_sweep_mesh(replay, learner, mesh)
                        else:
                            n = self._reanalyse_sweep(
                                replay, learner.network,
                                on_update=ring.on_reanalysed if ring is not None else None)
                        self.checkpoint["num_reanalysed_games"] += n
                    phase_time["reanalyse"] += time.time() - t0
                    last_metrics = metrics
                if cfg.PER:
                    self._write_priorities(replay, pending_priorities, spawned, train_mesh)

                # ---- checkpoint sync (once per loop at most) --------------
                t0 = time.time()
                if last_metrics is not None and (
                    training_step // cfg.checkpoint_interval
                ) > (last_ckpt_step // cfg.checkpoint_interval):
                    # The losses and lr of the last step, training_step,
                    # weights, optimizer state, played counters (gathered
                    # whole on a mesh: every rank syncs).
                    ckpt_lib.sync_checkpoint(self.checkpoint, learner, replay)
                    if cfg.save_model and is_main:
                        ckpt_lib.save_checkpoint(
                            self.checkpoint, cfg.results_path / "model.checkpoint"
                        )
                        si = getattr(cfg, "snapshot_interval", None)
                        if si and (training_step // si) > (last_ckpt_step // si):
                            # Numbered snapshot for offline strength retests.
                            step_tag = (training_step // si) * si
                            ckpt_lib.save_checkpoint(
                                self.checkpoint,
                                cfg.results_path / f"model_{step_tag:06d}.checkpoint",
                            )
                    last_ckpt_step = training_step
                phase_time["checkpoint"] += time.time() - t0

                self.checkpoint["training_step"] = training_step
                self.checkpoint["num_played_games"] = int(played_games)
                self.checkpoint["num_played_steps"] = int(played_steps)
                if logger:
                    logger.log(self.checkpoint)
                    if loop_counter % 20 == 0:
                        logger.write({"phase_time_s": phase_time})
                dt = max(1e-9, time.time() - t_start)
                # "Last test reward" is the last completed eval episode; the
                # open eval episode's running reward is shown beside it.
                partial = stats.get("eval_partial_reward")
                partial_s = f" (open eval: {partial:.2f})." if partial is not None else ""
                if is_main:
                    print(
                        f'Last test reward: {self.checkpoint["total_reward"]:.2f}.'
                        f"{partial_s} "
                        f"Training step: {training_step}/{cfg.training_steps}. "
                        f"Played games: {int(played_games)}. "
                        f'Loss: {self.checkpoint["total_loss"]:.2f}. '
                        f"Train steps/s: {training_step / dt:.1f}. "
                        f"Env steps/s: {played_steps / dt:.0f}",
                        end="\r",
                    )
        except KeyboardInterrupt:
            pass
        finally:
            if prefetcher is not None:
                prefetcher.stop()
            if profiler is not None:
                _stop_profile(profiler, cfg.profile_dir)

        # Final persist (reference muzero.py:334-346, 348-367): weights,
        # optimizer state and counters; the losses stay those of the last
        # checkpoint interval, as in JAX. Every rank syncs; rank 0 writes.
        self.checkpoint["training_step"] = training_step
        ckpt_lib.sync_state(self.checkpoint, learner, replay)
        if cfg.save_model and is_main:
            ckpt_lib.save_checkpoint(self.checkpoint, cfg.results_path / "model.checkpoint")
            ckpt_lib.save_replay_buffer(
                replay, self.checkpoint, cfg.results_path / "replay_buffer.pkl"
            )
        if logger:
            logger.close()
        if is_main:
            print()
        return self.checkpoint

    def _write_priorities(self, replay, pending, spawned, train_mesh):
        """Write pending training priorities back into the replay buffer
        (JAX muzero.py:635-640, :669-673). The single-process mesh gathers
        the ranks' rows on rank 0 first; a multi-host rank writes its own
        rows into its own buffer."""
        if spawned and train_mesh is not None:
            shards = dist_lib.gather_objects([pr.cpu().numpy() for pr, _ in pending])
            mp = train_mesh.shape["mp"]
            if shards is not None:
                pending[:] = [(torch.from_numpy(np.concatenate(rows, axis=1)), ibs)
                              for rows, (_, ibs) in zip(zip(*shards[::mp]), pending)]
        if dist_lib.process_index() == 0 or not spawned:
            _flush_priorities(replay, pending)
        pending.clear()

    # ------------------------------------------------------------------
    def test(self, render=False, opponent=None, muzero_player=None, num_tests=1,
             num_gpus=0):
        """Greedy evaluation of the checkpoint's weights (reference
        muzero.py:369-424): the mean reward over num_tests games, MuZero's
        own share in two-player games.

        opponent in {"self", "random", "expert", "human"}. "self" plays
        through a one-lane self-play driver at temperature 0 (on an FC net,
        the fused search at G = 1), the others through
        evaluate.play_against_opponent. num_gpus is kept for API parity.
        """
        cfg = self.config
        opponent = opponent or cfg.opponent or "self"
        muzero_player = muzero_player if muzero_player is not None else cfg.muzero_player
        env = self.make_env()
        self.network.load_state_dict(params_from_jax(self.checkpoint["weights"]))

        if opponent != "self":
            from muzero_general_tpu_torch.evaluate import play_against_opponent

            results = [
                play_against_opponent(
                    env, self.network, cfg, opponent, muzero_player,
                    seed=cfg.seed + i, render=render,
                )
                for i in range(num_tests)
            ]
        else:
            driver = self._make_driver(self.network, num_games=1, seed=cfg.seed)
            results = []
            while len(results) < num_tests:
                games, _ = driver.play(0.0)
                results.extend(games)
            results = results[:num_tests]

        if len(cfg.players) == 1:
            result = float(np.mean([gh.rewards.sum() for gh in results]))
        else:
            result = float(
                np.mean([two_player_reward_split(gh, muzero_player)[0] for gh in results])
            )
        print(f"\nTest results: {result:.2f} (mean over {num_tests} games)")
        return result

    # ------------------------------------------------------------------
    def terminate_workers(self):
        """API parity with reference muzero.py:348-367. The synchronous build
        has no detached workers; training stops cooperatively via the
        `terminate` flag or the STOP file in results_path."""
        self.checkpoint["terminate"] = True

    # ------------------------------------------------------------------
    def load_model(self, checkpoint_path=None, replay_buffer_path=None):
        """Restore a checkpoint (either package's) and optionally the
        replay buffer (reference muzero.py:426-464)."""
        if checkpoint_path:
            checkpoint_path = pathlib.Path(checkpoint_path)
            self.checkpoint = ckpt_lib.load_checkpoint(checkpoint_path)
            print(f"\nUsing checkpoint from {checkpoint_path}")
        if replay_buffer_path:
            replay_buffer_path = pathlib.Path(replay_buffer_path)
            self.replay_buffer_state = ckpt_lib.load_replay_buffer(replay_buffer_path)
            print(f"Initializing replay buffer with {replay_buffer_path}")
        else:
            # Counters start fresh without a buffer (reference muzero.py:449-461)
            self.checkpoint["training_step"] = 0
            self.checkpoint["num_played_steps"] = 0
            self.checkpoint["num_played_games"] = 0
            self.checkpoint["num_reanalysed_games"] = 0

    # ------------------------------------------------------------------
    def diagnose_model(self, horizon=3):
        """Virtual-vs-real trajectory diagnosis (reference muzero.py:466-479)
        of the checkpoint's weights, plotted; returns (virtual, real,
        divergence_index) of DiagnoseModel.compare_virtual_with_real_trajectories."""
        from muzero_general_tpu_torch.diagnose import DiagnoseModel

        self.network.load_state_dict(params_from_jax(self.checkpoint["weights"]))
        dm = DiagnoseModel(self.network, self.config, self.device)
        return dm.compare_virtual_with_real_trajectories(self.make_env(), horizon)


def _flush_priorities(replay, pending):
    """Write pending training priorities back into the replay buffer
    (JAX muzero.py:635-640, :669-673)."""
    for pr, index_batches in pending:
        pr = pr.cpu().numpy()
        for m, index_batch in enumerate(index_batches):
            replay.update_priorities(pr[m], index_batch)
    pending.clear()


def _start_profile(device):
    """A torch.profiler trace of the host and, on the card, the device
    (JAX muzero.py:502-505 traces loops 20-24)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profile(profiler, profile_dir):
    profiler.stop()
    profile_dir = pathlib.Path(profile_dir)
    profile_dir.mkdir(parents=True, exist_ok=True)
    profiler.export_chrome_trace(str(profile_dir / "trace.json"))


def hyperparameter_search(game_name, parametrization, budget, parallel_experiments,
                          num_tests, device=None):
    """(1+1)-ES hyperparameter search (reference muzero.py:495-581 used
    nevergrad OnePlusOne; JAX muzero.py:850-860 builds the equivalent
    one-plus-one loop in, search.py). `device`: as MuZero's; the
    experiments' device groups are slices of its fleet."""
    from muzero_general_tpu_torch.search import one_plus_one_search

    return one_plus_one_search(game_name, parametrization, budget, parallel_experiments,
                               num_tests, device=device)


def load_model_menu(muzero, game_name):
    """Interactive checkpoint picker (reference muzero.py:584-619), over the
    runs under results/<game> beside this package."""
    results_dir = pathlib.Path(__file__).resolve().parents[1] / "results" / game_name
    options = ["Specify paths manually"] + sorted(
        str(p) for p in results_dir.glob("*/") if p.is_dir()
    )
    for i, option in enumerate(options):
        print(f"{i}. {option}")
    choice = input("Enter a number to choose a model to load: ")
    choice = int(choice) if choice.isdigit() and int(choice) < len(options) else 0
    if choice == 0:
        checkpoint_path = input("Enter a path to the model.checkpoint: ")
        replay_buffer_path = input("Enter a path to the replay_buffer.pkl: ")
    else:
        checkpoint_path = pathlib.Path(options[choice]) / "model.checkpoint"
        replay_buffer_path = pathlib.Path(options[choice]) / "replay_buffer.pkl"
        if not pathlib.Path(replay_buffer_path).exists():
            replay_buffer_path = None
    muzero.load_model(checkpoint_path=checkpoint_path, replay_buffer_path=replay_buffer_path)


def main(argv=None, device=None):
    """CLI: `python -m muzero_general_tpu_torch [game] ['{json overrides}']`
    (reference muzero.py:622-712). With a game, trains it; without, the
    interactive menu. `device`: as MuZero's (None: the card)."""
    argv = argv if argv is not None else sys.argv[1:]
    from muzero_general_tpu_torch.games import AVAILABLE_GAMES

    if argv:
        game_name = argv[0]
        overrides = json.loads(argv[1]) if len(argv) > 1 else None
        muzero = MuZero(game_name, overrides, device=device)
        muzero.train()
        return

    print("\nWelcome to MuZero (PyTorch/CUDA edition)! Here's a list of games:")
    for i, name in enumerate(AVAILABLE_GAMES):
        print(f"{i}. {name}")
    choice = input("Enter a number to choose the game: ")
    game_name = AVAILABLE_GAMES[int(choice)] if choice.isdigit() else "cartpole"
    muzero = MuZero(game_name, device=device)

    while True:
        options = [
            "Train",
            "Load pretrained model",
            "Diagnose model",
            "Render some self play games",
            "Play against MuZero",
            "Test the game manually",
            "Hyperparameter search",
            "Exit",
        ]
        print()
        for i, option in enumerate(options):
            print(f"{i}. {option}")
        choice = input("Enter a number to choose an action: ")
        choice = int(choice) if choice.isdigit() else 7
        if choice == 0:
            muzero.train()
        elif choice == 1:
            load_model_menu(muzero, game_name)
        elif choice == 2:
            muzero.diagnose_model(horizon=30)
        elif choice == 3:
            muzero.test(render=True, opponent="self", muzero_player=None)
        elif choice == 4:
            muzero.test(render=True, opponent="human", muzero_player=0)
        elif choice == 5:
            from muzero_general_tpu_torch.evaluate import manual_game

            manual_game(muzero.make_env())
        elif choice == 6:
            hyperparameter_search(game_name, None, budget=20, parallel_experiments=1,
                                  num_tests=10, device=device)
        else:
            break


if __name__ == "__main__":
    main()
