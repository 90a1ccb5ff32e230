"""Orchestrator: the user-facing `MuZero` class, the training loop and the
CLI (port of muzero.py; reference muzero.py MuZero class :24-479, CLI menu
:622-712).

As in the JAX package, the reference's Ray actor fleet becomes one
synchronous process: after each self-play chunk the learner catches up to
ratio * num_played_steps exactly, and SharedStorage is the 17-key
checkpoint dict held in the process. Everything runs on one device:
`device=None` means the CUDA card, and without one `MuZero` raises unless
the caller passes `device="cpu"`.

What of the JAX package's muzero.py is where:
- `two_player_reward_split` :40; `MuZero.__init__` :87-125, with
  `device` beside the JAX arguments; `_restore_state` :134-153 is a
  `trainer.Learner` restored by `checkpoint.restore_learner`; the
  checkpoint syncs :155-160 and :676-704 are `checkpoint.sync_state` and
  `checkpoint.sync_checkpoint`; `_make_driver` :163-175; `_reanalyse_sweep`
  :178-216 with the value function of :447-452; `train` is `train`/`_train`
  :219-753 and `test` is `test`/`_test` :756-808; `terminate_workers` :811;
  `load_model` :818-836; `load_model_menu` :862-882; `main` :885-939.
- Device replay (ops/device_replay.py) engages where JAX's does
  (:380-446): `device_replay` with `fused_train_steps` > 1 (the port has
  one process and no mesh). The completed games go to the ring on the card
  each loop in padded chunks of _DEV_K_PAD (:523-526); a train round of M
  steps then samples, trains and writes priorities back there (:594-606),
  and reanalyse mirrors its fresh values into the ring (:657-663). The
  host buffer keeps the counters, the checkpoints and reanalyse; its
  priorities are not written on that path, as in JAX.
- The Gumbel search (`use_gumbel_mcts`) runs in the self-play driver and in
  evaluate.py.
- Raised with NotImplementedError, naming the ROADMAP queue 1 item that
  will lift it: `split_resources_in` > 1, `devices`, `distributed`, a
  mesh (`mesh_dp`/`mesh_mp` > 1) and `hyperparameter_search` (item 9);
  host envs (item 8).
- `diagnose_model` :839-847 runs diagnose.py's DiagnoseModel on the
  checkpoint's weights.
- The mesh and multi-host code of `_train` (:244-313, :326-349, :453-466)
  has no counterpart: the port runs on one card.
"""

import functools
import json
import pathlib
import sys
import time

import numpy as np
import torch

from muzero_general_tpu_torch import checkpoint as ckpt_lib
from muzero_general_tpu_torch import config as config_lib
from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.logger import MetricsLogger
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax, params_to_jax
from muzero_general_tpu_torch.ops import device_replay as dr_lib
from muzero_general_tpu_torch.ops.support import support_to_scalar
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


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 item {item})")


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
        split_resources_in, devices, slice_index, distributed: the JAX
            package's device-group and multi-host arguments; anything but
            their defaults raises (ROADMAP queue 1 item 9).
        device: the torch device everything runs on; None means the CUDA
            card (device.resolve_device).
    """

    def __init__(self, game_name, config=None, split_resources_in=1,
                 devices=None, slice_index=0, distributed=None, device=None):
        if distributed:
            raise _not_ported("multi-host training (distributed)", 9)
        if devices is not None or split_resources_in > 1:
            raise _not_ported("device groups (split_resources_in, devices)", 9)
        self.game_name = game_name
        self.device = resolve_device(device)
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

    def _make_driver(self, network, num_games=None, seed=None, greedy_lanes=0):
        """The batched self-play driver on the game's env (JAX
        muzero.py:163-175); host envs are not ported."""
        env = self.make_env()
        if getattr(env, "host_env", False):
            raise _not_ported("the host-env self-play driver (hostplay.py)", 8)
        return SelfPlayDriver(env, network, self.config, num_games=num_games, seed=seed,
                              greedy_lanes=greedy_lanes, device=self.device)

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
        cfg = self.config
        picked = replay.reanalyse_pick(cfg.reanalyse_games_per_interval)
        if not picked:
            return 0
        chunk = int(cfg.reanalyse_chunk_positions)
        obs_parts = [replay.reanalyse_observations(gh) for _, gh in picked]
        lengths = [o.shape[0] for o in obs_parts]
        all_obs = np.concatenate(obs_parts)
        out = np.empty((all_obs.shape[0],), np.float32)
        for start in range(0, all_obs.shape[0], chunk):
            block = torch.from_numpy(all_obs[start : start + chunk]).to(self.device)
            out[start : start + block.shape[0]] = (
                reanalyse_values(network, block, cfg.support_size).cpu().numpy()
            )
        off = 0
        for (gid, _), length in zip(picked, lengths):
            replay.update_reanalysed_values(gid, out[off : off + length])
            if on_update is not None:
                on_update(gid, out[off : off + length])
            off += length
        return len(picked)

    # ------------------------------------------------------------------
    def _refuse_unported(self):
        cfg = self.config
        if int(cfg.mesh_dp or 1) > 1 or int(cfg.mesh_mp or 1) > 1:
            raise _not_ported("a device mesh (mesh_dp, mesh_mp)", 9)

    def train(self, log_in_tensorboard=True):
        """Synchronous actor-learner training (reference muzero.py:132-208;
        JAX train/_train), on one device: the JAX loop's mesh and multi-host
        branches have no counterpart here (see the module docstring).
        Returns the checkpoint dict."""
        cfg = self.config
        self._refuse_unported()
        cfg.results_path.mkdir(parents=True, exist_ok=True)

        learner = self._restore_state()

        # Evaluation rides lane 0 of the self-play driver at temperature 0
        # (the reference's test-mode worker, self_play.py:54-90); 2-player
        # games against a scripted opponent play a separate evaluation game
        # every few loops instead.
        needs_self_test_lane = not (
            len(cfg.players) > 1 and cfg.opponent not in (None, "self")
        )
        driver = self._make_driver(
            self.network, seed=cfg.seed, greedy_lanes=1 if needs_self_test_lane else 0
        )

        if self.replay_buffer_state is not None:
            replay = ReplayBuffer(
                cfg,
                self.replay_buffer_state["buffer"],
                self.replay_buffer_state["num_played_games"],
                self.replay_buffer_state["num_played_steps"],
            )
        else:
            replay = ReplayBuffer(cfg)

        logger = (
            MetricsLogger(cfg.results_path, cfg, self.summary) if log_in_tensorboard else None
        )

        prefetcher = None
        if cfg.batch_prefetch:
            from muzero_general_tpu_torch.prefetch import BatchPrefetcher

            prefetcher = BatchPrefetcher(replay, depth=max(2, int(cfg.fused_train_steps)))

        def next_batches(n):
            if prefetcher is not None:
                return prefetcher.take(n)
            return [replay.get_batch() for _ in range(n)]

        M = max(1, int(cfg.fused_train_steps))
        # Device replay where JAX engages it (muzero.py:389-395; one process
        # and no mesh here): the train round samples, trains and writes its
        # priorities back on the card.
        ring = (DeviceRing(cfg, learner, self.device)
                if getattr(cfg, "device_replay", False) and M > 1 else None)
        self.device_ring = ring

        training_step = self.checkpoint["training_step"]
        print(f"\nTraining {self.game_name} on {self.device}...\n")
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
                if self.checkpoint["terminate"] or stop_file.exists():
                    break
                loop_counter += 1
                if cfg.profile_dir and loop_counter == 20:
                    profiler = _start_profile(self.device)
                if cfg.profile_dir and loop_counter == 25 and profiler is not None:
                    _stop_profile(profiler, cfg.profile_dir)
                    profiler = None
                # The weights the loop starts with go to self-play (and, as
                # the driver runs self.network, to this loop's evaluation).
                driver.load_weights(learner.network.state_dict())
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
                played_games = replay.num_played_games
                played_steps = replay.num_played_steps
                buffer_ready = bool(replay.buffer)
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
                        parts = next_batches(M)
                        index_batches = [ib for ib, _ in parts]
                        batches = {k: np.stack([b[k] for _, b in parts]) for k in parts[0][1]}
                        phase_time["batch"] += time.time() - t0
                        t0 = time.time()
                        metrics, priorities_m = learner.train_steps(batches)
                        training_step += M
                        if cfg.PER:
                            pending_priorities.append((priorities_m, index_batches))
                    else:
                        index_batch, batch = next_batches(1)[0]
                        phase_time["batch"] += time.time() - t0
                        t0 = time.time()
                        metrics, priorities = learner.train_step(batch)
                        training_step += 1
                        if cfg.PER:
                            pending_priorities.append((priorities[None], [index_batch]))
                    if cfg.PER and len(pending_priorities) >= 4:
                        _flush_priorities(replay, pending_priorities)
                    phase_time["train"] += time.time() - t0
                    t0 = time.time()
                    if (
                        cfg.use_last_model_value
                        and (training_step // cfg.reanalyse_interval)
                        > (prev_step // cfg.reanalyse_interval)
                        and replay.buffer
                    ):
                        n = self._reanalyse_sweep(
                            replay, learner.network,
                            on_update=ring.on_reanalysed if ring is not None else None)
                        self.checkpoint["num_reanalysed_games"] += n
                    phase_time["reanalyse"] += time.time() - t0
                    last_metrics = metrics
                if cfg.PER:
                    _flush_priorities(replay, pending_priorities)

                # ---- checkpoint sync (once per loop at most) --------------
                t0 = time.time()
                if last_metrics is not None and (
                    training_step // cfg.checkpoint_interval
                ) > (last_ckpt_step // cfg.checkpoint_interval):
                    # The losses and lr of the last step, training_step,
                    # weights, optimizer state, played counters.
                    ckpt_lib.sync_checkpoint(self.checkpoint, learner, replay)
                    if cfg.save_model:
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
        # checkpoint interval, as in JAX.
        self.checkpoint["training_step"] = training_step
        ckpt_lib.sync_state(self.checkpoint, learner, replay)
        if cfg.save_model:
            ckpt_lib.save_checkpoint(self.checkpoint, cfg.results_path / "model.checkpoint")
            ckpt_lib.save_replay_buffer(
                replay, self.checkpoint, cfg.results_path / "replay_buffer.pkl"
            )
        if logger:
            logger.close()
        print()
        return self.checkpoint

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
                          num_tests):
    """(1+1)-ES hyperparameter search (JAX muzero.py:850, search.py)."""
    raise _not_ported("hyperparameter_search (search.py)", 9)


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
    interactive menu. `device`: as MuZero's (None: the card).

    The menu's "Hyperparameter search" reaches the NotImplementedError of
    hyperparameter_search."""
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
                                  num_tests=10)
        else:
            break


if __name__ == "__main__":
    main()
