"""The port's orchestrator (muzero_general_tpu_torch/muzero.py) against the
JAX package's, loop for loop.

Loop parity: JAX's `MuZero._train` and the port's `MuZero.train` get the
same games, weights and replay draws, and must then take the same steps:
- games: each side's `_make_driver` returns `StubDriver`, whose `play`
  hands out one fixed script of games (made once with numpy from a seed)
  and the stats JAX's driver returns; self-play itself is held against JAX
  by test_torch_selfplay.py;
- weights: the port starts from JAX's initial checkpoint["weights"];
- replay draws: JAX's `ReplayBuffer.get_batch` is patched (from this file)
  onto its numpy path, which the port's C++ assembler equals bit for bit
  (JAX's own native path does not); `batch_prefetch` is off on both sides,
  as the prefetch thread's timing decides which batches a step sees;
- JAX trains on one device (`mesh_dp` 1), not the test suite's 8-device CPU
  mesh.
Then these are exact: the temperatures handed to self-play, the sequence of
single and fused train calls, every metrics.jsonl line's counters and
rewards, the checkpoint dict's keys and counters, the saved files' names
(and each loads in the other package). Losses, weights and optimizer state
agree within the tolerances below. The tictactoe case also plays the
opponent evaluation game (random opponent, first-index ties, no root
noise) every `eval_interval_loops`.
"""

import ast
import copy
import json
import pathlib

import numpy as np
import pytest
import torch

import muzero_general_tpu.muzero as jax_muzero
import muzero_general_tpu.ops.mcts as jax_mcts
from muzero_general_tpu import checkpoint as jax_checkpoint
from muzero_general_tpu.replay import GameHistory as JaxGameHistory
from muzero_general_tpu.replay import ReplayBuffer as JaxReplayBuffer
from muzero_general_tpu_torch import MuZero, checkpoint
from muzero_general_tpu_torch import muzero as port_muzero
from muzero_general_tpu_torch import evaluate
from muzero_general_tpu_torch.models import params_to_jax
from muzero_general_tpu_torch.ops import mcts as port_mcts
from muzero_general_tpu_torch.replay import GameHistory, ReplayBuffer
from muzero_general_tpu_torch.trainer import Learner
from test_torch_trainer import ADAM_PARAM_TOL, _leaves, assert_trees_close

REPO = pathlib.Path(__file__).resolve().parents[1]
# Losses of the last checkpoint interval and the lr, after up to 32 steps on
# both sides: float32 summed in another order, through the same batches.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
# mean_value: the eval game's root values (the stub's, or the search's,
# which agree to 5e-5: test_torch_evaluate.py).
VALUE_ATOL = 5e-5
# After 32 Adam steps the ResNet's params drift apart by up to 1.5e-4
# (observed; a ReLU pre-activation near 0 can take the other side in the
# other framework, ROADMAP "Known tolerances"), the FC net's by 7.2e-6; both
# within test_torch_trainer.py's ADAM_PARAM_TOL * lr * steps. The running
# statistics, averaged from those params' activations, within rtol 2e-3 and
# 1e-4 (observed 5.1e-5, 5.5e-4 relative); Adam's mu and nu within 2e-3 of
# the tree's largest (observed 8.0e-4 for the ResNet, 4.6e-5 for the FC net).
LOOP_STATS_RTOL, LOOP_STATS_ATOL = 2e-3, 1e-4
LOOP_MOMENT_TOL = 2e-3

EXACT_KEYS = ("training_step", "num_played_games", "num_played_steps",
              "num_reanalysed_games", "episode_length", "total_reward", "muzero_reward",
              "opponent_reward", "terminate")
CLOSE_KEYS = ("total_loss", "value_loss", "reward_loss", "policy_loss", "lr")

CARTPOLE = dict(
    training_steps=32, batch_size=8, num_unroll_steps=3, td_steps=5,
    checkpoint_interval=5, snapshot_interval=10, reanalyse_interval=6,
    reanalyse_games_per_interval=3, reanalyse_chunk_positions=7,
    num_simulations=4, parallel_games=4, batch_prefetch=False, mesh_dp=1,
)
TICTACTOE = dict(
    CARTPOLE, channels=4, reduced_channels_reward=2, reduced_channels_value=2,
    reduced_channels_policy=2, num_simulations=8, root_exploration_fraction=0.0,
    opponent="random", eval_interval_loops=3,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's operations here are small: one intra-op thread, so that a
    busy host (the suite runs in several worker processes) does not stall
    them in the thread pool's waits (observed: the tictactoe loop case
    ~20 s alone, 472 s beside five other workers with 8 threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ratio(played_games):
    """A callable ratio (as lunarlander's anneal): rising, so the targets
    give both fused and single steps."""
    return 0.25 + 0.05 * played_games


# name: (game, overrides)
CASES = {
    "cartpole_fused_per": ("cartpole", dict(CARTPOLE, fused_train_steps=8, PER=True,
                                            ratio=_ratio)),
    "cartpole_single": ("cartpole", dict(CARTPOLE, fused_train_steps=1, PER=False, ratio=0.4)),
    "tictactoe_fused": ("tictactoe", dict(TICTACTOE, fused_train_steps=8, PER=False,
                                          ratio=_ratio)),
}


def random_game(rng, cfg, length):
    A, players = len(cfg.action_space), len(cfg.players)
    return {
        "observations": rng.normal(size=(length,) + tuple(cfg.observation_shape)).astype(
            np.float32),
        "actions": np.concatenate([[0], rng.integers(0, A, length)]).astype(np.int32),
        "rewards": np.concatenate([[0.0], rng.normal(size=length)]).astype(np.float32),
        "to_play": (np.arange(length + 1) % players).astype(np.int32),
        "child_visits": rng.dirichlet(np.ones(A), length).astype(np.float32),
        "root_values": (3 * rng.normal(size=length)).astype(np.float32),
    }


def game_script(cfg, seed, loops=12):
    """Per play() call: two games for replay, an eval game every other call,
    and the open eval episode's reward."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(loops):
        games = [random_game(rng, cfg, int(rng.integers(6, 14))) for _ in range(2)]
        evals = [random_game(rng, cfg, int(rng.integers(3, 9)))] if i % 2 == 0 else []
        out.append((games, evals, float(rng.normal())))
    return out


class StubDriver:
    """Self-play stand-in: play() hands out the script's next games as
    `cls` (either package's GameHistory, fresh arrays each side) with the
    stats JAX's driver returns; load_weights loads the driver's network, as
    SelfPlayDriver.load_weights does."""

    def __init__(self, script, cls, network=None, greedy_lanes=0):
        self.script, self.cls, self.network = script, cls, network
        self.greedy_lanes = greedy_lanes
        self.calls, self.temperatures = 0, []

    def _game(self, fields):
        return self.cls(**{k: v.copy() for k, v in fields.items()})

    def play(self, *args):  # JAX: (variables, temperature); port: (temperature)
        self.temperatures.append(args[-1])
        games, evals, partial = self.script[self.calls % len(self.script)]
        self.calls += 1
        stats = {"env_steps": 8 * 4, "max_tree_depth": 0,
                 "pred_values": np.zeros((8, 4), np.float32), "eval_games": []}
        if self.greedy_lanes:
            stats["eval_games"] = [self._game(g) for g in evals]
            stats["eval_partial_reward"] = partial
        return [self._game(g) for g in games], stats

    def load_weights(self, state_dict):
        self.network.load_state_dict(state_dict)


def deterministic_specs(monkeypatch):
    """First-index ties in the B = 1 evaluation search on both sides (as
    test_torch_mcts.py sets them), so a near tie cannot be drawn apart."""
    jax_from = jax_mcts.SearchSpec.from_config.__func__
    port_from = port_mcts.SearchSpec.from_config.__func__
    monkeypatch.setattr(jax_mcts.SearchSpec, "from_config", classmethod(
        lambda cls, *a, **k: jax_from(cls, *a, **k)._replace(deterministic_tie_break=True)))
    monkeypatch.setattr(port_mcts.SearchSpec, "from_config", classmethod(
        lambda cls, *a, **k: port_from(cls, *a, **k)._replace(deterministic_tie_break=True)))


def _metrics(path):
    lines = [json.loads(x) for x in (path / "metrics.jsonl").read_text().splitlines()]
    return [x for x in lines if "phase_time_s" not in x]


def run_jax(mz, script, monkeypatch):
    """JAX MuZero._train with the stub driver, the numpy replay path and
    counted train calls. Returns (MuZero, checkpoint, call kinds, driver)."""
    kinds = []

    def counting(factory, kind):
        def make(*args, **kwargs):
            fn = factory(*args, **kwargs)

            def call(*a):
                kinds.append(kind)
                return fn(*a)

            return call

        return make

    get_batch = JaxReplayBuffer.get_batch
    monkeypatch.setattr(JaxReplayBuffer, "get_batch",
                        lambda self, use_native=True: get_batch(self, use_native=False))
    monkeypatch.setattr(jax_muzero, "make_train_step",
                        counting(jax_muzero.make_train_step, "single"))
    monkeypatch.setattr(jax_muzero, "make_fused_train_steps",
                        counting(jax_muzero.make_fused_train_steps, "fused"))
    drivers = []

    def make_driver(runner, **kw):
        drivers.append(StubDriver(script, JaxGameHistory, None, kw.get("greedy_lanes", 0)))
        return drivers[-1]

    mz._make_driver = make_driver
    ck = mz.train()
    monkeypatch.undo()
    return mz, ck, kinds, drivers[0]


def run_port(game, overrides, weights, script, path, monkeypatch):
    kinds = []
    train_step, train_steps = Learner.train_step, Learner.train_steps

    def single(self, batch):
        kinds.append("single")
        return train_step(self, batch)

    def fused(self, batches):
        kinds.append("fused")
        return train_steps(self, batches)

    monkeypatch.setattr(Learner, "train_step", single)
    monkeypatch.setattr(Learner, "train_steps", fused)
    mz = MuZero(game, dict(overrides, results_path=str(path)), device="cpu")
    mz.checkpoint["weights"] = copy.deepcopy(weights)
    drivers = []

    def make_driver(network, **kw):
        drivers.append(StubDriver(script, GameHistory, network, kw.get("greedy_lanes", 0)))
        return drivers[-1]

    mz._make_driver = make_driver
    ck = mz.train()
    monkeypatch.undo()
    return mz, ck, kinds, drivers[0]


_RUNS = {}


def parity_run(name, tmp_path_factory, monkeypatch):
    """Both loops of one case, from JAX's initial weights; run once per
    test session."""
    if name not in _RUNS:
        game, overrides = CASES[name]
        root = tmp_path_factory.mktemp(name)
        jmz = jax_muzero.MuZero(game, dict(overrides, results_path=str(root / "jax")))
        weights = copy.deepcopy(jmz.checkpoint["weights"])
        script = game_script(jmz.config, seed=7)
        deterministic_specs(monkeypatch)
        jax_side = run_jax(jmz, script, monkeypatch)
        deterministic_specs(monkeypatch)
        port_side = run_port(game, overrides, weights, script, root / "port", monkeypatch)
        _RUNS[name] = (root, jax_side, port_side)
    return _RUNS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_train_loop_matches_jax_loop(name, tmp_path_factory, monkeypatch):
    root, (jmz, jck, jkinds, jdrv), (tmz, tck, tkinds, tdrv) = parity_run(
        name, tmp_path_factory, monkeypatch)
    game, overrides = CASES[name]
    steps = overrides["training_steps"]
    assert jck["training_step"] == tck["training_step"] == steps
    # The loop's schedule: the temperatures handed to self-play, then the
    # kinds of train calls, in order.
    assert tdrv.temperatures == jdrv.temperatures
    assert tkinds == jkinds
    if overrides["fused_train_steps"] > 1:
        assert {"single", "fused"} <= set(tkinds)
    else:
        assert set(tkinds) == {"single"}
    # Every loop's logged line.
    jlines, tlines = _metrics(root / "jax"), _metrics(root / "port")
    assert len(tlines) == len(jlines) == tdrv.calls >= 3
    for j, t in zip(jlines, tlines):
        for key in EXACT_KEYS:
            if key in j:
                assert t[key] == j[key], key
        for key in CLOSE_KEYS:
            np.testing.assert_allclose(t[key], j[key], rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=key)
        np.testing.assert_allclose(t["mean_value"], j["mean_value"], rtol=0, atol=VALUE_ATOL)
    # The returned checkpoint dict.
    assert list(tck) == list(jck) == checkpoint.CHECKPOINT_KEYS
    for key in EXACT_KEYS:
        assert tck[key] == jck[key], key
    for key in CLOSE_KEYS + ("mean_value",):
        np.testing.assert_allclose(tck[key], jck[key], rtol=LOSS_RTOL, atol=VALUE_ATOL,
                                   err_msg=key)
    if overrides.get("use_last_model_value", True):
        assert tck["num_reanalysed_games"] > 0
    # Weights, running statistics and the Adam state.
    lr = tmz.config.lr_init
    assert_trees_close(tck["weights"]["params"], jck["weights"]["params"],
                       ADAM_PARAM_TOL * lr * steps, what="params")
    assert_trees_close(tck["weights"]["batch_stats"], jck["weights"]["batch_stats"],
                       LOOP_STATS_ATOL, LOOP_STATS_RTOL, what="batch_stats")
    _, adam, schedule = jck["optimizer_state"]
    opt = tck["optimizer_state"]
    assert int(opt["count"]) == int(adam.count) == steps
    assert int(opt["schedule_count"]) == int(schedule.count) == steps
    for key, want in (("mu", adam.mu), ("nu", adam.nu)):
        atol = LOOP_MOMENT_TOL * max(np.abs(x).max() for _, x in _leaves(want))
        assert_trees_close(opt[key], want, atol, what=key)


@pytest.mark.parametrize("name", ["cartpole_fused_per", "tictactoe_fused"])
def test_saved_files_match_and_load_in_the_other_package(name, tmp_path_factory, monkeypatch):
    root, (jmz, jck, *_), (tmz, tck, *_) = parity_run(name, tmp_path_factory, monkeypatch)

    def saved(path):
        return sorted(p.name for p in path.iterdir() if not p.name.startswith("events."))

    names = saved(root / "port")
    assert names == saved(root / "jax")
    # snapshot_interval 10, crossed mid-run: numbered snapshots beside the last
    assert len([n for n in names if n.startswith("model_0")]) >= 2
    for fname in names:
        if fname.endswith(".checkpoint"):
            for path in (root / "port" / fname, root / "jax" / fname):
                for loaded in (checkpoint.load_checkpoint(path),
                               jax_checkpoint.load_checkpoint(path)):
                    assert list(loaded) == checkpoint.CHECKPOINT_KEYS
            port_ck = checkpoint.load_checkpoint(root / "port" / fname)
            jax_ck = jax_checkpoint.load_checkpoint(root / "jax" / fname)
            for key in EXACT_KEYS:
                assert port_ck[key] == jax_ck[key], (fname, key)
    # Each replay buffer loads in the other package.
    port_rb = jax_checkpoint.load_replay_buffer(root / "port" / "replay_buffer.pkl")
    jax_rb = checkpoint.load_replay_buffer(root / "jax" / "replay_buffer.pkl")
    assert all(type(gh) is GameHistory for gh in jax_rb["buffer"].values())
    jbuf = JaxReplayBuffer(jmz.config, port_rb["buffer"], port_rb["num_played_games"],
                           port_rb["num_played_steps"])
    tbuf = ReplayBuffer(tmz.config, jax_rb["buffer"], jax_rb["num_played_games"],
                        jax_rb["num_played_steps"])
    assert sorted(jbuf.buffer) == sorted(tbuf.buffer)
    assert jbuf.total_samples == tbuf.total_samples
    assert (jbuf.num_played_steps, tbuf.num_played_steps) == (jck["num_played_steps"],) * 2
    # The port restores a JAX-written checkpoint's optimizer state.
    learner = Learner(tmz.config, device="cpu")
    checkpoint.restore_learner(learner, checkpoint.load_checkpoint(root / "jax" / "model.checkpoint"))
    assert learner.training_step == jck["training_step"]


def test_reanalyse_sweep_matches_jax():
    """The same buffer and weights (running statistics moved off 0 and 1),
    a chunk that does not divide the positions: the refreshed values agree
    within 1e-5, on the same games."""
    import jax

    from muzero_general_tpu.ops.support import support_to_scalar as jax_support_to_scalar

    overrides = dict(TICTACTOE, reanalyse_games_per_interval=4, reanalyse_chunk_positions=11)
    jmz = jax_muzero.MuZero("tictactoe", dict(overrides))
    rng = np.random.default_rng(3)
    weights = jax.tree_util.tree_map(np.array, jmz.checkpoint["weights"])
    for leaf in jax.tree_util.tree_leaves(weights["batch_stats"]):
        leaf += rng.uniform(0.1, 0.5, leaf.shape).astype(np.float32)
    jmz.checkpoint["weights"] = weights
    tmz = MuZero("tictactoe", dict(overrides), device="cpu")
    tmz.checkpoint["weights"] = copy.deepcopy(weights)
    games = [random_game(rng, jmz.config, int(rng.integers(5, 10))) for _ in range(6)]
    jbuf, tbuf = JaxReplayBuffer(jmz.config), ReplayBuffer(tmz.config)
    for g in games:
        jbuf.save_game(JaxGameHistory(**copy.deepcopy(g)))
        tbuf.save_game(GameHistory(**copy.deepcopy(g)))
    assert sum(len(jbuf.buffer[i]) for i in range(4)) % 11

    runner = jmz.runner
    fn = jax.jit(lambda v, obs: jax_support_to_scalar(runner.initial_inference(v, obs)[0],
                                                      jmz.config.support_size))
    learner = tmz._restore_state()
    for sweep in range(2):  # round-robin: games 0-3, then 4, 5, 0, 1
        n_j = jmz._reanalyse_sweep(jbuf, fn, weights)
        n_t = tmz._reanalyse_sweep(tbuf, learner.network)
        assert n_j == n_t == 4
        for gid in jbuf.buffer:
            want = jbuf.buffer[gid].reanalysed_predicted_root_values
            got = tbuf.buffer[gid].reanalysed_predicted_root_values
            assert (got is None) == (want is None), gid
            if want is not None:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=str(gid))
    assert learner.network.training  # the sweep restored train mode


# ---------------------------------------------------------------------------
# Resume (tests/test_resume.py's pattern)
# ---------------------------------------------------------------------------

OVR = dict(training_steps=6, batch_size=4, num_simulations=4, parallel_games=2,
           selfplay_chunk_moves=4, num_unroll_steps=2, td_steps=3, checkpoint_interval=2,
           ratio=None, fused_train_steps=1, max_moves=12)


def test_resume_continues_from_checkpoint_and_resets_without_buffer(tmp_path):
    mz = MuZero("cartpole", dict(OVR, results_path=str(tmp_path / "a")), device="cpu")
    ck = mz.train(log_in_tensorboard=False)
    assert ck["training_step"] == 6
    assert (tmp_path / "a" / "model.checkpoint").exists()
    assert (tmp_path / "a" / "replay_buffer.pkl").exists()
    trained = copy.deepcopy(ck["weights"])

    # With both files: counters and weights restored (JAX muzero.py:818-836).
    mz2 = MuZero("cartpole", dict(OVR, training_steps=10, results_path=str(tmp_path / "b")),
                 device="cpu")
    mz2.load_model(checkpoint_path=tmp_path / "a" / "model.checkpoint",
                   replay_buffer_path=tmp_path / "a" / "replay_buffer.pkl")
    assert mz2.checkpoint["training_step"] == 6
    assert mz2.replay_buffer_state["num_played_games"] == ck["num_played_games"] > 0
    learner = mz2._restore_state()
    assert learner.training_step == 6
    assert_trees_close(params_to_jax(learner.network)["params"], trained["params"],
                       0.0, what="restored params")
    ck2 = mz2.train(log_in_tensorboard=False)
    assert ck2["training_step"] == 10
    assert ck2["num_played_games"] >= ck["num_played_games"]
    assert any(not np.array_equal(a, b) for (_, a), (_, b) in
               zip(_leaves(ck2["weights"]["params"]), _leaves(trained["params"])))

    # Without the buffer the counters start fresh (reference muzero.py:449-461).
    mz3 = MuZero("cartpole", dict(OVR), device="cpu")
    mz3.load_model(checkpoint_path=tmp_path / "a" / "model.checkpoint")
    for key in ("training_step", "num_played_games", "num_played_steps",
                "num_reanalysed_games"):
        assert mz3.checkpoint[key] == 0, key
    assert mz3.replay_buffer_state is None


def test_ratio_schedule_callable_is_honored(tmp_path):
    calls = []

    def schedule(games):
        calls.append(games)
        return 5.0

    mz = MuZero("cartpole", dict(OVR, max_moves=16, results_path=str(tmp_path)), device="cpu")
    mz.config.ratio = schedule
    ck = mz.train(log_in_tensorboard=False)
    assert ck["training_step"] == OVR["training_steps"]
    assert calls and calls == sorted(calls)


def test_port_resumes_a_jax_written_run(tmp_path_factory, monkeypatch):
    """The JAX loop's files (model.checkpoint with its Adam state,
    replay_buffer.pkl of JAX GameHistory) resume in the port's MuZero,
    counters continued."""
    root, (jmz, jck, *_), _ = parity_run("cartpole_single", tmp_path_factory, monkeypatch)
    _, overrides = CASES["cartpole_single"]
    mz = MuZero("cartpole", dict(overrides, training_steps=jck["training_step"] + 4,
                                 results_path=str(root / "resumed")), device="cpu")
    mz.load_model(checkpoint_path=root / "jax" / "model.checkpoint",
                  replay_buffer_path=root / "jax" / "replay_buffer.pkl")
    learner = mz._restore_state()
    assert learner.training_step == jck["training_step"]
    cfg = mz.config
    assert learner.lr() == pytest.approx(
        cfg.lr_init * cfg.lr_decay_rate ** (jck["training_step"] / cfg.lr_decay_steps), rel=1e-6)
    ck = mz.train(log_in_tensorboard=False)
    assert ck["training_step"] == jck["training_step"] + 4
    assert ck["num_played_games"] >= jck["num_played_games"]
    assert int(ck["optimizer_state"]["count"]) == ck["training_step"]


# ---------------------------------------------------------------------------
# What is not ported raises; nothing of JAX is imported
# ---------------------------------------------------------------------------


def no_plots(monkeypatch):
    """Record diagnose.py's plots instead of drawing them; returns the list
    they are recorded in (the tree as "mcts", the heatmaps by title)."""
    from muzero_general_tpu_torch import diagnose

    drawn = []
    monkeypatch.setattr(diagnose.Trajectoryinfo, "plot_trajectory",
                        lambda self, *a, **k: drawn.append(self.title))
    monkeypatch.setattr(diagnose.DiagnoseModel, "plot_mcts",
                        lambda self, *a, **k: drawn.append("mcts"))
    return drawn


def test_unported_branches_raise(tmp_path, monkeypatch):
    # Device groups of one device (search.py's) are ported: they pin the
    # instance to that device. A group of more than one device needs a mesh,
    # which, like `distributed` and mesh_dp > 1, is item 9b.
    assert MuZero("cartpole", split_resources_in=2, device="cpu").device == torch.device("cpu")
    mz = MuZero("cartpole", devices=["cpu"])
    assert mz.device == torch.device("cpu") and mz._devices == [torch.device("cpu")]
    assert {p.device for p in mz.network.parameters()} == {torch.device("cpu")}
    with pytest.raises(NotImplementedError, match="item 9b"):
        MuZero("cartpole", devices=["cpu", "meta"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 9b"):
        MuZero("cartpole", distributed=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MuZero("cartpole")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MuZero("cartpole", split_resources_in=2)
    base = dict(OVR, results_path=str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 9b"):
        MuZero("cartpole", dict(base, mesh_dp=2), device="cpu").train(log_in_tensorboard=False)
    # Device replay (item 7) and the Gumbel search (item 6) are ported
    # (tests/test_torch_device_replay.py, tests/test_torch_gumbel.py): device
    # replay engages where JAX engages it and nowhere else.
    mz = MuZero("cartpole", dict(base, device_replay=True, fused_train_steps=8, batch_size=4,
                                 training_steps=2), device="cpu")
    assert mz.train(log_in_tensorboard=False)["training_step"] == 2
    assert mz.device_ring is not None
    mz = MuZero("cartpole", dict(base, device_replay=True), device="cpu")  # fused_train_steps 1
    mz.train(log_in_tensorboard=False)
    assert mz.device_ring is None
    mz = MuZero("cartpole", dict(base, use_gumbel_mcts=True, max_moves=4), device="cpu")
    game = evaluate.play_against_opponent(mz.make_env(), mz.network, mz.config, "self", 0)
    assert 1 <= len(game) <= 4
    # hyperparameter_search is ported (tests/test_torch_search.py): it runs
    # search.py's loop on the caller's device.
    from muzero_general_tpu_torch import search

    calls = []
    monkeypatch.setattr(search, "one_plus_one_search", lambda *a, **k: calls.append((a, k)))
    port_muzero.hyperparameter_search("cartpole", None, 20, 1, 10, device="cpu")
    assert calls == [(("cartpole", None, 20, 1, 10), {"device": "cpu"})]
    mz = MuZero("cartpole", dict(base), device="cpu")
    # diagnose_model is ported (tests/test_torch_diagnose.py): it runs, its
    # plots recorded instead of drawn.
    drawn = no_plots(monkeypatch)
    virtual, real, _ = mz.diagnose_model(horizon=2)
    assert len(virtual.action_history) == 2 and real.mcts_depth
    assert drawn == ["mcts", "Virtual trajectory: ", "Real trajectory: "]
    # Host envs are ported (tests/test_torch_hostplay.py,
    # tests/test_torch_host_muzero.py): the host driver plays them, and
    # evaluation and the manual game take them.
    mz = MuZero("lunarlander", dict(base, max_moves=3), device="cpu")
    assert isinstance(mz._make_driver(mz.network), port_muzero.HostSelfPlayDriver)
    assert np.isfinite(mz.test())
    game = evaluate.play_against_opponent(mz.make_env(), mz.network, mz.config, "random", 0)
    assert 1 <= len(game) <= 3 and game.observations.shape[1:] == (1, 1, 8)
    moves = iter(["2"] * 1000)
    monkeypatch.setattr("builtins.input", lambda prompt="": next(moves))
    evaluate.manual_game(mz.make_env())
    assert next(moves) == "2"  # the lander came down before 1,000 main-engine moves


_FORBIDDEN = {"jax", "flax", "optax", "muzero_general_tpu"}


def _imports(path):
    """The root names of every module the file imports, also through
    importlib.import_module / __import__ with a literal name."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


def test_port_and_card_scripts_import_nothing_of_jax():
    files = sorted((REPO / "muzero_general_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_gpu.py",
              REPO / "tests" / "test_torch_e2e_learning.py"]
    assert len(files) > 40
    for module in ("ops/gumbel", "ops/device_replay", "hostplay", "search", "envs/host"):
        assert REPO / "muzero_general_tpu_torch" / f"{module}.py" in files
    for path in files:
        found = _FORBIDDEN & set(_imports(path))
        assert not found, f"{path.relative_to(REPO)} imports {sorted(found)}"
    # The walk sees imports: this file's own would be found.
    assert {"jax", "muzero_general_tpu"} <= set(_imports(pathlib.Path(__file__)))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_trains_and_writes_a_checkpoint(tmp_path):
    overrides = dict(training_steps=4, parallel_games=4, num_simulations=4, batch_size=8,
                     max_moves=8, results_path=str(tmp_path))
    port_muzero.main(["cartpole", json.dumps(overrides)], device="cpu")
    ck = checkpoint.load_checkpoint(tmp_path / "model.checkpoint")
    assert ck["training_step"] == 4
    assert (tmp_path / "replay_buffer.pkl").exists()
    assert (tmp_path / "metrics.jsonl").exists()
    with pytest.raises(AttributeError, match="no attribute"):
        port_muzero.main(["cartpole", json.dumps({"no_such_key": 1})], device="cpu")


def test_cli_menu_reaches_the_ported_methods(tmp_path, monkeypatch, capsys):
    """The menu: game 0 (cartpole), then "Diagnose model" runs (horizon 30,
    its plots recorded instead of drawn), then "Exit" ends it; "Hyperparameter
    search" raises."""
    monkeypatch.setattr(port_muzero.config_lib.MuZeroConfig, "default_results_path",
                        lambda self, game: tmp_path)
    drawn = no_plots(monkeypatch)
    answers = iter(["0", "2", "7"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    port_muzero.main([], device="cpu")
    assert drawn == ["mcts", "Virtual trajectory: ", "Real trajectory: "]
    out = capsys.readouterr().out
    assert "Diagnose model" in out
    assert "Real trajectory reached Done" in out or "Reached horizon" in out
    # "Hyperparameter search" reaches search.py (its runs: test_torch_search.py).
    from muzero_general_tpu_torch import search

    searches = []
    monkeypatch.setattr(search, "one_plus_one_search",
                        lambda *a, **k: searches.append((a, k)))
    answers = iter(["0", "6", "7"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    port_muzero.main([], device="cpu")
    assert searches == [(("cartpole", None, 20, 1, 10), {"device": "cpu"})]
    answers = iter(["0", "7"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    port_muzero.main([], device="cpu")
    assert "Hyperparameter search" in capsys.readouterr().out
