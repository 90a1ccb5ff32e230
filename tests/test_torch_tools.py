"""The port's tools (muzero_general_tpu_torch/tools/) on the CPU.

The card tools (trace_search, trace_train, resnet_profile,
hidden_store_bench) run their `main` at tiny sizes with `--device cpu` and
print the JAX tools' columns or keys; gpu_parity refuses without a card, and
its compare function flags an injected visit mismatch.

The learning tools (device_replay_bench, connect4_gate, retest_snapshots,
gumbel_proof, lander_curve) are held against the JAX package's tools,
loaded from tools/ by file path: `MuZero` (and `play_against_opponent`)
patched to the same recorder in both packages, both `main`s run with the
same arguments on the same fixed metrics.jsonl and the same fake clock; the
recorded games, overrides and calls, and the printed tables, must be equal.
"""

import importlib.util
import itertools
import json
import pathlib
import re
import sys
import time
import types

import numpy as np
import pytest
import torch

import muzero_general_tpu.evaluate as jax_evaluate
import muzero_general_tpu.muzero as jax_muzero
from muzero_general_tpu_torch import config as port_config
from muzero_general_tpu_torch import evaluate as port_evaluate
from muzero_general_tpu_torch import muzero as port_muzero
from muzero_general_tpu_torch.tools import (connect4_gate, device_replay_bench, gpu_parity,
                                            gumbel_proof, hidden_store_bench, lander_curve,
                                            profiling, resnet_profile, retest_snapshots,
                                            trace_search, trace_train)

REPO = pathlib.Path(__file__).resolve().parents[1]
# A row of the JAX tools' top-ops table (tools/trace_search.py:120-121)
ROW = r"^ +\d+\.\d\d ms  x *\d+  +\d+\.\d us/op  \S"
# The keys of tools/resnet_profile.py's JSON line at its defaults
RESNET_PROFILE_KEYS = {
    "B", "sims", "dtype", "hidden_dtype", "net_scan_ms", "net_call_us",
    "hidden_rw_lane_major_ms", "hidden_rw_node_major_ms", "search_stub_ms", "mcts_pallas_ms",
    "mcts_pallas_env_steps_per_s", "mcts_xla_ms", "mcts_xla_env_steps_per_s",
    "descend_kernel_us", "chunk_env_steps_per_s", "chunk_pallas"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tools' operations here are small: one intra-op thread, so that a
    busy host (the suite runs in several worker processes) does not stall
    them in the thread pool's waits (observed: resnet_profile's case ~8 s
    alone, 305 s beside five other workers with 8 threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_tool(name):
    """tools/<name>.py of the JAX package, loaded by its path."""
    path = REPO / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# The card tools at tiny sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--games", "4", "--sims", "4", "--top", "5"],
    ["--game", "gomoku", "--games", "8", "--sims", "3", "--fold", "1", "--pallas", "0",
     "--top", "3"],
])
def test_trace_search_prints_the_jax_table(argv, tmp_path, capsys):
    assert trace_search.main(argv + ["--device", "cpu", "--keep", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cpu (no card")
    assert any(line.startswith("# total cpu (host ops, nested) op time: ") for line in lines)
    top = int(argv[argv.index("--top") + 1])
    rows = [line for line in lines if re.match(ROW, line)]
    assert len(rows) == top
    game = argv[argv.index("--game") + 1] if "--game" in argv else "connect4"
    trace = json.loads((tmp_path / f"trace_search_{game}.json").read_text())
    assert trace["traceEvents"]


def test_trace_train_prints_the_jax_table(capsys):
    args = trace_train.parse_args(["--game", "cartpole", "--batch", "4", "--fused", "2",
                                   "--top", "4", "--device", "cpu"])
    result = trace_train.run(args)
    out = capsys.readouterr().out
    assert len([line for line in out.splitlines() if re.match(ROW, line)]) == 4
    assert "per step" in out and np.isfinite(result["loss"])
    assert result["table"]["launches_per_step"] == result["table"]["launches"] / 2


def test_trace_train_batches_follow_the_jax_recipe():
    cfg = port_config.load_game_module("connect4").MuZeroConfig()
    cfg.batch_size = 3
    got = trace_train.random_batches(cfg, 2)
    U, A = cfg.num_unroll_steps, len(cfg.action_space)
    rng = np.random.default_rng(0)
    assert got["observation"].shape == (2, 3, 3, 6, 7)
    np.testing.assert_array_equal(got["observation"],
                                  rng.normal(size=(2, 3, 3, 6, 7)).astype(np.float32))
    np.testing.assert_array_equal(got["action"], rng.integers(0, A, (2, 3, U + 1)))
    assert got["target_policy"].shape == (2, 3, U + 1, A)
    np.testing.assert_array_equal(got["gradient_scale"], np.full((2, 3, U + 1), U, np.float32))


def test_resnet_profile_prints_the_jax_keys(capsys):
    assert resnet_profile.main(["--games", "4", "--sims", "6", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    result = json.loads(captured.out.splitlines()[-1])
    assert RESNET_PROFILE_KEYS <= set(result)
    assert result["descend_kernel_checked"] is True
    assert (result["B"], result["sims"], result["dtype"]) == (4, 6, "bfloat16")
    assert "# descend kernel (end-state tree, equal to descend_plain)" in captured.err
    skipped = resnet_profile.run(resnet_profile.parse_args(
        ["--games", "2", "--sims", "2", "--skip", "net_scan,hidden_rw,search_stub,mcts_pallas,"
         "mcts_xla,kernels,chunk", "--device", "cpu"]), log=lambda msg: None)
    assert set(skipped) == {"B", "sims", "dtype", "hidden_dtype", "launches"}


def test_hidden_store_bench_variants_give_equal_stores(capsys):
    fns = hidden_store_bench.variants(9, 4, 6, 8, torch.device("cpu"))
    assert set(fns) == set(hidden_store_bench.VARIANTS)
    outs = {name: fn() for name, fn in fns.items()}
    for name in ("inplace", "kernel"):
        assert torch.equal(outs[name][0], outs["value"][0])
        assert torch.equal(outs[name][1], outs["value"][1])
    store = outs["value"][0]
    assert torch.equal(store[0], torch.ones((4, 6)))
    assert torch.equal(store[8], torch.full((4, 6), 1.000001))
    assert hidden_store_bench.main(["--N", "9", "--B", "4", "--F", "6", "--sims", "8",
                                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in hidden_store_bench.VARIANTS:
        assert f"\n{name}: " in out and " ms for 8 sims (" in out
    assert "the three final stores bit-equal" in out


def test_gpu_parity_refuses_without_a_card(capsys):
    assert gpu_parity.main(["--device", "cpu"]) == 1
    assert gpu_parity.main([]) == 1  # no card here
    assert "needs a CUDA card" in capsys.readouterr().err


def test_gpu_parity_compare_flags_one_visit_mismatch():
    gen = torch.Generator().manual_seed(0)
    visits = torch.randint(0, 50, (64, 2), generator=gen)
    values = torch.randn((64,), generator=gen)
    ref = types.SimpleNamespace(root_visit_counts=visits, root_value=values)
    same = types.SimpleNamespace(root_visit_counts=visits.clone(),
                                 root_value=values + 5e-6)
    assert gpu_parity.compare(ref, same, gpu_parity.STAGED_TOL)[2] == []
    flipped = visits.clone()
    flipped[17, 1] += 1
    got = types.SimpleNamespace(root_visit_counts=flipped, root_value=values)
    mismatch, gap, failures = gpu_parity.compare(ref, got, gpu_parity.STAGED_TOL)
    assert mismatch == 1 / 128 and gap == 0.0
    assert failures == ["visit mismatch frac=0.0078"]
    far = types.SimpleNamespace(root_visit_counts=visits, root_value=values + 2e-4)
    assert "root values diverge" in gpu_parity.compare(ref, far, gpu_parity.STREAM_TOL)[2][0]


def test_profiling_table_and_trace_on_the_cpu(tmp_path):
    x = torch.randn(16, 16)
    rows, wall, _ = profiling.device_trace(lambda: (x @ x).relu(), "cpu", tmp_path, "t")
    names = {name for _, name, _ in rows}
    assert {"aten::mm", "aten::relu"} <= names and wall > 0
    assert (tmp_path / "t.json").exists()
    printed = []
    summary = profiling.top_ops_table([(3000.0, "a", 3), (1000.0, "b", 1)], 1, per=2,
                                      unit="step", unprofiled_ms=8.0, device="cpu",
                                      print_fn=printed.append)
    assert printed[0] == "# total cpu (host ops, nested) op time: 4.0 ms"
    assert printed[1] == ("# launches: 4 (2 names), 2.0 per step; unprofiled call 8.00 ms, "
                          "busy share: not measured")
    assert printed[2] == "      3.00 ms  x     3    1000.0 us/op  a"
    assert summary["launches_per_step"] == 2 and summary["busy_share"] is None
    cfg = port_config.load_game_module("atari").MuZeroConfig()
    assert profiling.stacked_shape(cfg) == (3 * 33 + 32, 96, 96)
    assert profiling.card_line("cpu").startswith("cpu (no card")


# ---------------------------------------------------------------------------
# The learning tools against the JAX package's, MuZero patched to a recorder
# ---------------------------------------------------------------------------

METRICS = [
    {"training_step": s, "total_reward": 10.0 + s, "muzero_reward": (-1.0, 0.0, 1.0)[s % 3],
     "num_played_games": s // 2}
    for s in range(0, 40, 3)
] + [{"phase_time_s": {"train": 12.345, "batch": 1.25, "selfplay": 3.75, "test": 0.5}}]


def recorder(log):
    """A MuZero stand-in recording its construction and calls into `log`;
    train() writes METRICS (and a line that is not JSON) to results_path."""

    class Recorder:
        def __init__(self, game_name, config=None, device=None, **kwargs):
            self.config = port_config.load_game_module(game_name).MuZeroConfig()
            port_config.apply_overrides(self.config, dict(config or {}))
            log.append(("init", game_name, dict(config or {})))
            self.device = device
            self.make_env = lambda seed=None: "env"
            self.checkpoint = {"weights": {}}
            self.network = types.SimpleNamespace(load_state_dict=lambda state: None)
            self.runner = "runner"

        def train(self, log_in_tensorboard=True):
            env = self.make_env(seed=5)
            if env != "env":
                log.append(("make_env", type(env).__name__, env.deterministic, env._seed))
            log.append(("train", log_in_tensorboard))
            path = self.config.results_path
            if path is not None:
                path = pathlib.Path(path)
                path.mkdir(parents=True, exist_ok=True)
                with open(path / "metrics.jsonl", "w") as f:
                    f.write("not json\n")
                    f.writelines(json.dumps(r) + "\n" for r in METRICS)
            return {"training_step": self.config.training_steps, "num_played_games": 7}

        def test(self, render=False, opponent=None, muzero_player=None, num_tests=1, **kw):
            log.append(("test", opponent, num_tests))
            return 100.0 + self.config.num_simulations + self.config.seed

        def load_model(self, checkpoint_path=None, replay_buffer_path=None):
            log.append(("load_model", pathlib.Path(checkpoint_path).name))

        # The JAX package's names for the weights (retest_snapshots)
        def _restore_state(self):
            return "state"

        def _variables(self, state):
            return "variables"

    return Recorder


def fake_game(log, opponent, muzero_player, seed):
    log.append(("play", opponent, muzero_player, seed))
    rewards = np.zeros(5, np.float32)
    rewards[1 + seed % 4] = 1.0  # a win, a loss, or no reward (a draw)
    return types.SimpleNamespace(rewards=rewards, to_play=np.array([0, 1, 0, 1, 0]))


def run_both(name, monkeypatch, capsys, args, tmp_path):
    """Both packages' tool `name` on `args` with MuZero recorded and a
    fake clock. Returns {package: (log, stdout lines)}; the port's card line
    is checked and dropped."""
    out = {}
    for package, mz_module, ev_module in (("jax", jax_muzero, jax_evaluate),
                                          ("port", port_muzero, port_evaluate)):
        log = []
        monkeypatch.setattr(mz_module, "MuZero", recorder(log))
        if package == "jax":
            monkeypatch.setattr(ev_module, "play_against_opponent",
                                lambda env, runner, cfg, variables, opponent, player, seed:
                                fake_game(log, opponent, player, seed))
        else:
            monkeypatch.setattr(ev_module, "play_against_opponent",
                                lambda env, network, cfg, opponent, player, seed:
                                fake_game(log, opponent, player, seed))
        clock = itertools.count(1000.0, 37.5)
        monkeypatch.setattr(time, "time", lambda: next(clock))
        if package == "jax":
            tool = jax_tool(name)
            if name == "lander_curve":  # its /tmp results under tmp_path
                monkeypatch.setattr(tool, "pathlib", types.SimpleNamespace(
                    Path=lambda p: tmp_path / pathlib.PurePath(p).name))
            monkeypatch.setattr(sys, "argv", [name] + args)
            tool.main()
        else:
            monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
            tool = PORT_TOOLS[name]
            assert tool.main(args + ["--device", "cpu"]) == 0
        monkeypatch.undo()
        lines = capsys.readouterr().out.splitlines()
        if package == "port":
            assert lines[0].startswith("cpu (no card")
            lines = lines[1:]
        out[package] = (log, lines)
    return out


PORT_TOOLS = {m.__name__.rsplit(".", 1)[1]: m for m in (
    connect4_gate, device_replay_bench, gumbel_proof, lander_curve, retest_snapshots)}
LEARNING_CASES = {
    "device_replay_bench": ["--steps", "40", "--games", "8", "--ratio", "0.5", "--out", "{tmp}/dr"],
    "connect4_gate": ["--steps", "39", "--out", "{tmp}/gate", "--snapshot", "10", "--seed", "2",
                      "--override", '{"PER": false}', "--fresh", "--batch-leaves", "2"],
    "gumbel_proof": ["--steps", "12", "--tests", "3", "--seeds", "2", "--opponent", "random"],
    "lander_curve": ["--steps", "36", "--tests", "2", "--seeds", "2"],
    "retest_snapshots": ["--dir", "{tmp}/snaps", "--games", "5", "--also-final"],
}


@pytest.mark.parametrize("name", sorted(LEARNING_CASES))
def test_learning_tool_matches_the_jax_tool(name, tmp_path, monkeypatch, capsys):
    for snap in ("model_100.checkpoint", "model_20.checkpoint", "model.checkpoint"):
        (tmp_path / "snaps").mkdir(exist_ok=True)
        (tmp_path / "snaps" / snap).write_bytes(b"")
    args = [a.replace("{tmp}", str(tmp_path)) for a in LEARNING_CASES[name]]
    out = run_both(name, monkeypatch, capsys, args, tmp_path)
    (jax_log, jax_lines), (port_log, port_lines) = out["jax"], out["port"]
    assert port_log == jax_log
    assert port_lines == jax_lines
    table = [line for line in jax_lines if line.startswith("| ")]
    assert len(table) >= 2, jax_lines
    kinds = {entry[0] for entry in jax_log}
    assert "init" in kinds
    if name == "retest_snapshots":
        assert [e[1] for e in jax_log if e[0] == "load_model"] == [
            "model_20.checkpoint", "model_100.checkpoint", "model.checkpoint"]
    if name == "lander_curve":
        assert ("make_env", "LunarLander", False, 5) in jax_log


def test_lander_curve_at_matches_the_jax_tool():
    rows = [{"training_step": s, "total_reward": float(r)}
            for s, r in ((0, -3.0), (5, 1.5), (5, 2.5), (12, 7.0), (30, -1.0))]
    jax_curve_at = jax_tool("lander_curve").curve_at
    for milestones in ([3, 6, 9, 12], [0, 30, 31], [-1, 4], []):
        np.testing.assert_equal(lander_curve.curve_at(rows, milestones),
                                jax_curve_at(rows, milestones))
