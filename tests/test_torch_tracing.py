"""The port's spans and counters (muzero_general_tpu_torch/tracing.py): off
by default, on under a torch profiler or after enable(), stamped on
time.time_ns's clock; the search's phases on each route nested in the
self-play driver's moves; the learner's phases in order; the host_sync
count of a chunk against its sites; the cap; MuZero.train's phase_time
from its loop spans; the spans in the operator's Chrome trace; and the
tools' busy share as a union of device intervals.

The `gpu` test runs a connect4 chunk on the card under torch's sync debug
mode, where every synchronizing operation warns, and holds the warnings
against the host_sync count; it also shows the tracer on under a profiler
that records the card's activity alone, and off without one. The file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_tracing.py
"""

import json
import sys
import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from muzero_general_tpu_torch import tracing
from muzero_general_tpu_torch.config import load_game_module
from muzero_general_tpu_torch.models import MuZeroNetwork
from muzero_general_tpu_torch.muzero import MuZero
from muzero_general_tpu_torch.ops import mcts as mcts_ops
from muzero_general_tpu_torch.selfplay import MoveRecord, SelfPlayDriver
from muzero_general_tpu_torch.tools import profiling
from muzero_general_tpu_torch.trainer import Learner

SEARCH_PHASES = {"search.root", "search.select", "search.gather", "search.network",
                 "search.decode", "search.expand", "search.backprop", "search.action",
                 "search.finish"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _driver(leaves=1, kernels=True, lanes=8, sims=16, moves=2, device="cpu", seed=7):
    cfg = load_game_module("connect4").MuZeroConfig()
    cfg.parallel_games, cfg.num_simulations, cfg.selfplay_chunk_moves = lanes, sims, moves
    cfg.search_batch_leaves, cfg.use_pallas_mcts = leaves, kernels
    env = load_game_module("connect4").make_env(device=device)
    return SelfPlayDriver(env, MuZeroNetwork(cfg, device, 0), cfg, seed=seed, device=device)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_nothing_is_recorded_by_default():
    with tracing.span("a"):
        pass
    assert tracing.end(tracing.begin(), "b") == 0
    before = tracing.counters().get("c", 0)
    tracing.count("c", 2, site="here")
    got = tracing.take()
    assert got.spans == [] and got.events == [] and got.dropped == 0
    totals = tracing.counters()  # the totals are always kept
    assert totals["c"] == before + 2 and totals["c:here"] >= 2
    assert "descend_planar" in totals  # beside the kernel wrappers' launch counts


@pytest.mark.parametrize("switch", ["profiler", "enable"])
def test_spans_record_when_on_on_the_unix_clock(switch):
    def work():
        t0 = time.time_ns()
        with tracing.span("outer"):
            t = tracing.begin()
            t = tracing.end(t, "first")
            tracing.end(t, "second")
            tracing.count("c", 3, site="s")
        return t0, time.time_ns()

    if switch == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            t0, t1 = work()
    else:
        tracing.enable()
        t0, t1 = work()
        tracing.disable()
    got = tracing.take()
    assert [n for _, _, n in got.spans] == ["first", "second", "outer"]
    first, second, outer = got.spans
    assert t0 <= outer[0] and outer[1] <= t1  # time.time_ns's clock
    assert first[1] == second[0]  # one phase ends where the next begins
    assert _inside(first, outer) and _inside(second, outer)
    assert [(n, k, s) for _, n, k, s in got.events] == [("c", 3, "s")]
    assert outer[0] <= got.events[0][0] <= outer[1]


def test_the_cap_counts_dropped_records(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 5)
    tracing.enable()
    for i in range(4):
        with tracing.span(f"s{i}"):
            pass
    for _ in range(3):
        tracing.count("c")
    got = tracing.take()
    assert len(got.spans) == 4 and len(got.events) == 1 and got.dropped == 2
    assert tracing.take().dropped == 0


@pytest.mark.parametrize("route", ["kernel", "plain", "multileaf", "stream"])
def test_search_phases_nest_in_the_drivers_moves(route):
    driver = _driver(leaves=8 if route == "multileaf" else 1, kernels=route != "plain")
    assert driver.spec.use_kernels == (route != "plain")
    if route == "stream":  # the stream kernels' plain versions
        driver.spec = driver.spec._replace(use_kernels=False, use_stream=True)
    tracing.enable()
    driver.play(1.0)
    tracing.disable()
    spans = tracing.take().spans
    names = [n for _, _, n in spans]
    assert SEARCH_PHASES <= set(names)
    assert {"selfplay.chunk", "selfplay.fold", "selfplay.move", "selfplay.env",
            "selfplay.records"} <= set(names)
    moves = [s for s in spans if s[2] == "selfplay.move"]
    chunk = [s for s in spans if s[2] == "selfplay.chunk"]
    assert len(moves) == 2 and len(chunk) == 1
    assert all(_inside(m, chunk[0]) for m in moves)
    for s in spans:
        if s[2].startswith("search."):
            assert any(_inside(s, m) for m in moves), s
    roots = [s for s in spans if s[2] == "search.root"]
    nets = [s for s in spans if s[2] == "search.network"]
    # One network call a move at the root, one a simulation (a round of K).
    sims = 16 // driver.spec.batch_leaves
    assert len(nets) == 2 * (1 + sims)
    assert sum(any(_inside(n, r) for r in roots) for n in nets) == 2


def test_learner_phases_once_a_step_in_order():
    cfg = load_game_module("cartpole").MuZeroConfig()
    cfg.batch_size, cfg.num_unroll_steps = 4, 2
    learner = Learner(cfg, "cpu", seed=0)
    M, B, U, A = 3, cfg.batch_size, cfg.num_unroll_steps, len(cfg.action_space)
    g = torch.Generator().manual_seed(0)
    batches = {
        "observation": torch.rand((M, B) + profiling.stacked_shape(cfg), generator=g),
        "action": torch.randint(0, A, (M, B, U + 1), generator=g, dtype=torch.int32),
        "target_value": torch.randn((M, B, U + 1), generator=g),
        "target_reward": torch.randn((M, B, U + 1), generator=g),
        "target_policy": torch.softmax(torch.randn((M, B, U + 1, A), generator=g), -1),
        "weight": torch.ones((M, B)),
        "gradient_scale": torch.full((M, B, U + 1), float(U)),
    }
    tracing.enable()
    learner.train_steps(batches)
    tracing.disable()
    spans = tracing.take().spans
    step = ["train.forward", "train.backward", "train.optimizer", "train.schedule"]
    assert [n for _, _, n in spans] == ["train.to_device"] + step * M
    ordered = sorted(spans)
    assert [n for _, _, n in ordered] == ["train.to_device"] + step * M
    for (_, end, _), (start, _, _) in zip(ordered[1:], ordered[2:]):
        assert end <= start


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel", "plain"])
def test_host_sync_count_of_a_chunk_matches_its_sites(kernels, monkeypatch):
    driver = _driver(kernels=kernels)
    S, moves = 16, 2
    # sample_gamma's rejection rounds, each ending in a host read of `pending`
    rounds = []
    any_ = torch.Tensor.any

    def counted_any(self, *args, **kwargs):
        if sys._getframe(1).f_code is mcts_ops.sample_gamma.__code__:
            rounds.append(1)
        return any_(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "any", counted_any)
    net = driver.network.folded_twin()
    fold = sum(t.numel() > 0 for t in list(net.parameters()) + list(net.buffers()))
    tracing.take()
    tracing.enable()
    driver.play(1.0)
    tracing.disable()
    sites = {}
    for _, name, n, site in tracing.take().events:
        if name == "conv3x3":  # the folded twin's 3x3 convs, counted by route
            continue
        assert name == "host_sync"
        sites[site] = sites.get(site, 0) + n
    want = {"selfplay.records": len(MoveRecord._fields), "selfplay.fold": fold,
            "search.noise": len(rounds), "search.expand": moves * S}
    if not kernels:  # the plain-op descent's loop bound, read on the host
        want["search.select"] = moves * S
    assert len(rounds) >= moves
    assert sites == want


def test_phase_time_is_the_loop_spans_totals(tmp_path):
    overrides = dict(training_steps=6, batch_size=4, num_simulations=4, parallel_games=2,
                     selfplay_chunk_moves=4, num_unroll_steps=2, td_steps=3,
                     checkpoint_interval=2, ratio=None, fused_train_steps=1, max_moves=12,
                     results_path=str(tmp_path))
    mz = MuZero("cartpole", overrides, device="cpu")
    tracing.enable()
    mz.train(log_in_tensorboard=True)
    tracing.disable()
    spans = tracing.take().spans
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    phase_lines = [x["phase_time_s"] for x in lines if "phase_time_s" in x]
    loops = [s for s in spans if s[2] == "loop.selfplay"]
    assert len(loops) == len(lines) - len(phase_lines) >= 1
    assert len(phase_lines) == len(loops) + 1  # every loop, and once at the end
    totals = dict.fromkeys(("selfplay", "test", "train", "reanalyse", "batch", "checkpoint"), 0)
    for start, end, name in spans:
        if name.startswith("loop."):
            totals[name[len("loop."):]] += end - start
    assert phase_lines[-1] == {k: ns / 1e9 for k, ns in totals.items()} == mz.phase_time
    assert totals["train"] > 0 and totals["selfplay"] > 0


def test_program_spans_join_the_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("program.work"):
            (x @ x).relu()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tracing.add_to_chrome_trace(path, tracing.take().spans)
    events = json.loads(path.read_text())["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program"]
    row = [e for e in events if e.get("ph") == "M" and e.get("args") == {"name": "program"}]
    assert [e["name"] for e in mine] == ["program.work"] and row[0]["pid"] == mine[0]["pid"]
    ops = [e for e in events if e.get("name") == "aten::relu"]
    # the op lies inside the span, on the file's own time base
    assert mine[0]["ts"] <= ops[0]["ts"]
    assert ops[0]["ts"] + ops[0]["dur"] <= mine[0]["ts"] + mine[0]["dur"]


def test_tools_busy_share_is_a_union_of_device_intervals():
    assert profiling.union_ns([(0, 10), (5, 20), (30, 40), (31, 32), (40, 41)]) == 31
    rows = profiling.DeviceRows([(3000.0, "a", 3), (3000.0, "b", 1)])
    rows.busy_us = profiling.union_ns([(0, 3_000_000), (0, 3_000_000)]) / 1e3  # overlapping
    printed = []
    summary = profiling.top_ops_table(rows, 2, unprofiled_ms=12.0, device="cuda",
                                      print_fn=printed.append)
    assert summary["total_ms"] == 6.0  # the kernels' time, summed
    assert summary["busy_share"] == 0.25  # 3 ms of the 12, overlaps counted once
    assert printed[1].endswith("the card busy 25.0%")
    rows.busy_us = None
    assert profiling.top_ops_table(rows, 2, unprofiled_ms=12.0, device="cuda",
                                   print_fn=printed.append)["busy_share"] is None


@pytest.mark.gpu
@pytest.mark.parametrize("leaves", [1, 8])
def test_host_sync_sites_are_complete_on_the_card(leaves):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    driver = _driver(leaves=leaves, lanes=64, sims=200, moves=8, device=torch.device("cuda"))
    assert driver.spec.use_kernels
    driver.play(1.0)  # builds or loads the kernels
    torch.cuda.synchronize()
    tracing.take()
    before = tracing.counters()["host_sync"]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            driver.play(1.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    assert syncs == tracing.counters()["host_sync"] - before > 0
    assert tracing.take().spans == []  # off without a profiler
    with profile(activities=[ProfilerActivity.CUDA]):  # the card's activity alone
        driver.play(1.0)
        torch.cuda.synchronize()
    names = {n for _, _, n in tracing.take().spans}
    assert {"selfplay.chunk", "search.network", "search.select"} <= names
