"""The generators that drive a cell's traffic, one module each, chosen by
the traffic file's "generator" key. Each has `run(cell, seed, seconds,
trace, device, t_start)` returning the run's result (see run.py)."""

from time import perf_counter as now
from time import time_ns

import torch

from gpubench.yardstick import trace as trace_lib


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profiled(fn, device, spans, name, between=None):
    """fn() twice under torch.profiler recording the card's operations only,
    the second call inside a span `name` of `spans` that lasts to the end of
    a device synchronize. Host operations are not recorded: recording each
    of a call's hundreds of thousands stretches it well past its unprofiled
    time, and the idle share would measure the profiler. The first call
    takes the profiler's start-up costs and is not measured; `between()`, if
    given, runs before the second. The first call's span is `<name>.first`.
    Returns (the profiler or None off the card, the second call's seconds),
    the profiler to be parsed (trace.parse) once the window has closed."""

    def call(span):
        start = time_ns()
        fn()
        sync(device)
        end = time_ns()
        spans.intervals.append((start, end, span))
        return (end - start) / 1e9

    def both():
        call(f"{name}.first")
        if between is not None:
            between()
        return call(name)

    sync(device)
    if torch.device(device).type != "cuda":
        return None, both()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_s = both()
    return prof, wall_s


def peak_bytes(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def release(device):
    """Hand the program's freed memory back before the reference runs."""
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def device_summary(readings, window_name):
    """The traced run's busy seconds, window seconds and breakdown from the
    profiled call named `window_name`; and a line for standard error with
    the profiled call's wall time against the median unprofiled call's, and
    the device time that lies outside the two profiled calls (0 where the
    host's clock and the profiler's agree)."""
    tr = readings.get("trace")
    wins = trace_lib.windows(tr, window_name) if tr is not None else []
    if not wins:
        return {}, None, None
    win = wins[0]
    busy = trace_lib.busy_ns(tr, win) / 1e9
    window_s = (win[1] - win[0]) / 1e9
    breakdown = {"device_ops": trace_lib.top_ops(trace_lib.ops_in(tr, win)),
                 "idle_gaps": trace_lib.idle_by_span(tr, win)}
    first = trace_lib.windows(tr, f"{window_name}.first")[0]
    walls = sorted(c["wall_s"] for c in readings["calls"] if not c["profiled"])
    note = (f"gpubench trace: busy {busy:.6f} s of a {window_s:.6f} s profiled call "
            f"(the profiler's first call {(first[1] - first[0]) / 1e9:.6f} s; device "
            f"operations outside both {trace_lib.outside_ns(tr, win, first) / 1e9:.6f} s); "
            f"unprofiled calls {walls[len(walls) // 2]:.6f} s (median of {len(walls)}), "
            f"stretch {window_s / walls[len(walls) // 2]:.4f}")
    return {"busy_s": busy, "window_s": window_s}, breakdown, note


def port_config(cell, seed):
    """The port's config of the cell: the game module's, with every key of
    the configuration file and the traffic set."""
    from muzero_general_tpu_torch.config import load_game_module

    cfg = load_game_module(cell.config["game"]).MuZeroConfig()
    for key, value in cell.config["config"].items():
        if not hasattr(cfg, key):
            raise SystemExit(f"gpubench: the port's config has no key {key!r}")
        setattr(cfg, key, tuple(value) if key == "observation_shape" else value)
    cfg.seed = seed
    return cfg
