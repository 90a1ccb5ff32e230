"""Device traces for the port's tools and chip_smoke.py: one call of a
function under torch.profiler, its kernels summed by name, and the top-ops
table of the JAX package's tools/trace_search.py and tools/trace_train.py.

`device_trace(fn, device)` runs fn() once under torch.profiler and sums the
raw kineto events by name: device time and launches. It reads the raw
events, not `key_averages()`, whose event objects take tens of seconds to
build for the ~207,000 kernels of a gomoku move. On the card only the
device's activity is recorded (the host ops' events are not needed for the
busy share and would double what the profiler parses on exit); on the CPU
the table holds the CPU's operator events instead, nested ones included (an
op's time also counts in its callers'), which checks the tools' plumbing
and measures nothing of the card.

`top_ops_table` prints the JAX tools' table (`ms  xlaunches  us/op  name`)
under a header of the total device time, the launches per simulation or
per step, and the card's busy share of an unprofiled call of the same
function (timed by `timeit`: the profiler slows the host, so the share is
taken against a call it did not watch). The busy time is the union of the
kernels' intervals, so kernels that overlap count once. `--keep DIR` in the
tools writes the Chrome trace of the profiled call there
(`export_chrome_trace`), with the program's spans of the call (tracing.py)
on a row of their own.
"""

import pathlib
import subprocess
import time

import torch

from muzero_general_tpu_torch import tracing


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's stand-in line."""
    if torch.device(device).type != "cuda":
        return "cpu (no card: the tool measures nothing of a device)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timeit(fn, device, reps=1, warmup=0):
    """Mean host-clock seconds of fn() over `reps` calls after `warmup`
    calls, each ending in a device synchronize (as the JAX tools pulled a
    value to the host after each call)."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        synchronize(device)
    return (time.perf_counter() - t0) / reps


class DeviceRows(list):
    """device_trace's rows, (device us, name, launches), with `busy_us`: the
    union of the events' intervals, each moment some event ran counted
    once."""

    busy_us = None


def union_ns(intervals):
    """Nanoseconds covered by (start_ns, end_ns) intervals, overlaps once."""
    total, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def device_trace(fn, device="cuda", keep=None, name="trace"):
    """fn() once under torch.profiler. Returns the kernels (on the CPU: the
    operators) as DeviceRows, the profiled wall ms, and when the parse
    began. keep: a directory the Chrome trace is written to, as
    <name>.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    activity, kind = ((ProfilerActivity.CUDA, DeviceType.CUDA) if on_card
                      else (ProfilerActivity.CPU, DeviceType.CPU))
    synchronize(device)
    with profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    t_parse = time.perf_counter()
    spans = tracing.take().spans
    totals, intervals = {}, []
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != kind:
            continue  # runtime calls on the host
        total = totals.setdefault(evt.name(), [0.0, 0])
        total[0] += evt.duration_ns() / 1e3
        total[1] += 1
        intervals.append((evt.start_ns(), evt.start_ns() + evt.duration_ns()))
    if keep is not None:
        path = pathlib.Path(keep)
        path.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path / f"{name}.json"))
        tracing.add_to_chrome_trace(path / f"{name}.json", spans)
    rows = DeviceRows((dev_us, key, count) for key, (dev_us, count) in totals.items())
    rows.busy_us = union_ns(intervals) / 1e3
    return rows, wall, t_parse


def top_ops_table(rows, top, per=None, unit="simulation", unprofiled_ms=None, label="",
                  device="cuda", print_fn=print):
    """Print the top-`top` rows by total time in the JAX tools' columns
    under a summary header; return the summary: total_ms, launches,
    launches_per_<unit>, busy_share (the union of the rows' device intervals,
    DeviceRows.busy_us, over `unprofiled_ms`; None where either is not given
    or the trace holds no device time) and the top rows."""
    where = "device" if torch.device(device).type == "cuda" else "cpu (host ops, nested)"
    total_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[2] for r in rows)
    busy_us = getattr(rows, "busy_us", None)
    busy = None
    if unprofiled_ms and busy_us and where == "device":
        busy = busy_us / 1e3 / unprofiled_ms
    print_fn(f"# total {where} op time: {total_ms:.1f} ms{label}")
    line = f"# launches: {launches} ({len(rows)} names)"
    if per:
        line += f", {launches / per:.1f} per {unit}"
    if unprofiled_ms is not None:
        line += f"; unprofiled call {unprofiled_ms:.2f} ms"
        line += (f", the card busy {100 * busy:.1f}%" if busy is not None
                 else ", busy share: not measured")
    print_fn(line)
    ranked = sorted(rows, key=lambda r: -r[0])[:top]
    for dev_us, name, count in ranked:
        ms = dev_us / 1e3
        print_fn(f"{ms:10.2f} ms  x{count:6d}  {ms / max(count, 1) * 1e3:8.1f} us/op  {name[:110]}")
    return {"total_ms": total_ms, "launches": launches,
            f"launches_per_{unit}": launches / per if per else None, "busy_share": busy,
            "top": [{"name": n, "ms": us / 1e3, "launches": c} for us, n, c in ranked]}


def launch_counts():
    """Every kernel wrapper's launch count (each counts where it launches
    its kernel, on the card only)."""
    from muzero_general_tpu_torch.ops import (conv3x3, hidden_store, mcts_fused, mcts_kernels,
                                              mcts_stream)

    return {"mcts_fused_search": mcts_fused.search.launches,
            "descend_planar": mcts_kernels.descend_planar.launches,
            "descend": mcts_kernels.descend.launches,
            "backprop": mcts_kernels.backprop.launches,
            "descend_stream": mcts_stream.descend_stream.launches,
            "update_edges": mcts_stream.update_edges.launches,
            "write_node_hidden": hidden_store.write_node_hidden.launches,
            "conv3x3": conv3x3.conv3x3.launches}


def launches_since(before):
    """The kernels launched since `before` (a launch_counts()), those
    launched at least once."""
    return {k: n - before[k] for k, n in launch_counts().items() if n > before[k]}


def stacked_shape(config):
    """The network's stacked observation shape (C * (n + 1) + n, H, W): the
    JAX runner's stacked_observation_shape()."""
    c, h, w = config.observation_shape
    n = config.stacked_observations
    return (c * (n + 1) + n, h, w)
