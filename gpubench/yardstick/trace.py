"""The traced run's reading of torch.profiler: the device's operations of a
profiled call and the benchmark's own host spans, on one clock.

A profiled call runs under `torch.profiler.profile` recording CUDA
activity alone, so the call runs at about its unprofiled speed. The
benchmark's spans (spans.py) are host intervals taken with the clock the
profiler stamps device events with. `parse` reads the raw kineto events
(not `key_averages()`, whose event objects take tens of seconds to build
for a few hundred thousand kernels) into device intervals.

Busy time is the union of the device intervals, not their sum, so
operations that overlap or run on several streams are counted once. An
idle gap is a stretch of a profiled span in which no device operation ran;
it is named by the innermost benchmark span the host was in at the gap's
middle.
"""

from typing import NamedTuple


class Trace(NamedTuple):
    ops: list  # (start_ns, end_ns, name) of every device operation
    spans: list  # (start_ns, end_ns, name) of every benchmark span


def parse(prof, spans) -> Trace:
    """Device operations of a finished profiler (None: none) and the
    benchmark's spans."""
    ops = []
    if prof is not None:
        from torch.autograd import DeviceType

        for evt in prof.profiler.kineto_results.events():
            if evt.device_type() == DeviceType.CUDA:
                start = evt.start_ns()
                ops.append((start, start + evt.duration_ns(), evt.name()))
    return Trace(sorted(ops), sorted(spans))


def union(intervals):
    """Merged (start, end) of sorted (start, end, ...) intervals."""
    merged = []
    for start, end, *_ in intervals:
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def clip(intervals, lo, hi):
    """The parts of merged intervals that lie in [lo, hi]."""
    out = []
    for start, end in intervals:
        s, e = max(start, lo), min(end, hi)
        if e > s:
            out.append((s, e))
    return out


def windows(trace: Trace, name: str):
    """(start, end) of every span called `name`: the profiled calls."""
    return [(s, e) for s, e, n in trace.spans if n == name]


def busy_ns(trace: Trace, window):
    """Nanoseconds of `window` in which some device operation ran."""
    return sum(e - s for s, e in clip(union(trace.ops), *window))


def outside_ns(trace: Trace, window, before=None):
    """Nanoseconds of device operations outside `window` and, if given, the
    stretch `before` it: 0 where the host's clock and the profiler's agree
    and the two hold every profiled operation."""
    inside = busy_ns(trace, window) + (busy_ns(trace, before) if before else 0)
    return sum(e - s for s, e in union(trace.ops)) - inside


def ops_in(trace: Trace, window):
    """The device operations that start inside `window`."""
    lo, hi = window
    return [op for op in trace.ops if lo <= op[0] < hi]


def top_ops(ops, n=10):
    """[(name, seconds)] of the n operation names with the most device time."""
    totals = {}
    for start, end, name in ops:
        totals[name] = totals.get(name, 0) + (end - start)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in ranked]


def idle_gaps(trace: Trace, window):
    """The device's idle stretches inside `window`, as (start, end)."""
    lo, hi = window
    gaps, t = [], lo
    for s, e in clip(union(trace.ops), lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def innermost_spans(spans, points):
    """For each time in `points` (sorted), the name of the innermost span
    containing it ("" where none does). Spans nest, as the host's calls do."""
    events = []  # (time, kind, ...) with ends before starts at a tie
    for i, (s, e, name) in enumerate(spans):
        events.append((s, 1, i))
        events.append((e, 0, i))
    events.sort()
    starts = [ev[0] for ev in events]
    out = []
    stack = []
    k = 0
    for p in points:
        while k < len(events) and starts[k] <= p:
            _, kind, i = events[k]
            if kind == 1:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            k += 1
        out.append(spans[stack[-1]][2] if stack else "")
    return out


def idle_by_span(trace: Trace, window, n=10):
    """[(span name, seconds)] of the n spans that the host was in during
    the most idle device time inside `window`."""
    gaps = idle_gaps(trace, window)
    mids = [(s + e) // 2 for s, e in gaps]
    order = sorted(range(len(gaps)), key=mids.__getitem__)
    names = innermost_spans(trace.spans, [mids[i] for i in order])
    totals = {}
    for i, name in zip(order, names):
        s, e = gaps[i]
        totals[name or "outside spans"] = totals.get(name or "outside spans", 0) + (e - s)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in ranked]


def profiled_ops(readings, window_name):
    """The device operations of a run's profiled call `window_name` (none
    where the run has no trace or the call ran no device operation)."""
    tr = readings.get("trace")
    wins = windows(tr, window_name) if tr is not None else []
    return ops_in(tr, wins[0]) if wins else []


def kernel_seconds(readings, window_name, fragment):
    """Device seconds of the profiled call's operations whose name holds
    `fragment`."""
    return sum(e - s for s, e, name in profiled_ops(readings, window_name)
               if fragment in name) / 1e9


def idle_percent(readings, window_name):
    """100 * (1 - busy / wall): the device time of the profiled call (a
    union), over the median wall time of the same run's unprofiled calls,
    which do the same work; None without device operations. The profiled
    call itself is not the divisor: the profiler's per-launch cost stretches
    its wall time (a fifth at 1,024 lanes, K = 1), not its device time."""
    tr = readings.get("trace")
    walls = sorted(c["wall_s"] for c in readings["calls"] if not c["profiled"])
    if not profiled_ops(readings, window_name) or not walls:
        return None
    busy_s = busy_ns(tr, windows(tr, window_name)[0]) / 1e9
    return 100 * (1 - busy_s / walls[len(walls) // 2])
