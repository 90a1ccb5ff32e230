"""The program's own spans and counters (the port's tracing.py) in the
traced run: the idle time of the profiled call by the program's phase, and
its counter events.

The program records its spans, on the clock the profiler stamps device
events with, while a torch profiler runs, so they cover the profiled calls.
A reader hands `take`, a function that imports the port's tracing module
and calls its `take()` (the reader imports it, so that this file imports
nothing of the program); the spans are taken once and kept in the readings
for the other readers. A program without the tracer, or a run in which it
recorded nothing in the window, gives None.

An idle gap of the profiled call (trace.py idle_gaps) is named by the
innermost program span at its middle ("" where none holds it). The gaps are
then scaled by (median unprofiled wall - busy) / (profiled wall - busy):
the profiler stretches the host's side of the call, not its device time,
and the scale puts the phases onto the unprofiled call's idle time. So the
phases, "" included, add up to the idle time behind idle_share.* (trace.py
idle_percent).
"""

from gpubench.yardstick import trace


def taken(r, take):
    """The program's (spans, events) of the run, or None: taken from the
    tracer by the first reader, kept in `r` for the others."""
    if "program" not in r:
        try:
            r["program"] = take()  # (spans, events, dropped)
        except ImportError:  # a program without the tracer
            r["program"] = None
    return r["program"]


def _window(r, window_name):
    tr = r.get("trace")
    wins = trace.windows(tr, window_name) if tr is not None else []
    return (tr, wins[0]) if wins else (tr, None)


def _median_wall_ns(r):
    walls = sorted(c["wall_s"] for c in r["calls"] if not c["profiled"])
    return walls[len(walls) // 2] * 1e9 if walls else None


def idle_by_phase(r, window_name, take):
    """{innermost program span name, "" outside all: scaled idle ns} of the
    profiled call `window_name`; None without program spans in it, device
    operations, or unprofiled calls."""
    got = taken(r, take)
    tr, win = _window(r, window_name)
    median = _median_wall_ns(r)
    if got is None or win is None or median is None or not trace.ops_in(tr, win):
        return None
    lo, hi = win
    spans = sorted((max(s, lo), min(e, hi), n) for s, e, n in got[0] if e > lo and s < hi)
    busy = trace.busy_ns(tr, win)
    if not spans or hi - lo <= busy:
        return None
    scale = (median - busy) / (hi - lo - busy)
    gaps = trace.idle_gaps(tr, win)
    names = trace.innermost_spans(spans, [(s + e) // 2 for s, e in gaps])
    phases = {}
    for (s, e), name in zip(gaps, names):
        phases[name] = phases.get(name, 0.0) + (e - s) * scale
    return phases


def idle_ns(phases, keep):
    """The scaled idle ns of the phases whose name `keep(name)` accepts."""
    return sum(ns for name, ns in phases.items() if keep(name))


def events_in(r, window_name, take, name):
    """The sum of the n of the program's counter events `name` inside the
    profiled call; None without program spans in it."""
    got = taken(r, take)
    tr, win = _window(r, window_name)
    if got is None or win is None:
        return None
    lo, hi = win
    if not any(e > lo and s < hi for s, e, _ in got[0]):
        return None
    return sum(n for t, ev, n, _ in got[1] if ev == name and lo <= t <= hi)


def profiled_sum(r, key):
    """The sum of `key` (moves, steps) over the profiled calls."""
    return sum(c[key] for c in r["calls"] if c["profiled"])
