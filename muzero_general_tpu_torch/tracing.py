"""The port's spans and counters: where the program's own time goes, on the
clock the device's events are stamped with.

Spans. `span(name)` is a context manager; `begin()` and `end(token, name)`
are its cheaper form, which the program uses, where one phase ends as the
next begins:

    t = tracing.begin()
    ...                                  # phase a
    t = tracing.end(t, "search.select")  # ends a, starts b
    ...                                  # phase b
    tracing.end(t, "search.gather")

Each records (start_ns, end_ns, name) with `time.time_ns`, the Unix clock
torch.profiler stamps device events with, so the program's spans and the
card's kernels lie on one timeline. Names run by layer: `selfplay.*` (the
self-play driver), `search.*` (ops/mcts.py), `train.*` (trainer.py) and
`loop.*` (muzero.py).

When. A span records only while the tracer is on: after `enable()` (until
`disable()`), or while a torch profiler runs in the process, whatever
activities it records (`torch.autograd._profiler_enabled()`). So a profiled
call gets the spans with no switch. Off, `span` and `begin` cost one flag
check and allocate nothing, and `end` of a token `begin` gave while off
returns at once (a begin/end pair ~0.1-0.3 us off on an x86 host, `span`
~0.5-0.6 us; ~0.4-0.9 us on).

Counters. `count(name, n, site)` adds n to a running total that is always
kept, as the kernel wrappers' `.launches` are. While the tracer is on it
also records the event (t_ns, name, n, site), so a reader can count inside
a window. `host_sync` counts the self-play and search path's deliberate
waits on the device (a copy between host and device, a Python number of a
device tensor), each tagged with its site.

Reading. `take()` returns and clears what was recorded. The record is
capped at CAPACITY spans and events together; what comes past the cap is
dropped and counted. `counters()` gives the running totals beside the
kernel wrappers' launch counts.

`Phases` times spans always, whether the tracer is on or not, and keeps
their per-name totals: MuZero.train's loop phases (`loop.*`), its
`phase_time`. `add_to_chrome_trace` writes spans into a torch.profiler
Chrome trace, on a row of their own.
"""

import json
from time import time_ns
from typing import NamedTuple

import torch

CAPACITY = 1 << 20

_profiling = torch.autograd._profiler_enabled


class Taken(NamedTuple):
    spans: list  # (start_ns, end_ns, name), in the order they ended
    events: list  # (t_ns, name, n, site)
    dropped: int  # records that came past the cap


_enabled = False
_spans = []
_events = []
_dropped = 0
_totals = {}  # counter name (and name:site) -> running total


class _Off:
    """The span of a tracer that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.start = time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        add_span(self.start, time_ns(), self.name)


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def span(name):
    if _enabled or _profiling():
        return _Span(name)
    return _OFF


def begin() -> int:
    """A token for end(): the start time, or 0 while off."""
    return time_ns() if (_enabled or _profiling()) else 0


def end(token, name) -> int:
    """Record the span `name` from `token` to now; returns now, the token of
    the span that starts here (0 if `token` was)."""
    if not token:
        return 0
    now = time_ns()
    add_span(token, now, name)
    return now


def add_span(start_ns, end_ns, name):
    global _dropped
    if len(_spans) + len(_events) < CAPACITY:
        _spans.append((start_ns, end_ns, name))
    else:
        _dropped += 1


def count(name, n=1, site=None):
    """Add n to counter `name` and to `name:site`; record the event while
    the tracer is on."""
    global _dropped
    _totals[name] = _totals.get(name, 0) + n
    if site is not None:
        key = f"{name}:{site}"
        _totals[key] = _totals.get(key, 0) + n
    if _enabled or _profiling():
        if len(_spans) + len(_events) < CAPACITY:
            _events.append((time_ns(), name, n, site))
        else:
            _dropped += 1


def take() -> Taken:
    """What was recorded since the last take(), and clear it."""
    global _spans, _events, _dropped
    taken = Taken(_spans, _events, _dropped)
    _spans, _events, _dropped = [], [], 0
    return taken


def counters():
    """The running totals of every counter: the tracer's counters and the
    kernel wrappers' launches (tools/profiling.py launch_counts). A kernel's
    launches keep its name where a counter shares it: `conv3x3` is the
    fused conv's launches, the tracer's `conv3x3` calls are by site under
    `conv3x3:<site>`."""
    from muzero_general_tpu_torch.tools.profiling import launch_counts

    return {**_totals, **launch_counts()}


class Phases:
    """Spans timed always, with per-name totals: `seconds[name]`, kept as
    whole nanoseconds in `ns`, so a total equals the sum of its recorded
    spans. A span is recorded as `prefix + name` while the tracer is on."""

    def __init__(self, prefix, names):
        self.prefix = prefix
        self.ns = dict.fromkeys(names, 0)
        self.seconds = dict.fromkeys(names, 0.0)

    def lap(self, name, start_ns) -> int:
        """End the span `name` begun at `start_ns` (a time.time_ns()); returns
        its end, where the next span may begin."""
        stop = time_ns()
        self.ns[name] += stop - start_ns
        self.seconds[name] = self.ns[name] / 1e9
        if _enabled or _profiling():
            add_span(start_ns, stop, self.prefix + name)
        return stop


def add_to_chrome_trace(path, spans):
    """Write `spans` into the Chrome trace at `path` (torch.profiler's
    export_chrome_trace) as complete events on a "program" row, converted
    with the file's own base time so they line up with its events."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    base_ns = int(doc.get("baseTimeNanoseconds", 0))
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "program"}})
    events.extend({"ph": "X", "cat": "program", "name": name, "pid": pid, "tid": 0,
                   "ts": (start - base_ns) / 1e3, "dur": (stop - start) / 1e3}
                  for start, stop, name in spans)
    with open(path, "w") as f:
        json.dump(doc, f)
