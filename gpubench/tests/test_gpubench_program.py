"""The readers of the program's own spans and counters (yardstick/program.py
and the metrics that use it) on made-up readings: the idle gaps named by
the innermost program span and scaled to the unprofiled calls add up, with
the gaps outside every program span, to the idle time behind idle_share;
each reader's value by hand; and None where the program recorded nothing
in the window or has no tracer."""

import pytest

from gpubench import harness
from gpubench.yardstick import program, trace

OPS = [(10, 20, "k"), (15, 30, "k"), (40, 50, "k"), (70, 80, "k"), (120, 130, "k")]
# busy 40 of the 100 ns window; gaps (0, 10) (30, 40) (50, 70) (80, 100),
# middles 5, 35, 60, 90.
PROGRAM_SPANS = [
    (-50, 88, "selfplay.chunk"),  # clipped to the window
    (2, 70, "selfplay.move"),
    (3, 8, "search.select"),
    (30, 39, "search.root"),
    (32, 38, "search.network"),  # nested in search.root
    (55, 65, "selfplay.env"),
    (110, 140, "search.select"),  # outside the window
]
EVENTS = [(5, "host_sync", 3, "selfplay.records"), (95, "host_sync", 1, "search.expand"),
          (150, "host_sync", 7, "search.expand"), (50, "other", 9, None)]


def readings(window="play", walls=(60, 70, 400), spans=PROGRAM_SPANS, events=EVENTS):
    calls = [{"profiled": True, "wall_s": 100e-9, "moves": 2, "steps": 4}] + [
        {"profiled": False, "wall_s": w * 1e-9, "moves": 2, "steps": 4} for w in walls]
    tr = trace.Trace(OPS, [(0, 100, window), (-60, -1, f"{window}.first")])
    r = {"trace": tr, "calls": calls, "simulations": 5}
    if spans is not None:
        r["program"] = (spans, events)
    return r


def no_take():
    raise AssertionError("the readings hold the program's spans already")


def test_phases_and_outside_add_up_to_the_idle_time():
    r = readings()
    phases = program.idle_by_phase(r, "play", no_take)
    # the unprofiled median 70 ns: scale (70 - 40) / (100 - 40)
    assert phases == pytest.approx({"search.select": 5, "search.network": 5,
                                    "selfplay.env": 10, "": 10})
    # idle_share's idle time: the median unprofiled call less the busy time
    assert trace.idle_percent(r, "play") == pytest.approx(100 * (70 - 40) / 70)
    assert sum(phases.values()) == pytest.approx(70 - trace.busy_ns(r["trace"], (0, 100)))


@pytest.mark.parametrize("name, window, value", [
    ("search_idle_us_per_sim.selfplay", "play", 5 / 1e3 / (2 * 5)),
    ("network_idle_us_per_sim.selfplay", "play", 5 / 1e3 / (2 * 5)),
    ("driver_idle_ms_per_move.selfplay", "play", 10 / 1e6 / 2),
    ("host_syncs_per_move.selfplay", "play", (3 + 1) / 2),
])
def test_selfplay_readers_by_hand(name, window, value):
    assert harness.load_reader(name)(readings(window)) == pytest.approx(value)


@pytest.mark.parametrize("name, span", [("forward_idle_ms_per_step.train", "train.forward"),
                                        ("backward_idle_ms_per_step.train", "train.backward")])
def test_train_readers_by_hand(name, span):
    spans = [(0, 100, "train.schedule"), (25, 45, "train.forward"),
             (45, 95, "train.backward")]
    r = readings("train_steps", spans=spans, events=[])
    # gap middles 35 (forward), 60 and 90 (backward); scale 0.5; 4 steps
    want = {"train.forward": 5, "train.backward": 20}[span] / 1e6 / 4
    assert harness.load_reader(name)(r) == pytest.approx(want)


READERS = ["search_idle_us_per_sim.selfplay", "network_idle_us_per_sim.selfplay",
           "driver_idle_ms_per_move.selfplay", "host_syncs_per_move.selfplay",
           "forward_idle_ms_per_step.train", "backward_idle_ms_per_step.train"]


@pytest.mark.parametrize("name", READERS)
def test_readers_without_program_spans_give_none(name):
    window = "train_steps" if name.endswith(".train") else "play"
    assert harness.load_reader(name)(readings(window, spans=[])) is None
    assert harness.load_reader(name)(readings(window, spans=[(200, 300, "x")])) is None
    # a program without the tracer: the import fails, nothing raises
    r = readings(window, spans=None)
    assert program.idle_by_phase(r, window, lambda: __import__("no_such_tracer")) is None
    assert r["program"] is None and harness.load_reader(name)(r) is None
    # no trace (a run off the card)
    assert harness.load_reader(name)({"trace": None, "calls": [], "program": ([], [])}) is None


def test_readers_take_the_programs_spans_once():
    from muzero_general_tpu_torch import tracing

    tracing.take()
    for start, end, name in PROGRAM_SPANS:
        tracing.add_span(start, end, name)
    r = readings(spans=None)
    first = harness.load_reader("search_idle_us_per_sim.selfplay")(r)
    second = harness.load_reader("network_idle_us_per_sim.selfplay")(r)
    assert first == second == pytest.approx(5 / 1e3 / 10)
    assert tracing.take().spans == []
