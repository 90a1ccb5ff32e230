"""The self-play driver's idle time a move: the card's idle time in the
profiled play() call under the program's selfplay.* spans outside any
search.* span (the fold, the env step, history and resets, the records'
copy and cut), scaled to the unprofiled calls (yardstick/program.py), over
the call's moves, in milliseconds."""

from gpubench.yardstick import program


def _take():
    from muzero_general_tpu_torch import tracing

    return tracing.take()


def read(r):
    phases = program.idle_by_phase(r, "play", _take)
    if phases is None:
        return None
    ns = program.idle_ns(phases, lambda n: n.startswith("selfplay."))
    return ns / 1e6 / program.profiled_sum(r, "moves")
