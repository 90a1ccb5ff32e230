"""The search's idle time a simulation: the card's idle time in the profiled
play() call under the program's search.* spans other than search.network
(the descent, gather, decode, expansion, backprop, root and action
selection), scaled to the unprofiled calls (yardstick/program.py), over the
call's moves x simulations, in microseconds."""

from gpubench.yardstick import program


def _take():
    from muzero_general_tpu_torch import tracing

    return tracing.take()


def read(r):
    phases = program.idle_by_phase(r, "play", _take)
    if phases is None:
        return None
    ns = program.idle_ns(phases, lambda n: n.startswith("search.") and n != "search.network")
    return ns / 1e3 / (program.profiled_sum(r, "moves") * r["simulations"])
