"""The network's idle time a simulation: the card's idle time in the
profiled play() call under the program's search.network spans (the root's
and each simulation's inference call), scaled to the unprofiled calls
(yardstick/program.py), over the call's moves x simulations, in
microseconds."""

from gpubench.yardstick import program


def _take():
    from muzero_general_tpu_torch import tracing

    return tracing.take()


def read(r):
    phases = program.idle_by_phase(r, "play", _take)
    if phases is None:
        return None
    ns = program.idle_ns(phases, lambda n: n == "search.network")
    return ns / 1e3 / (program.profiled_sum(r, "moves") * r["simulations"])
