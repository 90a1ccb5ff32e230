"""Device operations (kernels, copies, sets) a simulation: those of the
profiled play() call over its moves times the simulations a move."""

from gpubench.yardstick import trace


def read(r):
    ops = trace.profiled_ops(r, "play")
    if not ops:
        return None
    moves = sum(c["moves"] for c in r["calls"] if c["profiled"])
    return len(ops) / (moves * r["simulations"])
