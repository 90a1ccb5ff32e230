"""Device operations (kernels, copies, sets) a training step: those of the
profiled train_steps call over its steps."""

from gpubench.yardstick import trace


def read(r):
    ops = trace.profiled_ops(r, "train_steps")
    if not ops:
        return None
    return len(ops) / sum(c["steps"] for c in r["calls"] if c["profiled"])
