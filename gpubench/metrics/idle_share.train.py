"""The card's idle share in the traced run's train_steps calls: 1 - the union of
the profiled call's device operations over the median wall time of the
run's unprofiled calls, in percent (yardstick/trace.py idle_percent)."""

from gpubench.yardstick import trace


def read(r):
    return trace.idle_percent(r, "train_steps")
