"""The learner's forward idle time a step: the card's idle time in the
profiled train_steps call under the program's train.forward spans (the
unrolled loss), scaled to the unprofiled calls (yardstick/program.py), over
the call's steps, in milliseconds."""

from gpubench.yardstick import program


def _take():
    from muzero_general_tpu_torch import tracing

    return tracing.take()


def read(r):
    phases = program.idle_by_phase(r, "train_steps", _take)
    if phases is None:
        return None
    return program.idle_ns(phases, lambda n: n == "train.forward") / 1e6 / program.profiled_sum(
        r, "steps")
