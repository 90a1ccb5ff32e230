"""Host syncs a move: the program's host_sync counter events (each a wait
of the host on the card: a copy between them, a Python number of a device
tensor) inside the profiled play() call, over its moves."""

from gpubench.yardstick import program


def _take():
    from muzero_general_tpu_torch import tracing

    return tracing.take()


def read(r):
    syncs = program.events_in(r, "play", _take, "host_sync")
    if syncs is None:
        return None
    return syncs / program.profiled_sum(r, "moves")
