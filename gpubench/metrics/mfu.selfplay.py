"""The network's share of the card's peak in self-play: one initial
inference a lane a move and one recurrent inference a lane a simulation,
counted from the configuration's shapes (yardstick/flops.py), over the
wall time of the traced run's unprofiled play() calls, against the peak of
the configuration's compute dtype."""

from gpubench.yardstick import flops, peaks


def read(r):
    calls = [c for c in r["calls"] if not c["profiled"]]
    if r["device_type"] != "cuda" or not calls:
        return None
    cfg = r["config"]
    moves = sum(c["moves"] for c in calls)
    work = moves * flops.selfplay_move_flops(cfg, r["lanes"], r["simulations"])
    return 100 * work / sum(c["wall_s"] for c in calls) / peaks.peak_flops(cfg["compute_dtype"])
