"""The learner's share of the card's peak: the unrolled loss's forward and
backward FLOPs (backward twice the forward, recomputation not counted;
yardstick/flops.py) at the configuration's batch, over the wall time of the
traced run's unprofiled train_steps calls, against the peak of the
configuration's compute dtype."""

from gpubench.yardstick import flops, peaks


def read(r):
    calls = [c for c in r["calls"] if not c["profiled"]]
    if r["device_type"] != "cuda" or not calls:
        return None
    cfg = r["config"]
    steps = sum(c["steps"] for c in calls)
    work = steps * flops.train_step_flops(cfg, r["batch"])
    return 100 * work / sum(c["wall_s"] for c in calls) / peaks.peak_flops(cfg["compute_dtype"])
