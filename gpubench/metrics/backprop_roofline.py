"""The backprop kernel's share of its roofline in the profiled play() call:
each launch's least time by the bytes and operations its own path needs
(yardstick/treework.py, from the launch's leaf depths), summed, over the
device time of the kernel's events (backprop_kernel)."""

from gpubench.yardstick import peaks, trace


def read(r):
    kernel_s = trace.kernel_seconds(r, "play", "backprop_kernel")
    work = r["tree_work"]["backprop"]
    if not kernel_s or not work:
        return None
    return 100 * sum(peaks.bound_seconds(f, b) for f, b in work) / kernel_s
