"""The planar descent kernel's share of its roofline in the profiled play()
call: each launch's least time by the bytes and operations its own tree
needs (yardstick/treework.py, from the launch's leaf depths), summed, over
the device time of the kernel's events (descend_kernel<true, ...>)."""

from gpubench.yardstick import peaks, trace


def read(r):
    kernel_s = trace.kernel_seconds(r, "play", "descend_kernel<true")
    work = r["tree_work"]["descend_planar"]
    if not kernel_s or not work:
        return None
    return 100 * sum(peaks.bound_seconds(f, b) for f, b in work) / kernel_s
