"""The greedy scan kernel's share of its roofline over the window: each
launch's least time (``yardstick.greedy_work`` on its shapes, over the
card's peaks) summed, over its device time summed (CUPTI)."""

from nomadbench import devtrace


def read(run):
    if run.devtrace is None or run.launches is None:
        return None
    return devtrace.roofline_pct(
        run.launches.greedy_bounds_ms(),
        run.devtrace.kernel_times_s(devtrace.GREEDY_KERNEL))
