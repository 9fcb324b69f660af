"""The water-fill kernel's share of its roofline over the window: each
launch's least time (``yardstick.waterfill_work`` on its inputs, over
the card's peaks) summed, over its device time summed (CUPTI)."""

from nomadbench import devtrace


def read(run):
    if run.devtrace is None or run.launches is None:
        return None
    return devtrace.roofline_pct(
        run.launches.waterfill_bounds_ms(),
        run.devtrace.kernel_times_s(devtrace.WATERFILL_KERNEL))
