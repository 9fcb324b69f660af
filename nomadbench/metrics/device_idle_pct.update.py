"""The device: the share of the traced window in which no operation ran
on the card (1 - the union of device time over the window, CUPTI)."""


def read(run):
    dt = run.devtrace
    if dt is None or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s() / dt.window_s)
