"""The coalescer: the window's job submissions per water-fill launch
(``waterfill.LAUNCHES`` over the window)."""


def read(run):
    launches = run.counters.get("waterfill_launches", 0)
    evals = len(run.window_records("register"))
    return evals / launches if launches and evals else None
