"""Due→complete ms of every job submission due in the window, p95 over
all of them."""

from nomadbench import stats


def read(run):
    return stats.pct(stats.latencies_ms(run.records, "register"), 95.0)
