"""Due→complete ms of every deregistration due in the window, p95 over
all of them."""

from nomadbench import stats


def read(run):
    return stats.pct(stats.latencies_ms(run.records, "deregister"), 95.0)
