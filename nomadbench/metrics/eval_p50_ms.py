"""Due→complete ms of every job submission due in the window, p50."""

from nomadbench import stats


def read(run):
    return stats.pct(stats.latencies_ms(run.records, "register"), 50.0)
