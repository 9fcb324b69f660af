"""The stop path: ``fsm.apply`` ms of a wave's deregister evals (the
plan that stops every allocation), summed per wave; p50 over the
window's waves."""

from nomadbench import stats


def read(run):
    per_wave = stats.per_group_sums(run, "deregister", "fsm.apply")
    return stats.median([v for v in per_wave.values() if v > 0])
