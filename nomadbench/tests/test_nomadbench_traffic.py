"""Traffic from the seed: the same seed gives the same traffic, another
seed other traffic of the same work; open-loop latencies run from the due
time; percentiles are over all requests."""

import json

import numpy as np

from nomadbench import stats
from nomadbench.drivers import open_service
from conftest import BENCH

MIX = json.loads((BENCH / "traffic" / "service-open.json").read_text())
SEEDS = (2 ** 31 + 7, 2 ** 32 + 11)


def sched(seed):
    return open_service.schedule(MIX, np.random.default_rng(seed), 10.0)


def test_same_seed_same_traffic_other_seed_other_order_same_work():
    a, b, c = sched(SEEDS[0]), sched(SEEDS[0]), sched(SEEDS[1])
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x, y)
        assert not np.array_equal(x, z)
    assert sorted(a[1]) == sorted(c[1])
    # The same gaps, but for the one each order leaves after the last.
    ga = {round(g, 9) for g in np.diff(a[0])}
    gc = {round(g, 9) for g in np.diff(c[0])}
    assert len(a[0]) == len(c[0]) and len(ga ^ gc) <= 2


def test_counts_are_heavy_tailed_over_the_range():
    counts = sched(SEEDS[0])[1]
    assert counts.min() >= 1 and counts.max() <= 420
    assert 6 <= np.median(counts) <= 10 and counts.max() > 100


def test_latency_runs_from_the_due_time():
    recs = [dict(kind="register", in_window=True, due=1.0, sent=1.5,
                 done=2.0, status="complete")]
    assert stats.latencies_ms(recs, "register") == [1000.0]


def test_percentiles_over_all_requests_and_failures_miss_every_limit():
    recs = [dict(kind="register", in_window=True, due=0.0, sent=0.0,
                 done=i / 1000.0, status="complete") for i in range(1, 20)]
    recs.append(dict(kind="register", in_window=True, due=0.0, sent=0.0,
                     done=None, status=""))
    xs = stats.latencies_ms(recs, "register")
    assert stats.pct(xs, 50) == 10.0
    assert stats.pct(xs, 95) == 19.0
    assert stats.pct(xs, 100) == stats.FAILED_MS
