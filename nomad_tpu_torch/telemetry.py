"""In-process counters, gauges and samples: the slice of nomad_tpu.telemetry
that the ported scheduler path and server loop call (``incr_counter``,
``set_gauge``, ``add_sample``, ``measure_since``), with an in-memory
read-out (``snapshot``) for ``Server.stats()`` and the tests, plus the
two aggregates the SLO monitor, the express lane and the read books keep
(``AggregateSample``, ``BurnRateWindow``). Sinks, intervals and Prometheus
exposition come with the observability slice.

Keys are tuples of names, flattened with dots (no service prefix).
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch import prng

Key = Tuple[str, ...]

_lock = threading.Lock()
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
_samples: Dict[str, List[float]] = {}
_MAX_SAMPLES = 4096


def _flat(key: Key) -> str:
    return ".".join(key)


def incr_counter(key: Key, value: float = 1.0) -> None:
    k = _flat(key)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + value


def set_gauge(key: Key, value: float) -> None:
    with _lock:
        _gauges[_flat(key)] = float(value)


def add_sample(key: Key, value: float) -> None:
    k = _flat(key)
    with _lock:
        ring = _samples.setdefault(k, [])
        ring.append(value)
        del ring[:-_MAX_SAMPLES]


def measure_since(key: Key, start: float) -> None:
    """Record the ms elapsed since ``start`` (a time.perf_counter stamp)."""
    add_sample(key, (time.perf_counter() - start) * 1000.0)


def samples(key: Key) -> List[float]:
    """A copy of one sample key's retained ring, oldest first."""
    with _lock:
        return list(_samples.get(_flat(key), ()))


def _quantile(sorted_vals: List[float], q: float) -> float:
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def snapshot() -> Dict[str, Dict]:
    """Counters and gauges by flat key, and per sample key its count, mean,
    p50 and p95 over the retained ring (the last 4096 samples)."""
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        rings = {k: sorted(v) for k, v in _samples.items() if v}
    samples = {
        k: {"count": len(v), "mean": sum(v) / len(v),
            "p50": _quantile(v, 0.50), "p95": _quantile(v, 0.95)}
        for k, v in rings.items()
    }
    return {"counters": counters, "gauges": gauges, "samples": samples}


# Bounded reservoir per AggregateSample (Vitter's algorithm R).
RESERVOIR_SIZE = 256

QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))

# The reservoir's replacement draws: display-only (quantiles), never a
# decision, from one process-wide stream so no caller shares a cursor.
_reservoir_rng = prng.stream(0, "telemetry.reservoir")


class AggregateSample:
    """Streaming aggregate of one sample series (go-metrics inmem.go
    AggregateSample) with a bounded uniform reservoir for p50/p95/p99."""

    __slots__ = ("count", "sum", "sum_sq", "min", "max", "last", "last_time",
                 "reservoir")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.sum_sq = 0.0
        self.min = 0.0
        self.max = 0.0
        self.last = 0.0
        self.last_time = 0.0
        self.reservoir: List[float] = []

    def ingest(self, v: float) -> None:
        if self.count == 0 or v < self.min:
            self.min = v
        if self.count == 0 or v > self.max:
            self.max = v
        self.count += 1
        self.sum += v
        self.sum_sq += v * v
        self.last = v
        # Display-only wall stamp of the last sample; no arithmetic.
        self.last_time = time.time()
        # Algorithm R: after the reservoir fills, sample i survives with
        # probability RESERVOIR_SIZE/i.
        if len(self.reservoir) < RESERVOIR_SIZE:
            self.reservoir.append(v)
        else:
            j = _reservoir_rng.randrange(self.count)
            if j < RESERVOIR_SIZE:
                self.reservoir[j] = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def stddev(self) -> float:
        if self.count < 2:
            return 0.0
        var = (self.sum_sq - self.sum * self.sum / self.count) / (self.count - 1)
        return math.sqrt(var) if var > 0 else 0.0

    def quantiles(self) -> Dict[str, float]:
        """Nearest-rank p50/p95/p99 over the reservoir (0 when empty)."""
        if not self.reservoir:
            return {name: 0.0 for name, _ in QUANTILES}
        ordered = sorted(self.reservoir)
        n = len(ordered)
        return {
            name: ordered[max(0, min(n - 1, math.ceil(p * n) - 1))]
            for name, p in QUANTILES
        }


class BurnRateWindow:
    """Rolling-window error-budget accounting for one SLO objective (SRE
    workbook ch. 5). ``record(good)`` appends one sample; ``stats()``
    reports the bad fraction, the budget spent and the burn rate
    (bad_fraction / budget_fraction: 1.0 spends the budget exactly over
    the window). Monotonic timestamps; bounded at ``max_samples`` with
    oldest-first eviction, counted in ``evicted``."""

    __slots__ = ("window_s", "objective", "max_samples", "_lock",
                 "_samples", "evicted")

    def __init__(self, window_s: float = 3600.0, objective: float = 0.95,
                 max_samples: int = 8192):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.window_s = float(window_s)
        self.objective = float(objective)
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._samples: "collections.deque" = collections.deque()  # (t, good)
        self.evicted = 0

    def record(self, good: bool, t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else t
        with self._lock:
            self._samples.append((t, bool(good)))
            self._prune_locked(t)

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()
        while len(self._samples) > self.max_samples:
            self._samples.popleft()
            self.evicted += 1

    def stats(self, now: Optional[float] = None) -> Dict[str, float]:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prune_locked(now)
            total = len(self._samples)
            bad = sum(1 for _, good in self._samples if not good)
            evicted = self.evicted
        budget_fraction = 1.0 - self.objective
        bad_fraction = bad / total if total else 0.0
        burn = bad_fraction / budget_fraction
        return {
            "window_s": self.window_s,
            "objective": self.objective,
            "total": total,
            "bad": bad,
            "good_fraction": round(1.0 - bad_fraction, 6),
            "budget_spent_fraction": round(min(burn, 1.0), 6),
            "budget_remaining_fraction": round(max(0.0, 1.0 - burn), 6),
            "burn_rate": round(burn, 4),
            "evicted": evicted,
        }
