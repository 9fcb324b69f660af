"""In-process counters, gauges and samples: the slice of nomad_tpu.telemetry
that the ported scheduler path and server loop call (``incr_counter``,
``set_gauge``, ``add_sample``, ``measure_since``), with an in-memory
read-out (``snapshot``) for ``Server.stats()`` and the tests. Sinks,
intervals and Prometheus exposition come with the observability slice.

Keys are tuples of names, flattened with dots (no service prefix).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

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
