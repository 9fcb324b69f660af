"""In-process counters and samples: the slice of nomad_tpu.telemetry that
the ported scheduler path calls (``incr_counter``/``add_sample``). Sinks
and exposition come with the observability slice."""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

Key = Tuple[str, ...]

_lock = threading.Lock()
_counters: Dict[str, float] = {}
_samples: Dict[str, List[float]] = {}
_MAX_SAMPLES = 4096


def _flat(key: Key) -> str:
    return ".".join(key)


def incr_counter(key: Key, value: float = 1.0) -> None:
    k = _flat(key)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + value


def add_sample(key: Key, value: float) -> None:
    k = _flat(key)
    with _lock:
        ring = _samples.setdefault(k, [])
        ring.append(value)
        del ring[:-_MAX_SAMPLES]

