"""Stage timing for the solver path: the slice of nomad_tpu.trace that the
ported scheduler calls.

The solve cuts its wall into staging / transfer / execute / readback (the
cuts nomad_tpu's bench breakdown publishes). A stage timer is live only
while the calling thread carries a span (``use_span``); the span receives
the cuts through ``record_stages(stages, prefix)``. The tracer, its ring
of finished traces and the chrome export belong to the server-loop slice
and are not here yet.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List

_tls = threading.local()


def now() -> float:
    return time.perf_counter()


def current_span():
    """The active span on this thread (set by use_span), or None."""
    return getattr(_tls, "span", None)


@contextmanager
def use_span(span):
    """Install ``span`` as this thread's active span. A span is any object
    with ``annotate(key, value)`` and ``record_stages(stages, prefix)``."""
    prev = getattr(_tls, "span", None)
    _tls.span = span
    try:
        yield span
    finally:
        _tls.span = prev


class _StageCtx:
    __slots__ = ("timer", "name", "t0")

    def __init__(self, timer: "StageTimer", name: str):
        self.timer = timer
        self.name = name

    def __enter__(self):
        self.t0 = now()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.timer.stages.append((self.name, self.t0, now()))
        return False


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_CTX = _NullCtx()


class StageTimer:
    """Named, ordered stage cuts, recorded on any thread and emitted to the
    eval's span afterwards."""

    __slots__ = ("stages",)

    def __init__(self):
        self.stages: List[tuple] = []  # (name, start, end)

    def stage(self, name: str) -> _StageCtx:
        return _StageCtx(self, name)

    def durations_ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, t0, t1 in self.stages:
            out[name] = out.get(name, 0.0) + (t1 - t0) * 1000.0
        return out

    def emit_spans(self, parent, prefix: str = "solver.") -> None:
        if parent is None:
            return
        parent.record_stages(self.stages, prefix)


class _NullStageTimer(StageTimer):
    """Inert timer handed out when no span is installed."""

    __slots__ = ()

    def stage(self, name: str):
        return _NULL_CTX

    def emit_spans(self, parent, prefix: str = "solver.") -> None:
        pass


NULL_STAGES = _NullStageTimer()


def active_stages() -> StageTimer:
    return getattr(_tls, "stages", None) or NULL_STAGES


@contextmanager
def use_stages(st: StageTimer):
    prev = getattr(_tls, "stages", None)
    _tls.stages = None if isinstance(st, _NullStageTimer) else st
    try:
        yield st
    finally:
        _tls.stages = prev


def stage(name: str):
    """Record ``name`` on this thread's active stage timer (no-op when none
    is installed)."""
    return active_stages().stage(name)
