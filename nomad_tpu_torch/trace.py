"""Eval-lifecycle tracing: spans over the broker → scheduler → solver →
plan-apply pipeline, and the solver's stage cuts.

Port of nomad_tpu/trace.py. Lightweight spans with parent links and
key/value annotations, recorded into a bounded, lock-protected ring of
traces keyed by evaluation id (the trace id IS the eval id).

Span taxonomy (producers in parentheses):

- ``eval``                      root; broker enqueue → ack/failed (eval_broker)
- ``broker.delay``              a delayed eval's ``wait`` (a rolling update's
                                stagger), enqueue → its timer fires, or
                                ``cancelled`` at a flush (eval_broker)
- ``broker.wait``               ready-queue wait, enqueue/nack → dequeue (eval_broker)
- ``worker.wait_for_index``     FSM catch-up before snapshot (worker)
- ``worker.invoke_scheduler``   the scheduler pass (worker)
- ``sched.reconcile``           job read → first solve or the plan's end: the
                                block/fast reconcile or the object diff and the
                                evictions, annotated ``path`` and the stop,
                                update and place counts (scheduler/generic,
                                tpu/solver)
- ``solver.staging``            host tensorization: masks + usage (tpu/solver)
- ``solver.transfer``           per-eval device uploads + dispatch (tpu/solver)
- ``solver.execute``            device execution wait (ops/binpack, ops/coalesce)
- ``solver.readback``           D2H readback + host expansion (ops/binpack)
- ``worker.submit_plan``        plan submit → response (worker)
- ``plan.queue_wait``           plan-queue wait, enqueue → applier dequeue
- ``plan.evaluate``             plan verification against the snapshot
- ``plan.apply``                raft apply → commit (plan_pipeline)
- ``raft.persist``              the entry's encode, ``json.dumps`` and journal
                                append: the ``submit`` → ``persisted`` anchors
                                of /v1/agent/raft's ``append_persist`` (raft/node)
- ``fsm.apply``                 one FSM log-entry apply, annotated msg_type
- ``runtime.gc``                an interpreter collection of at least 1 ms on a
                                thread serving the trace, under the root, made
                                after the pause (telemetry.GCBooks)

A stage timer is live only while the calling thread carries a span
(``use_span``); the span receives the solver's cuts through
``record_stages(stages, prefix)``. ``Tracer.get_trace`` reads one eval's
spans back; ``/v1/evaluation/<id>/trace`` and ``/v1/agent/traces`` expose
them, and ``chrome_trace`` exports one trace for Perfetto.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

# Monotonic wall clock: epoch-anchored perf_counter, so spans from every
# thread order consistently (time.time() can step backwards under NTP,
# which would break the nesting invariants the trace consumers rely on).
# nomadlint: allow(DET002) -- one-shot wall anchor for the monotonic
# span clock; sampled exactly once at import, never in span math.
_EPOCH = time.time() - time.perf_counter()


def now() -> float:
    return _EPOCH + time.perf_counter()


# Span ids need process-uniqueness, not entropy: os.urandom is a syscall
# (~30us under load — more than the rest of a span's lifecycle combined),
# so ids derive from one urandom seed and a counter pushed through a
# 64-bit odd-multiplier bijection (unique per process, random-looking).
_SPAN_SEED = int.from_bytes(os.urandom(8), "little")
_span_counter = itertools.count(1)


def _new_span_id() -> str:
    mixed = (next(_span_counter) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    return format(_SPAN_SEED ^ mixed, "016x")


class Span:
    """One timed operation within a trace. Not thread-safe per instance:
    a span is started, annotated, and finished by one component."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "start", "end",
        "annotations", "thread", "_tracer",
    )

    def __init__(self, tracer: "Tracer", trace_id: str, name: str,
                 parent_id: str = "", start: Optional[float] = None,
                 annotations: Optional[Dict[str, Any]] = None):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.name = name
        self.start = now() if start is None else start
        self.end: Optional[float] = None
        self.annotations: Dict[str, Any] = dict(annotations or {})
        self.thread = threading.current_thread().name

    def annotate(self, key: str, value: Any) -> "Span":
        self.annotations[key] = value
        return self

    def finish(self, end: Optional[float] = None) -> None:
        if self.end is not None:
            return  # idempotent: racing finishers keep the first stamp
        self.end = now() if end is None else end
        self._tracer._record_finished(self)

    def ctx(self) -> Dict[str, str]:
        """The wire-portable span context (rides RPC request envelopes)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def record_stages(self, stages, prefix: str = "") -> None:
        """Record measured ``(name, start, end)`` cuts as finished child
        spans (StageTimer.emit_spans)."""
        self._tracer.record_batch(self, stages, prefix)

    def record_on_root(self, name: str, start: float, end: float,
                       annotations: Dict[str, Any]) -> bool:
        """Record a measured interval of this span's thread as a finished
        child of its trace's root (a collection pause that stopped the
        thread while it served this span: telemetry.GCBooks)."""
        return self._tracer.record_on_root(
            self.trace_id, name, start, end, annotations, self.thread)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "duration_ms": (
                round((self.end - self.start) * 1000.0, 4)
                if self.end is not None else None
            ),
            "thread": self.thread,
            # Copy: serialization happens outside any lock, and an open
            # span's producer may annotate concurrently — handing out the
            # live dict would race json.dumps with a dict resize.
            "annotations": dict(self.annotations),
        }


class _NullSpan:
    """Inert span: returned when tracing is disabled so call sites never
    branch. Shared singleton; every method is a no-op."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = ""
    name = ""
    start = 0.0
    end: Optional[float] = None
    annotations: Dict[str, Any] = {}

    def annotate(self, key: str, value: Any) -> "_NullSpan":
        return self

    def finish(self, end: Optional[float] = None) -> None:
        pass

    def ctx(self) -> Dict[str, str]:
        return {}

    def record_stages(self, stages, prefix: str = "") -> None:
        pass

    def to_dict(self) -> Dict[str, Any]:
        return {}


NULL_SPAN = _NullSpan()


class _Trace:
    __slots__ = ("trace_id", "spans", "open", "root_ctx", "dropped",
                 "updated", "done")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: List[Span] = []          # finished spans
        self.open: Dict[str, Span] = {}      # span_id -> unfinished span
        self.root_ctx: Dict[str, str] = {}   # the root span's wire context
        self.dropped = 0
        self.updated = now()
        self.done = False


class Tracer:
    """Bounded ring of traces. Oldest-inserted trace evicted past
    ``max_traces``; per-trace span count capped at ``max_spans`` (excess
    finishes are counted, not stored). All methods are thread-safe."""

    def __init__(self, max_traces: int = 256, max_spans: int = 512,
                 enabled: bool = True):
        self.max_traces = max(1, max_traces)
        self.max_spans = max(1, max_spans)
        self.enabled = enabled
        self._lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, _Trace]" = (
            collections.OrderedDict()
        )
        # Process-wide loss accounting (mutated under the lock): per-trace
        # ``dropped`` says one eval's trace is partial, but without an
        # aggregate, silent trace loss under 10k-node load is invisible
        # until someone opens the one trace that happens to be truncated.
        self.spans_dropped = 0
        self.traces_evicted = 0

    # -- producing ---------------------------------------------------------

    def start_span(self, trace_id: str, name: str, parent: Any = None,
                   start: Optional[float] = None,
                   annotations: Optional[Dict[str, Any]] = None,
                   root: bool = False):
        """Open a span. ``parent`` is a Span, a wire context dict, or a
        span_id string. ``root=True`` additionally registers the span's
        context as the trace root (what ``root_ctx`` returns)."""
        if not self.enabled or not trace_id:
            return NULL_SPAN
        parent_id = ""
        if isinstance(parent, Span):
            parent_id = parent.span_id
        elif isinstance(parent, dict):
            parent_id = parent.get("span_id", "")
        elif isinstance(parent, str):
            parent_id = parent
        span = Span(self, trace_id, name, parent_id, start, annotations)
        with self._lock:
            tr = self._trace_locked(trace_id)
            tr.open[span.span_id] = span
            tr.updated = now()
            if root:
                tr.root_ctx = span.ctx()
        return span

    def _record_finished(self, span: Span) -> None:
        with self._lock:
            tr = self._traces.get(span.trace_id)
            if tr is None:
                # Trace evicted while the span was open: re-admit it so a
                # slow eval's tail spans aren't silently lost.
                tr = self._trace_locked(span.trace_id)
            tr.open.pop(span.span_id, None)
            if len(tr.spans) >= self.max_spans:
                tr.dropped += 1
                self.spans_dropped += 1
            else:
                tr.spans.append(span)
            tr.updated = now()

    def record_batch(self, parent, stages, prefix: str = "") -> None:
        """Bulk-record already-measured ``(name, start, end)`` triples as
        finished children of ``parent`` under ONE lock hold — the solver
        emits its four stage cuts per eval, and per-span locking was a
        measurable slice of the tracing overhead budget."""
        if (not self.enabled or not stages or parent is None
                or isinstance(parent, _NullSpan)):
            return
        spans = []
        for name, t0, t1 in stages:
            s = Span(self, parent.trace_id, prefix + name,
                     parent.span_id, t0)
            s.end = t1
            spans.append(s)
        with self._lock:
            tr = self._trace_locked(parent.trace_id)
            for s in spans:
                if len(tr.spans) >= self.max_spans:
                    tr.dropped += 1
                    self.spans_dropped += 1
                else:
                    tr.spans.append(s)
            tr.updated = now()

    def record_on_root(self, trace_id: str, name: str, start: float,
                       end: float, annotations: Dict[str, Any],
                       thread: str) -> bool:
        """Record an already-measured span as a child of the trace's root.
        False, and nothing recorded, when tracing is disabled or the trace
        is gone (an evicted trace is not re-admitted for it) or rootless."""
        if not self.enabled:
            return False
        span = Span(self, trace_id, name, "", start, annotations)
        span.end = end
        span.thread = thread
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None or not tr.root_ctx:
                return False
            span.parent_id = tr.root_ctx.get("span_id", "")
            if len(tr.spans) >= self.max_spans:
                tr.dropped += 1
                self.spans_dropped += 1
            else:
                tr.spans.append(span)
            tr.updated = now()
        return True

    def adopt_root(self, trace_id: str, ctx: Dict[str, str]) -> None:
        """Register a REMOTE root context (received over RPC) so local
        spans of this trace can parent on it via root_ctx()."""
        if not self.enabled or not trace_id or not ctx:
            return
        with self._lock:
            tr = self._trace_locked(trace_id)
            if not tr.root_ctx:
                tr.root_ctx = dict(ctx)

    def root_ctx(self, trace_id: str) -> Dict[str, str]:
        with self._lock:
            tr = self._traces.get(trace_id)
            return dict(tr.root_ctx) if tr is not None else {}

    def mark_done(self, trace_id: str) -> None:
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is not None:
                tr.done = True
                tr.updated = now()

    def _trace_locked(self, trace_id: str) -> _Trace:
        tr = self._traces.get(trace_id)
        if tr is None:
            tr = _Trace(trace_id)
            self._traces[trace_id] = tr
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)
                self.traces_evicted += 1
        return tr

    # -- querying ----------------------------------------------------------

    def get_trace(self, trace_id: str) -> Optional[List[Dict[str, Any]]]:
        """All spans of one trace (finished + still-open), sorted by start
        time. None when the trace is unknown (or was evicted)."""
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                return None
            spans = list(tr.spans) + list(tr.open.values())
        out = [s.to_dict() for s in spans]
        out.sort(key=lambda d: (d["start"], d["name"]))
        return out

    def stats(self) -> Dict[str, Any]:
        """Aggregate tracer health: retained count plus the process-wide
        loss counters."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "retained": len(self._traces),
                "max_traces": self.max_traces,
                "max_spans": self.max_spans,
                "spans_dropped": self.spans_dropped,
                "traces_evicted": self.traces_evicted,
            }

    def traces(self) -> List[Dict[str, Any]]:
        """Summaries of retained traces, most recently updated first
        (/v1/agent/traces)."""
        with self._lock:
            items = list(self._traces.values())
        out = []
        for tr in items:
            spans = list(tr.spans)
            root = next((s for s in spans if not s.parent_id), None)
            out.append({
                "trace_id": tr.trace_id,
                "spans": len(spans),
                "open_spans": len(tr.open),
                "dropped_spans": tr.dropped,
                "done": tr.done,
                "updated": tr.updated,
                "root": root.name if root is not None else "",
                "duration_ms": (
                    round((root.end - root.start) * 1000.0, 4)
                    if root is not None and root.end is not None else None
                ),
            })
        out.sort(key=lambda d: d["updated"], reverse=True)
        return out

    def chrome_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Chrome trace-event JSON for one trace (loads into Perfetto /
        chrome://tracing): complete ('X') events in microseconds, and
        thread-name metadata events mapping thread names to tids."""
        spans = self.get_trace(trace_id)
        if spans is None:
            return None
        tids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for s in spans:
            tid = tids.setdefault(s["thread"], len(tids) + 1)
            end = s["end"] if s["end"] is not None else now()
            events.append({
                "name": s["name"],
                "cat": "eval",
                "ph": "X",
                "ts": round(s["start"] * 1e6, 1),
                "dur": round((end - s["start"]) * 1e6, 1),
                "pid": 1,
                "tid": tid,
                "args": {
                    **s["annotations"],
                    "span_id": s["span_id"],
                    "parent_id": s["parent_id"],
                },
            })
        for name, tid in tids.items():
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "args": {"name": name},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Process tracer + thread-local context
# ---------------------------------------------------------------------------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def configure(max_traces: int = 256, max_spans: int = 512,
              enabled: bool = True) -> Tracer:
    """Agent telemetry wiring: rebuild the process tracer from the
    ``telemetry { }`` config block's knobs."""
    global _TRACER
    _TRACER = Tracer(max_traces, max_spans, enabled)
    return _TRACER


_tls = threading.local()


def current_span():
    """The active span on this thread (set by use_span), or None."""
    return getattr(_tls, "span", None)


@contextmanager
def use_span(span):
    """Install ``span`` as this thread's active span: downstream
    components (solver stages, FSM applies) parent on it without any
    signature plumbing. NULL_SPAN installs as None."""
    prev = getattr(_tls, "span", None)
    _tls.span = span if not isinstance(span, _NullSpan) else None
    try:
        yield span
    finally:
        _tls.span = prev


# ---------------------------------------------------------------------------
# Stage timing
# ---------------------------------------------------------------------------


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
