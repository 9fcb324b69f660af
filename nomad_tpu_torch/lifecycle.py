"""End-to-end latency attribution: per-allocation lifecycle timelines.

Port of nomad_tpu/lifecycle.py (host code): the port's spans and events
carry nomad_tpu's names, so the stitch is the same, save one stage:
``broker_delay``, from the ``broker.delay`` span that only the port's
delayed evals carry (nomad_tpu counts that wait ``unattributed``).

The north-star artifacts measure plan/eval latency from event timestamps
and stop there — nobody could say where the rest of a user-visible
placement goes. This module answers that question WITHOUT adding a single
hot-path instrument: it stitches what the observability stack already
records — per-eval trace spans (``nomad_tpu_torch/trace.py``; the span context
rides Plan/Eval envelopes) and the raft-index-stamped typed event stream
(``nomad_tpu_torch/events.py``) — into one **timeline** per evaluation/allocation
batch, then decomposes submit→placed / submit→running latency into
per-stage queue-wait vs service-time contributions (the waterfall Borg's
cell-scale evaluation and Sparrow's headline metric call for, PAPERS.md).

The stitcher is strictly read-only on decisions: it consumes retained
spans and events after the fact, so enabling it cannot perturb placement
(the SIMLOAD event digest is the enforcement: a run with the layer off
gives the same digest).

Stage taxonomy (a PARTITION of submit→placed, so stage sums reconcile
with measured end-to-end latency by construction — ``unattributed``
holds the thread-handoff/dispatch gaps the spans don't cover):

==================  =====  ====================================================
``broker_delay``    queue  a delayed eval's ``wait`` before it is ready (a
                           rolling update's stagger; ``broker.delay``)
``broker_wait``     queue  eval ready/blocked-queue wait (restarts on
                           redelivery — each extra pass is a visible retry
                           segment, not lost time)
``raft_catchup``    svc    worker FSM catch-up before snapshotting
``schedule_solve``  svc    the scheduler pass minus nested plan submits
                           (snapshot + staging + device solve + readback)
``submit_overhead`` svc    plan submit RPC minus queue/verify/commit
``plan_queue_wait`` queue  plan-queue parked time
``plan_verify``     svc    fused/scalar plan verification
``raft_commit``     svc    raft apply → durable commit
``unattributed``    —      submit→placed minus everything above
``client_ack``      svc    PlanApplied → client running ack (the
                           submit→running extension; event-stamped)
==================  =====  ====================================================

A bounce through the optimistic pipeline (conflict → RefreshIndex →
re-plan) shows up as ``attempts > 1`` plus per-attempt segments; the
conflict count rides ``bounces``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional

from nomad_tpu_torch import structs, trace

# Stage partition of submit->placed, in pipeline order. client_ack extends
# the partition to submit->running.
STAGES = (
    "broker_delay",
    "broker_wait",
    "raft_catchup",
    "schedule_solve",
    "submit_overhead",
    "plan_queue_wait",
    "plan_verify",
    "raft_commit",
    "unattributed",
)

# Express-lane stages (server/express.py): a separate taxonomy — the
# express path skips broker/worker/plan-queue entirely, so its timeline
# is the in-line pick + lease (submit→placed) with the async raft commit
# OUTSIDE submit→placed (it happens after the caller was answered).
# Surfaced in the waterfall only when express timelines are present.
EXPRESS_STAGES = (
    "express_pick",
    "express_lease",
)

# Async-commit stage: informative (how long until the placement became
# durable), deliberately NOT part of the submit→placed partition.
EXPRESS_ASYNC_STAGES = ("express_commit",)

STAGE_KINDS = {
    "broker_delay": "queue",
    "broker_wait": "queue",
    "raft_catchup": "service",
    "schedule_solve": "service",
    "submit_overhead": "service",
    "plan_queue_wait": "queue",
    "plan_verify": "service",
    "raft_commit": "service",
    "unattributed": "gap",
    "client_ack": "service",
    "express_pick": "service",
    "express_lease": "service",
    "express_commit": "async",
}

# Span name -> stage for the directly-mapped spans. schedule_solve and
# submit_overhead are derived (parent minus nested children).
_SPAN_STAGE = {
    "broker.delay": "broker_delay",
    "broker.wait": "broker_wait",
    "worker.wait_for_index": "raft_catchup",
    "plan.queue_wait": "plan_queue_wait",
    "plan.evaluate": "plan_verify",
    "plan.apply": "raft_commit",
    "express.pick": "express_pick",
    "express.lease": "express_lease",
    "express.commit": "express_commit",
}


def _dur_ms(span: Dict[str, Any]) -> float:
    if span.get("end") is None:
        return 0.0
    return (span["end"] - span["start"]) * 1000.0


class Timeline:
    """One evaluation's lifecycle: submit → placed (→ running), with the
    per-stage decomposition and per-attempt segments. An eval is the
    timeline key because that is the granularity plans, columnar alloc
    blocks, and the trace all share; per-alloc lookups resolve through
    ``Allocation.eval_id``."""

    __slots__ = (
        "eval_id", "job_id", "eval_type", "triggered_by",
        "submitted_at", "placed_at", "running_at",
        "attempts", "bounces", "stage_ms", "solver_ms", "segments",
        "spans_seen",
    )

    def __init__(self, eval_id: str):
        self.eval_id = eval_id
        self.job_id = ""
        self.eval_type = ""
        self.triggered_by = ""
        self.submitted_at: Optional[float] = None
        self.placed_at: Optional[float] = None
        self.running_at: Optional[float] = None
        self.attempts = 0            # submit_plan cycles observed
        self.bounces = 0             # refresh/conflict cycles among them
        self.stage_ms: Dict[str, float] = {}
        self.solver_ms: Dict[str, float] = {}
        # (stage, attempt, start_ms_rel, duration_ms) detail rows,
        # ordered by start — the per-eval waterfall.
        self.segments: List[Dict[str, Any]] = []
        self.spans_seen = 0

    # -- derived -------------------------------------------------------------

    @property
    def submit_to_placed_ms(self) -> Optional[float]:
        if self.submitted_at is None or self.placed_at is None:
            return None
        return (self.placed_at - self.submitted_at) * 1000.0

    @property
    def submit_to_running_ms(self) -> Optional[float]:
        if self.submitted_at is None or self.running_at is None:
            return None
        return (self.running_at - self.submitted_at) * 1000.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "eval_id": self.eval_id,
            "job_id": self.job_id,
            "eval_type": self.eval_type,
            "triggered_by": self.triggered_by,
            "submitted_at": self.submitted_at,
            "placed_at": self.placed_at,
            "running_at": self.running_at,
            "submit_to_placed_ms": _round(self.submit_to_placed_ms),
            "submit_to_running_ms": _round(self.submit_to_running_ms),
            "attempts": self.attempts,
            "bounces": self.bounces,
            "stage_ms": {k: round(v, 3) for k, v in self.stage_ms.items()},
            "solver_ms": {k: round(v, 3) for k, v in self.solver_ms.items()},
            "segments": list(self.segments),
            "spans_seen": self.spans_seen,
        }


def _round(v: Optional[float], nd: int = 3) -> Optional[float]:
    return None if v is None else round(v, nd)


# ---------------------------------------------------------------------------
# Stitching
# ---------------------------------------------------------------------------


def scan_events(events: Iterable) -> Dict[str, Dict[str, Any]]:
    """One pass over the event stream -> per-eval lifecycle anchors:
    ``submitted`` (first EvalUpdated(pending)), ``placed`` (first
    PlanApplied), ``running`` (first AllocClientUpdated(running) whose
    payload names the eval), plus job metadata and the per-key raft-index
    sequence the ordering tests pin. Accepts Event objects or dicts."""
    out: Dict[str, Dict[str, Any]] = {}

    def _rec(key: str) -> Dict[str, Any]:
        rec = out.get(key)
        if rec is None:
            rec = out[key] = {
                "submitted": None, "placed": None, "running": None,
                "job_id": "", "triggered_by": "",
            }
        return rec

    for e in events:
        if isinstance(e, dict):
            topic, etype, key = e["topic"], e["type"], e["key"]
            payload, etime = e.get("payload") or {}, e["time"]
        else:
            topic, etype, key = e.topic, e.type, e.key
            payload, etime = e.payload, e.time
        if topic == "Eval" and etype == "EvalUpdated":
            rec = _rec(key)
            if (payload.get("status") == structs.EVAL_STATUS_PENDING
                    and rec["submitted"] is None):
                rec["submitted"] = etime
                rec["job_id"] = payload.get("job_id", "")
                rec["triggered_by"] = payload.get("triggered_by", "")
        elif topic == "Plan" and etype == "PlanApplied":
            rec = _rec(key)
            if rec["placed"] is None:
                rec["placed"] = etime
        elif topic == "Express" and etype == "ExpressPlaced":
            # Express evals never publish a pending EvalUpdated (they
            # commit COMPLETE, asynchronously); the placement event
            # carries the in-line latency, so the anchors derive from it:
            # placed = event time, submitted = placed - placed_ms.
            rec = _rec(key)
            if rec["submitted"] is None:
                ms = float(payload.get("placed_ms", 0.0))
                rec["placed"] = etime
                rec["submitted"] = etime - ms / 1000.0
                rec["job_id"] = payload.get("job_id", "")
                rec["triggered_by"] = "express"
        elif topic == "Alloc" and etype == "AllocClientUpdated":
            ev_id = payload.get("eval_id", "")
            if (ev_id
                    and payload.get("client_status")
                    == structs.ALLOC_CLIENT_STATUS_RUNNING):
                rec = _rec(ev_id)
                if rec["running"] is None:
                    rec["running"] = etime
    return out


def stitch_eval(eval_id: str, spans: Optional[List[Dict[str, Any]]],
                anchors: Optional[Dict[str, Any]] = None) -> Timeline:
    """Build one Timeline from a trace's span dicts (tracer.get_trace
    shape) plus the event-derived anchors. Works degraded: with no spans
    the end-to-end numbers still come from the anchors (tracing disabled
    is not an error — the waterfall is just all ``unattributed``)."""
    tl = Timeline(eval_id)
    anchors = anchors or {}
    tl.submitted_at = anchors.get("submitted")
    tl.placed_at = anchors.get("placed")
    tl.running_at = anchors.get("running")
    tl.job_id = anchors.get("job_id", "")
    tl.triggered_by = anchors.get("triggered_by", "")

    spans = [s for s in (spans or []) if s.get("end") is not None]
    spans.sort(key=lambda s: (s["start"], s["name"]))
    tl.spans_seen = len(spans)
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)

    root = by_name.get("eval", [None])[0]
    if root is not None:
        ann = root.get("annotations") or {}
        tl.job_id = tl.job_id or ann.get("job_id", "")
        tl.eval_type = ann.get("type", "")
        tl.triggered_by = tl.triggered_by or ann.get("triggered_by", "")
        if tl.submitted_at is None:
            tl.submitted_at = root["start"]

    submits = by_name.get("worker.submit_plan", [])
    tl.attempts = max(1, len(submits)) if spans else 0
    for s in by_name.get("plan.evaluate", ()):
        ann = s.get("annotations") or {}
        if ann.get("refresh_index"):
            tl.bounces += 1

    stage_ms: Dict[str, float] = {}

    def _add(stage: str, span: Dict[str, Any], attempt: int) -> None:
        d = _dur_ms(span)
        stage_ms[stage] = stage_ms.get(stage, 0.0) + d
        if tl.submitted_at is not None:
            tl.segments.append({
                "stage": stage,
                "kind": STAGE_KINDS[stage],
                "attempt": attempt,
                "start_ms": round((span["start"] - tl.submitted_at) * 1000.0, 3),
                "duration_ms": round(d, 3),
            })

    # Attempt index: the i-th occurrence of a span name is attempt i+1
    # (redeliveries restart broker.wait; bounces restart the plan spans).
    for name, stage in _SPAN_STAGE.items():
        for i, s in enumerate(by_name.get(name, ())):
            _add(stage, s, i + 1)

    # Derived stages: parent minus nested children, clamped at zero (an
    # open child or clock jitter must not go negative).
    invoke_ms = sum(_dur_ms(s) for s in by_name.get(
        "worker.invoke_scheduler", ()))
    submit_ms = sum(_dur_ms(s) for s in submits)
    plan_child_ms = sum(
        stage_ms.get(k, 0.0)
        for k in ("plan_queue_wait", "plan_verify", "raft_commit")
    )
    if invoke_ms:
        solve = max(0.0, invoke_ms - submit_ms)
        stage_ms["schedule_solve"] = solve
        for i, s in enumerate(by_name.get("worker.invoke_scheduler", ())):
            if tl.submitted_at is not None:
                tl.segments.append({
                    "stage": "schedule_solve", "kind": "service",
                    "attempt": i + 1,
                    "start_ms": round(
                        (s["start"] - tl.submitted_at) * 1000.0, 3),
                    "duration_ms": round(_dur_ms(s), 3),
                })
    if submit_ms:
        stage_ms["submit_overhead"] = max(0.0, submit_ms - plan_child_ms)

    # Solver detail (nested inside schedule_solve, not a partition stage).
    for name, group in by_name.items():
        if name.startswith("solver."):
            tl.solver_ms[name[len("solver."):]] = sum(
                _dur_ms(s) for s in group
            )

    # e2e comes from the event anchors only: a no-op eval (no PlanApplied)
    # keeps it absent rather than inventing one from the root span.
    e2e = tl.submit_to_placed_ms
    if e2e is not None:
        if tl.triggered_by == "express":
            # Express submit→placed is the in-line path: only the
            # express stages partition it. The async-commit machinery's
            # spans (express_commit and the plan stages nested under it)
            # run AFTER the caller was answered and must not charge it.
            attributed = sum(stage_ms.get(s, 0.0) for s in EXPRESS_STAGES)
        else:
            attributed = sum(
                v for k, v in stage_ms.items()
                if STAGE_KINDS.get(k) != "async"
            )
        stage_ms["unattributed"] = max(0.0, e2e - attributed)
    if (tl.placed_at is not None and tl.running_at is not None
            and tl.running_at >= tl.placed_at):
        stage_ms["client_ack"] = (tl.running_at - tl.placed_at) * 1000.0

    tl.stage_ms = stage_ms
    tl.segments.sort(key=lambda seg: seg["start_ms"])
    return tl


def stitch(events: Iterable, tracer=None) -> Dict[str, Timeline]:
    """Stitch a timeline for every eval the event stream saw submitted.
    ``tracer`` defaults to the process tracer; pass None-able — evals
    whose traces were evicted (or recorded with tracing off) still get
    event-anchored timelines."""
    if tracer is None:
        tracer = trace.get_tracer()
    anchors = scan_events(events)
    out: Dict[str, Timeline] = {}
    for eval_id, rec in anchors.items():
        if rec["submitted"] is None:
            continue
        spans = tracer.get_trace(eval_id) if tracer is not None else None
        out[eval_id] = stitch_eval(eval_id, spans, rec)
    return out


def stitch_from_server(server, eval_id: str) -> Optional[Timeline]:
    """Live-server lookup for the HTTP tier: anchors from the server's
    retained event ring, spans from the process tracer. None when neither
    the ring nor the tracer knows the eval."""
    broker = getattr(getattr(server, "fsm", None), "events", None)
    anchors = scan_events(broker.all_events()) if broker is not None else {}
    rec = anchors.get(eval_id)
    spans = trace.get_tracer().get_trace(eval_id)
    if rec is None and spans is None:
        return None
    return stitch_eval(eval_id, spans, rec)


# ---------------------------------------------------------------------------
# Critical-path attribution: the latency waterfall
# ---------------------------------------------------------------------------


def _percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    n = len(sorted_vals)
    return sorted_vals[max(0, min(n - 1, math.ceil(p * n) - 1))]


def _quantile_block(vals: List[float]) -> Dict[str, Any]:
    s = sorted(vals)
    return {
        "n": len(s),
        "p50_ms": round(_percentile(s, 0.50), 2),
        "p95_ms": round(_percentile(s, 0.95), 2),
        "p99_ms": round(_percentile(s, 0.99), 2),
        "max_ms": round(s[-1], 2) if s else 0.0,
    }


def attribution(timelines: Iterable[Timeline]) -> Dict[str, Any]:
    """The scenario-window reduction: submit→placed / submit→running
    percentiles plus a per-stage waterfall — each stage's total and mean
    contribution, its share of aggregate end-to-end time, and its share
    inside the p95 tail (the critical-path view: which stage buys the
    tail). ``reconciliation`` proves the partition property: attributed
    stage sums (incl. the explicit unattributed gap) equal measured
    end-to-end within rounding."""
    tls = [t for t in timelines if t.submit_to_placed_ms is not None]
    placed = [t.submit_to_placed_ms for t in tls]
    running = [t.submit_to_running_ms for t in tls
               if t.submit_to_running_ms is not None]

    out: Dict[str, Any] = {
        "timelines": len(tls),
        "submit_to_placed_ms": _quantile_block(placed),
        "submit_to_running_ms": _quantile_block(running),
        "attempts": {
            "max": max((t.attempts for t in tls), default=0),
            "bounced_timelines": sum(1 for t in tls if t.bounces),
            "bounces": sum(t.bounces for t in tls),
        },
    }
    if not tls:
        out["waterfall"] = []
        out["reconciliation"] = {"end_to_end_ms": 0.0, "stage_sum_ms": 0.0,
                                 "attributed_fraction": 0.0}
        return out

    total_e2e = sum(placed)
    p95 = _percentile(sorted(placed), 0.95)
    tail = [t for t in tls if t.submit_to_placed_ms >= p95] or tls
    tail_e2e = sum(t.submit_to_placed_ms for t in tail)

    waterfall = []
    stage_sum_all = 0.0
    stages = list(STAGES)
    if any(t.stage_ms.get(s) for t in tls for s in EXPRESS_STAGES):
        # Express timelines present: their stages join the waterfall
        # (before the unattributed gap, which stays last).
        stages = stages[:-1] + list(EXPRESS_STAGES) + stages[-1:]
    for stage in stages:
        per_tl = [t.stage_ms.get(stage, 0.0) for t in tls]
        total = sum(per_tl)
        stage_sum_all += total
        tail_total = sum(t.stage_ms.get(stage, 0.0) for t in tail)
        waterfall.append({
            "stage": stage,
            "kind": STAGE_KINDS[stage],
            "total_ms": round(total, 2),
            "mean_ms": round(total / len(tls), 3),
            "p95_ms": round(_percentile(sorted(per_tl), 0.95), 2),
            "share": round(total / total_e2e, 4) if total_e2e else 0.0,
            "share_of_p95_tail": (
                round(tail_total / tail_e2e, 4) if tail_e2e else 0.0
            ),
        })
    out["waterfall"] = waterfall
    out["reconciliation"] = {
        "end_to_end_ms": round(total_e2e, 2),
        "stage_sum_ms": round(stage_sum_all, 2),
        # Partition property: 1.0 up to clamping/rounding. The <10%
        # acceptance bound guards the stitcher's clock consistency, not a
        # tunable.
        "attributed_fraction": (
            round(stage_sum_all / total_e2e, 4) if total_e2e else 0.0
        ),
    }
    return out


def worst_k(timelines: Iterable[Timeline], k: int = 8) -> List[Dict[str, Any]]:
    """The K slowest submit→placed timelines, slowest first — what the
    debug bundle and tier-1 failure forensics attach."""
    ranked = sorted(
        (t for t in timelines if t.submit_to_placed_ms is not None),
        key=lambda t: t.submit_to_placed_ms, reverse=True,
    )
    return [t.to_dict() for t in ranked[:k]]
