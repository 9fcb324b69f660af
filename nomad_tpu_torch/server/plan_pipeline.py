"""Optimistic parallel plan pipeline: the Omega-posture plan applier.

Replaces the one-at-a-time serial applier (the old ``PlanApplier`` in
plan_apply.py): N scheduler workers evaluate concurrently against
delta-rolled snapshots, and this pipeline drains up to K pending plans per
cycle, verifies all K in **one fused batched tensor pass** over the
columnar ``_NodeTable`` (a K x nodes feasibility check generalizing
``evaluate_plan``), commits the non-conflicting subsets in commit order,
and bounces conflicting plans back to their workers through the existing
RefreshIndex path.

Conflict semantics are transaction-time per Omega (Schwarzkopf et al.,
EuroSys 2013, PAPERS.md): every plan is evaluated optimistically against
the snapshot its worker held; at apply time the pipeline re-verifies
against current state, and a plan whose verification failed CONFLICTS iff
a commit in the same batch — or any commit since the plan's snapshot
index — touched overlapping node capacity. Conflicting plans keep the
sequential-equivalent partial-commit/refresh response (the worker
re-snapshots and re-plans the remainder), so placement decisions are
bit-identical to the serial applier; the pipeline only *attributes* and
*counts* the conflicts (``plan.conflicts``) and amortizes verification +
commit over the batch (``plan.batch_size``).

Decision identity is the load-bearing contract: ``evaluate_plans`` is
fuzz-pinned decision-identical to K sequential ``evaluate_plan`` calls
with the committed subset of each plan rolled into the snapshot between
calls (tests/test_fuzz_differential.py). The fused pass is therefore a
pure verification-cost optimization — it can never change what commits.

Port of nomad_tpu/server/plan_pipeline.py. The express lane's hooks
(``ledger``, ``Plan.express_lease``) are live: ``Server`` sets ``ledger``
when the lane is on, and the verifier then charges active leases.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch import telemetry, trace
from nomad_tpu_torch.server.eval_broker import BrokerError, EvalBroker
from nomad_tpu_torch.server.plan_apply import (
    _AskAccum,
    _block_has_net,
    _existing_block_usage_rows,
    _node_table,
    _object_allocs,
    evaluate_plan,
)
from nomad_tpu_torch.server.plan_queue import PendingPlan, PlanQueue
from nomad_tpu_torch.structs import Plan, PlanResult

# How many pending plans one pipeline cycle drains at most. Sized at the
# worker-concurrency ceiling: more than ~2x the worker count can never be
# pending at once (each worker blocks on one plan), and a small K keeps
# the fused pass's K x nodes scratch arrays cache-resident.
DEFAULT_MAX_BATCH = 8

# Commit-log depth for transaction-time conflict attribution: (index,
# touched-node-set) of recent commits. Bounded because attribution only
# needs to cover plans currently in flight — a worker's snapshot is at
# most a few commits old; anything older than the horizon is attributed
# conservatively (treated as overlapping).
COMMIT_LOG_DEPTH = 64


class _PipelineTotals:
    """Process-wide lifetime counters shared by every pipeline instance —
    the GLOBAL_MIRROR_CACHE posture, so /v1/agent/metrics and the debug
    bundle can surface pipeline health without holding a server ref."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.batches = 0
        self.plans = 0
        self.committed = 0
        self.noops = 0
        self.rejected = 0
        self.conflicts = 0
        self.refreshes = 0
        self.fused_plans = 0
        self.scalar_plans = 0
        self.max_batch_seen = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "batches": self.batches,
                "plans": self.plans,
                "committed": self.committed,
                "noops": self.noops,
                "rejected": self.rejected,
                "conflicts": self.conflicts,
                "refreshes": self.refreshes,
                "fused_plans": self.fused_plans,
                "scalar_plans": self.scalar_plans,
                "max_batch_seen": self.max_batch_seen,
            }


PIPELINE_TOTALS = _PipelineTotals()


def _plan_touched_nodes(plan: Plan) -> set:
    """Node ids whose capacity this plan touches — the conflict-detection
    granularity (Omega's per-machine transaction footprint)."""
    nodes = set(plan.node_allocation)
    nodes.update(plan.node_update)
    for run in plan.block_stops:
        nodes.update(run.node_ids)
    for b in plan.alloc_batches:
        nodes.update(b.node_ids)
    for b in plan.update_batches:
        if b.src_node_ids:
            nodes.update(b.src_node_ids)
        elif getattr(b, "allocs", None):
            nodes.update(a.node_id for a in b.allocs)
    return nodes


def apply_result_to_snapshot(snap, result: PlanResult, index: int) -> None:
    """Roll one plan's committed subset into ``snap`` — the ONE optimistic
    mutation shared by the batched verifier (sequential-equivalence rolls)
    and the pipeline's cross-batch optimistic snapshot, so the two can
    never drift. Block stop runs commit as the FSM commits them
    (``stop_block_members``), ahead of the object rows."""
    allocs = _object_allocs(result)
    if result.block_stops:
        _stopped, copies = snap.stop_block_members(index, result.block_stops)
        allocs = copies + allocs
    if allocs:
        snap.upsert_allocs(index, allocs)
    if result.alloc_batches:
        snap.upsert_alloc_blocks(index, result.alloc_batches)
    if result.update_batches:
        snap.apply_update_batches(index, result.update_batches)


def _whole_commit_result(plan: Plan) -> PlanResult:
    """The whole-commit PlanResult shape evaluate_plan returns on its
    pure-columnar fast path — the fused pass must produce the identical
    object shape for decision identity."""
    result = PlanResult(
        node_update={},
        node_allocation={},
        failed_allocs=plan.failed_allocs,
    )
    result.alloc_batches = [b for b in plan.alloc_batches if b.n]
    result.update_batches = [b for b in plan.update_batches if b.n]
    return result


def _fused_eligible(plan: Plan) -> bool:
    """A plan rides the fused K x nodes pass iff its entire ask is pure
    columnar placement batches: no per-node object placements or evictions
    (those need the scalar/object merge paths), no update batches (delta
    semantics), and no network-carrying batches (sequential port
    semantics — and a committed net batch flips later plans' nodes to the
    scalar path, which the cumulative-ask trick can't express)."""
    if (plan.node_allocation or plan.node_update or plan.update_batches
            or plan.block_stops):
        return False
    return all(not _block_has_net(b) for b in plan.alloc_batches)


def _fused_prefix(snap, plans: List[Plan], table,
                  reservations=None) -> Tuple[int, List[PlanResult]]:
    """Verify a leading run of fused-eligible plans in ONE batched tensor
    pass over the node table: stack the K per-plan asks, prefix-cumsum
    along K (each plan sees every earlier plan's ask as committed usage —
    exactly the sequential roll), and fit-check all K x touched-rows at
    once. Returns (m, results): the longest prefix whose plans ALL fully
    fit, with their whole-commit results. m == 0 means the first plan
    needs the scalar path (ineligible, or doesn't fully fit — the exact
    partial answer comes from evaluate_plan)."""
    import numpy as np

    if table is None or table.n == 0:
        return 0, []
    if snap.nodes_with_object_allocs():
        # Object rows change per-node usage in ways only the per-node
        # walk accounts; the whole batch takes the sequential path.
        return 0, []

    run: List[Plan] = []
    for plan in plans:
        if not _fused_eligible(plan):
            break
        run.append(plan)
    if not run:
        return 0, []

    block_usage, net_rows, _blocks = _existing_block_usage_rows(snap, table)

    asks = []          # per plan: dense [N,4] int64 ask (or None)
    plan_rows = []     # per plan: row indices its ask touches
    eligible = len(run)
    for i, plan in enumerate(run):
        ask = _AskAccum()
        for b in plan.alloc_batches:
            ask.add_batch(
                b.node_ids, b.node_counts,
                np.asarray(b.resource_vector(), dtype=np.int64),
                src=b.src_hint,
            )
        arr, _flat_ids, rows = ask.accumulate_rows(table)
        if rows.size:
            valid = rows >= 0
            if not valid.all():
                # Unknown node id: sequential would partial-commit; this
                # plan and everything after it leave the fused run.
                eligible = i
                break
            sc = table.dead[rows] | table.scalar_only[rows]
            if net_rows is not None:
                sc = sc | net_rows[rows]
            if sc.any():
                eligible = i
                break
        asks.append(
            arr if arr is not None
            else np.zeros((table.n, 4), dtype=np.int64)
        )
        plan_rows.append(rows)
    if eligible == 0:
        return 0, []

    run = run[:eligible]
    # One fused pass: inclusive prefix over the K stacked asks restricted
    # to the union of touched rows, one broadcast compare against totals.
    union = np.unique(np.concatenate([r for r in plan_rows if r.size]
                                     or [np.empty(0, dtype=np.int64)]))
    if union.size == 0:
        # Nothing asks for capacity: every plan trivially whole-commits.
        return len(run), [_whole_commit_result(p) for p in run]
    stacked = np.stack([a[union] for a in asks])          # [K, U, 4]
    cum = np.cumsum(stacked, axis=0)                      # inclusive
    base = table.reserved[union].astype(np.int64)
    if block_usage is not None:
        base = base + block_usage[union]
    if reservations:
        # Active express capacity leases (server/express.py): charged as
        # base usage so no fused-verified plan can take leased capacity.
        # Fused-eligible plans are never express (express plans carry
        # node_allocation, which disqualifies them above), so no
        # own-lease exemption arises here.
        res_rows = np.zeros((table.n, 4), dtype=np.int64)
        rows_get = table.rows.get
        for nid, vec in reservations.items():
            row = rows_get(nid)
            if row is not None:
                res_rows[row] += vec
        base = base + res_rows[union]
    # Same int32 clamp as the scalar verifier's native.fit_check feed —
    # decision identity must survive saturating asks.
    used = np.minimum(base[None, :, :] + cum, 2**31 - 1)
    fits = np.all(used <= table.totals[union].astype(np.int64)[None, :, :],
                  axis=2)                                 # [K, U]
    pos = {int(r): i for i, r in enumerate(union.tolist())}
    m = 0
    for i, rows in enumerate(plan_rows):
        if rows.size:
            idxs = [pos[int(r)] for r in rows.tolist()]
            if not fits[i, idxs].all():
                break
        m = i + 1
    return m, [_whole_commit_result(p) for p in run[:m]]


def evaluate_plans(snap, plans: List[Plan],
                   stamp_index: Callable[[], int] = lambda: 0,
                   totals: Optional[_PipelineTotals] = None,
                   ledger=None,
                   ) -> List[PlanResult]:
    """Batched, sequential-equivalent plan verification: one PlanResult per
    plan, decision-identical to calling ``evaluate_plan(snap, plan)`` and
    rolling each committed subset into ``snap`` (apply_result_to_snapshot)
    before the next call. MUTATES ``snap`` the same way. The pure-columnar
    common case verifies whole runs of plans in one fused tensor pass;
    anything the fused pass can't prove falls to the exact scalar path for
    that plan and re-fuses the remainder.

    ``ledger`` (optional) is the express lane's ReservationLedger
    (server/express.py): active lease debits charge as existing usage in
    both the fused and scalar paths, with each express plan's OWN lease
    exempted from its verification — the reservation-aware verify.
    None (or an empty ledger) is decision-identical to before."""
    full_debits = None
    if ledger is not None:
        full_debits = ledger.debit_map() or None
    results: List[PlanResult] = []
    i = 0
    n = len(plans)
    while i < n:
        m = 0
        if n - i > 1:
            # A lone plan takes evaluate_plan directly — its own
            # pure-columnar fast path is the K=1 case of the fused pass.
            m, fused_results = _fused_prefix(
                snap, plans[i:], _node_table(snap),
                reservations=full_debits,
            )
        if m:
            for plan, result in zip(plans[i:i + m], fused_results):
                apply_result_to_snapshot(snap, result, stamp_index())
                results.append(result)
            if totals is not None:
                with totals._lock:
                    totals.fused_plans += m
            i += m
            continue
        plan = plans[i]
        reservations = full_debits
        if ledger is not None and plan.express_lease:
            # The express plan verifying its own async commit: exempt
            # its own lease (its ask IS that reservation) while still
            # charging every other outstanding lease.
            reservations = ledger.debit_map(
                exclude=(plan.express_lease,)) or None
        result = evaluate_plan(snap, plan, reservations=reservations)
        if not result.is_noop():
            apply_result_to_snapshot(snap, result, stamp_index())
        results.append(result)
        if totals is not None:
            with totals._lock:
                totals.scalar_plans += 1
        i += 1
    return results


class PlanPipeline(threading.Thread):
    """Long-lived batch applier thread (the plan_apply.go:39-117 role,
    batched). ``raft`` is anything with apply(msg_type, payload) ->
    Future[index] and an ``applied_index`` property. Verification of batch
    N+1 overlaps the (raft) apply of batch N via the rolled optimistic
    snapshot; within a batch the K raft entries dispatch back-to-back and
    one waiter thread resolves them in commit order."""

    def __init__(
        self,
        plan_queue: PlanQueue,
        eval_broker: EvalBroker,
        raft,
        fsm,
        logger: Optional[logging.Logger] = None,
        max_batch: int = DEFAULT_MAX_BATCH,
    ):
        super().__init__(daemon=True, name="plan-pipeline")
        self.plan_queue = plan_queue
        self.eval_broker = eval_broker
        self.raft = raft
        # Hold the FSM, not its StateStore: a raft snapshot restore rebinds
        # fsm.state to a fresh store and plans must verify against the
        # live one.
        self.fsm = fsm
        self.logger = logger or logging.getLogger("nomad_tpu_torch.plan_pipeline")
        self.max_batch = max(1, int(max_batch))
        self._stop = threading.Event()
        # (commit index, touched node-id set) of recent commits, newest
        # last — the transaction-time conflict attribution window.
        self._commit_log = collections.deque(maxlen=COMMIT_LOG_DEPTH)
        self._inflight: List = []
        self._opt_snap = None
        self.totals = PIPELINE_TOTALS
        # Express reservation ledger (server/express.py), set by the
        # server when the lane is enabled: active lease debits charge as
        # usage during verification. None = lease-blind (identical to
        # the pre-express pipeline).
        self.ledger = None

    def stop(self) -> None:
        self._stop.set()

    def stats(self) -> Dict[str, int]:
        return self.totals.stats()

    # -- conflict attribution ----------------------------------------------

    def _record_commit(self, index: int, touched: set):
        """Append one commit footprint and return the (mutable) entry so
        the waiter can overwrite the estimated index with the entry's
        real raft index once its future resolves. Mutating entry[0] races
        only benignly with _conflicts_since reads (int store is atomic;
        a read of the pre-fixup estimate is no worse than the estimate
        itself)."""
        if not touched:
            return None
        entry = [index, touched]
        self._commit_log.append(entry)
        return entry

    def _conflicts_since(self, touched: set, snapshot_index: int) -> bool:
        """Transaction-time check: did any commit after ``snapshot_index``
        touch overlapping node capacity? snapshot_index == 0 means the
        submitter predates conflict stamping (wire plans from old peers,
        the legacy planner shape) — no attribution, same behavior."""
        if snapshot_index <= 0 or not touched:
            return False
        log = self._commit_log
        for index, nodes in reversed(log):
            if index <= snapshot_index:
                # The log reaches back past the snapshot: the window is
                # fully covered and no overlap was found.
                return False
            if not touched.isdisjoint(nodes):
                return True
        # Scan fell off the log's old end before reaching snapshot_index.
        # A full deque means older commits were evicted — the window is
        # NOT covered, so attribute conservatively (treated as
        # overlapping, per the COMMIT_LOG_DEPTH contract). A part-filled
        # deque holds every commit this pipeline ever made: nothing was
        # missed, no conflict.
        return len(log) == log.maxlen

    # -- the loop -----------------------------------------------------------

    def run(self) -> None:
        while not self._stop.is_set():
            batch = self.plan_queue.dequeue_batch(
                self.max_batch, timeout=0.2
            )
            if not batch:
                continue
            try:
                self._process_batch(batch)
            except Exception as e:  # never leak blocked workers
                telemetry.incr_counter(("plan", "pipeline", "batch_failure"))
                self.logger.exception("plan pipeline batch failed")
                for pending in batch:
                    if not pending.future.done():
                        pending.respond(None, e)
                        if pending.plan.express_lease:
                            continue  # never marked the broker
                        # Clear the inflight mark outstanding_reset_and_mark
                        # set (the serial applier cleared it in EVERY
                        # respond path): a leaked mark makes nack defer on
                        # a retry timer forever and the eval permanently
                        # undeliverable. Unmarked/already-done plans are a
                        # harmless no-op decrement.
                        try:
                            self.eval_broker.plan_done(pending.plan.eval_id)
                        except Exception:
                            # plan_done is a lock-guarded decrement; a
                            # failure here means broker state is already
                            # torn down — count it and keep failing the
                            # remaining futures (nomadlint EXC001).
                            telemetry.incr_counter(
                                ("plan", "pipeline", "plan_done_error")
                            )

    def _process_batch(self, batch: List[PendingPlan]) -> None:
        tracer = trace.get_tracer()

        # Token verification + inflight mark, atomically per plan
        # (split-brain guard, plan_apply.go:52-58; the mark stops the nack
        # timer redelivering an eval whose plan is mid-commit).
        live: List[PendingPlan] = []
        ctxs: Dict[int, Dict[str, str]] = {}
        for pending in batch:
            eval_id = pending.plan.eval_id
            plan_ctx = pending.plan.span_ctx or tracer.root_ctx(eval_id)
            ctxs[id(pending)] = plan_ctx
            tracer.start_span(
                eval_id, "plan.queue_wait", parent=plan_ctx,
                start=pending.enqueue_time,
            ).finish()
            if pending.plan.express_lease:
                # Express async-commit plans (server/express.py): the
                # eval never rode the broker, so there is no outstanding
                # delivery to re-token or mark — and nothing to plan_done
                # later. They still verify/commit/bounce like any plan.
                live.append(pending)
                continue
            try:
                self.eval_broker.outstanding_reset_and_mark(
                    eval_id, pending.plan.eval_token
                )
            except BrokerError as e:
                self.logger.error(
                    "plan rejected for evaluation %s: %s", eval_id, e
                )
                pending.respond(None, e)
                with self.totals._lock:
                    self.totals.rejected += 1
                continue
            live.append(pending)
        if not live:
            return

        telemetry.add_sample(("plan", "batch_size"), float(len(live)))
        with self.totals._lock:
            self.totals.batches += 1
            self.totals.plans += len(live)
            self.totals.max_batch_seen = max(
                self.totals.max_batch_seen, len(live)
            )

        # Optimistic snapshot lineage: the rolled copy exists ONLY to
        # overlap verification with a still-in-flight apply. Once every
        # dispatched apply has resolved — and equally when the previous
        # batch dispatched nothing (all-bounce/noop batches leave
        # _inflight empty) — the real state is authoritative: drop the
        # rolled copy and re-snapshot fresh, so out-of-band raft writes
        # (client alloc updates freeing capacity, node drains, GC) are
        # seen and an all-bounce batch can never pin a stale snapshot
        # into an indefinite bounce loop.
        if self._inflight and all(f.done() for f in self._inflight):
            self._inflight = []
        if not self._inflight:
            self._opt_snap = None
        if self._opt_snap is None:
            self._opt_snap = self.fsm.state.snapshot()
        snap = self._opt_snap

        t0 = time.perf_counter()
        eval_spans = []
        for pending in live:
            eval_spans.append(tracer.start_span(
                pending.plan.eval_id, "plan.evaluate",
                parent=ctxs[id(pending)],
            ))
        # Commit-index estimate: the batch's K entries land back-to-back,
        # so the j-th committed plan's entry lands at base + j (exact
        # under InProcRaft absent interleaved writes; an interleaved
        # write shifts real indices up and the waiter fixes the commit
        # log up from each resolved future). The old serial "+1 for
        # every plan" stamped all K commits at the SAME index, which
        # broke the reversed commit-log scan's early-exit and
        # systematically under-attributed conflicts.
        base_index = self.raft.applied_index
        commit_seq = [0]

        def stamp_index() -> int:
            commit_seq[0] += 1
            return base_index + commit_seq[0]

        ledger = self.ledger
        if ledger is not None and not ledger.active() \
                and not any(p.plan.express_lease for p in live):
            # Empty ledger and no express plans in the batch: skip the
            # debit-map plumbing entirely (the lane-off steady state).
            ledger = None
        results = evaluate_plans(
            snap, [p.plan for p in live],
            stamp_index=stamp_index,
            totals=self.totals,
            ledger=ledger,
        )
        for span, result in zip(eval_spans, results):
            span.annotate("refresh_index", result.refresh_index)
            span.annotate("batched", len(live)).finish()
        telemetry.measure_since(("plan", "evaluate"), t0)

        # Commit-order pass: record committed footprints, attribute
        # conflicts transaction-time (same batch first — earlier commits
        # are already in the log when later plans are attributed).
        to_commit: List[Tuple[PendingPlan, PlanResult]] = []
        for pending, result in zip(live, results):
            plan = pending.plan
            if result.refresh_index:
                with self.totals._lock:
                    self.totals.refreshes += 1
                touched = _plan_touched_nodes(plan)
                if self._conflicts_since(touched, plan.snapshot_index):
                    result.conflict = True
                    telemetry.incr_counter(("plan", "conflicts"))
                    with self.totals._lock:
                        self.totals.conflicts += 1
            if result.is_noop():
                # Nothing to replicate (evict-nothing plans, whole-plan
                # bounces): respond straight away — the worker refreshes
                # and re-plans without waiting on this batch's commits.
                if not plan.express_lease:
                    self.eval_broker.plan_done(plan.eval_id)
                pending.respond(result, None)
                with self.totals._lock:
                    self.totals.noops += 1
                continue
            # Record the COMMITTED footprint (PlanResult carries the same
            # node-keyed shape as Plan), not the full ask — a bounced
            # subset took no capacity and must not charge later plans
            # with a conflict. Estimated index base + j (j-th dispatch of
            # this batch); the waiter overwrites it with the real index.
            entry = self._record_commit(
                base_index + len(to_commit) + 1,
                _plan_touched_nodes(result),
            )
            to_commit.append((pending, result, entry))
        if not to_commit:
            return

        # Bound staleness across batches: at most one batch of applies in
        # flight (plan_apply.go:119-144's single-overlap rule, batched).
        for f in self._inflight:
            try:
                f.result()
            except Exception:
                # The failure was already delivered to ITS plan's worker
                # by the waiter thread; here the future is only drained
                # for the single-overlap staleness bound. Still counted:
                # a quietly failing apply stream is a sick raft layer
                # (nomadlint EXC001).
                telemetry.incr_counter(("plan", "pipeline", "apply_error"))
        self._inflight = []

        dispatched = []
        for pending, result, entry in to_commit:
            apply_span = tracer.start_span(
                pending.plan.eval_id, "plan.apply",
                parent=ctxs[id(pending)],
            )
            future = self._apply(result, pending.plan, apply_span)
            dispatched.append((pending, result, future, apply_span, entry))
        self._inflight = [f for _, _, f, _, _ in dispatched]
        with self.totals._lock:
            self.totals.committed += len(dispatched)
        if all(f.done() for _, _, f, _, _ in dispatched):
            # Synchronous replication (InProcRaft): every future resolved
            # during dispatch — respond inline and spare each blocked
            # worker a waiter-thread spawn + context switch.
            self._resolve_batch(dispatched)
        else:
            waiter = threading.Thread(
                target=self._resolve_batch, args=(dispatched,), daemon=True,
                name="plan-pipeline-wait",
            )
            waiter.start()

    def _apply(self, result: PlanResult, plan: Plan, span=None):
        """Dispatch one plan's replicated alloc update. The optimistic
        snapshot was already rolled by evaluate_plans — only the raft
        entry goes out here."""
        t0 = time.perf_counter()
        allocs = _object_allocs(result)
        payload = {"allocs": allocs}
        if result.block_stops:
            # The raft codec writes them as stop id runs; an in-process
            # raft hands the runs to the FSM as they are.
            payload["block_stops"] = result.block_stops
        if result.alloc_batches:
            payload["alloc_batches"] = result.alloc_batches
        if result.update_batches:
            payload["update_batches"] = result.update_batches
        # Plan provenance rides the replicated entry so EVERY replica's
        # FSM publishes exactly one PlanApplied per committed plan.
        payload["plan"] = {
            "eval_id": plan.eval_id,
            "allocs": len(allocs) + sum(r.n for r in result.block_stops),
            "alloc_batches": len(result.alloc_batches),
            "update_batches": len(result.update_batches),
        }
        # A synchronous replication layer (InProcRaft) applies on THIS
        # thread: the active-span install lets the FSM hang its fsm.apply
        # span under plan.apply. An async raft applies elsewhere.
        with trace.use_span(span if span is not None else trace.NULL_SPAN):
            future = self.raft.apply("alloc_update", payload)
        telemetry.measure_since(("plan", "submit"), t0)
        return future

    def _resolve_batch(self, dispatched) -> None:
        """Resolve the batch's raft futures in commit order and respond —
        one thread per batch instead of one per plan (plan_apply.go:146-162
        amortized)."""
        for pending, result, future, span, entry in dispatched:
            index = 0
            try:
                try:
                    index = future.result()
                except Exception as e:  # raft apply failed
                    self.logger.error("failed to apply plan: %s", e)
                    if span is not None:
                        span.annotate("error", str(e)).finish()
                    pending.respond(None, e)
                    continue
                if entry is not None:
                    # Fix the conflict-attribution log up from estimate
                    # to the entry's real raft index (see _record_commit).
                    entry[0] = index
                result.alloc_index = index
                if span is not None:
                    span.annotate("alloc_index", index).finish()
                pending.respond(result, None)
            finally:
                # The commit is durable (or failed): redelivery may
                # proceed, and a redelivered worker's wait_index now
                # covers this plan. Express plans never marked the
                # broker, so there is nothing to clear.
                if not pending.plan.express_lease:
                    self.eval_broker.plan_done(
                        pending.plan.eval_id, commit_index=index
                    )
