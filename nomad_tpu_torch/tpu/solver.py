"""Device placement solver: Stack-protocol implementation + batched
schedulers (port of nomad_tpu/tpu/solver.py on torch tensors).

``TPUStack`` is a drop-in for the reference's GenericStack/SystemStack seam
(upstream scheduler/stack.go:24-33): set_nodes/set_job/select. Instead
of walking a chained iterator per candidate node, it tensorizes the node set
(nomad_tpu.tpu.mirror) and solves placement as a dense constraint-mask +
argmax bin-pack on device (nomad_tpu.ops.binpack).

Differences from the host oracle, by design:
- The host GenericStack ranks only a random ~log2(n) subset of feasible
  nodes (power-of-two-choices, stack.go:94-121); the dense solve scores
  every node at no extra cost, so placement quality is >= host.
- Network *port* assignment stays a host post-pass on the selected node
  (sparse + sequential, network.go:136-194); only dense bandwidth
  feasibility rides the device solve.

``TPUGenericScheduler`` reuses the host scheduler's diff/update/plan logic
wholesale and replaces the per-placement Select loop with one batched
``select_many`` per task group — one to a handful of device dispatches per
evaluation regardless of count. Class names stay those of nomad_tpu so the
two packages diff line for line.

``TPUSystemScheduler`` checks every pinned placement of a system task
group in one fit dispatch. Each dispatch fires the ``solver.execute``
fault site first. Dropped on purpose: the DEVICE_BREAKER accounting
around each dispatch and its host route. A device fault, injected or
organic, fails the eval, which is nacked and redelivered.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nomad_tpu_torch import faults, telemetry, trace
from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.network import NetworkIndex
from nomad_tpu_torch.ops.binpack import (
    EXACT_THRESHOLD,
    _greedy_step_state,
    bucket,
    device_const,
    solve_counts_async,
    solve_many_async,
)
from nomad_tpu_torch.ops.coalesce import device_activity
from nomad_tpu_torch.parallel import mesh as mesh_lib
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.feasible import _has_distinct_hosts
from nomad_tpu_torch.scheduler import SchedulerError
from nomad_tpu_torch.scheduler.generic import GenericScheduler
from nomad_tpu_torch.scheduler.rank import RankedNode
from nomad_tpu_torch.scheduler.stack import (
    BATCH_JOB_ANTI_AFFINITY_PENALTY,
    SERVICE_JOB_ANTI_AFFINITY_PENALTY,
)
from nomad_tpu_torch.scheduler.system import SystemScheduler
from nomad_tpu_torch.scheduler.util import (
    AllocTuple,
    tainted_nodes,
    task_group_constraints,
)
from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_FAILED,
    ALLOC_DESIRED_STATUS_RUN,
    ALLOC_DESIRED_STATUS_STOP,
    JOB_TYPE_BATCH,
    NODE_STATUS_READY,
    AllocBatch,
    Allocation,
    Job,
    Node,
    Plan,
    Resources,
    Task,
    TaskGroup,
    filter_terminal_allocs,
    generate_uuid,
    generate_uuids,
)
from nomad_tpu_torch.tpu.mirror import GLOBAL_MIRROR_CACHE, NodeMirror


# A placement out of a batched solve: (node, task_resources). Plain tuples:
# at bench scale (100k placements per eval) object construction is hot.
_Placement = Tuple[Node, Dict[str, Resources]]

_UUID_POOL = None


def _uuid_pool():
    """Single worker thread for id generation overlapped with device waits."""
    global _UUID_POOL
    if _UUID_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _UUID_POOL = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="nomad-uuid"
        )
    return _UUID_POOL


# Bulk alloc-id entropy: batches don't carry materialized ids at all —
# AllocBatch holds a 128-bit ids_seed and derives "32 hex chars per
# placement" through a deterministic SHAKE-256 stream only when something
# actually READS ids (a client sync, an individual lookup). The history
# here is instructive: os.urandom for 100k ids held the GIL ~4ms and
# starved the coalescer dispatcher; a process PRNG moved the cost but
# kept it (~4ms of bytes+hex per eval) somewhere on the eval's critical
# path, overlap games notwithstanding. Seed-form deletes the cost: the
# scheduler's columnar pipeline (solve → verify → commit) never reads an
# id, so at headline scale the expansion simply never happens — and the
# seed is what rides the wire and the raft log (16 bytes vs 3.2MB per
# 100k-alloc batch), with every replica deriving identical ids.
def _new_ids_seed() -> int:
    import os as _os

    return int.from_bytes(_os.urandom(16), "little")


class SolverPanel:
    """Device-solve efficiency introspection (/v1/agent/solver).

    The solver pads every dispatch — the node axis to a power-of-two
    bucket (mirror.padded) and the exact path's count axis likewise — so
    jit caches stay warm across varying cluster sizes. That trade is
    deliberate, but until now it was unmeasured: nobody could say how
    much device time the padding wastes at the current cluster size, how
    occupied the shape buckets actually run, or what each XLA compile
    cost and why it happened.

    Pure observer: counters recorded AFTER a solve's readback, on the
    worker's own thread, under a private lock no decision path takes.
    Decision-invariance is pinned by the churn-fragmentation scenario's
    observatory-off digest-equality arm.

    Books (process-wide, like PIPELINE_TOTALS):

    - per-solve padding economy: live vs padded rows on both axes, the
      waste ratios derived at snapshot time;
    - ``device_ms`` is RIDER-ATTRIBUTED solve wall (dispatch → readback
      per solve_group call): when the coalescer stacks N concurrent
      solves into one vmapped dispatch, each rider's window spans the
      shared dispatch, so the sum is an UPPER BOUND on device time
      under concurrency (read it next to the coalescer's
      dispatches/coalesced split on /v1/agent/solver);
    - bucket-occupancy histograms: solves + mean live rows per node
      bucket, and per count bucket on the exact path;
    - compile attribution: a bounded ring of first-dispatch records per
      (kind, node bucket, count bucket) shape key — wall time and the
      TRIGGER: ``precompile`` (warm_shapes), ``bucket_crossing`` (first
      solve of a new node-axis bucket), ``first_roll`` (first count
      bucket within a known node bucket);
    - device-time-per-placement: total device-solve wall over total
      placements, the scalar equivalence classes push down.
    """

    MAX_COMPILE_RECORDS = 128

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.solves = 0
        self.requested = 0
        self.placed = 0
        self.device_ms = 0.0
        self.live_rows = 0
        self.padded_rows = 0
        self.count_live = 0
        self.count_padded = 0
        # node bucket -> [solves, sum live rows]
        self._node_buckets: Dict[int, List[int]] = {}
        # count bucket -> [solves, sum live count] (exact path only; the
        # water-fill program is count-independent by construction)
        self._count_buckets: Dict[int, List[int]] = {}
        self._seen_shapes: set = set()
        self._seen_node_buckets: set = set()
        # Monotonic per-trigger compile counters, SEPARATE from the
        # bounded record ring below: the Prometheus counter families
        # derive from these, and a counter backed by an eviction ring
        # would DECREASE once shape diversity passes the cap — rate()
        # reads that as a reset and reports phantom compile spikes.
        self._compile_counts: Dict[str, int] = {}
        self._compiles: List[Dict] = []
        # Batch-width axis: eval-stack width -> [dispatches, evals,
        # device_ms] recorded by the coalescer per device dispatch. The
        # amortization story of cross-eval batching: N stacked evals'
        # shared dispatch wall divided by N is the per-eval cost the
        # batching win shows up in.
        self._batch_widths: Dict[int, List[float]] = {}
        # Equivalence classes (Borg §'equivalence class'): identical
        # task groups of one job collapsed to one solve row with a
        # multiplicity count. rows_saved = solves that never dispatched.
        self.equiv_classes = 0
        self.equiv_members = 0
        self.equiv_copies = 0
        self.equiv_rows_saved = 0

    # -- recording -----------------------------------------------------------

    @contextmanager
    def precompile(self):
        """Mark this thread's dispatches as warm_shapes precompiles so
        their first-shape records attribute to the warmer, not to a
        victim eval."""
        self._tls.precompile = getattr(self._tls, "precompile", 0) + 1
        try:
            yield
        finally:
            self._tls.precompile -= 1

    def record_solve(self, kind: str, n_live: int, n_padded: int,
                     count: int, count_padded: int, placed: int,
                     wall_ms: float) -> None:
        shape_key = (kind, n_padded, count_padded)
        pre = bool(getattr(self._tls, "precompile", 0))
        with self._lock:
            self.solves += 1
            self.requested += count
            self.placed += placed
            self.device_ms += wall_ms
            self.live_rows += n_live
            self.padded_rows += n_padded
            if count_padded:
                # Count-axis economy is an EXACT-path story: the
                # water-fill program is count-independent (its shape
                # never pads the ask count), so only padded-count
                # dispatches enter the ratio.
                self.count_live += count
                self.count_padded += count_padded
            nb = self._node_buckets.get(n_padded)
            if nb is None:
                nb = self._node_buckets[n_padded] = [0, 0]
            nb[0] += 1
            nb[1] += n_live
            if count_padded:
                cb = self._count_buckets.get(count_padded)
                if cb is None:
                    cb = self._count_buckets[count_padded] = [0, 0]
                cb[0] += 1
                cb[1] += count
            if shape_key not in self._seen_shapes:
                known_bucket = n_padded in self._seen_node_buckets
                self._seen_shapes.add(shape_key)
                self._seen_node_buckets.add(n_padded)
                trigger = (
                    "precompile" if pre
                    else "first_roll" if known_bucket
                    else "bucket_crossing"
                )
                self._compile_counts[trigger] = (
                    self._compile_counts.get(trigger, 0) + 1
                )
                self._compiles.append({
                    "shape": {"kind": kind, "node_bucket": n_padded,
                              "count_bucket": count_padded},
                    "trigger": trigger,
                    "wall_ms": round(wall_ms, 3),
                    "solve_seq": self.solves,
                })
                del self._compiles[:-self.MAX_COMPILE_RECORDS]

    def record_dispatch(self, width: int, wall_ms: float) -> None:
        """One coalescer device dispatch carrying ``width`` stacked evals
        (1 = a lone solve). Wall is dispatch→ready, rider-attributed like
        per-solve device_ms."""
        with self._lock:
            row = self._batch_widths.get(width)
            if row is None:
                row = self._batch_widths[width] = [0, 0, 0.0]
            row[0] += 1
            row[1] += width
            row[2] += wall_ms

    def record_equiv(self, members: int, count: int) -> None:
        """One equivalence-class collapse: ``members`` identical task
        groups (``count`` total copies) solved as one row."""
        with self._lock:
            self.equiv_classes += 1
            self.equiv_members += members
            self.equiv_copies += count
            self.equiv_rows_saved += members - 1

    # -- exposition ----------------------------------------------------------

    def snapshot(self) -> Dict:
        """The panel's section of the /v1/agent/solver body."""
        with self._lock:
            node_buckets = [
                {
                    "bucket": b, "solves": s, "mean_live_rows":
                    round(live / s, 1) if s else 0.0,
                    "occupancy": round(live / (s * b), 4) if s else 0.0,
                }
                for b, (s, live) in sorted(self._node_buckets.items())
            ]
            count_buckets = [
                {
                    "bucket": b, "solves": s, "mean_live":
                    round(live / s, 1) if s else 0.0,
                    "occupancy": round(live / (s * b), 4) if s else 0.0,
                }
                for b, (s, live) in sorted(self._count_buckets.items())
            ]
            return {
                "solves": self.solves,
                "requested": self.requested,
                "placed": self.placed,
                # Raw padded-axis sums: window consumers (the scenario
                # runner's trajectory) difference these to derive
                # in-window waste ratios.
                "live_rows": self.live_rows,
                "padded_rows": self.padded_rows,
                "count_live": self.count_live,
                "count_padded": self.count_padded,
                "device_ms": round(self.device_ms, 3),
                "device_ms_per_placement": round(
                    self.device_ms / self.placed, 4
                ) if self.placed else 0.0,
                # 1 - live/padded over every dispatched row: the share of
                # the node axis the device chewed for nothing.
                "node_padding_waste": round(
                    1.0 - self.live_rows / self.padded_rows, 4
                ) if self.padded_rows else 0.0,
                "count_padding_waste": round(
                    1.0 - self.count_live / self.count_padded, 4
                ) if self.count_padded else 0.0,
                "node_buckets": node_buckets,
                "count_buckets": count_buckets,
                # Eval-stack width histogram of the coalescer's device
                # dispatches + per-eval amortized device wall: the
                # cross-eval batching win, read directly. String keys so
                # the JSON round-trips stably (artifact diffs).
                "batch_widths": {
                    str(w): {
                        "dispatches": d, "evals": ev,
                        "device_ms": round(ms, 3),
                        "device_ms_per_eval": round(ms / ev, 4) if ev
                        else 0.0,
                    }
                    for w, (d, ev, ms) in sorted(
                        self._batch_widths.items())
                },
                "batch_dispatches": sum(
                    d for d, _e, _m in self._batch_widths.values()),
                "batch_evals": sum(
                    e for _d, e, _m in self._batch_widths.values()),
                "equiv": {
                    "classes": self.equiv_classes,
                    "members": self.equiv_members,
                    "copies": self.equiv_copies,
                    "rows_saved": self.equiv_rows_saved,
                },
                "compiles": {
                    "total": sum(self._compile_counts.values()),
                    "by_trigger": dict(sorted(
                        self._compile_counts.items())),
                    "recent": list(self._compiles[-16:]),
                },
            }


# Process-wide panel shared by every stack/scheduler instance (the
# PIPELINE_TOTALS posture); /v1/agent/solver serves its snapshot.
SOLVER_PANEL = SolverPanel()


def _check_device_fault(target: str) -> None:
    """Injected device death at the ``solver.execute`` site: raises, and
    the eval fails and is nacked as on an organic kernel fault. No
    breaker counts it and no host route takes the redelivery."""
    fault = faults.fire("solver.execute", target=target)
    if fault is not None and fault.mode in ("error", "drop", "partition"):
        raise faults.DeviceFault("injected fault: solver.execute")


def _solve_stages() -> "trace.StageTimer":
    """A live stage timer when this eval carries a trace span (the worker
    installed one via trace.use_span); the inert singleton otherwise, so
    an untraced solve pays one thread-local read."""
    if trace.current_span() is not None:
        return trace.StageTimer()
    return trace.NULL_STAGES


def _emit_solver_trace(st, start: float, count: int) -> None:
    """Publish one solve's stage cuts: child spans under the eval's active
    span (solver.staging/transfer/execute/readback — the SAME cuts
    bench.py's breakdown publishes, through the same StageTimer), plus
    the aggregate device-solve wall as a telemetry sample. Per-stage
    aggregates live in the spans, not the sink — four extra sink writes
    per solve measurably eat the <5% tracing-overhead budget."""
    ms = (time.perf_counter() - start) * 1000.0
    telemetry.add_sample(("solver", "solve"), ms)
    if st is trace.NULL_STAGES:
        return
    span = trace.current_span()
    if span is not None:
        span.annotate("solve_count", count)
    st.emit_spans(span)


class _SolveInputs:
    """Device inputs for one task-group solve, assembled by TPUStack.prepare."""

    __slots__ = (
        "mask", "used", "job_count", "tg_count", "bw_used",
        "ask", "ask_np", "bw_ask", "bw_ask_val", "job_distinct", "tg_distinct",
    )

    def __init__(self, mask, used, job_count, tg_count, bw_used, ask, ask_np,
                 bw_ask, bw_ask_val, job_distinct, tg_distinct):
        self.mask = mask
        self.used = used
        self.job_count = job_count
        self.tg_count = tg_count
        self.bw_used = bw_used
        self.ask = ask
        self.ask_np = ask_np
        self.bw_ask = bw_ask
        self.bw_ask_val = bw_ask_val
        self.job_distinct = job_distinct
        self.tg_distinct = tg_distinct


class TPUStack:
    """Dense-solve Stack (service/batch/system variants)."""

    def __init__(self, ctx: EvalContext, batch: bool = False,
                 system: bool = False, device=None):
        self.ctx = ctx
        self.device = resolve_device(device)
        self.batch = batch
        self.system = system
        if system:
            self.penalty = 0.0
        else:
            self.penalty = (
                BATCH_JOB_ANTI_AFFINITY_PENALTY
                if batch
                else SERVICE_JOB_ANTI_AFFINITY_PENALTY
            )
        self.job: Optional[Job] = None
        self.mirror: Optional[NodeMirror] = None

    def set_nodes(self, nodes: List[Node]) -> None:
        # No shuffle needed: the solve is a global argmax, not a sampled scan.
        self.mirror = NodeMirror(nodes, self.device)

    def set_mirror(self, mirror: NodeMirror) -> None:
        """Adopt a cached mirror (MirrorCache): node tensors already on
        device, mask caches warm from earlier evals of the same state
        generation."""
        self.mirror = mirror

    def set_job(self, job: Job) -> None:
        self.job = job

    # -- core batched solve ------------------------------------------------

    def solve_group(self, tg: TaskGroup, count: int, overlap=None):
        """One batched device solve for ``count`` copies of a task group:
        eligibility masks + usage tensorization + dispatch + readback. This
        is the reformulated Stack.Select loop (stack.go:131-159) and the
        north-star timed phase.

        Returns (idxs, oks, size): numpy node indices / ok flags per copy
        (idxs is None when the node set is empty). ``overlap``, if given, is
        called between device dispatch and readback — independent host work
        (uuid batches, name materialization) rides the transfer round-trip.
        """
        start = time.perf_counter()
        st = _solve_stages()
        with trace.use_stages(st):
            with st.stage("staging"):
                tg_constr = task_group_constraints(tg)
                prep = self.prepare(tg, tg_constr)
            if prep is None:
                if overlap is not None:
                    overlap()
                self.ctx.metrics().allocation_time = (
                    time.perf_counter() - start
                )
                _emit_solver_trace(st, start, count)
                return None, None, tg_constr.size

            # nomad_tpu also counts the dispatch against DEVICE_BREAKER
            # here; the port has no breaker.
            _check_device_fault(tg.name)
            t_dispatch = time.perf_counter()
            with st.stage("transfer"):
                fetch = solve_many_async(
                    self.mirror.total, self.mirror.sched_cap, prep.used,
                    prep.job_count, prep.tg_count, self.mirror.bw_avail,
                    prep.bw_used, prep.mask, prep.ask, prep.bw_ask, count,
                    self.penalty, job_distinct=prep.job_distinct,
                    tg_distinct=prep.tg_distinct,
                )
            if overlap is not None:
                overlap()
            idxs, oks = fetch()
        self.ctx.metrics().allocation_time = time.perf_counter() - start
        _emit_solver_trace(st, start, count)
        exact = count <= EXACT_THRESHOLD
        # Panel wall = the dispatch→readback window only: staging
        # (constraint masks, mirror usage build) is HOST work and must
        # not inflate the device-time books.
        SOLVER_PANEL.record_solve(
            "exact" if exact else "waterfill",
            self.mirror.n, self.mirror.padded,
            count, bucket(count) if exact else 0,
            int(np.count_nonzero(oks)),
            (time.perf_counter() - t_dispatch) * 1000.0,
        )
        return idxs, oks, tg_constr.size

    def solve_group_counts(self, tg: TaskGroup, count: int, overlap=None):
        """Columnar variant of solve_group: one water-fill dispatch, returns
        (counts[N] per mirror row, n_unplaced, size). The AllocBatch path —
        no per-placement expansion anywhere."""
        start = time.perf_counter()
        st = _solve_stages()
        with trace.use_stages(st):
            with st.stage("staging"):
                tg_constr = task_group_constraints(tg)
                prep = self.prepare(tg, tg_constr)
            if prep is None:
                if overlap is not None:
                    overlap()
                self.ctx.metrics().allocation_time = (
                    time.perf_counter() - start
                )
                _emit_solver_trace(st, start, count)
                return None, count, tg_constr.size

            _check_device_fault(tg.name)
            t_dispatch = time.perf_counter()
            with st.stage("transfer"):
                fetch = solve_counts_async(
                    self.mirror.total, self.mirror.sched_cap, prep.used,
                    prep.job_count, prep.tg_count, self.mirror.bw_avail,
                    prep.bw_used, prep.mask, prep.ask, prep.bw_ask, count,
                    self.penalty, job_distinct=prep.job_distinct,
                    tg_distinct=prep.tg_distinct,
                )
            if overlap is not None:
                overlap()
            counts, unplaced = fetch()
        self.ctx.metrics().allocation_time = time.perf_counter() - start
        _emit_solver_trace(st, start, count)
        SOLVER_PANEL.record_solve(
            "waterfill", self.mirror.n, self.mirror.padded, count, 0,
            count - int(unplaced),
            (time.perf_counter() - t_dispatch) * 1000.0,
        )
        return counts, unplaced, tg_constr.size

    def select_many(self, tg: TaskGroup, count: int) -> Tuple[List[Optional[_Placement]], Resources]:
        """Place ``count`` copies of a task group in one batched device solve.

        Returns (placements, size): ``placements[i]`` is None when no node
        was found for the i-th copy.
        """
        idxs, oks, size = self.solve_group(tg, count)
        if idxs is None:
            return [None] * count, size
        placements = self._offer_networks(tg, idxs, oks)
        return placements, size

    def prepare(self, tg: TaskGroup, tg_constr) -> Optional["_SolveInputs"]:
        """Assemble the device inputs for one task group: eligibility mask,
        utilization tensors, ask vectors, distinct-hosts scopes. Shared by
        select_many and the batched system scheduler. Returns None when the
        node set is empty."""
        mirror = self.mirror
        metrics = self.ctx.metrics()
        if mirror is None or mirror.n == 0:
            return None

        # Eligibility: drivers + job & tg constraints, all as masks —
        # combined + uploaded once per (state generation, constraint set).
        mask_dev, n_filtered = mirror.device_mask(
            self.ctx, tg_constr.drivers,
            self.job.constraints if self.job is not None else None,
            tg_constr.constraints,
        )

        metrics.evaluate_node(mirror.n)
        if n_filtered:
            metrics.filter_node(None, "constraint-mask", n_filtered)

        job_distinct = False
        tg_distinct = _has_distinct_hosts(tg.constraints)
        if self.job is not None:
            job_distinct = _has_distinct_hosts(self.job.constraints)

        job_id = self.job.id if self.job is not None else ""
        used, job_count, tg_count, bw_used = mirror.build_usage(
            self.ctx, job_id, tg.name
        )
        ask_vec = tuple(tg_constr.size.as_vector())
        ask_np = np.array(ask_vec, dtype=np.int32)
        bw_ask_val = sum(
            t.resources.networks[0].mbits
            for t in tg.tasks
            if t.resources and t.resources.networks
        )
        return _SolveInputs(
            mask=mask_dev, used=used, job_count=job_count,
            tg_count=tg_count, bw_used=bw_used,
            ask=device_const("ask", ask_vec, self.device),
            ask_np=ask_np,
            bw_ask=device_const("i32", bw_ask_val, self.device),
            bw_ask_val=bw_ask_val,
            job_distinct=job_distinct, tg_distinct=tg_distinct,
        )

    def _offer_networks(
        self, tg: TaskGroup, idxs: List[int], oks: List[bool]
    ) -> List[Optional[_Placement]]:
        """Host post-pass: assign IPs + ports on each selected node, tracking
        offers made earlier in this batch (mirrors rank.go:179-211)."""
        mirror = self.mirror
        metrics = self.ctx.metrics()
        net_indexes: Dict[int, NetworkIndex] = {}
        placements: List[Optional[_Placement]] = []

        if not any(t.resources is not None and t.resources.networks for t in tg.tasks):
            # No network asks: nothing to offer. Share one task_resources
            # map across placements — the reference's Select fallback also
            # aliases the task's own Resources when no offer is needed
            # (stack.go:150-154). Consumers must treat these as immutable;
            # select() copies before handing them to inplace_update.
            shared = {t.name: t.resources for t in tg.tasks}
            nodes_list = mirror.nodes
            n = mirror.n
            return [
                (nodes_list[idx], shared) if ok and 0 <= idx < n else None
                for idx, ok in zip(idxs, oks)
            ]

        for idx, ok in zip(idxs, oks):
            if not ok or idx < 0 or idx >= mirror.n:
                placements.append(None)
                continue
            node = mirror.nodes[idx]

            net_idx = net_indexes.get(idx)
            if net_idx is None:
                # Per-eval seeded port stream, like BinPackIterator: stale-
                # snapshot evals must not collide on a shared node's ports.
                net_idx = NetworkIndex(self.ctx.prng("network.dynamic_ports"))
                net_idx.set_node(node)
                net_idx.add_allocs(self.ctx.proposed_allocs(node.id))
                net_indexes[idx] = net_idx

            task_resources: Dict[str, Resources] = {}
            failed = False
            for task in tg.tasks:
                res = task.resources.copy()
                if res.networks:
                    offer, err = net_idx.assign_network(res.networks[0])
                    if offer is None:
                        metrics.exhausted_node(node, f"network: {err}")
                        failed = True
                        break
                    net_idx.add_reserved(offer)
                    res.networks = [offer]
                task_resources[task.name] = res
            if failed:
                placements.append(None)
                continue
            placements.append((node, task_resources))
        return placements

    # -- Stack protocol ----------------------------------------------------

    def select(self, tg: TaskGroup) -> Tuple[Optional[RankedNode], Resources]:
        """Single-placement Stack entry, used by inplace_update and host-style
        callers."""
        self.ctx.reset()
        placements, size = self.select_many(tg, 1)
        placement = placements[0]
        if placement is None:
            return None, size
        node, task_resources = placement
        option = RankedNode(node)
        # Copy per task: inplace_update mutates these (util.py network
        # restore), and the fast path may alias the job spec's Resources.
        option.task_resources = {k: v.copy() for k, v in task_resources.items()}
        for task in tg.tasks:
            if task.name not in option.task_resources:
                option.task_resources[task.name] = task.resources
        return option, size


class TPUGenericScheduler(GenericScheduler):
    """GenericScheduler with the dense batched solve
    (factory names: tpu-service / tpu-batch)."""

    # Task groups at or above this count (and without network asks) place
    # through the columnar AllocBatch path; smaller ones keep the object
    # flow, whose semantics the ported reference tests pin down exactly.
    BATCH_PLACE_THRESHOLD = 256

    def __init__(self, state, planner, logger: logging.Logger, batch: bool,
                 device=None):
        super().__init__(state, planner, logger, batch)
        self.device = resolve_device(device)

    def make_stack(self, ctx: EvalContext) -> TPUStack:
        return TPUStack(ctx, batch=self.batch, device=self.device)

    def compute_job_allocs(self) -> None:
        """Columnar reconcile fast path, skipping name materialization and
        per-alloc diff objects:

        - Fresh registration: no existing allocations means stop/update/
          migrate are empty by definition (util.go:54-131 degenerates to
          place-everything); each big task group places as one columnar
          batch over index range [0, count).
        - Pure scale-up: every existing alloc is an 'ignore' (same job
          version, group still present, node untainted, index in range) —
          the missing indices are recovered by parsing the count-expansion
          names of the *existing* allocs (len(existing) parses instead of
          count string materializations), and only those place.
        - Pure in-place update: allocs differ only by job version with
          tasks_updated false (util.go:265-302) — they re-stamp columnar
          via AllocUpdateBatch under a per-node delta headroom check,
          never touching the per-alloc select (util.go:316-398).

        Anything needing stops, migrations, destructive updates, or
        network reoffers falls through to the reference-shaped object
        diff (generic_sched.go:186-243).
        """
        job = self.job
        if job is None:
            return super().compute_job_allocs()

        # Deepest fast path: every existing alloc lives in stored columnar
        # blocks — reconcile and in-place-update whole blocks without
        # materializing a single member.
        blocked = self._block_reconcile()
        if blocked is not None:
            existing_idx, updates_by_tg = blocked, {}
        else:
            existing = filter_terminal_allocs(
                self.state.allocs_by_job(self.eval.job_id)
            )
            if existing:
                reconciled = self._fast_reconcile(existing)
                if reconciled is None:
                    return super().compute_job_allocs()
                existing_idx, updates_by_tg = reconciled
            else:
                existing_idx, updates_by_tg = {}, {}

        if updates_by_tg:
            batches, leftovers = self._plan_update_batches(updates_by_tg)
            if leftovers:
                # Overflowing nodes need the evict-and-place machinery:
                # take the full reference-shaped diff instead.
                return super().compute_job_allocs()
            for b in batches:
                self.ctx.plan.append_update_batch(b)

        big, small = [], []
        # In a block-world job (reconciled block-wise above) replacements
        # must stay columnar regardless of count: small object placements
        # would flip the live-object gate and knock every later rolling
        # round off the block path.
        force_columnar = blocked is not None
        for tg in job.task_groups:
            have = existing_idx.get(tg.name)
            if have:
                if len(have) >= tg.count:
                    continue
                missing = np.setdiff1d(
                    np.arange(tg.count),
                    np.fromiter(have, dtype=np.int64, count=len(have)),
                )
            else:
                missing = np.arange(tg.count)
            if len(missing) == 0:
                continue
            has_networks = any(
                t.resources is not None and t.resources.networks
                for t in tg.tasks
            )
            if not has_networks and (
                force_columnar
                or len(missing) >= self.BATCH_PLACE_THRESHOLD
            ):
                big.append((tg, missing))
            else:
                small.append((tg, missing))

        self._reconcile_done(
            "block" if blocked is not None else "fast",
            sum(len(missing) for _tg, missing in big + small))
        if small:
            place = [
                AllocTuple(f"{job.name}.{tg.name}[{i}]", tg)
                for tg, missing in small
                for i in missing
            ]
            if place:
                self.compute_placements(place)
        self._place_big_groups(big)

    def _place_big_groups(self, big) -> None:
        """Columnar placement of the big task groups, collapsed by
        EQUIVALENCE CLASS (Borg §scheduling 'equivalence classes'):
        CONSECUTIVE groups whose solve inputs are identical — same ask
        vector, same drivers, same constraint surface, no distinct_hosts
        scoping — share ONE counts-solve carrying the summed
        multiplicity, and the per-node counts de-mux host-side back into
        one AllocBatch per member group (first-member-first along the
        mirror's row order, the same exhaustion order the sequential
        per-group loop produces). A job spelled as M identical groups
        costs one solve row instead of M. Only ADJACENT members collapse:
        folding a later equivalent group past an interleaved
        non-equivalent one would let its placements into the plan before
        that group solves, changing the usage view (anti-affinity
        job_count, plan deltas) the sequential loop would have given it
        — consecutive runs keep the accumulation order bit-identical for
        every non-member."""
        if len(big) < 2:
            for tg, missing in big:
                self._place_batch(tg, missing)
            return
        job_distinct = (self.job is not None
                        and _has_distinct_hosts(self.job.constraints))

        def equiv_key(tg):
            if job_distinct or _has_distinct_hosts(tg.constraints):
                return None
            c = task_group_constraints(tg)
            return (
                tuple(c.size.as_vector()),
                frozenset(c.drivers),
                tuple((x.l_target, x.operand, x.r_target)
                      for x in c.constraints),
            )

        def flush(run):
            if len(run) == 1:
                self._place_batch(*run[0])
            else:
                self._place_batch_class(run)

        run: list = []
        run_key: Optional[Tuple] = None
        for tg, missing in big:
            key = equiv_key(tg)
            if run and key is not None and key == run_key:
                run.append((tg, missing))
                continue
            if run:
                flush(run)
            if key is None:
                self._place_batch(tg, missing)
                run, run_key = [], None
            else:
                run, run_key = [(tg, missing)], key
        if run:
            flush(run)

    def _place_batch_class(self, members) -> None:
        """One counts-solve for a whole equivalence class: ``members`` is
        [(tg, missing_indices), ...] with identical solve inputs. The
        combined per-node counts split back into per-member AllocBatches
        by walking the solve's row order and filling members in job
        order — so member i's share is exactly what a sequential loop
        would have carved out of the same combined capacity."""
        from nomad_tpu_torch.structs import AllocBatch

        self.ctx.reset()
        tg0 = members[0][0]
        total_count = sum(len(m) for _tg, m in members)
        _nodes, mirror = GLOBAL_MIRROR_CACHE.get(
            self.state, self.job.datacenters, self.device
        )
        self.stack.set_mirror(mirror)
        # Members share one resource size by class-key construction:
        # the solve's size serves every member's batch and failed alloc.
        counts, unplaced, size = self.stack.solve_group_counts(
            tg0, total_count
        )
        SOLVER_PANEL.record_equiv(len(members), total_count)
        # Per-member metrics: a deep copy of the shared solve's books per
        # member, so coalesced_failures (and any later mutation) never
        # accumulates across members onto one object — the sequential
        # loop gives every group its own AllocMetric and consumers sum
        # failure counts per failed alloc.
        solve_metrics = self.ctx.metrics()

        placed_total = total_count - unplaced if counts is not None else 0
        ids_arr = mirror.id_array()
        nz = (np.flatnonzero(counts[: mirror.n])
              if placed_total > 0 else np.empty(0, dtype=np.int64))
        # De-mux: walk the placed rows in order, carving each row's count
        # into the current member's remaining need.
        run_iter = iter(nz.tolist())
        row = None
        row_left = 0
        for tg, missing in members:
            metrics = copy.deepcopy(solve_metrics)
            need = min(len(missing), placed_total)
            placed_total -= need
            m_rows: List[int] = []
            m_counts: List[int] = []
            while need > 0:
                if row_left == 0:
                    row = next(run_iter)
                    row_left = int(counts[row])
                take = min(row_left, need)
                m_rows.append(row)
                m_counts.append(take)
                row_left -= take
                need -= take
            n_member_placed = sum(m_counts)
            if n_member_placed:
                batch = AllocBatch(
                    eval_id=self.eval.id,
                    job=self.job,
                    tg_name=tg.name,
                    resources=size,
                    task_resources={t.name: t.resources for t in tg.tasks},
                    metrics=metrics,
                    node_ids=ids_arr[m_rows].tolist(),
                    node_counts=m_counts,
                    name_idx=np.asarray(missing[:n_member_placed]),
                    ids_seed=_new_ids_seed(),
                )
                batch.src_ids_ref = ids_arr
                batch.src_rows = np.asarray(m_rows, dtype=np.int64)
                self.plan.append_batch(batch)
            n_failed = len(missing) - n_member_placed
            if n_failed:
                failed = object.__new__(Allocation)
                failed.__dict__ = {
                    "id": generate_uuid(), "eval_id": self.eval.id,
                    "name": f"{self.job.name}.{tg.name}"
                            f"[{int(missing[n_member_placed])}]",
                    "node_id": "", "job_id": self.job.id, "job": self.job,
                    "task_group": tg.name,
                    "resources": size,
                    "task_resources": {}, "metrics": metrics,
                    "desired_status": ALLOC_DESIRED_STATUS_FAILED,
                    "desired_description":
                        "failed to find a node for placement",
                    "client_status": ALLOC_CLIENT_STATUS_FAILED,
                    "client_description": "", "create_index": 0,
                    "modify_index": 0,
                }
                failed.metrics.coalesced_failures += n_failed - 1
                self.plan.append_failed(failed)

    def _constraints_unchanged(self, old_job, old_tg, new_tg) -> bool:
        """Whether the feasibility criteria (job + tg + per-task
        constraints, datacenters, drivers) are identical between job
        versions. tasks_updated ignores these, but they gate whether the
        in-place node is still eligible."""
        job = self.job
        if (old_job.constraints != job.constraints
                or old_job.datacenters != job.datacenters
                or old_tg.constraints != new_tg.constraints):
            return False
        for nt in new_tg.tasks:
            ot = old_tg.lookup_task(nt.name)
            if ot is None or ot.constraints != nt.constraints:
                return False
        return True

    def _plan_update_batches(self, updates_by_tg):
        """Plan one AllocUpdateBatch per task group for columnar in-place
        updates, admitting per node within delta headroom. Old resource
        vectors are identity-cached: allocs of one batch share a single
        Resources object, so this is dict hits, not numpy per alloc.
        Returns (batches, leftover_allocs) — leftovers exceeded some
        node's headroom and need the per-alloc path."""
        from nomad_tpu_torch.structs import AllocUpdateBatch

        state = self.ctx.state
        vec_cache: Dict[int, np.ndarray] = {}

        def vec(res):
            key = id(res)
            v = vec_cache.get(key)
            if v is None:
                v = (np.zeros(4, dtype=np.int64) if res is None
                     else np.asarray(res.as_vector(), dtype=np.int64))
                vec_cache[key] = v
            return v

        # Per-node current usage -> headroom, shared across groups. With
        # the store's node table available, the base (totals - reserved -
        # columnar block usage) is three array ops; per-node python runs
        # only where object rows or plan entries exist. Existing allocs of
        # a committed columnar job would otherwise materialize per node
        # right here.
        from nomad_tpu_torch.server.plan_apply import _node_table

        headroom: Dict[str, Optional[np.ndarray]] = {}
        table = _node_table(state)
        plan = self.ctx.plan
        if table is not None:
            headroom_base, net_rows, blocks, obj_nodes = (
                self._headroom_base(state, table)
            )

            def node_headroom(nid):
                h = headroom.get(nid, False)
                if h is not False:
                    return h
                row = table.rows.get(nid)
                if row is None:
                    headroom[nid] = None
                    return None
                if net_rows is not None and net_rows[row]:
                    # Network-carrying block usage isn't in the base (it
                    # needs the sequential port index): no columnar
                    # headroom claim — the per-alloc path decides.
                    headroom[nid] = None
                    return None
                h = headroom_base[row].copy()
                if (nid in obj_nodes or plan.node_update.get(nid)
                        or plan.node_allocation.get(nid)):
                    counts: Dict[int, int] = {}
                    for a in self.ctx.proposed_allocs_objects(nid):
                        key = id(a.resources)
                        counts[key] = counts.get(key, 0) + 1
                        if key not in vec_cache:
                            vec(a.resources)
                    for key, n in counts.items():
                        h -= vec_cache[key] * n
                    # Evicted block members: the base counted them; the
                    # object walk can't subtract them, so credit back.
                    for a in plan.node_update.get(nid, ()):
                        if any(blk.find(a.id) is not None for blk in blocks):
                            h += vec(a.resources)
                headroom[nid] = h
                return h

            def admit_vectorized(groups, new_vec):
                """Single-member groups on 'simple' nodes (no object rows,
                no plan entries, no network blocks, no prior headroom
                claim) admit in ONE vectorized gather over the node table
                — the 10k-nodes-one-alloc-each steady state of a columnar
                job's in-place update. Admitted allocs' headroom is
                deducted from the shared base in place; everything else
                stays for the per-node python path."""
                # A node may host several single-member groups (distinct
                # old-Resources identities after a snapshot restore); the
                # one-shot gather below assumes one delta per row, so only
                # nodes with exactly one candidate group qualify.
                node_candidates: Dict[str, int] = {}
                for key, members in groups.items():
                    if len(members) == 1:
                        nid = key[0]
                        node_candidates[nid] = node_candidates.get(nid, 0) + 1
                simple = []
                rows = []
                deltas = []
                for key, members in groups.items():
                    if len(members) != 1:
                        continue
                    nid = key[0]
                    if node_candidates.get(nid, 0) != 1:
                        continue  # duplicate rows: scalar ledger path
                    if nid in headroom:
                        continue  # claimed by an earlier group/tg
                    row = table.rows.get(nid)
                    if row is None:
                        continue
                    if net_rows is not None and net_rows[row]:
                        continue
                    if (nid in obj_nodes or plan.node_update.get(nid)
                            or plan.node_allocation.get(nid)):
                        continue
                    simple.append(key)
                    rows.append(row)
                    deltas.append(new_vec - vec(members[0].resources))
                if not simple:
                    return groups, []
                rows_arr = np.asarray(rows, dtype=np.int64)
                delta_mat = np.stack(deltas)
                h_mat = headroom_base[rows_arr]
                ok = np.all((h_mat - delta_mat >= 0) | (delta_mat <= 0),
                            axis=1)
                admitted = []
                for i, key in enumerate(simple):
                    if ok[i]:
                        admitted.append(groups.pop(key)[0])
                # One in-place deduction for every admitted node: later
                # node_headroom calls (other groups/tgs) read the updated
                # base, matching the scalar path's headroom[nid] ledger.
                adm_rows = rows_arr[ok]
                if adm_rows.size:
                    headroom_base[adm_rows] -= delta_mat[ok]
                return groups, admitted
        else:
            def node_headroom(nid):
                h = headroom.get(nid, False)
                if h is not False:
                    return h
                node = state.node_by_id(nid)
                if node is None or node.resources is None:
                    headroom[nid] = None
                    return None
                used = vec(node.reserved).copy()
                # Identity-counted accumulation over the proposed view
                counts: Dict[int, int] = {}
                for a in self.ctx.proposed_allocs(nid):
                    key = id(a.resources)
                    counts[key] = counts.get(key, 0) + 1
                    if key not in vec_cache:
                        vec(a.resources)
                for key, n in counts.items():
                    used += vec_cache[key] * n
                h = vec(node.resources) - used
                headroom[nid] = h
                return h

        batches = []
        all_leftovers = []
        for tg, allocs in updates_by_tg.values():
            size = task_group_constraints(tg).size
            new_vec = np.asarray(size.as_vector(), dtype=np.int64)
            # Group by (node, old-resources identity): one delta check per
            # group instead of per alloc.
            groups: Dict[Tuple[str, int], list] = {}
            for a in allocs:
                groups.setdefault((a.node_id, id(a.resources)), []).append(a)

            batch_allocs = []
            if table is not None:
                groups, simple_admitted = admit_vectorized(groups, new_vec)
                batch_allocs.extend(simple_admitted)
            for (nid, _res_key), members in groups.items():
                h = node_headroom(nid)
                if h is None:
                    all_leftovers.extend((tg, a) for a in members)
                    continue
                delta = new_vec - vec(members[0].resources)
                if not delta.any():
                    batch_allocs.extend(members)
                    continue
                # Admit the largest k with h - k*delta >= 0 on growth dims.
                grow = delta > 0
                if grow.any():
                    k = int(np.min(h[grow] // delta[grow]))
                    k = max(0, min(k, len(members)))
                else:
                    k = len(members)
                if k:
                    headroom[nid] = h - delta * k
                    batch_allocs.extend(members[:k])
                all_leftovers.extend((tg, a) for a in members[k:])

            if batch_allocs:
                batches.append(AllocUpdateBatch(
                    eval_id=self.eval.id,
                    job=self.job,
                    tg_name=tg.name,
                    resources=size,
                    task_resources={t.name: t.resources for t in tg.tasks},
                    metrics=self.ctx.metrics(),
                    allocs=batch_allocs,
                ))
        return batches, all_leftovers

    def inplace_updates(self, updates):
        """Columnar in-place updates for the object-diff path: eligible
        task groups (tasks_updated false, util.go:265-302, and network-
        free) batch through _plan_update_batches; networks, real task
        changes, and headroom-overflow leftovers take the reference's
        per-alloc path (util.go:316-398)."""
        from nomad_tpu_torch.scheduler.util import tasks_updated

        if len(updates) < self.BATCH_PLACE_THRESHOLD:
            return super().inplace_updates(updates)

        by_tg: Dict[int, Tuple[TaskGroup, list]] = {}
        rest = []
        for u in updates:
            existing_tg = u.alloc.job.lookup_task_group(u.task_group.name)
            if (existing_tg is None
                    or tasks_updated(u.task_group, existing_tg)
                    or not self._constraints_unchanged(
                        u.alloc.job, existing_tg, u.task_group)):
                rest.append(u)
                continue
            has_net = any(
                t.resources is not None and t.resources.networks
                for t in u.task_group.tasks
            ) or any(
                tr is not None and tr.networks
                for tr in (u.alloc.task_resources or {}).values()
            )
            if has_net:
                rest.append(u)
                continue
            by_tg.setdefault(
                id(u.task_group), (u.task_group, [])
            )[1].append(u.alloc)

        if not by_tg:
            return super().inplace_updates(rest) if rest else rest

        batches, leftovers = self._plan_update_batches(by_tg)
        for b in batches:
            self.ctx.plan.append_update_batch(b)
        rest.extend(AllocTuple(a.name, tg, a) for tg, a in leftovers)
        self.logger.debug(
            "sched: %s: %d columnar in-place updates of %d",
            self.eval, sum(b.n for b in batches), len(updates),
        )
        return super().inplace_updates(rest) if rest else rest

    def _block_reconcile(self):
        """Block-level reconcile: classify whole StoredAllocBlocks as
        'ignore' or 'in-place update' under the five-way diff
        (util.go:54-131) without materializing a single member — the
        steady state of a committed columnar job. Eligible update blocks
        are appended to the plan as block-columnar AllocUpdateBatches
        (src_* columns) and the occupied index map is returned; None means
        'cannot decide block-wise' (object rows, taint, scale-down,
        destructive change, headroom overflow) and the caller takes the
        materializing path."""
        from nomad_tpu_torch.scheduler.util import tasks_updated
        from nomad_tpu_torch.server.plan_apply import _node_table

        job = self.job
        state = self.state
        if not hasattr(state, "job_alloc_blocks") or not hasattr(
            state, "job_has_object_allocs"
        ):
            return None
        if state.job_has_object_allocs(self.eval.job_id):
            return None
        blocks = state.job_alloc_blocks(self.eval.job_id)
        if not blocks:
            return None  # fresh registration: normal path is already lean
        table = _node_table(state)
        if table is None:
            return None
        tg_by_name = {tg.name: tg for tg in job.task_groups}
        rows_get = table.rows.get
        dead = table.dead
        job_mi = job.modify_index
        occupied: Dict[str, set] = {}
        live_total: Dict[str, int] = {}
        pending: list = []
        destructive: list = []
        for blk in blocks:
            tg = tg_by_name.get(blk.tg_name)
            if tg is None:
                return None  # group removed: stops needed
            for nid in blk.node_ids:
                row = rows_get(nid)
                if row is None or dead[row]:
                    return None  # tainted node: migrations needed
            # Excluded positions are promoted members whose object rows
            # are terminal (the live-object gate above ruled out
            # non-terminal ones): only the LIVE view participates.
            idx = blk.live_name_idx()
            if idx.size and int(idx.max()) >= tg.count:
                return None  # scale-down: stops needed
            occ = occupied.setdefault(blk.tg_name, set())
            occ.update(idx.tolist())
            live_total[blk.tg_name] = (
                live_total.get(blk.tg_name, 0) + blk.n_live
            )
            if blk.job is job or (
                blk.job is not None and blk.job.modify_index == job_mi
            ):
                continue  # ignore: same job version
            old_job = blk.job
            old_tg = old_job.lookup_task_group(blk.tg_name) if old_job else None
            if (old_tg is None
                    or any(t.resources is not None and t.resources.networks
                           for t in tg.tasks)
                    or any(tr is not None and tr.networks
                           for tr in (blk.task_resources or {}).values())):
                return None  # network reoffer / reshaped group: object path
            if (tasks_updated(tg, old_tg)
                    or not self._constraints_unchanged(old_job, old_tg, tg)):
                # Destructive change: block-wise only under a rolling
                # update strategy (evict max_parallel members, place
                # replacements); evict-everything takes the object path.
                if not job.update.rolling():
                    return None
                destructive.append((tg, blk))
            else:
                pending.append((tg, blk))
        for tg_name, occ in occupied.items():
            if live_total[tg_name] != len(occ):
                return None  # duplicate indices: needs the object diff
        if pending:
            batches = self._admit_block_updates(pending, table, state)
            if batches is None:
                return None  # headroom overflow: evict-and-place machinery
            for b in batches:
                self.ctx.plan.append_update_batch(b)
            self.logger.debug(
                "sched: %s: %d block-columnar in-place updates",
                self.eval, sum(b.n for b in batches),
            )
        if destructive:
            self._evict_block_prefixes(destructive, occupied)
        return occupied

    def _evict_block_prefixes(self, destructive, occupied) -> None:
        """Rolling destructive update over whole blocks: evict the first
        max_parallel members as one stop run a block (``stop_prefix``:
        positions and node runs, no Allocation built), free their name
        indices so the caller's missing-index placement refills them
        columnar, and flag limit_reached so the next rolling eval is
        scheduled (util.go:400-416 evictAndPlace semantics)."""
        from nomad_tpu_torch.scheduler.generic import ALLOC_UPDATING

        limit = self.job.update.max_parallel
        plan = self.ctx.plan
        for tg, blk in destructive:
            if limit <= 0:
                self.limit_reached = True
                break
            k = min(limit, blk.n_live)
            run = blk.stop_prefix(k, ALLOC_DESIRED_STATUS_STOP,
                                  ALLOC_UPDATING)
            plan.append_block_stop(run)
            occ = occupied[blk.tg_name]
            occ.difference_update(blk.name_idx[run.positions].tolist())
            limit -= k
            if k < blk.n_live:
                self.limit_reached = True
        self.logger.debug(
            "sched: %s: rolling block eviction, limit_reached=%s",
            self.eval, self.limit_reached,
        )

    @staticmethod
    def _headroom_base(state, table):
        """Free-capacity base over the node table: totals - reserved -
        columnar block usage. The ONE construction shared by the scalar
        ledger (_plan_update_batches) and the whole-block admission
        (_admit_block_updates), so the two in-place admission tiers can
        never drift. Returns (base int64[N,4], net_rows, blocks,
        obj_nodes)."""
        from nomad_tpu_torch.server.plan_apply import _existing_block_usage_rows

        block_usage, net_rows, blocks = _existing_block_usage_rows(
            state, table
        )
        base = table.totals.astype(np.int64) - table.reserved
        if block_usage is not None:
            base = base - block_usage
        return base, net_rows, blocks, state.nodes_with_object_allocs()

    def _admit_block_updates(self, pending, table, state):
        """Whole-block delta-headroom admission over the node table: one
        vectorized check per block. Returns the block-columnar update
        batches, or None if ANY node lacks headroom (or object/plan/network
        interference makes columnar accounting unsound) — partial
        admission needs the per-alloc machinery."""
        from nomad_tpu_torch.structs import AllocUpdateBatch

        base, net_rows, _blocks, obj_nodes = self._headroom_base(state, table)
        plan = self.ctx.plan
        batches = []
        for tg, blk in pending:
            size = task_group_constraints(tg).size
            new_vec = np.asarray(size.as_vector(), dtype=np.int64)
            old_vec = (
                np.asarray(blk.resources.as_vector(), dtype=np.int64)
                if blk.resources is not None
                else np.zeros(4, dtype=np.int64)
            )
            live_nids, live_counts = blk.live_runs()
            live_ids = [blk.alloc_id(i) for i in blk.live_positions()]
            delta = new_vec - old_vec
            if np.any(delta > 0):
                rows = np.fromiter(
                    (table.rows[nid] for nid in live_nids),
                    dtype=np.int64, count=len(live_nids),
                )
                if net_rows is not None and bool(net_rows[rows].any()):
                    return None
                if any(nid in obj_nodes or plan.node_update.get(nid)
                       or plan.node_allocation.get(nid)
                       for nid in live_nids):
                    return None
                counts = np.asarray(live_counts, dtype=np.int64)
                need = delta[None, :] * counts[:, None]
                h = base[rows]
                ok = np.all((h - need >= 0) | (delta[None, :] <= 0), axis=1)
                if not bool(ok.all()):
                    return None
                base[rows] -= np.maximum(need, 0)
            batches.append(AllocUpdateBatch(
                eval_id=self.eval.id,
                job=self.job,
                tg_name=tg.name,
                resources=size,
                task_resources={t.name: t.resources for t in tg.tasks},
                metrics=self.ctx.metrics(),
                alloc_ids=live_ids,
                src_node_ids=live_nids,
                src_node_counts=live_counts,
                src_resources=blk.resources,
            ))
        return batches

    def _fast_reconcile(self, existing):
        """Classify every existing alloc of this job as 'ignore' or
        'in-place update' under the five-way diff (util.go:54-131).
        Returns ({tg_name: occupied index set}, {tg_key: (tg, [allocs to
        update])}); or None when anything needs stops, migrations, or the
        destructive path — the caller then takes the full object diff.
        Per-alloc work is dict hits: job-version and task-group checks are
        cached by identity (allocs share their job/resources objects)."""
        from nomad_tpu_torch.scheduler.util import tasks_updated

        job = self.job
        tainted = tainted_nodes(self.state, existing)
        if any(tainted.values()):
            return None
        tg_by_name = {tg.name: tg for tg in job.task_groups}

        # One cheap pass: bucket allocs per task-group name.
        by_tg_name: Dict[str, list] = {}
        for a in existing:
            group = by_tg_name.get(a.task_group)
            if group is None:
                by_tg_name[a.task_group] = group = []
            group.append(a)

        occupied: Dict[str, set] = {}
        updates_by_tg: Dict[int, Tuple[TaskGroup, list]] = {}
        # identity-cached verdicts for (old job, tg name) pairs
        updatable_cache: Dict[Tuple[int, str], bool] = {}
        job_mi = job.modify_index
        for tg_name, allocs in by_tg_name.items():
            tg = tg_by_name.get(tg_name)
            if tg is None:
                return None  # group removed: stops needed
            if len(allocs) > tg.count:
                return None  # scale-down: stops needed
            # Indices must be parsed even for a full-looking group: a
            # terminal low index plus a live out-of-range one gives
            # len == count while still needing a stop + a placement.
            occ = set()
            for a in allocs:
                try:
                    idx = int(a.name.rsplit("[", 1)[1].rstrip("]"))
                except (IndexError, ValueError):
                    return None
                if idx >= tg.count:
                    return None  # scale-down: stops needed
                occ.add(idx)
            occupied[tg_name] = occ
            for a in allocs:
                if a.job.modify_index == job_mi:
                    continue  # ignore
                # In-place candidate: eligibility cached per old-job/tg
                key = (id(a.job), tg_name)
                ok = updatable_cache.get(key)
                if ok is None:
                    old_tg = a.job.lookup_task_group(tg_name)
                    # Constraint surfaces must be unchanged too: the batch
                    # path skips the per-alloc constraint-masked select the
                    # reference runs (util.go:346-358), which is only sound
                    # when feasibility criteria didn't move.
                    ok = (old_tg is not None
                          and not tasks_updated(tg, old_tg)
                          and self._constraints_unchanged(a.job, old_tg, tg)
                          and not any(
                              t.resources is not None and t.resources.networks
                              for t in tg.tasks))
                    updatable_cache[key] = ok
                if not ok or any(
                    tr is not None and tr.networks
                    for tr in (a.task_resources or {}).values()
                ):
                    return None  # destructive / network reoffer path
                updates_by_tg.setdefault(id(tg), (tg, []))[1].append(a)
        return occupied, updates_by_tg

    def _place_batch(self, tg: TaskGroup, name_indices: "np.ndarray") -> None:
        """Place ``len(name_indices)`` copies of a task group as one
        AllocBatch: a single counts-solve dispatch, ids carried as a
        16-byte seed (expanded only if read), zero per-placement Python
        objects."""
        from nomad_tpu_torch.structs import AllocBatch

        self.ctx.reset()
        count = len(name_indices)
        _nodes, mirror = GLOBAL_MIRROR_CACHE.get(
            self.state, self.job.datacenters, self.device)
        self.stack.set_mirror(mirror)

        counts, unplaced, size = self.stack.solve_group_counts(tg, count)
        metrics = self.ctx.metrics()

        placed = count - unplaced if counts is not None else 0
        if placed > 0:
            nz = np.flatnonzero(counts[: mirror.n])
            ids_arr = mirror.id_array()
            batch = AllocBatch(
                eval_id=self.eval.id,
                job=self.job,
                tg_name=tg.name,
                resources=size,
                task_resources={t.name: t.resources for t in tg.tasks},
                metrics=metrics,
                node_ids=ids_arr[nz].tolist(),
                node_counts=counts[nz].tolist(),
                name_idx=np.asarray(name_indices[:placed]),
                ids_seed=_new_ids_seed(),
            )
            # Mirror-row hint: the verifier resolves these runs by gather
            # through a cached (node table, mirror) row map.
            batch.src_ids_ref = ids_arr
            batch.src_rows = nz
            self.plan.append_batch(batch)

        if unplaced > 0 or counts is None:
            n_failed = count - placed
            failed = object.__new__(Allocation)
            failed.__dict__ = {
                "id": generate_uuid(), "eval_id": self.eval.id,
                "name": f"{self.job.name}.{tg.name}[{int(name_indices[placed]) if placed < count else 0}]",
                "node_id": "", "job_id": self.job.id, "job": self.job,
                "task_group": tg.name, "resources": size,
                "task_resources": {}, "metrics": metrics,
                "desired_status": ALLOC_DESIRED_STATUS_FAILED,
                "desired_description": "failed to find a node for placement",
                "client_status": ALLOC_CLIENT_STATUS_FAILED,
                "client_description": "", "create_index": 0,
                "modify_index": 0,
            }
            failed.metrics.coalesced_failures += n_failed - 1
            self.plan.append_failed(failed)

    def compute_placements(self, place: List[AllocTuple]) -> None:
        """Batched replacement of generic_sched.go:245-298: one solve per
        task group instead of one Select per missing alloc. Host-side object
        assembly is lean: uuid batches overlap the device round-trip and
        Allocations are stamped from a shared field template."""
        _nodes, mirror = GLOBAL_MIRROR_CACHE.get(
            self.state, self.job.datacenters, self.device)
        self.stack.set_mirror(mirror)

        # Group the missing allocs by task group. Diff output arrives in
        # materialization order (all copies of one group contiguous), so
        # run-slicing avoids 100k dict operations; out-of-order stragglers
        # from rolling updates just start a new run for the same group.
        groups: List[Tuple[TaskGroup, List[AllocTuple]]] = []
        run_tg = None
        run_start = 0
        for i, missing in enumerate(place):
            if missing.task_group is not run_tg:
                if run_tg is not None:
                    groups.append((run_tg, place[run_start:i]))
                run_tg = missing.task_group
                run_start = i
        if run_tg is not None:
            groups.append((run_tg, place[run_start:]))

        for tg, missing_list in groups:
            self.ctx.reset()
            count = len(missing_list)
            # Generate ids on a worker thread: it runs while this thread
            # blocks (GIL released) in the device readback inside solve_group.
            uuid_future = _uuid_pool().submit(generate_uuids, count)

            idxs, oks, size = self.stack.solve_group(tg, count)
            uuids = uuid_future.result()

            has_networks = any(
                t.resources is not None and t.resources.networks for t in tg.tasks
            )
            if idxs is None:
                placements: List[Optional[_Placement]] = [None] * count
            elif has_networks:
                # Sparse + sequential port assignment: host post-pass.
                placements = self.stack._offer_networks(tg, idxs, oks)
            else:
                placements = None  # lean path below

            metrics = self.ctx.metrics()
            template = {
                "id": "", "eval_id": self.eval.id, "name": "", "node_id": "",
                "job_id": self.job.id, "job": self.job, "task_group": tg.name,
                "resources": size, "task_resources": {}, "metrics": metrics,
                "desired_status": ALLOC_DESIRED_STATUS_RUN,
                "desired_description": "",
                "client_status": ALLOC_CLIENT_STATUS_PENDING,
                "client_description": "", "create_index": 0, "modify_index": 0,
            }
            failed_alloc: Optional[Allocation] = None

            if placements is None:
                # Lean path (no network asks): stamp Allocations straight
                # from the solve indices. The fused solve returns indices
                # grouped by node, so per-node plan lists build in runs.
                # task_resources aliases the job spec like the reference's
                # Select fallback (stack.go:150-154); treat as immutable.
                shared_tr = {t.name: t.resources for t in tg.tasks}
                template["task_resources"] = shared_tr
                nodes_list = self.stack.mirror.nodes
                n = self.stack.mirror.n
                node_alloc = self.plan.node_allocation
                run_node_id = None
                run_list = None
                new = object.__new__
                copy_t = template.copy
                for missing, idx, ok, uid in zip(
                    missing_list, idxs.tolist(), oks.tolist(), uuids
                ):
                    if ok and 0 <= idx < n:
                        node_id = nodes_list[idx].id
                        alloc = new(Allocation)
                        d = copy_t()
                        d["id"] = uid
                        d["name"] = missing.name
                        d["node_id"] = node_id
                        alloc.__dict__ = d
                        if node_id != run_node_id:
                            run_list = node_alloc.setdefault(node_id, [])
                            run_node_id = node_id
                        run_list.append(alloc)
                    elif failed_alloc is not None:
                        failed_alloc.metrics.coalesced_failures += 1
                    else:
                        alloc = new(Allocation)
                        d = copy_t()
                        d["id"] = uid
                        d["name"] = missing.name
                        d["task_resources"] = {}
                        d["desired_status"] = ALLOC_DESIRED_STATUS_FAILED
                        d["desired_description"] = (
                            "failed to find a node for placement"
                        )
                        d["client_status"] = ALLOC_CLIENT_STATUS_FAILED
                        alloc.__dict__ = d
                        self.plan.append_failed(alloc)
                        failed_alloc = alloc
                continue

            for i, (missing, placement) in enumerate(zip(missing_list, placements)):
                if placement is None and failed_alloc is not None:
                    failed_alloc.metrics.coalesced_failures += 1
                    continue

                alloc = object.__new__(Allocation)
                d = dict(template)
                d["id"] = uuids[i]
                d["name"] = missing.name
                alloc.__dict__ = d
                if placement is not None:
                    alloc.node_id = placement[0].id
                    alloc.task_resources = placement[1]
                    self.plan.append_alloc(alloc)
                else:
                    alloc.task_resources = {}
                    alloc.desired_status = ALLOC_DESIRED_STATUS_FAILED
                    alloc.desired_description = "failed to find a node for placement"
                    alloc.client_status = ALLOC_CLIENT_STATUS_FAILED
                    self.plan.append_failed(alloc)
                    failed_alloc = alloc


class TPUSystemScheduler(SystemScheduler):
    """SystemScheduler with a vectorized per-node fit: all pinned placements
    of a task group are checked in one dispatch (factory: tpu-system).
    ``device`` defaults to the CUDA card."""

    # One-per-node placements at or above this count flow columnar
    # (AllocBatch with unit runs) instead of per-Allocation objects.
    BATCH_PLACE_THRESHOLD = 64

    def __init__(self, state, planner, logger: logging.Logger, device=None):
        super().__init__(state, planner, logger)
        self.device = resolve_device(device)

    def make_stack(self, ctx: EvalContext) -> TPUStack:
        return TPUStack(ctx, system=True, device=self.device)

    def _place_system_batch(self, tg, tg_constr, missing_list, mirror,
                            fit_np, metrics, elig_np=None) -> bool:
        """Columnar system placement: one AllocBatch of unit runs over the
        fitting pinned nodes. Applies only to large network-free groups
        with each node appearing once (the normal system diff shape —
        repeats and network offers take the per-alloc path). Returns True
        when the group was handled."""
        if len(missing_list) < self.BATCH_PLACE_THRESHOLD:
            return False
        if tg_constr.size.networks or any(
            t.resources is not None and t.resources.networks
            for t in tg.tasks
        ):
            return False

        # Pass 1 — pure validation, NO side effects: a bail-out here falls
        # back to the sequential path, which must not see half-recorded
        # metrics. System names repeat one string per task group
        # ("job.tg[0]" on every node), so the bracket parse is memoized.
        parsed = []
        seen = set()
        name_memo: Dict[str, Optional[int]] = {}
        for missing in missing_list:
            nid = missing.alloc.node_id
            if nid in seen:
                return False  # repeated node: sequential accounting path
            seen.add(nid)
            name = missing.name
            idx_val = name_memo.get(name, -2)
            if idx_val == -2:
                lb = name.rfind("[")
                if lb < 0 or not name.endswith("]"):
                    idx_val = None
                else:
                    try:
                        idx_val = int(name[lb + 1:-1])
                    except ValueError:
                        idx_val = None
                name_memo[name] = idx_val
            if idx_val is None:
                return False
            parsed.append((nid, idx_val))

        # Pass 2 — fit decisions and metrics. The common case (every
        # pinned node fits) is one vectorized gather; the python loop only
        # runs to attribute metrics to the failing nodes.
        index = mirror.index
        rows = [index.get(nid) for nid, _ in parsed]
        if any(r is None for r in rows):
            # Same invariant the sequential path enforces: a pinned
            # placement must name a known eligible node.
            bad = parsed[rows.index(None)][0]
            raise SchedulerError(f"could not find node {bad!r}")
        fits = fit_np[np.asarray(rows, dtype=np.int64)]
        failed = 0
        first_failed_idx = 0
        if bool(fits.all()):
            node_ids = [nid for nid, _ in parsed]
            name_idx = [idx for _, idx in parsed]
        else:
            node_ids = []
            name_idx = []
            for (nid, idx_val), row, ok in zip(parsed, rows, fits):
                if ok:
                    node_ids.append(nid)
                    name_idx.append(idx_val)
                else:
                    if failed == 0:
                        first_failed_idx = idx_val
                    failed += 1
                    # Constraint-filtered vs resource-exhausted, per the
                    # reference's FilterNode/exhausted split.
                    if elig_np is not None and not elig_np[row]:
                        metrics.filter_node(mirror.nodes[row],
                                            "constraint-mask")
                    else:
                        metrics.exhausted_node(mirror.nodes[row],
                                               "resources")

        self._emit_system_batch(tg, tg_constr, metrics, node_ids, name_idx,
                                failed, first_failed_idx)
        return True

    def _emit_system_batch(self, tg, tg_constr, metrics, node_ids, name_idx,
                           failed: int, first_failed_idx: int,
                           src_hint=None) -> None:
        """Append the columnar placement batch (+ one coalesced failed
        alloc) for a system task group."""
        placed = len(node_ids)
        if placed:
            batch = AllocBatch(
                eval_id=self.eval.id,
                job=self.job,
                tg_name=tg.name,
                resources=tg_constr.size,
                task_resources={t.name: t.resources for t in tg.tasks},
                metrics=metrics,
                node_ids=node_ids,
                node_counts=[1] * placed,
                name_idx=np.asarray(name_idx, dtype=np.int64),
                ids_seed=_new_ids_seed(),
            )
            if src_hint is not None:
                batch.src_ids_ref, batch.src_rows = src_hint
            self.plan.append_batch(batch)
        if failed:
            failed_alloc = Allocation(
                id=generate_uuid(),
                eval_id=self.eval.id,
                name=f"{self.job.name}.{tg.name}[{first_failed_idx}]",
                job_id=self.job.id,
                job=self.job,
                task_group=tg.name,
                resources=tg_constr.size,
                metrics=metrics,
                desired_status=ALLOC_DESIRED_STATUS_FAILED,
                desired_description="failed to find a node for placement",
                client_status=ALLOC_CLIENT_STATUS_FAILED,
            )
            failed_alloc.metrics.coalesced_failures += failed - 1
            self.plan.append_failed(failed_alloc)

    def _system_fit(self, tg, tg_constr, mirror):
        """One dispatch: fit for every node at once. Returns (prep,
        fit_np) or None when no node is eligible (stack.prepare bail).
        With a solve mesh, one fit a node shard, concatenated in row
        order (nomad_tpu shards its one _greedy_step_state)."""
        prep = self.stack.prepare(tg, tg_constr)
        if prep is None:
            return None
        _check_device_fault(tg.name)
        t_dispatch = time.perf_counter()
        args10 = (mirror.total, mirror.sched_cap, prep.used, prep.job_count,
                  prep.tg_count, mirror.bw_avail, prep.bw_used, prep.mask,
                  prep.ask, prep.bw_ask)
        with device_activity():
            mesh = mesh_lib.mesh_for_nodes(mirror.padded, mirror.device)
            if mesh is not None:
                placed = mesh_lib.shard_waterfill_args(mesh, args10)
                fits = []
                for i, dev in enumerate(mesh.node_devices):
                    _score, fit = _greedy_step_state(
                        *(x.shards[i] for x in placed[:8]),
                        placed[8].on(dev), placed[9].on(dev), 0.0,
                        prep.job_distinct, prep.tg_distinct,
                    )
                    fits.append(fit.cpu())
                fit_np = torch.cat(fits).numpy()
            else:
                _score, fit = _greedy_step_state(
                    *(mesh_lib.whole(x) for x in args10), 0.0,
                    prep.job_distinct, prep.tg_distinct,
                )
                fit_np = fit.cpu().numpy()
        # System jobs ask one copy per node; the fit mask IS the
        # placement decision, so fits = placements for the panel.
        SOLVER_PANEL.record_solve(
            "system_fit", mirror.n, mirror.padded, mirror.n, 0,
            int(np.count_nonzero(fit_np[: mirror.n])),
            (time.perf_counter() - t_dispatch) * 1000.0,
        )
        return prep, fit_np

    def compute_job_allocs(self) -> None:
        if self._fresh_columnar_allocs():
            return
        super().compute_job_allocs()

    def _fresh_columnar_allocs(self) -> bool:
        """Fully columnar fresh registration: a system job with no existing
        allocations places one AllocBatch of unit runs per task group
        straight from the mirror's fit mask — the per-node diff and its
        10k AllocTuple/Allocation objects never exist. Falls back (False)
        for small clusters, repeat counts, network asks, or any existing
        allocs — those take the reference-shaped diff path."""
        job = self.job
        if job is None or len(self.nodes) < self.BATCH_PLACE_THRESHOLD:
            return False
        # Existence check only — materializing the alloc table here would
        # double the cost the fallback path pays again (a job with only
        # terminal allocs conservatively takes the diff path).
        if self.state.has_allocs_for_job(self.eval.job_id):
            return False
        for tg in job.task_groups:
            if tg.count > 1:
                return False
            if task_group_constraints(tg).size.networks or any(
                t.resources is not None and t.resources.networks
                for t in tg.tasks
            ):
                return False
        self.limit_reached = False
        _nodes, mirror = GLOBAL_MIRROR_CACHE.get(
            self.state, job.datacenters, self.device)
        self.stack.set_mirror(mirror)
        n = len(mirror.nodes)
        for tg in job.task_groups:
            self.ctx.reset()
            tg_constr = task_group_constraints(tg)
            metrics = self.ctx.metrics()
            res = self._system_fit(tg, tg_constr, mirror)
            if res is None:
                continue  # same posture as compute_placements' prep bail
            prep, fit_np = res
            fits = fit_np[:n]
            placed_rows = np.nonzero(fits)[0]
            nodes = mirror.nodes
            ids_arr = mirror.id_array()
            node_ids = ids_arr[placed_rows].tolist()
            failed_rows = np.nonzero(~fits)[0]
            # Attribute like the reference's FilterNode/exhausted split
            # (feasible.go vs rank.go): a node the eligibility mask
            # rejected was constraint-filtered, not resource-exhausted.
            elig_np = prep.mask.cpu().numpy()[:n]
            for i in failed_rows:
                if elig_np[i]:
                    metrics.exhausted_node(nodes[i], "resources")
                else:
                    metrics.filter_node(nodes[i], "constraint-mask")
            self._emit_system_batch(
                tg, tg_constr, metrics, node_ids,
                np.zeros(len(node_ids), dtype=np.int64),
                len(failed_rows), 0,
                src_hint=(ids_arr, placed_rows),
            )
        return True

    def compute_placements(self, place: List[AllocTuple]) -> None:
        node_by_id = {node.id: node for node in self.nodes}
        # self.nodes IS ready_nodes_in_dcs(state, dcs) (system.py) — the
        # exact set the mirror cache keys on, so repeat system evals of one
        # state generation share a resident mirror like the generic path.
        _nodes, mirror = GLOBAL_MIRROR_CACHE.get(
            self.state, self.job.datacenters, self.device
        )
        self.stack.set_mirror(mirror)

        groups: Dict[int, Tuple[TaskGroup, List[AllocTuple]]] = {}
        for missing in place:
            key = id(missing.task_group)
            groups.setdefault(key, (missing.task_group, []))[1].append(missing)

        for tg, missing_list in groups.values():
            self.ctx.reset()
            tg_constr = task_group_constraints(tg)
            metrics = self.ctx.metrics()
            res = self._system_fit(tg, tg_constr, mirror)
            if res is None:
                continue
            prep, fit_np = res

            if self._place_system_batch(tg, tg_constr, missing_list,
                                        mirror, fit_np, metrics,
                                        elig_np=prep.mask.cpu().numpy()):
                continue

            # Host-side in-group accounting: if a node receives more than one
            # placement in this group, deduct earlier asks before re-checking
            # (job validation enforces count==1 for system jobs, but the diff
            # can still repeat nodes; never overcommit).
            totals_np = mirror.total.cpu().numpy()
            used_np = prep.used.cpu().numpy()
            bw_avail_np = mirror.bw_avail.cpu().numpy()
            bw_used_np = prep.bw_used.cpu().numpy()
            placed_on: Dict[int, int] = {}

            failed_alloc: Optional[Allocation] = None
            for missing in missing_list:
                node = node_by_id.get(missing.alloc.node_id)
                if node is None:
                    raise SchedulerError(
                        f"could not find node {missing.alloc.node_id!r}"
                    )
                idx = mirror.index[node.id]
                ok = bool(fit_np[idx])
                if ok and placed_on.get(idx, 0) > 0:
                    extra = placed_on[idx]
                    ok = bool(
                        np.all(
                            used_np[idx] + (extra + 1) * prep.ask_np
                            <= totals_np[idx]
                        )
                        and bw_used_np[idx] + (extra + 1) * prep.bw_ask_val
                        <= bw_avail_np[idx]
                    )
                placement = None
                if ok:
                    placement = self.stack._offer_networks(tg, [idx], [True])[0]
                if placement is not None:
                    placed_on[idx] = placed_on.get(idx, 0) + 1

                if placement is None and failed_alloc is not None:
                    failed_alloc.metrics.coalesced_failures += 1
                    continue

                alloc = Allocation(
                    id=generate_uuid(),
                    eval_id=self.eval.id,
                    name=missing.name,
                    job_id=self.job.id,
                    job=self.job,
                    task_group=tg.name,
                    resources=tg_constr.size,
                    metrics=metrics,
                )
                if placement is not None:
                    alloc.node_id = placement[0].id
                    alloc.task_resources = placement[1]
                    alloc.desired_status = ALLOC_DESIRED_STATUS_RUN
                    alloc.client_status = ALLOC_CLIENT_STATUS_PENDING
                    self.plan.append_alloc(alloc)
                else:
                    metrics.exhausted_node(node, "resources")
                    alloc.desired_status = ALLOC_DESIRED_STATUS_FAILED
                    alloc.desired_description = "failed to find a node for placement"
                    alloc.client_status = ALLOC_CLIENT_STATUS_FAILED
                    self.plan.append_failed(alloc)
                    failed_alloc = alloc


def new_tpu_scheduler(variant: str, state, planner, logger: logging.Logger,
                      device=None):
    """``device`` defaults to the CUDA card; asking for CUDA without one
    raises (there is no host fallback)."""
    if variant == "service":
        return TPUGenericScheduler(state, planner, logger, batch=False,
                                   device=device)
    if variant == "batch":
        return TPUGenericScheduler(state, planner, logger, batch=True,
                                   device=device)
    if variant == "system":
        return TPUSystemScheduler(state, planner, logger, device=device)
    raise ValueError(f"unknown device scheduler variant {variant!r}")


def warm_shapes(snapshot, counts=(8, 16, 32, 64, 128, 129), logger=None,
                stop=None, device=None) -> int:
    """Warm the solve path for the current cluster's node buckets (the
    server's start-time hook; see ServerConfig.prewarm_shapes). Port of
    nomad_tpu's ``warm_shapes``.

    There is no compile per shape here, but a fresh process's first eval
    still builds the node mirror and the eligibility masks, allocates the
    stacked dispatch buffers, and loads (or builds, at first use) both
    hand kernels — work that lands inside the coalescer's burst hold and
    splits a burst. This drives the REAL path (MirrorCache.get ->
    TPUStack.set_mirror/set_job -> solve_group for counts <= 128,
    solve_group_counts above) against the live snapshot with an
    unsatisfiable batch job, so both kernels launch and the mirror the
    first eval uses is resident. Returns the number of solve dispatches
    issued.
    """
    from nomad_tpu_torch.ops.coalesce import device_activity

    log = logger or logging.getLogger("nomad_tpu_torch.tpu.warm")
    nodes = [
        n for n in snapshot.nodes()
        if n.status == NODE_STATUS_READY and not n.drain
    ]
    if not nodes:
        return 0
    device = resolve_device(device)
    with device_activity(), SOLVER_PANEL.precompile():
        return _warm_shapes_inner(snapshot, counts, log, stop, nodes, device)


def _warm_shapes_inner(snapshot, counts, log, stop, nodes, device) -> int:
    from nomad_tpu_torch.ops.coalesce import (
        warm_batch_shapes,
        warm_exact_batch_shapes,
    )

    all_dcs = sorted({n.datacenter for n in nodes})
    # One warm per distinct node bucket: the union of datacenters plus
    # each single datacenter (the common job targeting shapes).
    dc_sets = [all_dcs] + [[dc] for dc in all_dcs]
    seen = set()
    dispatches = 0
    t0 = time.perf_counter()
    for dcs in dc_sets:
        _nodes, mirror = GLOBAL_MIRROR_CACHE.get(snapshot, list(dcs), device)
        if mirror.n == 0 or mirror.padded in seen:
            continue
        seen.add(mirror.padded)
        tg = TaskGroup(
            name="_warm", count=1,
            tasks=[Task(name="_warm", driver="_warm",
                        resources=Resources(cpu=1, memory_mb=1))],
        )
        job = Job(
            region="global", id=f"_warm-{mirror.padded}", name="_warm",
            type=JOB_TYPE_BATCH, priority=1,
            datacenters=list(dcs), task_groups=[tg],
        )
        ctx = EvalContext(snapshot, Plan(eval_id="_warm"), log)
        stack = TPUStack(ctx, batch=True, device=device)
        stack.set_mirror(mirror)
        stack.set_job(job)
        for count in counts:
            if stop is not None and stop():
                # Server shutting down: start no more device work.
                return dispatches
            if count <= EXACT_THRESHOLD:
                stack.solve_group(tg, count)
            else:
                stack.solve_group_counts(tg, count)
            dispatches += 1
        # Coalesced multi-eval dispatches stack the eval axis to the
        # widths {2, 4, 8}: warm those too, through the coalescer's own
        # stacking code, so a burst's first drain allocates nothing new.
        dispatches += warm_batch_shapes(mirror.padded, stop=stop,
                                        device=device)
        dispatches += warm_exact_batch_shapes(
            mirror.padded,
            counts=[c for c in counts if c <= EXACT_THRESHOLD],
            stop=stop, device=device,
        )
    log.info(
        "warmed %d solve dispatch(es) across %d node bucket(s) in %.1fs",
        dispatches, len(seen), time.perf_counter() - t0,
    )
    return dispatches
