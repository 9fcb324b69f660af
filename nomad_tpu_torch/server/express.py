"""Sparrow express lane: leader-local sub-millisecond placement.

Port of nomad_tpu/server/express.py. The in-line pick is host numpy over
the mirror's host-side capacity view (``NodeMirror.capacity_view``:
``totals_np`` beside the delta-rolled base usage) and the mirror's host
masks, as in nomad_tpu, by design: it is a sub-millisecond path, and one
device round trip per submission would cost more than the pick itself.
The view's mirror is the solver's own (``MirrorCache.get`` on the
server's device), built off the submit path on the committer's cadence.

The full eval→broker→worker→plan-pipeline→raft path costs milliseconds
at steady-10k — the wrong cost model for millisecond-scale tasks. Sparrow
(PAPERS.md) buys three orders of magnitude for short tasks by trading
global optimality for latency; Omega's shared-state posture supplies the
reconciliation story for running a second, faster placement path against
the same cell. This module is that second path:

- **Eligibility.** A job opts in via the job model (``Job.express``,
  batch type, small task count, no network asks, no distinct-hosts
  semantics, not an update of a live job). The admission front door
  classifies express submissions into their own rate lane
  (``admission.LANE_EXPRESS``) — and the SLO-coupled shedder treats the
  lane as batch-yielding: a shed batch door sheds express too (express
  is a latency lane, not a rate-limit bypass).

- **Synchronous placement.** An eligible submission places IN-LINE on the
  leader: seeded power-of-``choices`` sampling (the ``express.pick``
  stream — Sparrow's batch sampling) over the delta-rolled
  ``MirrorCache`` mirror's capacity view (totals, delta-maintained base
  usage), debited by the reservation ledger below. The caller gets
  "placed" back in well under a millisecond; no broker, no worker pool,
  no plan queue on the submit path.

- **Leased capacity reservations.** Each placement takes a bounded,
  TTL-leased reservation (:class:`ReservationLedger`) on the chosen
  nodes' capacity, debited from the same capacity view the slow path
  reads at plan-verify time (plan_apply/plan_pipeline fold the ledger's
  per-node debits into verification), so a slow-path plan cannot take
  capacity an express placement was promised while its raft entry is
  still in flight. Lease TTLs carry seeded jitter (the
  ``express.lease_jitter`` stream) so synchronized expiry can't stampede.

- **Asynchronous commit.** A committer thread replicates each placement
  through the ordinary machinery — job + completed eval through raft,
  then the allocations as an ``all_at_once`` plan through the optimistic
  plan pipeline (tagged ``Plan.express_lease`` so the pipeline skips
  broker bookkeeping and exempts the plan's OWN lease from the debits it
  verifies under). A verify-time failure — capacity taken after the
  lease was lost, a node died — is a typed, counted ``EXPRESS_BOUNCE``
  riding the pipeline's transaction-time conflict attribution
  (``PlanResult.conflict``): the committer re-places the SAME
  allocations (ids stable — exactly-once is per task) under a fresh
  lease and resubmits; past ``max_bounces`` (or on leadership loss) it
  reconciles through the slow path — a fresh PENDING evaluation that the
  ordinary scheduler places, forwarded to the current leader
  (``Express.Reconcile``). All-at-once plans make a bounce atomic:
  either every member commits in one entry or none do, so a task can
  never be half-placed across attempts.

Failure posture: the ledger is leader-local and volatile by design. On
leadership loss the lane demotes (leases cleared, counted as lost) and
every still-uncommitted entry reconciles to the new leader, whose own
ledger starts empty — correct, because its state view contains no
uncommitted express capacity; the reconciliation evals re-enter through
``restore_eval_broker``'s ordinary pending-eval requeue. The safety
invariant (fuzz-pinned in nomad_tpu's tests/test_express.py and, on
the port, tests/test_torch_express.py) is: express placements
NEVER violate capacity the slow path believes in — an express allocation
only becomes durable through verified plan commit — and every express
task places exactly once across bounces, lease expiry and failover.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from nomad_tpu_torch import prng, structs, telemetry, trace
from nomad_tpu_torch.structs import (
    Allocation,
    AllocMetric,
    Evaluation,
    Job,
    Plan,
    Resources,
    generate_uuid,
    generate_uuids,
)
from nomad_tpu_torch.raft import NotLeaderError
from nomad_tpu_torch.tpu.mirror import GLOBAL_MIRROR_CACHE

# Evaluation.triggered_by for express placements (sync path) and for the
# slow-path reconciliation evals a bounced-out/failed-over entry falls
# back to (canonical definitions in structs.py — the generic scheduler's
# trigger allowlist reads the same constant).
EVAL_TRIGGER_EXPRESS = structs.EVAL_TRIGGER_EXPRESS
EVAL_TRIGGER_EXPRESS_RECONCILE = structs.EVAL_TRIGGER_EXPRESS_RECONCILE

# Typed committer outcomes (counters + the bounded decision ring; NOT
# event types — bounce counts depend on commit/solve interleaving, and
# events would make the canonical digest timing-dependent).
EXPRESS_COMMITTED = "EXPRESS_COMMITTED"
EXPRESS_BOUNCE = "EXPRESS_BOUNCE"
EXPRESS_RECONCILED = "EXPRESS_RECONCILED"
EXPRESS_LEASE_EXPIRED = "EXPRESS_LEASE_EXPIRED"

# Bounded committer-outcome ring depth (the admission decision-ring
# posture: enough to see a bounce storm's shape, never its own queue).
OUTCOME_RING = 256


@dataclass
class ExpressConfig:
    """Express-lane tunables. Default-OFF: with ``enabled=False`` the
    lane constructs but never places, draws nothing, and publishes
    nothing — the decision-invariance the banked steady-10k digests pin."""

    enabled: bool = False
    # Reservation lease TTL (seconds) and the jitter fraction added on
    # top (ttl * U[0, jitter) via the express.lease_jitter stream).
    lease_ttl: float = 2.0
    lease_jitter: float = 0.5
    # Bound on outstanding leases (≈ uncommitted express submissions).
    # At the cap new submissions fall back to the slow path, typed.
    max_leases: int = 4096
    # Sampling: up to ``probes`` seeded row draws per member, placing on
    # the best of the first ``choices`` that fit (Sparrow's power of two
    # choices; more probes = better packing, more latency).
    probes: int = 16
    choices: int = 2
    # Eligibility ceiling: larger jobs take the solver path, where the
    # device bin-pack earns its latency.
    max_tasks: int = 16
    # Bound on the committer backlog; at the cap submissions fall back
    # to the slow path (the front door already rate-bounds offered load;
    # this bounds the lane's own queue).
    max_pending: int = 512
    # Verify-time bounces before an entry reconciles via the slow path.
    max_bounces: int = 32

    @classmethod
    def parse(cls, spec: Optional[Dict[str, Any]]) -> "ExpressConfig":
        """Validated construction from the ``server { express { ... } }``
        config block — typos and nonsense ranges fail at parse time, the
        AdmissionConfig posture."""
        if spec is None:
            return cls()
        if not isinstance(spec, dict):
            raise ValueError("express config must be a mapping")
        known = set(cls.__dataclass_fields__)
        unknown = [k for k in spec if k not in known]
        if unknown:
            raise ValueError(
                f"unknown express config key(s): {sorted(unknown)} "
                f"(have: {sorted(known)})"
            )
        out = cls(**{
            k: (bool(v) if k == "enabled"
                else int(v) if k in ("max_leases", "probes", "choices",
                                     "max_tasks", "max_pending",
                                     "max_bounces")
                else float(v))
            for k, v in spec.items()
        })
        if out.lease_ttl <= 0:
            raise ValueError("express.lease_ttl must be > 0")
        if not 0 <= out.lease_jitter <= 4:
            raise ValueError("express.lease_jitter must be in [0, 4]")
        for knob, lo, hi in (("max_leases", 1, 1_000_000),
                             ("probes", 1, 4096),
                             ("choices", 1, 64),
                             ("max_tasks", 1, 4096),
                             ("max_pending", 1, 1_000_000),
                             ("max_bounces", 0, 10_000)):
            v = getattr(out, knob)
            if not lo <= v <= hi:
                raise ValueError(
                    f"express.{knob} must be in [{lo}, {hi}], got {v}"
                )
        if out.choices > out.probes:
            raise ValueError("express.choices must be <= express.probes")
        return out


class _IdPool:
    """Amortized uuid source: ONE urandom read (structs.generate_uuids)
    serves many ids. An os.urandom syscall can cost a sizeable share of
    the sub-millisecond budget on some kernels, and a submission needs
    several ids — drawn
    one-by-one they would eat most of the sub-millisecond budget."""

    __slots__ = ("_ids", "_lock")

    BATCH = 256  # ids per refill

    def __init__(self):
        self._ids: List[str] = []
        self._lock = threading.Lock()

    def take(self) -> str:
        with self._lock:
            if not self._ids:
                self._ids = generate_uuids(self.BATCH)
            return self._ids.pop()


class Lease:
    """One submission's leased capacity: per-node int64[4] debits plus a
    monotonic-clock expiry."""

    __slots__ = ("id", "eval_id", "debits", "expires", "granted_ttl")

    def __init__(self, eval_id: str, debits: Dict[str, np.ndarray],
                 expires: float, granted_ttl: float,
                 lease_id: str = ""):
        self.id = lease_id or generate_uuid()
        self.eval_id = eval_id
        self.debits = debits
        self.expires = expires
        self.granted_ttl = granted_ttl


class ReservationLedger:
    """Bounded ledger of TTL-leased capacity reservations.

    The slow path reads it at plan-verify time (``debit_map``); the
    express pick path reads it per candidate node (``node_debit``). All
    mutation is under one leaf lock — no other lock is ever taken while
    it is held (the lock-order gate pins this)."""

    def __init__(self, max_leases: int = 4096):
        self.max_leases = int(max_leases)
        self._lock = threading.Lock()
        self._leases: Dict[str, Lease] = {}
        # node id -> summed active debit (int64[4]); entries removed when
        # they fall to zero so debit_map stays O(touched nodes).
        self._by_node: Dict[str, np.ndarray] = {}
        self.granted = 0
        self.released = 0
        self.expired = 0
        self.rejected_full = 0
        self.peak_active = 0

    def reserve(self, eval_id: str, debits: Dict[str, np.ndarray],
                ttl: float, now: Optional[float] = None,
                lease_id: str = "") -> Optional[Lease]:
        """Grant one lease (None at the cap). ``debits`` maps node id to
        the summed int64[4] ask reserved on it."""
        if now is None:
            now = time.monotonic()
        lease = Lease(eval_id, {k: v.copy() for k, v in debits.items()},
                      now + ttl, ttl, lease_id=lease_id)
        with self._lock:
            if len(self._leases) >= self.max_leases:
                self.rejected_full += 1
                return None
            self._leases[lease.id] = lease
            for nid, vec in lease.debits.items():
                prev = self._by_node.get(nid)
                self._by_node[nid] = (
                    vec.copy() if prev is None else prev + vec
                )
            self.granted += 1
            self.peak_active = max(self.peak_active, len(self._leases))
        return lease

    def _drop_locked(self, lease: Lease) -> None:
        for nid, vec in lease.debits.items():
            cur = self._by_node.get(nid)
            if cur is None:
                continue
            cur = cur - vec
            if (cur <= 0).all():
                self._by_node.pop(nid, None)
            else:
                self._by_node[nid] = cur

    def release(self, lease_id: str) -> bool:
        """Idempotent release (False if already released/expired)."""
        with self._lock:
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                return False
            self._drop_locked(lease)
            self.released += 1
        return True

    def expire_due(self, now: Optional[float] = None) -> List[Lease]:
        """Drop every lease past its TTL; returns them (the committer
        counts and the test clock can force expiry by passing ``now``)."""
        if now is None:
            now = time.monotonic()
        out: List[Lease] = []
        with self._lock:
            for lid in [lid for lid, l in self._leases.items()
                        if l.expires <= now]:
                lease = self._leases.pop(lid)
                self._drop_locked(lease)
                self.expired += 1
                out.append(lease)
        return out

    def clear(self) -> int:
        """Drop everything (leadership loss). Returns the count lost."""
        with self._lock:
            n = len(self._leases)
            self._leases.clear()
            self._by_node.clear()
        return n

    def holds(self, lease_id: str) -> bool:
        with self._lock:
            return lease_id in self._leases

    def active(self) -> int:
        with self._lock:
            return len(self._leases)

    def node_debit(self, node_id: str) -> Optional[np.ndarray]:
        """Summed active debit on one node (shared array — copy before
        mutation), or None."""
        with self._lock:
            return self._by_node.get(node_id)

    def debit_map(self, exclude: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
        """{node id: summed int64[4] debit} over active leases, minus the
        ``exclude``d lease ids (a plan verifying its own lease must not
        double-count itself). Fresh arrays — callers may mutate."""
        with self._lock:
            if not self._leases:
                return {}
            out = {nid: vec.copy() for nid, vec in self._by_node.items()}
            for lid in exclude:
                lease = self._leases.get(lid)
                if lease is None:
                    continue
                for nid, vec in lease.debits.items():
                    cur = out.get(nid)
                    if cur is None:
                        continue
                    cur -= vec
                    if (cur <= 0).all():
                        out.pop(nid, None)
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            reserved = [int(x) for x in (
                sum(self._by_node.values(), np.zeros(4, dtype=np.int64))
            )] if self._by_node else [0, 0, 0, 0]
            return {
                "active": len(self._leases),
                "nodes_debited": len(self._by_node),
                "max_leases": self.max_leases,
                "granted": self.granted,
                "released": self.released,
                "expired": self.expired,
                "rejected_full": self.rejected_full,
                "peak_active": self.peak_active,
                "reserved_vector": reserved,
            }


class _MaskCtx:
    """Minimal context for mirror constraint masks (check_constraint only
    reads the regex compile cache)."""

    __slots__ = ("regexp_cache",)

    def __init__(self):
        self.regexp_cache: Dict[str, Any] = {}


def express_eligible(job: Job, config: ExpressConfig) -> bool:
    """Static (job-shape) half of eligibility; the lane's ``submit``
    additionally rejects updates of live jobs and falls back when no
    capacity sample fits. Express handles exactly the shapes the sync
    pick can answer: small batch jobs, no ports, no distinct-hosts."""
    if not config.enabled or not getattr(job, "express", False):
        return False
    if job.type != structs.JOB_TYPE_BATCH:
        return False
    total = sum(tg.count for tg in job.task_groups)
    if not 0 < total <= config.max_tasks:
        return False
    for c in job.constraints:
        if c.operand == structs.CONSTRAINT_DISTINCT_HOSTS:
            return False
    for tg in job.task_groups:
        for c in tg.constraints:
            if c.operand == structs.CONSTRAINT_DISTINCT_HOSTS:
                return False
        for task in tg.tasks:
            if task.resources is not None and task.resources.networks:
                return False  # port semantics need the sequential index
    return True


class _CapacityView:
    """One datacenter set's cached capacity view: the mirror's node list
    + totals next to the delta-rolled base usage. Built/refreshed OFF
    the submit path (the committer thread's cadence): rolling usage
    forward under a 10k-node service load costs milliseconds, which is
    the whole sub-ms budget. Staleness is bounded (VIEW_REFRESH) and
    safe: the ledger covers express-vs-express, verify is authoritative
    for everything else — a stale view costs at worst a bounce."""

    __slots__ = ("nodes", "mirror", "totals", "used", "at")

    def __init__(self, nodes, mirror, totals, used, at):
        self.nodes = nodes
        self.mirror = mirror
        self.totals = totals
        self.used = used
        self.at = at


class _PendingCommit:
    """One placed-but-uncommitted submission in the committer queue."""

    __slots__ = ("job", "ev", "allocs", "lease", "bounces", "durable",
                 "enqueued")

    def __init__(self, job: Job, ev: Evaluation, allocs: List[Allocation],
                 lease: Lease):
        self.job = job
        self.ev = ev
        self.allocs = allocs
        self.lease = lease
        self.bounces = 0
        # job+eval raft entries committed (survives bounce retries).
        self.durable = False
        self.enqueued = time.perf_counter()


class ExpressLane:
    """The leader-local express placement lane. One per server; consulted
    by ``Server.job_register`` after admission for express-eligible jobs.
    ``submit`` returns ``(eval_id, index)`` with the placement made
    in-line, or None — the caller then takes the ordinary slow path (a
    fallback, never an error: express is an optimization, the broker
    path is the contract)."""

    def __init__(self, server, config: Optional[ExpressConfig] = None):
        self.server = server
        self.config = config or ExpressConfig()
        self.ledger = ReservationLedger(self.config.max_leases)
        seed = getattr(server.config, "seed", 0)
        # Seeded decision streams (nomad_tpu_torch/prng.py): candidate rows and
        # lease jitter replay per seed; draws are serialized under
        # _lock so the n-th draw is a pure function of the submission
        # sequence.
        self._pick = prng.stream(seed, "express.pick")
        self._jitter = prng.stream(seed, "express.lease_jitter")
        self._mask_ctx = _MaskCtx()
        self._ids = _IdPool()
        # Per-datacenter-set capacity views, swapped atomically by the
        # committer thread's refresh cadence (see _CapacityView).
        self._views: Dict[Tuple[str, ...], _CapacityView] = {}
        self._lock = threading.Lock()
        self._pending: "collections.deque[_PendingCommit]" = collections.deque()
        # Job id -> eval id of entries placed but not yet durably
        # handled (committed or reconciled): the duplicate-submission
        # guard across the async-commit window, where job_by_id can't
        # answer yet. A same-job retry gets the ORIGINAL eval id back —
        # the idempotent answer a client retrying a timed-out register
        # expects — instead of a second placement.
        self._inflight_jobs: Dict[str, str] = {}
        self._wake = threading.Condition(self._lock)
        self._stop = threading.Event()
        # Test seam: committer processes entries only while set (tests
        # clear it to hold a lease mid-commit; production never touches).
        self.commit_gate = threading.Event()
        self.commit_gate.set()
        self._thread: Optional[threading.Thread] = None
        # Books (mutated under _lock; read lock-free for exposition).
        self.placed = 0
        self.tasks_placed = 0
        self.committed = 0
        self.bounces = 0
        self.conflicts = 0
        self.reconciled = 0
        self.duplicates = 0
        self.fallbacks: Dict[str, int] = {}
        self.place_sample = telemetry.AggregateSample()
        self._outcomes: "collections.deque" = collections.deque(
            maxlen=OUTCOME_RING)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if not self.config.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._commit_loop, daemon=True, name="express-commit",
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._wake:
            self._wake.notify_all()
        # Join the committer first: an entry it popped just before the
        # stop must finish (or fail into the drain below) rather than
        # race interpreter teardown on a daemon thread.
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        # Best-effort drain: placed-but-uncommitted entries reconcile to
        # durable pending evals before the lane goes dark — the callers
        # were already told "placed", and a clean (rolling-restart)
        # shutdown must not silently lose that work. Runs after _stop so
        # the committer can't double-pop; raft/forwarding is still up
        # (the server tears the lane down first).
        while True:
            with self._wake:
                if not self._pending:
                    break
                entry = self._pending.popleft()
            try:
                self._reconcile(entry, reason="shutdown")
            except Exception:
                # Per-entry isolation: one failed reconcile (a transient
                # forward error) must not abandon the REST of the
                # backlog — every entry is a caller already answered
                # "placed".
                telemetry.incr_counter(("express", "reconcile_error"))
                self.server.logger.exception(
                    "express shutdown drain failed for eval %s",
                    entry.ev.id)
            finally:
                self._job_done(entry.job.id)

    def demote(self) -> None:
        """Leadership lost: leases are meaningless against a stale view.
        Pending entries stay queued — the committer reconciles them to
        the current leader (their job/eval/alloc entries were never
        committed here, so the slow path places them exactly once)."""
        lost = self.ledger.clear()
        if lost:
            telemetry.incr_counter(("express", "leases_lost"), lost)

    # -- the submit path (synchronous, sub-millisecond) ----------------------

    def submit(self, job: Job, client_id: str = "",
               ) -> Optional[Tuple[str, int]]:
        """Place ``job`` in-line under a leased reservation and hand the
        raft commit to the committer. None = take the slow path."""
        if not express_eligible(job, self.config):
            return None
        t0 = time.perf_counter()
        state = self.server.state_store
        if state.job_by_id(job.id) is not None:
            # Updates of a live job need the reconciler's diff semantics.
            # Checked against the LIVE store (not the reused snapshot):
            # a double-submit inside the snapshot window must still fall
            # to the slow path's idempotent upsert.
            return self._fallback("job_exists")
        view = self._view(tuple(job.datacenters))
        eval_id = self._ids.take()
        # Decide under the lock, act outside it (_fallback re-takes the
        # lock to count). The in-flight map closes the async-commit
        # window: a same-job retry arriving before the first entry's
        # raft job_register lands gets the FIRST submission's eval id
        # back (idempotent retry) instead of a second placement —
        # committed state alone can't see the duplicate yet. An empty
        # value is the pre-enqueue placeholder: the winner is still
        # placing (sub-ms), so the retry parks on the lane condition
        # until the entry resolves to an enqueued eval id (answer with
        # it) or is withdrawn (the winner fell back — take the slow
        # path too; a phantom id that no one will ever commit must
        # never be handed out).
        with self._wake:
            declined = None
            if job.id in self._inflight_jobs:
                self.duplicates += 1
                deadline = time.monotonic() + 2.0
                while True:
                    dup_eval = self._inflight_jobs.get(job.id)
                    if dup_eval is None:
                        declined = "job_exists"  # winner withdrew
                        break
                    if dup_eval:
                        break
                    if time.monotonic() >= deadline:
                        declined = "job_exists"
                        break
                    self._wake.wait(timeout=0.05)
            elif len(self._pending) >= self.config.max_pending:
                declined = "backlog_full"
            else:
                dup_eval = None
                self._inflight_jobs[job.id] = ""
        if declined is not None:
            return self._fallback(declined)
        if dup_eval:
            telemetry.incr_counter(("express", "duplicate"))
            return dup_eval, self.server.raft.applied_index
        # Re-check committed state AFTER installing the placeholder: a
        # prior same-id entry releases its guard only once its commit is
        # state-visible, so the pre-guard job_by_id check above races a
        # commit-then-release interleaving — guard-absent + job-present
        # here is exactly that committed case, and placing would double
        # the job.
        if state.job_by_id(job.id) is not None:
            self._job_done(job.id)
            return self._fallback("job_exists")
        try:
            return self._submit_reserved(job, client_id, eval_id, view, t0)
        except BaseException:
            # The guard placeholder must not outlive a failed
            # submission: a leaked entry would park every later
            # register of this job id on the duplicate wait.
            self._job_done(job.id)
            raise

    def _submit_reserved(self, job: Job, client_id: str, eval_id: str,
                         view: "_CapacityView", t0: float,
                         ) -> Optional[Tuple[str, int]]:
        """The placement half of submit(), run with the duplicate-guard
        placeholder held (the caller releases it on any exception; the
        fallback paths here release it inline)."""
        tracer = trace.get_tracer()
        root = tracer.start_span(eval_id, "express.place", root=True,
                                 annotations={"job_id": job.id,
                                              "client_id": client_id})
        pick_span = tracer.start_span(eval_id, "express.pick", parent=root)
        placement = self._place(job, view)
        pick_span.finish()
        if placement is None:
            root.annotate("fallback", True).finish()
            self._job_done(job.id)
            return self._fallback("no_fit")
        assignments, debits = placement
        lease_span = tracer.start_span(eval_id, "express.lease", parent=root)
        lease = self.ledger.reserve(eval_id, debits, self._lease_ttl(),
                                    lease_id=self._ids.take())
        lease_span.finish()
        if lease is None:
            root.annotate("fallback", True).finish()
            self._job_done(job.id)
            return self._fallback("ledger_full")

        ev = Evaluation(
            id=eval_id,
            priority=job.priority,
            type=job.type,
            triggered_by=EVAL_TRIGGER_EXPRESS,
            job_id=job.id,
            status=structs.EVAL_STATUS_COMPLETE,
            status_description="express placement",
        )
        allocs = self._materialize(job, ev, assignments, self._ids)
        entry = _PendingCommit(job, ev, allocs, lease)
        placed_ms = (time.perf_counter() - t0) * 1000.0
        events = getattr(self.server.fsm, "events", None)
        if events is not None:
            # ONE deterministic event per express submission (digest
            # contract: bounce/commit timing never shows in the stream).
            # Published BEFORE the committer can see the entry, so the
            # per-key type sequence is structurally ExpressPlaced-first
            # — the async commit's EvalUpdated/PlanApplied share this
            # key and must never race ahead of it. placed_ms lets
            # lifecycle/slo consumers build the express timeline
            # without new hot-path instruments.
            events.publish(
                "Express", "ExpressPlaced", key=eval_id,
                payload={
                    "job_id": job.id,
                    "tasks": len(allocs),
                    "placed_ms": round(placed_ms, 4),
                },
            )
        with self._wake:
            self._pending.append(entry)
            self.placed += 1
            self.tasks_placed += len(allocs)
            # Resolve the duplicate-guard placeholder: parked retries
            # wake to the real eval id.
            self._inflight_jobs[job.id] = eval_id
            self._wake.notify_all()
        self.place_sample.ingest(placed_ms)
        telemetry.incr_counter(("express", "placed"))
        telemetry.add_sample(("express", "place"), placed_ms)
        root.annotate("tasks", len(allocs)).finish()
        return eval_id, self.server.raft.applied_index

    # Capacity-view refresh cadence (seconds). Driven by the committer
    # thread so the submit path NEVER pays a snapshot copy or a usage
    # roll; the pick tolerates this much staleness by construction (the
    # ledger covers our own in-flight placements, plan verify is
    # authoritative for everything else).
    VIEW_REFRESH = 0.05
    MAX_VIEWS = 16

    def _build_view(self, dcs: Tuple[str, ...]) -> _CapacityView:
        snap = self.server.state_store.snapshot()
        nodes, mirror = GLOBAL_MIRROR_CACHE.get(snap, list(dcs),
                                                device=self.server.device)
        totals, used = mirror.capacity_view(snap)
        view = _CapacityView(nodes, mirror, totals, used,
                             time.monotonic())
        # Under the lane lock: cold-path submits (RPC threads) and the
        # committer's refresh both insert/evict here, and a concurrent
        # double-eviction would KeyError out of a client's register.
        with self._lock:
            views = self._views
            views[dcs] = view
            while len(views) > self.MAX_VIEWS:
                views.pop(next(iter(views)))
        return view

    def _view(self, dcs: Tuple[str, ...]) -> _CapacityView:
        view = self._views.get(dcs)
        if view is None:
            view = self._build_view(dcs)  # cold path (first submission)
        return view

    def _refresh_views(self) -> None:
        """Committer-cadence refresh of every known view (off the submit
        path by design — see VIEW_REFRESH)."""
        now = time.monotonic()
        for dcs, view in list(self._views.items()):
            if now - view.at >= self.VIEW_REFRESH:
                try:
                    self._build_view(dcs)
                except Exception:
                    # A torn refresh must not kill the committer; the
                    # stale view keeps serving (bounded by verify).
                    telemetry.incr_counter(
                        ("express", "view_refresh_error"))
                    self.server.logger.exception(
                        "express capacity-view refresh failed")

    def await_inflight(self, job_id: str, timeout: float = 5.0) -> bool:
        """Block until no express entry for ``job_id`` is mid-async-
        commit (True) or ``timeout`` lapses (False). The slow path calls
        this before registering a job the express lane declined: a
        same-id submission may still be committing, and the slow
        scheduler's snapshot must contain its allocations or the job
        double-places. No-op (no lock contention beyond one check) in
        the common case."""
        if job_id not in self._inflight_jobs:
            return True
        deadline = time.monotonic() + timeout
        with self._wake:
            while job_id in self._inflight_jobs:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    telemetry.incr_counter(
                        ("express", "await_inflight_timeout"))
                    return False
                self._wake.wait(timeout=min(0.05, remaining))
        return True

    def _lease_ttl(self) -> float:
        """Configured TTL plus seeded jitter (the express.lease_jitter
        stream) — the ONE definition fresh leases and bounce re-leases
        share, drawn under the lane lock so the stream replays."""
        with self._lock:
            return self.config.lease_ttl * (
                1.0 + self.config.lease_jitter * self._jitter.random()
            )

    def _fallback(self, why: str) -> None:
        with self._lock:
            self.fallbacks[why] = self.fallbacks.get(why, 0) + 1
        telemetry.incr_counter(("express", "fallback", why))
        return None

    def _place(self, job: Job, view: _CapacityView,
               allocs: Optional[List[Allocation]] = None,
               ) -> Optional[Tuple[List[Tuple[object, str]],
                                   Dict[str, np.ndarray]]]:
        """Seeded sampled placement of every member against the cached
        capacity view (delta-rolled mirror + base usage, refreshed off
        the submit path). Returns (assignments, per-node debit map) or
        None when any member finds no fit within the probe budget.
        ``allocs`` re-places existing members (the bounce path) instead
        of expanding the job's groups."""
        nodes, mirror = view.nodes, view.mirror
        n = mirror.n
        if n == 0:
            return None
        totals, used = view.totals, view.used

        def tg_mask(tg):
            """Eligibility mask for one task group (driver + job/tg
            constraints) — cached per mirror, so warm submissions pay
            dict hits."""
            m = mirror.driver_mask({t.driver for t in tg.tasks})
            if job.constraints:
                m = m & mirror.constraint_mask(
                    self._mask_ctx, job.constraints)
            if tg.constraints:
                m = m & mirror.constraint_mask(
                    self._mask_ctx, tg.constraints)
            return m

        # (payload, mask, vec) per member: payload is the task group on
        # a fresh placement (materialized after) or the existing
        # Allocation on a bounce re-place (id stable, node rewritten) —
        # BOTH paths enforce the same eligibility masks.
        members: List[Tuple[object, Optional[np.ndarray], np.ndarray]] = []
        if allocs is not None:
            masks: Dict[str, Optional[np.ndarray]] = {}
            for a in allocs:
                if a.task_group not in masks:
                    tg = job.lookup_task_group(a.task_group)
                    masks[a.task_group] = (
                        tg_mask(tg) if tg is not None else None
                    )
                members.append((a, masks[a.task_group], np.asarray(
                    a.resources.as_vector() if a.resources else (0,) * 4,
                    dtype=np.int64)))
        else:
            for tg in job.task_groups:
                vec = np.asarray(_group_resources(tg).as_vector(),
                                 dtype=np.int64)
                cmask = tg_mask(tg)
                for _ in range(tg.count):
                    members.append((tg, cmask, vec))
        assignments: List[Tuple[object, str]] = []
        debits: Dict[str, np.ndarray] = {}
        node_debit = self.ledger.node_debit
        cfg = self.config
        with self._lock:  # serialize the seeded draws
            for member, mask, vec in members:
                best_row = -1
                best_free = None
                fits = 0
                for _probe in range(cfg.probes):
                    row = self._pick.randrange(n)
                    if mask is not None and not mask[row]:
                        continue
                    nid = nodes[row].id
                    free = totals[row].astype(np.int64) \
                        - used[row].astype(np.int64) - vec
                    lease_d = node_debit(nid)
                    if lease_d is not None:
                        free = free - lease_d
                    local = debits.get(nid)
                    if local is not None:
                        free = free - local
                    if (free < 0).any():
                        continue
                    fits += 1
                    score = int(free[0]) + int(free[1])
                    if best_free is None or score > best_free:
                        best_free = score
                        best_row = row
                    if fits >= cfg.choices:
                        break
                if best_row < 0:
                    return None
                nid = nodes[best_row].id
                prev = debits.get(nid)
                debits[nid] = vec.copy() if prev is None else prev + vec
                assignments.append((member, nid))
        return assignments, debits

    @staticmethod
    def _materialize(job: Job, ev: Evaluation,
                     assignments, ids: _IdPool) -> List[Allocation]:
        """Allocation objects for a fresh placement (ids minted HERE and
        stable for the entry's lifetime — the exactly-once key)."""
        out: List[Allocation] = []
        per_tg: Dict[str, int] = {}
        for (tg, nid) in assignments:
            i = per_tg.get(tg.name, 0)
            per_tg[tg.name] = i + 1
            res = _group_resources(tg)
            out.append(Allocation(
                id=ids.take(),
                eval_id=ev.id,
                name=f"{job.name}.{tg.name}[{i}]",
                node_id=nid,
                job_id=job.id,
                job=job,
                task_group=tg.name,
                resources=res,
                task_resources={
                    t.name: t.resources.copy()
                    for t in tg.tasks if t.resources is not None
                },
                metrics=AllocMetric(),
                desired_status=structs.ALLOC_DESIRED_STATUS_RUN,
                client_status=structs.ALLOC_CLIENT_STATUS_PENDING,
            ))
        return out

    # -- the committer (asynchronous raft) -----------------------------------

    def _commit_loop(self) -> None:
        while not self._stop.is_set():
            self.commit_gate.wait(timeout=0.05)
            expired = self.ledger.expire_due()
            if expired:
                telemetry.incr_counter(
                    ("express", "lease_expired"), len(expired))
                self._outcome(EXPRESS_LEASE_EXPIRED,
                              eval_id=expired[0].eval_id,
                              count=len(expired))
            # Capacity views refresh HERE, on the committer's clock —
            # never on the submit path (see _CapacityView).
            self._refresh_views()
            with self._wake:
                if not self._pending:
                    self._wake.wait(timeout=0.05)
                if not self._pending or not self.commit_gate.is_set():
                    continue
                entry = self._pending.popleft()
            try:
                self._commit(entry)
            except Exception as e:
                # The placement was answered optimistically; losing the
                # entry here would break exactly-once. Reconcile through
                # the slow path — and count it: a committer that falls
                # back under no failure is a sick lane.
                telemetry.incr_counter(("express", "commit_error"))
                self.server.logger.exception(
                    "express commit failed for eval %s", entry.ev.id)
                try:
                    self._reconcile(entry, reason=f"commit_error: {e}")
                except Exception:
                    telemetry.incr_counter(("express", "reconcile_error"))
                    self.server.logger.exception(
                        "express reconcile failed for eval %s", entry.ev.id)
            finally:
                self._job_done(entry.job.id)

    def _commit(self, entry: _PendingCommit) -> None:
        tracer = trace.get_tracer()
        span = tracer.start_span(entry.ev.id, "express.commit",
                                 parent=tracer.root_ctx(entry.ev.id))
        try:
            if not entry.durable:
                try:
                    self.server.raft.apply(
                        "job_register", {"job": entry.job}).result()
                    self.server.raft.apply(
                        "eval_update", {"evals": [entry.ev]}).result()
                except NotLeaderError:
                    self._reconcile(entry, reason="not_leader")
                    return
                entry.durable = True
            while True:
                if self.server.state_store.has_allocs_for_job(
                        entry.job.id):
                    # Another registration path placed this job while
                    # our commit was in flight (a concurrent slow-path
                    # submit of the same id is invisible to the
                    # duplicate guard): don't double-commit — the
                    # reconcile eval's ordinary scheduler dedupes
                    # against the live allocs (noop when the job is
                    # whole). A commit racing the other plan inside one
                    # pipeline cycle can still slip this check — the
                    # residual window of the leader-local trade; verify
                    # stays capacity-safe either way.
                    self._reconcile(entry,
                                    reason="concurrent_registration")
                    return
                plan = Plan(
                    eval_id=entry.ev.id,
                    priority=entry.ev.priority,
                    all_at_once=True,  # bounce atomically: never half-place
                    snapshot_index=self.server.raft.applied_index,
                    express_lease=entry.lease.id,
                )
                for a in entry.allocs:
                    plan.append_alloc(a)
                try:
                    result = self.server.plan_submit(plan)
                except NotLeaderError:
                    self._reconcile(entry, reason="not_leader")
                    return
                if result is not None and not result.refresh_index:
                    self.ledger.release(entry.lease.id)
                    with self._lock:
                        self.committed += 1
                    telemetry.incr_counter(("express", "committed"))
                    self._outcome(EXPRESS_COMMITTED, eval_id=entry.ev.id,
                                  tasks=len(entry.allocs),
                                  bounces=entry.bounces)
                    span.annotate("bounces", entry.bounces)
                    return
                # EXPRESS_BOUNCE: the all_at_once plan committed nothing.
                conflict = bool(result is not None and result.conflict)
                entry.bounces += 1
                lease_lost = not self.ledger.release(entry.lease.id)
                with self._lock:
                    self.bounces += 1
                    if conflict:
                        self.conflicts += 1
                telemetry.incr_counter(("express", "bounce"))
                if conflict:
                    telemetry.incr_counter(("express", "bounce_conflict"))
                self._outcome(EXPRESS_BOUNCE, eval_id=entry.ev.id,
                              conflict=conflict, lease_lost=lease_lost,
                              bounce=entry.bounces)
                if entry.bounces > self.config.max_bounces:
                    self._reconcile(entry, reason="max_bounces")
                    return
                # Re-place the SAME allocations (ids stable) under a
                # fresh lease against a FRESH view (a bounce means the
                # cached one lied; re-picking against it would re-bounce).
                view = self._build_view(tuple(entry.job.datacenters))
                placement = self._place(entry.job, view,
                                        allocs=entry.allocs)
                if placement is None:
                    self._reconcile(entry, reason="no_fit_on_bounce")
                    return
                assignments, debits = placement
                lease = self.ledger.reserve(entry.ev.id, debits,
                                            self._lease_ttl())
                if lease is None:
                    self._reconcile(entry, reason="ledger_full_on_bounce")
                    return
                entry.lease = lease
                for (alloc, nid) in assignments:
                    alloc.node_id = nid
        finally:
            span.finish()

    def _reconcile(self, entry: _PendingCommit, reason: str) -> None:
        """Slow-path reconciliation: hand the task to the ordinary
        scheduler via a PENDING eval on the CURRENT leader
        (``Server.express_reconcile`` applies locally on a leader and
        forwards ``Express.Reconcile`` otherwise). Nothing of this entry
        ever committed as allocations (all_at_once bounces are atomic;
        not_leader means even the job/eval entries may be absent), so the
        fresh eval places each task exactly once. The ORIGINAL express
        eval commits COMPLETE alongside, chained via next_eval — the
        submitter was handed that id and must see it reach a terminal
        status (quiesce/monitor loops poll it)."""
        self.ledger.release(entry.lease.id)
        ev = Evaluation(
            id=generate_uuid(),
            priority=entry.ev.priority,
            type=entry.job.type,
            triggered_by=EVAL_TRIGGER_EXPRESS_RECONCILE,
            job_id=entry.job.id,
            status=structs.EVAL_STATUS_PENDING,
            status_description=f"express reconcile ({reason})",
        )
        original = entry.ev.copy()
        original.status = structs.EVAL_STATUS_COMPLETE
        original.status_description = f"express reconciled ({reason})"
        original.next_eval = ev.id
        self.server.express_reconcile(entry.job, [original, ev])
        with self._lock:
            self.reconciled += 1
        telemetry.incr_counter(("express", "reconciled"))
        self._outcome(EXPRESS_RECONCILED, eval_id=entry.ev.id,
                      reason=reason, new_eval=ev.id)

    def _job_done(self, job_id: str) -> None:
        """Release the duplicate-submission guard for one job id (entry
        durably handled, or the submission fell back before enqueue).
        Wakes retries parked on the pre-enqueue placeholder."""
        with self._wake:
            self._inflight_jobs.pop(job_id, None)
            self._wake.notify_all()

    def _outcome(self, kind: str, **kw) -> None:
        kw["outcome"] = kind
        # nomadlint: allow(DET002) -- operator-facing decision-ring stamp
        # on /v1/agent/express; never interval math.
        kw["time"] = time.time()
        self._outcomes.append(kw)

    # -- exposition ----------------------------------------------------------

    def backlog(self) -> int:
        with self._lock:
            return len(self._pending)

    def summary(self) -> Dict[str, Any]:
        return {
            "enabled": self.config.enabled,
            "placed": self.placed,
            "tasks_placed": self.tasks_placed,
            "committed": self.committed,
            "bounces": self.bounces,
            "conflicts": self.conflicts,
            "reconciled": self.reconciled,
            "duplicates": self.duplicates,
            "fallbacks": dict(self.fallbacks),
            "backlog": self.backlog(),
            "leases": self.ledger.active(),
        }

    def snapshot(self) -> Dict[str, Any]:
        """The /v1/agent/express body (and the debug bundle's ``express``
        section): config, books, place-latency quantiles, the ledger, and
        the recent committer outcomes."""
        q = self.place_sample.quantiles()
        return {
            **self.summary(),
            "config": {
                "lease_ttl": self.config.lease_ttl,
                "lease_jitter": self.config.lease_jitter,
                "max_leases": self.config.max_leases,
                "probes": self.config.probes,
                "choices": self.config.choices,
                "max_tasks": self.config.max_tasks,
                "max_pending": self.config.max_pending,
                "max_bounces": self.config.max_bounces,
            },
            "place_ms": {
                "count": self.place_sample.count,
                "mean": round(self.place_sample.mean, 4),
                "max": round(self.place_sample.max, 4),
                **{k: round(v, 4) for k, v in q.items()},
            },
            "ledger": self.ledger.stats(),
            "recent_outcomes": list(self._outcomes),
        }


def _group_resources(tg) -> Resources:
    """Summed task-group resources (the alloc-level vector the verifier
    and the mirror usage read)."""
    total = Resources()
    for task in tg.tasks:
        total.add(task.resources)
    return total
