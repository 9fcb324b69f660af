"""The server: wires state, broker, plan pipeline, workers, heartbeats.

Port of nomad_tpu/server/server.py (upstream nomad/server.go and the RPC
endpoint files): the single-process ("DevMode") composition, with the
synchronous InProcRaft as its replication layer. Endpoint methods carry the
semantics of the net/rpc endpoints (job_endpoint.go, node_endpoint.go,
eval_endpoint.go, plan_endpoint.go) minus the wire format.

The server runs its ``tpu-*`` schedulers on one device, ``config.device``
(default: the CUDA card), resolved when the Server is built: without a card
the constructor raises, unless the caller asks for the CPU. There is no
host fallback: a device fault in an eval fails that eval's scheduler pass,
and the worker nacks it into the broker's redelivery machinery.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch import structs, telemetry, trace
from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.events import EventBroker
from nomad_tpu_torch.ops.binpack import bucket
from nomad_tpu_torch.ops.coalesce import (
    GLOBAL_SOLVER,
    device_work,
    quiesce_all,
)
from nomad_tpu_torch.server.eval_broker import (
    FAILED_QUEUE,
    BrokerError,
    BrokerFullError,
    EvalBroker,
)
from nomad_tpu_torch.server.fsm import FSM, InProcRaft
from nomad_tpu_torch.server.heartbeat import HeartbeatManager
from nomad_tpu_torch.server.plan_pipeline import PlanPipeline
from nomad_tpu_torch.server.plan_queue import PlanQueue
from nomad_tpu_torch.server.timetable import TimeTable
from nomad_tpu_torch.server.worker import Worker
from nomad_tpu_torch.structs import (
    CORE_JOB_EVAL_GC,
    CORE_JOB_NODE_GC,
    CORE_JOB_PRIORITY,
    JOB_TYPE_CORE,
    Evaluation,
    Job,
    Node,
    Plan,
    PlanResult,
    generate_uuid,
)
from nomad_tpu_torch.capacity import CapacityAccountant, CapacityConfig
from nomad_tpu_torch.profile_observe import (
    ProfileObserveConfig,
    RuntimeObservatory,
)
from nomad_tpu_torch.raft_observe import RaftObservatory, RaftObserveConfig
from nomad_tpu_torch.read_observe import ReadObservatory, ReadObserveConfig
from nomad_tpu_torch.server.admission import (
    AdmissionConfig,
    AdmissionController,
)
from nomad_tpu_torch.server.express import ExpressConfig, ExpressLane
from nomad_tpu_torch.server.read_path import ReadPath, ReadPathConfig
from nomad_tpu_torch.slo import (
    DEFAULT_OBJECTIVES,
    EXPRESS_OBJECTIVES,
    SLOMonitor,
)
from nomad_tpu_torch.tpu.mirror import GLOBAL_MIRROR_CACHE

# nomad_tpu ServerConfig keys whose modules the port does not have yet,
# with the module each needs. Setting one raises: it is never ignored.
NOT_PORTED = {
    "tls": "TLS on the RPC tier (tlsutil.py)",
    "solver_mesh": "the solver mesh (parallel/mesh.py)",
}


@dataclass
class ServerConfig:
    """Server tunables (reference: nomad/config.go:46-236 defaults).

    The keys of nomad_tpu's ServerConfig that belong to modules the port
    does not have yet are listed in ``NOT_PORTED`` and must stay None: the
    solver mesh and TLS.
    ``Server.stats()`` reports the server's device in place of nomad_tpu's
    device-probe and breaker state.
    """

    region: str = "global"
    datacenter: str = "dc1"
    node_name: str = "server-1"
    # Scheduler worker concurrency (``num_schedulers`` is the legacy
    # alias; a passed num_schedulers wins over scheduler_workers).
    scheduler_workers: int = 4
    num_schedulers: Optional[int] = None
    # How many pending plans the pipeline drains and verifies per fused
    # batch pass (plan_pipeline.py). 1 degenerates to the serial applier.
    plan_batch_size: int = 8
    # Seed for the server's name-salted decision-path PRNG streams
    # (broker scheduler choice, heartbeat jitter — nomad_tpu_torch.prng).
    seed: int = 0
    enabled_schedulers: List[str] = field(
        default_factory=lambda: [
            structs.JOB_TYPE_SERVICE,
            structs.JOB_TYPE_BATCH,
            structs.JOB_TYPE_SYSTEM,
            JOB_TYPE_CORE,
        ]
    )
    # 'tpu' routes service/batch evals to the device-solve factories;
    # 'host' uses the scalar oracle.
    scheduler_backend: str = "tpu"
    # Where the tpu-* schedulers solve: None = the CUDA card (raises at
    # Server construction without one), or e.g. "cpu" / "cuda:0".
    device: Optional[str] = None
    eval_nack_timeout: float = 60.0
    eval_delivery_limit: int = 3
    # Broker-level eval coalescing: each worker drains up to this many
    # ready evals (distinct jobs) per dequeue and runs them concurrently,
    # stacking their device solves into one dispatch (1 disables).
    eval_batch_size: int = 4
    eval_gc_interval: float = 300.0
    eval_gc_threshold: float = 3600.0
    node_gc_interval: float = 300.0
    node_gc_threshold: float = 24 * 3600.0
    min_heartbeat_ttl: float = 10.0
    max_heartbeats_per_second: float = 50.0
    # Declared by nomad_tpu and read by neither package: heartbeat TTLs
    # renewed at leader establish use the normal TTL. Stored, inert.
    failover_heartbeat_ttl: float = 300.0
    periodic_dispatch: bool = False  # GC dispatch loop (leader.go:170-200)
    # Ring size of the cluster event stream (nomad_tpu_torch.events).
    event_buffer_size: int = 2048
    # Declarative latency SLOs (nomad_tpu_torch.slo): objective name ->
    # threshold ms, e.g. {"submit_to_placed_p95_ms": 250}. None = the
    # slo.DEFAULT_OBJECTIVES set; {} disables the monitor entirely.
    slo_objectives: Optional[Dict[str, float]] = None
    # Rolling error-budget window for the SLO burn-rate accounting.
    slo_window_s: float = 3600.0
    # Enforced bound on the broker's pending evals (ready + blocked +
    # waiting); past it the broker spills (typed NACK + readmission).
    # 0 = unbounded.
    eval_pending_cap: int = 0
    # Enforced plan-queue depth cap: enqueue past it is a typed
    # PlanQueueError(ERR_QUEUE_FULL) -> worker nack. 0 = unbounded.
    plan_queue_cap: int = 0
    # Bound on blocking-query watcher registrations (state store + event
    # stream). 0 = unbounded.
    max_blocking_watchers: int = 0
    # Warm the solve path for the cluster's node buckets in the background
    # at start (tpu/solver.py warm_shapes): node mirror, masks, stacked
    # dispatch buffers and the kernels' first load, so the first eval and
    # the first burst do not pay them inside the coalescer's hold.
    prewarm_shapes: bool = True
    # Admission front-door spec (AdmissionConfig.parse mapping): per-
    # client token-bucket rate lanes + SLO-coupled shedding. None =
    # permissive defaults (admit everything).
    admission: Optional[Dict] = None
    # Express placement lane spec (ExpressConfig.parse mapping): leader-
    # local in-line placement of small express batch jobs under leased
    # capacity reservations. None = lane off.
    express: Optional[Dict] = None
    # Read-path observatory spec (ReadObserveConfig.parse mapping): the
    # books behind /v1/agent/reads. None = defaults (enabled; it only
    # records, nothing feeds back into a decision).
    reads: Optional[Dict] = None
    # Follower read plane spec (ReadPathConfig.parse mapping): the stale
    # lane's bound, the linearizable lane's read index, per-(role, lane)
    # serve books. None = defaults (enabled). It can refuse a read; it
    # never touches the log beyond the once-per-term barrier.
    read_path: Optional[Dict] = None
    # Capacity observatory spec (CapacityConfig.parse mapping): the
    # read-only accountant behind /v1/agent/capacity. None = defaults
    # (enabled; decision-invariant, as the churn-fragmentation
    # contrast arm shows).
    capacity: Optional[Dict] = None
    # Raft & recovery observatory spec (RaftObserveConfig.parse
    # mapping): the read-only observer behind /v1/agent/raft. None =
    # defaults (enabled; it drains books the raft node keeps as plain
    # data).
    raft_observe: Optional[Dict] = None
    tls: object = None
    # Runtime self-observatory spec (ProfileObserveConfig.parse mapping):
    # the read-only observer behind /v1/agent/profile and
    # /v1/agent/runtime (stack sampler, byte ledger, the lock watchdog's
    # table). None = defaults (enabled); {"enabled": False} is
    # steady-10k's profiler-off contrast arm.
    profile: Optional[Dict] = None
    solver_mesh: Optional[Dict] = None

    def __post_init__(self) -> None:
        for key, needs in NOT_PORTED.items():
            if getattr(self, key) is not None:
                raise ValueError(
                    f"ServerConfig.{key} needs {needs}, which "
                    "nomad_tpu_torch does not have yet"
                )
        if self.num_schedulers is not None:
            self.scheduler_workers = self.num_schedulers
        # Both spellings read the same resolved value afterwards.
        self.num_schedulers = self.scheduler_workers
        if (not isinstance(self.scheduler_workers, int)
                or isinstance(self.scheduler_workers, bool)
                or not 0 <= self.scheduler_workers <= 128):
            raise ValueError(
                "scheduler_workers must be an integer in [0, 128], got "
                f"{self.scheduler_workers!r}"
            )
        if (not isinstance(self.plan_batch_size, int)
                or isinstance(self.plan_batch_size, bool)
                or not 1 <= self.plan_batch_size <= 256):
            raise ValueError(
                "plan_batch_size must be an integer in [1, 256], got "
                f"{self.plan_batch_size!r}"
            )
        for knob in ("eval_pending_cap", "plan_queue_cap",
                     "max_blocking_watchers"):
            v = getattr(self, knob)
            if (not isinstance(v, int) or isinstance(v, bool)
                    or not 0 <= v <= 10_000_000):
                raise ValueError(
                    f"{knob} must be an integer in [0, 10000000], got {v!r}"
                )
        # Parse-time validation of the front door, lane and read-plane
        # blocks (typo'd keys and out-of-range values fail config load);
        # the parsed configs are what Server consumes.
        self.admission_config = AdmissionConfig.parse(self.admission)
        self.express_config = ExpressConfig.parse(self.express)
        self.capacity_config = CapacityConfig.parse(self.capacity)
        self.raft_observe_config = RaftObserveConfig.parse(self.raft_observe)
        self.reads_config = ReadObserveConfig.parse(self.reads)
        self.read_path_config = ReadPathConfig.parse(self.read_path)
        self.profile_config = ProfileObserveConfig.parse(self.profile)

    def scheduler_factory(self, eval_type: str) -> str:
        if self.scheduler_backend == "tpu" and eval_type in (
            structs.JOB_TYPE_SERVICE,
            structs.JOB_TYPE_BATCH,
            structs.JOB_TYPE_SYSTEM,
        ):
            return f"tpu-{eval_type}"
        return eval_type


class Server:
    """Single-process scheduling brain (reference: nomad/server.go:57-230,
    leader lifecycle at nomad/leader.go:99-140)."""

    def __init__(self, config: Optional[ServerConfig] = None,
                 logger: Optional[logging.Logger] = None):
        self.config = config or ServerConfig()
        # Resolved first: a server without the device it was asked for
        # fails here, not at its first eval.
        self.device = resolve_device(self.config.device)
        self.logger = logger or logging.getLogger("nomad_tpu_torch.server")

        self.eval_broker = EvalBroker(
            self.config.eval_nack_timeout, self.config.eval_delivery_limit,
            seed=self.config.seed,
            pending_cap=self.config.eval_pending_cap,
        )
        self.fsm = FSM(
            eval_broker=self.eval_broker, logger=self.logger,
            events=EventBroker(capacity=self.config.event_buffer_size,
                               emitter=self.config.node_name),
        )
        if self.config.max_blocking_watchers:
            self.fsm.state.watch.max_watchers = \
                self.config.max_blocking_watchers
            self.fsm.events.watch.max_watchers = \
                self.config.max_blocking_watchers
        self.raft = InProcRaft(self.fsm)
        self.plan_queue = PlanQueue(max_depth=self.config.plan_queue_cap)
        self.time_table = TimeTable()
        self.heartbeat = HeartbeatManager(self)
        self.plan_applier = PlanPipeline(
            self.plan_queue, self.eval_broker, self.raft, self.fsm,
            self.logger, max_batch=self.config.plan_batch_size,
        )
        self.workers: List[Worker] = []
        self._periodic_stop = threading.Event()
        self._started = False
        # Live SLO accounting over this server's own event stream
        # (/v1/agent/slo): an event-ring consumer, read-only on decisions.
        # An empty objectives dict opts out; None means the defaults, plus
        # the express lane's own target when the lane is on.
        self.slo_monitor: Optional[SLOMonitor] = None
        if self.config.slo_objectives is None or self.config.slo_objectives:
            objectives = self.config.slo_objectives
            if objectives is None and self.config.express_config.enabled:
                objectives = {**DEFAULT_OBJECTIVES, **EXPRESS_OBJECTIVES}
            self.slo_monitor = SLOMonitor(
                self.fsm.events, objectives,
                window_s=self.config.slo_window_s,
            )
        # The bounded front door (server/admission.py): consulted by
        # job_register/job_evaluate BEFORE any raft apply. With no caps
        # or rates configured it admits on a no-lock fast path.
        monitor = self.slo_monitor
        self.admission = AdmissionController(
            self.config.admission_config,
            seed=self.config.seed,
            queue_depth=self.eval_broker.pending_total,
            queue_cap=self.config.eval_pending_cap,
            burn_rate=(monitor.burn_rate if monitor is not None
                       else None),
            events=self.fsm.events,
        )
        # The express lane: built always (its books answer lane-off too),
        # active only when configured. The pipeline verifies under the
        # lane's reservation ledger only when the lane is on.
        self.express_lane = ExpressLane(self, self.config.express_config)
        if self.config.express_config.enabled:
            self.plan_applier.ledger = self.express_lane.ledger
        # The observatories are composed here and only here: no decision
        # path imports them. The getters re-read per poll: a snapshot
        # install rebinds fsm.state (a counted full rebuild, never a
        # stale view), and ClusterServer swaps in a RaftNode after this
        # constructor runs.
        self.capacity_accountant = CapacityAccountant(
            lambda: self.fsm.state,
            self.config.capacity_config,
            events=self.fsm.events,
        )
        self.raft_observatory = RaftObservatory(
            lambda: self.raft,
            self.config.raft_observe_config,
            events=self.fsm.events,
            fsm_getter=lambda: self.fsm,
        )
        # The read books the HTTP layer writes into (/v1/agent/reads);
        # the getters re-read per poll (snapshot installs rebind
        # fsm.state, ClusterServer swaps in a RaftNode).
        self.read_observatory = ReadObservatory(
            lambda: self.fsm.state,
            lambda: self.raft,
            self.config.reads_config,
            events=self.fsm.events,
        )
        # The follower read plane: consistency-lane resolution for every
        # HTTP read. It re-reads self.raft per request.
        self.read_path = ReadPath(self, self.config.read_path_config)
        # The runtime self-observatory: stack sampler, the lock
        # watchdog's contention table and the byte ledger. The getters
        # re-read the live handles per poll.
        self.runtime_observatory = RuntimeObservatory(
            self.config.profile_config,
            events=self.fsm.events,
            store_getter=lambda: self.fsm.state,
            rings_getter=self._runtime_rings,
            tables_getter=self._runtime_tables,
        )
        # Solve dispatches the start-time warmer has issued (0 until its
        # first pass over registered nodes completes).
        self.warm_dispatches = 0

    def _runtime_rings(self) -> Dict:
        """The bounded rings the byte ledger accounts: event broker, trace
        ring, admission decisions, express pending and outcomes, the plan
        pipeline's commit log."""
        return {
            "events": getattr(self.fsm.events, "_events", None),
            "traces": getattr(trace.get_tracer(), "_traces", None),
            "admission_decisions": getattr(
                self.admission, "_decisions", None),
            "express_pending": getattr(self.express_lane, "_pending", None),
            "express_outcomes": getattr(
                self.express_lane, "_outcomes", None),
            "plan_commit_log": getattr(
                self.plan_applier, "_commit_log", None),
        }

    def _runtime_tables(self) -> Dict:
        """The sibling observatories' books, through their snapshots."""
        out = {}
        if self.config.capacity_config.enabled:
            out["capacity"] = self.capacity_accountant.snapshot()
        if self.config.raft_observe_config.enabled:
            out["raft_observe"] = self.raft_observatory.snapshot()
        if self.config.reads_config.enabled:
            out["read_observe"] = self.read_observatory.snapshot()
        return out

    @property
    def plan_pipeline(self) -> PlanPipeline:
        """The optimistic batch applier (``plan_applier`` is the legacy
        spelling kept for the reference's naming)."""
        return self.plan_applier

    @property
    def state_store(self):
        return self.fsm.state

    # -- lifecycle (leader.go:99-140 establishLeadership) -------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.plan_queue.set_enabled(True)
        self.eval_broker.set_enabled(True)
        self.plan_applier.start()
        self.restore_eval_broker()
        for i in range(self.config.scheduler_workers):
            worker = Worker(self, i)
            worker.start()
            self.workers.append(worker)
        if self.config.periodic_dispatch:
            t = threading.Thread(
                target=self._periodic_dispatcher, daemon=True,
                name="periodic-gc",
            )
            t.start()
        reaper = threading.Thread(
            target=self._reap_failed_evaluations, daemon=True,
            name="failed-eval-reaper",
        )
        reaper.start()
        self._start_readmission()
        if self.slo_monitor is not None:
            self.slo_monitor.start()
        self.express_lane.start()
        self.capacity_accountant.start()
        self.raft_observatory.start()
        self.read_observatory.start()
        self.runtime_observatory.start()
        emitter = threading.Thread(
            target=self._emit_stats, daemon=True, name="stats-emitter",
        )
        emitter.start()
        if self.config.prewarm_shapes and self.config.scheduler_backend == "tpu":
            warmer = threading.Thread(
                target=self._prewarm_solver, daemon=True, name="shape-warmer",
            )
            warmer.start()

    def _prewarm_solver(self) -> None:
        """Background warm of the solve path (see ServerConfig
        .prewarm_shapes), re-run whenever the cluster's node-bucket
        signature changes: a fresh cluster warms as soon as nodes
        register, and growth into a larger bucket warms before an eval
        needs it. The server's device was resolved at construction, so
        there is no device to wait for. Wakes on node-table writes (and
        every 5 s at most idle), so a registration is warmed at once."""
        from nomad_tpu_torch.state.store import item_table
        from nomad_tpu_torch.tpu.solver import warm_shapes

        warmed_sig = None
        while not self._periodic_stop.is_set():
            store = self.state_store
            try:
                ticket = store.watch.register([item_table("nodes")])
            except structs.RejectError:
                # Watcher cap reached: fall back to the 5 s poll.
                ticket = None
            try:
                snap = store.snapshot()
                nodes = [
                    n for n in snap.nodes()
                    if n.status == structs.NODE_STATUS_READY and not n.drain
                ]
                per_dc: Dict[str, int] = {}
                for n in nodes:
                    per_dc[n.datacenter] = per_dc.get(n.datacenter, 0) + 1
                sig = (
                    bucket(len(nodes)) if nodes else 0,
                    tuple(sorted(bucket(c) for c in per_dc.values())),
                )
                if nodes and sig != warmed_sig:
                    try:
                        self.warm_dispatches += warm_shapes(
                            snap, logger=self.logger, device=self.device,
                            stop=self._periodic_stop.is_set,
                        )
                        warmed_sig = sig
                    except Exception:
                        self.logger.exception("shape prewarm failed")
                if ticket is None:
                    self._periodic_stop.wait(5.0)
                else:
                    store.watch.wait(ticket, timeout=5.0)
            finally:
                if ticket is not None:
                    store.watch.unregister(ticket)

    def _stop_loop(self) -> None:
        """Stop workers, pipeline, broker and heartbeats (no device
        drain)."""
        self._periodic_stop.set()
        for worker in self.workers:
            worker.stop()
        self.express_lane.stop()
        self.capacity_accountant.stop()
        self.raft_observatory.stop()
        self.read_observatory.stop()
        self.runtime_observatory.stop()
        if self.slo_monitor is not None:
            self.slo_monitor.stop()
        self.plan_applier.stop()
        self.plan_queue.set_enabled(False)
        self.eval_broker.set_enabled(False)
        self.heartbeat.clear_all()

    def _drain_device(self, drain_timeout: float) -> bool:
        """Wait for the process-wide device work to drain, at most
        ``drain_timeout`` seconds. The coalescer is shared by every server
        of the process (cluster members included), so this may wait on
        other servers' solves: the wait is bounded and logged."""
        before = device_work()
        t0 = time.monotonic()
        drained = quiesce_all(drain_timeout)
        self.logger.info(
            "shutdown: %s device work in %.3fs (at stop: %d queued, %d "
            "dispatching, %d in direct device work; now: %s)",
            "drained" if drained else "gave up waiting for",
            time.monotonic() - t0, before["queued"], before["dispatching"],
            before["direct"], device_work(),
        )
        return drained

    def shutdown(self, drain_timeout: float = 10.0) -> bool:
        """Stop the loop, then drain device work: returns once no worker
        is inside a scheduler pass and no coalesced solve is queued or in
        flight (False if that took longer than ``drain_timeout``)."""
        self._stop_loop()
        return self._drain_device(drain_timeout)

    def _emit_stats(self) -> None:
        """Periodic telemetry gauges at 1 Hz (server.go:213-228 EmitStats ->
        eval_broker.go:557-575, plan_queue.go:198-209, heartbeat.go:135-148)."""
        while not self._periodic_stop.wait(1.0):
            broker = self.eval_broker.snapshot_stats()
            telemetry.set_gauge(("broker", "total_ready"), broker.total_ready)
            telemetry.set_gauge(
                ("broker", "total_unacked"), broker.total_unacked)
            telemetry.set_gauge(
                ("broker", "total_blocked"), broker.total_blocked)
            telemetry.set_gauge(
                ("broker", "total_waiting"), broker.total_waiting)
            for queue, stats in broker.by_scheduler.items():
                telemetry.set_gauge(("broker", queue, "ready"), stats.ready)
                telemetry.set_gauge(
                    ("broker", queue, "unacked"), stats.unacked)
            telemetry.set_gauge(
                ("plan", "queue_depth"), self.plan_queue.depth())
            telemetry.set_gauge(
                ("worker", "concurrency"),
                sum(1 for w in self.workers if w.is_alive()),
            )
            telemetry.set_gauge(
                ("plan", "pipeline_batch_max"), self.plan_applier.max_batch)
            telemetry.set_gauge(
                ("heartbeat", "active"), self.heartbeat.num_timers())
            for name, registry in (("state", self.state_store.watch),
                                   ("events", self.fsm.events.watch)):
                wstats = registry.stats()
                telemetry.set_gauge(
                    ("blocking", name, "watchers"), wstats["watchers"])
                telemetry.set_gauge(
                    ("blocking", name, "watch_rejected"), wstats["rejected"])

    def restore_eval_broker(self) -> None:
        """Re-enqueue non-terminal evals after (re)gaining leadership
        (leader.go:142-168). wait_index = the post-barrier applied index:
        an earlier delivery of a restored eval may have committed a plan
        right before the previous leader died, and the next worker's
        snapshot must contain that plan or the eval gets placed twice."""
        wait_index = self.raft.applied_index
        for ev in self.state_store.evals():
            if ev.should_enqueue():
                try:
                    self.eval_broker.enqueue(ev, wait_index=wait_index)
                except BrokerFullError:
                    # Cap reached mid-restore: the rest stays durable in
                    # state; the readmission loop drains it as capacity
                    # frees (the spill flag is already set).
                    break

    def _start_readmission(self) -> None:
        """Arm the spill-readmission loop iff the broker is bounded (an
        unbounded broker never spills; the thread would idle forever).
        Shared by Server.start and ClusterServer.start."""
        if not self.config.eval_pending_cap:
            return
        threading.Thread(
            target=self._readmission_loop, daemon=True,
            name="eval-readmit",
        ).start()

    def _readmission_loop(self) -> None:
        """Drain spilled evals back into the bounded broker as capacity
        frees. Spilling (eval_broker.pending_cap) keeps over-cap evals
        durable in the state store only; this loop is the other half of
        that contract — without it a spilled eval would be stuck pending
        forever. Polling is cheap: the broker hands out one True per
        spill episode (reclaim_spilled), so the state scan runs only
        when there is actually something to readmit."""
        while not self._periodic_stop.wait(0.5):
            if not self.eval_broker.reclaim_spilled():
                continue
            wait_index = self.raft.applied_index
            pending = [ev for ev in self.state_store.evals()
                       if ev.should_enqueue()]
            # Highest priority first, then oldest — the order the broker
            # itself would have served them in.
            pending.sort(key=lambda e: (-e.priority, e.create_index, e.id))
            readmitted = 0
            for ev in pending:
                try:
                    self.eval_broker.enqueue(
                        ev, wait_index=wait_index)
                    readmitted += 1
                except BrokerFullError:
                    break  # flag re-armed by the broker; next episode
                except BrokerError:
                    break  # disabled (leadership lost) — moot
            if readmitted:
                telemetry.incr_counter(("broker", "readmitted"), readmitted)
                self.logger.debug(
                    "readmitted %d spilled evals", readmitted)

    def _periodic_dispatcher(self) -> None:
        """Dispatch GC core evals periodically (leader.go:170-200)."""
        import time as _time

        last_eval_gc = last_node_gc = _time.monotonic()
        while not self._periodic_stop.wait(1.0):
            now = _time.monotonic()
            self.time_table.witness(self.raft.applied_index)
            if now - last_eval_gc >= self.config.eval_gc_interval:
                self._dispatch_core_job(CORE_JOB_EVAL_GC)
                last_eval_gc = now
            if now - last_node_gc >= self.config.node_gc_interval:
                self._dispatch_core_job(CORE_JOB_NODE_GC)
                last_node_gc = now

    def _reap_failed_evaluations(self) -> None:
        """Drain the broker's _failed queue: mark the eval failed through the
        log and ack it so the job's blocked evals unwedge
        (reference: leader.go:202-238)."""
        while not self._periodic_stop.is_set():
            try:
                ev, token = self.eval_broker.dequeue([FAILED_QUEUE], timeout=0.5)
            except BrokerError:
                if self._periodic_stop.wait(0.2):
                    return
                continue
            if ev is None:
                continue
            self.logger.warning("failed evaluation %s reached delivery limit, marking as failed", ev.id)
            new_eval = ev.copy()
            new_eval.status = structs.EVAL_STATUS_FAILED
            new_eval.status_description = (
                f"evaluation reached delivery limit "
                f"({self.config.eval_delivery_limit})"
            )
            try:
                self.eval_upsert([new_eval])
                self.eval_broker.ack(ev.id, token)
            except Exception:
                self.logger.exception("failed to reap evaluation %s", ev.id)

    def _dispatch_core_job(self, job_id: str) -> None:
        ev = Evaluation(
            id=generate_uuid(),
            priority=CORE_JOB_PRIORITY,
            type=JOB_TYPE_CORE,
            triggered_by=structs.EVAL_TRIGGER_SCHEDULED,
            job_id=job_id,
            status=structs.EVAL_STATUS_PENDING,
        )
        try:
            self.eval_broker.enqueue(ev)
        except BrokerFullError:
            # GC is periodic: the next tick retries after the overload
            # passes; the breach itself is already counted by the broker.
            self.logger.debug("core job %s dispatch spilled at cap", job_id)

    # -- Job endpoint (job_endpoint.go) -------------------------------------

    def job_register(self, job: Job, client_id: str = "") -> Tuple[str, int]:
        """Register/update a job and create its evaluation
        (job_endpoint.go:18-72). Returns (eval_id, index).

        The admission front door is checked FIRST (before validation, so
        an overload rejection stays cheap) and before any raft apply, so
        a raised RejectError proves zero side effects."""
        self.admission.admit_job(job, client_id)
        job.validate()
        if job.type == JOB_TYPE_CORE:
            raise ValueError("job type cannot be core")
        # An express-eligible job places in-line against the leader's
        # capacity view under a leased reservation; its raft entries
        # commit asynchronously. None = ineligible or declined: take the
        # ordinary path below.
        express = self.express_lane.submit(job, client_id)
        if express is not None:
            return express
        # A same-id express submission may still be mid-commit: wait it
        # out so the scheduler's snapshot holds its allocations. A commit
        # stalled past the wait is a typed capacity rejection (nothing
        # was applied, so a replay stays safe).
        if not self.express_lane.await_inflight(job.id):
            raise structs.RejectError(
                structs.REJECT_QUEUE_FULL,
                f"express commit for job {job.id} still in flight",
                retry_after=1.0,
            )
        index = self.raft.apply("job_register", {"job": job}).result()

        ev = Evaluation(
            id=generate_uuid(),
            priority=job.priority,
            type=job.type,
            triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER,
            job_id=job.id,
            job_modify_index=index,
            status=structs.EVAL_STATUS_PENDING,
        )
        eval_index = self.eval_upsert([ev])
        return ev.id, eval_index

    def job_evaluate(self, job_id: str, client_id: str = "") -> Tuple[str, int]:
        """Force re-evaluation (job_endpoint.go:75-128). Eval ingress is
        admission-gated like registration."""
        job = self.state_store.job_by_id(job_id)
        if job is None:
            raise KeyError("job not found")
        self.admission.admit_job(job, client_id)
        ev = Evaluation(
            id=generate_uuid(),
            priority=job.priority,
            type=job.type,
            triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER,
            job_id=job.id,
            job_modify_index=job.modify_index,
            status=structs.EVAL_STATUS_PENDING,
        )
        index = self.eval_upsert([ev])
        return ev.id, index

    def job_deregister(self, job_id: str) -> Tuple[str, int]:
        """Remove a job and evaluate the teardown
        (job_endpoint.go:130-183)."""
        job = self.state_store.job_by_id(job_id)
        # A deregister racing an in-flight express commit would no-op
        # against absent state and then see the committer resurrect the
        # job after the "successful" removal.
        if not self.express_lane.await_inflight(job_id):
            raise structs.RejectError(
                structs.REJECT_QUEUE_FULL,
                f"express commit for job {job_id} still in flight",
                retry_after=1.0,
            )
        index = self.raft.apply("job_deregister", {"job_id": job_id}).result()

        priority = job.priority if job else structs.JOB_DEFAULT_PRIORITY
        jtype = job.type if job else structs.JOB_TYPE_SERVICE
        ev = Evaluation(
            id=generate_uuid(),
            priority=priority,
            type=jtype,
            triggered_by=structs.EVAL_TRIGGER_JOB_DEREGISTER,
            job_id=job_id,
            job_modify_index=index,
            status=structs.EVAL_STATUS_PENDING,
        )
        eval_index = self.eval_upsert([ev])
        return ev.id, eval_index

    # -- Node endpoint (node_endpoint.go) ------------------------------------

    @staticmethod
    def _validate_registration(node: Node) -> None:
        """Shared by the single and batch registration paths — a check
        added to one must hold on both or invalid nodes reach the raft
        log through whichever path drifted."""
        if not node.id:
            raise ValueError("missing node ID for client registration")
        if not node.datacenter:
            raise ValueError("missing datacenter for client registration")
        if not node.name:
            raise ValueError("missing node name for client registration")
        if not node.status:
            node.status = structs.NODE_STATUS_INIT
        if not structs.valid_node_status(node.status):
            raise ValueError("invalid status for node")

    def node_register(self, node: Node) -> Dict:
        """node_endpoint.go:18-80"""
        self._validate_registration(node)

        index = self.raft.apply("node_register", {"node": node}).result()

        reply: Dict = {"node_modify_index": index, "index": index, "eval_ids": []}
        if structs.should_drain_node(node.status):
            reply["eval_ids"], reply["eval_create_index"] = self.create_node_evals(
                node.id, index
            )
        if not node.terminal_status():
            reply["heartbeat_ttl"] = self.heartbeat.reset_heartbeat_timer(node.id)
        return reply

    def node_batch_register(self, nodes: List[Node]) -> Dict:
        """Bulk registration: one raft entry and one batched heartbeat arm
        for a whole tranche of nodes. The RPC-tier enabler for a 10k-node
        fleet (nomad_tpu's simcluster): per-node Node.Register would cost
        10k raft applies and 10k timer-arm lock hops. Semantics per node
        match node_register minus the drain-eval fan-out (batch
        registration is for fresh, non-draining fleets; a draining node
        must register individually)."""
        if not nodes:
            return {"index": 0, "heartbeat_ttls": {}}
        for node in nodes:
            self._validate_registration(node)
            if structs.should_drain_node(node.status):
                raise ValueError(
                    "batch registration only accepts init/ready nodes"
                )
        index = self.raft.apply(
            "node_batch_register", {"nodes": nodes}
        ).result()
        # Every node is init/ready here (validated above), so all get TTLs.
        ttls = self.heartbeat.reset_many([n.id for n in nodes])
        return {"index": index, "heartbeat_ttls": ttls}

    def node_batch_heartbeat(self, node_ids: List[str]) -> Dict:
        """Batched TTL renewal: equivalent to N node_heartbeat calls for
        already-ready nodes, under one heartbeat-manager lock hold. Nodes
        that are unknown get ttl 0.0 (the client re-registers); nodes in a
        non-ready state fall back to the full node_update_status path so
        the down->ready transition evals still fan out."""
        snap = self.state_store.snapshot()
        renew: List[str] = []
        out: Dict[str, float] = {}
        for node_id in node_ids:
            node = snap.node_by_id(node_id)
            if node is None:
                out[node_id] = 0.0
            elif node.status == structs.NODE_STATUS_READY:
                renew.append(node_id)
            else:
                # Per-node isolation: the snapshot is stale, and a node
                # deregistered since (KeyError from the live-store
                # re-read) must cost THAT node its renewal, not the
                # whole tranche — the batch path would otherwise amplify
                # one racing failure to batch_size nodes' TTLs.
                try:
                    out[node_id] = self.node_update_status(
                        node_id, structs.NODE_STATUS_READY
                    ).get("heartbeat_ttl", 0.0)
                except (KeyError, ValueError):
                    out[node_id] = 0.0
        if renew:
            out.update(self.heartbeat.reset_many(renew))
        return {"heartbeat_ttls": out}

    def node_deregister(self, node_id: str) -> Dict:
        """node_endpoint.go:82-117"""
        index = self.raft.apply("node_deregister", {"node_id": node_id}).result()
        self.heartbeat.clear_heartbeat_timer(node_id)
        eval_ids, eval_index = self.create_node_evals(node_id, index)
        return {
            "eval_ids": eval_ids,
            "eval_create_index": eval_index,
            "node_modify_index": index,
            "index": index,
        }

    def node_update_status(self, node_id: str, status: str) -> Dict:
        """node_endpoint.go:119-184"""
        if not structs.valid_node_status(status):
            raise ValueError("invalid status for node")
        node = self.state_store.node_by_id(node_id)
        if node is None:
            raise KeyError("node not found")

        index = node.modify_index
        if node.status != status:
            index = self.raft.apply(
                "node_status_update", {"node_id": node_id, "status": status}
            ).result()

        reply: Dict = {"node_modify_index": index, "index": index, "eval_ids": []}
        transition_to_ready = (
            node.status in (structs.NODE_STATUS_INIT, structs.NODE_STATUS_DOWN)
            and status == structs.NODE_STATUS_READY
        )
        if structs.should_drain_node(status) or transition_to_ready:
            reply["eval_ids"], reply["eval_create_index"] = self.create_node_evals(
                node_id, index
            )
        if status != structs.NODE_STATUS_DOWN:
            reply["heartbeat_ttl"] = self.heartbeat.reset_heartbeat_timer(node_id)
        return reply

    def node_update_drain(self, node_id: str, drain: bool) -> Dict:
        """node_endpoint.go:187-238"""
        node = self.state_store.node_by_id(node_id)
        if node is None:
            raise KeyError("node not found")
        index = node.modify_index
        if node.drain != drain:
            index = self.raft.apply(
                "node_drain_update", {"node_id": node_id, "drain": drain}
            ).result()
        reply: Dict = {"node_modify_index": index, "index": index, "eval_ids": []}
        if drain:
            reply["eval_ids"], reply["eval_create_index"] = self.create_node_evals(
                node_id, index
            )
        return reply

    def node_evaluate(self, node_id: str) -> Dict:
        """Force re-evaluation of a node (node_endpoint.go:240-280)."""
        node = self.state_store.node_by_id(node_id)
        if node is None:
            raise KeyError("node not found")
        eval_ids, eval_index = self.create_node_evals(node_id, node.modify_index)
        return {"eval_ids": eval_ids, "eval_create_index": eval_index,
                "index": eval_index}

    def node_heartbeat(self, node_id: str) -> float:
        """Client TTL renewal via Node.UpdateStatus(ready) in the reference;
        exposed directly for the client loop."""
        return self.node_update_status(node_id, structs.NODE_STATUS_READY).get(
            "heartbeat_ttl", 0.0
        )

    def update_allocs_from_client(self, allocs: List) -> int:
        """node_endpoint.go:385-457 (Node.UpdateAlloc)"""
        return self.raft.apply("alloc_client_update", {"allocs": allocs}).result()

    def node_batch_expire(self, node_ids: List[str]) -> Dict:
        """Mass TTL expiry (the heartbeat wheel's batch path): mark every
        node down and fan out the re-placement evaluations in ONE
        eval_upsert / broker enqueue instead of a per-node storm. Per-node
        semantics stay IDENTICAL to node_update_status(down) +
        create_node_evals: same per-node status applies (pipelined rather
        than serialized), same per-node eval fan-out with NO cross-node
        dedup — which nodes die in the same wheel pass is timing, and a
        node's eval set must not depend on it."""
        status = structs.NODE_STATUS_DOWN
        staged: List[Tuple[str, object, int]] = []
        for node_id in node_ids:
            node = self.state_store.node_by_id(node_id)
            if node is None:
                continue
            if node.status != status:
                fut = self.raft.apply(
                    "node_status_update",
                    {"node_id": node_id, "status": status},
                )
                staged.append((node_id, fut, 0))
            else:
                staged.append((node_id, None, node.modify_index))
        settled: List[Tuple[str, int]] = []
        for node_id, fut, index in staged:
            if fut is not None:
                index = fut.result()
            settled.append((node_id, index))
        # One snapshot for the whole batch: every status apply above has
        # committed, and the fan-out reads only allocs-by-node + system
        # jobs, which those applies don't change.
        snap = self.state_store.snapshot()
        evals: List[Evaluation] = []
        reply: Dict = {"eval_ids": [], "nodes": len(settled)}
        for node_id, node_index in settled:
            evals.extend(self._node_eval_fanout(snap, node_id, node_index))
        if evals:
            reply["eval_create_index"] = self.eval_upsert(evals)
            reply["eval_ids"] = [e.id for e in evals]
        return reply

    def create_node_evals(self, node_id: str, node_index: int) -> Tuple[List[str], int]:
        """Fan out node-update evals: one per job with allocs on the node,
        plus every system job (node_endpoint.go:459-551)."""
        snap = self.state_store.snapshot()
        if (not snap.allocs_by_node(node_id)
                and not snap.jobs_by_scheduler(structs.JOB_TYPE_SYSTEM)):
            return [], 0
        evals = self._node_eval_fanout(snap, node_id, node_index)
        index = self.eval_upsert(evals)
        return [e.id for e in evals], index

    def _node_eval_fanout(self, snap, node_id: str,
                          node_index: int) -> List[Evaluation]:
        """One node's node-update eval set (the create_node_evals body,
        shared with the batch-expiry path so single and mass expiry build
        byte-identical evals from the same snapshot reads)."""
        allocs = snap.allocs_by_node(node_id)
        sys_jobs = snap.jobs_by_scheduler(structs.JOB_TYPE_SYSTEM)

        evals: List[Evaluation] = []
        job_ids = set()
        for alloc in allocs:
            if alloc.job_id in job_ids or alloc.job is None:
                continue
            job_ids.add(alloc.job_id)
            evals.append(
                Evaluation(
                    id=generate_uuid(),
                    priority=alloc.job.priority,
                    type=alloc.job.type,
                    triggered_by=structs.EVAL_TRIGGER_NODE_UPDATE,
                    job_id=alloc.job_id,
                    node_id=node_id,
                    node_modify_index=node_index,
                    status=structs.EVAL_STATUS_PENDING,
                )
            )
        for job in sys_jobs:
            if job.id in job_ids:
                continue
            job_ids.add(job.id)
            evals.append(
                Evaluation(
                    id=generate_uuid(),
                    priority=job.priority,
                    type=job.type,
                    triggered_by=structs.EVAL_TRIGGER_NODE_UPDATE,
                    job_id=job.id,
                    node_id=node_id,
                    node_modify_index=node_index,
                    status=structs.EVAL_STATUS_PENDING,
                )
            )

        return evals

    # -- Eval endpoint (eval_endpoint.go) ------------------------------------

    def eval_dequeue(self, schedulers: List[str], timeout: float):
        """Returns (eval, token, wait_index) — wait_index is the raft
        index the worker must observe locally before snapshotting."""
        ev, token = self.eval_broker.dequeue(schedulers, timeout)
        if ev is None:
            return None, "", 0
        # Floor at the leader's applied index: whatever was committed
        # before this delivery (earlier plans for this eval included) must
        # be visible in the processing worker's snapshot.
        return ev, token, max(self.eval_broker.wait_index(ev.id),
                              self.raft.applied_index)

    def eval_dequeue_batch(self, schedulers: List[str], max_batch: int,
                           timeout: float):
        """Coalescing dequeue: block for one eval, drain up to max_batch-1
        more ready ones (distinct jobs). The broker half of SURVEY.md §7
        'Batched evals' — the worker runs the batch concurrently so the
        device solves stack into one dispatch (ops/coalesce.py).
        Returns (eval, token, wait_index) triples."""
        return [
            (ev, token, max(self.eval_broker.wait_index(ev.id),
                            self.raft.applied_index))
            for ev, token in self.eval_broker.dequeue_batch(
                schedulers, max_batch, timeout)
        ]

    def eval_ack(self, eval_id: str, token: str) -> None:
        self.eval_broker.ack(eval_id, token)

    def eval_touch(self, eval_id: str, token: str) -> None:
        """Reset the outstanding eval's nack timer mid-processing — keeps a
        long first-compile solve from being redelivered (the broker-side
        mechanism is OutstandingReset, eval_broker.go:396-412; the
        reference only exercises it from plan submission, which is too
        late for a pre-plan cold compile)."""
        self.eval_broker.outstanding_reset(eval_id, token)

    def eval_nack(self, eval_id: str, token: str) -> None:
        self.eval_broker.nack(eval_id, token)

    def eval_upsert(self, evals: List[Evaluation]) -> int:
        """Commit evals through the log (Eval.Update / Eval.Create RPC,
        eval_endpoint.go)."""
        return self.raft.apply("eval_update", {"evals": evals}).result()

    def eval_reap(self, eval_ids: List[str], alloc_ids: List[str]) -> int:
        return self.raft.apply(
            "eval_delete", {"evals": eval_ids, "allocs": alloc_ids}
        ).result()

    # -- Plan endpoint (plan_endpoint.go:16-38) ------------------------------

    def plan_submit(self, plan: Plan) -> PlanResult:
        pending = self.plan_queue.enqueue(plan)
        return pending.wait()

    # -- Read plane (server/read_path.py) ------------------------------------

    def confirmed_read_index(self, timeout: float = 2.0) -> int:
        """A leadership-confirmed read index for the linearizable lane (no
        raft log write). InProcRaft confirms trivially; a ClusterServer
        follower forwards Raft.ReadIndex to the leader."""
        return self.raft.read_index(timeout=timeout)

    # -- Express endpoint (server/express.py) --------------------------------

    def express_reconcile(self, job: Job, evals: List[Evaluation]) -> int:
        """Durably hand a bounced-out or failed-over express entry to the
        ordinary scheduler: upsert the job and its evals (the original
        express eval complete with a successor, plus the PENDING
        reconcile eval, which the FSM enqueues) through raft. On a
        ClusterServer a non-leader forwards Express.Reconcile.

        Idempotent: a retried hand-over whose reconcile eval (the last of
        ``evals``) is already in the state store applied before, and is
        not applied again."""
        if self.state_store.eval_by_id(evals[-1].id) is not None:
            return self.raft.applied_index
        self.raft.apply("job_register", {"job": job}).result()
        return self.eval_upsert(evals)

    # -- convenience --------------------------------------------------------

    def wait_for_eval(self, eval_id: str, timeout: float = 10.0) -> Evaluation:
        """Poll until the eval reaches a terminal status (the CLI monitor's
        polling loop, command/monitor.go)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            ev = self.state_store.eval_by_id(eval_id)
            if ev is not None and ev.terminal_status():
                return ev
            _time.sleep(0.01)
        raise TimeoutError(f"eval {eval_id} did not complete")

    def stats(self) -> Dict:
        broker = self.eval_broker.snapshot_stats()
        return {
            "applied_index": self.raft.applied_index,
            "broker_ready": broker.total_ready,
            "broker_unacked": broker.total_unacked,
            "broker_blocked": broker.total_blocked,
            "plan_queue_depth": self.plan_queue.depth(),
            "plan_pipeline": self.plan_applier.stats(),
            "heartbeat_timers": self.heartbeat.num_timers(),
            "scheduler": self.solver_stats(),
            "slo": (self.slo_monitor.summary()
                    if self.slo_monitor is not None else None),
            "admission": self.admission.summary(),
            "express": self.express_lane.summary(),
            "capacity": (self.capacity_accountant.summary()
                         if self.config.capacity_config.enabled else None),
            "raft_observe": (self.raft_observatory.summary()
                             if self.config.raft_observe_config.enabled
                             else None),
            "reads": (self.read_observatory.summary()
                      if self.config.reads_config.enabled else None),
            "read_path": self.read_path.summary(),
            "runtime": (self.runtime_observatory.summary()
                        if self.config.profile_config.enabled else None),
            "telemetry": telemetry.snapshot(),
        }

    def solver_stats(self) -> Dict:
        """Device-solver health: the server's device, the coalescer's
        dispatch/batch counters, and the mirror cache's hit and roll
        counts (the port has no device probe or breaker to report)."""
        cache = GLOBAL_MIRROR_CACHE
        return {
            "device": str(self.device),
            "coalesce_dispatches": GLOBAL_SOLVER.dispatches,
            "coalesce_batched_evals": GLOBAL_SOLVER.coalesced,
            "mirror_cache_hits": cache.hits,
            "mirror_cache_misses": cache.misses,
            "mirror_delta_rolls": cache.delta_rolls,
            "mirror_full_rebuilds": cache.full_rebuilds,
            "mirror_rows_restaged": cache.rows_restaged,
        }
