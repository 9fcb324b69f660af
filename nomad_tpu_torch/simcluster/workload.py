"""Seeded workload injectors: deterministic arrival processes.

Port of nomad_tpu/simcluster/workload.py, schedule for schedule: the
streams, ids and payloads are the reference's, so the canonical event
digest of a scenario can be held to the JAX package's.

Each injector owns a ``random.Random`` seeded from ``(run seed, injector
name)`` — the ``nomad_tpu/faults.py`` posture: streams are independent per
injector (adding one injector never shifts another's decisions), and a
fixed seed replays the same action schedule, job ids, counts and mutation
choices run after run. Job shapes are the ``mock.py`` cluster shapes
(exec-driver web tasks, service/batch/system types) with deterministic
ids, so the event stream's per-entity lifecycles are seed-reproducible.

An injector emits :class:`Action` records; the scenario runner executes
them against the server at their offsets. Kinds:

``register_job``   payload: the Job to register (built lazily so every
                   run constructs fresh object graphs); optional
                   ``client_id`` (admission rate-lane identity) and
                   ``impolite`` (no-self-throttling pacing: the runner
                   blasts each client's sequence on its own thread —
                   OverdriveInjector).
``update_job``     payload: job key + mutation ("inplace" bumps cpu by 1
                   — tasks_updated() false, the in-place path;
                   "destructive" changes task env — evict+place).
``deregister_job`` payload: job key — a full Job.Deregister through the
                   RPC front door; the teardown eval stops every alloc
                   (the churn that shreds bin-pack density).
``fail_nodes``     payload: how many nodes to silence; the runner picks
                   the tranche (preferring alloc-hosting nodes so the
                   migration path is actually driven).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from random import Random
from typing import Callable, Dict, List, Optional

from nomad_tpu_torch import structs
from nomad_tpu_torch.structs import (
    Constraint,
    Job,
    Resources,
    RestartPolicy,
    Task,
    TaskGroup,
)


@dataclass(order=True)
class Action:
    at: float
    kind: str = field(compare=False)
    payload: Dict = field(compare=False, default_factory=dict)


def build_job(job_id: str, jtype: str, count: int,
              cpu: int = 100, memory_mb: int = 128,
              datacenters: Optional[List[str]] = None,
              priority: int = 50, express: bool = False) -> Job:
    """A mock.job()-shaped job with a deterministic id; network-free so
    scale runs stay on the columnar batch path (ports are a host-side
    sequential post-pass that only adds runtime, not control-plane
    signal)."""
    return Job(
        region="global",
        id=job_id,
        name=job_id,
        type=jtype,
        priority=priority,
        express=express,
        datacenters=datacenters or ["dc1", "dc2"],
        constraints=[Constraint(
            l_target="$attr.kernel.name", r_target="linux", operand="=",
        )],
        task_groups=[TaskGroup(
            name="web",
            count=count,
            restart_policy=RestartPolicy(
                attempts=1, interval=600.0, delay=5.0,
            ),
            tasks=[Task(
                name="web", driver="exec",
                resources=Resources(cpu=cpu, memory_mb=memory_mb),
            )],
        )],
    )


class Injector:
    """Base: a named, seeded action source."""

    name = "injector"

    def __init__(self, seed: int = 0):
        # Name-salted stream, the faults.py FaultRule posture.
        self.rng = Random(int(seed) ^ zlib.crc32(self.name.encode()))

    def actions(self) -> List[Action]:  # pragma: no cover - interface
        raise NotImplementedError


class SteadyServiceInjector(Injector):
    """Steady-state service arrivals: ``jobs`` service jobs spread over
    ``over`` seconds with jittered inter-arrival gaps."""

    name = "steady-service"

    def __init__(self, seed: int, jobs: int, tasks_per_job: int,
                 over: float, cpu: int = 100, memory_mb: int = 128):
        super().__init__(seed)
        self.jobs = jobs
        self.tasks_per_job = tasks_per_job
        self.over = over
        self.cpu = cpu
        self.memory_mb = memory_mb

    def actions(self) -> List[Action]:
        out = []
        gap = self.over / max(self.jobs, 1)
        t = 0.0
        for k in range(self.jobs):
            jid = f"sim-steady-{k:03d}"
            out.append(Action(
                at=t, kind="register_job",
                payload={"job_key": jid, "build": self._builder(jid)},
            ))
            t += gap * (0.5 + self.rng.random())
        return out

    def _builder(self, jid: str) -> Callable[[], Job]:
        count, cpu, mem = self.tasks_per_job, self.cpu, self.memory_mb
        return lambda: build_job(jid, structs.JOB_TYPE_SERVICE, count,
                                 cpu=cpu, memory_mb=mem)


class BatchBurstInjector(Injector):
    """Batch bursts: at each burst instant, ``jobs_per_burst`` batch jobs
    land at once (one raft-entry-per-job arrival storm — the coalescing
    dequeue's food)."""

    name = "batch-burst"

    def __init__(self, seed: int, bursts: int, jobs_per_burst: int,
                 tasks_per_job: int, gap: float = 5.0,
                 cpu: int = 100, memory_mb: int = 128):
        super().__init__(seed)
        self.bursts = bursts
        self.jobs_per_burst = jobs_per_burst
        self.tasks_per_job = tasks_per_job
        self.gap = gap
        self.cpu = cpu
        self.memory_mb = memory_mb

    def actions(self) -> List[Action]:
        out = []
        for b in range(self.bursts):
            at = b * self.gap
            for k in range(self.jobs_per_burst):
                jid = f"sim-burst-{b:02d}-{k:03d}"
                out.append(Action(
                    at=at, kind="register_job",
                    payload={"job_key": jid, "build": self._builder(jid)},
                ))
        return out

    def _builder(self, jid: str) -> Callable[[], Job]:
        count, cpu, mem = self.tasks_per_job, self.cpu, self.memory_mb
        return lambda: build_job(jid, structs.JOB_TYPE_BATCH, count,
                                 cpu=cpu, memory_mb=mem)


class UpdateChurnInjector(Injector):
    """Update churn over its own base jobs: registers ``base_jobs`` first,
    then fires ``updates`` mutations — in-place resource bumps
    (tasks_updated() false) or destructive env changes (evict+place),
    chosen by the seeded stream."""

    name = "update-churn"

    def __init__(self, seed: int, base_jobs: int, tasks_per_job: int,
                 updates: int, start: float = 1.0, over: float = 6.0,
                 inplace_probability: float = 0.5):
        super().__init__(seed)
        self.base_jobs = base_jobs
        self.tasks_per_job = tasks_per_job
        self.updates = updates
        self.start = start
        self.over = over
        self.inplace_probability = inplace_probability

    def actions(self) -> List[Action]:
        out = []
        for k in range(self.base_jobs):
            jid = f"sim-churnjob-{k:03d}"
            out.append(Action(
                at=0.0, kind="register_job",
                payload={"job_key": jid, "build": self._builder(jid)},
            ))
        gap = self.over / max(self.updates, 1)
        for u in range(self.updates):
            target = f"sim-churnjob-{self.rng.randrange(self.base_jobs):03d}"
            mutation = (
                "inplace"
                if self.rng.random() < self.inplace_probability
                else "destructive"
            )
            out.append(Action(
                at=self.start + u * gap, kind="update_job",
                payload={"job_key": target, "mutation": mutation,
                         "serial": u},
            ))
        return out

    def _builder(self, jid: str) -> Callable[[], Job]:
        count = self.tasks_per_job
        return lambda: build_job(jid, structs.JOB_TYPE_SERVICE, count)


class NodeRefreshInjector(Injector):
    """Steady node-table write load: every ``every`` seconds, ``count``
    live nodes re-register with unchanged fingerprints (the periodic
    client re-registration/fingerprint-refresh posture) — one batched
    node upsert through raft per tick. This is the single-node-write
    pattern the delta-maintained device mirror absorbs: membership and
    mask surface don't move, so each tick should cost one delta roll,
    never a full 10k-row rebuild, and placements are unaffected."""

    name = "node-refresh"

    def __init__(self, seed: int, count: int, every: float,
                 start: float = 0.5, until: float = 10.0):
        super().__init__(seed)
        self.count = count
        self.every = every
        self.start = start
        self.until = until

    def actions(self) -> List[Action]:
        out = []
        t = self.start
        while t < self.until:
            out.append(Action(
                at=t, kind="refresh_nodes",
                payload={"count": self.count, "rng": self.rng},
            ))
            t += self.every
        return out


class OverdriveInjector(Injector):
    """IMPOLITE offered load: ``clients`` independent clients each blast
    ``jobs_per_client`` batch jobs at t=0 with NO self-throttling — the
    runner executes each client's sequence on its own thread, firing the
    next registration the instant the previous response (admit OR typed
    rejection) returns, instead of pacing actions on the shared clock.
    This is the pacing mode the polite injectors lack: steady/burst
    arrivals serialize on one action loop, so the server never sees more
    concurrent front-door pressure than one RPC at a time. Overdrive
    offers clients x jobs x tasks work far beyond capacity and lets the
    admission layer (nomad_tpu/server/admission.py) be the only thing
    standing.

    Determinism posture: the action list (client ids, job ids, shapes)
    is fully seed-determined, and each client's registrations run IN
    ORDER on its own thread — so per-client admission decisions against
    per-client token buckets replay exactly (burst admitted, the rest
    RATE_LIMITED: refill over a sub-second blast at the scenario's tiny
    rates can never mint a token). Cross-client interleaving is
    scheduling noise the canonical event digest already ignores."""

    name = "overdrive"
    pacing = "impolite"

    def __init__(self, seed: int, clients: int, jobs_per_client: int,
                 tasks_per_job: int, cpu: int = 100, memory_mb: int = 128):
        super().__init__(seed)
        self.clients = clients
        self.jobs_per_client = jobs_per_client
        self.tasks_per_job = tasks_per_job
        self.cpu = cpu
        self.memory_mb = memory_mb

    def actions(self) -> List[Action]:
        out = []
        for c in range(self.clients):
            client_id = f"sim-client-{c:03d}"
            for k in range(self.jobs_per_client):
                jid = f"sim-ovr-{c:03d}-{k:03d}"
                out.append(Action(
                    at=0.0, kind="register_job",
                    payload={"job_key": jid, "build": self._builder(jid),
                             "client_id": client_id, "impolite": True},
                ))
        return out

    def _builder(self, jid: str) -> Callable[[], Job]:
        count, cpu, mem = self.tasks_per_job, self.cpu, self.memory_mb
        return lambda: build_job(jid, structs.JOB_TYPE_BATCH, count,
                                 cpu=cpu, memory_mb=mem)


class ExpressStreamInjector(Injector):
    """A stream of express-eligible short tasks riding alongside a
    service background (the express-mix scenario's latency probe): one
    tiny express-flagged batch job every ``every`` seconds with jittered
    gaps, from ``start`` until ``until``. Each submission exercises the
    whole express path — admission's express lane, the leader-local
    sampled pick under a leased reservation, the in-line placed answer,
    and the asynchronous raft commit — and lands exactly one
    ``ExpressPlaced`` event carrying the in-line latency, which is what
    the artifact's ``express_placed_ms`` quantiles (and the
    express_placed_p50_ms SLO gate) reduce."""

    name = "express-stream"

    def __init__(self, seed: int, tasks: int, every: float,
                 start: float = 1.0, until: float = 10.0,
                 tasks_per_job: int = 1, cpu: int = 50,
                 memory_mb: int = 32, priority: int = 20):
        super().__init__(seed)
        self.tasks = tasks
        self.every = every
        self.start = start
        self.until = until
        self.tasks_per_job = tasks_per_job
        self.cpu = cpu
        self.memory_mb = memory_mb
        self.priority = priority

    def actions(self) -> List[Action]:
        out = []
        t = self.start
        k = 0
        while k < self.tasks and t < self.until:
            jid = f"sim-express-{k:05d}"
            out.append(Action(
                at=t, kind="register_job",
                payload={"job_key": jid, "build": self._builder(jid),
                         "client_id": "sim-express-client",
                         "express": True},
            ))
            k += 1
            t += self.every * (0.5 + self.rng.random())
        return out

    def _builder(self, jid: str) -> Callable[[], Job]:
        count, cpu, mem = self.tasks_per_job, self.cpu, self.memory_mb
        prio = self.priority
        return lambda: build_job(jid, structs.JOB_TYPE_BATCH, count,
                                 cpu=cpu, memory_mb=mem, priority=prio,
                                 express=True)


class FragmentationChurnInjector(Injector):
    """Fill → shred → probe: the arrival process that strands capacity.

    Phase 1 (fill): ``fill_jobs`` small-task batch jobs land over
    ``fill_over`` seconds and pack the cell tight (the columnar path —
    high bin-pack density by construction).

    Phase 2 (shred): a SEEDED subset (``dereg_fraction``) of the fill
    jobs deregisters over ``dereg_over`` seconds. Every stop leaves its
    node's remnant free capacity behind — aggregate free grows, but it
    is scattered across partially-occupied nodes: bin-pack density
    drops and capacity strands against the larger reference shapes.

    Phase 3 (probe): ``probe_jobs`` service jobs with a CHUNKY task
    shape (``probe_cpu``/``probe_memory_mb``, sized so only
    well-drained nodes fit one) arrive into the shredded cell — the
    workload whose placement quality the future defragmenter is
    supposed to rescue. The capacity observatory's stranded-% and the
    solver panel's padding-waste trajectories across these phases ARE
    the banked artifact this scenario exists to produce.

    Fully seed-determined: job ids, shapes, the deregistration subset
    and all pacing derive from the injector's name-salted stream, so
    the canonical event digest replays."""

    name = "fragmentation-churn"

    def __init__(self, seed: int, fill_jobs: int, tasks_per_job: int,
                 dereg_fraction: float = 0.5,
                 probe_jobs: int = 3, probe_tasks: int = 150,
                 fill_over: float = 6.0, dereg_start: float = 8.0,
                 dereg_over: float = 4.0, probe_start: float = 14.0,
                 probe_over: float = 3.0,
                 fill_cpu: int = 100, fill_memory_mb: int = 128,
                 probe_cpu: int = 1500, probe_memory_mb: int = 1024):
        super().__init__(seed)
        self.fill_jobs = fill_jobs
        self.tasks_per_job = tasks_per_job
        self.dereg_fraction = dereg_fraction
        self.probe_jobs = probe_jobs
        self.probe_tasks = probe_tasks
        self.fill_over = fill_over
        self.dereg_start = dereg_start
        self.dereg_over = dereg_over
        self.probe_start = probe_start
        self.probe_over = probe_over
        self.fill_cpu = fill_cpu
        self.fill_memory_mb = fill_memory_mb
        self.probe_cpu = probe_cpu
        self.probe_memory_mb = probe_memory_mb

    def actions(self) -> List[Action]:
        out = []
        gap = self.fill_over / max(self.fill_jobs, 1)
        for k in range(self.fill_jobs):
            jid = f"sim-frag-fill-{k:03d}"
            out.append(Action(
                at=k * gap, kind="register_job",
                payload={"job_key": jid,
                         "build": self._builder(
                             jid, structs.JOB_TYPE_BATCH,
                             self.tasks_per_job, self.fill_cpu,
                             self.fill_memory_mb)},
            ))
        n_dereg = int(round(self.fill_jobs * self.dereg_fraction))
        victims = self.rng.sample(range(self.fill_jobs), n_dereg)
        dgap = self.dereg_over / max(n_dereg, 1)
        for i, k in enumerate(victims):
            out.append(Action(
                at=self.dereg_start + i * dgap, kind="deregister_job",
                payload={"job_key": f"sim-frag-fill-{k:03d}"},
            ))
        pgap = self.probe_over / max(self.probe_jobs, 1)
        for k in range(self.probe_jobs):
            jid = f"sim-frag-probe-{k:03d}"
            out.append(Action(
                at=self.probe_start + k * pgap, kind="register_job",
                payload={"job_key": jid,
                         "build": self._builder(
                             jid, structs.JOB_TYPE_SERVICE,
                             self.probe_tasks, self.probe_cpu,
                             self.probe_memory_mb)},
            ))
        return out

    @staticmethod
    def _builder(jid: str, jtype: str, count: int, cpu: int,
                 mem: int) -> Callable[[], Job]:
        return lambda: build_job(jid, jtype, count, cpu=cpu, memory_mb=mem)


class LeaderRestartInjector(Injector):
    """Kill-and-recover: at ``at`` seconds the runner shuts the leader
    down mid-load and restarts it from its durable raft state (same
    data dir, same RPC port) — ROADMAP item 2's cold-restart-under-load
    ask. The runner handles the mechanics (event-stream dedup by raft
    index across the restart, fleet reconnection, recovery-timeline
    capture); this injector only schedules the cut. Requires a spec
    with ``durable_raft`` — an in-memory leader has nothing to recover
    from."""

    name = "leader-restart"

    def __init__(self, seed: int, at: float):
        super().__init__(seed)
        self.at = at

    def actions(self) -> List[Action]:
        return [Action(at=self.at, kind="restart_leader", payload={})]


class ReadFleetInjector(Injector):
    """IMPOLITE read pressure: the seeded follower-read fleet the
    read-path observatory (nomad_tpu/read_observe.py) is judged against.

    One ``read_storm`` action schedules the whole fleet; the runner
    lazily stands up a loopback HTTP front end over the live server and
    drives three reader populations on their own threads until
    ``until``:

    - ``pollers`` tight-loop plain GETs over the list endpoints
      (/v1/jobs, /v1/nodes, /v1/allocations, /v1/evaluations) at
      ``poll_interval`` pacing with per-reader seeded jitter — the
      cheap-but-rude dashboard-refresh population.
    - ``watchers`` long-poll the same endpoints with
      ``?index=N&wait=`` blocking queries, advancing their cursor on
      each X-Nomad-Index — the well-behaved change-notification
      population whose register→wake hold time the observatory's
      hold/serve partition attributes.
    - ``sse_tails`` hold ``/v1/event/stream?format=sse`` sessions open
      and count frames — the firehose population the SSE session books
      (lag vs broker head, Truncated accounting) exist for.

    Reads never touch the decision path — the action list and every
    reader's pacing jitter are seed-determined so the CLIENT-side
    request counts replay, and the canonical event digest is
    read-invariant by construction (reads publish nothing)."""

    name = "read-fleet"

    def __init__(self, seed: int, pollers: int = 4, watchers: int = 4,
                 sse_tails: int = 2, poll_interval: float = 0.2,
                 start: float = 0.5, duration: float = 10.0,
                 max_stale_ms: float = 5000.0):
        super().__init__(seed)
        self.pollers = pollers
        self.watchers = watchers
        self.sse_tails = sse_tails
        self.poll_interval = poll_interval
        self.start = start
        self.duration = duration
        # Staleness bound the fleet's stale-lane opt-in carries
        # (?stale=1&max_stale=) when the cell serves follower reads —
        # the bound the artifact's stale-age-p95 gate is judged against.
        self.max_stale_ms = max_stale_ms

    def actions(self) -> List[Action]:
        # Per-reader pacing jitter is drawn HERE, from the injector's
        # name-salted stream, so the fleet's offered load replays without
        # the runner threads sharing an rng.
        jitters = [round(0.5 + self.rng.random(), 6)
                   for _ in range(self.pollers)]
        return [Action(
            at=self.start, kind="read_storm",
            payload={
                "pollers": self.pollers,
                "watchers": self.watchers,
                "sse_tails": self.sse_tails,
                "poll_interval": self.poll_interval,
                "poll_jitters": jitters,
                "max_stale_ms": self.max_stale_ms,
                "until": self.start + self.duration,
            },
        )]


class NodeChurnInjector(Injector):
    """Node-failure churn: silence ``count`` nodes at ``at`` seconds. The
    runner resolves the tranche (preferring alloc-hosting nodes with this
    injector's stream) so TTL expiry drives real migrations."""

    name = "node-churn"

    def __init__(self, seed: int, count: int, at: float):
        super().__init__(seed)
        self.count = count
        self.at = at

    def actions(self) -> List[Action]:
        return [Action(
            at=self.at, kind="fail_nodes",
            payload={"count": self.count, "rng": self.rng},
        )]
