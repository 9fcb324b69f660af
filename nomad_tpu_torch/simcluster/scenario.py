"""Scenario runner: named scale scenarios against a real ClusterServer.

Port of nomad_tpu/simcluster/scenario.py over the port's ClusterServer,
RPC tier and device. One scenario = one ``ClusterServer`` cell (real RPC
listener, real raft log, real workers and solver on ``device``), one
:class:`SimFleet` and a set of seeded injectors. Progress is observed
through the cluster event stream
(``nomad_tpu_torch/events.py``), and every run emits one JSON artifact:
placements/s, plan and eval latency quantiles, broker and plan-queue
peaks, heartbeat-timer load, the mirror's delta economy, the plan
pipeline's books, the solver panel's window and the canonical event
digest, the sorted multiset of per-key event-type sequences that a replay
with the same seed, or nomad_tpu's runner on the same scenario and seed,
must reproduce.

``device`` defaults to the CUDA card (``device.resolve_device``: no card
raises, there is no CPU fallback) and goes into every member's
``ServerConfig``; tests pass ``device="cpu"``. The runner binds the port's
``GLOBAL_SOLVER``, ``GLOBAL_MIRROR_CACHE``, ``SOLVER_PANEL`` and
``warm_batch_shapes``, never nomad_tpu's. The artifact's ``backend`` is
the torch device, with the card's name on CUDA.

The artifact carries nomad_tpu's admission (the controller's books next
to the injector's experience of the door), express, capacity (the
accountant's 2 Hz trajectory and final snapshot), raft (the write-path
partition, log economy and, after a leader restart, the recovery
timeline with the placements-survived verdict), reads (with the
consistency lanes' verdict block), profile (the runtime observatory's
role wall shares, the lock watchdog's contention table and the byte
ledger with its 1M-row projection), ``latency_attribution`` and ``slo``
sections, and for the chaos families (``simcluster/chaos.py``) the armed
storm's ``faults`` books and the ``chaos`` verdict.
``attribution_layer=False`` runs the tracer off and the SLO monitor
unbuilt; those two sections are then None.

An attributed run with the profiler on installs
``telemetry.port_lock_watchdog()`` (the lock-order analysis of the port's
own sources) for its span, and uninstalls it after; the contrast arms
run without it. steady-10k's profiler-off contrast arm carries the
``profiler_overhead`` verdict.

Every scenario of nomad_tpu's registry, the three chaos families
included, runs in this package. Server overrides go to each member's
``ServerConfig`` as nomad_tpu's runner passes them, ``tls`` included.

The read fleet (``read_storm`` actions) talks HTTP to loopback fronts of
the port's ``api/http.py``: one on the leader, and with the read plane on
one per follower, which the fleet rotates across.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import logging
import math
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from nomad_tpu_torch import faults, lifecycle, slo, structs, telemetry
from nomad_tpu_torch.api.codec import to_dict
from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.rpc import RemoteError
from nomad_tpu_torch.server.cluster import (
    ClusterConfig,
    ClusterServer,
    wait_for_leader,
)
from nomad_tpu_torch.server.server import ServerConfig
from nomad_tpu_torch.simcluster.simnode import SimFleet, sim_node
from nomad_tpu_torch.structs import parse_reject
from nomad_tpu_torch.simcluster.workload import (
    Action,
    BatchBurstInjector,
    ExpressStreamInjector,
    FragmentationChurnInjector,
    LeaderRestartInjector,
    NodeChurnInjector,
    NodeRefreshInjector,
    OverdriveInjector,
    ReadFleetInjector,
    SteadyServiceInjector,
    UpdateChurnInjector,
    build_job,
)

SCHEMA_VERSION = 1

@dataclass
class ScenarioSpec:
    name: str
    n_nodes: int
    injectors: Callable[[int], List]  # seed -> injector list
    quiesce_timeout: float = 120.0
    # Server knobs merged over the scenario default config.
    server_overrides: Dict = field(default_factory=dict)
    # Optional faults {} block armed (with the run seed) for the window
    # (the chaos families' storms).
    faults_spec: Optional[Dict] = None
    # Warmup job size: warms the node bucket's water-fill + batch
    # shapes before the measured window (0 skips).
    warmup_count: int = 300
    # How many placed allocs the fleet acknowledges after quiescence
    # (client_status=running through Node.UpdateAlloc); bounded because
    # acking a columnar member promotes it to an object row.
    ack_cap: int = 200
    # Whether same-seed runs are expected to reproduce the canonical
    # event digest (node-failure churn depends on which nodes host
    # allocs, which concurrent placement does not pin).
    deterministic: bool = True
    # Optional CONTRAST arm: server-override deltas for a second run
    # whose trimmed summary lands in the artifact's "contrast" section.
    contrast_overrides: Optional[Dict] = None
    # Whether the contrast arm must reproduce the MAIN arm's canonical
    # event digest (an observer switched off must be decision-invariant).
    contrast_digest_invariant: bool = False
    # Durable raft state: the runner creates a temp data dir so every
    # entry journals (the restart scenarios). Cleaned up after.
    durable_raft: bool = False
    # ClusterConfig overrides (snapshot_threshold, trailing_logs, ...).
    cluster_overrides: Dict = field(default_factory=dict)
    # Raft cluster size. 1 is the classic single-member runner path; >1
    # stands up a real multi-member cell (shared peers table, one elected
    # leader, the fleet pointed at it).
    cluster_members: int = 1
    # Chaos verdict hook (simcluster/chaos.py): called as
    # chaos_check(runner, srv, artifact) after the artifact is built;
    # returns the artifact's "chaos" section and raises on a violated
    # invariant (exactly-once re-placement, duplicate PlanApplied, a
    # rejoined follower whose FSM digest diverged).
    chaos_check: Optional[Callable] = None
    description: str = ""


def _spec_registry() -> Dict[str, ScenarioSpec]:
    """nomad_tpu's registry, spec for spec."""
    return {
        "steady-1k": ScenarioSpec(
            name="steady-1k", n_nodes=1000,
            injectors=lambda seed: [SteadyServiceInjector(
                seed, jobs=6, tasks_per_job=260, over=3.0,
            )],
            quiesce_timeout=90.0, ack_cap=150,
            description="tier-1 smoke: 1k nodes, 6 service jobs x260 "
                        "tasks arriving over ~3s (1560 placements, "
                        "columnar path)",
        ),
        "steady-10k": ScenarioSpec(
            name="steady-10k", n_nodes=10_000,
            injectors=lambda seed: [
                SteadyServiceInjector(
                    seed, jobs=24, tasks_per_job=420, over=18.0,
                ),
                # Steady node-write load riding the placement window: the
                # fingerprint-refresh posture whose single-node upserts
                # the delta mirror must absorb without full rebuilds
                # (the artifact's "mirror" section proves it).
                NodeRefreshInjector(
                    seed, count=12, every=0.9, start=0.7, until=17.5,
                ),
            ],
            quiesce_timeout=300.0, ack_cap=300,
            # Profiler-off contrast arm: the runtime self-observatory on
            # vs off must leave the canonical digest byte-identical.
            contrast_overrides={"profile": {"enabled": False}},
            contrast_digest_invariant=True,
            description="the north-star control-plane scale: 10k live "
                        "nodes, 24 service jobs x420 tasks over ~18s "
                        "(10,080 placements) under steady node-refresh "
                        "writes (12 re-registrations every ~0.9s)",
        ),
        "steady-100k-nodes": ScenarioSpec(
            name="steady-100k-nodes", n_nodes=100_000,
            injectors=lambda seed: [SteadyServiceInjector(
                seed, jobs=24, tasks_per_job=420, over=24.0,
            )],
            server_overrides={
                # 100k/10 = 10000s TTLs: beats never come due inside the
                # run, so loaded-box beat starvation can't expire live
                # nodes.
                "max_heartbeats_per_second": 10.0,
                # The 100k-node registration tranche events + the
                # steady-10k-shaped placement flow must fit the 20 Hz
                # watcher's poll stride without ring truncation.
                "event_buffer_size": 32768,
            },
            quiesce_timeout=900.0, ack_cap=0,
            description="ROADMAP item 1's node-axis proof: the steady-10k "
                        "service workload (24 jobs x420 tasks over ~24s) "
                        "against a 100k-node cell — the mirror pads to "
                        "the 131072-row bucket and every solve scores "
                        "every node; the solver panel's device-time-per-"
                        "placement is the meter the 'same warm-path cost "
                        "class as 10k' claim is judged against",
        ),
        "burst-100k": ScenarioSpec(
            name="burst-100k", n_nodes=10_000,
            injectors=lambda seed: [BatchBurstInjector(
                seed, bursts=1, jobs_per_burst=8, tasks_per_job=12_500,
            )],
            quiesce_timeout=420.0, ack_cap=0,
            description="one 100k-task burst (8 batch jobs x12.5k) at 10k "
                        "nodes — the BASELINE config-3 ask through the "
                        "whole pipeline",
        ),
        "overdrive-1k": ScenarioSpec(
            name="overdrive-1k", n_nodes=400,
            injectors=lambda seed: [OverdriveInjector(
                seed, clients=6, jobs_per_client=8, tasks_per_job=20,
            )],
            server_overrides={
                "admission": {"client_rate": 0.05, "client_burst": 2},
                "eval_pending_cap": 128,
                "plan_queue_cap": 64,
                "event_buffer_size": 8192,
                "max_heartbeats_per_second": 2.0,
            },
            quiesce_timeout=120.0, ack_cap=0, warmup_count=100,
            description="tier-1 overdrive smoke: 6 impolite clients x8 "
                        "batch jobs x20 tasks blast a 400-node cell; "
                        "admission rate lanes admit 2/client (burst), "
                        "the rest reject RATE_LIMITED typed",
        ),
        "overdrive-100k": ScenarioSpec(
            name="overdrive-100k", n_nodes=10_000,
            injectors=lambda seed: [OverdriveInjector(
                seed, clients=5, jobs_per_client=50, tasks_per_job=400,
            )],
            server_overrides={
                "admission": {"client_rate": 0.02, "client_burst": 1},
                "eval_pending_cap": 128,
                "plan_queue_cap": 64,
                "event_buffer_size": 16384,
                "max_heartbeats_per_second": 10.0,
                "scheduler_workers": 8,
                "eval_batch_size": 1,
            },
            contrast_overrides={
                "admission": {"enabled": False},
                "eval_pending_cap": 0,
                "plan_queue_cap": 0,
                "event_buffer_size": 16384,
                "max_heartbeats_per_second": 10.0,
                "scheduler_workers": 8,
                "eval_batch_size": 4,
            },
            quiesce_timeout=600.0, ack_cap=0,
            description="the impolite front-door proof: 5 clients blast "
                        "250 batch jobs (100k tasks offered) at a 10k-"
                        "node cell with no self-throttling; admission ON "
                        "admits 1/client (5 jobs, 2000 tasks) and "
                        "rejects the rest RATE_LIMITED typed, keeping "
                        "admitted p95 submit-to-placed under the 250ms "
                        "SLO with every queue bounded; the contrast arm "
                        "re-runs with admission OFF and documents the "
                        "unbounded-queue latency cliff",
        ),
        "express-1k": ScenarioSpec(
            name="express-1k", n_nodes=400,
            injectors=lambda seed: [
                SteadyServiceInjector(
                    seed, jobs=3, tasks_per_job=60, over=2.0,
                ),
                ExpressStreamInjector(
                    seed, tasks=40, every=0.06, start=0.5, until=5.0,
                ),
            ],
            server_overrides={
                "express": {"enabled": True},
                "event_buffer_size": 8192,
                "max_heartbeats_per_second": 2.0,
            },
            quiesce_timeout=90.0, ack_cap=0, warmup_count=100,
            description="tier-1 express smoke: 400 nodes, a small "
                        "service background plus a 40-task express "
                        "stream through the leader-local lane "
                        "(sub-ms in-line placement, async commit)",
        ),
        "express-mix": ScenarioSpec(
            name="express-mix", n_nodes=10_000,
            injectors=lambda seed: [
                SteadyServiceInjector(
                    seed, jobs=24, tasks_per_job=420, over=18.0,
                ),
                NodeRefreshInjector(
                    seed, count=12, every=0.9, start=0.7, until=17.5,
                ),
                ExpressStreamInjector(
                    seed, tasks=300, every=0.05, start=2.0, until=17.0,
                ),
            ],
            server_overrides={
                "express": {"enabled": True},
                "event_buffer_size": 8192,
            },
            quiesce_timeout=300.0, ack_cap=0,
            description="the latency-floor proof: steady-10k's service "
                        "load + node-refresh writes, with a ~300-task "
                        "express stream placed in-line by the leader-"
                        "local lane under leased reservations — "
                        "express p50 submit→placed < 1ms while the "
                        "service lane keeps its 250ms SLO",
        ),
        "churn-frag-200": ScenarioSpec(
            name="churn-frag-200", n_nodes=200,
            injectors=lambda seed: [FragmentationChurnInjector(
                seed, fill_jobs=6, tasks_per_job=400,
                dereg_fraction=0.5, probe_jobs=2, probe_tasks=40,
                fill_over=2.0, dereg_start=3.0, dereg_over=1.5,
                probe_start=5.0, probe_over=1.0,
            )],
            server_overrides={
                "capacity": {"poll_interval": 0.25,
                             "events_interval": 2.0},
                "event_buffer_size": 16384,
                "max_heartbeats_per_second": 2.0,
            },
            contrast_overrides={
                "capacity": {"enabled": False},
                "event_buffer_size": 16384,
                "max_heartbeats_per_second": 2.0,
            },
            contrast_digest_invariant=True,
            quiesce_timeout=120.0, ack_cap=0, warmup_count=100,
            description="tier-1 observatory smoke: 200 nodes, 6 fill "
                        "jobs x400 small tasks, half deregistered, a "
                        "chunky probe wave — capacity/solver "
                        "trajectories banked, observatory-off contrast "
                        "arm digest-equal",
        ),
        "churn-fragmentation": ScenarioSpec(
            name="churn-fragmentation", n_nodes=600,
            injectors=lambda seed: [FragmentationChurnInjector(
                seed, fill_jobs=18, tasks_per_job=1000,
                dereg_fraction=0.5, probe_jobs=3, probe_tasks=150,
                fill_over=6.0, dereg_start=8.0, dereg_over=4.0,
                probe_start=14.0, probe_over=3.0,
                probe_cpu=800, probe_memory_mb=768,
            )],
            server_overrides={
                "capacity": {"poll_interval": 0.25,
                             "events_interval": 5.0},
                "event_buffer_size": 32768,
                "max_heartbeats_per_second": 2.0,
            },
            contrast_overrides={
                "capacity": {"enabled": False},
                "event_buffer_size": 32768,
                "max_heartbeats_per_second": 2.0,
            },
            contrast_digest_invariant=True,
            quiesce_timeout=300.0, ack_cap=0,
            description="the fragmentation baseline the defrag arc is "
                        "judged against: 18 batch jobs x1000 small "
                        "tasks pack a 600-node cell to ~75% cpu, a "
                        "seeded half deregisters (density shreds, "
                        "capacity strands), then 3 chunky service "
                        "probe jobs land in the wreckage; the "
                        "capacity observatory banks stranded-% and "
                        "padding-waste trajectories, and an "
                        "observatory-off contrast arm proves digest "
                        "equality (decision invariance)",
        ),
        "read-storm": ScenarioSpec(
            name="read-storm", n_nodes=10_000,
            injectors=lambda seed: [
                SteadyServiceInjector(
                    seed, jobs=24, tasks_per_job=420, over=18.0,
                ),
                NodeRefreshInjector(
                    seed, count=12, every=0.9, start=0.7, until=17.5,
                ),
                ReadFleetInjector(
                    seed, pollers=6, watchers=6, sse_tails=3,
                    poll_interval=0.3, start=1.0, duration=16.0,
                    max_stale_ms=5000.0,
                ),
            ],
            cluster_members=3,
            cluster_overrides={
                "election_timeout_min": 2.5,
                "election_timeout_max": 5.0,
                "heartbeat_interval": 0.1,
            },
            server_overrides={
                "reads": {"poll_interval": 0.25, "events_interval": 2.0},
            },
            contrast_overrides={
                "reads": {"enabled": False},
                "read_path": {"enabled": False},
            },
            contrast_digest_invariant=True,
            quiesce_timeout=300.0, ack_cap=0,
            description="the follower-read-plane proof: the steady-10k "
                        "write load (24 service jobs x420 tasks over "
                        "~18s, node-refresh writes riding along) on a "
                        "3-member cell while a seeded impolite read "
                        "fleet (6 pollers, 6 blocking watchers, 3 SSE "
                        "tails) rides the FOLLOWERS' front ends — stale "
                        "lane under a 5s bound, every 5th poll "
                        "linearizable via the leader's read-index "
                        "lease; the reads section banks the serving "
                        "books per member plus the lanes verdict "
                        "(follower serve share, staleness-age "
                        "distribution, read-index floor), and a leader-"
                        "only contrast arm (lanes+observatory OFF) "
                        "proves digest equality while exhibiting the "
                        "leader pile-up the plane relieves",
        ),
        "read-storm-800": ScenarioSpec(
            name="read-storm-800", n_nodes=800,
            injectors=lambda seed: [
                SteadyServiceInjector(
                    seed, jobs=6, tasks_per_job=120, over=3.0,
                ),
                ReadFleetInjector(
                    seed, pollers=2, watchers=2, sse_tails=1,
                    poll_interval=0.15, start=0.5, duration=4.0,
                    max_stale_ms=5000.0,
                ),
            ],
            cluster_members=3,
            cluster_overrides={
                "election_timeout_min": 2.5,
                "election_timeout_max": 5.0,
                "heartbeat_interval": 0.1,
            },
            server_overrides={
                "reads": {"poll_interval": 0.2, "events_interval": 1.0},
                "event_buffer_size": 8192,
                "max_heartbeats_per_second": 2.0,
            },
            contrast_overrides={
                "reads": {"enabled": False},
                "read_path": {"enabled": False},
                "event_buffer_size": 8192,
                "max_heartbeats_per_second": 2.0,
            },
            contrast_digest_invariant=True,
            quiesce_timeout=120.0, ack_cap=0, warmup_count=100,
            description="tier-1 read-path smoke: 800 nodes x 3-member "
                        "cell, 6 service jobs x120 tasks under a small "
                        "impolite read fleet (2 pollers, 2 blocking "
                        "watchers, 1 SSE tail) served by the FOLLOWER "
                        "fronts on the stale/linearizable lanes; reads "
                        "+ lanes sections banked, leader-only contrast "
                        "arm digest-equal",
        ),
        "restart-under-load": ScenarioSpec(
            name="restart-under-load", n_nodes=10_000,
            injectors=lambda seed: [
                SteadyServiceInjector(
                    seed, jobs=24, tasks_per_job=420, over=18.0,
                ),
                LeaderRestartInjector(seed, at=9.0),
            ],
            durable_raft=True,
            cluster_overrides={
                "snapshot_threshold": 64,
                "trailing_logs": 16,
            },
            server_overrides={
                "event_buffer_size": 16384,
                "max_heartbeats_per_second": 10.0,
            },
            quiesce_timeout=600.0, ack_cap=0,
            description="ROADMAP item 2's kill-and-recover proof, "
                        "measurement half: the steady-10k service "
                        "workload (24 jobs x420 tasks over ~18s) at 10k "
                        "nodes with a DURABLE raft log (journal + "
                        "compressed snapshot cadence); at t=9s the "
                        "leader is killed outright and restarted from "
                        "its data dir on the same port — every pre-kill "
                        "placement must survive the replay, in-flight "
                        "evals redeliver and finish, the canonical "
                        "event digest stays seed-deterministic across "
                        "the cut (events dedup by raft index), and the "
                        "artifact banks the recovery timeline "
                        "(snapshot-restore wall, entries replayed, "
                        "replay rate, time-to-leader/serving)",
        ),
        "restart-800": ScenarioSpec(
            name="restart-800", n_nodes=800,
            injectors=lambda seed: [
                SteadyServiceInjector(
                    seed, jobs=6, tasks_per_job=120, over=4.0,
                ),
                LeaderRestartInjector(seed, at=2.0),
            ],
            durable_raft=True,
            cluster_overrides={"snapshot_threshold": 24,
                               "trailing_logs": 8},
            server_overrides={
                "event_buffer_size": 8192,
                "max_heartbeats_per_second": 2.0,
            },
            quiesce_timeout=120.0, ack_cap=0, warmup_count=100,
            description="tier-1 restart smoke: 800 nodes, 6 service "
                        "jobs x120 tasks, leader killed and restarted "
                        "from durable state at t=2s — placements "
                        "survive, recovery timeline populated",
        ),
        "churn": ScenarioSpec(
            name="churn", n_nodes=2000,
            injectors=lambda seed: [
                SteadyServiceInjector(seed, jobs=4, tasks_per_job=150,
                                      over=2.0),
                UpdateChurnInjector(seed, base_jobs=2, tasks_per_job=150,
                                    updates=4, start=2.5, over=4.0),
                NodeChurnInjector(seed, count=40, at=7.0),
            ],
            # Compressed TTLs so a silenced node expires inside the run;
            # the floor leaves the fleet a >=1s beat margin (beats land at
            # 0.8*ttl).
            server_overrides={"min_heartbeat_ttl": 5.0,
                              "max_heartbeats_per_second": 2000.0},
            quiesce_timeout=180.0, ack_cap=100, deterministic=False,
            description="mixed churn at 2k nodes: service arrivals, "
                        "in-place/destructive update churn, and a 40-node "
                        "failure tranche expiring through real TTLs",
        ),
    }


SCENARIOS = _spec_registry()


def canonical_events(events) -> Dict:
    """The determinism reduction: group events by key, keep each group's
    type sequence in publish order, and digest the sorted multiset of
    those sequences. Which uuid an eval got and how two workers' groups
    interleaved globally is scheduling noise; what happened to each
    entity, in order, is the replay contract.

    Observer topics (events.OBSERVER_TOPICS) and the "Fault" topic are
    excluded by construction: they publish on a wall-clock cadence (or
    per retry attempt), so how many land in a run is box-speed noise."""
    from nomad_tpu_torch.events import OBSERVER_TOPICS

    excluded = OBSERVER_TOPICS | {"Fault"}
    groups: Dict[str, List[str]] = {}
    by_type: Dict[str, int] = {}
    for e in events:
        if e.topic in excluded:
            continue
        groups.setdefault(e.key, []).append(e.type)
        by_type[e.type] = by_type.get(e.type, 0) + 1
    multiset = sorted(tuple(v) for v in groups.values())
    digest = hashlib.sha256(
        json.dumps(multiset, separators=(",", ":")).encode()
    ).hexdigest()
    return {
        "digest": digest,
        "groups": len(multiset),
        "by_type": dict(sorted(by_type.items())),
    }


def _quantiles(samples: List[float]) -> Dict:
    if not samples:
        return {"n": 0}
    s = sorted(samples)

    def q(p: float) -> float:
        idx = min(len(s) - 1, max(0, int(round(p * (len(s) - 1)))))
        return s[idx]

    return {
        "n": len(s),
        "p50_ms": round(q(0.50) * 1000, 2),
        "p95_ms": round(q(0.95) * 1000, 2),
        "max_ms": round(s[-1] * 1000, 2),
    }


class _HttpShim:
    """Minimal agent facade for the read fleet's loopback HTTP front end
    on the leader: the read handlers reach only ``agent.server``, resolved
    per request to the runner's current server."""

    def __init__(self, runner: "ScenarioRunner"):
        self._runner = runner

    @property
    def server(self):
        return self._runner._srv

    def leader_addr(self) -> str:
        srv = self._runner._srv
        return srv.rpc_addr if srv.raft.is_leader else ""


class _MemberHttpShim:
    """Agent facade pinned to ONE cell member: the follower read plane's
    front end. It serves the same member for its whole life, so the lane
    books (role, staleness age, read-index waits) are attributed to the
    server that answered."""

    def __init__(self, member):
        self._member = member

    @property
    def server(self):
        return self._member

    def leader_addr(self) -> str:
        if self._member.raft.is_leader:
            return self._member.rpc_addr
        return self._member.raft.leader_addr or ""


class ScenarioRunner:
    def __init__(self, spec: ScenarioSpec, seed: int = 42,
                 logger: Optional[logging.Logger] = None,
                 n_nodes: Optional[int] = None,
                 attribution_layer: bool = True,
                 device=None):
        self.spec = spec
        self.seed = int(seed)
        self.n_nodes = int(n_nodes or spec.n_nodes)
        # False runs the identical scenario with the attribution layer off
        # (tracer disabled, SLO monitor unbuilt). Decisions must not depend
        # on it (digest-pinned).
        self.attribution_layer = bool(attribution_layer)
        self.device = resolve_device(device)
        self.logger = logger or logging.getLogger("nomad_tpu_torch.simcluster")
        self._events: List = []
        self._events_lock = threading.Lock()
        self._truncated = False
        self._stop = threading.Event()
        self.peaks = {"broker_ready": 0, "broker_unacked": 0,
                      "broker_blocked": 0, "plan_queue_depth": 0}
        # (t, cumulative plans, cumulative conflicts) at 10 Hz — the
        # conflict-rate-vs-load raw series.
        self._pipe_samples: List = []
        self._srv: Optional[ClusterServer] = None
        self._jobs: Dict[str, object] = {}
        # The front door as the injector experiences it: offered
        # registrations and typed rejections by reason (the artifact's
        # admission.injector view, beside the controller's own books).
        self._offer_lock = threading.Lock()
        self._offered = 0
        self._rejected: Dict[str, int] = {}
        # Capacity-observatory and solver-panel trajectories, sampled at
        # 2 Hz by the depth sampler (the capacity one when the
        # observatory is on).
        self._capacity_samples: List[Dict] = []
        self._panel_samples: List[Dict] = []
        self._t_measure0 = 0.0
        self._panel0: Optional[Dict] = None
        # Restart bookkeeping (restart_leader): the event watcher's
        # raft-index floor (replayed events at or below it are dupes of
        # collected ones and are dropped), per-server counter baselines
        # carried across the restart (a fresh server's pipeline and
        # heartbeat books start at zero), and the restart verdict block.
        self._raft_floor = 0
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._pipe0: Dict = {}
        self._pipe_carry: Dict = {}
        self._hb0: Dict = {}
        self._hb_carry: Dict = {}
        self._data_dir: Optional[str] = None
        self._restart: Optional[Dict] = None
        # Multi-member bookkeeping (cluster_members > 1): every live
        # member (leader first after election), the shared peers table a
        # restarted member rejoins through, the killed-follower book
        # (kill_follower -> restart_follower), the rejoin-poll thread,
        # and the chaos book the spec's chaos_check reduces into the
        # artifact's chaos section.
        self._members: List[ClusterServer] = []
        self._peers: Dict[str, str] = {}
        self._downed: Optional[Dict] = None
        self._rejoin_thread: Optional[threading.Thread] = None
        self._chaos: Dict = {}
        # Read fleet: the leader's loopback HTTP front (started at the
        # first storm), one front per follower when the lanes are on, the
        # reader threads and their client-side books, and the lane books
        # (staleness ages off X-Nomad-LastContact, read-index violations,
        # missing freshness stamps) behind the reads.lanes section.
        self._http = None
        self._follower_https: List = []
        self._readers: List[threading.Thread] = []
        self._reader_stats: List[Dict] = []
        self._t_actions0 = 0.0
        self._lane_lock = threading.Lock()
        self._lane_books: Dict[str, int] = {
            "follower_dialed": 0, "leader_dialed": 0,
            "stale_reads": 0, "stale_refused": 0,
            "linear_reads": 0, "linear_violations": 0,
            "stamp_missing": 0,
        }
        self._stale_ages_ms: List[float] = []
        self._stale_bound_ms = 0.0

    # -- observation --------------------------------------------------------

    def _start_watcher(self, broker, cursor: int) -> None:
        """Tail one event broker into the run's event list. A leader
        restart stops the old server's watcher (final page included) and
        starts a fresh one on the restarted server's broker with the
        raft-index floor set, so the replayed prefix dedups instead of
        double-counting."""
        self._watch_stop = threading.Event()
        self._watch_thread = threading.Thread(
            target=self._watch_events,
            args=(broker, cursor, self._watch_stop),
            daemon=True, name="sim-events")
        self._watch_thread.start()

    def _stop_watcher(self) -> None:
        self._watch_stop.set()
        t = self._watch_thread
        if t is not None:
            t.join(timeout=10.0)

    def _watch_events(self, broker, cursor: int, stop) -> None:
        while True:
            done = stop.is_set()  # one last page after the stop
            latest, evs, truncated = broker.events_after(cursor)
            if truncated:
                self._truncated = True
            if evs:
                self._take_events(evs)
                cursor = latest
            if done:
                return
            time.sleep(0.05)

    def _take_events(self, evs) -> None:
        """Collect a page, dropping post-restart replay dupes: an event
        re-published by log replay carries the same raft index as its
        pre-kill original (the FSM apply is deterministic), so everything
        at or below the kill-time applied index is already collected.
        Observer-born events (raft_index 0) always pass; their topics are
        digest-excluded anyway."""
        floor = self._raft_floor
        if floor:
            evs = [e for e in evs if not (0 < e.raft_index <= floor)]
        if evs:
            with self._events_lock:
                self._events.extend(evs)

    def _sample_depths(self, srv) -> None:
        from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

        capacity_on = srv.config.capacity_config.enabled
        tick = 0
        while not self._stop.wait(0.1):
            # Re-read per tick: a leader restart swaps the server out
            # from under the sampler mid-run.
            srv = self._srv
            tick += 1
            if tick % 5 == 0:
                # 2 Hz: roll the capacity accountant to the store's
                # current generation (the change-log consumption its own
                # poll does) and sample its headline aggregates, beside
                # the solver panel's raw padded-axis sums, which the
                # artifact differences into in-window waste series.
                # Guarded: an observatory error must not kill the thread
                # that also tracks the broker and plan-queue peaks.
                try:
                    now = time.perf_counter()
                    if capacity_on:
                        acct = srv.capacity_accountant
                        acct.refresh()
                        snap = acct.snapshot()
                        self._capacity_samples.append({
                            "t": now,
                            "utilization": snap["utilization"],
                            "density": snap["binpack_density"],
                            "stranded": {
                                st["shape"]: st["stranded_pct"]
                                for st in snap["stranded"]
                            },
                            "placeable": {
                                st["shape"]: st["placeable_count"]
                                for st in snap["stranded"]
                            },
                            "occupied": snap["nodes"]["occupied"],
                        })
                    p = SOLVER_PANEL.snapshot()
                    self._panel_samples.append({
                        "t": now,
                        "solves": p["solves"],
                        "placed": p["placed"],
                        "device_ms": p["device_ms"],
                        "live_rows": p["live_rows"],
                        "padded_rows": p["padded_rows"],
                        "count_live": p["count_live"],
                        "count_padded": p["count_padded"],
                    })
                except Exception:
                    self.logger.exception(
                        "simcluster: observatory sample failed")
            stats = srv.eval_broker.snapshot_stats()
            self.peaks["broker_ready"] = max(
                self.peaks["broker_ready"], stats.total_ready)
            self.peaks["broker_unacked"] = max(
                self.peaks["broker_unacked"], stats.total_unacked)
            self.peaks["broker_blocked"] = max(
                self.peaks["broker_blocked"], stats.total_blocked)
            # The quantity eval_pending_cap bounds (ready+blocked+waiting).
            self.peaks["broker_pending"] = max(
                self.peaks.get("broker_pending", 0),
                stats.total_ready + stats.total_blocked
                + stats.total_waiting)
            self.peaks["plan_queue_depth"] = max(
                self.peaks["plan_queue_depth"], srv.plan_queue.depth())
            pipe = srv.plan_pipeline.stats()
            self._pipe_samples.append(
                (time.perf_counter(), pipe["plans"], pipe["conflicts"])
            )

    # -- actions ------------------------------------------------------------

    def _register_job(self, fleet: SimFleet, payload: Dict) -> Optional[str]:
        """One Job.Register through the real RPC front door. Returns the
        eval id, or None when admission rejected it typed: the rejection
        is counted by reason, never retried (the overdrive injector is
        impolite by contract: it measures the door)."""
        job = payload["build"]()
        with self._offer_lock:
            self._offered += 1
        args = {"job": to_dict(job)}
        if payload.get("client_id"):
            args["client_id"] = payload["client_id"]
        try:
            out = fleet._pool().call(
                self._srv.rpc_addr, "Job.Register", args,
                timeout=fleet.rpc_timeout,
            )
        except RemoteError as e:
            rejection = parse_reject(str(e))
            if rejection is None:
                raise
            with self._offer_lock:
                self._rejected[rejection.reason] = (
                    self._rejected.get(rejection.reason, 0) + 1
                )
            return None
        self._jobs[payload["job_key"]] = job
        return out["eval_id"]

    def _update_job(self, fleet: SimFleet, payload: Dict) -> Optional[str]:
        base = self._jobs.get(payload["job_key"])
        if base is None:
            return None
        job = copy.deepcopy(base)
        if payload["mutation"] == "inplace":
            # Resource-only bump: tasks_updated() false -> the in-place
            # path (util.go:265-302).
            job.task_groups[0].tasks[0].resources.cpu += 1
        else:
            # Env change: destructive -> evict+place (util.go:403-416).
            job.task_groups[0].tasks[0].env = {
                "V": str(payload.get("serial", 0))
            }
        self._jobs[payload["job_key"]] = job
        out = fleet._pool().call(
            self._srv.rpc_addr, "Job.Register", {"job": to_dict(job)},
            timeout=fleet.rpc_timeout,
        )
        return out["eval_id"]

    def _deregister_job(self, fleet: SimFleet,
                        payload: Dict) -> Optional[str]:
        """One Job.Deregister through the real RPC front door. Returns the
        eval id (None for an unknown job key)."""
        job = self._jobs.get(payload["job_key"])
        if job is None:
            return None
        out = fleet._pool().call(
            self._srv.rpc_addr, "Job.Deregister", {"job_id": job.id},
            timeout=fleet.rpc_timeout,
        )
        return out["eval_id"]

    def _refresh_nodes(self, fleet: SimFleet, payload: Dict) -> None:
        """Re-register ``count`` live nodes with identical fingerprints:
        one batched node upsert through raft. Seeded pick over the sorted
        live set keeps the event digest deterministic."""
        rng = payload["rng"]
        live = sorted(fleet.live_nodes())
        if not live:
            return
        pick = rng.sample(live, min(int(payload["count"]), len(live)))
        nodes = []
        for nid in pick:
            i = int(nid.rsplit("-", 1)[1])
            nodes.append(sim_node(i, "dc1" if i % 2 == 0 else "dc2"))
        fleet._pool().call(
            self._srv.rpc_addr, "Node.BatchRegister",
            {"nodes": [to_dict(n) for n in nodes]},
            timeout=fleet.rpc_timeout,
        )

    def _fail_nodes(self, fleet: SimFleet, payload: Dict) -> List[str]:
        """Silence nodes: a seeded ``count`` sample preferring
        alloc-hosting nodes (the churn tranche), or an explicit
        ``node_ids`` list (a chaos kill schedule's correlated failure
        domain, one whole rack). Either way the hosted alloc map at kill
        time lands in the chaos book, so a chaos_check can judge
        exactly-once re-placement per lost alloc."""
        snap = self._srv.state_store.snapshot()
        live = set(fleet.live_nodes())
        explicit = payload.get("node_ids")
        if explicit:
            pick: List[str] = [n for n in explicit if n in live]
        else:
            rng = payload["rng"]
            count = int(payload["count"])
            hosting = set()
            for job in self._jobs.values():
                for a in snap.allocs_by_job(job.id):
                    if a.desired_status == structs.ALLOC_DESIRED_STATUS_RUN:
                        hosting.add(a.node_id)
            hosting &= live
            pick = rng.sample(sorted(hosting), min(count, len(hosting)))
            if len(pick) < count:
                rest = sorted(live - set(pick))
                pick += rng.sample(rest, min(count - len(pick), len(rest)))
        killed = set(pick)
        hosted: Dict[str, List[str]] = {}
        for job in self._jobs.values():
            for a in snap.allocs_by_job(job.id):
                if (a.desired_status == structs.ALLOC_DESIRED_STATUS_RUN
                        and a.node_id in killed):
                    hosted.setdefault(job.id, []).append(a.id)
        book = self._chaos.setdefault(
            "killed_nodes", {"nodes": [], "hosted_jobs": {}})
        book["nodes"].extend(pick)
        for jid, aids in sorted(hosted.items()):
            book["hosted_jobs"].setdefault(jid, []).extend(aids)
        fleet.fail(pick)
        self.logger.info(
            "simcluster: silenced %d nodes (%d jobs hosted there)",
            len(pick), len(hosted))
        return pick

    def _expand_fleet(self, fleet: SimFleet, payload: Dict) -> None:
        """Register ``count`` fresh nodes from index ``start`` mid-run:
        the rack-failure family's spare tranche, capacity that exists
        only after the fill is placed (a barrier enforces it), so every
        re-placement after the rack kill can only land on spares."""
        start = int(payload["start"])
        count = int(payload["count"])
        nodes = [sim_node(i, "dc1" if i % 2 == 0 else "dc2")
                 for i in range(start, start + count)]
        fleet.register(nodes)
        self._chaos.setdefault("expanded", []).append(
            {"start": start, "count": count})
        self.logger.info(
            "simcluster: expanded fleet by %d spare nodes", count)

    def _followers(self) -> List[ClusterServer]:
        """The cell's non-leader members, sorted by node id. Re-resolves
        the live leader first: bring-up churn may have moved leadership
        after self._srv was chosen."""
        for m in self._members:
            if m.raft.is_leader:
                self._srv = m
                break
        srv = self._srv
        return sorted((m for m in self._members if m is not srv),
                      key=lambda m: m.cluster.node_id)

    def _kill_follower(self, payload: Dict) -> None:
        """Kill one follower outright mid-load (``index`` over the sorted
        non-leader members). The cell keeps serving on the remaining
        quorum; the kill book carries what restart_follower needs to
        bring the same member back from its durable state on its port."""
        followers = self._followers()
        target = followers[int(payload.get("index", 0))]
        book = {
            "node_id": target.cluster.node_id,
            "port": int(target.rpc_addr.rsplit(":", 1)[1]),
            "data_dir": target.cluster.raft_data_dir,
            "killed_at_s": round(
                time.perf_counter() - self._t_measure0, 2),
            "leader_applied_at_kill": self._srv.raft.applied_index,
            "_index": self._members.index(target),
        }
        target.shutdown()
        self._downed = book
        self._chaos["follower_kill"] = {
            k: v for k, v in book.items() if not k.startswith("_")}
        self.logger.info("simcluster: killed follower %s at t=%.2fs",
                         book["node_id"], book["killed_at_s"])

    def _restart_follower(self, payload: Dict) -> None:
        """Restart the killed follower from its durable raft state on the
        same port and node id while the cell keeps serving. With the
        kill-to-restart window past the leader's snapshot threshold, the
        rejoin rides the chunked InstallSnapshot path racing live
        appends; a background poll stamps time-to-rejoin (the follower's
        applied index reaching the leader's commit index at restart)
        into the chaos book, and the chaos_check joins it before judging
        digest equality."""
        book = self._downed
        if book is None:
            raise RuntimeError(
                "restart_follower without a killed follower")
        self._downed = None
        name = book["node_id"]
        cfg = ServerConfig(**{**self._cfg_kwargs, "node_name": name})
        ccfg = self._cluster_config(bind_port=book["port"],
                                    data_dir=book["data_dir"])
        ccfg.node_id = name
        ccfg.bootstrap_expect = len(self._members)
        ccfg.peers = self._peers
        srv2 = ClusterServer(cfg, ccfg, logger=self.logger.getChild(name))
        self._members[book["_index"]] = srv2
        commit_floor = self._srv.raft.commit_index
        t_restart = time.perf_counter()
        srv2.start()
        restart_book = {
            "node_id": name,
            "restarted_at_s": round(t_restart - self._t_measure0, 2),
            "downtime_s": round(t_restart - self._t_measure0
                                - book["killed_at_s"], 2),
            "commit_floor": commit_floor,
            "time_to_rejoin_ms": None,
        }
        self._chaos["follower_restart"] = restart_book

        def _poll_rejoin() -> None:
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                if srv2.raft.applied_index >= commit_floor:
                    restart_book["time_to_rejoin_ms"] = round(
                        (time.perf_counter() - t_restart) * 1000.0, 1)
                    return
                time.sleep(0.02)

        self._rejoin_thread = threading.Thread(
            target=_poll_rejoin, daemon=True, name="sim-rejoin")
        self._rejoin_thread.start()
        self.logger.info(
            "simcluster: follower %s restarting from %s (commit floor "
            "%d)", name, book["data_dir"], commit_floor)

    def _read_storm(self, payload: Dict) -> None:
        """Launch the impolite read fleet (ReadFleetInjector): stand the
        loopback HTTP fronts up (first storm only) and start the reader
        threads (tight-loop pollers over the list endpoints, blocking
        watchers advancing on X-Nomad-Index, SSE tails over
        /v1/event/stream), each running until the payload's ``until``
        offset. With followers and the read plane on, every follower gets
        its own front and the fleet rotates across them: pollers and
        watchers take the stale lane under the payload's bound (every
        5th poll the linearizable lane), SSE tails ride each follower's
        own event ring. With the lanes off (the leader-only contrast
        arm) every read lands on the leader's front as a plain GET. The
        runner keeps only the client-side books here."""
        from urllib.error import HTTPError
        from urllib.request import urlopen

        from nomad_tpu_torch.api.http import HTTPServer

        if self._http is None:
            self._http = HTTPServer(
                _HttpShim(self), port=0,
                logger=self.logger.getChild("readhttp"),
            )
            self._http.start()
        base = self._http.addr
        lanes_on = bool(self._srv.config.read_path_config.enabled)
        if lanes_on and len(self._members) > 1 and not self._follower_https:
            for m in self._followers():
                h = HTTPServer(
                    _MemberHttpShim(m), port=0,
                    logger=self.logger.getChild(
                        f"readhttp-{m.cluster.node_id}"),
                )
                h.start()
                self._follower_https.append(h)
        follower_bases = [h.addr for h in self._follower_https]
        bound_ms = float(payload.get("max_stale_ms", 5000.0))
        self._stale_bound_ms = bound_ms
        deadline = self._t_actions0 + float(payload["until"])
        interval = float(payload.get("poll_interval", 0.2))
        jitters = list(payload.get("poll_jitters") or [1.0])
        paths = ("/v1/jobs", "/v1/nodes", "/v1/allocations",
                 "/v1/evaluations")
        stats = self._reader_stats
        stop = self._stop
        books = self._lane_books
        lane_lock = self._lane_lock

        def book_lane(headers, linear: bool) -> None:
            """Client-side lane accounting for one follower-front 200:
            the freshness stamp (applied index + contact age), the
            measured staleness age, and the linearizable floor (nothing
            older than the confirmed read index)."""
            applied = headers.get("X-Nomad-LastIndex")
            contact = headers.get("X-Nomad-LastContact")
            with lane_lock:
                if applied is None or contact is None:
                    books["stamp_missing"] += 1
                    return
                if linear:
                    books["linear_reads"] += 1
                    ridx = int(headers.get("X-Nomad-Read-Index") or 0)
                    if ridx <= 0 or int(applied) < ridx:
                        books["linear_violations"] += 1
                else:
                    books["stale_reads"] += 1
                    self._stale_ages_ms.append(float(contact))

        def poller(k: int) -> None:
            jitter = float(jitters[k % len(jitters)])
            n = errs = nbytes = refused = 0
            while time.monotonic() < deadline and not stop.is_set():
                path = paths[(n + k) % len(paths)]
                linear = False
                if follower_bases:
                    fb = follower_bases[(n + k) % len(follower_bases)]
                    linear = n % 5 == 4
                    url = (f"{fb}{path}?consistent=1" if linear else
                           f"{fb}{path}?stale=1&max_stale={bound_ms:g}")
                    with lane_lock:
                        books["follower_dialed"] += 1
                else:
                    url = base + path
                try:
                    with urlopen(url, timeout=10.0) as resp:
                        nbytes += len(resp.read())
                        if follower_bases:
                            book_lane(resp.headers, linear)
                except HTTPError as e:
                    if e.code == 429:
                        refused += 1
                    errs += 1
                except Exception:
                    errs += 1
                n += 1
                time.sleep(interval * jitter)
            stats.append({"kind": "pollers", "requests": n,
                          "errors": errs, "bytes": nbytes,
                          "lane_refused": refused})

        def watcher(k: int) -> None:
            path = paths[k % len(paths)]
            index = 1
            n = wakes = timeouts = errs = 0
            while time.monotonic() < deadline and not stop.is_set():
                if follower_bases:
                    fb = follower_bases[k % len(follower_bases)]
                    url = (f"{fb}{path}?index={index}&wait=2s"
                           f"&stale=1&max_stale={bound_ms:g}")
                    with lane_lock:
                        books["follower_dialed"] += 1
                else:
                    url = f"{base}{path}?index={index}&wait=2s"
                try:
                    with urlopen(url, timeout=15.0) as resp:
                        resp.read()
                        new = int(resp.headers.get("X-Nomad-Index") or 0)
                        if follower_bases:
                            book_lane(resp.headers, False)
                    if new > index:
                        wakes += 1
                        index = new
                    else:
                        timeouts += 1
                except Exception:
                    errs += 1
                n += 1
            stats.append({"kind": "watchers", "requests": n,
                          "wakes": wakes, "timeouts": timeouts,
                          "errors": errs})

        def sse_tail(k: int) -> None:
            sse_base = (follower_bases[k % len(follower_bases)]
                        if follower_bases else base)
            sessions = frames = errs = 0
            while time.monotonic() < deadline and not stop.is_set():
                # Bounded sessions that reconnect until the deadline.
                wait_s = max(min(deadline - time.monotonic(), 4.0), 0.5)
                try:
                    with urlopen(
                        f"{sse_base}/v1/event/stream?format=sse"
                        f"&wait={wait_s:.1f}s",
                        timeout=30.0,
                    ) as resp:
                        sessions += 1
                        for line in resp:
                            if line.startswith(b"data:"):
                                frames += 1
                except Exception:
                    errs += 1
            stats.append({"kind": "sse_tails", "sessions": sessions,
                          "frames": frames, "errors": errs})

        specs = (("pollers", poller, "sim-read-poll"),
                 ("watchers", watcher, "sim-read-watch"),
                 ("sse_tails", sse_tail, "sim-read-sse"))
        for key, target, prefix in specs:
            for k in range(int(payload.get(key, 0))):
                t = threading.Thread(target=target, args=(k,),
                                     daemon=True, name=f"{prefix}-{k}")
                t.start()
                self._readers.append(t)
        self.logger.info(
            "simcluster: read storm launched (%s pollers, %s watchers, "
            "%s sse tails) until t=%.1fs",
            payload.get("pollers", 0), payload.get("watchers", 0),
            payload.get("sse_tails", 0), float(payload["until"]))

    def _resolve_fault_plan(self, plan: Dict) -> Dict:
        """Bind member-role placeholders in an armed fault plan:
        ``{leader}`` -> the elected leader's node id, ``{followerN}`` ->
        the Nth sorted non-leader member. Chaos specs are written before
        the seeded election resolves who leads, so the plan speaks in
        roles and the runner substitutes the winners here, over every
        string in the plan."""
        if len(self._members) <= 1:
            return plan
        subs = {"{leader}": self._srv.cluster.node_id}
        for i, m in enumerate(self._followers()):
            subs[f"{{follower{i}}}"] = m.cluster.node_id

        def sub(v):
            if isinstance(v, str):
                for k, s in subs.items():
                    v = v.replace(k, s)
                return v
            if isinstance(v, dict):
                return {k: sub(x) for k, x in v.items()}
            if isinstance(v, list):
                return [sub(x) for x in v]
            return v

        return sub(plan)

    def _cluster_config(self, bind_port: int = 0,
                        data_dir: Optional[str] = None) -> ClusterConfig:
        kwargs = dict(bootstrap_expect=1, bind_port=bind_port)
        data_dir = data_dir or self._data_dir
        if data_dir:
            kwargs["raft_data_dir"] = data_dir
        kwargs.update(self.spec.cluster_overrides)
        return ClusterConfig(**kwargs)

    def _build_cluster(self, cfg_kwargs: Dict) -> List[ClusterServer]:
        """Construct the run's server(s). cluster_members == 1 is the
        classic single-member path. >1 builds a real cell: every member
        shares ONE peers dict (each registers its rpc_addr at
        construction), bootstrap_expect = members, and a durable spec
        journals each member into its own subdirectory."""
        members = int(self.spec.cluster_members or 1)
        if members <= 1:
            srv = ClusterServer(
                ServerConfig(**cfg_kwargs), self._cluster_config(),
                logger=self.logger,
            )
            self._members = [srv]
            return self._members
        self._peers = {}
        out: List[ClusterServer] = []
        for i in range(members):
            name = f"server-{i}"
            data_dir = None
            if self._data_dir is not None:
                data_dir = os.path.join(self._data_dir, name)
                os.makedirs(data_dir, exist_ok=True)
            ccfg = self._cluster_config(data_dir=data_dir)
            ccfg.node_id = name
            ccfg.bootstrap_expect = members
            ccfg.peers = self._peers
            cfg = ServerConfig(**{**cfg_kwargs, "node_name": name})
            out.append(ClusterServer(
                cfg, ccfg, logger=self.logger.getChild(name)))
        self._members = out
        return out

    def _restart_leader(self, fleet: SimFleet) -> None:
        """Kill the leader outright and restart it from its durable raft
        state on the same port. The order is the contract:

        1. shut the old server down (in-flight plans fail typed; their
           evals stay pending in durable state);
        2. drain the old event ring completely, and record the kill-time
           applied index as the watcher's raft-index floor and the
           pre-kill live placement map;
        3. build the new server on the same data dir and port, let its
           raft observatory absorb the old one's books, attach a fresh
           watcher before start (replayed events race the first poll),
           start it and wait for leadership;
        4. flush the fleet's pooled conns (dead sockets invalidate on
           first use) until the new listener answers.

        The new server builds a new store (a new store uid), so its
        solver mirror is built afresh on the device; the old store's
        mirror is no longer reachable from any server."""
        from nomad_tpu_torch.rpc import RPCError

        if not self.spec.durable_raft or self._data_dir is None:
            raise RuntimeError(
                "restart_leader requires a durable_raft scenario spec")
        old = self._srv
        port = int(old.rpc_addr.rsplit(":", 1)[1])
        t_kill0 = time.perf_counter()
        self.logger.info("simcluster: killing leader at t=%.2fs",
                         t_kill0 - self._t_measure0)
        old.shutdown()
        # The watcher drains the (quiescent) old ring on its way out.
        self._stop_watcher()
        pre_applied = old.raft.applied_index
        pre_allocs = {
            a.id: a.node_id for a in old.state_store.allocs()
            if a.desired_status == structs.ALLOC_DESIRED_STATUS_RUN
        }
        # Carry the per-server counter baselines across the restart: the
        # fresh server's books start at zero, and the artifact's
        # measured-window deltas must span both lives.
        for k, v in old.plan_pipeline.stats().items():
            if not isinstance(v, (int, float)):
                continue
            if k == "max_batch_seen":  # a high-watermark, not a delta
                self._pipe_carry[k] = max(self._pipe_carry.get(k, 0), v)
                continue
            self._pipe_carry[k] = (self._pipe_carry.get(k, 0)
                                   + v - self._pipe0.get(k, 0))
            self._pipe0[k] = 0
        for k, v in old.heartbeat.stats().items():
            self._hb_carry[k] = (self._hb_carry.get(k, 0)
                                 + v - self._hb0.get(k, 0))
            self._hb0[k] = 0
        self._raft_floor = pre_applied

        srv2 = ClusterServer(
            ServerConfig(**self._cfg_kwargs),
            self._cluster_config(bind_port=port), logger=self.logger,
        )
        self._srv = srv2
        if self._members:
            self._members[self._members.index(old)] = srv2
        # The write-path books span both server lives.
        srv2.raft_observatory.absorb(old.raft_observatory)
        # Fresh watcher before start: the log replay publishes into the
        # new ring within milliseconds of leadership; every replayed
        # event is at or below the floor and dedups.
        self._start_watcher(srv2.fsm.events, 0)
        srv2.start()
        wait_for_leader([srv2], timeout=60.0)
        deadline = time.monotonic() + 30.0
        for pool in fleet._pools:
            while True:
                try:
                    pool.call(srv2.rpc_addr, "Status.Ping", {},
                              timeout=2.0)
                    break
                except RPCError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
        downtime = time.perf_counter() - t_kill0
        self._restart = {
            "killed_at_s": round(t_kill0 - self._t_measure0, 2),
            "downtime_s": round(downtime, 3),
            "pre_kill_applied_index": pre_applied,
            "pre_kill_placements": len(pre_allocs),
            "pre_kill_alloc_map": pre_allocs,
        }
        self.logger.info(
            "simcluster: leader restarted in %.2fs (replaying from "
            "applied index %d, %d live placements pre-kill)",
            downtime, pre_applied, len(pre_allocs),
        )

    # -- the run ------------------------------------------------------------

    def run(self) -> Dict:
        from nomad_tpu_torch import trace as trace_mod
        from nomad_tpu_torch.ops.binpack import bucket
        from nomad_tpu_torch.ops.coalesce import (
            GLOBAL_SOLVER,
            warm_batch_shapes,
        )
        from nomad_tpu_torch.tpu.mirror import GLOBAL_MIRROR_CACHE
        from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

        spec = self.spec
        # Overrides go through the CONSTRUCTOR: __post_init__ resolves and
        # validates the scheduler_workers/num_schedulers alias pair.
        cfg_kwargs = dict(
            scheduler_backend="tpu", scheduler_workers=4, eval_batch_size=4,
            prewarm_shapes=False, periodic_dispatch=False,
            # The run seed feeds the server's name-salted decision-path
            # streams (broker scheduler choice, heartbeat jitter).
            seed=self.seed, device=str(self.device),
        )
        cfg_kwargs.update(spec.server_overrides)
        if not self.attribution_layer:
            cfg_kwargs["slo_objectives"] = {}
        # Kept for the members a restart action builds anew.
        self._cfg_kwargs = cfg_kwargs
        # Lock-contention attribution for the run: the watchdog over the
        # port's lock analysis, installed before any member builds a lock
        # so the profile section carries the contention table. Timing
        # only; no decision observes it. Not in the profiler-off contrast
        # arm or the attribution-off arm.
        self._watchdog = None
        prof_enabled = (cfg_kwargs.get("profile") or {}).get("enabled", True)
        if self.attribution_layer and prof_enabled:
            try:
                self._watchdog = telemetry.port_lock_watchdog().install()
            except Exception as e:
                self.logger.warning(
                    "simcluster: lock watchdog unavailable (the lock-order "
                    "analysis failed): %s", e)
        if spec.durable_raft and self._data_dir is None:
            self._data_dir = tempfile.mkdtemp(prefix="nomad-sim-raft-")
        try:
            members = self._build_cluster(cfg_kwargs)
            srv = self._srv = members[0]
            fleet = SimFleet(srv.rpc_addr, logger=self.logger)
        except BaseException:
            # The run never starts: no lock of a later run is wrapped.
            if self._watchdog is not None:
                self._watchdog.uninstall()
                self._watchdog = None
            raise
        tracer = trace_mod.get_tracer()
        tracing_was = tracer.enabled
        if not self.attribution_layer:
            tracer.enabled = False
        t_run0 = time.perf_counter()
        try:
            for m in members:
                m.start()
            if len(members) == 1:
                wait_for_leader([srv])
            else:
                # Whoever won the seeded election is the cell's front door
                # for the whole run: the runner and the fleet point at it.
                srv = self._srv = wait_for_leader(members, timeout=30.0)
                members.sort(key=lambda m: (m is not srv,
                                            m.cluster.node_id))
                fleet.addr = srv.rpc_addr

            # Phase 1: fleet bring-up (batched registration + TTL arms).
            # The beater starts FIRST so early tranches renew while later
            # ones still register.
            nodes = [
                sim_node(i, "dc1" if i % 2 == 0 else "dc2")
                for i in range(self.n_nodes)
            ]
            fleet.start_heartbeats()
            try:
                reg = fleet.register(nodes)
            except RemoteError as e:
                if len(members) == 1 or "NotLeaderError" not in str(e):
                    raise
                # An election churned between wait_for_leader and
                # bring-up: re-resolve the front door and re-register
                # (an idempotent upsert).
                srv = self._srv = wait_for_leader(members, timeout=30.0)
                members.sort(key=lambda m: (m is not srv,
                                            m.cluster.node_id))
                fleet.addr = srv.rpc_addr
                reg = fleet.register(nodes)
            timers = srv.heartbeat.num_timers()
            if timers != self.n_nodes:
                raise RuntimeError(
                    f"bring-up lost nodes: {timers}/{self.n_nodes} "
                    "heartbeat timers armed after registration"
                )

            # Phase 2: warm the solve shapes for this node bucket so the
            # measured window reports steady state: the warmup job's
            # single-eval water-fill, then every coalesced width.
            if spec.warmup_count:
                warm = build_job("sim-warmup", structs.JOB_TYPE_BATCH,
                                 spec.warmup_count)
                out = fleet._pool().call(
                    srv.rpc_addr, "Job.Register", {"job": to_dict(warm)},
                    timeout=fleet.rpc_timeout,
                )
                srv.wait_for_eval(out["eval_id"], timeout=180.0)
                warm_batch_shapes(bucket(max(self.n_nodes, 1)),
                                  device=self.device)
                if srv.config.express_config.enabled:
                    # Warm the express path too: the first in-line
                    # placement pays the capacity-view build.
                    wexp = build_job("sim-warmup-express",
                                     structs.JOB_TYPE_BATCH, 1,
                                     express=True)
                    out = fleet._pool().call(
                        srv.rpc_addr, "Job.Register",
                        {"job": to_dict(wexp)},
                        timeout=fleet.rpc_timeout,
                    )
                    srv.wait_for_eval(out["eval_id"], timeout=60.0)
                    # The eval commits COMPLETE before the async alloc
                    # commit lands: drain the lane so the warmup's
                    # AllocUpserted never leaks past the window's cursor.
                    lane = srv.express_lane
                    deadline = time.monotonic() + 60.0
                    while (lane.committed + lane.reconciled
                           < lane.placed):
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                "express warmup commit did not drain")
                        time.sleep(0.01)

            # Warmup boundary for the live SLO monitor: wipe its books
            # (counted in resets/reset_excluded) so the artifact's `slo`
            # section judges the measured window only.
            if srv.slo_monitor is not None:
                srv.slo_monitor.reset()

            # Phase 3: measured window. Cursor excludes bring-up/warmup.
            if spec.faults_spec is not None:
                plan = dict(spec.faults_spec)
                plan.setdefault("seed", self.seed)
                faults.get_registry().load(self._resolve_fault_plan(plan))
            broker = srv.fsm.events
            cursor = broker.get_index()
            self._hb0 = srv.heartbeat.stats()
            t_measure0 = time.perf_counter()
            dispatches0 = GLOBAL_SOLVER.dispatches
            mirror0 = GLOBAL_MIRROR_CACHE.stats()
            self._pipe0 = srv.plan_pipeline.stats()
            self._t_measure0 = t_measure0
            # The panel is process-global: window accounting differences
            # against this baseline.
            self._panel0 = SOLVER_PANEL.snapshot()
            self._start_watcher(broker, cursor)
            sampler = threading.Thread(
                target=self._sample_depths, args=(srv,), daemon=True,
                name="sim-sampler")
            sampler.start()

            injectors = spec.injectors(self.seed)
            actions: List[Action] = sorted(
                a for inj in injectors for a in inj.actions()
            )
            t0 = time.monotonic()
            self._t_actions0 = t0
            expected_evals: List[str] = []
            failed_tranche: List[str] = []
            # IMPOLITE registrations (OverdriveInjector): each client's
            # sequence runs IN ORDER on its own thread, the next request
            # the instant the previous response returns. Per-client order
            # keeps per-client token-bucket decisions seed-deterministic;
            # cross-client interleaving is noise the digest ignores.
            impolite: Dict[str, List[Action]] = {}
            paced: List[Action] = []
            for action in actions:
                if (action.kind == "register_job"
                        and action.payload.get("impolite")):
                    impolite.setdefault(
                        action.payload.get("client_id", ""), []
                    ).append(action)
                else:
                    paced.append(action)
            blasters: List[threading.Thread] = []
            blasted: List[List[Optional[str]]] = []
            blast_errors: List[BaseException] = []

            def blast(client_actions, out):
                try:
                    for a in client_actions:
                        out.append(self._register_job(fleet, a.payload))
                except BaseException as e:  # surfaced after join
                    # A non-reject failure must fail the run, not count
                    # the errored requests as admitted.
                    blast_errors.append(e)

            for client, client_actions in sorted(impolite.items()):
                out: List[Optional[str]] = []
                blasted.append(out)
                t = threading.Thread(
                    target=blast, args=(client_actions, out),
                    daemon=True, name=f"sim-blast-{client}",
                )
                blasters.append(t)
                t.start()
            for action in paced:
                delay = t0 + action.at - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                if action.kind == "register_job":
                    ev_id = self._register_job(fleet, action.payload)
                    if ev_id:
                        expected_evals.append(ev_id)
                elif action.kind == "read_storm":
                    self._read_storm(action.payload)
                elif action.kind == "update_job":
                    ev_id = self._update_job(fleet, action.payload)
                    if ev_id:
                        expected_evals.append(ev_id)
                elif action.kind == "deregister_job":
                    ev_id = self._deregister_job(fleet, action.payload)
                    if ev_id:
                        expected_evals.append(ev_id)
                elif action.kind == "refresh_nodes":
                    self._refresh_nodes(fleet, action.payload)
                elif action.kind == "fail_nodes":
                    failed_tranche = self._fail_nodes(fleet, action.payload)
                elif action.kind == "restart_leader":
                    # Synchronous in the paced loop: no registration is
                    # in flight across the kill (only worker-side eval
                    # and plan work, which the durable log re-drives).
                    self._restart_leader(fleet)
                elif action.kind == "barrier":
                    # A chaos phase boundary: everything injected so far
                    # terminal and the broker drained before the next
                    # phase exists (the rack fill placed before the spare
                    # tranche registers).
                    self._wait_quiesced(
                        self._srv, list(expected_evals), [],
                        time.monotonic()
                        + float(action.payload.get("timeout", 60.0)))
                elif action.kind == "expand_fleet":
                    self._expand_fleet(fleet, action.payload)
                elif action.kind == "kill_follower":
                    self._kill_follower(action.payload)
                elif action.kind == "restart_follower":
                    self._restart_follower(action.payload)
                elif action.kind == "settle":
                    # Pure pacing point: the sleep above held the loop
                    # open to this action's time. The chaos compiler
                    # emits one past the storm horizon so a fast workload
                    # cannot quiesce while fault windows are still ahead.
                    pass
                else:
                    raise ValueError(f"unknown action kind {action.kind!r}")
            for t in blasters:
                t.join()
            if blast_errors:
                raise RuntimeError(
                    f"{len(blast_errors)} impolite blast thread(s) "
                    "failed on a non-reject error"
                ) from blast_errors[0]
            for out in blasted:
                expected_evals.extend(ev_id for ev_id in out if ev_id)
            # Readers stop at their payload deadline; every reader must be
            # off the wire before quiescence is judged.
            for t in self._readers:
                t.join(timeout=60.0)
            live_readers = [t.name for t in self._readers if t.is_alive()]
            if live_readers:
                raise RuntimeError(
                    f"read-fleet reader(s) did not stop: {live_readers}")

            # A leader restart swaps the server mid-loop: everything from
            # quiescence on reads the current one.
            srv = self._srv
            self._wait_quiesced(srv, expected_evals, failed_tranche,
                                time.monotonic() + spec.quiesce_timeout)
            wall = time.perf_counter() - t_run0
            measured = time.perf_counter() - t_measure0
            # Effective baselines: counters carried across a restart (the
            # old server's window share folded in as a negative offset).
            hb0 = {k: self._hb0.get(k, 0) - self._hb_carry.get(k, 0)
                   for k in self._hb0}
            hb1 = srv.heartbeat.stats()
            dispatches = GLOBAL_SOLVER.dispatches - dispatches0
            mirror1 = GLOBAL_MIRROR_CACHE.stats()
            # The delta economy over the MEASURED window: under steady
            # refresh churn, delta_rolls must dominate full_rebuilds.
            mirror = {
                k: mirror1[k] - mirror0[k]
                for k in ("hits", "misses", "delta_rolls",
                          "full_rebuilds", "rows_restaged")
            }
            pipe1 = srv.plan_pipeline.stats()
            pipeline = {
                k: (pipe1[k] - self._pipe0.get(k, 0)
                    + self._pipe_carry.get(k, 0))
                for k in ("batches", "plans", "committed", "noops",
                          "conflicts", "refreshes", "fused_plans",
                          "scalar_plans")
            }
            pipeline["max_batch_seen"] = max(
                pipe1["max_batch_seen"],
                self._pipe_carry.get("max_batch_seen", 0))

            # Phase 4: alloc acknowledgement (bounded client posture).
            acked = 0
            if spec.ack_cap and self._jobs:
                first = next(iter(self._jobs.values()))
                snap = srv.state_store.snapshot()
                live = [
                    a for a in snap.allocs_by_job(first.id)
                    if a.desired_status == structs.ALLOC_DESIRED_STATUS_RUN
                ][:spec.ack_cap]
                if live:
                    acked = fleet.ack_allocs(live)

            # Drain the watcher, then build the artifact.
            self._stop.set()
            self._stop_watcher()
            sampler.join(timeout=5.0)
            return self._artifact(
                srv, fleet, reg, hb0, hb1, dispatches, acked, wall,
                measured, len(expected_evals), mirror, pipeline,
            )
        finally:
            self._stop.set()
            self._stop_watcher()
            tracer.enabled = tracing_was
            if self._watchdog is not None:
                self._watchdog.uninstall()
                self._watchdog = None
            if spec.faults_spec is not None:
                faults.get_registry().clear()
            for h in [self._http, *self._follower_https]:
                if h is None:
                    continue
                try:
                    h.shutdown()
                except Exception:
                    self.logger.exception(
                        "simcluster: read front-end shutdown failed")
            self._http = None
            self._follower_https = []
            fleet.stop()
            for m in self._members:
                try:
                    m.shutdown()
                except Exception:
                    self.logger.exception(
                        "simcluster: member shutdown failed")
            if self._data_dir is not None:
                shutil.rmtree(self._data_dir, ignore_errors=True)
                self._data_dir = None

    def _wait_quiesced(self, srv, expected_evals: List[str],
                       failed_tranche: List[str], deadline: float) -> None:
        """Quiescence = every expected eval terminal, every silenced node
        marked down (its expiry fans out more evals), the broker drained,
        and every express placement committed or reconciled. An express
        eval commits COMPLETE before its allocations' plan does, so
        nomad_tpu's runner, which waits on evals only, can close the
        window with the last express commit still in flight (its
        AllocUpserted/PlanApplied then miss the digest)."""
        down_needed = set(failed_tranche)
        pending: List[str] = list(expected_evals)
        express_busy = 0
        while time.monotonic() < deadline:
            snap = srv.state_store.snapshot()
            if down_needed:
                down_needed = {
                    # nomadlint: allow(DET003) -- order-independent
                    # filter: the result set is only len()/emptiness
                    # checked.
                    nid for nid in down_needed
                    if (snap.node_by_id(nid) is not None
                        and snap.node_by_id(nid).status
                        != structs.NODE_STATUS_DOWN)
                }
            pending = [
                ev_id for ev_id in expected_evals
                if (snap.eval_by_id(ev_id) is None
                    or not snap.eval_by_id(ev_id).terminal_status())
            ]
            stats = srv.eval_broker.snapshot_stats()
            busy = (stats.total_ready + stats.total_unacked
                    + stats.total_blocked)
            lane = srv.express_lane
            express_busy = lane.placed - lane.committed - lane.reconciled
            if (not pending and not down_needed and busy == 0
                    and express_busy == 0):
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"scenario did not quiesce: pending_evals={len(pending)}"
            f"/{len(expected_evals)}, nodes_still_up={len(down_needed)}, "
            f"express_in_flight={express_busy}"
        )

    def _conflict_curve(self) -> List[Dict]:
        """Reduce the 10 Hz cumulative (plans, conflicts) series into
        conflict-rate-vs-load points: differentiate into ~0.5s windows,
        keep windows that saw plans, and bucket them by load (plans/s)."""
        samples = self._pipe_samples
        if len(samples) < 2:
            return []
        windows = []
        stride = 5  # 5 x 10 Hz = ~0.5s differentiation windows
        for i in range(0, len(samples) - 1, stride):
            # Clamped end: the tail beyond the last full stride still
            # forms a window.
            j = min(i + stride, len(samples) - 1)
            t0, p0, c0 = samples[i]
            t1, p1, c1 = samples[j]
            dt = max(t1 - t0, 1e-9)
            dp, dc = p1 - p0, c1 - c0
            if dp > 0:
                windows.append((dp / dt, dp, dc))
        if not windows:
            return []
        buckets: Dict[int, List] = {}
        for load, dp, dc in windows:
            # Geometric load buckets (1-2, 2-4, 4-8 ... plans/s).
            b = max(0, int(math.log2(max(load, 1.0))))
            agg = buckets.setdefault(b, [0, 0, 0, 0.0])
            agg[0] += 1
            agg[1] += dp
            agg[2] += dc
            agg[3] += load
        return [
            {
                "plans_per_sec": round(agg[3] / agg[0], 2),
                "windows": agg[0],
                "plans": agg[1],
                "conflicts": agg[2],
                "conflict_rate": round(agg[2] / max(agg[1], 1), 4),
            }
            for _b, agg in sorted(buckets.items())
        ]

    def _artifact(self, srv, fleet, reg, hb0, hb1, dispatches, acked,
                  wall, measured, n_injected_evals, mirror,
                  pipeline) -> Dict:
        with self._events_lock:
            events = list(self._events)
        pending_at: Dict[str, float] = {}
        terminal_at: Dict[str, float] = {}
        plan_at: Dict[str, float] = {}
        placed = 0
        stopped = 0
        expired_nodes = 0
        for e in events:
            if e.topic == "Eval" and e.type == "EvalUpdated":
                status = e.payload.get("status")
                if status == structs.EVAL_STATUS_PENDING:
                    pending_at.setdefault(e.key, e.time)
                elif status in (structs.EVAL_STATUS_COMPLETE,
                                structs.EVAL_STATUS_FAILED):
                    terminal_at.setdefault(e.key, e.time)
            elif e.topic == "Plan" and e.type == "PlanApplied":
                plan_at.setdefault(e.key, e.time)
            elif e.topic == "Alloc" and e.type == "AllocUpserted":
                if e.payload.get("columnar"):
                    placed += int(e.payload.get("count", 0))
                elif (e.payload.get("desired_status")
                        == structs.ALLOC_DESIRED_STATUS_RUN):
                    placed += 1
                else:
                    stopped += 1
            elif e.type == "NodeHeartbeatExpired":
                expired_nodes += 1

        plan_latency = [
            plan_at[k] - pending_at[k]
            for k in plan_at if k in pending_at
        ]
        eval_latency = [
            terminal_at[k] - pending_at[k]
            for k in terminal_at if k in pending_at
        ]
        t_first = min(pending_at.values()) if pending_at else 0.0
        t_last = max(plan_at.values()) if plan_at else t_first
        window = max(t_last - t_first, 1e-9)
        renewals = hb1["renewals"] - hb0["renewals"]

        caps = {
            "eval_pending_cap": srv.config.eval_pending_cap,
            "plan_queue_cap": srv.config.plan_queue_cap,
        }
        controller = srv.admission.snapshot()
        controller["recent_rejections"] = \
            controller.get("recent_rejections", [])[-20:]
        rejected_total = sum(self._rejected.values())
        express_ms = [
            float(e.payload.get("placed_ms", 0.0)) for e in events
            if e.topic == "Express" and e.type == "ExpressPlaced"
        ]
        artifact = {
            "schema_version": SCHEMA_VERSION,
            "scenario": self.spec.name,
            "description": self.spec.description,
            "seed": self.seed,
            "n_nodes": self.n_nodes,
            "backend": _backend_name(self.device),
            "wall_seconds": round(wall, 2),
            "registration": reg,
            "placements": {
                "placed": placed,
                "stopped": stopped,
                "evals_injected": n_injected_evals,
                "plans_applied": len(plan_at),
                "window_seconds": round(window, 3),
                "placements_per_sec": round(placed / window, 1),
                "device_dispatches": dispatches,
            },
            "plan_latency_ms": _quantiles(plan_latency),
            "eval_latency_ms": _quantiles(eval_latency),
            "peaks": dict(self.peaks),
            "heartbeat": {
                "timers": srv.heartbeat.num_timers(),
                "renewals_measured": renewals,
                # Over the MEASURED window (hb0 is sampled at its start).
                "renewals_per_sec_measured": round(
                    renewals / max(measured, 1e-9), 2),
                # Transient: Σ 1/(beat_fraction·ttl) over CURRENT grants.
                "scheduled_renewals_per_sec": round(
                    fleet.scheduled_renewals_per_sec(), 2),
                # Converged steady state (every node re-granted at the
                # full count): n·ln2/(beat_fraction·T) ≈ 0.87·cap.
                "equilibrium_renewals_per_sec": round(
                    _equilibrium_rate(srv, fleet), 2),
                "rate_cap_per_sec": srv.config.max_heartbeats_per_second,
                "beats_sent": fleet.beats_sent,
                "beat_batches": fleet.beat_batches,
                "expirations": expired_nodes,
            },
            "alloc_ack": {"acked": acked},
            "mirror": mirror,
            "plan_pipeline": {
                **pipeline,
                "workers": srv.config.scheduler_workers,
                "pipeline_batch_max": srv.plan_pipeline.max_batch,
                "conflict_rate": round(
                    pipeline["conflicts"] / max(pipeline["plans"], 1), 4
                ),
                "conflict_rate_vs_load": self._conflict_curve(),
            },
            "events": {
                "observed": len(events),
                "truncated": self._truncated,
                **canonical_events(events),
            },
            "deterministic_contract": self.spec.deterministic,
            # The front door over the run: the controller's own books
            # beside the injector's experience of it, and the bounded-
            # queue verdict (sampled peaks against the configured caps).
            "admission": {
                "controller": controller,
                "injector": {
                    "offered": self._offered,
                    "admitted": self._offered - rejected_total,
                    "rejected": dict(sorted(self._rejected.items())),
                },
                "caps": caps,
                "caps_respected": (
                    (not caps["eval_pending_cap"]
                     or self.peaks.get("broker_pending", 0)
                     <= caps["eval_pending_cap"])
                    and (not caps["plan_queue_cap"]
                         or self.peaks["plan_queue_depth"]
                         <= caps["plan_queue_cap"])
                ),
            },
            "capacity": self._capacity_section(srv),
            "raft": self._raft_section(srv),
            "reads": self._reads_section(srv),
            "profile": self._profile_section(srv),
            "solver_panel": self._solver_panel_section(),
        }
        if srv.config.express_config.enabled:
            # The lane's own books and ledger beside the event-derived
            # in-line latency the express_placed_p50_ms objective judges.
            artifact["express"] = {
                "lane": srv.express_lane.snapshot(),
                "placed_events": len(express_ms),
            }
        if self.attribution_layer:
            # End-to-end latency attribution: one timeline per eval the
            # window submitted (spans from the tracer, anchors from the
            # events digested above), reduced to submit→placed/running
            # quantiles and a per-stage waterfall. Express timelines are
            # a different regime (sub-ms in-line) with their own block.
            timelines = lifecycle.stitch(events)
            slow_tls = [t for t in timelines.values()
                        if t.triggered_by != "express"]
            att = lifecycle.attribution(slow_tls)
            # Scenario-scoped objectives (slo.SCENARIO_OBJECTIVES).
            objectives = slo.SCENARIO_OBJECTIVES.get(self.spec.name)
            if express_ms:
                att["express_placed_ms"] = _quantiles(
                    [ms / 1000.0 for ms in express_ms])
                objectives = {**(objectives or slo.DEFAULT_OBJECTIVES),
                              **slo.EXPRESS_OBJECTIVES}
            att["slo_check"] = slo.evaluate_artifact(att, objectives)
            artifact["latency_attribution"] = att
            artifact["slo"] = (
                srv.slo_monitor.snapshot()
                if srv.slo_monitor is not None else None
            )
        else:
            artifact["latency_attribution"] = None
            artifact["slo"] = None
        if self.spec.faults_spec is not None:
            artifact["faults"] = faults.get_registry().snapshot()
        if self.spec.chaos_check is not None:
            # The chaos verdict (simcluster/chaos.py): judges the
            # family's declared invariants against the finished artifact
            # and the live cluster, and raises on a violation.
            artifact["chaos"] = self.spec.chaos_check(self, srv, artifact)
        return artifact

    def _capacity_section(self, srv) -> Dict:
        """The capacity observatory's trajectory over the measured window
        (stranded %, density, utilization, placeable counts) and its
        final snapshot. {"enabled": False} in the observatory-off
        contrast arm (presence keeps the schema stable across arms)."""
        if not srv.config.capacity_config.enabled:
            return {"enabled": False}
        acct = srv.capacity_accountant
        acct.refresh()
        trajectory = [
            {**{k: v for k, v in s.items() if k != "t"},
             "t_s": round(s["t"] - self._t_measure0, 2)}
            for s in self._capacity_samples
        ]
        return {
            "enabled": True,
            "sample_hz": 2,
            "trajectory": trajectory,
            "final": acct.snapshot(),
        }

    def _raft_section(self, srv) -> Dict:
        """The raft observatory's run report (raft_observe.py): write-path
        stage attribution per msg_type, log/snapshot economy, and after a
        leader restart the recovery timeline with the placements-
        survived verdict. A run that lost a pre-kill placement raises
        here: survival is the scenario's contract, not a statistic."""
        obs = getattr(srv, "raft_observatory", None)
        if obs is None or not srv.config.raft_observe_config.enabled:
            return {"enabled": False}
        obs.refresh()
        snap = obs.snapshot()
        out = {
            "enabled": True,
            "write_path": snap["write_path"],
            "replication": snap["replication"],
            "log": snap["log"],
            "snapshot": snap["snapshot"],
            "recovery": snap["recovery"],
            "observer": snap["observer"],
        }
        if self._restart is not None:
            restart = {k: v for k, v in self._restart.items()
                       if k != "pre_kill_alloc_map"}
            pre = self._restart["pre_kill_alloc_map"]
            post = {
                a.id: a.node_id for a in srv.state_store.allocs()
                if a.desired_status == structs.ALLOC_DESIRED_STATUS_RUN
            }
            # Survival = the same alloc id on the same node: a committed
            # placement comes back from the durable log verbatim, not
            # re-placed elsewhere.
            surviving = sum(
                1 for aid, nid in pre.items() if post.get(aid) == nid
            )
            restart["surviving_placements"] = surviving
            restart["placements_survived"] = surviving == len(pre)
            recovery = snap["recovery"]
            rematerialize_ms = (
                (recovery.get("snapshot_restore_ms") or 0.0)
                + (recovery.get("replay_wall_ms") or 0.0)
            )
            restart["placements_rematerialized_per_s"] = (
                round(len(pre) / (rematerialize_ms / 1000.0), 1)
                if rematerialize_ms else None
            )
            out["restart"] = restart
            if not restart["placements_survived"]:
                raise RuntimeError(
                    f"leader restart lost placements: {surviving}/"
                    f"{len(pre)} survived the replay"
                )
        return out

    def _profile_section(self, srv) -> Dict:
        """The runtime observatory's run report (profile_observe.py):
        per-role wall shares from the stack sampler, the lock-contention
        table while the watchdog is installed, and the byte ledger with
        the measured-per-row 1M-node projection. {"enabled": False} in the
        profiler-off contrast arm (presence keeps the schema stable)."""
        obs = srv.runtime_observatory
        if not srv.config.profile_config.enabled:
            return {"enabled": False}
        obs.refresh()
        return {"enabled": True, **obs.snapshot()}

    def _reads_section(self, srv) -> Dict:
        """The read books' run report (read_observe.py): per-route serving
        attribution, the blocking hold/serve split, SSE sessions, watch
        wake economy and staleness, plus the client side of any injected
        read fleet. {"enabled": False} in the reads-off contrast arm. With
        follower fronts, each follower's own books land under
        ``by_member`` and the lanes verdict under ``lanes``."""
        fleet = self._fleet_summary()
        obs = getattr(srv, "read_observatory", None)
        if obs is None or not srv.config.reads_config.enabled:
            out = {"enabled": False}
        else:
            obs.refresh()
            out = {"enabled": True, **obs.snapshot()}
        if fleet:
            out["fleet"] = fleet
        if self._follower_https and out.get("enabled"):
            by_member = {}
            for m in self._followers():
                mobs = getattr(m, "read_observatory", None)
                if mobs is None or not m.config.reads_config.enabled:
                    continue
                mobs.refresh()
                by_member[m.cluster.node_id] = mobs.snapshot()
            out["by_member"] = by_member
        if self._http is not None or self._follower_https:
            out["lanes"] = self._lanes_section(srv)
        return out

    def _lanes_section(self, srv) -> Dict:
        """The consistency-lane verdict block (reads.lanes, the shape
        slo.evaluate_read_lanes reads): per-role serve counts summed over
        every member's read-path books, the follower serve share, the
        stale bound with the client-measured staleness ages, and the
        linearizable floor and freshness-stamp violation counters.
        ``enabled`` false in the leader-only contrast arm."""
        members = self._members or [srv]
        rp_cfg = getattr(srv.config, "read_path_config", None)
        enabled = bool(rp_cfg is not None and rp_cfg.enabled
                       and getattr(srv, "read_path", None) is not None)
        if not enabled:
            return {"enabled": False, "members": len(members)}
        served = {"leader": 0, "follower": 0}
        by_lane: Dict[str, int] = {}
        stale_refused = linear_refused = 0
        for m in members:
            snap = m.read_path.snapshot()
            for role, lanes in snap["served"].items():
                served[role] += sum(lanes.values())
                for lane, n in lanes.items():
                    by_lane[lane] = by_lane.get(lane, 0) + n
            stale_refused += snap["stale"]["refused"]
            linear_refused += snap["linearizable"]["refused"]
        total = served["leader"] + served["follower"]
        with self._lane_lock:
            client = dict(self._lane_books)
            ages = sorted(self._stale_ages_ms)

        def q(p: float) -> float:
            idx = min(len(ages) - 1, max(0, int(round(p * (len(ages) - 1)))))
            return ages[idx]

        return {
            "enabled": True,
            "members": len(members),
            "served": served,
            "by_lane": by_lane,
            "follower_serve_share": (
                round(served["follower"] / total, 4) if total else 0.0
            ),
            "stale_bound_ms": self._stale_bound_ms,
            "stale_age_ms": (
                {"n": len(ages), "p50": round(q(0.50), 2),
                 "p95": round(q(0.95), 2), "max": round(ages[-1], 2)}
                if ages else {"n": 0}
            ),
            "stale_refused": stale_refused,
            "linear_refused": linear_refused,
            "linear_reads": client["linear_reads"],
            "linear_violations": client["linear_violations"],
            "stamp_missing": client["stamp_missing"],
            "client": client,
        }

    def _fleet_summary(self) -> Dict:
        """The per-reader client books summed by population (pollers,
        watchers, sse_tails)."""
        out: Dict[str, Dict] = {}
        for s in self._reader_stats:
            agg = out.setdefault(s["kind"], {})
            for k, v in s.items():
                if k == "kind":
                    continue
                agg[k] = agg.get(k, 0) + v
            agg["readers"] = agg.get("readers", 0) + 1
        return out

    def _solver_panel_section(self) -> Dict:
        """Device-solve efficiency over the measured window: deltas
        against the window-start baseline (the panel is process-global)
        plus the padding-waste trajectory derived from the sampled raw
        padded-axis sums."""
        from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

        p0 = self._panel0 or {}
        p1 = SOLVER_PANEL.snapshot()

        def delta(key):
            return p1.get(key, 0) - p0.get(key, 0)

        trajectory = []
        for s in self._panel_samples:
            live = s["live_rows"] - p0.get("live_rows", 0)
            padded = s["padded_rows"] - p0.get("padded_rows", 0)
            clive = s["count_live"] - p0.get("count_live", 0)
            cpadded = s["count_padded"] - p0.get("count_padded", 0)
            trajectory.append({
                "t_s": round(s["t"] - self._t_measure0, 2),
                "solves": s["solves"] - p0.get("solves", 0),
                "node_padding_waste": round(
                    1.0 - live / padded, 4) if padded else 0.0,
                "count_padding_waste": round(
                    1.0 - clive / cpadded, 4) if cpadded else 0.0,
            })
        placed = delta("placed")
        device_ms = round(delta("device_ms"), 3)
        padded = delta("padded_rows")
        live = delta("live_rows")
        cpadded = delta("count_padded")
        clive = delta("count_live")
        # Batch-width window: per-width dispatch/eval/wall deltas against
        # the window-start baseline.
        bw0 = p0.get("batch_widths", {})
        batch_widths = {}
        for width, row in p1.get("batch_widths", {}).items():
            base = bw0.get(width, {})
            d = row["dispatches"] - base.get("dispatches", 0)
            ev = row["evals"] - base.get("evals", 0)
            ms = round(row["device_ms"] - base.get("device_ms", 0.0), 3)
            if d:
                batch_widths[width] = {
                    "dispatches": d, "evals": ev, "device_ms": ms,
                    "device_ms_per_eval": round(ms / ev, 4) if ev else 0.0,
                }
        eq0 = p0.get("equiv", {})
        eq1 = p1.get("equiv", {})
        return {
            "window": {
                "solves": delta("solves"),
                "requested": delta("requested"),
                "placed": placed,
                "device_ms": device_ms,
                "device_ms_per_placement": round(
                    device_ms / placed, 4) if placed else 0.0,
                "node_padding_waste": round(
                    1.0 - live / padded, 4) if padded else 0.0,
                "count_padding_waste": round(
                    1.0 - clive / cpadded, 4) if cpadded else 0.0,
                "batch_widths": batch_widths,
                "equiv": {
                    k: eq1.get(k, 0) - eq0.get(k, 0)
                    for k in ("classes", "members", "copies",
                              "rows_saved")
                },
            },
            "trajectory": trajectory,
            # Process-lifetime views (include the pre-window warmup).
            "node_buckets": p1["node_buckets"],
            "count_buckets": p1["count_buckets"],
            "compiles": p1["compiles"],
        }


def _contrast_spec(spec: ScenarioSpec) -> ScenarioSpec:
    overrides = {**spec.server_overrides, **spec.contrast_overrides}
    return dataclasses.replace(
        spec, server_overrides=overrides, contrast_overrides=None)


def profiler_overhead(profiled: Dict, disabled: Dict) -> Optional[Dict]:
    """The profiled arm's plan p50 against the profiler-off arm's (None
    when either arm planned nothing)."""
    p_on = (profiled.get("plan_latency_ms") or {}).get("p50_ms")
    p_off = (disabled.get("plan_latency_ms") or {}).get("p50_ms")
    if not (p_on and p_off):
        return None
    return {
        "plan_p50_ms_profiled": p_on,
        "plan_p50_ms_disabled": p_off,
        "overhead_fraction": round(p_on / p_off - 1.0, 4),
    }


def _equilibrium_rate(srv, fleet) -> float:
    from nomad_tpu_torch.server.heartbeat import rate_scaled_interval

    n = len(fleet.live_nodes())
    if n == 0:
        return 0.0
    base = rate_scaled_interval(
        srv.config.max_heartbeats_per_second,
        srv.config.min_heartbeat_ttl, n,
    )
    # E[1/ttl] for ttl ~ U[T, 2T] is ln2/T.
    return n * math.log(2) / (fleet.beat_fraction * base)


def _backend_name(device: torch.device) -> str:
    """The torch device the run solved on, with the card's name on CUDA."""
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def run_scenario(name: str, seed: int = 42, out_path: Optional[str] = None,
                 n_nodes: Optional[int] = None,
                 logger: Optional[logging.Logger] = None,
                 attribution_layer: bool = True,
                 contrast: bool = True, device=None) -> Dict:
    """Run one named scenario on ``device`` (default the CUDA card);
    optionally write the JSON artifact. When the spec declares a
    contrast arm it runs after the main arm and a trimmed summary lands
    in ``artifact["contrast"]``; a profiler-off arm adds the
    ``profiler_overhead`` verdict. ``contrast=False`` skips it
    (determinism re-verification compares main arms only)."""
    spec = SCENARIOS.get(name)
    if spec is None:
        raise KeyError(
            f"unknown scenario {name!r} (have: {sorted(SCENARIOS)})"
        )
    artifact = ScenarioRunner(
        spec, seed=seed, n_nodes=n_nodes, logger=logger,
        attribution_layer=attribution_layer, device=device,
    ).run()
    if contrast and spec.contrast_overrides is not None:
        contrast_spec = _contrast_spec(spec)
        overrides = contrast_spec.server_overrides
        full = ScenarioRunner(
            contrast_spec, seed=seed, n_nodes=n_nodes, logger=logger,
            attribution_layer=attribution_layer, device=device,
        ).run()
        att = full.get("latency_attribution") or {}
        artifact["contrast"] = {
            "run": True,
            "server_overrides": overrides,
            "placements": full["placements"],
            "peaks": full["peaks"],
            "plan_latency_ms": full["plan_latency_ms"],
            "submit_to_placed_ms": att.get("submit_to_placed_ms"),
            "slo_check": att.get("slo_check"),
            "admission": full["admission"],
            "events": {"observed": full["events"]["observed"],
                       "truncated": full["events"]["truncated"]},
        }
        if spec.contrast_digest_invariant:
            # The off arm's decision-invariance verdict.
            artifact["contrast"]["events"]["digest"] = \
                full["events"]["digest"]
            artifact["contrast"]["digest_matches"] = (
                full["events"]["digest"] == artifact["events"]["digest"]
            )
            artifact["contrast"]["capacity"] = full.get("capacity")
            artifact["contrast"]["reads"] = full.get("reads")
            artifact["contrast"]["profile"] = full.get("profile")
        if ((spec.contrast_overrides.get("profile") or {})
                .get("enabled") is False):
            # Profiler-overhead verdict: same-seed arms do identical
            # plan work, so the plan p50 delta is the profiler's cost.
            artifact["contrast"]["profiler_overhead"] = profiler_overhead(
                artifact, full)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=2, sort_keys=True)
            f.write("\n")
    return artifact
