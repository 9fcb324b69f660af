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

Left out until their modules are ported, each named in the artifact's
``not_ported`` list (``NOT_PORTED_SECTIONS``); a section is absent, never
reported as zero:

- the attribution layer's ``latency_attribution`` and ``slo`` sections
  (``lifecycle.py``, ``slo.py``). ``attribution_layer`` keeps its meaning
  for the tracer (off: no spans); the runner never sets
  ``slo_objectives``, which the port's ServerConfig refuses;
- the lock watchdog (``telemetry.LockWatchdog`` with ``tools/nomadlint``'s
  analysis of nomad_tpu's own sources);
- admission's controller books and typed rejections
  (``server/admission.py``): the ``admission`` section keeps the
  injector's offered count and the queue caps;
- the capacity, raft, reads (with its lanes), profile and express
  sections, and the capacity branch of the depth sampler;
- a spec's contrast arm where its overrides need one of those modules:
  ``steady-10k``'s profiler-off arm is recorded as not run, with why.

A scenario that needs an unported module (``unported_needs``: a server
override in ``server.NOT_PORTED``, a leader restart, a read storm, an
express stream, impolite pacing, a chaos action, fault storm or verdict)
raises :class:`NotPortedError` naming the modules before anything
starts. It never runs a quietly
reduced version. Runnable in this package: ``steady-1k``, ``steady-10k``,
``steady-100k-nodes``, ``burst-100k`` and ``churn``.
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

from nomad_tpu_torch import structs
from nomad_tpu_torch.api.codec import to_dict
from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.rpc import RemoteError
from nomad_tpu_torch.server.cluster import (
    ClusterConfig,
    ClusterServer,
    wait_for_leader,
)
from nomad_tpu_torch.server.server import NOT_PORTED, ServerConfig
from nomad_tpu_torch.simcluster.simnode import SimFleet, sim_node
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

# Sections of nomad_tpu's artifact whose modules the port does not have
# yet, with what each needs (the artifact's "not_ported" list).
NOT_PORTED_SECTIONS = {
    "admission.controller": NOT_PORTED["admission"],
    "capacity": NOT_PORTED["capacity"],
    "express": NOT_PORTED["express"],
    "latency_attribution": "end-to-end attribution (lifecycle.py, slo.py)",
    "lock_watchdog": "the lock watchdog (telemetry.LockWatchdog, "
                     "tools/nomadlint)",
    "profile": NOT_PORTED["profile"],
    "raft": NOT_PORTED["raft_observe"],
    "reads": NOT_PORTED["reads"],
    "reads.lanes": NOT_PORTED["read_path"],
    "slo": NOT_PORTED["slo_objectives"],
}

_CHAOS = "the chaos families (simcluster/chaos.py)"
# Action kinds whose machinery waits for a module the port does not have.
_ACTION_NEEDS = {
    "restart_leader": "the raft observatory (raft_observe.py), which "
                      "holds the restart's placements-survived verdict",
    "read_storm": "the HTTP API and the follower read plane (api/http.py, "
                  "server/read_path.py)",
    **{kind: _CHAOS for kind in ("barrier", "expand_fleet", "settle",
                                 "kill_follower", "restart_follower")},
}


class NotPortedError(RuntimeError):
    """A scenario needs a module nomad_tpu_torch does not have yet."""


@dataclass
class ScenarioSpec:
    name: str
    n_nodes: int
    injectors: Callable[[int], List]  # seed -> injector list
    quiesce_timeout: float = 120.0
    # Server knobs merged over the scenario default config.
    server_overrides: Dict = field(default_factory=dict)
    # Optional faults {} block armed (with the run seed) for the window
    # (the chaos families' storms; refused until chaos.py is ported).
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
    # Chaos verdict hook (nomad_tpu/simcluster/chaos.py, not ported yet):
    # a spec that sets it is refused.
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
            # Profiler-off contrast arm (needs profile_observe.py: the
            # port records it as not run).
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


def unported_needs(spec: ScenarioSpec, seed: int = 0) -> List[str]:
    """The modules ``spec`` needs that nomad_tpu_torch does not have yet,
    sorted (empty: the port runs it whole)."""
    needs = {NOT_PORTED[k] for k in spec.server_overrides if k in NOT_PORTED}
    for inj in spec.injectors(seed):
        for a in inj.actions():
            if a.kind in _ACTION_NEEDS:
                needs.add(_ACTION_NEEDS[a.kind])
            if a.payload.get("express"):
                needs.add(NOT_PORTED["express"])
            # Impolite pacing measures the admission door.
            if a.payload.get("impolite"):
                needs.add(NOT_PORTED["admission"])
    if spec.chaos_check is not None or spec.faults_spec is not None:
        needs.add(_CHAOS)
    return sorted(needs)


def _not_ported_message(what: str, needs: List[str]) -> str:
    return (f"{what} needs " + "; ".join(needs)
            + ", which nomad_tpu_torch does not have yet")


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


class ScenarioRunner:
    def __init__(self, spec: ScenarioSpec, seed: int = 42,
                 logger: Optional[logging.Logger] = None,
                 n_nodes: Optional[int] = None,
                 attribution_layer: bool = True,
                 device=None):
        self.spec = spec
        self.seed = int(seed)
        self.n_nodes = int(n_nodes or spec.n_nodes)
        # False runs the identical scenario with the tracer disabled (no
        # spans). Decisions must not depend on it (digest-pinned).
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
        self._offered = 0
        # Solver-panel trajectory, sampled at 2 Hz by the depth sampler.
        self._panel_samples: List[Dict] = []
        self._t_measure0 = 0.0
        self._panel0: Optional[Dict] = None
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._data_dir: Optional[str] = None
        # Multi-member bookkeeping (cluster_members > 1): every live
        # member (leader first after election) and the shared peers table.
        self._members: List[ClusterServer] = []
        self._peers: Dict[str, str] = {}

    # -- observation --------------------------------------------------------

    def _start_watcher(self, broker, cursor: int) -> None:
        """Tail one event broker into the run's event list."""
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
                with self._events_lock:
                    self._events.extend(evs)
                cursor = latest
            if done:
                return
            time.sleep(0.05)

    def _sample_depths(self, srv) -> None:
        from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

        tick = 0
        while not self._stop.wait(0.1):
            tick += 1
            if tick % 5 == 0:
                # 2 Hz: the solver panel's raw padded-axis sums, which
                # the artifact differences into in-window waste series.
                p = SOLVER_PANEL.snapshot()
                self._panel_samples.append({
                    "t": time.perf_counter(),
                    "solves": p["solves"],
                    "placed": p["placed"],
                    "device_ms": p["device_ms"],
                    "live_rows": p["live_rows"],
                    "padded_rows": p["padded_rows"],
                    "count_live": p["count_live"],
                    "count_padded": p["count_padded"],
                })
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

    def _register_job(self, fleet: SimFleet, payload: Dict) -> str:
        """One Job.Register through the real RPC front door. Returns the
        eval id. (nomad_tpu's runner also counts typed rejections here:
        they come from admission control, not ported yet.)"""
        job = payload["build"]()
        self._offered += 1
        args = {"job": to_dict(job)}
        if payload.get("client_id"):
            args["client_id"] = payload["client_id"]
        out = fleet._pool().call(
            self._srv.rpc_addr, "Job.Register", args,
            timeout=fleet.rpc_timeout,
        )
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
        """Silence a seeded ``count`` sample of nodes, preferring
        alloc-hosting ones so the migration path is driven. (nomad_tpu's
        runner also books the hosted allocs for the chaos verdicts.)"""
        snap = self._srv.state_store.snapshot()
        live = set(fleet.live_nodes())
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
        fleet.fail(pick)
        self.logger.info("simcluster: silenced %d nodes", len(pick))
        return pick

    def _cluster_config(self, data_dir: Optional[str] = None
                        ) -> ClusterConfig:
        kwargs = dict(bootstrap_expect=1, bind_port=0)
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
        needs = unported_needs(spec, self.seed)
        if needs:
            raise NotPortedError(
                _not_ported_message(f"scenario {spec.name!r}", needs))
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
        if spec.durable_raft and self._data_dir is None:
            self._data_dir = tempfile.mkdtemp(prefix="nomad-sim-raft-")
        members = self._build_cluster(cfg_kwargs)
        srv = self._srv = members[0]
        fleet = SimFleet(srv.rpc_addr, logger=self.logger)
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

            # Phase 3: measured window. Cursor excludes bring-up/warmup.
            broker = srv.fsm.events
            cursor = broker.get_index()
            hb0 = srv.heartbeat.stats()
            t_measure0 = time.perf_counter()
            dispatches0 = GLOBAL_SOLVER.dispatches
            mirror0 = GLOBAL_MIRROR_CACHE.stats()
            pipe0 = srv.plan_pipeline.stats()
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
            expected_evals: List[str] = []
            failed_tranche: List[str] = []
            for action in actions:
                delay = t0 + action.at - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                if action.kind == "register_job":
                    expected_evals.append(
                        self._register_job(fleet, action.payload))
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
                else:
                    raise NotPortedError(_not_ported_message(
                        f"action {action.kind!r}",
                        [_ACTION_NEEDS.get(action.kind, "its module")]))

            self._wait_quiesced(srv, expected_evals, failed_tranche,
                                time.monotonic() + spec.quiesce_timeout)
            wall = time.perf_counter() - t_run0
            measured = time.perf_counter() - t_measure0
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
                k: pipe1[k] - pipe0[k]
                for k in ("batches", "plans", "committed", "noops",
                          "conflicts", "refreshes", "fused_plans",
                          "scalar_plans")
            }
            pipeline["max_batch_seen"] = pipe1["max_batch_seen"]

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
            fleet.stop()
            for m in members:
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
        marked down (its expiry fans out more evals), and the broker
        drained."""
        down_needed = set(failed_tranche)
        pending: List[str] = list(expected_evals)
        while time.monotonic() < deadline:
            snap = srv.state_store.snapshot()
            if down_needed:
                # Order-independent filter: only its emptiness is read.
                down_needed = {
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
            if not pending and not down_needed and busy == 0:
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"scenario did not quiesce: pending_evals={len(pending)}"
            f"/{len(expected_evals)}, nodes_still_up={len(down_needed)}"
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
        not_ported = [{"section": k, "needs": v}
                      for k, v in sorted(NOT_PORTED_SECTIONS.items())]
        if self.spec.contrast_overrides is not None:
            needs = _contrast_needs(self.spec, self.seed)
            if needs:
                not_ported.append({"section": "contrast",
                                   "needs": "; ".join(needs)})

        caps = {
            "eval_pending_cap": srv.config.eval_pending_cap,
            "plan_queue_cap": srv.config.plan_queue_cap,
        }
        return {
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
            # The injector's offered registrations and the queue caps; the
            # controller's books and typed rejections wait for admission.py.
            "admission": {
                "injector": {"offered": self._offered},
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
            "solver_panel": self._solver_panel_section(),
            "not_ported": not_ported,
        }

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


def _contrast_needs(spec: ScenarioSpec, seed: int) -> List[str]:
    return unported_needs(_contrast_spec(spec), seed)


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
    in ``artifact["contrast"]``; an arm whose overrides need a module the
    port does not have yet is not run, and the section says so and why.
    ``contrast=False`` skips it (determinism re-verification compares main
    arms only)."""
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
        needs = unported_needs(contrast_spec, seed)
        if needs:
            artifact["contrast"] = {
                "run": False,
                "server_overrides": overrides,
                "reason": _not_ported_message("the contrast arm", needs),
            }
        else:
            full = ScenarioRunner(
                contrast_spec, seed=seed, n_nodes=n_nodes, logger=logger,
                attribution_layer=attribution_layer, device=device,
            ).run()
            artifact["contrast"] = {
                "run": True,
                "server_overrides": overrides,
                "placements": full["placements"],
                "peaks": full["peaks"],
                "plan_latency_ms": full["plan_latency_ms"],
                "admission": full["admission"],
                "events": {"observed": full["events"]["observed"],
                           "truncated": full["events"]["truncated"]},
            }
            if spec.contrast_digest_invariant:
                # The off arm's decision-invariance verdict.
                artifact["contrast"]["events"]["digest"] = \
                    full["events"]["digest"]
                artifact["contrast"]["digest_matches"] = (
                    full["events"]["digest"]
                    == artifact["events"]["digest"]
                )
    if out_path:
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=2, sort_keys=True)
            f.write("\n")
    return artifact
