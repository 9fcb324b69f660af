"""Chaos scenario compiler: declarative fault storms, correlated
failure domains, crash-recovery scenarios — compiled onto the runner.

Port of nomad_tpu/simcluster/chaos.py onto the port's runner, spec for
spec: the same grammar, validation, compiled schedules, verdicts and
families, so each family's canonical digest can be held to nomad_tpu's.
The families run their placements on the runner's device.

Other failure scenarios are hand-written runner code (the leader
restart, the churn tranche). This module makes the failure modes
that actually take down cells DECLARATIVE: a chaos spec is a plain
mapping — phases x workload mix x fault storm x kill schedule — parsed
and validated up front (the agent-config posture: an impossible spec
fails at parse time with a named field, never mid-run), then compiled
into an ordinary :class:`ScenarioSpec` the existing runner executes.
Everything downstream (simload, determinism verification) works on
chaos families for free because the compiler's output is just another
registered scenario.

Spec grammar::

    {
      "name": "rack-failure",
      "description": "...",
      "nodes":  {"count": 256, "racks": 32, "spares": 8},
      "cluster": {"members": 3, "overrides": {...ClusterConfig...}},
      "server": {...ServerConfig overrides...},
      "run": {"quiesce_timeout": ..., "warmup_count": ...,
              "ack_cap": ..., "durable_raft": ...},
      "phases": [            # each: "at" + exactly ONE directive
        {"at": 0.0, "workload": [{"kind": "steady", ...params}]},
        {"at": 5.0, "barrier": {"timeout": 90.0}},
        {"at": 5.1, "expand_spares": true},
        {"at": 6.0, "kill": {"rack": 3}},          # or {"follower": 0}
        {"at": 8.0, "restart": {"follower": true}},
      ],
      "storm": {"sites": {...faults.py plan, {leader}/{followerN}
                          role placeholders allowed in strings...}},
      "assert": {"exactly_once_replacement": true, ...},
      "objectives": {"submit_to_placed_p95_ms": 15000.0},
    }

The three shipped families:

- **rack-failure** — correlated failure domain: the fleet is carved
  into racks (count/racks nodes each), one full-node job pinned per
  node, a barrier proves the fill fully placed, a spare tranche
  registers, then ONE WHOLE RACK is silenced together. The dead rack's
  TTL cohort expires through the timer wheel as a batch (heartbeat.py's
  batched expiry -> server.node_batch_expire: one shared snapshot, one
  eval_upsert — not a per-node broker storm) and the verdict is
  exactly-once: every lost alloc re-placed exactly once, every
  untouched job untouched.
- **partition-flap** — a seeded one-way raft partition (leader->
  follower0 appends dropped) flapping on a faults.py flap window
  timeline during a placement burst, with follower0's votes suppressed
  so the short flaps can never force an election: the cell must keep
  committing on the remaining quorum with NO duplicate PlanApplied, no
  leadership change, and bounded plan-latency degradation (the family's
  scenario-scoped SLO).
- **follower-crash-rejoin** — a follower killed outright mid-load and
  restarted from its durable journal past the leader's snapshot
  threshold: the rejoin rides the chunked InstallSnapshot path
  (raft/node.py) racing live appends while the cell keeps serving, and
  the verdict is fsm_state_digest equality between the rejoined
  follower and the leader plus a counted multi-chunk install.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from nomad_tpu_torch import slo, structs
from nomad_tpu_torch.simcluster.scenario import SCENARIOS, ScenarioSpec, _quantiles
from nomad_tpu_torch.simcluster.workload import (
    Action,
    BatchBurstInjector,
    Injector,
    NodeRefreshInjector,
    SteadyServiceInjector,
    build_job,
)

# Full-node shape of simnode.sim_node: a rack-fill task occupies its
# host completely, so the fill is a node<->job bijection and the rack
# kill's re-placements can only land on the spare tranche.
_SIM_NODE_CPU = 4000
_SIM_NODE_MEMORY_MB = 8192


class RackFillInjector(Injector):
    """One full-node service job per fleet node, registered at an even
    deterministic cadence over ``over`` seconds: ``jobs`` jobs x 1 task
    sized to the whole node. After the fill quiesces the cell is a
    bijection (every node hosts exactly one job), which is what makes
    the rack kill's exactly-once verdict sharp: each dead node loses
    exactly one alloc, and its replacement has exactly one place to
    go — the spare tranche."""

    name = "rack-fill"

    def __init__(self, seed: int, jobs: int, over: float = 4.0,
                 cpu: int = _SIM_NODE_CPU,
                 memory_mb: int = _SIM_NODE_MEMORY_MB):
        super().__init__(seed)
        self.jobs = jobs
        self.over = over
        self.cpu = cpu
        self.memory_mb = memory_mb

    def actions(self) -> List[Action]:
        out = []
        gap = self.over / max(self.jobs - 1, 1)
        for k in range(self.jobs):
            jid = f"rack-fill-{k:05d}"
            out.append(Action(
                at=k * gap, kind="register_job",
                payload={"job_key": jid, "build": self._job_factory(jid)},
            ))
        return out

    def _job_factory(self, jid: str):
        count, cpu, mem = 1, self.cpu, self.memory_mb
        return lambda: build_job(jid, structs.JOB_TYPE_SERVICE, count,
                                 cpu=cpu, memory_mb=mem)


class _PhaseActions:
    """A fixed, pre-built action list wearing the injector interface —
    how compiled phase directives (barrier/kill/expand/restart) and
    phase-shifted workload injectors ride the runner's ordinary
    sort-and-pace loop."""

    def __init__(self, actions: List[Action]):
        self._actions = actions

    def actions(self) -> List[Action]:
        return list(self._actions)


# Workload vocabulary: kind -> (build function, allowed params, required
# params). Each build function takes (seed, params, chaos_spec) so
# rack_fill can default its job count to the fleet size.
def _build_steady(seed, p, _cs):
    return SteadyServiceInjector(
        seed, jobs=int(p["jobs"]), tasks_per_job=int(p["tasks_per_job"]),
        over=float(p["over"]), cpu=int(p.get("cpu", 100)),
        memory_mb=int(p.get("memory_mb", 128)))


def _build_burst(seed, p, _cs):
    return BatchBurstInjector(
        seed, bursts=int(p["bursts"]),
        jobs_per_burst=int(p["jobs_per_burst"]),
        tasks_per_job=int(p["tasks_per_job"]),
        gap=float(p.get("gap", 5.0)), cpu=int(p.get("cpu", 100)),
        memory_mb=int(p.get("memory_mb", 128)))


def _build_node_refresh(seed, p, _cs):
    return NodeRefreshInjector(
        seed, count=int(p["count"]), every=float(p["every"]),
        start=float(p.get("start", 0.5)), until=float(p.get("until", 10.0)))


def _build_rack_fill(seed, p, cs):
    return RackFillInjector(
        seed, jobs=int(p.get("jobs", cs.n_nodes)),
        over=float(p.get("over", 4.0)),
        cpu=int(p.get("cpu", _SIM_NODE_CPU)),
        memory_mb=int(p.get("memory_mb", _SIM_NODE_MEMORY_MB)))


WORKLOAD_KINDS: Dict[str, tuple] = {
    "steady": (_build_steady,
               {"jobs", "tasks_per_job", "over", "cpu", "memory_mb"},
               {"jobs", "tasks_per_job", "over"}),
    "burst": (_build_burst,
              {"bursts", "jobs_per_burst", "tasks_per_job", "gap",
               "cpu", "memory_mb"},
              {"bursts", "jobs_per_burst", "tasks_per_job"}),
    "node_refresh": (_build_node_refresh,
                     {"count", "every", "start", "until"},
                     {"count", "every"}),
    "rack_fill": (_build_rack_fill,
                  {"jobs", "over", "cpu", "memory_mb"}, set()),
}

# The declarative assertion vocabulary (the "assert" block): every flag
# maps to a verdict the compiled chaos_check judges against the
# finished artifact + live cluster, RAISING on violation.
ASSERT_FLAGS = frozenset({
    "exactly_once_replacement",  # every lost alloc re-placed once
    "no_duplicate_plans",        # no PlanApplied key seen twice
    "leader_stable",             # zero Leader topic events in-window
    "storm_transitions",         # every flap rule: 2xcount transitions
    "rejoin_digest_equal",       # follower FSM digest == leader's
    "require_install_snapshot",  # rejoin came via chunked install
})

_TOP_KEYS = frozenset({"name", "description", "nodes", "cluster",
                       "server", "run", "phases", "storm", "assert",
                       "objectives"})
_PHASE_DIRECTIVES = frozenset({"workload", "barrier", "expand_spares",
                               "kill", "restart"})
_RUN_KEYS = frozenset({"quiesce_timeout", "warmup_count", "ack_cap",
                       "durable_raft"})


class ChaosSpecError(ValueError):
    """A chaos spec that cannot compile — raised at parse time with the
    offending field named, never mid-run."""


def _reject_unknown(mapping: Dict, allowed, where: str) -> None:
    unknown = sorted(set(mapping) - set(allowed))
    if unknown:
        raise ChaosSpecError(
            f"chaos spec {where}: unknown key(s) {unknown} "
            f"(allowed: {sorted(allowed)})")


@dataclass
class ChaosPhase:
    at: float
    directive: str          # one of _PHASE_DIRECTIVES
    workload: List[Dict] = field(default_factory=list)
    barrier_timeout: float = 60.0
    kill_rack: Optional[int] = None
    kill_follower: Optional[int] = None


@dataclass
class ChaosSpec:
    """One parsed chaos scenario: validated structure, ready to
    compile() into a ScenarioSpec."""

    name: str
    description: str
    n_nodes: int
    racks: int
    spares: int
    cluster_members: int
    cluster_overrides: Dict
    server_overrides: Dict
    phases: List[ChaosPhase]
    storm: Optional[Dict]
    asserts: Dict[str, bool]
    objectives: Dict[str, float]
    quiesce_timeout: float = 120.0
    warmup_count: int = 300
    ack_cap: int = 0
    durable_raft: bool = False

    @property
    def rack_size(self) -> int:
        return self.n_nodes // self.racks if self.racks else 0

    def rack_nodes(self, rack: int) -> List[str]:
        size = self.rack_size
        return [f"sim-{i:05d}"
                for i in range(rack * size, (rack + 1) * size)]

    # -- parsing -------------------------------------------------------------

    @classmethod
    def parse(cls, raw: Dict) -> "ChaosSpec":
        if not isinstance(raw, dict):
            raise ChaosSpecError("chaos spec must be a mapping")
        _reject_unknown(raw, _TOP_KEYS, "top level")
        name = raw.get("name")
        if not name or not isinstance(name, str):
            raise ChaosSpecError("chaos spec needs a non-empty 'name'")
        where = f"{name!r}"

        nodes = raw.get("nodes")
        if not isinstance(nodes, dict) or "count" not in nodes:
            raise ChaosSpecError(
                f"{where}: 'nodes' must be a mapping with 'count'")
        _reject_unknown(nodes, {"count", "racks", "spares"},
                        f"{where} nodes")
        n_nodes = int(nodes["count"])
        racks = int(nodes.get("racks", 0))
        spares = int(nodes.get("spares", 0))
        if n_nodes <= 0:
            raise ChaosSpecError(f"{where}: nodes.count must be positive")
        if racks:
            if racks <= 0 or n_nodes % racks:
                raise ChaosSpecError(
                    f"{where}: nodes.racks must divide nodes.count "
                    f"({n_nodes} % {racks} != 0)")
        if spares < 0:
            raise ChaosSpecError(f"{where}: nodes.spares must be >= 0")

        cluster = raw.get("cluster") or {}
        _reject_unknown(cluster, {"members", "overrides"},
                        f"{where} cluster")
        members = int(cluster.get("members", 1))
        if members < 1:
            raise ChaosSpecError(f"{where}: cluster.members must be >= 1")

        run = raw.get("run") or {}
        _reject_unknown(run, _RUN_KEYS, f"{where} run")
        durable = bool(run.get("durable_raft", False))

        phases_raw = raw.get("phases")
        if not isinstance(phases_raw, list) or not phases_raw:
            raise ChaosSpecError(
                f"{where}: 'phases' must be a non-empty list")
        phases: List[ChaosPhase] = []
        saw_follower_kill = False
        for i, ph in enumerate(phases_raw):
            pw = f"{where} phases[{i}]"
            if not isinstance(ph, dict) or "at" not in ph:
                raise ChaosSpecError(f"{pw}: needs 'at'")
            _reject_unknown(ph, {"at"} | _PHASE_DIRECTIVES, pw)
            directives = sorted(set(ph) & _PHASE_DIRECTIVES)
            if len(directives) != 1:
                raise ChaosSpecError(
                    f"{pw}: exactly one directive of "
                    f"{sorted(_PHASE_DIRECTIVES)} required, "
                    f"got {directives}")
            d = directives[0]
            at = float(ph["at"])
            if at < 0:
                raise ChaosSpecError(f"{pw}: 'at' must be >= 0")
            phase = ChaosPhase(at=at, directive=d)
            if d == "workload":
                wl = ph["workload"]
                if not isinstance(wl, list) or not wl:
                    raise ChaosSpecError(
                        f"{pw}: workload must be a non-empty list")
                for j, w in enumerate(wl):
                    ww = f"{pw} workload[{j}]"
                    if not isinstance(w, dict) or "kind" not in w:
                        raise ChaosSpecError(f"{ww}: needs 'kind'")
                    kind = w["kind"]
                    if kind not in WORKLOAD_KINDS:
                        raise ChaosSpecError(
                            f"{ww}: unknown kind {kind!r} (have: "
                            f"{sorted(WORKLOAD_KINDS)})")
                    _, allowed, required = WORKLOAD_KINDS[kind]
                    _reject_unknown(w, allowed | {"kind"}, ww)
                    missing = sorted(required - set(w))
                    if missing:
                        raise ChaosSpecError(
                            f"{ww}: kind {kind!r} missing required "
                            f"param(s) {missing}")
                phase.workload = [dict(w) for w in wl]
            elif d == "barrier":
                b = ph["barrier"]
                if isinstance(b, dict):
                    _reject_unknown(b, {"timeout"}, f"{pw} barrier")
                    phase.barrier_timeout = float(b.get("timeout", 60.0))
                elif b is not True:
                    raise ChaosSpecError(
                        f"{pw}: barrier must be true or "
                        "{'timeout': seconds}")
            elif d == "expand_spares":
                if not spares:
                    raise ChaosSpecError(
                        f"{pw}: expand_spares needs nodes.spares > 0")
                if ph["expand_spares"] is not True:
                    raise ChaosSpecError(
                        f"{pw}: expand_spares must be true (sizing "
                        "comes from nodes.spares)")
            elif d == "kill":
                k = ph["kill"]
                if not isinstance(k, dict) or len(k) != 1:
                    raise ChaosSpecError(
                        f"{pw}: kill must be {{'rack': N}} or "
                        "{'follower': N}")
                if "rack" in k:
                    if not racks:
                        raise ChaosSpecError(
                            f"{pw}: kill.rack needs nodes.racks set")
                    r = int(k["rack"])
                    if not 0 <= r < racks:
                        raise ChaosSpecError(
                            f"{pw}: kill.rack {r} out of range "
                            f"[0, {racks})")
                    phase.kill_rack = r
                elif "follower" in k:
                    f_idx = int(k["follower"])
                    if members < 3:
                        raise ChaosSpecError(
                            f"{pw}: kill.follower needs cluster.members "
                            ">= 3 (a 2-member cell loses quorum)")
                    if not 0 <= f_idx < members - 1:
                        raise ChaosSpecError(
                            f"{pw}: kill.follower {f_idx} out of range "
                            f"[0, {members - 1})")
                    phase.kill_follower = f_idx
                    saw_follower_kill = True
                else:
                    raise ChaosSpecError(
                        f"{pw}: kill must name 'rack' or 'follower'")
            elif d == "restart":
                r = ph["restart"]
                if r != {"follower": True}:
                    raise ChaosSpecError(
                        f"{pw}: restart must be {{'follower': true}}")
                if not saw_follower_kill:
                    raise ChaosSpecError(
                        f"{pw}: restart.follower needs an earlier "
                        "kill.follower phase")
                if not durable:
                    raise ChaosSpecError(
                        f"{pw}: restart.follower needs "
                        "run.durable_raft=true (nothing to replay "
                        "otherwise)")
            phases.append(phase)
        if [p.at for p in phases] != sorted(p.at for p in phases):
            raise ChaosSpecError(
                f"{where}: phases must be sorted by 'at'")

        storm = raw.get("storm")
        if storm is not None:
            if (not isinstance(storm, dict)
                    or not isinstance(storm.get("sites"), dict)
                    or not storm["sites"]):
                raise ChaosSpecError(
                    f"{where}: storm must be a mapping with non-empty "
                    "'sites'")
            if members < 3 and _mentions_roles(storm):
                raise ChaosSpecError(
                    f"{where}: storm uses {{leader}}/{{followerN}} "
                    "placeholders but cluster.members < 3")

        asserts_raw = raw.get("assert") or {}
        _reject_unknown(asserts_raw, ASSERT_FLAGS, f"{where} assert")
        asserts = {k: bool(v) for k, v in asserts_raw.items()}
        if asserts.get("rejoin_digest_equal") and not saw_follower_kill:
            raise ChaosSpecError(
                f"{where}: assert.rejoin_digest_equal needs a "
                "kill.follower + restart.follower schedule")
        if asserts.get("storm_transitions") and storm is None:
            raise ChaosSpecError(
                f"{where}: assert.storm_transitions needs a 'storm'")
        if asserts.get("exactly_once_replacement") and not any(
                p.kill_rack is not None or p.directive == "kill"
                for p in phases):
            raise ChaosSpecError(
                f"{where}: assert.exactly_once_replacement needs a "
                "kill phase")

        objectives = dict(raw.get("objectives") or {})
        for oname, oms in objectives.items():
            slo.Objective.parse(oname, oms)  # parse-time validation

        return cls(
            name=name,
            description=str(raw.get("description", "")),
            n_nodes=n_nodes, racks=racks, spares=spares,
            cluster_members=members,
            cluster_overrides=dict(cluster.get("overrides") or {}),
            server_overrides=dict(raw.get("server") or {}),
            phases=phases,
            storm=storm,
            asserts=asserts,
            objectives=objectives,
            quiesce_timeout=float(run.get("quiesce_timeout", 120.0)),
            warmup_count=int(run.get("warmup_count", 300)),
            ack_cap=int(run.get("ack_cap", 0)),
            durable_raft=durable,
        )

    # -- compilation ---------------------------------------------------------

    def _phase_action(self, phase: ChaosPhase) -> Action:
        if phase.directive == "barrier":
            return Action(at=phase.at, kind="barrier",
                          payload={"timeout": phase.barrier_timeout})
        if phase.directive == "expand_spares":
            return Action(at=phase.at, kind="expand_fleet",
                          payload={"start": self.n_nodes,
                                   "count": self.spares})
        if phase.directive == "kill":
            if phase.kill_rack is not None:
                return Action(
                    at=phase.at, kind="fail_nodes",
                    payload={"node_ids": self.rack_nodes(phase.kill_rack)})
            return Action(at=phase.at, kind="kill_follower",
                          payload={"index": phase.kill_follower})
        if phase.directive == "restart":
            return Action(at=phase.at, kind="restart_follower", payload={})
        raise AssertionError(phase.directive)  # parse() exhausted these

    def storm_horizon(self) -> Optional[float]:
        """Upper bound (seconds from arm) on the storm's scheduled
        timeline: the last flap window of any rule ends by
        ``count*period``, an explicit window list by its max end.
        ``None`` when no rule carries a schedule (pure probability
        storms have no horizon to outlive)."""
        horizon = None
        for rule in (self.storm or {}).get("sites", {}).values():
            end = None
            if rule.get("flap"):
                end = (int(rule["flap"]["count"])
                       * float(rule["flap"].get("period", 1.0)))
            elif rule.get("windows"):
                end = max(float(w[1]) for w in rule["windows"])
            if end is not None:
                horizon = end if horizon is None else max(horizon, end)
        return horizon

    def compile(self) -> ScenarioSpec:
        """The compiled runner input: phase workloads become seeded
        injectors shifted to their phase offset, kill/barrier/expand/
        restart directives become single runner actions, the storm
        becomes the armed faults plan, and the assert flags become the
        chaos_check verdict closure."""
        cspec = self

        def injectors(seed: int) -> List:
            out: List = []
            for phase in cspec.phases:
                if phase.directive == "workload":
                    for w in phase.workload:
                        build, _a, _r = WORKLOAD_KINDS[w["kind"]]
                        inj = build(
                            seed, {k: v for k, v in w.items()
                                   if k != "kind"}, cspec)
                        out.append(_PhaseActions([
                            Action(at=a.at + phase.at, kind=a.kind,
                                   payload=a.payload)
                            for a in inj.actions()
                        ]))
                else:
                    out.append(_PhaseActions(
                        [cspec._phase_action(phase)]))
            horizon = cspec.storm_horizon()
            if horizon is not None:
                # The run must OUTLIVE the storm: a fast workload can
                # quiesce before the last flap window opens, leaving the
                # tail of the scheduled timeline unwalked — the artifact
                # then honestly reports fewer transitions than the spec
                # promised and storm_transitions trips on wall-clock
                # luck. One no-op action paced past the horizon pins the
                # action loop open until every scheduled edge is history
                # (margin covers the load->pacer-epoch skew, which is
                # the stats-snapshot block between them, microseconds).
                out.append(_PhaseActions([
                    Action(at=horizon + 0.25, kind="settle", payload={})
                ]))
            return out

        return ScenarioSpec(
            name=cspec.name,
            n_nodes=cspec.n_nodes,
            injectors=injectors,
            quiesce_timeout=cspec.quiesce_timeout,
            server_overrides=dict(cspec.server_overrides),
            faults_spec=(dict(cspec.storm) if cspec.storm else None),
            warmup_count=cspec.warmup_count,
            ack_cap=cspec.ack_cap,
            deterministic=True,
            durable_raft=cspec.durable_raft,
            cluster_overrides=dict(cspec.cluster_overrides),
            cluster_members=cspec.cluster_members,
            chaos_check=_make_chaos_check(cspec),
            description=cspec.description,
        )


def _mentions_roles(obj) -> bool:
    if isinstance(obj, str):
        return "{leader}" in obj or "{follower" in obj
    if isinstance(obj, dict):
        return any(_mentions_roles(v) for v in obj.values())
    if isinstance(obj, list):
        return any(_mentions_roles(v) for v in obj)
    return False


# ---------------------------------------------------------------------------
# The compiled verdict
# ---------------------------------------------------------------------------

def _make_chaos_check(cspec: ChaosSpec) -> Callable:
    """Build the spec's chaos_check closure: judge every declared
    assert flag against the finished artifact + live cluster state,
    bank the chaos books into the artifact's chaos section, and RAISE
    on any violated invariant (exactly-once is a contract, not a
    statistic — the _raft_section placements-survived posture)."""

    def chaos_check(runner, srv, artifact) -> Dict:
        with runner._events_lock:
            events = list(runner._events)
        out: Dict = {"family": cspec.name, "checks": []}
        violations: List[str] = []

        def verdict(name: str, ok: bool, detail: str = "", **extra):
            out["checks"].append({"check": name, "ok": bool(ok),
                                  **extra})
            if not ok:
                violations.append(f"{name}: {detail or extra}")

        flags = cspec.asserts
        if flags.get("no_duplicate_plans"):
            seen: Dict[str, int] = {}
            for e in events:
                if e.topic == "Plan" and e.type == "PlanApplied":
                    seen[e.key] = seen.get(e.key, 0) + 1
            dupes = sorted(k for k, n in seen.items() if n > 1)
            verdict("no_duplicate_plans", not dupes,
                    f"{len(dupes)} plan keys applied more than once",
                    plans_applied=len(seen), duplicates=dupes[:10])

        if flags.get("leader_stable"):
            flips = [e.type for e in events if e.topic == "Leader"]
            verdict("leader_stable", not flips,
                    f"leadership changed in-window: {flips[:6]}",
                    leader_events=len(flips))

        if flags.get("storm_transitions"):
            _check_storm(artifact, verdict)

        if flags.get("exactly_once_replacement"):
            _check_exactly_once(runner, srv, artifact, events,
                                cspec, out, verdict)

        if (flags.get("rejoin_digest_equal")
                or flags.get("require_install_snapshot")):
            _check_rejoin(runner, srv, flags, out, verdict)

        out["ok"] = not violations
        if violations:
            raise RuntimeError(
                f"chaos scenario {cspec.name!r} violated "
                f"{len(violations)} invariant(s): "
                + "; ".join(violations))
        return out

    return chaos_check


def _check_storm(artifact: Dict, verdict) -> None:
    """Every flap-scheduled rule must have walked its full timeline:
    one armed + one disarmed edge per window (transitions == 2 x
    count), and the storm must actually have fired (an armed window
    nothing hit would make the whole family vacuous)."""
    sites = (artifact.get("faults") or {}).get("sites") or {}
    flap_rules = []
    for site, rules in sites.items():
        for r in rules:
            if r.get("flap"):
                flap_rules.append((site, r))
    if not flap_rules:
        verdict("storm_transitions", False,
                "no flap rules in the armed storm")
        return
    for site, r in flap_rules:
        want = 2 * int(r["flap"]["count"])
        got = int(r.get("transitions", 0))
        fired = int(r.get("fired", 0))
        verdict(f"storm_transitions[{site}]",
                got == want and fired > 0,
                f"transitions {got} != {want} or fired {fired} == 0",
                transitions=got, expected=want, fired=fired)


def _check_exactly_once(runner, srv, artifact, events, cspec,
                        out, verdict) -> None:
    """The rack-failure contract: every alloc lost with the dead rack
    re-placed EXACTLY once on a surviving node, every untouched job
    untouched, every dead node expired through the timer wheel. Also
    banks the expiry->re-placement latency distribution."""
    book = runner._chaos.get("killed_nodes") or {}
    killed = set(book.get("nodes") or [])
    hosted: Dict[str, List[str]] = book.get("hosted_jobs") or {}
    snap = srv.state_store.snapshot()
    bad: List[str] = []
    replaced = 0
    on_spares = 0
    for jid, lost in sorted(hosted.items()):
        rows = snap.allocs_by_job(jid)
        live = [a for a in rows
                if (a.desired_status == structs.ALLOC_DESIRED_STATUS_RUN
                    and a.node_id not in killed)]
        if len(live) != 1:
            bad.append(f"{jid}: {len(live)} live replacements")
            continue
        if len(rows) != len(lost) + 1:
            bad.append(f"{jid}: {len(rows)} alloc rows "
                       f"(want {len(lost) + 1})")
            continue
        replaced += 1
        idx = int(live[0].node_id.rsplit("-", 1)[1])
        if idx >= cspec.n_nodes:
            on_spares += 1
    untouched_bad = 0
    for jid, job in runner._jobs.items():
        if job.id in hosted:
            continue
        rows = snap.allocs_by_job(job.id)
        live = [a for a in rows
                if a.desired_status == structs.ALLOC_DESIRED_STATUS_RUN]
        if len(rows) != 1 or len(live) != 1:
            untouched_bad += 1
            bad.append(f"{job.id}: untouched job has {len(rows)} rows/"
                       f"{len(live)} live")
    expirations = (artifact.get("heartbeat") or {}).get("expirations")
    verdict("exactly_once_replacement",
            not bad and replaced == len(hosted),
            f"{len(bad)} jobs broke exactly-once: {bad[:6]}",
            lost_jobs=len(hosted), replaced=replaced,
            replaced_on_spares=on_spares,
            untouched_violations=untouched_bad)
    verdict("all_killed_expired", expirations == len(killed),
            f"expirations {expirations} != killed {len(killed)}",
            expirations=expirations, killed=len(killed))
    # Expiry -> re-placement latency: for each NodeHeartbeatExpired,
    # the wait until the next PlanApplied at or after it (the
    # re-placement evals are the only plans left after the barrier).
    expiries = sorted(e.time for e in events
                      if e.type == "NodeHeartbeatExpired")
    plans = sorted(e.time for e in events
                   if e.topic == "Plan" and e.type == "PlanApplied")
    waits = []
    for te in expiries:
        i = bisect.bisect_left(plans, te)
        if i < len(plans):
            waits.append(plans[i] - te)
    out["expiry_replacement_ms"] = _quantiles(waits)


def _check_rejoin(runner, srv, flags, out, verdict) -> None:
    """The follower-crash-rejoin contract: the restarted follower
    catches the leader up (applied index converges), its FSM digest
    equals the leader's (raft_observe.fsm_state_digest — the
    same yardstick the replay tests pin), and — when required — the
    rejoin actually rode the chunked InstallSnapshot path."""
    from nomad_tpu_torch.raft_observe import fsm_state_digest

    t = runner._rejoin_thread
    if t is not None:
        t.join(timeout=120.0)
    restart_book = runner._chaos.get("follower_restart") or {}
    name = restart_book.get("node_id")
    follower = next((m for m in runner._members
                     if m.cluster.node_id == name), None)
    if follower is None:
        verdict("rejoin_digest_equal", False,
                f"restarted follower {name!r} not found")
        return
    # Converge-then-compare with a stability re-check: the leader's
    # applied index may still tick (post-quiesce stragglers), so the
    # digests only count when taken at one matched index.
    deadline = time.monotonic() + 90.0
    matched = False
    d_leader = d_follower = None
    while time.monotonic() < deadline:
        la = srv.raft.applied_index
        if follower.raft.applied_index >= la:
            d_leader = fsm_state_digest(srv.state_store)
            d_follower = fsm_state_digest(follower.state_store)
            if d_leader == d_follower and srv.raft.applied_index == la:
                matched = True
                break
        time.sleep(0.05)
    if flags.get("rejoin_digest_equal"):
        verdict("rejoin_digest_equal", matched,
                f"follower digest {d_follower} != leader {d_leader} "
                f"(follower applied {follower.raft.applied_index}, "
                f"leader {srv.raft.applied_index})",
                fsm_state_digest=d_leader)
    if flags.get("require_install_snapshot"):
        chunks = follower.raft.snapshot_chunks_received
        verdict("require_install_snapshot", chunks >= 2,
                f"follower received {chunks} snapshot chunks (want a "
                "real chunked install, >= 2)",
                chunks_received=chunks)
    out["time_to_rejoin_ms"] = restart_book.get("time_to_rejoin_ms")
    out["follower_restart"] = dict(restart_book)
    out["follower_kill"] = dict(
        runner._chaos.get("follower_kill") or {})


# ---------------------------------------------------------------------------
# The shipped families
# ---------------------------------------------------------------------------

RACK_FAILURE = {
    "name": "rack-failure",
    "description": (
        "correlated failure domain: 256 nodes in 32 racks of 8, one "
        "full-node service job pinned per node (a barrier proves the "
        "fill placed), an 8-node spare tranche registers, then rack 3 "
        "dies together — the whole TTL cohort expires through the "
        "timer wheel as a batch (one shared snapshot, one coalesced "
        "eval_upsert) and every lost alloc is re-placed exactly once "
        "on the spares"),
    "nodes": {"count": 256, "racks": 32, "spares": 8},
    "server": {
        # ONE worker: the fill is a full-node bijection, and concurrent
        # workers racing for the last empty nodes strand losers as
        # blocked evals (placement becomes a race outcome, not a seed
        # outcome). Serial eval processing makes every placement a pure
        # function of registration order.
        "scheduler_workers": 1,
        # TTLs sized so NO node renews before the rack dies (first beat
        # lands at 0.8*ttl >= 24s, the kill at ~8s): every dead node's
        # expiry deadline is then its bring-up arm plus its seeded
        # jitter — a pure function of the seed, not of whether a renewal
        # squeaked in under the kill. The seeded jitter also spreads the
        # 8 deadlines ~seconds apart, so re-placement plans never
        # overlap in the plan pipeline (an overlapping pair can trim and
        # re-plan, which is wall-clock noise in the event stream).
        "min_heartbeat_ttl": 30.0,
        "max_heartbeats_per_second": 2000.0,
        "event_buffer_size": 16384,
    },
    # warmup_count=0: a warmup job would occupy a node and break the
    # fill's node<->job bijection.
    "run": {"warmup_count": 0, "ack_cap": 0, "quiesce_timeout": 360.0},
    "phases": [
        {"at": 0.0, "workload": [{"kind": "rack_fill", "over": 4.0}]},
        # Everything placed BEFORE the spares exist: re-placements can
        # then only land on the spare tranche.
        {"at": 4.5, "barrier": {"timeout": 120.0}},
        {"at": 4.6, "expand_spares": True},
        {"at": 5.5, "kill": {"rack": 3}},
    ],
    # exactly_once_replacement IS the family's duplicate detector: a
    # double-committed replacement plan would leave two live allocs for
    # a lost job. A per-eval PlanApplied-count assert would be wrong
    # here — a plan trimmed against a racing expiry apply legitimately
    # re-plans under the same eval id, and WHEN that happens is wall
    # clock, not seed.
    "assert": {"exactly_once_replacement": True},
    # The fill's cold first solve and the TTL expiry wait are part of
    # the family by design; the objective bounds the re-placement
    # story, not the steady-state cell SLO.
    "objectives": {"submit_to_placed_p95_ms": 15000.0},
}

PARTITION_FLAP = {
    "name": "partition-flap",
    "description": (
        "seeded one-way raft partition flapping during a burst: "
        "leader->follower0 appends drop on 5 armed flap windows "
        "(faults.py scheduled timelines) while a 900-task burst "
        "places; follower0's votes are suppressed so the short flaps "
        "can never force an election — the cell keeps committing on "
        "the remaining quorum with no duplicate PlanApplied, no "
        "leadership change, and bounded plan-latency degradation"),
    "nodes": {"count": 400},
    "cluster": {
        "members": 3,
        "overrides": {
            # Election timeouts far above the 0.6s armed windows: the
            # partitioned follower misses a few heartbeats per flap but
            # never reaches its campaign deadline.
            "election_timeout_min": 2.5,
            "election_timeout_max": 5.0,
            "heartbeat_interval": 0.1,
            # The membership prober must not reap the flapped follower.
            "suspicion_threshold": 1000,
        },
    },
    "server": {
        "scheduler_workers": 2,
        "event_buffer_size": 16384,
        # 400/2 = 200s TTLs: no heartbeat traffic inside the window.
        "max_heartbeats_per_second": 2.0,
    },
    "run": {"quiesce_timeout": 180.0, "warmup_count": 150, "ack_cap": 0},
    "phases": [
        {"at": 0.5, "workload": [{
            "kind": "burst", "bursts": 1, "jobs_per_burst": 6,
            "tasks_per_job": 150,
        }]},
    ],
    "storm": {"sites": {
        # One-way: leader->follower0 replication drops while armed;
        # follower1 never misses an append, so commit quorum holds.
        "raft.append": {
            "mode": "drop", "probability": 1.0,
            "match": "{leader}->{follower0}",
            "flap": {"period": 1.2, "duty": 0.5, "count": 5,
                     "jitter": 0.2},
        },
        # Belt and suspenders: even if follower0 somehow campaigned,
        # its vote requests die — the leader_stable assert is about the
        # flap being survivable, not about winning re-elections.
        "raft.vote": {
            "mode": "drop", "probability": 1.0,
            "match": "{follower0}->",
        },
    }},
    "assert": {"no_duplicate_plans": True, "leader_stable": True,
               "storm_transitions": True},
    "objectives": {"submit_to_placed_p95_ms": 5000.0},
}

FOLLOWER_CRASH_REJOIN = {
    "name": "follower-crash-rejoin",
    "description": (
        "crash recovery under load: a 3-member durable cell serves the "
        "steady workload while a follower is killed outright at t=3s "
        "and restarted from its journal at t=8s — by then the leader "
        "has snapshotted past it (threshold 24, trailing 8), so the "
        "rejoin rides the chunked InstallSnapshot path (4 KiB chunks) "
        "racing live appends; the verdict is fsm_state_digest equality "
        "with the leader plus a counted multi-chunk install, and the "
        "cell never stops placing"),
    "nodes": {"count": 500},
    "cluster": {
        "members": 3,
        "overrides": {
            # Compressed compaction: the 5s downtime MUST put the
            # follower behind the leader's log start so the rejoin is
            # an InstallSnapshot, not a quiet tail replay.
            "snapshot_threshold": 24,
            "trailing_logs": 8,
            "snapshot_chunk_bytes": 4096,
            "suspicion_threshold": 1000,
            # Wide elections: 3 servers share one GIL, and production
            # 150-300ms timeouts churn leadership under load (the
            # tests/cluster_util.py lesson) — which would point the
            # whole fleet at a deposed front door mid-run.
            "election_timeout_min": 2.5,
            "election_timeout_max": 5.0,
            "heartbeat_interval": 0.1,
        },
    },
    "server": {
        "scheduler_workers": 2,
        "event_buffer_size": 16384,
        # 500/2 = 250s TTLs: no heartbeat traffic inside the window.
        "max_heartbeats_per_second": 2.0,
    },
    "run": {"durable_raft": True, "quiesce_timeout": 240.0,
            "ack_cap": 0},
    "phases": [
        {"at": 0.0, "workload": [
            {"kind": "steady", "jobs": 10, "tasks_per_job": 120,
             "over": 12.0},
            # Steady node-write load: every refresh is a raft entry, so
            # the kill->restart window accumulates well past the
            # snapshot threshold.
            {"kind": "node_refresh", "count": 12, "every": 0.25,
             "start": 0.5, "until": 11.5},
        ]},
        {"at": 3.0, "kill": {"follower": 0}},
        {"at": 8.0, "restart": {"follower": True}},
    ],
    # Digest equality subsumes duplicate detection here: a plan applied
    # twice on either side would split the FSM digests.
    "assert": {"rejoin_digest_equal": True,
               "require_install_snapshot": True},
    "objectives": {"submit_to_placed_p95_ms": 5000.0},
}

FAMILIES = (RACK_FAILURE, PARTITION_FLAP, FOLLOWER_CRASH_REJOIN)


def register(raw: Dict) -> ScenarioSpec:
    """Parse + compile one chaos spec and register it as an ordinary
    named scenario (simload sees it); scenario-scoped SLO objectives
    land in slo.SCENARIO_OBJECTIVES, which the artifact's own slo_check
    reads."""
    cspec = ChaosSpec.parse(raw)
    spec = cspec.compile()
    SCENARIOS[cspec.name] = spec
    if cspec.objectives:
        slo.SCENARIO_OBJECTIVES.setdefault(
            cspec.name,
            {**slo.DEFAULT_OBJECTIVES, **cspec.objectives})
    return spec


for _raw in FAMILIES:
    register(_raw)
