"""The port's chaos compiler (simcluster/chaos.py), its ``solver.execute``
fault site and the express lane's reconcile hand-over, against nomad_tpu.

- Spec parsing and compiling: every rejection of ``tests/test_chaos.py``
  raises the same error with the same message in both packages; phase
  offsets, rack domains, the rack-fill bijection and the storm horizon
  compile to nomad_tpu's schedules (the whole payload compared).
- The registered families: the same raw specs, members, durable raft,
  storms, actions and scenario objectives as nomad_tpu's ``SCENARIOS``.
- The verdicts: one synthetic run (chaos book, jobs, store, events,
  artifact) given to both packages' ``chaos_check`` gives the same
  section, or raises the same violations.
- ``solver.execute``: armed with ``count=1`` it fails the first solve of
  an eval with ``DeviceFault``; the eval is nacked, redelivered and
  completes with exactly its count live. The same site raises on the CPU
  path of the harness. There is no breaker and no host route.
- The express reconcile hand-over retries a forward that found no leader,
  and a retry of one that already applied places nothing twice.

Tolerance: exact.
"""

import random
import threading
import time
import types

import pytest

from nomad_tpu import slo as jslo
from nomad_tpu.api.codec import to_dict as jax_to_dict
from nomad_tpu.simcluster import chaos as jch
from nomad_tpu.simcluster import scenario as jsc
from nomad_tpu_torch import faults, mock, slo, structs
from nomad_tpu_torch.api.codec import to_dict as port_to_dict
from nomad_tpu_torch.harness import Harness
from nomad_tpu_torch.raft import NotLeaderError
from nomad_tpu_torch.rpc import RPCTimeoutError
from nomad_tpu_torch.server import express as pexp
from nomad_tpu_torch.simcluster import chaos as pch
from nomad_tpu_torch.simcluster import scenario as psc
from nomad_tpu_torch.structs import Evaluation, generate_uuid
from test_torch_express import dev_server, express_job, register_nodes, wait


@pytest.fixture(autouse=True)
def clean_faults():
    faults.get_registry().clear()
    yield
    faults.get_registry().clear()


def minimal(**over):
    raw = {
        "name": "t",
        "nodes": {"count": 8},
        "phases": [{"at": 0.0, "workload": [
            {"kind": "steady", "jobs": 1, "tasks_per_job": 1, "over": 1.0},
        ]}],
    }
    raw.update(over)
    return raw


def payload_view(payload, to_dict):
    out = {}
    for k, v in payload.items():
        if k == "build":
            out[k] = to_dict(v())
        elif isinstance(v, random.Random):
            out[k] = v.getstate()
        else:
            out[k] = v
    return out


def actions(spec, seed, to_dict):
    return sorted(((a.at, a.kind, repr(payload_view(a.payload, to_dict)))
                   for inj in spec.injectors(seed) for a in inj.actions()))


def compiled_pair(raw, seed=7):
    got = pch.ChaosSpec.parse(raw).compile()
    ref = jch.ChaosSpec.parse(raw).compile()
    return (actions(got, seed, port_to_dict),
            actions(ref, seed, jax_to_dict))


# -- parsing and compiling ----------------------------------------------------

BAD_SPECS = {
    "unknown_key": minimal(bogus=1),
    "racks_divide": minimal(nodes={"count": 8, "racks": 3}),
    "workload_kind": minimal(phases=[{"at": 0, "workload": [
        {"kind": "nope"}]}]),
    "workload_param": minimal(phases=[{"at": 0, "workload": [
        {"kind": "steady", "jobs": 1}]}]),
    "two_directives": minimal(phases=[{"at": 0, "barrier": True,
                                       "expand_spares": True}]),
    "kill_follower_one_member": minimal(phases=[{"at": 0, "kill": {
        "follower": 0}}]),
    "kill_rack_no_racks": minimal(phases=[{"at": 0, "kill": {"rack": 0}}]),
    "restart_without_kill": minimal(
        cluster={"members": 3}, run={"durable_raft": True},
        phases=[{"at": 0, "restart": {"follower": True}}]),
    "restart_not_durable": minimal(
        cluster={"members": 3},
        phases=[{"at": 0, "kill": {"follower": 0}},
                {"at": 1, "restart": {"follower": True}}]),
    "spares": minimal(phases=[{"at": 0, "expand_spares": True}]),
    "assert_flag": minimal(**{"assert": {"definitely_fine": True}}),
    "storm_transitions": minimal(**{"assert": {"storm_transitions": True}}),
    "roles_one_member": minimal(storm={"sites": {"raft.append": {
        "mode": "drop", "match": "{leader}->x"}}}),
    "phase_order": minimal(phases=[
        {"at": 2.0, "barrier": True},
        {"at": 1.0, "workload": [{"kind": "steady", "jobs": 1,
                                  "tasks_per_job": 1, "over": 1.0}]},
    ]),
    "objective": minimal(objectives={"not_a_metric": 100.0}),
    "no_name": {"nodes": {"count": 8}, "phases": []},
    "not_a_mapping": "rack-failure",
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_bad_spec_rejected_as_reference(case):
    raw = BAD_SPECS[case]
    with pytest.raises(ValueError) as got:
        pch.ChaosSpec.parse(raw)
    with pytest.raises(ValueError) as ref:
        jch.ChaosSpec.parse(raw)
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)


def test_minimal_spec_compiles_as_reference():
    spec = pch.ChaosSpec.parse(minimal()).compile()
    assert spec.n_nodes == 8 and spec.deterministic is True
    got, ref = compiled_pair(minimal(), seed=42)
    assert got == ref and [k for _at, k, _p in got] == ["register_job"]


@pytest.mark.parametrize("at", [0.0, 2.5, 7.25])
def test_phase_offsets_shift_workload_as_reference(at):
    raw = minimal(phases=[{"at": at, "workload": [
        {"kind": "steady", "jobs": 3, "tasks_per_job": 2, "over": 1.0},
        {"kind": "node_refresh", "count": 2, "every": 0.5},
    ]}])
    got, ref = compiled_pair(raw)
    assert got == ref
    assert min(a for a, _k, _p in got) >= at


def test_rack_nodes_are_contiguous_domains():
    for mod in (pch, jch):
        cspec = mod.ChaosSpec.parse(minimal(nodes={"count": 16,
                                                   "racks": 4}))
        assert cspec.rack_size == 4
        assert cspec.rack_nodes(0) == [f"sim-{i:05d}" for i in range(4)]
        assert cspec.rack_nodes(3) == [f"sim-{i:05d}"
                                       for i in range(12, 16)]


def test_rack_fill_bijection_equals_reference():
    got = pch.RackFillInjector(42, jobs=4, over=3.0).actions()
    ref = jch.RackFillInjector(42, jobs=4, over=3.0).actions()
    assert [(a.at, a.kind, payload_view(a.payload, port_to_dict))
            for a in got] == [(a.at, a.kind,
                               payload_view(a.payload, jax_to_dict))
                              for a in ref]
    job = got[0].payload["build"]()
    assert got[-1].at == pytest.approx(3.0)
    assert job.task_groups[0].count == 1
    assert job.task_groups[0].tasks[0].resources.cpu == 4000
    assert len({a.payload["job_key"] for a in got}) == 4


STORMS = {
    "flap": {"raft.append": {"mode": "drop", "probability": 1.0,
                             "flap": {"period": 1.2, "duty": 0.5,
                                      "count": 5, "jitter": 0.2}},
             "raft.vote": {"mode": "drop", "probability": 1.0}},
    "windows": {"raft.append": {"mode": "drop",
                                "windows": [[0.5, 1.0], [2.0, 3.5]]}},
    "unscheduled": {"raft.append": {"mode": "drop", "probability": 0.1}},
}


@pytest.mark.parametrize("storm, horizon", [
    ("flap", 6.0), ("windows", 3.5), ("unscheduled", None)])
def test_storm_horizon_equals_reference(storm, horizon):
    raw = minimal(storm={"sites": STORMS[storm]})
    got = pch.ChaosSpec.parse(raw)
    assert got.storm_horizon() == jch.ChaosSpec.parse(raw).storm_horizon()
    assert got.storm_horizon() == (None if horizon is None
                                   else pytest.approx(horizon))
    pa, ra = compiled_pair(raw)
    assert pa == ra
    settles = [a for a, k, _p in pa if k == "settle"]
    assert settles == ([] if horizon is None else [horizon + 0.25])
    assert got.compile().faults_spec == {"sites": STORMS[storm]}


# -- the registered families --------------------------------------------------


def test_families_equal_reference():
    assert pch.FAMILIES == jch.FAMILIES
    assert pch.ASSERT_FLAGS == jch.ASSERT_FLAGS
    assert set(pch.WORKLOAD_KINDS) == set(jch.WORKLOAD_KINDS)


@pytest.mark.parametrize("name", [raw["name"] for raw in jch.FAMILIES])
def test_family_registered_as_reference(name):
    got, ref = psc.SCENARIOS[name], jsc.SCENARIOS[name]
    assert got.chaos_check is not None
    for f in ("n_nodes", "cluster_members", "durable_raft",
              "cluster_overrides", "server_overrides", "faults_spec",
              "warmup_count", "ack_cap", "quiesce_timeout",
              "deterministic"):
        assert getattr(got, f) == getattr(ref, f), f
    assert (actions(got, 42, port_to_dict)
            == actions(ref, 42, jax_to_dict))
    assert slo.SCENARIO_OBJECTIVES[name] == jslo.SCENARIO_OBJECTIVES[name]


def test_family_shapes():
    s = psc.SCENARIOS
    assert s["partition-flap"].cluster_members == 3
    assert s["rack-failure"].cluster_members == 1
    assert s["follower-crash-rejoin"].durable_raft is True
    kills = [a for i in s["rack-failure"].injectors(42)
             for a in i.actions() if a.kind == "fail_nodes"]
    assert [k.payload["node_ids"] for k in kills] == [
        [f"sim-{i:05d}" for i in range(24, 32)]]
    kinds = {a.kind for i in s["follower-crash-rejoin"].injectors(42)
             for a in i.actions()}
    assert {"kill_follower", "restart_follower"} <= kinds


# -- the verdicts on one synthetic run ----------------------------------------


def alloc(aid, node_id, status="run"):
    return types.SimpleNamespace(id=aid, node_id=node_id,
                                 desired_status=status)


class Snap:
    def __init__(self, by_job):
        self.by_job = by_job

    def snapshot(self):
        return self

    def allocs_by_job(self, jid):
        return list(self.by_job.get(jid, []))


def event(topic, etype, key, t):
    return types.SimpleNamespace(topic=topic, type=etype, key=key, time=t)


def rack_run(variant):
    """A rack of two dead nodes hosting jobs j0, j1; j2 untouched; spare
    node sim-00008 past n_nodes=8."""
    by_job = {
        "j0": [alloc("a0", "sim-00000", "stop"), alloc("a0r", "sim-00008")],
        "j1": [alloc("a1", "sim-00001", "stop"), alloc("a1r", "sim-00003")],
        "j2": [alloc("a2", "sim-00005")],
    }
    expirations = 2
    if variant == "twice":
        by_job["j0"].append(alloc("a0x", "sim-00004"))
    elif variant == "lost":
        by_job["j1"] = [alloc("a1", "sim-00001", "stop")]
    elif variant == "untouched":
        by_job["j2"].append(alloc("a2x", "sim-00006"))
    elif variant == "expiry":
        expirations = 1
    runner = types.SimpleNamespace(
        _events_lock=threading.Lock(),
        _events=[event("Node", "NodeHeartbeatExpired", "sim-00000", 1.0),
                 event("Plan", "PlanApplied", "e1", 1.5),
                 event("Node", "NodeHeartbeatExpired", "sim-00001", 2.0),
                 event("Plan", "PlanApplied", "e2", 2.25)],
        _chaos={"killed_nodes": {"nodes": ["sim-00000", "sim-00001"],
                                 "hosted_jobs": {"j0": ["a0"],
                                                 "j1": ["a1"]}}},
        _jobs={k: types.SimpleNamespace(id=k) for k in by_job},
    )
    srv = types.SimpleNamespace(state_store=Snap(by_job))
    artifact = {"heartbeat": {"expirations": expirations}}
    return runner, srv, artifact


def storm_run(variant):
    rule = {"flap": {"count": 5}, "transitions": 10, "fired": 7}
    if variant == "short":
        rule["transitions"] = 8
    elif variant == "unfired":
        rule["fired"] = 0
    sites = {"raft.append": [rule], "raft.vote": [{"fired": 3}]}
    if variant == "no_flap":
        sites = {"raft.vote": [{"fired": 3}]}
    events = [event("Plan", "PlanApplied", f"e{k}", k) for k in range(3)]
    if variant == "duplicate":
        events.append(event("Plan", "PlanApplied", "e1", 9))
    if variant == "leader":
        events.append(event("Leader", "LeaderAcquired", "s1", 5))
    runner = types.SimpleNamespace(
        _events_lock=threading.Lock(), _events=events,
        _chaos={}, _jobs={})
    return runner, None, {"faults": {"sites": sites}}


def verdict(mod, raw, run):
    cspec = mod.ChaosSpec.parse(raw)
    check = mod._make_chaos_check(cspec)
    try:
        return ("ok", check(*run))
    except RuntimeError as e:
        return ("raised", str(e))


RACK = {"name": "rack", "nodes": {"count": 8, "racks": 4, "spares": 1},
        "phases": [{"at": 0.0, "kill": {"rack": 0}}],
        "assert": {"exactly_once_replacement": True}}
FLAP = {"name": "flap", "nodes": {"count": 8},
        "cluster": {"members": 3},
        "phases": [{"at": 0.0, "workload": [
            {"kind": "burst", "bursts": 1, "jobs_per_burst": 1,
             "tasks_per_job": 1}]}],
        "storm": {"sites": STORMS["flap"]},
        "assert": {"no_duplicate_plans": True, "leader_stable": True,
                   "storm_transitions": True}}


@pytest.mark.parametrize("variant", ["good", "twice", "lost", "untouched",
                                     "expiry"])
def test_exactly_once_verdict_equals_reference(variant):
    got = verdict(pch, RACK, rack_run(variant))
    ref = verdict(jch, RACK, rack_run(variant))
    assert got == ref
    assert got[0] == ("ok" if variant == "good" else "raised")
    if variant == "good":
        checks = {c["check"]: c for c in got[1]["checks"]}
        assert checks["exactly_once_replacement"]["replaced_on_spares"] == 1
        assert got[1]["expiry_replacement_ms"]["n"] == 2


@pytest.mark.parametrize("variant", ["good", "short", "unfired", "no_flap",
                                     "duplicate", "leader"])
def test_storm_verdicts_equal_reference(variant):
    got = verdict(pch, FLAP, storm_run(variant))
    ref = verdict(jch, FLAP, storm_run(variant))
    assert got == ref
    assert got[0] == ("ok" if variant == "good" else "raised")


class DigestStore:
    def __init__(self, allocs):
        self._allocs = allocs

    def snapshot(self):
        return self

    def nodes(self):
        return [types.SimpleNamespace(id="n1", status="ready", drain=False,
                                      modify_index=3)]

    def jobs(self):
        return [types.SimpleNamespace(id="j1", type="service",
                                      modify_index=4)]

    def evals(self):
        return []

    def allocs(self):
        return [types.SimpleNamespace(id=a, node_id="n1", job_id="j1",
                                      desired_status="run",
                                      client_status="pending")
                for a in self._allocs]

    def get_index(self, table):
        return {"nodes": 3, "jobs": 4, "evals": 0, "allocs": 9}[table]


def rejoin_run(chunks):
    def member(node_id, applied, chunks_received):
        return types.SimpleNamespace(
            cluster=types.SimpleNamespace(node_id=node_id),
            raft=types.SimpleNamespace(
                applied_index=applied,
                snapshot_chunks_received=chunks_received),
            state_store=DigestStore(["a1", "a2"]))

    leader = member("server-0", 40, 0)
    follower = member("server-1", 40, chunks)
    runner = types.SimpleNamespace(
        _events_lock=threading.Lock(), _events=[],
        _rejoin_thread=None, _members=[leader, follower],
        _chaos={"follower_restart": {"node_id": "server-1",
                                     "time_to_rejoin_ms": 812.5},
                "follower_kill": {"node_id": "server-1"}})
    return runner, leader, {}


REJOIN = {"name": "rejoin", "nodes": {"count": 8},
          "cluster": {"members": 3}, "run": {"durable_raft": True},
          "phases": [{"at": 0.0, "kill": {"follower": 0}},
                     {"at": 1.0, "restart": {"follower": True}}],
          "assert": {"rejoin_digest_equal": True,
                     "require_install_snapshot": True}}


@pytest.mark.parametrize("chunks", [1, 3])
def test_rejoin_verdict_equals_reference(chunks):
    got = verdict(pch, REJOIN, rejoin_run(chunks))
    ref = verdict(jch, REJOIN, rejoin_run(chunks))
    assert got == ref
    assert got[0] == ("ok" if chunks > 1 else "raised")
    if chunks > 1:
        assert got[1]["time_to_rejoin_ms"] == 812.5


# -- the solver.execute fault site --------------------------------------------


def test_solver_execute_site_and_modes_equal_reference():
    from nomad_tpu import faults as jfaults

    assert faults.SITE_MODES["solver.execute"] == \
        jfaults.SITE_MODES["solver.execute"]
    assert issubclass(faults.DeviceFault, faults.FaultError)


def batch_job(count):
    job = mock.job()
    job.type = structs.JOB_TYPE_BATCH
    job.task_groups[0].count = count
    job.task_groups[0].tasks[0].resources.networks = []
    job.task_groups[0].tasks[0].resources.cpu = 50
    return job


@pytest.mark.parametrize("count", [20, 300])
def test_solver_execute_fault_fails_the_eval_then_it_completes(count):
    """Counts of 20 take the greedy scan's dispatch, 300 the water-fill's.
    The first solve raises DeviceFault; the worker nacks; the redelivery
    places exactly ``count``."""
    from nomad_tpu_torch.server.server import Server, ServerConfig

    srv = Server(ServerConfig(device="cpu", scheduler_workers=1,
                              min_heartbeat_ttl=3600.0,
                              prewarm_shapes=False))
    srv.start()
    try:
        srv.node_batch_register([mock.node() for _ in range(40)])
        faults.get_registry().configure("solver.execute", mode="error",
                                        count=1)
        job = batch_job(count)
        eid, _ = srv.job_register(job)
        ev = srv.wait_for_eval(eid, timeout=60.0)
        assert ev.status == structs.EVAL_STATUS_COMPLETE
        rule = faults.get_registry().snapshot()["sites"]["solver.execute"]
        assert rule[0]["fired"] == 1
        live = [a for a in srv.state_store.allocs_by_job(job.id)
                if not a.terminal_status()]
        assert len(live) == count
    finally:
        srv.shutdown()


def test_solver_execute_fault_raises_on_the_cpu_path():
    h = Harness()
    for _ in range(64):
        h.state.upsert_node(h.next_index(), mock.node())
    job = batch_job(300)
    h.state.upsert_job(h.next_index(), job)
    ev = Evaluation(id=generate_uuid(), priority=50, type=job.type,
                    triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER,
                    job_id=job.id)
    faults.get_registry().configure("solver.execute", mode="drop", count=1)
    with pytest.raises(faults.DeviceFault, match="solver.execute"):
        h.process("tpu-batch", ev, device="cpu")
    # The rule is spent: the same eval now places on the same CPU path.
    h.process("tpu-batch", ev, device="cpu")
    assert sum(b.n for b in h.plans[-1].alloc_batches) == 300


# -- the express reconcile hand-over ------------------------------------------


def held_entry(srv, jid):
    lane = srv.express_lane
    lane.commit_gate.clear()
    job = express_job(jid)
    srv.job_register(job)
    assert lane.backlog() == 1
    # The commit finds no leader: the committer takes the slow path.
    real_submit = srv.plan_submit
    calls = {"n": 0}

    def plan_submit(plan):
        calls["n"] += 1
        if calls["n"] == 1:
            raise NotLeaderError("")
        return real_submit(plan)

    srv.plan_submit = plan_submit
    return job


def reconcile_evals(srv, job):
    return [e for e in srv.state_store.evals_by_job(job.id)
            if e.triggered_by == pexp.EVAL_TRIGGER_EXPRESS_RECONCILE]


def live_allocs(srv, job):
    return [a for a in srv.state_store.allocs_by_job(job.id)
            if not a.terminal_status()]


@pytest.mark.parametrize("failure", ["no_leader", "lost_response"])
def test_reconcile_hand_over_is_retried_and_places_once(failure):
    """``no_leader``: the first forward finds no leader (NotLeaderError)
    and never ran; ``lost_response``: the first hand-over applied and its
    answer was lost (RPCTimeoutError). Either way the retry lands and the
    task is placed exactly once, by one reconcile eval."""
    srv = dev_server(workers=1)
    try:
        register_nodes(srv, 4)
        job = held_entry(srv, f"exp-handover-{failure}")
        real = srv.express_reconcile
        calls = []

        def express_reconcile(j, evals):
            calls.append([e.id for e in evals])
            if len(calls) == 1:
                if failure == "no_leader":
                    raise NotLeaderError("")
                real(j, evals)
                raise RPCTimeoutError("response lost")
            return real(j, evals)

        srv.express_reconcile = express_reconcile
        srv.express_lane.commit_gate.set()
        assert wait(lambda: len(live_allocs(srv, job)) == 1, 30.0)
        assert wait(lambda: srv.express_lane.reconciled == 1, 10.0)
        assert len(calls) == 2
        # One eval id per entry: the retry names the same reconcile eval.
        assert calls[0] == calls[1]
        assert len(reconcile_evals(srv, job)) == 1
        time.sleep(0.5)
        assert len(live_allocs(srv, job)) == 1
    finally:
        srv.shutdown()


def test_reconcile_hand_over_gives_up_only_when_the_lane_stops():
    srv = dev_server(workers=1)
    try:
        register_nodes(srv, 4)
        job = held_entry(srv, "exp-handover-stop")
        calls = []

        def express_reconcile(j, evals):
            calls.append(1)
            raise NotLeaderError("")

        srv.express_reconcile = express_reconcile
        srv.express_lane.commit_gate.set()
        assert wait(lambda: len(calls) >= 5, 20.0)
        assert srv.express_lane.reconciled == 0
    finally:
        srv.shutdown()
    assert not live_allocs(srv, job)
