"""chip_smoke.py's pure helpers, on the CPU: its count of the bytes and
operations that bound the water-fill, on its own instances; the server
phase's check of committed allocs (one task a node for a system job);
the system phase at a small size; the agent phase's job and config files;
the simcluster phase's reading of the committed reference digests and
its check of a run's artifact against them (the slow test recomputes
those digests with nomad_tpu); the client phase at a small size; and the
planes phase's checks of the front door and the fast lanes, and the
phase itself on the CPU at a small size; the simcluster phase's
profiler-off arm and its check of the profiled arm's profile section;
and the operator phase's Prometheus reader, lock and role deltas, config
file, and the phase itself on the CPU at a small size; and the secure
phase's certificates and refusals, its oracle and its native check, and
the phase itself on the CPU at a small size."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs

# Per eval: ask (16 B), bandwidth ask, count, penalty (4 B each) read,
# remaining written; per row: eligible read (1 B), count written (4 B).
EVAL_BYTES = 16 + 4 + 4 + 4 + 4
ROW_BYTES = 1 + 4


def case(mode, n=8192, b=2):
    rng = np.random.default_rng(3)
    return cs.waterfill_case(rng, n, b, False, False, mode,
                             torch.device("cpu"))


@pytest.mark.parametrize("mode, b, live, cands", [
    # 5,000 empty nodes, 100,000 tasks: level 20, nothing left to select.
    ("headline", 1, 5000, 0),
    # 12,500 tasks on 5,000 nodes: level 2, every node a candidate.
    ("ties", 8, 5000, 5000),
])
def test_waterfill_work_headline_nodes(mode, b, live, cands):
    n_bytes, ops = cs.waterfill_work(*case(mode, b=b))
    per_eval = (8192 * ROW_BYTES + live * 40 + cands * (8 + 4)
                + EVAL_BYTES)
    assert n_bytes == b * per_eval
    assert ops == cs.SCORE_OPS * cands * b


@pytest.mark.parametrize("mode", ["saturated", "count0", "ineligible"])
def test_waterfill_work_no_candidates(mode):
    """No row is scored: every cap is taken whole, nothing is asked, or
    no row is eligible; only the eligible rows' inputs are read."""
    args = case(mode)
    live = int(args[7].sum())
    if mode == "ineligible":
        assert live == 0
    n_bytes, ops = cs.waterfill_work(*args)
    assert ops == 0
    assert n_bytes == 2 * (8192 * ROW_BYTES + EVAL_BYTES) + live * 40


def test_waterfill_work_counts_less_than_every_input():
    """On random rows the bound counts what the data needs: under every
    input tensor read whole, and at least the eligible rows' inputs."""
    args = case("random")
    every = sum(t.numel() * t.element_size() for t in args[:12])
    n_bytes, ops = cs.waterfill_work(*args)
    live = int(args[7].sum())
    assert live * 40 < n_bytes < every + 2 * 8192 * 4
    assert 0 < ops <= cs.SCORE_OPS * live


# -- the server phase's check of committed allocs ------------------------------


def committed_state(runs, other=None):
    """A state store with two dc1 nodes and one dc2 node (1000 MHz, 2000
    MB each), the job's placements committed as one columnar block of
    ``runs`` (node id -> count; 100 MHz / 128 MB a task), and ``other``
    (node id -> count) placements of another job as object rows."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.state import StateStore
    from nomad_tpu_torch.structs import AllocBatch, Allocation, Node, Resources

    store = StateStore()
    for i, (nid, dc) in enumerate([("a", "dc1"), ("b", "dc1"),
                                   ("c", "dc2")]):
        store.upsert_node(i + 1, Node(
            id=nid, datacenter=dc, name=nid,
            attributes={"kernel.name": "linux", "driver.exec": "1"},
            resources=Resources(cpu=1000, memory_mb=2000, disk_mb=10_000,
                                iops=100),
            status=structs.NODE_STATUS_READY))
    job = cs.make_job("committed", structs.JOB_TYPE_BATCH,
                      sum(runs.values()), ["dc1"])
    res = job.task_groups[0].tasks[0].resources
    store.upsert_job(10, job)
    store.upsert_alloc_blocks(11, [AllocBatch(
        eval_id="ev-1", job=job, tg_name="work", resources=res,
        task_resources={"work": res}, node_ids=list(runs),
        node_counts=list(runs.values()),
        name_idx=np.arange(sum(runs.values())), ids_seed=12345)])
    if other:
        store.upsert_allocs(12, [Allocation(
            id=f"other-{nid}-{k}", eval_id="ev-2", name=f"other[{k}]",
            node_id=nid, job_id="other", task_group="work",
            resources=Resources(cpu=100, memory_mb=128),
            desired_status=structs.ALLOC_DESIRED_STATUS_RUN)
            for nid, n in other.items() for k in range(n)])
    return store.snapshot(), job


@pytest.mark.parametrize("runs, other, want, error", [
    ({"a": 5, "b": 5}, None, 10, None),
    ({"a": 7, "b": 7}, {"b": 3}, 14, None),
    # short count: the job holds fewer live tasks than it asked for
    ({"a": 5, "b": 4}, None, 10, "live tasks"),
    # a dc2 placement for a dc1 job
    ({"a": 5, "c": 5}, None, 10, "outside its datacenters"),
    # over capacity: 11 x 100 MHz on a 1000 MHz node
    ({"a": 11}, None, 11, "exceed its capacity"),
    # over capacity only with another job's object rows counted
    ({"a": 8}, {"a": 3}, 8, "exceed its capacity"),
])
def test_check_committed(runs, other, want, error):
    snap, job = committed_state(runs, other)
    if error is None:
        assert cs.check_committed(snap, job, want) == want
    else:
        with pytest.raises(AssertionError, match=error):
            cs.check_committed(snap, job, want)


@pytest.mark.parametrize("runs, want, error", [
    # one task on each dc1 node: the system job's plan
    ({"a": 1, "b": 1}, 2, None),
    # one alloc too many: a second task on a node
    ({"a": 2, "b": 1}, 2, "live tasks"),
    ({"a": 2, "b": 1}, 3, "other than 1"),
    # a dc1 node left without its task
    ({"a": 1}, 2, "live tasks"),
])
def test_check_committed_system(runs, want, error):
    snap, job = committed_state(runs)
    if error is None:
        assert cs.check_committed(snap, job, want, per_node=1) == want
    else:
        with pytest.raises(AssertionError, match=error):
            cs.check_committed(snap, job, want, per_node=1)


def test_system_phase_commits_one_task_a_dc1_node():
    """phase_system's pieces on a small cluster: a fresh store, tpu-system
    on the CPU, the verifying planner; check_committed holds the result to
    one task on each dc1 node."""
    import logging

    from nomad_tpu_torch import structs
    from nomad_tpu_torch.scheduler import new_scheduler

    old = cs.N_NODES
    cs.N_NODES = 101
    try:
        job = cs.system_job()
        state = cs.system_store(job)
        planner = cs.VerifyingPlanner(state, 3)
        ev = structs.Evaluation(
            id="ev-sys", priority=50, type=job.type, job_id=job.id,
            triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER)
        new_scheduler("tpu-system", state.snapshot(), planner,
                      logging.getLogger("test"), device="cpu").process(ev)
        assert planner.status == structs.EVAL_STATUS_COMPLETE
        assert cs.system_placed() == 51
        assert cs.check_committed(state.snapshot(), job, 51,
                                  per_node=1) == 51
    finally:
        cs.N_NODES = old


def test_agent_job_files_parse_to_make_job_jobs():
    """The agent phase's HCL files are make_job's jobs: the port's jobspec
    gives the same job, id aside (a file's id is its name)."""
    from nomad_tpu_torch import jobspec
    from nomad_tpu_torch.api.codec import to_dict

    jobs = cs.agent_jobs()
    assert [j.type for j, _ in jobs] == ["batch", "service", "system"]
    for job, text in jobs:
        parsed = to_dict(jobspec.parse(text))
        want = to_dict(job)
        for doc in (parsed, want):
            for tg in doc["task_groups"]:
                for task in tg["tasks"]:
                    # jobspec fills the task fields make_job leaves empty
                    task["config"] = task["config"] or {}
                    task["meta"] = task["meta"] or {}
        assert parsed == want


def test_agent_config_file_parses_to_a_server_agent():
    from nomad_tpu_torch import agent_config
    from nomad_tpu_torch.agent import AgentConfig

    fc = agent_config.parse_config(cs.agent_config_hcl("/data", "cuda"))
    cfg = AgentConfig.from_file_config(fc)
    assert (cfg.server_enabled, cfg.client_enabled, cfg.device,
            cfg.http_port, cfg.rpc_port, cfg.bootstrap_expect,
            cfg.data_dir) == (True, False, "cuda", 0, 0, 1, "/data")


# -- the simcluster phase's checks --------------------------------------------


def test_reference_digests_file_is_valid():
    """The committed file names its nomad_tpu commit and carries every key
    the phase reads for each scenario the phase runs; nomad_tpu
    reproduced each digest across its two runs."""
    refs = cs.load_reference_digests()
    for name in (cs.SIM_SCENARIOS + cs.PLANE_SCENARIOS
                 + cs.RECOVERY_SCENARIOS
                 + ("steady-1k", "overdrive-1k", "read-storm-800",
                    "churn-frag-200", "restart-800")):
        assert refs[name]["seed"] == cs.SEED
        if name == "follower-crash-rejoin":
            # nomad_tpu gave two digests over four runs (one more
            # EvalUpdated in two): both are listed, each run twice.
            assert refs[name]["reproduced"] is False
            assert len(refs[name]["digests_seen"]) == 2
            assert refs[name]["digest"] in refs[name]["digests_seen"]
            continue
        assert refs[name]["reproduced"] is True
    for name in ("churn-frag-200", "restart-800"):
        assert refs[name]["other_seeds"]["11"]["reproduced"] is True
    assert refs["restart-under-load"]["placed"] == 24 * 420
    assert refs["rack-failure"]["placed"] == 256 + 8
    assert refs["follower-crash-rejoin"]["placed"] == 10 * 120
    assert refs["steady-10k"]["placed"] == 24 * 420
    assert refs["burst-100k"]["placed"] == 8 * 12_500
    for name in cs.PLANE_SCENARIOS:
        assert "admission_injector" in refs[name], name
    assert refs["overdrive-100k"]["admission_injector"] == {
        "offered": 250, "admitted": 5, "rejected": {"RATE_LIMITED": 245}}
    assert refs["read-storm-800"]["other_seeds"]["11"]["reproduced"] is True


@pytest.mark.parametrize("data, error", [
    ({"scenarios": {"a": {}}}, "no nomad_tpu commit"),
    ({"nomad_tpu_commit": "abc", "scenarios": {}}, "no scenario"),
    ({"nomad_tpu_commit": "abc", "scenarios": {"a": {"digest": "d"}}},
     "a lacks"),
])
def test_reference_digests_file_is_checked(tmp_path, data, error):
    path = tmp_path / "refs.json"
    path.write_text(json.dumps(data))
    with pytest.raises(AssertionError, match=error):
        cs.load_reference_digests(str(path))


def reference(**kw):
    ref = {"seed": 42, "digest": "d1", "by_type": {"PlanApplied": 2},
           "placed": 20, "evals_injected": 2, "plans_applied": 2,
           "heartbeat_timers": 10, "reproduced": True}
    ref.update(kw)
    return ref


def artifact(placed=20, evals=2, plans=2, timers=10, truncated=False,
             digest="d1", by_type=None):
    return {"scenario": "synthetic",
            "placements": {"placed": placed, "evals_injected": evals,
                           "plans_applied": plans},
            "heartbeat": {"timers": timers},
            "events": {"truncated": truncated, "digest": digest,
                       "by_type": by_type or {"PlanApplied": 2}}}


@pytest.mark.parametrize("art, ref, result", [
    (artifact(), reference(), True),
    # nomad_tpu did not reproduce its own digest: no digest check
    (artifact(digest="d2"), reference(reproduced=False), False),
    (artifact(placed=19), reference(), "placed=19"),
    (artifact(evals=3), reference(), "evals_injected=3"),
    (artifact(plans=1), reference(), "plans_applied=1"),
    (artifact(timers=9), reference(), "heartbeat timers"),
    (artifact(truncated=True), reference(), "truncated"),
    (artifact(digest="d2"), reference(), "canonical digest"),
    (artifact(by_type={"PlanApplied": 1}), reference(), "canonical digest"),
    # nomad_tpu gave two digests: the port's must be one of them
    (artifact(digest="d2"), reference(reproduced=False, digests_seen={
        "d1": {"by_type": {"PlanApplied": 2}, "runs": 1},
        "d2": {"by_type": {"PlanApplied": 2}, "runs": 1}}), True),
    (artifact(digest="d3"), reference(reproduced=False, digests_seen={
        "d1": {"by_type": {"PlanApplied": 2}, "runs": 1}}),
     "canonical digest"),
])
def test_check_scenario(art, ref, result):
    if isinstance(result, bool):
        assert cs.check_scenario(art, ref) is result
    else:
        with pytest.raises(AssertionError, match=result):
            cs.check_scenario(art, ref)


@pytest.mark.slow
@pytest.mark.parametrize("name, seed", [
    *((n, cs.SEED) for n in cs.SIM_SCENARIOS + cs.PLANE_SCENARIOS
      + cs.RECOVERY_SCENARIOS),
    ("overdrive-1k", cs.SEED), ("read-storm-800", cs.SEED),
    ("read-storm-800", 11), ("churn-frag-200", cs.SEED),
    ("churn-frag-200", 11), ("restart-800", cs.SEED), ("restart-800", 11),
])
def test_reference_digests_match_nomad_tpu(name, seed):
    """Recompute the committed reference digest with nomad_tpu, as the
    file's command says, so that the file cannot drift unseen."""
    from nomad_tpu.simcluster import run_scenario

    art = run_scenario(name, seed=seed, attribution_layer=False,
                       contrast=False)
    ref = cs.load_reference_digests()[name]
    if seed != ref["seed"]:
        ref = ref["other_seeds"][str(seed)]
    seen = ref.get("digests_seen") or {ref["digest"]: ref}
    assert art["events"]["digest"] in seen
    assert art["events"]["by_type"] == seen[art["events"]["digest"]][
        "by_type"]
    assert art["placements"]["placed"] == ref["placed"]
    if "admission_injector" in ref:
        assert art["admission"]["injector"] == ref["admission_injector"]


def test_agent_phase_grants_long_ttls_and_probe_times_beats(tmp_path):
    """The agent phase's agent grants every node a TTL of at least
    AGENT_MIN_HEARTBEAT_TTL_S, so no node goes down while the headline's
    stop holds the store, and HeartbeatProbe times beats against it."""
    from nomad_tpu_torch.simcluster.simnode import SimFleet

    agent = cs.phase_agent_agent(torch.device("cpu"), str(tmp_path))
    fleet = None
    try:
        agent.start()
        srv = agent.server
        deadline = cs.time.perf_counter() + 30.0
        while not srv.raft.is_leader:
            assert cs.time.perf_counter() < deadline
            cs.time.sleep(0.01)
        nodes = cs.cluster_nodes()[:4]
        fleet = SimFleet(srv.rpc_addr)
        fleet.register(nodes)
        assert min(fleet.granted.values()) >= cs.AGENT_MIN_HEARTBEAT_TTL_S
        probe = cs.HeartbeatProbe(srv.rpc_addr, nodes[0].id)
        probe.start()
        cs.time.sleep(5 * cs.PROBE_EVERY_S)
        beats = probe.stop()
        assert beats["beats"] >= 1
        assert 0.0 < beats["p50_ms"] <= beats["max_ms"]
        assert srv.heartbeat.stats()["expirations"] == 0
    finally:
        if fleet is not None:
            fleet.stop()
        agent.shutdown()


# -- the client phase's pieces -------------------------------------------------


@pytest.fixture
def small_client_phase(monkeypatch):
    """phase_client at a small size on the CPU: 16 SimFleet nodes, two
    clients given the GPU attributes by hand, a 130-task batch job (more
    than 128: the water-fill) and every launch of a plain version counted
    as the card's kernels count theirs. The cloud metadata fingerprints
    get no network (the agent -dev subprocess gets chip_smoke's
    NO_NETWORK_ENV; this process's urllib is left as it is)."""
    from nomad_tpu_torch.client import fingerprint
    from nomad_tpu_torch.ops import greedy, waterfill

    for name, value in (("N_NODES", 16), ("CLIENT_NODES", 2),
                        ("CLIENT_BATCH_COUNT", 130),
                        ("CLIENT_BATCH_ROUNDS", 1),
                        ("CLIENT_SERVICE_COUNT", 2), ("CLIENT_TASK_CPU", 10),
                        ("CLIENT_WAIT_S", 60.0)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(fingerprint._MetadataFingerprint, "_get",
                        lambda self, path: None)
    for mod, name in ((waterfill, "solve_waterfill_batched_plain"),
                      (greedy, "solve_greedy_batched_shared_plain")):
        inner = getattr(mod, name)

        def counted(*args, _mod=mod, _inner=inner, **kw):
            _mod.LAUNCHES += 1
            return _inner(*args, **kw)
        monkeypatch.setattr(mod, name, counted)


def test_client_jobs_run_only_on_gpu_nodes(small_client_phase, tmp_path):
    """Each client job lands only on the GPU-attributed client nodes,
    never on a SimFleet node, and reaches its final client status: the
    batch job dead with exit 0, the service job running then gone with
    its pids, the failing job failed after 1 + attempts starts."""
    wf, gr = cs.phase_client_jobs(torch.device("cpu"), "cpu", str(tmp_path))
    assert wf >= 1 + cs.CLIENT_BATCH_ROUNDS
    assert gr >= 2


def test_client_jobs_need_the_gpu_attribute():
    job = cs.client_job("j", "batch", 3, "mock_driver", {"run_for": 0.1})
    (c,) = job.constraints
    assert (c.l_target, c.r_target, c.operand) == ("$attr.driver.gpu", "1",
                                                   "=")
    assert cs.gpu_attrs(torch.device("cpu"))["driver.gpu"] == "1"


def test_client_dev_agent_runs_a_job(small_client_phase, tmp_path):
    """agent -dev as a subprocess on the CPU: run, status, alloc-status
    and client-config -servers, the task's stdout, SIGINT -> 0."""
    cs.client_dev_agent(torch.device("cpu"), "cpu", str(tmp_path))


# -- the planes phase's checks -------------------------------------------------


def plane_artifact(caps_respected=True, injector=None, lane=None,
                   lanes=None):
    art = {"scenario": "synthetic", "peaks": {}, "admission": {
        "caps": {}, "caps_respected": caps_respected,
        "injector": injector or {"offered": 3, "admitted": 2,
                                 "rejected": {"RATE_LIMITED": 1}}}}
    if lane is not None:
        art["express"] = {"lane": {"placed": 4, "committed": 3,
                                   "reconciled": 1, "backlog": 0,
                                   "ledger": {"active": 0}, **lane}}
    if lanes is not None:
        art["reads"] = {"lanes": {
            "enabled": True, "members": 3, "follower_serve_share": 1.0,
            "stale_bound_ms": 5000.0, "stale_age_ms": {"n": 4, "p95": 80},
            "linear_violations": 0, "stamp_missing": 0, **lanes}}
    return art


PLANE_REF = {"admission_injector": {"offered": 3, "admitted": 2,
                                    "rejected": {"RATE_LIMITED": 1}}}


@pytest.mark.parametrize("art, error", [
    (plane_artifact(), None),
    (plane_artifact(lane={}, lanes={}), None),
    (plane_artifact(caps_respected=False), "queue cap"),
    (plane_artifact(injector={"offered": 3, "admitted": 3,
                              "rejected": {}}), "the door gave"),
    (plane_artifact(lane={"committed": 2}), "express placements"),
    (plane_artifact(lane={"backlog": 1}), "leases or commits left"),
    (plane_artifact(lane={"ledger": {"active": 2}}), "leases or commits"),
    (plane_artifact(lanes={"linear_violations": 1}), "linearizable reads"),
    (plane_artifact(lanes={"stamp_missing": 2}), "freshness stamp"),
    (plane_artifact(lanes={"follower_serve_share": 0.5}),
     "follower_serve_share"),
    (plane_artifact(lanes={"stale_age_ms": {"n": 4, "p95": 6000}}),
     "stale_age_p95_bound_ratio"),
])
def test_check_planes(art, error):
    if error is None:
        cs.check_planes(art, PLANE_REF)
        return
    with pytest.raises(AssertionError, match=error):
        cs.check_planes(art, PLANE_REF)


def test_check_planes_without_reference_books():
    """A reference entry without admission books (a steady scenario) is
    held to the caps only."""
    cs.check_planes(plane_artifact(injector={"offered": 9}), {})


@pytest.fixture
def counted_plain(monkeypatch):
    """Every launch of a plain version counted as the card's kernels count
    theirs."""
    from nomad_tpu_torch.ops import greedy, waterfill

    for mod, name in ((waterfill, "solve_waterfill_batched_plain"),
                      (greedy, "solve_greedy_batched_shared_plain")):
        inner = getattr(mod, name)

        def counted(*args, _mod=mod, _inner=inner, **kw):
            _mod.LAUNCHES += 1
            return _inner(*args, **kw)
        monkeypatch.setattr(mod, name, counted)


def test_planes_phase_at_a_small_size(counted_plain, capsys):
    """phase_planes on the CPU with the slice's tier-1 scenarios (and
    steady-1k for the water-fill): each held to nomad_tpu's digest and
    check_planes, with its rows logged."""
    wf, gr = cs.phase_planes(torch.device("cpu"), "cpu",
                             names=("express-1k", "overdrive-1k",
                                    "steady-1k"))
    assert wf >= 1 and gr >= 1
    out = capsys.readouterr().out
    for name in ("express-1k", "overdrive-1k", "steady-1k"):
        assert f"planes {name}: digest=" in out
        assert "equals nomad_tpu's" in out
    assert "planes express-1k: express placed=41" in out
    assert 'rejected_by_reason={"RATE_LIMITED": 36}' in out


# -- the recovery phase's checks ----------------------------------------------


def recovery_artifact(name, checks=None, ok=True, chunks=3, survived=True,
                      recovery=None, digest="d1"):
    art = {"scenario": name, "events": {"digest": digest,
                                        "by_type": {"PlanApplied": 2}}}
    if name in cs.CHAOS_CHECKS:
        names = checks if checks is not None else [
            c.replace("[", "[raft.append]") for c in cs.CHAOS_CHECKS[name]]
        art["chaos"] = {"ok": ok, "checks": [
            {"check": c, "ok": ok,
             **({"chunks_received": chunks}
                if c == "require_install_snapshot" else {})}
            for c in names]}
    if name == "restart-under-load":
        timeline = {k: 1.0 for k in cs.RECOVERY_TIMELINE}
        timeline["cold_start"] = True
        timeline.update(recovery or {})
        art["raft"] = {"restart": {"placements_survived": survived},
                       "recovery": timeline}
    return art


def contrast_artifact(digest="d1", capacity=None):
    return {"capacity": capacity or {"enabled": False},
            "events": {"digest": digest, "by_type": {"PlanApplied": 2}}}


@pytest.mark.parametrize("art, contrast, error", [
    (recovery_artifact("rack-failure"), None, None),
    (recovery_artifact("partition-flap"), None, None),
    (recovery_artifact("follower-crash-rejoin"), None, None),
    (recovery_artifact("restart-under-load"), None, None),
    (recovery_artifact("churn-fragmentation"), contrast_artifact(), None),
    (recovery_artifact("rack-failure", ok=False), None, "chaos verdict"),
    (recovery_artifact("rack-failure", checks=["exactly_once_replacement"]),
     None, "all_killed_expired missing"),
    (recovery_artifact("partition-flap",
                       checks=["no_duplicate_plans", "leader_stable"]),
     None, "storm_transitions"),
    (recovery_artifact("follower-crash-rejoin", chunks=1), None,
     "1 snapshot chunk"),
    (recovery_artifact("restart-under-load", survived=False), None,
     "pre-kill placements lost"),
    (recovery_artifact("restart-under-load",
                       recovery={"time_to_serving_ms": None}), None,
     "recovery timeline"),
    (recovery_artifact("restart-under-load",
                       recovery={"cold_start": False}), None,
     "recovery timeline"),
    (recovery_artifact("churn-fragmentation"), contrast_artifact("d2"),
     "capacity-off arm gave d2"),
    (recovery_artifact("churn-fragmentation"),
     contrast_artifact(capacity={"enabled": True}), "ran the capacity"),
])
def test_check_recovery(art, contrast, error):
    if error is None:
        cs.check_recovery(art, contrast)
        return
    with pytest.raises(AssertionError, match=error):
        cs.check_recovery(art, contrast)


def test_stranded_at_reads_the_last_sample_before():
    traj = [{"t_s": t, "stranded": {"small": t / 10},
             "placeable": {"small": int(t)}} for t in (0.5, 1.0, 7.5, 9.0)]
    assert cs.stranded_at(traj, 8.0) == {"small": [0.75, 7]}
    assert cs.stranded_at(traj, 0.1) is None


def test_recovery_phase_at_a_small_size(counted_plain, capsys):
    """phase_recovery on the CPU with the slice's tier-1 smokes: each held
    to nomad_tpu's digest, churn-frag-200's capacity-off arm to the main
    arm's, restart-800's placements and recovery timeline, with the rows
    logged."""
    wf, gr = cs.phase_recovery(torch.device("cpu"), "cpu",
                               names=("churn-frag-200", "restart-800"))
    assert wf >= 1 and gr >= 1
    out = capsys.readouterr().out
    for name in ("churn-frag-200", "restart-800"):
        assert f"recovery {name}: waterfill_launches=" in out
        assert "equals nomad_tpu's" in out
    assert "the capacity-off arm's too" in out
    assert "recovery churn-frag-200: stranded_pct/placeable before" in out
    assert "recovery restart-800: recovery {" in out
    assert "recovery restart-800: write_path alloc_update" in out


# -- the operator phase and steady-10k's profiled arm ---------------------------


GOOD_SCRAPE = """# TYPE nomad_a_total counter
nomad_a_total 3
# TYPE nomad_b gauge
nomad_b{dim="cpu",lane="x\\"y"} 0.5
nomad_b{dim="mem"} +Inf
# TYPE s_ms summary
s_ms{quantile="0.5"} 1.5
s_ms_sum 3
s_ms_count 2
# TYPE s_ms_hist histogram
s_ms_hist_bucket{le="1"} 1
s_ms_hist_bucket{le="+Inf"} 2
s_ms_hist_sum 3
s_ms_hist_count 2
"""


def test_parse_prometheus_reads_every_line():
    assert cs.parse_prometheus(GOOD_SCRAPE) == {
        "nomad_a_total": "counter", "nomad_b": "gauge", "s_ms": "summary",
        "s_ms_hist": "histogram"}


@pytest.mark.parametrize("text, error", [
    ("nomad_a_total 3\n", "before its family"),
    ("# TYPE x gauge\n# TYPE x gauge\n", "declared twice"),
    ("# TYPE x gauge\nx abc\n", "could not convert"),
    ("# TYPE x meter\n", "scrape line 1"),
    ("# TYPE x gauge\nx{bad-label=\"1\"} 1\n", "scrape line 2"),
    ("# TYPE x gauge\nx  1\n", "scrape line 2"),
])
def test_parse_prometheus_refuses_bad_lines(text, error):
    with pytest.raises((AssertionError, ValueError), match=error):
        cs.parse_prometheus(text)


def profiled_artifact(enabled=True, roles=True, contention=True,
                      violations=0, projected=1000):
    return {"profile": {
        "enabled": enabled,
        "profiler": {"roles": {"worker": {"samples": 3, "wall_share": 1.0}}
                     if roles else {}},
        "locks": {"installed": True, "violations": violations,
                  "contention": [{"lock": "a"}] if contention else []},
        "bytes": {"mirror": {"projected_1m_bytes": projected}},
    }}


@pytest.mark.parametrize("art, error", [
    (profiled_artifact(), None),
    (profiled_artifact(enabled=False), "not enabled"),
    (profiled_artifact(roles=False), "no role wall shares"),
    (profiled_artifact(contention=False), "no lock-contention table"),
    (profiled_artifact(violations=2), "2 lock-order violations"),
    (profiled_artifact(projected=None), "no 1M-row projection"),
])
def test_check_profile(art, error):
    if error is None:
        cs.check_profile("s", art)
        return
    with pytest.raises(AssertionError, match=error):
        cs.check_profile("s", art)


def test_lock_delta_and_role_shares():
    before = {"L": {"acquisitions": 3, "contended": 1,
                    "wait_total_ms": 2.5}}
    after = {"L": {"acquisitions": 10, "contended": 4,
                   "wait_total_ms": 12.5}}
    assert cs.lock_delta(before, after, "L") == {
        "acquisitions": 7, "contended": 3, "wait_total_ms": 10.0}
    assert cs.lock_delta({}, after, "M") == {
        "acquisitions": 0, "contended": 0, "wait_total_ms": 0}
    p0 = {"roles": {"worker": {"samples": 2}}}
    p1 = {"roles": {"worker": {"samples": 5}, "raft": {"samples": 1}}}
    assert cs.role_shares(p0, p1) == {"raft": 0.25, "worker": 0.75}


def test_operator_config_file_parses_to_the_phase_agent(tmp_path):
    from nomad_tpu_torch import agent_config
    from nomad_tpu_torch.agent import AgentConfig

    path = tmp_path / "op.hcl"
    path.write_text(cs.operator_config_hcl(str(tmp_path), "cpu",
                                           "127.0.0.1:9"))
    cfg = AgentConfig.from_file_config(agent_config.default_config().merge(
        agent_config.load_config_file(str(path))))
    assert (cfg.server_enabled, cfg.enable_debug, cfg.lock_watchdog,
            cfg.statsd_addr, cfg.profile, cfg.device, cfg.http_port,
            cfg.rpc_port) == (True, True, True, "127.0.0.1:9",
                              {"enabled": True}, "cpu", 0, 0)
    assert cfg.histogram_buckets == list(cs.OPERATOR_BUCKETS)


def test_operator_phase_at_a_small_size(counted_plain, monkeypatch, tmp_path,
                                        capsys):
    """phase_operator on the CPU: 300 nodes, a 1,000-task headline and a
    count-20 service job through a port agent built from its config file,
    every operator route checked, the watchdog clean and uninstalled,
    the global metrics registry restored."""
    from nomad_tpu_torch import telemetry

    for name, value in (("N_NODES", 300), ("N_TASKS", 1000),
                        ("SERVICE_COUNT", 20)):
        monkeypatch.setattr(cs, name, value)
    was = telemetry.get_global()
    wf, gr = cs.phase_operator(torch.device("cpu"), "cpu", str(tmp_path))
    assert wf >= 1 + cs.OPERATOR_ROUNDS and gr >= 1 + cs.OPERATOR_ROUNDS
    assert telemetry.get_global() is was
    assert telemetry.active_lock_watchdog() is None
    out = capsys.readouterr().out
    assert "operator: scrape " in out and "statsd lines received" in out
    assert "violations 0; the ten with the most wait:" in out
    assert out.count("operator lock ") >= 3
    assert "operator operator-headline: register_complete_p50_ms=" in out
    assert "role shares over its rounds" in out


def test_simcluster_phase_runs_the_profiler_off_arm(counted_plain,
                                                   monkeypatch, capsys):
    """phase_simcluster on the CPU with steady-1k given steady-10k's
    profiler-off contrast arm: both arms held to nomad_tpu's digest, the
    profiled arm to check_profile, the overhead and the ledger logged."""
    import dataclasses

    from nomad_tpu_torch.simcluster import scenario as psc

    spec = dataclasses.replace(
        psc.SCENARIOS["steady-1k"],
        contrast_overrides=psc.SCENARIOS["steady-10k"].contrast_overrides)
    monkeypatch.setitem(psc.SCENARIOS, "steady-1k", spec)
    assert cs.phase_simcluster(torch.device("cpu"), "cpu",
                               names=("steady-1k",)) >= 2
    out = capsys.readouterr().out
    assert "simcluster steady-1k: profiler-off arm digest equal" in out
    assert '"overhead_fraction"' in out
    assert "simcluster steady-1k: byte ledger per_row_bytes=" in out
    assert "projected_1m_rows=1048576" in out


# -- the secure phase -----------------------------------------------------------


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return cs.make_certs(str(tmp_path_factory.mktemp("secure")))


def test_certs_give_mutual_tls_and_the_refusals(certs):
    """The server pair serves with its loopback SAN, the client pair gets
    through, the plaintext and the rogue pair are refused; against a
    plaintext listener the check fails."""
    from nomad_tpu_torch.rpc import RPCServer

    for name in ("server", "client", "rogue"):
        crt, key = certs[name]
        assert os.path.exists(crt) and os.path.exists(key)
    tls = RPCServer(ssl_context=cs.secure_tls(certs).incoming_context())
    plain = RPCServer()
    for srv in (tls, plain):
        srv.register("Status.Ping", lambda args: "pong")
        srv.start()
    try:
        cs.check_refusals(certs, tls.addr)
        with pytest.raises(AssertionError, match="plaintext dial reached"):
            cs.check_refusals(certs, plain.addr)
    finally:
        tls.shutdown()
        plain.shutdown()


def test_secure_oracle_at_a_small_size(capsys):
    """The oracle on the CPU: the headline shape and 12 fuzz seeds, none
    in the pow band."""
    assert cs.phase_secure_oracle(torch.device("cpu"), seeds=12) == 0
    assert "12 equal, 0 in the 256-ulp pow band" in capsys.readouterr().out


def test_secure_oracle_refuses_a_disagreement(monkeypatch):
    from nomad_tpu_torch.ops import binpack

    inner = binpack.solve_rounds_fused

    def off_by_one(*args):
        counts, left = inner(*args)
        counts = counts.clone()
        counts[int(counts.argmax())] -= 1
        return counts, left + 1
    monkeypatch.setattr(binpack, "solve_rounds_fused", off_by_one)
    s = cs.fuzz_solve_inputs(np.random.default_rng(cs.ORACLE_SEED_BASE))
    with pytest.raises(AssertionError, match="outside the pow band"):
        cs.oracle_agrees(s, cs.fuzz_tensors(s, torch.device("cpu")))


def test_check_sound_refuses_an_overfull_node():
    s = cs.fuzz_solve_inputs(np.random.default_rng(cs.ORACLE_SEED_BASE + 1))
    counts = np.zeros(len(s["total"]), dtype=np.int32)
    cs.check_sound(s, counts)
    counts[int(np.argmax(s["eligible"]))] = 1 << 20
    with pytest.raises(AssertionError, match="holds"):
        cs.check_sound(s, counts)


def test_secure_phase_at_a_small_size(counted_plain, monkeypatch, capsys):
    """phase_secure on the CPU: 300 nodes, a 1,000-task headline and a
    count-20 service job through a follower of a mutual-TLS cell and
    through the uplink of a TLS agent, a TLS client's mock tasks dead,
    the native verifier and the oracle."""
    from nomad_tpu_torch import native, telemetry
    from nomad_tpu_torch.client import fingerprint

    for name, value in (("N_NODES", 300), ("N_TASKS", 1000),
                        ("SERVICE_COUNT", 20)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(fingerprint._MetadataFingerprint, "_get",
                        lambda self, path: None)
    was = telemetry.get_global()
    calls = native.CALLS["fit_check"]
    wf, gr = cs.in_tmp(cs.phase_secure, torch.device("cpu"), "cpu")
    assert wf >= 2 and gr >= 2
    assert native.CALLS["fit_check"] > calls
    assert telemetry.get_global() is was
    out = capsys.readouterr().out
    assert out.count("plaintext dial refused") == 2
    assert out.count("untrusted certificate dial refused") == 2
    assert "secure secure-batch: register_complete_ms=" in out
    assert "committed=1000 on each of 3 members" in out
    assert "4 mock tasks dead" in out
    assert "1000 alloc stubs read through it" in out
    assert "a parked blocking query woke" in out
    assert "fit_check on 301 x 4 int32 rows equal to the plain" in out
    assert "60 equal, 0 in the 256-ulp pow band" in out
