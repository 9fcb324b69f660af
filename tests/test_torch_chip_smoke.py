"""chip_smoke.py's pure helpers, on the CPU: its count of the bytes and
operations that bound the water-fill, on its own instances; the server
phase's check of committed allocs (one task a node for a system job);
the system phase at a small size; the agent phase's job and config files;
the simcluster phase's reading of the committed reference digests and
its check of a run's artifact against them (the slow test recomputes
those digests with nomad_tpu); the client phase at a small size; and the
planes phase's checks of the front door and the fast lanes, and the
phase itself on the CPU at a small size."""

import json

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
                 + ("steady-1k", "overdrive-1k", "read-storm-800")):
        assert refs[name]["reproduced"] is True
        assert refs[name]["seed"] == cs.SEED
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
])
def test_check_scenario(art, ref, result):
    if isinstance(result, bool):
        assert cs.check_scenario(art, ref) is result
    else:
        with pytest.raises(AssertionError, match=result):
            cs.check_scenario(art, ref)


@pytest.mark.slow
@pytest.mark.parametrize("name, seed", [
    *((n, cs.SEED) for n in cs.SIM_SCENARIOS + cs.PLANE_SCENARIOS),
    ("overdrive-1k", cs.SEED), ("read-storm-800", cs.SEED),
    ("read-storm-800", 11),
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
    assert art["events"]["digest"] == ref["digest"]
    assert art["events"]["by_type"] == ref["by_type"]
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
