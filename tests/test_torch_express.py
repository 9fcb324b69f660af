"""The port's express lane (server/express.py) against nomad_tpu's.

- ``ExpressConfig.parse``, ``express_eligible`` and the
  ``ReservationLedger`` (a seeded stream of reserve / release / expire /
  clear) give nomad_tpu's results: the same debit maps and books.
- The in-line pick: two servers of each package with the same seed, the
  same nodes and the same express submissions (committer held) place
  every task on the same node, with the same lease TTL and the same
  ledger debits; the capacity view is nomad_tpu's.
- The lane's contract on the port's ``Server``: in-line placement and
  async commit, lane-off inertness, fallbacks, verify under the ledger
  (own lease exempt), a bounce that re-places the same allocation
  exactly once, reconciliation past the bounce budget, the duplicate
  guard, the shutdown drain, stacked leases, and the capacity-safety and
  exactly-once fuzz of nomad_tpu's ``tests/test_express.py`` on its seeds
  (11, 42, 1337).
- On a three-member ``ClusterServer`` cell: a deposed leader's
  uncommitted entry reconciles to the new leader over
  ``Express.Reconcile`` and places exactly once.
- ``express-1k`` through the port's runner gives nomad_tpu's committed
  canonical digest.

Tolerance: exact (host decisions on identical inputs).
"""

import json
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.api.codec import to_dict
from nomad_tpu.server import express as jexp
from nomad_tpu.server.server import Server as JaxServer
from nomad_tpu.server.server import ServerConfig as JaxServerConfig
from nomad_tpu.simcluster.workload import build_job as jax_build_job
from nomad_tpu_torch import faults, mock, structs
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.server import express as pexp
from nomad_tpu_torch.server.cluster import form_cluster, wait_for_leader
from nomad_tpu_torch.server.plan_apply import evaluate_plan
from nomad_tpu_torch.server.plan_pipeline import evaluate_plans
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.simcluster import scenario as psc
from nomad_tpu_torch.simcluster.workload import build_job
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import Allocation, Plan, Resources, generate_uuid
from test_torch_cluster import relaxed_cluster, retry_write

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def vec(cpu, mem=0, disk=0, iops=0):
    return np.array([cpu, mem, disk, iops], dtype=np.int64)


def express_job(jid, count=1, cpu=100, memory_mb=64):
    return build_job(jid, structs.JOB_TYPE_BATCH, count, cpu=cpu,
                     memory_mb=memory_mb, express=True)


def dev_server(express=True, workers=1, seed=0, **express_kw):
    srv = Server(ServerConfig(
        scheduler_workers=workers, scheduler_backend="host",
        prewarm_shapes=False, min_heartbeat_ttl=3600.0, seed=seed,
        express={"enabled": True, **express_kw} if express else None,
        device="cpu"))
    srv.start()
    return srv


def register_nodes(srv, n, cpu=4000, memory_mb=8192, prefix="node"):
    for i in range(n):
        node = mock.node()
        node.id = f"{prefix}-{i:03d}"
        node.resources.cpu = cpu
        node.resources.memory_mb = memory_mb
        srv.node_register(node)


def wait(cond, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


# -- config, eligibility, ledger ----------------------------------------------


@pytest.mark.parametrize("spec", [
    None, {"enabled": True}, {"enabled": True, "lease_ttl": 5, "probes": 8,
                              "choices": 4},
    {"max_tasks": 64, "max_pending": 9, "max_bounces": 0},
    {"enabledd": True}, {"lease_ttl": 0}, {"probes": 2, "choices": 3},
    {"max_leases": 0}, {"lease_jitter": 5}, "nope",
])
def test_express_config_parse_equals_reference(spec):
    try:
        ref = jexp.ExpressConfig.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pexp.ExpressConfig.parse(spec)
        assert str(got.value) == str(e)
        return
    assert vars(pexp.ExpressConfig.parse(spec)) == vars(ref)


def eligibility_jobs():
    """(name, reference job) shapes around every eligibility edge."""
    out = []
    for count in (1, 4, 5, 16, 17):
        out.append((f"count{count}", jax_build_job(
            f"c{count}", "batch", count, express=True)))
    out.append(("flag-off", jax_build_job("off", "batch", 2)))
    svc = jax_build_job("svc", "service", 2, express=True)
    svc.express = True
    out.append(("service", svc))
    net = jax_build_job("net", "batch", 1, express=True)
    net.task_groups[0].tasks[0].resources.networks = [
        jmock.node().resources.networks[0]]
    out.append(("network", net))
    for where in ("job", "group"):
        dh = jax_build_job("dh", "batch", 2, express=True)
        c = jmock.job().constraints[0]
        c.operand = "distinct_hosts"
        (dh.constraints if where == "job"
         else dh.task_groups[0].constraints).append(c)
        out.append((f"distinct-{where}", dh))
    return out


@pytest.mark.parametrize("cfg", [dict(enabled=True, max_tasks=4),
                                 dict(enabled=True),
                                 dict(enabled=False)])
@pytest.mark.parametrize("name, job", eligibility_jobs(),
                         ids=[n for n, _ in eligibility_jobs()])
def test_express_eligible_equals_reference(name, job, cfg):
    pjob = structs_from_reference(to_dict(job), "Job")
    assert (pexp.express_eligible(pjob, pexp.ExpressConfig(**cfg))
            == jexp.express_eligible(job, jexp.ExpressConfig(**cfg)))


def ledger_script(seed, n=120):
    rng = random.Random(seed)
    steps = []
    for k in range(n):
        r = rng.random()
        if r < 0.55:
            debits = {f"n{rng.randrange(5)}": [rng.randrange(1, 500),
                                               rng.randrange(1, 300), 0, 0]
                      for _ in range(rng.randrange(1, 3))}
            steps.append(("reserve", f"ev{k}", debits,
                          rng.choice([0.5, 2.0, 30.0]), f"lease-{k}"))
        elif r < 0.8:
            steps.append(("release", f"lease-{rng.randrange(k + 1)}"))
        elif r < 0.95:
            steps.append(("expire", rng.random() * 40.0))
        else:
            steps.append(("clear",))
    return steps


def run_ledger(mod, seed):
    ledger = mod.ReservationLedger(max_leases=12)
    out = []
    for step in ledger_script(seed):
        if step[0] == "reserve":
            _, ev, debits, ttl, lid = step
            lease = ledger.reserve(
                ev, {k: np.asarray(v, dtype=np.int64)
                     for k, v in debits.items()},
                ttl, now=0.0, lease_id=lid)
            out.append(None if lease is None else lease.id)
        elif step[0] == "release":
            out.append(ledger.release(step[1]))
        elif step[0] == "expire":
            out.append(sorted(l.id for l in ledger.expire_due(now=step[1])))
        else:
            out.append(ledger.clear())
        dmap = ledger.debit_map()
        out.append({k: v.tolist() for k, v in sorted(dmap.items())})
        out.append({k: v.tolist() for k, v in sorted(ledger.debit_map(
            exclude=("lease-3", "lease-7")).items())})
    out.append(ledger.stats())
    return out


@pytest.mark.parametrize("seed", [0, 1, 11, 42, 1337])
def test_ledger_equals_reference(seed):
    assert run_ledger(pexp, seed) == run_ledger(jexp, seed)


# -- the in-line pick against nomad_tpu's ---------------------------------------


def pick_servers(seed, **express_kw):
    kw = dict(scheduler_workers=0, scheduler_backend="host",
              prewarm_shapes=False, min_heartbeat_ttl=3600.0, seed=seed,
              express={"enabled": True, **express_kw})
    ref = JaxServer(JaxServerConfig(**kw))
    got = Server(ServerConfig(device="cpu", **kw))
    ref.start()
    got.start()
    return ref, got


def pick_nodes(seed, n):
    """Seeded node shapes (cpu, memory) so the pick's fits and scores
    spread; nodes of one datacenter and one of another."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n):
        node = jmock.node()
        node.id = f"pick-{i:03d}"
        node.datacenter = "dc1" if i % 4 else "dc2"
        node.resources.cpu = rng.choice([1000, 2000, 4000])
        node.resources.memory_mb = rng.choice([1024, 4096, 8192])
        nodes.append(node)
    return nodes


def pick_jobs(seed, n=24):
    rng = random.Random(seed + 1)
    jobs = []
    for k in range(n):
        job = jax_build_job(f"pick-{seed}-{k}", "batch", rng.randrange(1, 4),
                            cpu=rng.choice([100, 300, 700, 1500]),
                            memory_mb=rng.choice([64, 512, 3000]),
                            express=True)
        if rng.random() < 0.3:
            job.datacenters = ["dc1", "dc2"]
        jobs.append(job)
    return jobs


def lane_view(srv):
    lane = srv.express_lane
    return {
        "placements": [
            (e.ev.id == e.lease.eval_id, e.job.id,
             [a.node_id for a in e.allocs], [a.name for a in e.allocs],
             round(e.lease.granted_ttl, 12),
             {k: v.tolist() for k, v in sorted(e.lease.debits.items())})
            for e in lane._pending
        ],
        "debits": {k: v.tolist()
                   for k, v in sorted(lane.ledger.debit_map().items())},
        "fallbacks": dict(lane.fallbacks),
        "placed": lane.placed, "tasks_placed": lane.tasks_placed,
    }


@pytest.mark.parametrize("probes, choices", [(16, 2), (4, 1), (32, 8)])
@pytest.mark.parametrize("seed", [3, 11, 42])
def test_place_picks_equal_reference(seed, probes, choices):
    ref, got = pick_servers(seed, probes=probes, choices=choices,
                            lease_ttl=30.0)
    try:
        nodes = pick_nodes(seed, 24)
        for srv, conv in ((ref, lambda x: x),
                          (got, lambda x: structs_from_reference(
                              to_dict(x), "Node"))):
            srv.node_batch_register([conv(n) for n in nodes])
            srv.express_lane.commit_gate.clear()
        for job in pick_jobs(seed):
            ref.job_register(job)
            got.job_register(structs_from_reference(to_dict(job), "Job"))
        assert lane_view(got) == lane_view(ref)
        assert got.express_lane.placed > 0
        # The view the pick read: the same totals and base usage.
        for dcs in (("dc1",), ("dc1", "dc2")):
            rv = ref.express_lane._views.get(dcs)
            gv = got.express_lane._views.get(dcs)
            assert (rv is None) == (gv is None)
            if rv is not None:
                assert [n.id for n in gv.nodes] == [n.id for n in rv.nodes]
                assert np.array_equal(np.asarray(gv.totals),
                                      np.asarray(rv.totals))
                assert np.array_equal(np.asarray(gv.used),
                                      np.asarray(rv.used))
    finally:
        ref.shutdown()
        got.shutdown()


def test_capacity_view_rolls_like_base_usage():
    """capacity_view's in-place roll through the alloc change log equals
    the base usage recomputed from scratch, generation after
    generation."""
    from nomad_tpu_torch.tpu.mirror import NodeMirror

    state = StateStore()
    nodes = []
    for i in range(6):
        node = mock.node()
        node.id = f"cv-{i}"
        nodes.append(node)
    state.upsert_nodes(1, nodes)
    mirror = NodeMirror(nodes, "cpu")
    index = 2
    rng = random.Random(5)
    for _ in range(6):
        allocs = []
        for _ in range(rng.randrange(1, 4)):
            allocs.append(Allocation(
                id=generate_uuid(), eval_id="e", name="t[0]",
                node_id=f"cv-{rng.randrange(6)}", job_id="j",
                resources=Resources(cpu=rng.randrange(10, 300),
                                    memory_mb=rng.randrange(10, 300)),
                desired_status=structs.ALLOC_DESIRED_STATUS_RUN,
                client_status=structs.ALLOC_CLIENT_STATUS_PENDING))
        state.upsert_allocs(index, allocs)
        index += 1
        totals, used = mirror.capacity_view(state.snapshot())
        want, _bw = mirror._compute_base_usage(state.snapshot())
        assert np.array_equal(used, want)
        assert totals is mirror.totals_np


# -- the lane's contract on the port's Server ----------------------------------


def test_express_end_to_end():
    srv = dev_server()
    try:
        register_nodes(srv, 10)
        job = express_job("exp-e2e", count=3)
        eval_id, _ = srv.job_register(job)
        lane = srv.express_lane
        assert lane.placed == 1 and lane.tasks_placed == 3
        assert wait(lambda: (srv.state_store.eval_by_id(eval_id) or
                             structs.Evaluation()).status == "complete")
        ev = srv.state_store.eval_by_id(eval_id)
        assert ev.triggered_by == pexp.EVAL_TRIGGER_EXPRESS
        assert len(srv.state_store.allocs_by_job(job.id)) == 3
        assert wait(lambda: lane.committed == 1, 5.0)
        assert lane.bounces == 0 and lane.ledger.active() == 0
        placed = [e for e in srv.fsm.events.all_events()
                  if e.topic == "Express"]
        assert [e.type for e in placed] == ["ExpressPlaced"]
        assert placed[0].key == eval_id and placed[0].payload["tasks"] == 3
        srv.slo_monitor.poll()
        snap = srv.slo_monitor.snapshot()
        assert snap["samples"]["express_placed"]["count"] == 1
        assert "express_placed_p50_ms" in {o["name"]
                                           for o in snap["objectives"]}
    finally:
        srv.shutdown()


def test_express_lane_off_is_inert():
    srv = dev_server(express=False)
    try:
        assert srv.plan_applier.ledger is None
        register_nodes(srv, 4)
        job = express_job("exp-off", count=2)
        eval_id, _ = srv.job_register(job)
        ev = srv.wait_for_eval(eval_id, timeout=15.0)
        assert ev.triggered_by == structs.EVAL_TRIGGER_JOB_REGISTER
        assert srv.express_lane.placed == 0
        assert len(srv.state_store.allocs_by_job(job.id)) == 2
        assert not [e for e in srv.fsm.events.all_events()
                    if e.topic == "Express"]
    finally:
        srv.shutdown()


def test_express_ineligible_and_no_fit_fall_back():
    srv = dev_server()
    try:
        register_nodes(srv, 4, cpu=1000, memory_mb=1000)
        svc = build_job("svc-exp", structs.JOB_TYPE_SERVICE, 2)
        svc.express = True
        ev = srv.wait_for_eval(srv.job_register(svc)[0], timeout=15.0)
        assert ev.status == structs.EVAL_STATUS_COMPLETE
        assert srv.express_lane.placed == 0
        big = express_job("exp-big", cpu=5000)
        srv.job_register(big)
        assert srv.express_lane.fallbacks == {"no_fit": 1}
    finally:
        srv.shutdown()


def snap_with_node(cpu=1000, memory_mb=1000):
    state = StateStore()
    node = mock.node()
    node.id = "n1"
    node.resources = Resources(cpu=cpu, memory_mb=memory_mb,
                               disk_mb=10000, iops=100)
    node.reserved = None
    node.status = structs.NODE_STATUS_READY
    state.upsert_node(1, node)
    return state.snapshot()


def alloc_on(node_id, cpu, mem, job_id="j1", eval_id=""):
    return Allocation(
        id=generate_uuid(), eval_id=eval_id or generate_uuid(),
        name="t[0]", node_id=node_id, job_id=job_id,
        resources=Resources(cpu=cpu, memory_mb=mem),
        desired_status=structs.ALLOC_DESIRED_STATUS_RUN,
        client_status=structs.ALLOC_CLIENT_STATUS_PENDING)


def test_verify_under_the_ledger_exempts_own_lease():
    """A slow plan cannot verify into leased capacity; the express plan
    verifying its own commit is exempt from its own lease but not from
    another's (the pipeline's reservation hooks with a live ledger)."""
    plan = Plan(eval_id="ev-slow")
    plan.append_alloc(alloc_on("n1", cpu=600, mem=100))
    assert evaluate_plan(snap_with_node(), plan).node_allocation
    blocked = evaluate_plan(snap_with_node(), plan,
                            reservations={"n1": vec(600, 100)})
    assert blocked.refresh_index > 0 and not blocked.node_allocation
    elsewhere = evaluate_plan(snap_with_node(), plan,
                              reservations={"n9": vec(10**9)})
    assert elsewhere.node_allocation

    ledger = pexp.ReservationLedger()
    mine = ledger.reserve("ev-exp", {"n1": vec(600, 100)}, ttl=30.0)
    own = Plan(eval_id="ev-exp", all_at_once=True, express_lease=mine.id)
    own.append_alloc(alloc_on("n1", cpu=600, mem=100, eval_id="ev-exp"))
    [res] = evaluate_plans(snap_with_node(), [own], ledger=ledger)
    assert res.refresh_index == 0 and res.node_allocation
    ledger.reserve("ev-other", {"n1": vec(600, 100)}, ttl=30.0)
    own2 = Plan(eval_id="ev-exp", all_at_once=True, express_lease=mine.id)
    own2.append_alloc(alloc_on("n1", cpu=600, mem=100, eval_id="ev-exp"))
    [res2] = evaluate_plans(snap_with_node(), [own2], ledger=ledger)
    assert res2.refresh_index > 0 and not res2.node_allocation


def test_bounce_on_taken_capacity_places_exactly_once():
    srv = dev_server(workers=0, lease_ttl=5.0)
    try:
        register_nodes(srv, 3, cpu=1000, memory_mb=1000)
        lane = srv.express_lane
        lane.commit_gate.clear()
        job = express_job("exp-bounce", cpu=600, memory_mb=100)
        srv.job_register(job)
        entry = lane._pending[0]
        [alloc] = entry.allocs
        original, chosen = alloc.id, alloc.node_id
        expired = lane.ledger.expire_due(now=time.monotonic() + 3600.0)
        assert [lease.id for lease in expired] == [entry.lease.id]
        filler = alloc_on(chosen, cpu=900, mem=800, job_id="filler")
        srv.raft.apply("alloc_update", {"allocs": [filler]}).result()
        lane.commit_gate.set()
        assert wait(lambda: lane.committed == 1, 15.0)
        assert lane.bounces >= 1
        allocs = srv.state_store.allocs_by_job(job.id)
        assert len(allocs) == 1 and allocs[0].id == original
        assert allocs[0].node_id != chosen
        assert pexp.EXPRESS_BOUNCE in [o["outcome"] for o in lane._outcomes]
        assert lane.ledger.active() == 0
    finally:
        srv.shutdown()


def test_bounce_exhaustion_reconciles_via_slow_path():
    srv = dev_server(workers=1, max_bounces=1, lease_ttl=5.0)
    try:
        register_nodes(srv, 2, cpu=1000, memory_mb=1000)
        lane = srv.express_lane
        lane.commit_gate.clear()
        job = express_job("exp-rec", cpu=600, memory_mb=100)
        orig_eval, _ = srv.job_register(job)
        entry = lane._pending[0]
        lane.ledger.expire_due(now=time.monotonic() + 3600.0)
        fillers = [alloc_on(f"node-{i:03d}", cpu=950, mem=950,
                            job_id="filler") for i in range(2)]
        srv.raft.apply("alloc_update", {"allocs": fillers}).result()
        lane.commit_gate.set()
        assert wait(lambda: lane.reconciled == 1, 15.0)
        evs = srv.state_store.evals_by_job(job.id)
        reconcile = next(e for e in evs if e.triggered_by
                         == pexp.EVAL_TRIGGER_EXPRESS_RECONCILE)
        original = srv.state_store.eval_by_id(orig_eval)
        assert original.terminal_status()
        assert original.next_eval == reconcile.id
        assert not [a for a in srv.state_store.allocs_by_job(job.id)
                    if not a.terminal_status()]
        assert entry.bounces >= 1
    finally:
        srv.shutdown()


def test_backlog_full_falls_back_without_deadlock():
    srv = dev_server(workers=1, max_pending=1)
    try:
        register_nodes(srv, 4)
        lane = srv.express_lane
        lane.commit_gate.clear()
        srv.job_register(express_job("exp-q1"))
        done = threading.Event()

        def second():
            srv.job_register(express_job("exp-q2"))
            done.set()

        threading.Thread(target=second, daemon=True).start()
        assert done.wait(10.0)
        assert lane.fallbacks.get("backlog_full") == 1
        lane.commit_gate.set()
        for jid in ("exp-q1", "exp-q2"):
            assert wait(lambda j=jid: len(
                srv.state_store.allocs_by_job(j)) == 1, 15.0)
    finally:
        srv.shutdown()


def test_duplicate_submission_in_commit_window_is_idempotent():
    srv = dev_server(workers=1)
    try:
        register_nodes(srv, 4)
        lane = srv.express_lane
        lane.commit_gate.clear()
        first, _ = srv.job_register(express_job("exp-dup", count=2))
        retry, _ = srv.job_register(express_job("exp-dup", count=2))
        assert retry == first and lane.placed == 1 and lane.duplicates == 1
        lane.commit_gate.set()
        assert wait(lambda: len(
            srv.state_store.allocs_by_job("exp-dup")) == 2, 15.0)
        time.sleep(0.2)
        assert len([a for a in srv.state_store.allocs_by_job("exp-dup")
                    if not a.terminal_status()]) == 2
        srv.job_register(express_job("exp-dup", count=2))
        assert lane.fallbacks.get("job_exists") == 1
    finally:
        srv.shutdown()


def test_stop_drains_pending_entries_to_reconcile():
    srv = dev_server(workers=0)
    try:
        register_nodes(srv, 4)
        lane = srv.express_lane
        lane.commit_gate.clear()
        for k in range(3):
            srv.job_register(express_job(f"exp-stop-{k}"))
        assert lane.backlog() == 3
    finally:
        srv.shutdown()
    assert lane.reconciled == 3
    for k in range(3):
        assert any(e.triggered_by == pexp.EVAL_TRIGGER_EXPRESS_RECONCILE
                   for e in srv.state_store.evals_by_job(f"exp-stop-{k}"))


def test_leases_of_distinct_submissions_stack():
    srv = dev_server(workers=0, probes=16)
    try:
        register_nodes(srv, 2, cpu=1000, memory_mb=1000)
        lane = srv.express_lane
        lane.commit_gate.clear()
        srv.job_register(express_job("exp-a", cpu=600, memory_mb=100))
        srv.job_register(express_job("exp-b", cpu=600, memory_mb=100))
        nodes = [e.allocs[0].node_id for e in lane._pending]
        assert nodes[0] != nodes[1]
        assert lane.ledger.active() == 2
        lane.commit_gate.set()
        assert wait(lambda: lane.committed == 2, 15.0)
        assert lane.bounces == 0
    finally:
        srv.shutdown()


def node_usage(snap):
    usage = {}
    for node in snap.nodes():
        total = np.zeros(4, dtype=np.int64)
        for a in structs.filter_terminal_allocs(snap.allocs_by_node(node.id)):
            if a.resources is not None:
                total += np.asarray(a.resources.as_vector(), dtype=np.int64)
        usage[node.id] = total
    return usage


@pytest.mark.parametrize("seed", [11, 42, 1337])
def test_fuzz_capacity_safety_and_exactly_once(seed):
    """nomad_tpu's fuzz family on the port: seeded interleavings of
    express and slow-path submissions on a tight cell, with committer
    stalls and forced lease expiry. At quiesce no node exceeds its
    capacity and every express task placed exactly once."""
    rng = random.Random(seed)
    srv = dev_server(workers=2, lease_ttl=2.0, probes=32)
    try:
        n_nodes, cpu = 6, 2000
        register_nodes(srv, n_nodes, cpu=cpu, memory_mb=4000)
        lane = srv.express_lane
        express_jobs = []
        budget = int(n_nodes * cpu * 0.65)
        offered = 0
        for round_no in range(30):
            r = rng.random()
            if r < 0.55:
                count = rng.randrange(1, 3)
                job_cpu = rng.choice([100, 300, 500])
                job = express_job(f"exp-{seed}-{round_no}", count=count,
                                  cpu=job_cpu, memory_mb=64)
                if offered + count * job_cpu > budget:
                    continue
                offered += count * job_cpu
                express_jobs.append(job)
                srv.job_register(job)
            elif r < 0.85:
                count = rng.randrange(1, 4)
                job_cpu = rng.choice([200, 400])
                job = build_job(f"slow-{seed}-{round_no}",
                                structs.JOB_TYPE_BATCH, count,
                                cpu=job_cpu, memory_mb=64)
                if offered + count * job_cpu > budget:
                    continue
                offered += count * job_cpu
                srv.job_register(job)
            elif r < 0.93:
                lane.commit_gate.clear()
                time.sleep(rng.random() * 0.05)
                lane.commit_gate.set()
            else:
                lane.ledger.expire_due(now=time.monotonic() + 3600.0)
            if rng.random() < 0.3:
                time.sleep(0.01)
        lane.commit_gate.set()

        def quiesced():
            # Every entry committed or reconciled: a forced lease expiry
            # empties the ledger while an entry's plan is still in flight.
            if (lane.backlog() or lane.ledger.active()
                    or lane.committed + lane.reconciled != lane.placed):
                return False
            if any(not ev.terminal_status()
                   for ev in srv.state_store.evals()):
                return False
            stats = srv.eval_broker.snapshot_stats()
            return (stats.total_ready + stats.total_unacked
                    + stats.total_blocked) == 0

        assert wait(quiesced, 60.0), "fuzz run did not quiesce"
        snap = srv.state_store.snapshot()
        usage = node_usage(snap)
        for node in snap.nodes():
            total = np.asarray(node.resources.as_vector(), dtype=np.int64)
            reserved = (np.asarray(node.reserved.as_vector(), np.int64)
                        if node.reserved is not None else 0)
            assert (usage[node.id] + reserved <= total).all(), node.id
        for job in express_jobs:
            want = sum(tg.count for tg in job.task_groups)
            live = [a for a in snap.allocs_by_job(job.id)
                    if not a.terminal_status()]
            assert len(live) == want and len({a.id for a in live}) == want
    finally:
        srv.shutdown()


def test_same_seed_same_express_decisions():
    def run():
        srv = dev_server(workers=0, seed=9)
        try:
            register_nodes(srv, 8)
            out = []
            for k in range(10):
                srv.express_lane.commit_gate.clear()
                srv.job_register(express_job(f"exp-{k}", count=2))
                entry = srv.express_lane._pending[-1]
                out.append((tuple(a.node_id for a in entry.allocs),
                            round(entry.lease.granted_ttl, 9)))
            return out
        finally:
            srv.shutdown()

    assert run() == run()


# -- the cell: failover reconciles over Express.Reconcile ---------------------


def test_leader_failover_reconciles_outstanding_express():
    """A leader deposed (one-way outbound raft partition) while an express
    placement is uncommitted drops its lease on demotion; its committer
    forwards the entry to the new leader as a pending reconcile eval
    (Express.Reconcile), which places the task exactly once."""
    seed0 = faults.get_registry().seed
    servers = form_cluster(3, ServerConfig(
        device="cpu", scheduler_backend="host", scheduler_workers=1,
        min_heartbeat_ttl=3600.0, prewarm_shapes=False,
        express={"enabled": True}), base_cluster=relaxed_cluster())
    try:
        leader = wait_for_leader(servers, timeout=30.0)
        for i in range(4):
            node = mock.node()
            node.id = f"fo-node-{i}"
            retry_write(lambda n=node: leader.node_register(n))
        leader = wait_for_leader(servers, timeout=30.0)
        leader.express_lane.commit_gate.clear()
        job = express_job("exp-failover")
        retry_write(lambda: leader.job_register(job))
        holder = next((s for s in servers if s.express_lane.backlog()),
                      None)
        assert holder is not None
        assert holder.express_lane.ledger.active() == 1
        old_id = holder.cluster.node_id
        faults.get_registry().load({"seed": 7, "sites": {
            "raft.append": {"mode": "partition", "match": f"{old_id}->"},
            "raft.vote": {"mode": "partition", "match": f"{old_id}->"},
        }})
        survivors = [s for s in servers if s is not holder]
        assert wait(lambda: any(s.raft.is_leader for s in survivors), 45.0)
        new_leader = next(s for s in survivors if s.raft.is_leader)
        assert wait(lambda: not holder.raft.is_leader, 20.0)
        assert wait(lambda: holder.express_lane.ledger.active() == 0, 10.0)
        holder.express_lane.commit_gate.set()

        def live():
            return [a for a in new_leader.state_store.allocs_by_job(job.id)
                    if not a.terminal_status()]

        assert wait(lambda: len(live()) == 1, 60.0)
        assert any(e.triggered_by == pexp.EVAL_TRIGGER_EXPRESS_RECONCILE
                   for e in new_leader.state_store.evals_by_job(job.id))
        time.sleep(0.5)
        assert len(live()) == 1
    finally:
        # The registry is the process's: leave its seed as it was found
        # (the faults route of test_torch_api.py compares it).
        faults.get_registry().load({"seed": seed0, "sites": {}})
        for srv in servers:
            srv.shutdown(drain_timeout=2.0)


# -- express-1k through the runner --------------------------------------------


@pytest.fixture(scope="module")
def express_1k():
    return psc.run_scenario("express-1k", seed=42, device="cpu")


def test_express_1k_digest_equals_reference(express_1k):
    with open(os.path.join(REPO, "nomad_tpu_torch", "simcluster",
                           "reference_digests.json")) as f:
        ref = json.load(f)["scenarios"]["express-1k"]
    assert express_1k["events"]["digest"] == ref["digest"]
    assert express_1k["events"]["by_type"] == ref["by_type"]
    assert express_1k["placements"]["placed"] == ref["placed"]
    assert express_1k["events"]["truncated"] is False


def test_express_1k_lane_books(express_1k):
    lane = express_1k["express"]["lane"]
    # 40 stream submissions plus the warmup probe, each committed or
    # reconciled exactly once.
    assert lane["placed"] == 41
    assert lane["committed"] + lane["reconciled"] == lane["placed"]
    assert lane["ledger"]["active"] == 0 and lane["backlog"] == 0
    assert express_1k["express"]["placed_events"] == 40
    att = express_1k["latency_attribution"]
    assert att["express_placed_ms"]["n"] == 40
    rows = {r["objective"]: r for r in att["slo_check"]}
    assert "express_placed_p50_ms" in rows


class FakeLane:
    def __init__(self):
        self.placed, self.committed, self.reconciled = 2, 1, 0


class FakeStore:
    def snapshot(self):
        return self

    def eval_by_id(self, eval_id):
        return structs.Evaluation(id=eval_id, status="complete")

    def node_by_id(self, node_id):
        return None


class FakeBroker:
    def snapshot_stats(self):
        class Stats:
            total_ready = total_unacked = total_blocked = 0
        return Stats()


class FakeServer:
    def __init__(self):
        self.state_store = FakeStore()
        self.eval_broker = FakeBroker()
        self.express_lane = FakeLane()


def test_runner_quiesces_after_the_last_express_commit():
    """An express eval is complete before its allocations commit: the
    runner's quiescence waits for the lane too (nomad_tpu's waits on evals
    only, so its window can close with the last commit in flight)."""
    srv = FakeServer()
    runner = psc.ScenarioRunner(psc.SCENARIOS["express-1k"], device="cpu")

    def commit_later():
        time.sleep(0.3)
        srv.express_lane.committed = 2

    t = threading.Thread(target=commit_later)
    t0 = time.monotonic()
    t.start()
    runner._wait_quiesced(srv, ["ev-1"], [], time.monotonic() + 10.0)
    t.join()
    assert time.monotonic() - t0 >= 0.3
    assert srv.express_lane.committed == 2
    srv.express_lane.committed = 1
    with pytest.raises(TimeoutError, match="express_in_flight=1"):
        runner._wait_quiesced(srv, ["ev-1"], [], time.monotonic() + 0.2)
