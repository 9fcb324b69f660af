"""The port's job-update path against nomad_tpu's.

Every case runs the same cluster, jobs and evals through nomad_tpu's
``tests/sched_harness.Harness`` and ``nomad_tpu_torch.harness.Harness``
(``device="cpu"``) and compares, eval by eval: the placements by node,
the stops by (node, name), the in-place updates by (node, name, new
resources), the failed count, the alloc ids and port numbers, the
follow-up evals, and the job's allocs in the store afterwards.

Alloc and eval ids come from ``os.urandom`` in both packages' ``structs``
and from ``tpu.solver._new_ids_seed``. A rolling update evicts the first
allocs in the state's id order, so the two sides must draw the same ids:
each package's ``structs`` gets an ``os`` namespace of its own whose
``urandom`` reads a seeded stream, and each ``_new_ids_seed`` reads the
same side's stream. The two streams start from one seed; one shared
stream would not do, since the sides draw in turn. The fixtures (mock
nodes, jobs and allocs) are built with nomad_tpu's structs from a third
stream and converted for the port, so building them draws from neither
side's stream.

The cases: nomad_tpu's ``test_generic_sched.py`` update cases (modify,
rolling, in place, drain, retry limit), the update kinds on the mixed
cluster of ``test_torch_scheduler.py``, network asks with dynamic and
reserved ports, ``test_block_inplace.py``'s block-world rounds,
``test_fuzz_block_lifecycle.py``'s two lifecycles, and
``test_fuzz_differential.py``'s rolling-update, ports-at-scale,
anti-affinity and in-place identity families.
"""

import copy
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu import structs as jst
from nomad_tpu.api.codec import to_dict
from nomad_tpu.scheduler import wait_for_device
from nomad_tpu.server.plan_apply import evaluate_plan as j_evaluate_plan
from nomad_tpu.tpu import solver as jsolver
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.harness import Harness as PortHarness
from nomad_tpu_torch.harness import RejectPlan as PortRejectPlan
from nomad_tpu_torch.server.plan_apply import evaluate_plan as p_evaluate_plan
from nomad_tpu_torch.state import StateStore as PortStore
from nomad_tpu_torch.tpu import solver as psolver

from sched_harness import Harness as JaxHarness
from sched_harness import RejectPlan as JaxRejectPlan
from test_fuzz_differential import (
    _collision_penalty,
    _random_cluster,
    _random_job,
    _random_port_job,
    _roomy_nodes,
)
from test_torch_scheduler import make_job, random_cluster

torch.set_num_threads(2)

RUN = jst.ALLOC_DESIRED_STATUS_RUN


@pytest.fixture(scope="module", autouse=True)
def _jax_device_path():
    """nomad_tpu's tpu-* factories fall back to its host oracle until the
    device probe succeeds; the comparison needs its device solver."""
    assert wait_for_device(timeout=120.0) is not None


# -- seeded ids ----------------------------------------------------------------


class SeededOS:
    """An ``os`` stand-in for a package's ``structs``: ``urandom`` reads a
    seeded stream; ``ids_seed`` is ``_new_ids_seed`` on the same stream."""

    def __init__(self, seed):
        self._rng = random.Random(seed)

    def urandom(self, n):
        return self._rng.randbytes(n)

    def ids_seed(self):
        return int.from_bytes(self.urandom(16), "little")


# -- views ---------------------------------------------------------------------


def res(r):
    return None if r is None else tuple(int(x) for x in r.as_vector())


def ports(alloc):
    out = []
    for task in sorted(alloc.task_resources or {}):
        r = alloc.task_resources[task]
        out.append((task, tuple(
            (n.device, n.ip, n.mbits, tuple(n.reserved_ports),
             tuple(n.dynamic_ports)) for n in (r.networks or []))))
    return tuple(out)


def plan_view(plans, known):
    """Decisions of ``plans``; ``known`` holds the alloc ids in the store
    before the eval, so an object-path entry under an existing id is an
    in-place update."""
    place, stop, inplace, failed = [], [], [], 0
    for plan in plans:
        for nid, allocs in plan.node_update.items():
            stop.extend((nid, a.name, a.id, a.desired_status) for a in allocs)
        for nid, allocs in plan.node_allocation.items():
            for a in allocs:
                row = (nid, a.name, a.id, res(a.resources), ports(a))
                (inplace if a.id in known else place).append(row)
        for b in plan.alloc_batches:
            place.extend((a.node_id, a.name, a.id, res(a.resources), ports(a))
                         for a in b.materialize())
        for b in plan.update_batches:
            if b.src_node_ids:
                inplace.append(("block", b.tg_name, tuple(b.src_node_ids),
                                tuple(b.src_node_counts), tuple(b.alloc_ids),
                                res(b.resources), res(b.src_resources)))
            else:
                inplace.extend((a.node_id, a.name, a.id, res(b.resources))
                               for a in b.allocs)
        for a in plan.failed_allocs:
            failed += 1 + (a.metrics.coalesced_failures if a.metrics else 0)
    return {"place": sorted(place), "stop": sorted(stop),
            "inplace": sorted(inplace), "failed": failed}


def store_view(state, job_id):
    return sorted(
        (a.id, a.node_id, a.name, a.desired_status, res(a.resources),
         a.job.modify_index if a.job is not None else None, a.eval_id,
         ports(a))
        for a in state.allocs_by_job(job_id))


def live(state, job_id):
    return [a for a in state.allocs_by_job(job_id) if a.desired_status == RUN]


def check_fits(state, node_ids):
    for nid in node_ids:
        node = state.node_by_id(nid)
        fit, dim, _ = pst.allocs_fit(node, [
            a for a in state.allocs_by_node(nid) if a.desired_status == RUN])
        assert fit, (nid, dim)


# -- the pair of worlds --------------------------------------------------------


class ColumnarCommit:
    """Commits evaluated plans columnar (the FSM's posture): blocks through
    ``upsert_alloc_blocks``, in-place batches through
    ``apply_update_batches``; ``columnar=False`` materializes everything
    to object rows, as nomad_tpu's lifecycle fuzz does for its object
    world."""

    def __init__(self, harness, evaluate_plan, columnar=True):
        self.h = harness
        self.evaluate_plan = evaluate_plan
        self.columnar = columnar

    def submit_plan(self, plan):
        index = self.h.next_index()
        state = self.h.state
        result = self.evaluate_plan(state.snapshot(), plan)
        result.alloc_index = index
        allocs = [a for lst in result.node_update.values() for a in lst]
        allocs += [a for lst in result.node_allocation.values() for a in lst]
        allocs += result.failed_allocs
        if not self.columnar:
            for b in result.alloc_batches:
                allocs.extend(b.materialize())
            for b in result.update_batches:
                b.resolve(state.snapshot())
                allocs.extend(b.materialize())
        if allocs:
            state.upsert_allocs(index, allocs)
        if self.columnar and result.alloc_batches:
            state.upsert_alloc_blocks(index, result.alloc_batches)
        if self.columnar and result.update_batches:
            state.apply_update_batches(index, result.update_batches)
        return result, None

    def update_eval(self, ev):
        pass

    def create_eval(self, ev):
        pass


class Twin:
    """nomad_tpu's harness and the port's, fed the same objects; every
    ``process`` compares the two evals' decisions."""

    def __init__(self, monkeypatch, seed, planner=None):
        self.jax = JaxHarness()
        self.port = PortHarness()
        if planner == "reject":
            self.jax.planner = JaxRejectPlan(self.jax)
            self.port.planner = PortRejectPlan(self.port)
        elif planner == "columnar":
            self.jax.planner = ColumnarCommit(self.jax, j_evaluate_plan)
            self.port.planner = ColumnarCommit(self.port, p_evaluate_plan)
        self._fixture_os = SeededOS(("fixture", seed).__repr__())
        self._jax_os = SeededOS(("ids", seed).__repr__())
        self._port_os = SeededOS(("ids", seed).__repr__())
        monkeypatch.setattr(jst, "os", self._fixture_os)
        monkeypatch.setattr(pst, "os", self._port_os)
        monkeypatch.setattr(jsolver, "_new_ids_seed", self._jax_os.ids_seed)
        monkeypatch.setattr(psolver, "_new_ids_seed",
                            self._port_os.ids_seed)
        self.jobs = {}      # job id -> (nomad_tpu job, port job)
        self.node_ids = []
        self.n_evals = 0

    def _index(self):
        idx = self.jax.next_index()
        assert self.port.next_index() == idx
        return idx

    def _port_job(self, job):
        pair = self.jobs.get(job.id)
        if pair is not None and pair[0] is job:
            return pair[1]
        return structs_from_reference(to_dict(job), "Job")

    def nodes(self, nodes):
        for node in nodes:
            idx = self._index()
            self.jax.state.upsert_node(idx, node)
            self.port.state.upsert_node(
                idx, structs_from_reference(to_dict(node), "Node"))
            if node.id not in self.node_ids:
                self.node_ids.append(node.id)

    def job(self, job):
        """Register ``job`` (a nomad_tpu Job) on both sides."""
        pjob = self._port_job(job)
        idx = self._index()
        self.jax.state.upsert_job(idx, job)
        self.port.state.upsert_job(idx, pjob)
        self.jobs[job.id] = (job, pjob)
        return job

    def update_job(self, job_id, mutate, copy_job=True):
        """Apply ``mutate`` to both sides' stored job (to deep copies of
        them with ``copy_job``, else to the stored objects, which the
        committed allocs also hold) and register the result."""
        jjob, pjob = self.jobs[job_id]
        if copy_job:
            jjob, pjob = copy.deepcopy(jjob), copy.deepcopy(pjob)
        mutate(jjob)
        mutate(pjob)
        idx = self._index()
        self.jax.state.upsert_job(idx, jjob)
        self.port.state.upsert_job(idx, pjob)
        self.jobs[job_id] = (jjob, pjob)
        return jjob

    def allocs(self, allocs):
        pallocs = []
        for a in allocs:
            pa = structs_from_reference(to_dict(a), "Allocation")
            if a.job is not None:
                pa.job = self._port_job(a.job)
            pallocs.append(pa)
        idx = self._index()
        self.jax.state.upsert_allocs(idx, allocs)
        self.port.state.upsert_allocs(idx, pallocs)

    def drain(self, node_ids):
        for nid in node_ids:
            idx = self._index()
            for st in (self.jax.state, self.port.state):
                node = st.node_by_id(nid).copy()
                node.drain = True
                st.upsert_node(idx, node)

    def process(self, factory, job_id, trigger=jst.EVAL_TRIGGER_JOB_REGISTER,
                node_id="", ev=None):
        """One eval on both sides (``ev``: a nomad_tpu follow-up eval to
        run as it stands); returns the port's plans and its view."""
        jjob = self.jobs[job_id][0] if job_id in self.jobs else None
        if ev is None:
            self.n_evals += 1
            kw = dict(id=f"eval-{self.n_evals:04d}",
                      priority=jjob.priority if jjob else 50,
                      type=jjob.type if jjob else jst.JOB_TYPE_SERVICE,
                      triggered_by=trigger, job_id=job_id, node_id=node_id)
        else:
            kw = dict(id=ev.id, priority=ev.priority, type=ev.type,
                      triggered_by=ev.triggered_by, job_id=ev.job_id,
                      node_id=ev.node_id,
                      job_modify_index=ev.job_modify_index,
                      previous_eval=ev.previous_eval, wait=ev.wait)
        known_j = {a.id for a in self.jax.state.allocs_by_job(job_id)}
        known_p = {a.id for a in self.port.state.allocs_by_job(job_id)}
        assert known_j == known_p
        nj, np_ = len(self.jax.plans), len(self.port.plans)
        nej, nep = len(self.jax.evals), len(self.port.evals)
        ncj, ncp = len(self.jax.create_evals), len(self.port.create_evals)
        jst.os = self._jax_os
        try:
            self.jax.process(factory, jst.Evaluation(**kw))
        finally:
            jst.os = self._fixture_os
        self.port.process(factory, pst.Evaluation(**kw), device="cpu")
        jplans, pplans = self.jax.plans[nj:], self.port.plans[np_:]
        assert len(jplans) == len(pplans), (kw["id"], len(jplans),
                                            len(pplans))
        ref, got = plan_view(jplans, known_j), plan_view(pplans, known_p)
        for key in ("place", "stop", "inplace", "failed"):
            assert got[key] == ref[key], f"{kw['id']}: {key} differs"
        jev = (self.jax.evals[nej:], self.jax.create_evals[ncj:])
        pev = (self.port.evals[nep:], self.port.create_evals[ncp:])
        assert [(e.id, e.status, e.next_eval, e.triggered_by)
                for e in pev[0]] == [(e.id, e.status, e.next_eval,
                                      e.triggered_by) for e in jev[0]]
        assert [(e.id, e.triggered_by, e.wait, e.previous_eval,
                 e.job_modify_index) for e in pev[1]] == [
            (e.id, e.triggered_by, e.wait, e.previous_eval,
             e.job_modify_index) for e in jev[1]]
        if job_id:
            assert store_view(self.port.state, job_id) == store_view(
                self.jax.state, job_id), f"{kw['id']}: the stores differ"
        return pplans, got, jev[1]

    def roll(self, factory, job_id, max_rounds=20):
        """Process follow-up rolling evals until none is created; returns
        the number of rounds."""
        rounds = 0
        while rounds < max_rounds:
            created = [e for e in self.jax.create_evals
                       if e.triggered_by == jst.EVAL_TRIGGER_ROLLING_UPDATE
                       and e.job_id == job_id]
            if len(created) <= rounds:
                return rounds
            self.process(factory, job_id, ev=created[rounds])
            rounds += 1
        raise AssertionError(f"{job_id}: still rolling after {rounds} rounds")


# -- 1. nomad_tpu's generic scheduler update cases ---------------------------


def _mock_job(factory):
    job = jmock.job()
    if factory == "tpu-batch":
        job.type = jst.JOB_TYPE_BATCH
    return job


def _existing(job, nodes, n=10):
    out = []
    for i in range(n):
        alloc = jmock.alloc()
        alloc.job = job
        alloc.job_id = job.id
        alloc.node_id = nodes[i % len(nodes)].id
        alloc.name = f"my-job.web[{i}]"
        out.append(alloc)
    return out


def _replacement(job, factory, **kw):
    job2 = _mock_job(factory)
    job2.id = job.id
    for key, value in kw.items():
        setattr(job2, key, value)
    return job2


def case_modify(tw, factory, nodes):
    """generic_sched_test.go:116-212: a destructive change replaces all
    ten; terminal allocs are ignored."""
    job = tw.job(_mock_job(factory))
    tw.allocs(_existing(job, nodes))
    terminal = _existing(job, nodes, 5)
    for a in terminal:
        a.desired_status = jst.ALLOC_DESIRED_STATUS_FAILED
    tw.allocs(terminal)
    job2 = _replacement(job, factory)
    job2.task_groups[0].tasks[0].config["command"] = "/bin/other"
    tw.job(job2)
    _, got, _ = tw.process(factory, job.id)
    assert len(got["stop"]) == 10 and len(got["place"]) == 10


def _rolling(tw, factory, nodes, count=None):
    job = tw.job(_mock_job(factory))
    tw.allocs(_existing(job, nodes))
    job2 = _replacement(job, factory)
    job2.update = jst.UpdateStrategy(stagger=30.0, max_parallel=5)
    job2.task_groups[0].tasks[0].config["command"] = "/bin/other"
    if count is not None:
        job2.task_groups[0].count = count
    tw.job(job2)
    _, got, created = tw.process(factory, job.id)
    # a shrink's surplus stops outside the rolling limit
    assert len(got["stop"]) == 5 + max(0, 10 - (count or 10))
    assert len(created) == 1 and created[0].wait == 30.0
    tw.roll(factory, job.id)
    want = count if count is not None else 10
    assert len(live(tw.port.state, job.id)) == want


def case_rolling(tw, factory, nodes):
    """generic_sched_test.go:214-313, rolled to its end."""
    _rolling(tw, factory, nodes)


def case_rolling_count_up(tw, factory, nodes):
    _rolling(tw, factory, nodes, count=14)


def case_rolling_count_down(tw, factory, nodes):
    _rolling(tw, factory, nodes, count=7)


def case_in_place(tw, factory, nodes):
    """generic_sched_test.go:315-407: ports do not change in place."""
    job = tw.job(_mock_job(factory))
    tw.allocs(_existing(job, nodes))
    tw.job(_replacement(job, factory))
    _, got, _ = tw.process(factory, job.id)
    assert not got["stop"] and len(got["inplace"]) == 10
    for a in tw.port.state.allocs_by_job(job.id):
        for r in a.task_resources.values():
            assert r.networks[0].reserved_ports[0] == 5000


def case_drain(tw, factory, nodes):
    """generic_sched_test.go:462-537: the drained node's ten move."""
    drain = nodes[0]
    tw.drain([drain.id])
    job = tw.job(_mock_job(factory))
    allocs = _existing(job, [drain])
    tw.allocs(allocs)
    _, got, _ = tw.process(factory, job.id, jst.EVAL_TRIGGER_NODE_UPDATE,
                           node_id=drain.id)
    assert len(got["stop"]) == 10 and len(got["place"]) == 10
    assert all(a.node_id != drain.id for a in live(tw.port.state, job.id))


def case_retry_limit(tw, factory, nodes):
    """generic_sched_test.go:539-583: every plan refused, the eval fails."""
    job = tw.job(_mock_job(factory))
    tw.process(factory, job.id)
    assert tw.port.evals[-1].status == jst.EVAL_STATUS_FAILED
    assert tw.port.state.allocs_by_job(job.id) == []


GENERIC_CASES = {
    "modify": case_modify,
    "rolling": case_rolling,
    "rolling_count_up": case_rolling_count_up,
    "rolling_count_down": case_rolling_count_down,
    "in_place": case_in_place,
    "drain": case_drain,
    "retry_limit": case_retry_limit,
}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("n_nodes", [10, 64, 256])
@pytest.mark.parametrize("factory", ["tpu-service", "tpu-batch"])
@pytest.mark.parametrize("case", sorted(GENERIC_CASES))
def test_generic_update_case_matches_jax(case, factory, n_nodes, seed,
                                         monkeypatch):
    tw = Twin(monkeypatch, seed,
              planner="reject" if case == "retry_limit" else None)
    nodes = [jmock.node() for _ in range(n_nodes + (case == "drain"))]
    tw.nodes(nodes)
    GENERIC_CASES[case](tw, factory, nodes)


# -- 2. update kinds on the mixed cluster ------------------------------------

JOBS = {
    # object path, the greedy scan
    "service20": (jst.JOB_TYPE_SERVICE, 20, "tpu-service"),
    # columnar blocks, the water-fill
    "batch300": (jst.JOB_TYPE_BATCH, 300, "tpu-batch"),
    # object path, the water-fill
    "service150": (jst.JOB_TYPE_SERVICE, 150, "tpu-service"),
}


def _cpu_bump(job):
    job.task_groups[0].tasks[0].resources.cpu += 7


def _env(job):
    job.task_groups[0].tasks[0].env = {"V": "2"}


def _evict(job):
    # too big to grow in place on the fullest nodes
    job.task_groups[0].tasks[0].resources.cpu *= 6


def _rolling_env(count_delta):
    def mutate(job):
        tg = job.task_groups[0]
        pkg = pst if isinstance(job, pst.Job) else jst
        job.update = pkg.UpdateStrategy(stagger=5.0,
                                        max_parallel=max(5, tg.count // 4))
        tg.tasks[0].env = {"V": "3"}
        tg.count += count_delta
    return mutate


UPDATES = {
    "cpu_bump": _cpu_bump,
    "env": _env,
    "evict": _evict,
    "rolling": _rolling_env(0),
    "rolling_count": _rolling_env(6),
}


@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("n_nodes", [64, 256])
@pytest.mark.parametrize("update", sorted(UPDATES) + ["drain6"])
@pytest.mark.parametrize("job_name", sorted(JOBS))
def test_update_kind_on_mixed_cluster_matches_jax(job_name, update, n_nodes,
                                                  seed, monkeypatch):
    typ, count, factory = JOBS[job_name]
    tw = Twin(monkeypatch, seed)
    tw.nodes(random_cluster(seed, n_nodes))
    job = tw.job(make_job(job_name, typ, count))
    _, got, _ = tw.process(factory, job.id)
    assert len(got["place"]) + got["failed"] == count
    if update == "drain6":
        held = sorted({a.node_id for a in live(tw.jax.state, job.id)})
        drained = held[:6]
        tw.drain(drained)
        tw.process(factory, job.id, jst.EVAL_TRIGGER_NODE_UPDATE,
                   node_id=drained[0])
        assert not any(a.node_id in drained
                       for a in live(tw.port.state, job.id))
    else:
        tw.update_job(job.id, UPDATES[update])
        _, got, created = tw.process(factory, job.id)
        if update == "cpu_bump":
            assert got["inplace"] and not got["stop"]
        if update.startswith("rolling"):
            assert created and created[0].wait == 5.0
            tw.roll(factory, job.id)
    check_fits(tw.port.state, tw.node_ids)


# -- 3. network asks ---------------------------------------------------------


def _port_job(name, typ, count, reserved):
    job = make_job(name, typ, count, cpu=100, mem=128)
    task = job.task_groups[0].tasks[0]
    task.resources.networks = [jst.NetworkResource(
        mbits=10, dynamic_ports=["http", "https"],
        reserved_ports=[8080] if reserved else [])]
    return job


def _assert_ports_distinct(state, node_ids, reserved):
    for nid in node_ids:
        seen = set()
        for a in state.allocs_by_node(nid):
            if a.desired_status != RUN:
                continue
            for r in a.task_resources.values():
                for net in r.networks:
                    dyn = net.reserved_ports[len(net.reserved_ports)
                                             - len(net.dynamic_ports):]
                    assert len(dyn) == 2 and not set(dyn) & {22, 8080}
                    for p in net.reserved_ports:
                        key = (net.ip, p)
                        assert key not in seen, (nid, key)
                        seen.add(key)
                    assert (8080 in net.reserved_ports) == reserved


@pytest.mark.parametrize("seed", [7, 11, 13])
@pytest.mark.parametrize("reserved", [False, True])
@pytest.mark.parametrize("job_name", ["service20", "batch150"])
def test_port_asks_match_jax(job_name, reserved, seed, monkeypatch):
    """Two dynamic ports, with and without a reserved one, on mock nodes
    (one IP each): the same port numbers on both sides, distinct on each
    node, kept by an in-place update and drawn anew by a destructive one."""
    typ, factory = ((jst.JOB_TYPE_SERVICE, "tpu-service")
                    if job_name == "service20"
                    else (jst.JOB_TYPE_BATCH, "tpu-batch"))
    count = 20 if job_name == "service20" else 150
    tw = Twin(monkeypatch, seed)
    nodes = []
    for i in range(64):
        node = jmock.node()
        node.id = f"port-{seed}-{i:03d}"
        nodes.append(node)
    tw.nodes(nodes)
    job = tw.job(_port_job(job_name, typ, count, reserved))
    _, got, _ = tw.process(factory, job.id)
    # one reserved port a node: the reserved ask spreads one a node
    assert len(got["place"]) + got["failed"] == count
    _assert_ports_distinct(tw.port.state, tw.node_ids, reserved)
    before = {a.id: ports(a) for a in live(tw.port.state, job.id)}
    tw.update_job(job.id, _cpu_bump)
    tw.process(factory, job.id)
    after = {a.id: ports(a) for a in live(tw.port.state, job.id)}
    assert after == before
    tw.update_job(job.id, _env)
    tw.process(factory, job.id)
    _assert_ports_distinct(tw.port.state, tw.node_ids, reserved)


# -- 4. block-world in-place and rolling rounds ------------------------------

BATCH = 300


def _big_job(count=BATCH, cpu=100, mem=128):
    job = jmock.job()
    job.type = jst.JOB_TYPE_BATCH
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources = jst.Resources(cpu=cpu, memory_mb=mem)
    return job


def _block_cluster(tw, n):
    nodes = []
    for i in range(n):
        node = jmock.node()
        node.id = f"node-{i:03d}"
        nodes.append(node)
    tw.nodes(nodes)


def _blocks(state, job_id):
    return sorted((b.block_id, b.n, res(b.resources), b.job.modify_index)
                  for b in state.job_alloc_blocks(job_id))


def block_in_place(tw):
    job = tw.job(_big_job())
    tw.process("tpu-batch", job.id)
    assert not tw.port.state.job_has_object_allocs(job.id)
    before = {b[0] for b in _blocks(tw.port.state, job.id)}
    tw.update_job(job.id, _cpu_bump)
    plans, got, _ = tw.process("tpu-batch", job.id)
    assert plans[-1].update_batches[0].src_node_ids
    assert not got["place"] and not got["stop"]
    after = _blocks(tw.port.state, job.id)
    assert {b[0] for b in after} == before
    assert all(b[2][0] == 107 for b in after)


def block_same_version(tw):
    job = tw.job(_big_job())
    tw.process("tpu-batch", job.id)
    n = len(tw.port.plans)
    tw.process("tpu-batch", job.id)
    assert len(tw.port.plans) == n


def block_overflow(tw):
    """300 x 64 MB fit on 4 nodes, 300 x 112 MB cannot: no unsound
    whole-block update is committed."""
    job = tw.job(_big_job(cpu=30, mem=64))
    tw.process("tpu-batch", job.id)

    def grow(j):
        j.task_groups[0].tasks[0].resources.memory_mb = 112
    tw.update_job(job.id, grow)
    plans, _, _ = tw.process("tpu-batch", job.id)
    for b in plans[-1].update_batches:
        assert not b.src_node_ids or b.n < BATCH
    check_fits(tw.port.state, tw.node_ids)


def block_tainted(tw):
    job = tw.job(_big_job())
    tw.process("tpu-batch", job.id)
    victim = tw.port.state.job_alloc_blocks(job.id)[0].node_ids[0]
    tw.drain([victim])
    tw.update_job(job.id, _cpu_bump)
    tw.process("tpu-batch", job.id)
    run = live(tw.port.state, job.id)
    assert len(run) == BATCH and all(a.node_id != victim for a in run)


def block_rolling(tw):
    """A destructive change to a rolling job: max_parallel block members a
    round, rolled to the end, no node overcommitted mid-roll."""
    job = _big_job()
    job.update = jst.UpdateStrategy(stagger=0.01, max_parallel=50)
    tw.job(job)
    tw.process("tpu-batch", job.id)
    tw.update_job(job.id, _env)
    _, got, created = tw.process("tpu-batch", job.id)
    assert len(got["stop"]) == 50 and len(created) == 1
    rounds = tw.roll("tpu-batch", job.id)
    assert rounds >= 2
    check_fits(tw.port.state, tw.node_ids)
    versions = {a.job.modify_index for a in live(tw.port.state, job.id)}
    assert versions == {tw.jobs[job.id][1].modify_index}
    assert len(live(tw.port.state, job.id)) == BATCH


BLOCK_CASES = {
    "in_place": (block_in_place, 10, "columnar"),
    "same_version": (block_same_version, 10, "columnar"),
    "overflow": (block_overflow, 4, "columnar"),
    "tainted": (block_tainted, 10, "columnar"),
    "rolling": (block_rolling, 10, "columnar"),
}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_world_matches_jax(case, seed, monkeypatch):
    fn, n_nodes, planner = BLOCK_CASES[case]
    tw = Twin(monkeypatch, seed, planner=planner)
    _block_cluster(tw, n_nodes)
    fn(tw)


@pytest.mark.parametrize("seed", [1, 2])
def test_inplace_distinct_identity_allocs_match_jax(seed, monkeypatch):
    """After a restore every alloc has its own Resources object: a tight
    in-place grow must still respect each node's headroom, alike."""
    tw = Twin(monkeypatch, seed)
    tw.nodes([jmock.node() for _ in range(4)])
    job = tw.job(_big_job(cpu=30, mem=64))
    tw.process("tpu-batch", job.id)
    for st in (tw.jax.state, tw.port.state):
        for a in st.allocs_by_job(job.id):
            a.resources = copy.deepcopy(a.resources)

    def grow(j):
        j.task_groups[0].tasks[0].resources.memory_mb = 100
    tw.update_job(job.id, grow)
    tw.process("tpu-batch", job.id)
    check_fits(tw.port.state, tw.node_ids)


# -- 5. the two block lifecycles ---------------------------------------------


def _world_view(state, job_id):
    run = live(state, job_id)
    per_node, usage = {}, {}
    for a in run:
        per_node[a.node_id] = per_node.get(a.node_id, 0) + 1
        vec = np.asarray(a.resources.as_vector(), dtype=np.int64)
        usage[a.node_id] = usage.get(a.node_id, 0) + vec
    return (len(run), per_node,
            {k: tuple(int(x) for x in v) for k, v in usage.items()},
            {a.job.modify_index for a in run})


@pytest.mark.parametrize("seed", range(4))
def test_block_vs_object_lifecycle_matches_jax(seed, monkeypatch):
    """test_fuzz_block_lifecycle.py's lifecycle: the port's columnar world
    equals nomad_tpu's columnar world decision for decision, and the
    port's object world gives the same totals, spread, usage and version
    as its columnar one; the live-object counter equals a scan."""
    rng = np.random.default_rng(31_000 + seed)
    n_nodes = int(rng.choice([6, 10, 16]))
    count = int(rng.choice([BATCH, BATCH + 50]))
    # the object world is built before the twin (a StateStore draws an
    # id) and draws from a stream of its own
    obj = PortHarness()
    obj.planner = ColumnarCommit(obj, p_evaluate_plan, columnar=False)
    obj_os = SeededOS(("object world", seed).__repr__())
    tw = Twin(monkeypatch, seed, planner="columnar")
    _block_cluster(tw, n_nodes)
    for nid in tw.node_ids:
        obj.state.upsert_node(obj.next_index(),
                              tw.port.state.node_by_id(nid).copy())

    job = _big_job(count, cpu=int(rng.integers(20, 40)),
                   mem=int(rng.integers(32, 64)))
    tw.job(job)

    def obj_round():
        pjob = copy.deepcopy(tw.jobs[job.id][1])
        obj.state.upsert_job(obj.next_index(), pjob)
        with monkeypatch.context() as m:
            m.setattr(pst, "os", obj_os)
            m.setattr(psolver, "_new_ids_seed", obj_os.ids_seed)
            obj.process("tpu-batch", pst.Evaluation(
                id=f"obj-{obj.next_index()}", priority=pjob.priority,
                type=pjob.type, triggered_by=jst.EVAL_TRIGGER_JOB_REGISTER,
                job_id=job.id), device="cpu")

    tw.process("tpu-batch", job.id)
    obj_round()
    for _ in range(int(rng.integers(1, 4))):
        op = rng.choice(["grow", "shrink_res", "scale_up", "env"])
        grow_mb = int(rng.integers(1, 16))
        shrink = int(rng.integers(1, 10))
        scale = int(rng.integers(1, 40))
        env = str(int(rng.integers(0, 1000)))

        def mutate(j):
            tg = j.task_groups[0]
            if op == "grow":
                tg.tasks[0].resources.memory_mb += grow_mb
            elif op == "shrink_res":
                tg.tasks[0].resources.cpu = max(
                    1, tg.tasks[0].resources.cpu - shrink)
            elif op == "scale_up":
                tg.count += scale
            else:
                tg.tasks[0].env = {"V": env}
        tw.update_job(job.id, mutate)
        tw.process("tpu-batch", job.id)
        obj_round()
        view = _world_view(tw.port.state, job.id)
        assert view == _world_view(tw.jax.state, job.id), (seed, op)
        obj_view = _world_view(obj.state, job.id)
        assert obj_view[:3] == view[:3], (seed, op)
        assert len(obj_view[3]) == len(view[3]) == 1, (seed, op)
        check_fits(tw.port.state, tw.node_ids)
        t = tw.port.state._t
        scan = {}
        for a in t.allocs.values():
            if not a.terminal_status():
                scan[a.job_id] = scan.get(a.job_id, 0) + 1
        assert scan == t.live_objs_by_job, (seed, op)


@pytest.mark.parametrize("seed", range(2))
def test_no_lost_wakeup_under_concurrent_bulk_commits(seed):
    """test_fuzz_block_lifecycle.py's watch stress on the port's store:
    watchers looping register -> re-check -> wait on random nodes while a
    writer commits columnar blocks all see the final index promptly."""
    from nomad_tpu_torch import mock as pmock
    from nomad_tpu_torch.state.store import item_alloc_node

    rng = np.random.default_rng(90_000 + seed)
    store = PortStore()
    nodes = [pmock.node() for _ in range(12)]
    for i, n in enumerate(nodes):
        store.upsert_node(i + 1, n)
    job = pmock.job()
    store.upsert_job(100, job)
    n_commits = 30
    final_index = 100 + n_commits
    errors, observed = [], []

    def watcher(widx):
        wrng = np.random.default_rng(90_000 + seed * 100 + widx)
        node = nodes[int(wrng.integers(0, len(nodes)))]
        deadline = time.monotonic() + 30.0
        last = 0
        while time.monotonic() < deadline:
            ticket = store.watch.register([item_alloc_node(node.id)])
            try:
                idx = store.snapshot().get_index("allocs")
                if idx >= final_index:
                    observed.append((widx, idx))
                    return
                if idx == last:
                    store.watch.wait(ticket, timeout=0.5)
                last = idx
            finally:
                store.watch.unregister(ticket)
        errors.append(f"watcher {widx} never saw index {final_index}")

    threads = [threading.Thread(target=watcher, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for c in range(n_commits):
        k = int(rng.integers(1, len(nodes) + 1))
        sel = rng.choice(len(nodes), size=k, replace=False)
        batch = pst.AllocBatch(
            eval_id=f"gen-{seed}-{c}", job=job,
            tg_name=job.task_groups[0].name,
            resources=pst.Resources(cpu=1, memory_mb=1),
            node_ids=[nodes[i].id for i in sel], node_counts=[1] * k,
            name_idx=list(range(k)),
            ids_hex="".join(pst.generate_uuid().replace("-", "")
                            for _ in range(k)))
        store.upsert_alloc_blocks(101 + c, [batch])
        time.sleep(0.002)
    for t in threads:
        t.join(35.0)
    assert not errors, errors
    assert len(observed) == 6


# -- 6. test_fuzz_differential.py's update families --------------------------


@pytest.mark.parametrize("seed", [0, 3, 6, 9])
def test_fuzz_rolling_update_matches_jax(seed, monkeypatch):
    """:310: a random cluster and job, then a resource bump (destructive on
    the network-bearing ones) or a count change, re-evaluated. The job is
    mutated in place, as there: the committed allocs hold it too."""
    rng = np.random.default_rng(30_000 + seed)
    n = int(rng.integers(2, 40))
    nodes = _random_cluster(rng, n)
    tw = Twin(monkeypatch, seed)
    tw.nodes(nodes)
    job = _random_job(rng)
    job.task_groups[0].count = min(job.task_groups[0].count, 60)
    tw.job(job)
    factory = f"tpu-{job.type}"
    tw.process(factory, job.id)
    bump = rng.random() < 0.5
    delta = int(rng.integers(-20, 21))

    def mutate(j):
        if bump:
            j.task_groups[0].tasks[0].resources.cpu += 17
        else:
            j.task_groups[0].count = max(1, j.task_groups[0].count + delta)
    tw.update_job(job.id, mutate, copy_job=False)
    tw.process(factory, job.id)
    check_fits(tw.port.state, tw.node_ids)


@pytest.mark.parametrize("seed", [0, 4, 8, 12])
def test_fuzz_ports_at_scale_match_jax(seed, monkeypatch):
    """:528: count 129-300 with reserved and dynamic port asks on a
    random cluster: the same offers, no (ip, port) reused on a node."""
    rng = np.random.default_rng(50_000 + seed)
    n = int(rng.integers(40, 140))
    count = int(rng.integers(129, 300))
    nodes = _random_cluster(rng, n)
    tw = Twin(monkeypatch, seed)
    tw.nodes(nodes)
    job = tw.job(_random_port_job(rng, count))
    _, got, _ = tw.process(f"tpu-{job.type}", job.id)
    assert len(got["place"]) + got["failed"] == count
    for nid in tw.node_ids:
        seen = set()
        for a in live(tw.port.state, job.id):
            if a.node_id != nid:
                continue
            for r in a.task_resources.values():
                for net in r.networks:
                    for p in net.reserved_ports:
                        assert (net.ip, p) not in seen, (nid, net.ip, p)
                        seen.add((net.ip, p))


@pytest.mark.parametrize("seed", [0, 2, 4, 6])
def test_fuzz_anti_affinity_matches_jax(seed, monkeypatch):
    """:705: count a multiple of the node count on identical roomy nodes;
    the penalty spreads both sides evenly to the same nodes, then a
    destructive update re-spreads the replacements."""
    rng = np.random.default_rng(90_000 + seed)
    n = int(rng.integers(3, 12))
    per_node = int(rng.integers(2, 5))
    jtype = str(rng.choice([jst.JOB_TYPE_SERVICE, jst.JOB_TYPE_BATCH]))
    tw = Twin(monkeypatch, seed)
    nodes = _roomy_nodes(n)
    tw.nodes(nodes)
    job = jst.Job(
        region="global", id=jst.generate_uuid(), name="fuzz-aff",
        type=jtype, priority=50, datacenters=["dc1"],
        task_groups=[jst.TaskGroup(
            name="tg", count=n * per_node,
            restart_policy=jst.RestartPolicy(attempts=1, interval=600.0,
                                             delay=5.0),
            tasks=[jst.Task(name="t", driver="exec",
                            resources=jst.Resources(cpu=100,
                                                    memory_mb=64))])])
    tw.job(job)
    factory = f"tpu-{jtype}"
    tw.process(factory, job.id)
    for state in (tw.jax.state, tw.port.state):
        counts = sorted(sum(1 for a in live(state, job.id)
                            if a.node_id == nd.id) for nd in nodes)
        assert counts[0] == counts[-1] == per_node
    h = type("H", (), {"state": tw.port.state})
    assert _collision_penalty(h, nodes, job) == _collision_penalty(
        type("H", (), {"state": tw.jax.state}), nodes, job)
    tw.update_job(job.id, _env)
    tw.process(factory, job.id)


def _identity_round(tw, factory, job_id):
    ids0 = sorted(a.id for a in live(tw.port.state, job_id))

    def bump1(j):
        j.task_groups[0].tasks[0].resources.cpu += 1
    tw.update_job(job_id, bump1)
    tw.process(factory, job_id)
    bumped = tw.jobs[job_id][1].modify_index
    ids1 = sorted(a.id for a in live(tw.port.state, job_id))
    mods = {a.job.modify_index for a in live(tw.port.state, job_id)}
    tw.update_job(job_id, _env)
    tw.process(factory, job_id)
    ids2 = sorted(a.id for a in live(tw.port.state, job_id))
    assert ids1 == ids0
    assert mods == {bumped}
    assert len(ids2) == len(ids0) and not set(ids2) & set(ids0)


@pytest.mark.parametrize("seed", [0, 3, 6, 9])
def test_fuzz_inplace_identity_matches_jax(seed, monkeypatch):
    """:834: place, a cpu+1 bump (every id kept), an env change (every id
    replaced); the object-diff path (count < 256)."""
    rng = np.random.default_rng(95_000 + seed)
    count = int(rng.integers(5, 40))
    tw = Twin(monkeypatch, seed)
    tw.nodes(_roomy_nodes(max(4, count // 2)))
    job = tw.job(_ident_job(rng, count))
    tw.process("tpu-service", job.id)
    assert len(live(tw.port.state, job.id)) == count
    _identity_round(tw, "tpu-service", job.id)


@pytest.mark.parametrize("seed", [1, 2])
def test_fuzz_inplace_identity_block_native_matches_jax(seed, monkeypatch):
    """:853: the same at columnar scale (count 300): whole-block field
    swaps keep the id column."""
    rng = np.random.default_rng(95_000 + seed)
    tw = Twin(monkeypatch, seed)
    tw.nodes(_roomy_nodes(150))
    job = tw.job(_ident_job(rng, 300))
    tw.process("tpu-service", job.id)
    assert len(live(tw.port.state, job.id)) == 300
    _identity_round(tw, "tpu-service", job.id)


def _ident_job(rng, count):
    return jst.Job(
        region="global", id=jst.generate_uuid(), name="fuzz-ident",
        type=jst.JOB_TYPE_SERVICE, priority=50, datacenters=["dc1"],
        task_groups=[jst.TaskGroup(
            name="web", count=count,
            restart_policy=jst.RestartPolicy(attempts=1, interval=600.0,
                                             delay=5.0),
            tasks=[jst.Task(name="t", driver="exec",
                            resources=jst.Resources(
                                cpu=int(rng.integers(50, 200)),
                                memory_mb=64))])])


# -- the seeding itself --------------------------------------------------------


def test_seeded_ids_differ_without_the_seed(monkeypatch):
    """Unseeded, the two sides' rolling evictions pick different allocs:
    what the seeding guards against is real."""
    tw = Twin(monkeypatch, 1)
    monkeypatch.setattr(pst, "os", os)
    tw.nodes([jmock.node() for _ in range(10)])
    job = tw.job(_mock_job("tpu-service"))
    with pytest.raises(AssertionError, match="differs|stores differ"):
        tw.process("tpu-service", job.id)


def test_seeded_streams_repeat():
    a, b = SeededOS(5), SeededOS(5)
    assert [a.urandom(16) for _ in range(3)] == [b.urandom(16)
                                                 for _ in range(3)]
    assert a.ids_seed() == b.ids_seed()
