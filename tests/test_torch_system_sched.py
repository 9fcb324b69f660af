"""The port's system schedulers (``system`` and ``tpu-system``) against
nomad_tpu's, case for case of tests/test_system_sched.py.

Each case builds its nodes, jobs and existing allocations once with
nomad_tpu's ``mock`` and carries them to the port with ``to_dict`` /
``structs_from_reference``, so both harnesses hold the same ids. The same
eval then runs through nomad_tpu's factory and the port's (``device="cpu"``
for ``tpu-system``). Every assertion of the original case holds in both
packages, and the plans are equal: the same node ids, alloc names and
statuses placed and stopped, and the same failed allocs with the same
metrics (allocation time aside). Alloc ids are fresh uuids and are not
compared.

Tolerance: exact. A system placement is pinned to its node and decided by
the fit mask alone (integer capacity sums and the eligibility mask); no
score is compared, so no decision can fall inside the pow contract's
256-ulp band (ROADMAP, Queue 3). ``band_instances`` counts the decisions
that differ from a pure-integer fit check, and must be 0.
"""

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu import structs as jst
from nomad_tpu.api.codec import to_dict as jax_to_dict
from nomad_tpu.scheduler import wait_for_device
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.api.codec import to_dict as port_to_dict
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.harness import Harness as PortHarness
from nomad_tpu_torch.harness import RejectPlan as PortRejectPlan

from sched_harness import Harness as JaxHarness
from sched_harness import RejectPlan as JaxRejectPlan

torch.set_num_threads(2)

SYSTEM_FACTORIES = ["system", "tpu-system"]


@pytest.fixture(scope="module", autouse=True)
def _jax_device_path():
    """nomad_tpu's tpu-* factories fall back to its host oracle until the
    device probe succeeds; the comparison needs its tpu-system."""
    assert wait_for_device(timeout=120.0) is not None


def port(obj, cls):
    return structs_from_reference(jax_to_dict(obj), cls)


def flatten(node_map):
    return [a for allocs in node_map.values() for a in allocs]


class Pair:
    """nomad_tpu's harness and the port's, fed the same objects."""

    def __init__(self, reject=False):
        self.jax = JaxHarness()
        self.port = PortHarness()
        if reject:
            self.jax.planner = JaxRejectPlan(self.jax)
            self.port.planner = PortRejectPlan(self.port)

    def _index(self):
        idx = self.jax.next_index()
        assert self.port.next_index() == idx
        return idx

    def node(self, node):
        idx = self._index()
        self.jax.state.upsert_node(idx, node)
        self.port.state.upsert_node(idx, port(node, "Node"))

    def job(self, job):
        idx = self._index()
        self.jax.state.upsert_job(idx, job)
        self.port.state.upsert_job(idx, port(job, "Job"))

    def allocs(self, allocs):
        idx = self._index()
        self.jax.state.upsert_allocs(idx, allocs)
        self.port.state.upsert_allocs(
            idx, [port(a, "Allocation") for a in allocs])

    def process(self, factory, **ev):
        self.jax.process(factory, jst.Evaluation(**ev))
        self.port.process(factory, pst.Evaluation(**ev), device="cpu")


def _metrics(a, to_dict):
    m = to_dict(a.metrics) if a.metrics is not None else {}
    m.pop("allocation_time", None)
    return m


def plan_view(plans, to_dict):
    """What a plan decided, without alloc ids."""
    out = []
    for p in plans:
        placed = flatten(p.node_allocation)
        for b in p.alloc_batches:
            placed.extend(b.materialize())
        out.append((
            sorted((a.node_id, a.name, a.desired_status,
                    a.job.modify_index if a.job is not None else None)
                   for a in placed),
            sorted((a.node_id, a.name, a.desired_status)
                   for a in flatten(p.node_update)),
            sorted((a.name, a.task_group, a.desired_status,
                    repr(sorted(_metrics(a, to_dict).items())))
                   for a in p.failed_allocs),
        ))
    return out


def assert_same_plans(pair):
    assert (plan_view(pair.port.plans, port_to_dict)
            == plan_view(pair.jax.plans, jax_to_dict))
    assert ([(e.status, e.status_description) for e in pair.port.evals]
            == [(e.status, e.status_description) for e in pair.jax.evals])
    assert ([e.triggered_by for e in pair.port.create_evals]
            == [e.triggered_by for e in pair.jax.create_evals])


def _seed_nodes(pair, n=10):
    nodes = []
    for _ in range(n):
        node = jmock.node()
        nodes.append(node)
        pair.node(node)
    return nodes


def _alloc_on(job, node_id, name="my-job.web[0]"):
    alloc = jmock.alloc()
    alloc.job = job
    alloc.job_id = job.id
    alloc.node_id = node_id
    alloc.name = name
    return alloc


def _register_eval(job, **kw):
    ev = dict(id=jst.generate_uuid(), priority=job.priority,
              triggered_by=jst.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id)
    ev.update(kw)
    return ev


def _both(pair):
    return ((pair.jax, jst), (pair.port, pst))


def _assert_eval_status(h, status):
    assert len(h.evals) == 1, f"bad evals: {h.evals}"
    assert h.evals[0].status == status, f"bad: {h.evals[0]}"


# -- the cases of tests/test_system_sched.py ---------------------------------


def case_register(pair, factory):
    _seed_nodes(pair)
    job = jmock.system_job()
    pair.job(job)
    pair.process(factory, **_register_eval(job))
    for h, S in _both(pair):
        assert len(h.plans) == 1
        assert len(flatten(h.plans[0].node_allocation)) == 10
        assert len(h.state.allocs_by_job(job.id)) == 10
        _assert_eval_status(h, S.EVAL_STATUS_COMPLETE)


def case_register_add_node(pair, factory):
    nodes = _seed_nodes(pair)
    job = jmock.system_job()
    pair.job(job)
    pair.allocs([_alloc_on(job, node.id) for node in nodes])
    new_node = jmock.node()
    pair.node(new_node)
    pair.process(factory, id=jst.generate_uuid(), priority=50,
                 triggered_by=jst.EVAL_TRIGGER_NODE_UPDATE, job_id=job.id)
    for h, S in _both(pair):
        assert len(h.plans) == 1
        plan = h.plans[0]
        assert flatten(plan.node_update) == []
        assert len(flatten(plan.node_allocation)) == 1
        assert new_node.id in plan.node_allocation
        out = S.filter_terminal_allocs(h.state.allocs_by_job(job.id))
        assert len(out) == 11
        _assert_eval_status(h, S.EVAL_STATUS_COMPLETE)


def case_register_alloc_fail(pair, factory):
    """No nodes is a no-op."""
    job = jmock.system_job()
    pair.job(job)
    pair.process(factory, **_register_eval(job))
    for h, S in _both(pair):
        assert h.plans == []
        _assert_eval_status(h, S.EVAL_STATUS_COMPLETE)


def case_modify(pair, factory):
    nodes = _seed_nodes(pair)
    job = jmock.system_job()
    pair.job(job)
    allocs = [_alloc_on(job, node.id) for node in nodes]
    pair.allocs(allocs)
    terminal = []
    for i in range(5):
        alloc = _alloc_on(job, nodes[i].id)
        alloc.desired_status = jst.ALLOC_DESIRED_STATUS_FAILED
        terminal.append(alloc)
    pair.allocs(terminal)
    job2 = jmock.system_job()
    job2.id = job.id
    job2.task_groups[0].tasks[0].config["command"] = "/bin/other"
    pair.job(job2)
    pair.process(factory, id=jst.generate_uuid(), priority=50,
                 triggered_by=jst.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id)
    for h, S in _both(pair):
        assert len(h.plans) == 1
        plan = h.plans[0]
        assert len(flatten(plan.node_update)) == len(allocs)
        assert len(flatten(plan.node_allocation)) == 10
        out = S.filter_terminal_allocs(h.state.allocs_by_job(job.id))
        assert len(out) == 10
        _assert_eval_status(h, S.EVAL_STATUS_COMPLETE)


def case_modify_rolling(pair, factory):
    nodes = _seed_nodes(pair)
    job = jmock.system_job()
    pair.job(job)
    pair.allocs([_alloc_on(job, node.id) for node in nodes])
    job2 = jmock.system_job()
    job2.id = job.id
    job2.update = jst.UpdateStrategy(stagger=30.0, max_parallel=5)
    job2.task_groups[0].tasks[0].config["command"] = "/bin/other"
    pair.job(job2)
    pair.process(factory, id=jst.generate_uuid(), priority=50,
                 triggered_by=jst.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id)
    for h, S in _both(pair):
        assert len(h.plans) == 1
        plan = h.plans[0]
        assert len(flatten(plan.node_update)) == 5
        assert len(flatten(plan.node_allocation)) == 5
        _assert_eval_status(h, S.EVAL_STATUS_COMPLETE)
        ev_update = h.evals[0]
        create = h.create_evals[0]
        assert ev_update.next_eval == create.id
        assert create.previous_eval == ev_update.id
        assert create.triggered_by == S.EVAL_TRIGGER_ROLLING_UPDATE


def case_modify_in_place(pair, factory):
    nodes = _seed_nodes(pair)
    job = jmock.system_job()
    pair.job(job)
    pair.allocs([_alloc_on(job, node.id) for node in nodes])
    job2 = jmock.system_job()
    job2.id = job.id
    pair.job(job2)
    pair.process(factory, id=jst.generate_uuid(), priority=50,
                 triggered_by=jst.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id)
    for h, S in _both(pair):
        assert len(h.plans) == 1
        plan = h.plans[0]
        assert flatten(plan.node_update) == []
        planned = flatten(plan.node_allocation)
        assert len(planned) == 10
        modify_index = h.state.job_by_id(job.id).modify_index
        assert all(p.job.modify_index == modify_index for p in planned)
        out = h.state.allocs_by_job(job.id)
        assert len(out) == 10
        _assert_eval_status(h, S.EVAL_STATUS_COMPLETE)
        for alloc in out:
            for resources in alloc.task_resources.values():
                assert resources.networks[0].reserved_ports[0] == 5000


def case_deregister(pair, factory):
    nodes = _seed_nodes(pair)
    job = jmock.system_job()
    pair.allocs([_alloc_on(job, node.id) for node in nodes])
    pair.process(factory, id=jst.generate_uuid(), priority=50,
                 triggered_by=jst.EVAL_TRIGGER_JOB_DEREGISTER, job_id=job.id)
    for h, S in _both(pair):
        assert len(h.plans) == 1
        for node in nodes:
            assert len(h.plans[0].node_update[node.id]) == 1
        out = S.filter_terminal_allocs(h.state.allocs_by_job(job.id))
        assert out == []
        _assert_eval_status(h, S.EVAL_STATUS_COMPLETE)


def case_node_drain(pair, factory):
    node = jmock.node()
    node.drain = True
    pair.node(node)
    job = jmock.system_job()
    pair.job(job)
    pair.allocs([_alloc_on(job, node.id)])
    pair.process(factory, id=jst.generate_uuid(), priority=50,
                 triggered_by=jst.EVAL_TRIGGER_NODE_UPDATE, job_id=job.id,
                 node_id=node.id)
    for h, S in _both(pair):
        assert len(h.plans) == 1
        plan = h.plans[0]
        assert len(plan.node_update[node.id]) == 1
        planned = flatten(plan.node_update)
        assert len(planned) == 1
        assert planned[0].desired_status == S.ALLOC_DESIRED_STATUS_STOP
        _assert_eval_status(h, S.EVAL_STATUS_COMPLETE)


def case_retry_limit(pair, factory):
    _seed_nodes(pair)
    job = jmock.system_job()
    pair.job(job)
    pair.process(factory, **_register_eval(job))
    for h, S in _both(pair):
        assert len(h.plans) > 0
        assert h.state.allocs_by_job(job.id) == []
        _assert_eval_status(h, S.EVAL_STATUS_FAILED)


CASES = {
    "register": (case_register, False),
    "register_add_node": (case_register_add_node, False),
    "register_alloc_fail": (case_register_alloc_fail, False),
    "modify": (case_modify, False),
    "modify_rolling": (case_modify_rolling, False),
    "modify_in_place": (case_modify_in_place, False),
    "deregister": (case_deregister, False),
    "node_drain": (case_node_drain, False),
    "retry_limit": (case_retry_limit, True),
}


@pytest.mark.parametrize("factory", SYSTEM_FACTORIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_system_case_matches_jax(case, factory):
    fn, reject = CASES[case]
    pair = Pair(reject=reject)
    fn(pair, factory)
    assert_same_plans(pair)


# -- the columnar path ------------------------------------------------------


def _columnar_pair(n, small=0, ask=(100, 64)):
    pair = Pair()
    for i in range(n):
        node = jmock.node()
        node.id = f"sys-{i:03d}"
        if i < small:  # too small for the ask
            node.resources = jst.Resources(cpu=50, memory_mb=32)
        pair.node(node)
    job = jmock.system_job()
    for t in job.task_groups[0].tasks:
        t.resources = jst.Resources(cpu=ask[0], memory_mb=ask[1])
    pair.job(job)
    return pair, job


def _live(h, S, job_id):
    return [a for a in h.state.allocs_by_job(job_id)
            if a.desired_status == S.ALLOC_DESIRED_STATUS_RUN]


@pytest.mark.parametrize("factory", SYSTEM_FACTORIES)
def test_system_columnar_batch_path_matches_host(factory):
    """At or above BATCH_PLACE_THRESHOLD network-free nodes, tpu-system
    commits one AllocBatch of unit runs; both factories place one per
    node as nomad_tpu's do."""
    pair, job = _columnar_pair(80)
    pair.process(factory, **_register_eval(job, type=job.type))
    for h, S in _both(pair):
        live = _live(h, S, job.id)
        assert len(live) == 80
        assert len({a.node_id for a in live}) == 80
        assert all(a.name == f"{job.name}.{job.task_groups[0].name}[0]"
                   for a in live)
        if factory == "tpu-system":
            assert any(p.alloc_batches for p in h.plans)
    assert_same_plans(pair)


@pytest.mark.parametrize("factory", SYSTEM_FACTORIES)
def test_system_columnar_partial_fit_coalesces_failures(factory):
    """Some nodes cannot fit the task: the placements land on the fitting
    nodes and the failures coalesce into one failed alloc with the
    count, in both packages and both paths."""
    pair, job = _columnar_pair(70, small=20, ask=(500, 256))
    pair.process(factory, **_register_eval(job, type=job.type))
    for h, S in _both(pair):
        assert len(_live(h, S, job.id)) == 50
        failed = [a for p in h.plans for a in p.failed_allocs]
        assert len(failed) == 1
        assert failed[0].metrics.coalesced_failures == 19
    assert_same_plans(pair)


def test_system_columnar_node_update_takes_the_batch_path():
    """A second eval over a cluster that already runs the job: the diff
    places only on the new nodes (64 of them, so ``_place_system_batch``
    takes them columnar) and leaves the rest in place."""
    pair, job = _columnar_pair(80)
    pair.process("tpu-system", **_register_eval(job, type=job.type))
    for i in range(64):
        node = jmock.node()
        node.id = f"new-{i:03d}"
        pair.node(node)
    pair.process("tpu-system", id=jst.generate_uuid(), priority=50,
                 type=job.type, triggered_by=jst.EVAL_TRIGGER_NODE_UPDATE,
                 job_id=job.id)
    for h, S in _both(pair):
        assert len(_live(h, S, job.id)) == 144
        assert sum(b.n for b in h.plans[-1].alloc_batches) == 64
    assert_same_plans(pair)


def band_instances(h, job_id):
    """Placements whose decision differs from the pure-integer fit check
    (used + ask <= total on every dimension) over the harness's nodes."""
    live = {a.node_id for a in h.state.allocs_by_job(job_id)
            if a.desired_status == "run"}
    job = h.state.job_by_id(job_id)
    ask = np.array([job.task_groups[0].tasks[0].resources.cpu,
                    job.task_groups[0].tasks[0].resources.memory_mb])
    differ = 0
    for node in h.state.nodes():
        res = node.resources
        reserved = node.reserved
        used = ask + (np.array([reserved.cpu, reserved.memory_mb])
                      if reserved is not None else 0)
        fits = bool(np.all(used <= np.array([res.cpu, res.memory_mb])))
        differ += fits != (node.id in live)
    return differ


def test_system_decisions_need_no_score():
    pair, job = _columnar_pair(70, small=20, ask=(500, 256))
    pair.process("tpu-system", **_register_eval(job, type=job.type))
    assert band_instances(pair.port, job.id) == 0
    assert band_instances(pair.jax, job.id) == 0
