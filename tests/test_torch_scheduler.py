"""The port's scheduler slice (factory -> plan) against nomad_tpu's.

The same small cluster (half ``mock.node()``, half a random mix over two
datacenters and two kernels, resources from a few fixed shapes so scores
either tie exactly or are well separated) and the same jobs go through
nomad_tpu's tests/sched_harness.Harness with the ``tpu-*`` factories and
through ``nomad_tpu_torch.harness.Harness`` with ``device="cpu"``. The
placed node id -> count map, the failed count and the alloc names must be
equal. Also here: the coalescer's stacking, the import guard and the
device rule.
"""

import copy
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jax_mock
from nomad_tpu import structs as jst
from nomad_tpu.api.codec import to_dict
from nomad_tpu.scheduler import wait_for_device
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.harness import Harness
from nomad_tpu_torch.ops import coalesce

from sched_harness import Harness as JaxHarness

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = [(2000, 4096), (4000, 8192), (8000, 16384)]


@pytest.fixture(scope="module", autouse=True)
def _jax_device_path():
    """nomad_tpu's tpu-* factories fall back to its host oracle until the
    device probe succeeds; the comparison needs its device solver."""
    assert wait_for_device(timeout=120.0) is not None


def random_cluster(seed, n):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n):
        if i % 2 == 0:
            node = jax_mock.node()
            node.id = f"mock-{seed}-{i:04d}"
        else:
            cpu, mem = SHAPES[int(rng.integers(0, len(SHAPES)))]
            node = jst.Node(
                id=f"mix-{seed}-{i:04d}",
                datacenter=str(rng.choice(["dc1", "dc2"])),
                name=f"mix-{i}",
                attributes={
                    "kernel.name": str(rng.choice(["linux", "linux",
                                                   "darwin"])),
                    "driver.exec": "1",
                },
                resources=jst.Resources(cpu=cpu, memory_mb=mem,
                                        disk_mb=100 * 1024, iops=150),
                status=jst.NODE_STATUS_READY,
            )
        nodes.append(node)
    return nodes


def make_job(name, typ, count, groups=1, distinct=False, cpu=250, mem=256):
    job = jax_mock.job()
    job.id = f"job-{name}"
    job.name = name
    job.type = typ
    job.datacenters = ["dc1", "dc2"]
    if distinct:
        job.constraints.append(jst.Constraint(operand="distinct_hosts"))
    tg0 = job.task_groups[0]
    tg0.count = count
    task = tg0.tasks[0]
    task.resources = jst.Resources(cpu=cpu, memory_mb=mem)
    tgs = []
    for g in range(groups):
        tg = copy.deepcopy(tg0)
        tg.name = f"web{g}" if groups > 1 else "web"
        tgs.append(tg)
    job.task_groups = tgs
    return job


class Pair:
    """The two harnesses, fed identical nodes, jobs and evals."""

    def __init__(self, seed, n_nodes):
        self.jax = JaxHarness()
        self.port = Harness()
        for node in random_cluster(seed, n_nodes):
            idx = self.jax.next_index()
            assert self.port.next_index() == idx
            self.jax.state.upsert_node(idx, node)
            self.port.state.upsert_node(
                idx, structs_from_reference(to_dict(node), "Node"))

    def run(self, job, factory, eval_id):
        idx = self.jax.next_index()
        assert self.port.next_index() == idx
        self.jax.state.upsert_job(idx, job)
        self.port.state.upsert_job(
            idx, structs_from_reference(to_dict(job), "Job"))
        ev = dict(id=eval_id, priority=job.priority, type=job.type,
                  triggered_by=jst.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id)
        n_jax, n_port = len(self.jax.plans), len(self.port.plans)
        self.jax.process(factory, jst.Evaluation(**ev))
        self.port.process(factory, pst.Evaluation(**ev), device="cpu")
        return (self.jax.plans[n_jax:], self.port.plans[n_port:],
                self.jax.evals[-1].status, self.port.evals[-1].status)


def decisions(plans):
    """(node id -> placed count, failed count, sorted placed names)."""
    per_node, names, failed = {}, [], 0
    for plan in plans:
        placed = [a for allocs in plan.node_allocation.values()
                  for a in allocs]
        for b in plan.alloc_batches:
            placed.extend(b.materialize())
        for a in placed:
            per_node[a.node_id] = per_node.get(a.node_id, 0) + 1
            names.append(a.name)
        for a in plan.failed_allocs:
            failed += 1 + a.metrics.coalesced_failures
    return per_node, failed, sorted(names)


SCENARIOS = {
    # count 300: columnar AllocBatch path, the water-fill
    "batch300": [("batch300", jst.JOB_TYPE_BATCH, 300, {}, "tpu-batch")],
    # count 20: object path, the exact greedy scan
    "service20": [("service20", jst.JOB_TYPE_SERVICE, 20, {}, "tpu-service")],
    # the service eval's usage includes the batch job's stored blocks
    "batch300_then_service20": [
        ("b300", jst.JOB_TYPE_BATCH, 300, {}, "tpu-batch"),
        ("s20", jst.JOB_TYPE_SERVICE, 20, {}, "tpu-service"),
    ],
    # count 150 on the object path: the water-fill through solve_many_async
    "service150_two_groups": [
        ("s150", jst.JOB_TYPE_SERVICE, 150, {"groups": 2}, "tpu-service"),
    ],
    # distinct_hosts: one copy per node, the rest fail
    "batch300_distinct": [
        ("b300d", jst.JOB_TYPE_BATCH, 300, {"distinct": True}, "tpu-batch"),
    ],
    # asks that exhaust the cluster: failed allocs on both paths
    "over_capacity": [
        ("big", jst.JOB_TYPE_BATCH, 400, {"cpu": 1900, "mem": 3000},
         "tpu-batch"),
        ("svc", jst.JOB_TYPE_SERVICE, 40, {"cpu": 1900, "mem": 3000},
         "tpu-service"),
    ],
}


@pytest.mark.parametrize("n_nodes", [64, 256])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scheduler_decisions_match_jax(scenario, n_nodes):
    pair = Pair(seed=len(scenario) + n_nodes, n_nodes=n_nodes)
    for i, (name, typ, count, kw, factory) in enumerate(SCENARIOS[scenario]):
        job = make_job(name, typ, count, **kw)
        jplans, pplans, jstatus, pstatus = pair.run(
            job, factory, f"eval-{scenario}-{i}")
        assert jstatus == pstatus == jst.EVAL_STATUS_COMPLETE
        assert len(jplans) == len(pplans)
        ref = decisions(jplans)
        got = decisions(pplans)
        assert got[0] == ref[0], f"{scenario}/{name}: node -> count differs"
        assert got[1] == ref[1], f"{scenario}/{name}: failed count differs"
        assert got[2] == ref[2], f"{scenario}/{name}: alloc names differ"
        assert sum(got[0].values()) + got[1] == count * kw.get("groups", 1)


# -- the coalescer -----------------------------------------------------------


def _solve_rows(seed, n=64, b=3):
    from nomad_tpu_torch.tpu.mirror import NodeMirror

    rng = np.random.default_rng(seed)
    nodes = [structs_from_reference(to_dict(x), "Node")
             for x in random_cluster(seed, n)]
    mirror = NodeMirror(nodes, "cpu")
    rows = []
    for _ in range(b):
        used = (mirror.totals_np * rng.uniform(0, 0.6, (mirror.padded, 1))
                ).astype(np.int32)
        rows.append((
            mirror.total, mirror.sched_cap, torch.tensor(used),
            torch.zeros(mirror.padded, dtype=torch.int32),
            torch.zeros(mirror.padded, dtype=torch.int32), mirror.bw_avail,
            torch.zeros(mirror.padded, dtype=torch.int32),
            torch.tensor(mirror.base_mask),
            torch.tensor([100, 128, 0, 0], dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32),
        ))
    return rows


@pytest.mark.parametrize("kind", ["waterfill", "exact"])
def test_coalescer_stacks_a_burst_into_one_dispatch(kind):
    """An announced burst of 3 solves dispatches once (width 3, padded to
    4) and each member's result equals its lone solve."""
    rows = _solve_rows(21)
    # Exact entries stack only within one count bucket (here 32).
    counts = [300, 180, 250] if kind == "waterfill" else [20, 17, 25]
    solver = coalesce.CoalescingSolver()
    submit = solver.submit if kind == "waterfill" else solver.submit_exact
    lone = []
    for r, c in zip(rows, counts):
        lone.append(submit(*r, c, 10.0)())
    assert solver.dispatches == 3
    token = solver.hint_burst(3)
    results = [None] * 3

    def member(i):
        solver.burst_begin(token)
        results[i] = submit(*rows[i], counts[i], 10.0)()
        solver.burst_done()

    threads = [threading.Thread(target=member, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert solver.dispatches == 4 and solver.coalesced == 3
    for got, want in zip(results, lone):
        np.testing.assert_array_equal(got[0], want[0])
        if kind == "waterfill":
            assert got[1] == want[1]
        else:
            np.testing.assert_array_equal(got[1], want[1])


def test_coalescer_fault_reaches_fetch():
    """A failing dispatch fails its waiters' fetch(); nothing retries on
    another path."""
    rows = _solve_rows(4, b=1)
    bad = list(rows[0])
    bad[2] = bad[2].to(torch.int64)  # the wrapper refuses the dtype
    solver = coalesce.CoalescingSolver()
    fetch = solver.submit(*bad, 100, 10.0)
    with pytest.raises(RuntimeError) as info:
        fetch()
    assert isinstance(info.value.__cause__, TypeError)
    assert solver.quiesce(5.0)


# -- guards -------------------------------------------------------------------


# The server loop's, simcluster's, the head's, the client's, the
# observatories' and the solver mesh's modules, named so a walk that
# missed one still fails.
SERVER_LOOP_MODULES = [
    "nomad_tpu_torch.server.server", "nomad_tpu_torch.server.worker",
    "nomad_tpu_torch.server.plan_pipeline", "nomad_tpu_torch.server.fsm",
    "nomad_tpu_torch.server.eval_broker", "nomad_tpu_torch.events",
    "nomad_tpu_torch.faults", "nomad_tpu_torch.backoff",
    "nomad_tpu_torch.simcluster.scenario",
    "nomad_tpu_torch.simcluster.simnode",
    "nomad_tpu_torch.simcluster.workload",
    "nomad_tpu_torch.simcluster.simload",
    "nomad_tpu_torch.scheduler.system", "nomad_tpu_torch.jobspec",
    "nomad_tpu_torch.api.client", "nomad_tpu_torch.api.http",
    "nomad_tpu_torch.agent", "nomad_tpu_torch.agent_config",
    "nomad_tpu_torch.logbuf", "nomad_tpu_torch.cli",
    "nomad_tpu_torch.__main__", "nomad_tpu_torch.discover",
    "nomad_tpu_torch.client", "nomad_tpu_torch.client.client",
    "nomad_tpu_torch.client.servers", "nomad_tpu_torch.client.fingerprint",
    "nomad_tpu_torch.client.alloc_runner",
    "nomad_tpu_torch.client.task_runner",
    "nomad_tpu_torch.client.driver.spawn",
    "nomad_tpu_torch.client.driver.raw_exec",
    "nomad_tpu_torch.client.driver.docker",
    "nomad_tpu_torch.capacity", "nomad_tpu_torch.raft_observe",
    "nomad_tpu_torch.simcluster.chaos", "nomad_tpu_torch.telemetry",
    "nomad_tpu_torch.profile_observe", "nomad_tpu_torch.bundle",
    "nomad_tpu_torch.parallel", "nomad_tpu_torch.parallel.mesh",
    "nomad_tpu_torch.parallel.dcn", "nomad_tpu_torch.parallel.dcn_worker",
    "nomad_tpu_torch.tlsutil", "nomad_tpu_torch.scada",
    "nomad_tpu_torch.native",
]


def test_port_imports_without_jax_or_nomad_tpu():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['nomad_tpu'] = None\n"
        "import nomad_tpu_torch\n"
        f"for name in {SERVER_LOOP_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "for m in pkgutil.walk_packages(nomad_tpu_torch.__path__,"
        " 'nomad_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from nomad_tpu_torch import native, telemetry\n"
        "assert native.available()\n"
        "with telemetry.port_lock_watchdog() as wd:\n"
        "    assert telemetry.active_lock_watchdog() is wd\n"
        "assert not [m for m, v in sys.modules.items() if v is not None"
        " and m.split('.')[0] in ('jax', 'nomad_tpu')]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda():
    """Without ``device=`` every entry point targets the CUDA card, and
    raises where there is none instead of running on the CPU."""
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.convert import solve_inputs_from_numpy
    from nomad_tpu_torch.device import resolve_device
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.tpu.mirror import MirrorCache, NodeMirror

    h = Harness()
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        new_scheduler("tpu-batch", h.snapshot(), h)
    with pytest.raises(RuntimeError, match="CUDA"):
        new_scheduler("tpu-service", h.snapshot(), h)
    with pytest.raises(RuntimeError, match="CUDA"):
        new_scheduler("tpu-system", h.snapshot(), h)
    with pytest.raises(RuntimeError, match="CUDA"):
        Agent(AgentConfig(server_enabled=True, dev_mode=True, http_port=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        Agent(AgentConfig(server_enabled=True, http_port=0, rpc_port=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        Agent(AgentConfig.dev())
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_inputs_from_numpy({"total": np.zeros((8, 4))})
    with pytest.raises(RuntimeError, match="CUDA"):
        NodeMirror([])
    with pytest.raises(RuntimeError, match="CUDA"):
        MirrorCache().get(h.snapshot(), ["dc1"])
    # The host schedulers take no device and need none.
    assert new_scheduler("batch", h.snapshot(), h) is not None
    assert new_scheduler("system", h.snapshot(), h) is not None
