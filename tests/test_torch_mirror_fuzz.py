"""The mirror fuzz families of tests/test_fuzz_differential.py (section 5's
repadding boundary and log-horizon fallback, section 6's delta-maintained
usage) on the port's mirror, each run unsharded and on a 4-shard CPU
solve mesh.

The same node-table writes go to a nomad_tpu store and a port store
(test_torch_mirror.DualStore). A rolled port mirror must equal a fresh
port build, and nomad_tpu's mirror over the same writes, exactly -- every
array, mask and clean-usage tensor (the sharded ones read whole through
``cpu()``), with the same count of delta rolls and full rebuilds. On the
mesh every node tensor must also stay sharded through each roll. Usage:
``build_usage`` (the cached base rolled through the alloc change log plus
the plan's rows) must equal ``_build_usage_walk`` (the full proposed-alloc
walk) across alloc-table generations and random plans. All values are
integers or exact float32 copies of integers: equality is exact.
"""

import numpy as np
import pytest
import torch

from nomad_tpu import structs as jst
from nomad_tpu.state import store as jax_store_mod
from nomad_tpu.structs import Node, Resources
from nomad_tpu.tpu.mirror import MirrorCache as JaxMirrorCache
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.parallel import mesh as pmesh
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.util import ready_nodes_in_dcs
from nomad_tpu_torch.state import store as port_store_mod
from nomad_tpu_torch.structs import generate_uuid
from nomad_tpu_torch.tpu.mirror import MirrorCache, NodeMirror

from test_fuzz_differential import _mirror_mutate, _mirror_rand_node
from test_torch_mirror import DCS, DualStore, assert_mirrors_equal

torch.set_num_threads(2)

N_USAGE_SEEDS = 6
MESHES = ["unsharded", "mesh4"]


@pytest.fixture(params=MESHES)
def layout(request):
    """The mirror's layout: one tensor a buffer, or 4 CPU node shards."""
    if request.param == "mesh4":
        pmesh.configure_node_sharding(4, devices=["cpu"] * 4)
    try:
        yield request.param
    finally:
        pmesh.clear_node_sharding()


class _Whole:
    """A view of a port mirror whose node tensors read whole (so the
    shared comparison helper takes sharded mirrors as well)."""

    def __init__(self, m):
        self._m = m

    def __getattr__(self, name):
        v = getattr(self._m, name)
        if name in ("total", "sched_cap", "bw_avail"):
            return pmesh.whole(v)
        if name in ("device_mask", "clean_usage"):
            def call(*a, **kw):
                out = v(*a, **kw)
                if name == "device_mask":
                    return pmesh.whole(out[0]), out[1]
                return tuple(pmesh.whole(x) for x in out)
            return call
        return v


def assert_layout(m, layout):
    sharded = layout == "mesh4"
    for t in (m.total, m.sched_cap, m.bw_avail, *m.clean_usage(),
              m.device_mask(None, {"exec"}, None, None)[0]):
        assert isinstance(t, pmesh.ShardedTensor) == sharded
        if sharded:
            assert len(t.shards) == 4


def check(rolled, fresh, ref, where, layout):
    assert_layout(rolled, layout)
    assert_mirrors_equal(_Whole(rolled), _Whole(fresh), (where, "fresh"))
    assert_mirrors_equal(_Whole(rolled), ref, (where, "nomad_tpu"))


def test_mirror_delta_repadding_boundary(layout):
    """Appends inside the padding bucket roll; crossing the power-of-two
    boundary forces (and correctly executes) a full rebuild."""
    def mk(i):
        return Node(
            id=f"pad-{i:03d}", datacenter="dc1", name=f"pad-{i}",
            attributes={"kernel.name": "linux", "driver.exec": "1"},
            resources=Resources(cpu=1000, memory_mb=1024),
            status=jst.NODE_STATUS_READY,
        )

    store = DualStore()
    idx = 0
    for i in range(63):
        idx += 1
        store.upsert_node(idx, mk(i))
    cache, jcache = MirrorCache(), JaxMirrorCache()
    _n, m0 = cache.get(store.port.snapshot(), ["dc1"], "cpu")
    assert m0.padded == 64
    for i, want in ((63, 64), (64, 128)):
        idx += 1
        store.upsert_node(idx, mk(i))
        snap = store.port.snapshot()
        _n, m = cache.get(snap, ["dc1"], "cpu")
        _n, ref = jcache.get(store.jax.snapshot(), ["dc1"])
        assert m.padded == want
        check(m, NodeMirror(ready_nodes_in_dcs(snap, ["dc1"]), "cpu"), ref,
              str(i + 1), layout)
    # 63 -> 64 rolled inside the bucket; 64 -> 65 crossed to 128 and
    # rebuilt.
    assert cache.stats()["delta_rolls"] == 1
    assert cache.stats()["full_rebuilds"] == 2


def test_mirror_delta_log_horizon_fallback(layout, monkeypatch):
    """Writes past the bounded change log's horizon make
    node_changes_since return None and the cache fall back to one full
    rebuild -- never a wrong delta."""
    monkeypatch.setattr(port_store_mod, "NODE_LOG_HORIZON", 4)
    monkeypatch.setattr(jax_store_mod, "NODE_LOG_HORIZON", 4)
    store = DualStore()
    idx = 0
    for i in range(12):
        idx += 1
        store.upsert_node(idx, Node(
            id=f"hz-{i:03d}", datacenter="dc1", name=f"hz-{i}",
            attributes={"kernel.name": "linux"},
            resources=Resources(cpu=1000, memory_mb=1024),
            status=jst.NODE_STATUS_READY,
        ))
    cache, jcache = MirrorCache(), JaxMirrorCache()
    cache.get(store.port.snapshot(), ["dc1"], "cpu")
    base_index = store.port.get_index("nodes")
    for i in range(10):
        node = store.node_by_id(f"hz-{i % 12:03d}").copy()
        node.resources = node.resources.copy()
        node.resources.cpu += 1
        idx += 1
        store.upsert_node(idx, node)
    snap = store.port.snapshot()
    assert snap.node_changes_since(base_index) is None
    _n, rolled = cache.get(snap, ["dc1"], "cpu")
    _n, ref = jcache.get(store.jax.snapshot(), ["dc1"])
    check(rolled, NodeMirror(ready_nodes_in_dcs(snap, ["dc1"]), "cpu"), ref,
          "horizon", layout)
    stats = cache.stats()
    assert stats["delta_rolls"] == 0
    assert stats["full_rebuilds"] == 2, stats


def _usage(out):
    return [t.cpu().numpy() for t in out]


@pytest.mark.parametrize("seed", range(N_USAGE_SEEDS))
def test_usage_delta_matches_full_walk(seed, layout):
    """build_usage (the rolled base plus the plan's rows) equals the full
    proposed-alloc walk across alloc-table generations (object rows, some
    terminal; columnar blocks; a block member restamped onto another node)
    and random plans (placements, evictions of object rows and block
    members, stale ids), with node writes rolling the mirror between."""
    rng = np.random.default_rng(50_000 + seed)
    store = DualStore()
    pstore = store.port
    idx = 0
    n0 = int(rng.integers(8, 40))
    for i in range(n0):
        idx += 1
        store.upsert_node(idx, _mirror_rand_node(rng, i))
    cache = MirrorCache()
    cache.get(pstore.snapshot(), DCS, "cpu")

    tg = pst.TaskGroup(
        name="web", count=64,
        tasks=[pst.Task(name="t", driver="exec",
                        resources=pst.Resources(cpu=50, memory_mb=64))],
    )
    job, other_job = (
        pst.Job(region="global", id=f"{p}-{seed}", name=f"{p}-{seed}",
                type=pst.JOB_TYPE_SERVICE, priority=50, datacenters=DCS,
                task_groups=[tg])
        for p in ("uj", "uo"))

    def rand_alloc(nid, j, serial, status=pst.ALLOC_DESIRED_STATUS_RUN):
        return pst.Allocation(
            id=generate_uuid(), eval_id=generate_uuid(),
            name=f"{j.name}.web[{serial}]", node_id=nid, job_id=j.id,
            job=j, task_group="web",
            resources=pst.Resources(cpu=int(rng.integers(10, 200)),
                                    memory_mb=int(rng.integers(16, 256))),
            desired_status=status,
        )

    object_allocs = []
    for generation in range(int(rng.integers(2, 5))):
        ids = [n.id for n in pstore.nodes()]
        new_allocs = []
        for s in range(int(rng.integers(1, 6))):
            j = job if rng.random() < 0.6 else other_job
            status = (pst.ALLOC_DESIRED_STATUS_RUN if rng.random() < 0.8
                      else pst.ALLOC_DESIRED_STATUS_STOP)
            new_allocs.append(rand_alloc(str(rng.choice(ids)), j, s, status))
        idx += 1
        pstore.upsert_allocs(idx, new_allocs)
        object_allocs.extend(new_allocs)
        if rng.random() < 0.6:
            j = job if rng.random() < 0.5 else other_job
            picks = [str(rng.choice(ids))
                     for _ in range(int(rng.integers(1, 4)))]
            counts = [int(rng.integers(1, 5)) for _ in picks]
            idx += 1
            pstore.upsert_alloc_blocks(idx, [pst.AllocBatch(
                eval_id=generate_uuid(), job=j, tg_name="web",
                resources=pst.Resources(cpu=20, memory_mb=32),
                task_resources={"t": pst.Resources(cpu=20, memory_mb=32)},
                metrics=None, node_ids=picks, node_counts=counts,
                name_idx=np.arange(sum(counts)),
                ids_seed=int(rng.integers(1, 2**63)),
            )])
        if rng.random() < 0.5:
            for blk in pstore.alloc_blocks():
                if blk.n_live:
                    member = blk.materialize_pos(blk.live_positions()[0])
                    member.node_id = str(rng.choice(ids))
                    member.resources = pst.Resources(
                        cpu=int(rng.integers(10, 100)), memory_mb=32)
                    idx += 1
                    pstore.upsert_allocs(idx, [member])
                    object_allocs.append(member)
                    break
        for _ in range(int(rng.integers(0, 3))):
            idx, n0 = _mirror_mutate(rng, store, idx, n0 + 1000)

        snap = pstore.snapshot()
        _n, rolled = cache.get(snap, DCS, "cpu")
        fresh = NodeMirror(ready_nodes_in_dcs(snap, DCS), "cpu")

        plan = pst.Plan(eval_id=generate_uuid())
        mirror_ids = [n.id for n in fresh.nodes]
        if mirror_ids:
            for s in range(int(rng.integers(0, 4))):
                nid = str(rng.choice(mirror_ids))
                plan.node_allocation.setdefault(nid, []).append(
                    rand_alloc(nid, job, 100 + s))
        live_objects = [a for a in object_allocs
                        if pstore.alloc_object_by_id(a.id) is not None]
        for a in (rng.choice(live_objects, size=min(2, len(live_objects)),
                             replace=False) if live_objects else []):
            plan.node_update.setdefault(a.node_id, []).append(a.copy())
        for blk in snap.alloc_blocks():
            if rng.random() < 0.4 and blk.n_live:
                member = blk.materialize_pos(blk.live_positions()[0])
                plan.node_update.setdefault(member.node_id, []).append(member)
                break
        if mirror_ids and rng.random() < 0.5:
            stale = rand_alloc(str(rng.choice(mirror_ids)), job, 999)
            plan.node_update.setdefault(stale.node_id, []).append(stale)

        ctx = EvalContext(snap, plan)
        got = rolled.build_usage(ctx, job.id, "web")
        want = fresh._build_usage_walk(ctx, job.id, "web")
        for t in (*got, *want):
            assert isinstance(t, pmesh.ShardedTensor) == (layout == "mesh4")
        for g, w, name in zip(_usage(got), _usage(want),
                              ("used", "job_count", "tg_count", "bw_used")):
            np.testing.assert_array_equal(
                g, w, err_msg=f"seed {seed} gen {generation}: {name}")
