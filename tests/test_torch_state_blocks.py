"""The port's stored columnar blocks under exclusion (state/blocks.py,
state/store.py ``_exclude_block_members``): a block half excluded is
re-packed into a block of its live members, never dissolved into object
rows, and the store reads exactly as the expansion of the blocks as they
were before any re-pack."""

import copy
import logging

import numpy as np
import pytest

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.scheduler import new_scheduler
from nomad_tpu_torch.server.plan_apply import evaluate_plan
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import (
    AllocBatch,
    Evaluation,
    Resources,
    UpdateStrategy,
    allocs_fit,
    generate_uuid,
)
from nomad_tpu_torch.tpu.solver import TPUGenericScheduler


def _store(n_nodes):
    store = StateStore()
    for i in range(n_nodes):
        node = mock.node()
        node.id = f"node-{i}"
        store.upsert_node(i + 1, node)
    job = mock.job()
    store.upsert_job(50, job)
    return store, job


def _batch(job, node_ids, counts, seed=None, eval_id="ev-1"):
    n = sum(counts)
    kw = ({"ids_seed": seed} if seed is not None else
          {"ids_hex": "".join(generate_uuid().replace("-", "")
                              for _ in range(n))})
    return AllocBatch(
        eval_id=eval_id, job=job, tg_name=job.task_groups[0].name,
        resources=Resources(cpu=100, memory_mb=128),
        node_ids=list(node_ids), node_counts=list(counts),
        name_idx=list(range(n)), **kw)


def _key(a):
    return (a.id, a.node_id, a.job_id, a.eval_id, a.name, a.task_group,
            a.desired_status, a.client_status, a.create_index,
            a.modify_index, a.job.modify_index if a.job else None)


def _running(store, alloc_id):
    upd = store.alloc_by_id(alloc_id).copy()
    upd.client_status = structs.ALLOC_CLIENT_STATUS_RUNNING
    return upd


def test_block_repacks_once_half_promoted():
    store, job = _store(3)
    batch = _batch(job, ["node-0", "node-1", "node-2"], [3, 2, 3])
    store.upsert_alloc_blocks(100, [batch])
    (orig,) = store.alloc_blocks()
    ids = [batch.alloc_id(i) for i in range(8)]
    node_of = {ids[i]: orig.node_of_pos(i) for i in range(8)}
    # Positions 0, 1, 3, 4: node-0's first two members and node-1's run.
    for k, i in enumerate((0, 3, 4, 1)):
        store.update_alloc_from_client(101 + k, _running(store, ids[i]))

    (blk,) = store.alloc_blocks()
    assert blk.block_id == orig.block_id and not blk.excluded
    assert blk.n == blk.n_live == 4
    assert blk.node_ids == ["node-0", "node-2"] and blk.node_counts == [1, 3]
    live = (2, 5, 6, 7)
    assert [blk.alloc_id(i) for i in range(4)] == [ids[i] for i in live]
    assert blk.name_idx.tolist() == list(live)
    assert [blk.node_of_pos(i) for i in range(4)] == [
        node_of[ids[i]] for i in live]
    assert blk.job is job and blk.eval_id == "ev-1"
    assert (blk.create_index, blk.modify_index) == (100, 100)
    assert store.alloc_count() == 8
    objects = store.allocs_objects()
    assert {a.id for a in objects} == {ids[i] for i in (0, 1, 3, 4)}
    assert all(a.client_status == structs.ALLOC_CLIENT_STATUS_RUNNING
               for a in objects)
    assert store.repack_books.repacks == 1
    assert store.repack_books.members == 4
    running = {a.id for a in store.allocs_by_job(job.id)
               if a.client_status == structs.ALLOC_CLIENT_STATUS_RUNNING}
    assert running == {ids[i] for i in (0, 1, 3, 4)}


def _stop(store, alloc_id, status=structs.ALLOC_DESIRED_STATUS_STOP):
    a = store.alloc_by_id(alloc_id).copy()
    a.desired_status = status
    return a


@pytest.mark.parametrize("how", ["stop", "evict", "delete", "client"])
def test_block_whose_last_live_member_is_excluded_leaves_no_block(how):
    store, job = _store(2)
    batch = _batch(job, ["node-0", "node-1"], [4, 3], seed=0xC0FFEE)
    store.upsert_alloc_blocks(100, [batch])
    ids = [batch.alloc_id(i) for i in range(7)]
    index = 100
    # One member a write: the block re-packs on the way (7 → 3 → 1).
    for alloc_id in ids:
        index += 1
        if how == "stop":
            store.upsert_allocs(index, [_stop(store, alloc_id)])
        elif how == "evict":
            store.upsert_allocs(index, [_stop(
                store, alloc_id, structs.ALLOC_DESIRED_STATUS_EVICT)])
        elif how == "delete":
            store.delete_eval(index, [], [alloc_id])
        else:
            store.update_alloc_from_client(index, _running(store, alloc_id))
    assert store.alloc_blocks() == []
    assert store.job_alloc_blocks(job.id) == []
    t = store._t
    assert job.id not in t.live.by_job and "ev-1" not in t.live.by_eval
    assert store.repack_books.repacks == 2
    assert store.repack_books.members == 3 + 1
    assert store.alloc_count() == (0 if how == "delete" else 7)
    assert {a.id for a in store.allocs_by_job(job.id)} == (
        set() if how == "delete" else set(ids))


def _layout(rng, n_nodes):
    """Random node runs, one a node as a solve gives them, empty runs
    included."""
    runs = int(rng.integers(3, n_nodes + 1))
    node_ids = [f"node-{int(i)}"
                for i in rng.permutation(n_nodes)[:runs]]
    counts = [int(rng.integers(0, 9)) for _ in range(runs)]
    counts[0] = max(counts[0], 1)
    return node_ids, counts


@pytest.mark.parametrize("seed", range(8))
def test_repacked_store_reads_as_the_expansion(seed):
    """Seeded random exclusion sequences over several blocks, applied to
    a block store and to an object store holding the blocks' expansion
    (as they were before any re-pack): every read agrees after each
    write."""
    rng = np.random.default_rng(4_200 + seed)
    n_nodes = 8
    blocks, job = _store(n_nodes)
    objs = StateStore()
    for node in blocks.nodes():
        objs.upsert_node(node.modify_index, node.copy())
    objs.upsert_job(50, job)
    batches = []
    for b in range(3):
        node_ids, counts = _layout(rng, n_nodes)
        seed_kw = int(rng.integers(1 << 62)) if b % 2 else None
        batches.append(_batch(job, node_ids, counts, seed=seed_kw,
                              eval_id=f"ev-{b}"))
    blocks.upsert_alloc_blocks(100, batches)
    expansion = [a for blk in blocks.alloc_blocks() for a in blk.materialize()]
    objs.upsert_allocs(100, [a.copy() for a in expansion])
    all_ids = [a.id for a in expansion]
    node_ids = sorted({a.node_id for a in expansion})
    live = list(all_ids)
    index = 100

    def check():
        assert (sorted(_key(a) for a in blocks.allocs_by_job(job.id))
                == sorted(_key(a) for a in objs.allocs_by_job(job.id)))
        for nid in node_ids:
            assert (sorted(_key(a) for a in blocks.allocs_by_node(nid))
                    == sorted(_key(a) for a in objs.allocs_by_node(nid)))
        for alloc_id in all_ids:
            a, b = blocks.alloc_by_id(alloc_id), objs.alloc_by_id(alloc_id)
            assert (a is None) == (b is None)
            assert a is None or _key(a) == _key(b)
        assert blocks.alloc_count() == objs.alloc_count()

    while live:
        index += 1
        k = int(rng.integers(1, max(2, len(live) // 3) + 1))
        pick = [live.pop(int(rng.integers(len(live))))
                for _ in range(min(k, len(live)))]
        op = rng.choice(["stop", "delete", "client"])
        for store in (blocks, objs):
            if op == "stop":
                store.upsert_allocs(index, [_stop(store, i) for i in pick])
            elif op == "delete":
                store.delete_eval(index, [], pick)
            else:
                store.update_allocs_from_client(
                    index, [_running(store, i) for i in pick])
        check()
    assert blocks.alloc_blocks() == []
    assert blocks.repack_books.repacks >= 1


# -- the live view of one block ------------------------------------------------


@pytest.mark.parametrize("deleted", [(), (1, 4)])
def test_a_node_named_in_two_runs_reads_whole(deleted):
    """Runs [a:2, b:1, a:3]: every per-node read of node a sees both of
    its runs, before and after deletes that hit each of them."""
    store, job = _store(2)
    batch = _batch(job, ["node-0", "node-1", "node-0"], [2, 1, 3])
    store.upsert_alloc_blocks(100, [batch])
    ids = [batch.alloc_id(i) for i in range(6)]
    if deleted:
        store.delete_eval(101, [], [ids[p] for p in deleted])
    (blk,) = store.alloc_blocks()
    live = [p for p in range(6) if p not in deleted]
    on_a = [ids[p] for p in live if p != 2]
    assert [a.id for a in blk.materialize_node("node-0")] == on_a
    assert [a.id for a in store.allocs_by_node("node-0")] == on_a
    assert [a.id for a in store.allocs_by_node("node-1")] == [ids[2]]
    assert blk.live_counts_map() == {"node-0": len(on_a), "node-1": 1}
    assert [blk.node_of_pos(p) for p in range(6)] == [
        "node-0", "node-0", "node-1", "node-0", "node-0", "node-0"]
    assert blk.live_positions() == live


def test_first_per_node_reads_from_many_threads_see_every_run():
    """A block's run layout is shared by its copies and by every snapshot
    that holds one, and read from scheduler, verify, client and HTTP
    threads at once: a thread that reads while another is building the
    per-node map still finds every node's run."""
    import sys
    import threading

    from nomad_tpu_torch.state.blocks import StoredAllocBlock

    _, job = _store(0)
    nodes = [f"node-{i}" for i in range(2_000)]
    batch = _batch(job, nodes, [1] * len(nodes), seed=77)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for trial in range(40):
            blk = StoredAllocBlock.from_batch(batch, 100)
            gate = threading.Barrier(4)
            got = []

            def read(nid):
                gate.wait()
                got.append(len(blk.materialize_node(nid)))

            threads = [threading.Thread(target=read, args=(nodes[-1 - k],))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert got == [1] * 4, trial
    finally:
        sys.setswitchinterval(interval)


def test_copies_over_one_set_of_columns_share_one_layout():
    """Copies made before any read of the block (an exclusion, an
    in-place update, a whole stop) hold the one run layout; a re-pack,
    over new columns, builds its own."""
    from nomad_tpu_torch.state.blocks import StoredAllocBlock

    _, job = _store(0)
    batch = _batch(job, ["node-0", "node-1", "node-0"], [2, 1, 3], seed=5)
    blk = StoredAllocBlock.from_batch(batch, 100)
    copies = [
        blk.with_update(job, None, None, None, "ev-2", 101),
        blk.stopped(range(6), structs.ALLOC_DESIRED_STATUS_STOP, "", 102),
        blk.with_excluded([0]),
    ]
    copies.append(copies[2].with_excluded([3]))
    assert all(c._runs() is blk._runs() for c in copies)
    assert copies[3].repacked()._runs() is not blk._runs()


def _views(blk):
    """Every live read of ``blk``, each beside the same read recounted
    from its expansion."""
    mat = blk.materialize()
    prefix = f"{blk.job.name}.{blk.tg_name}["
    by_node = {}
    for a in mat:
        by_node[a.node_id] = by_node.get(a.node_id, 0) + 1
    runs = list(blk.live_node_counts())
    nodes = set(blk.node_ids)
    return [
        (blk.n_live, len(mat)),
        ([blk.alloc_id(p) for p in blk.live_positions()],
         [a.id for a in mat]),
        ([f"{prefix}{i}]" for i in blk.live_name_idx().tolist()],
         [a.name for a in mat]),
        ([n for n, c in runs for _ in range(c)], [a.node_id for a in mat]),
        ({n: c for n, c in blk.live_counts_map().items() if c}, by_node),
        (list(blk.live_members()), [(a.id, a.node_id) for a in mat]),
        ([blk.node_of_pos(p) for p in blk.live_positions()],
         [a.node_id for a in mat]),
        ([blk.find(a.id) for a in mat], blk.live_positions()),
        ({n: [_key(a) for a in blk.materialize_node(n)] for n in nodes},
         {n: [_key(a) for a in mat if a.node_id == n] for n in nodes}),
        ([[a.id for a in blk.materialize_prefix(k)]
          for k in (0, 1, len(mat) // 2, len(mat))],
         [[a.id for a in mat[:k]] for k in (0, 1, len(mat) // 2, len(mat))]),
    ]


@pytest.mark.parametrize("seed", range(12))
def test_every_live_view_recounts_the_expansion(seed):
    """Seeded random blocks whose nodes repeat across runs, put through a
    random sequence of exclusions, re-packs, whole and part stops and
    in-place updates: after each step every live read of the block, and
    of its pickled copy, equals a plain recount of ``materialize()``, and
    the expansion is the members the steps left."""
    import pickle

    from nomad_tpu_torch.state.blocks import StoredAllocBlock

    rng = np.random.default_rng(9_100 + seed)
    _, job = _store(0)
    runs = int(rng.integers(3, 12))
    node_ids = [f"node-{int(rng.integers(4))}" for _ in range(runs)]
    counts = [int(rng.integers(0, 6)) for _ in range(runs)]
    counts[0] += 1
    batch = _batch(job, node_ids, counts,
                   seed=int(rng.integers(1 << 62)) if seed % 2 else None)
    blk = StoredAllocBlock.from_batch(batch, 100)
    model = [a.id for a in batch.materialize()]
    for step in range(8):
        assert [a.id for a in blk.materialize()] == model, step
        for copy_ in (blk, pickle.loads(pickle.dumps(blk))):
            for got, want in _views(copy_):
                assert got == want, (step, type(copy_).__name__)
        if not model:
            break
        op = rng.choice(["exclude", "exclude", "repack", "stop", "part",
                         "update"])
        if op in ("exclude", "part"):
            k = int(rng.integers(1, len(model) + 1))
            pick = set(rng.choice(len(model), size=k, replace=False).tolist())
            positions = [blk.find(model[i]) for i in sorted(pick)]
            if op == "exclude":
                blk = blk.with_excluded(positions)
                model = [m for i, m in enumerate(model) if i not in pick]
            else:
                blk = blk.stopped(positions, structs.ALLOC_DESIRED_STATUS_STOP,
                                  "", 101 + step)
                model = [m for i, m in enumerate(model) if i in pick]
        elif op == "repack":
            blk = blk.repacked()
        elif op == "stop":
            blk = blk.stopped([blk.find(m) for m in model],
                              structs.ALLOC_DESIRED_STATUS_STOP, "",
                              101 + step)
        else:
            job2 = copy.deepcopy(job)
            job2.modify_index += step + 1
            blk = blk.with_update(job2, None, None, None, f"ev-u{step}",
                                  101 + step)


# -- a rolling update through the scheduler, committed columnar ----------------


class _ColumnarPlanner:
    """Commits evaluated plans as the FSM does: block stop runs through
    stop_block_members, stops and object rows through upsert_allocs,
    blocks through upsert_alloc_blocks, in-place batches through
    apply_update_batches."""

    def __init__(self, state):
        self.state = state
        self.plans = []
        self.created = []
        self.index = 1000

    def submit_plan(self, plan):
        self.plans.append(plan)
        self.index += 1
        result = evaluate_plan(self.state.snapshot(), plan)
        result.alloc_index = self.index
        allocs = [a for lst in result.node_update.values() for a in lst]
        allocs += [a for lst in result.node_allocation.values() for a in lst]
        allocs += result.failed_allocs
        if result.block_stops:
            _stopped, copies = self.state.stop_block_members(
                self.index, result.block_stops)
            allocs = copies + allocs
        if allocs:
            self.state.upsert_allocs(self.index, allocs)
        if result.alloc_batches:
            self.state.upsert_alloc_blocks(self.index, result.alloc_batches)
        if result.update_batches:
            self.state.apply_update_batches(self.index,
                                            result.update_batches)
        return result, None

    def update_eval(self, ev):
        pass

    def create_eval(self, ev):
        self.created.append(ev)


def test_rolling_update_stays_block_wise_every_round(monkeypatch):
    """A destructive change to a 300-task rolling job, 50 a round: every
    round reconciles block-wise (no live object row, no whole-block
    materialization), evicts exactly max_parallel, overcommits no node,
    and the roll converges; the old block re-packs at 150 and at 50
    live members instead of dissolving."""
    state = StateStore()
    for i in range(10):
        node = mock.node()
        node.id = f"node-{i:03d}"
        state.upsert_node(i + 1, node)
    planner = _ColumnarPlanner(state)
    job = mock.job()
    job.type = structs.JOB_TYPE_BATCH
    tg = job.task_groups[0]
    tg.count = 300
    tg.tasks[0].resources = Resources(cpu=100, memory_mb=128)
    job.update = UpdateStrategy(stagger=0.01, max_parallel=50)
    state.upsert_job(500, job)

    def process(j):
        sched = new_scheduler("tpu-batch", state.snapshot(), planner,
                              logging.getLogger("test"), device="cpu")
        sched.process(Evaluation(
            id=generate_uuid(), priority=j.priority, type=j.type,
            triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER, job_id=j.id))

    process(job)
    assert sum(b.n for b in state.job_alloc_blocks(job.id)) == 300
    job2 = copy.deepcopy(job)
    job2.task_groups[0].tasks[0].env = {"V": "2"}
    state.upsert_job(501, job2)

    paths = []
    orig_reconcile = TPUGenericScheduler._block_reconcile

    def spy_reconcile(self):
        out = orig_reconcile(self)
        paths.append("block" if out is not None else "other")
        return out
    monkeypatch.setattr(TPUGenericScheduler, "_block_reconcile",
                        spy_reconcile)
    from nomad_tpu_torch.state import blocks as blocks_mod
    calls = {"full": 0}
    orig_mat = blocks_mod.StoredAllocBlock.materialize

    def spy_mat(self):
        calls["full"] += 1
        return orig_mat(self)

    def live_by_version():
        out = {}
        for a in state.allocs_by_job(job.id):
            if a.desired_status == structs.ALLOC_DESIRED_STATUS_RUN:
                v = a.job.modify_index
                out[v] = out.get(v, 0) + 1
        return out

    rounds = 0
    while live_by_version().get(job.modify_index, 0):
        assert rounds < 10, "still rolling"
        assert not state.job_has_object_allocs(job.id)
        calls["full"] = 0
        monkeypatch.setattr(blocks_mod.StoredAllocBlock, "materialize",
                            spy_mat)
        process(job2)
        monkeypatch.setattr(blocks_mod.StoredAllocBlock, "materialize",
                            orig_mat)
        rounds += 1
        assert calls["full"] == 0, rounds
        plan = planner.plans[-1]
        stops = (sum(len(v) for v in plan.node_update.values())
                 + sum(r.n for r in plan.block_stops))
        assert stops == 50, (rounds, stops)
        for node in state.nodes():
            run = [a for a in state.allocs_by_node(node.id)
                   if a.desired_status == structs.ALLOC_DESIRED_STATUS_RUN]
            assert allocs_fit(node, run)[0], (rounds, node.id)
    assert rounds == 6
    assert paths == ["block"] * rounds
    assert live_by_version() == {job2.modify_index: 300}
    assert not state.job_has_object_allocs(job.id)
    assert state.repack_books.repacks == 2
    assert state.repack_books.members == 150 + 50
