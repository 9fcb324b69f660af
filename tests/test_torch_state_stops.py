"""Stops committed columnar (state/blocks.py ``StoppedAllocBlock``,
``StateStore.stop_block_members``, the FSM's ``alloc_update``): a stop
run of live block members becomes one stopped block, and the store reads
exactly as an object store holding every stop copy, while its live reads
never see a stopped member."""

import copy
import json
import logging

import numpy as np
import pytest

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.raft import log_codec
from nomad_tpu_torch.scheduler import new_scheduler
from nomad_tpu_torch.server.fsm import FSM
from nomad_tpu_torch.server.plan_apply import evaluate_plan
from nomad_tpu_torch.state.blocks import StoppedAllocBlock
from nomad_tpu_torch.structs import (
    AllocBatch,
    Evaluation,
    Resources,
    UpdateStrategy,
    expand_stop_runs,
    generate_uuid,
)

RUN = structs.ALLOC_DESIRED_STATUS_RUN
STOP = structs.ALLOC_DESIRED_STATUS_STOP
EVICT = structs.ALLOC_DESIRED_STATUS_EVICT
DESCRIPTIONS = ("alloc is being updated due to job update",
                "alloc not needed due to job update",
                "alloc is lost since its node is down")


def _key(a):
    res = a.resources.as_vector() if a.resources is not None else None
    return (a.id, a.node_id, a.job_id, a.eval_id, a.name, a.task_group,
            a.desired_status, a.desired_description, a.client_status,
            a.client_description, a.create_index, a.modify_index,
            a.job.modify_index if a.job is not None else None,
            None if res is None else tuple(res),
            tuple(sorted((k, tuple(v.as_vector()))
                         for k, v in (a.task_resources or {}).items())))


def _keys(allocs):
    return sorted(_key(a) for a in allocs)


def _fsms(n_nodes):
    """Two FSMs over the same nodes and job: one fed stops as id runs (the
    raft codec's form), one fed the stop copies as objects."""
    job = mock.job()
    nodes = []
    for i in range(n_nodes):
        node = mock.node()
        node.id = f"node-{i}"
        nodes.append(node)
    pair = (FSM(), FSM())
    for fsm in pair:
        for i, node in enumerate(nodes):
            fsm.apply(i + 1, "node_register", {"node": copy.deepcopy(node)})
        fsm.apply(50, "job_register", {"job": job})
    return pair, job


def _batch(job, rng, n_nodes, eval_id):
    runs = int(rng.integers(1, n_nodes + 1))
    node_ids = [f"node-{int(i)}" for i in rng.permutation(n_nodes)[:runs]]
    counts = [int(rng.integers(1, 7)) for _ in range(runs)]
    n = sum(counts)
    kw = ({"ids_seed": int(rng.integers(1 << 62))} if rng.integers(2) else
          {"ids_hex": "".join(generate_uuid().replace("-", "")
                              for _ in range(n))})
    tg = job.task_groups[0]
    return AllocBatch(
        eval_id=eval_id, job=job, tg_name=tg.name,
        resources=Resources(cpu=100, memory_mb=128),
        task_resources={t.name: t.resources for t in tg.tasks},
        node_ids=node_ids, node_counts=counts,
        name_idx=[int(i) for i in rng.permutation(n)], **kw)


def _check(cols, objs, job, all_ids, node_ids, eval_ids):
    c, o = cols.state, objs.state
    for alloc_id in all_ids:
        a, b = c.alloc_by_id(alloc_id), o.alloc_by_id(alloc_id)
        assert (a is None) == (b is None), alloc_id
        assert a is None or _key(a) == _key(b)
    assert _keys(c.allocs_by_job(job.id)) == _keys(o.allocs_by_job(job.id))
    assert _keys(c.allocs()) == _keys(o.allocs())
    for nid in node_ids:
        assert _keys(c.allocs_by_node(nid)) == _keys(o.allocs_by_node(nid))
    for ev in eval_ids:
        assert _keys(c.allocs_by_eval(ev)) == _keys(o.allocs_by_eval(ev))
    assert c.alloc_count() == o.alloc_count()
    assert c.has_allocs_for_job(job.id) == o.has_allocs_for_job(job.id)
    # The live reads: every member of a live block is a live allocation of
    # the object store, and together with the live object rows they are
    # all of its live allocations.
    for blocks in (c.alloc_blocks(), c.job_alloc_blocks(job.id)):
        members = [aid for blk in blocks for aid, _ in blk.live_members()]
        assert all(o.alloc_by_id(aid).desired_status == RUN
                   for aid in members)
        assert len(members) == sum(blk.n_live for blk in blocks)
        live_rows = {a.id for a in c.allocs_objects()
                     if not a.terminal_status()}
        assert set(members) | live_rows == {
            a.id for a in o.allocs() if not a.terminal_status()}
    assert not any(isinstance(blk, StoppedAllocBlock)
                   for blk in c.alloc_blocks() + c.job_alloc_blocks(job.id))


@pytest.mark.parametrize("seed", range(10))
def test_stopped_blocks_read_as_the_object_stores_expansion(seed):
    """Seeded random placements, stops and evictions (runs of mixed
    status and description, ids repeated, gone or already stopped),
    client updates, eval GC and deletions, applied by the FSM with stops
    as id runs and by one fed the stop copies: after every entry the reads
    by id, job, node and eval, the counts and the live reads agree."""
    rng = np.random.default_rng(23_000 + seed)
    n_nodes = 6
    (cols, objs), job = _fsms(n_nodes)
    all_ids, evals = [], []
    node_ids = [f"node-{i}" for i in range(n_nodes)]
    index = 100
    for step in range(40):
        index += 1
        op = ("place" if step < 2 else
              rng.choice(["place", "stop", "stop", "stop", "client", "gc",
                          "delete"]))
        if op == "place":
            ev = f"ev-{len(evals)}"
            evals.append(ev)
            batch = _batch(job, rng, n_nodes, ev)
            all_ids.extend(batch.alloc_id(i) for i in range(batch.n))
            cols.apply(index, "alloc_update", {"alloc_batches": [batch]})
            objs.apply(index, "alloc_update",
                       {"allocs": [a.copy() for a in batch.materialize()]})
        elif op == "stop":
            runs = []
            for _ in range(int(rng.integers(1, 4))):
                k = int(rng.integers(1, max(2, len(all_ids) // 4)))
                ids = [all_ids[int(i)]
                       for i in rng.integers(len(all_ids), size=k)]
                runs.append({"desired_status": str(rng.choice([STOP, EVICT])),
                             "desired_description": str(
                                 rng.choice(DESCRIPTIONS)),
                             "ids": ids})
            copies = expand_stop_runs(runs, objs.state.alloc_by_id)
            objs.apply(index, "alloc_update", {"allocs": copies})
            cols.apply(index, "alloc_update",
                       {"allocs_stopped": copy.deepcopy(runs)})
        elif op == "client":
            held = [i for i in all_ids if objs.state.alloc_by_id(i)]
            if not held:
                continue
            updates = []
            for i in rng.choice(len(held), size=min(len(held), 5),
                                replace=False):
                upd = objs.state.alloc_by_id(held[int(i)]).copy()
                upd.client_status = str(rng.choice(
                    ["running", "complete", "failed"]))
                upd.client_description = "reported"
                updates.append(upd)
            for fsm in (objs, cols):
                fsm.apply(index, "alloc_client_update",
                          {"allocs": [u.copy() for u in updates]})
        elif op == "gc":
            ev = str(rng.choice(evals))
            ids = [a.id for a in objs.state.allocs_by_eval(ev)]
            for fsm in (objs, cols):
                fsm.apply(index, "eval_delete",
                          {"evals": [ev], "allocs": list(ids)})
        else:
            ids = [all_ids[int(i)] for i in rng.integers(len(all_ids), size=4)]
            for fsm in (objs, cols):
                fsm.apply(index, "eval_delete", {"evals": [], "allocs": ids})
        _check(cols, objs, job, all_ids, node_ids, evals)
    books = cols.state.stop_books
    assert books.blocks >= 1 and books.members >= 1
    assert objs.state.stop_books.blocks == 0


def _placed(n_nodes=3, counts=(3, 2, 3)):
    (cols, _objs), job = _fsms(n_nodes)
    batch = AllocBatch(
        eval_id="ev-1", job=job, tg_name=job.task_groups[0].name,
        resources=Resources(cpu=100, memory_mb=128),
        node_ids=[f"node-{i}" for i in range(len(counts))],
        node_counts=list(counts), name_idx=list(range(sum(counts))),
        ids_seed=0xC0FFEE)
    cols.apply(100, "alloc_update", {"alloc_batches": [batch]})
    return cols, job, [batch.alloc_id(i) for i in range(batch.n)]


def _run(ids, status=STOP, desc=DESCRIPTIONS[0]):
    return {"desired_status": status, "desired_description": desc,
            "ids": list(ids)}


def test_a_whole_block_stop_keeps_its_columns_and_a_prefix_gathers():
    cols, job, ids = _placed()
    store = cols.state
    (src,) = store.alloc_blocks()
    cols.apply(101, "alloc_update", {"allocs_stopped": [_run(ids[:3])]})
    (prefix,) = store.stopped_alloc_blocks()
    assert prefix.node_ids == ["node-0"] and prefix.node_counts == [3]
    assert (prefix.create_index, prefix.modify_index) == (100, 101)
    assert prefix.block_id == ids[0]
    (live,) = store.alloc_blocks()
    cols.apply(102, "alloc_update", {"allocs_stopped": [
        _run(ids[3:], EVICT, DESCRIPTIONS[2])]})
    assert store.alloc_blocks() == [] and store.job_alloc_blocks(job.id) == []
    whole = [b for b in store.stopped_alloc_blocks() if b is not prefix]
    (whole,) = whole
    # The re-packed live block's columns, as they were.
    assert whole.node_ids is live.node_ids
    assert whole.name_idx is live.name_idx
    assert whole.desired_status == EVICT
    assert whole.desired_description == DESCRIPTIONS[2]
    assert [a.id for a in whole.materialize()] == ids[3:]
    assert store.alloc_count() == 8 and store.allocs_objects() == []
    assert src.n == 8
    books = store.stop_books
    assert (books.blocks, books.members, books.rows) == (2, 8, 0)


def test_a_client_update_promotes_a_stopped_member():
    cols, job, ids = _placed()
    store = cols.state
    cols.apply(101, "alloc_update", {"allocs_stopped": [_run(ids)]})
    upd = store.alloc_by_id(ids[4]).copy()
    upd.client_status = structs.ALLOC_CLIENT_STATUS_RUNNING
    cols.apply(102, "alloc_client_update", {"allocs": [upd]})
    (row,) = store.allocs_objects()
    assert row.id == ids[4] and row.terminal_status()
    assert row.client_status == structs.ALLOC_CLIENT_STATUS_RUNNING
    assert (row.create_index, row.modify_index) == (100, 102)
    assert row.desired_description == DESCRIPTIONS[0]
    assert not store.job_has_object_allocs(job.id)
    (blk,) = store.stopped_alloc_blocks()
    assert blk.n_live == 7 and blk.find(ids[4]) is None
    assert store.alloc_by_id(ids[4]) is row
    assert len(store.allocs_by_job(job.id)) == 8
    # A second stop of a stopped member takes the object path.
    cols.apply(103, "alloc_update", {"allocs_stopped": [
        _run(ids[:1], EVICT, DESCRIPTIONS[1])]})
    again = store.alloc_by_id(ids[0])
    assert store.allocs_objects() and again.desired_status == EVICT
    assert (again.create_index, again.modify_index) == (100, 103)
    assert store.stop_books.rows == 1
    assert store.stopped_alloc_blocks()[0].n_live == 6


def test_eval_gc_takes_stopped_blocks_and_members():
    cols, job, ids = _placed()
    store = cols.state
    cols.apply(101, "alloc_update", {"allocs_stopped": [_run(ids[:3])]})
    cols.apply(102, "eval_delete", {"evals": [], "allocs": [ids[0]]})
    (blk,) = store.stopped_alloc_blocks()
    assert blk.n_live == 2 and store.alloc_by_id(ids[0]) is None
    cols.apply(103, "eval_delete", {"evals": ["ev-1"], "allocs": []})
    assert store.stopped_alloc_blocks() == [] and store.alloc_blocks() == []
    assert store.allocs_by_job(job.id) == [] and store.alloc_count() == 0
    assert not store.has_allocs_for_job(job.id)
    assert store._t.stopped.by_job == {} and store._t.stopped.by_eval == {}


def test_a_snapshot_carries_stopped_blocks_only_where_there_are_any():
    import pickle

    cols, job, ids = _placed()
    assert "stopped_blocks" not in pickle.loads(cols.snapshot_bytes())
    cols.apply(101, "alloc_update", {"allocs_stopped": [_run(ids[2:6])]})
    data = cols.snapshot_bytes()
    assert len(pickle.loads(data)["stopped_blocks"]) == 1
    restored = FSM()
    restored.restore_bytes(data)
    assert restored.last_restore["stopped_blocks"] == 1
    assert (_keys(restored.state.allocs_by_job(job.id))
            == _keys(cols.state.allocs_by_job(job.id)))
    assert _keys(restored.state.allocs_by_node("node-1")) == _keys(
        cols.state.allocs_by_node("node-1"))


# -- a rolling update through the scheduler and the raft codec -----------------


class _FSMPlanner:
    """Commits evaluated plans as a raft replica does: one alloc_update
    entry a plan, through the log codec (stops as id runs) into the FSM."""

    def __init__(self, fsm):
        self.fsm = fsm
        self.plans = []
        self.index = 1000

    def submit_plan(self, plan):
        self.plans.append(plan)
        self.index += 1
        result = evaluate_plan(self.fsm.state.snapshot(), plan)
        result.alloc_index = self.index
        allocs = [a for lst in result.node_update.values() for a in lst]
        allocs += [a for lst in result.node_allocation.values() for a in lst]
        allocs += result.failed_allocs
        entry = json.loads(json.dumps(log_codec.encode_payload(
            "alloc_update", {"allocs": allocs,
                             "alloc_batches": result.alloc_batches,
                             "update_batches": result.update_batches})))
        self.fsm.apply(self.index, "alloc_update",
                       log_codec.decode_payload("alloc_update", entry))
        return result, None

    def update_eval(self, ev):
        pass

    def create_eval(self, ev):
        pass


def test_a_300_task_roll_stops_every_member_columnar():
    """A destructive change to a 300-task rolling job, 50 a round: each
    round's 50 stops commit as one stopped block, none as an object row,
    and the job reads as its 300 stop copies and 300 replacements."""
    fsm = FSM()
    state = fsm.state
    for i in range(10):
        node = mock.node()
        node.id = f"node-{i:03d}"
        fsm.apply(i + 1, "node_register", {"node": node})
    planner = _FSMPlanner(fsm)
    job = mock.job()
    job.type = structs.JOB_TYPE_BATCH
    tg = job.task_groups[0]
    tg.count = 300
    tg.tasks[0].resources = Resources(cpu=100, memory_mb=128)
    job.update = UpdateStrategy(stagger=0.01, max_parallel=50)
    fsm.apply(500, "job_register", {"job": job})

    def process(j):
        sched = new_scheduler("tpu-batch", state.snapshot(), planner,
                              logging.getLogger("test"), device="cpu")
        sched.process(Evaluation(
            id=generate_uuid(), priority=j.priority, type=j.type,
            triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER, job_id=j.id))

    process(job)
    job2 = copy.deepcopy(job)
    job2.task_groups[0].tasks[0].env = {"V": "2"}
    fsm.apply(501, "job_register", {"job": job2})
    rounds = 0
    while any(b.job.modify_index == job.modify_index
              for b in state.job_alloc_blocks(job.id)):
        assert rounds < 10, "still rolling"
        process(job2)
        rounds += 1
        assert not state.job_has_object_allocs(job.id)
    assert rounds == 6
    assert not [a for a in state.allocs_objects() if a.terminal_status()]
    books = state.stop_books
    assert (books.blocks, books.members, books.rows) == (6, 300, 0)
    allocs = state.allocs_by_job(job.id)
    stopped = [a for a in allocs if a.terminal_status()]
    assert len(stopped) == 300 and len(allocs) == 600
    assert {(a.desired_status, a.job.modify_index) for a in stopped} == {
        (STOP, job.modify_index)}
    assert all(a.desired_status == RUN for blk in state.alloc_blocks()
               for a in blk.materialize())
    assert sum(blk.n_live for blk in state.alloc_blocks()) == 300
