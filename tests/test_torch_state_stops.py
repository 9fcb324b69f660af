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
                             "block_stops": result.block_stops,
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


# -- stops carried through the plan as block stop runs ------------------------


def _block_roll(planner_cls=None, count=300, max_parallel=50):
    """A 300-task batch job placed as one block on 10 nodes (no reserved
    ports, as the benchmark's nodes, so plan verification takes its
    columnar path) and a destructive change to it registered: (fsm,
    planner, old job, new job, process)."""
    fsm = FSM()
    state = fsm.state
    for i in range(10):
        node = mock.node()
        node.id = f"node-{i:03d}"
        node.reserved.networks = []
        fsm.apply(i + 1, "node_register", {"node": node})
    planner = (planner_cls or _FSMPlanner)(fsm)
    job = mock.job()
    job.type = structs.JOB_TYPE_BATCH
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources = Resources(cpu=100, memory_mb=128)
    job.update = UpdateStrategy(stagger=0.01, max_parallel=max_parallel)
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
    return fsm, planner, job, job2, process


def test_each_round_of_a_block_roll_carries_its_stops_as_one_run(
        monkeypatch):
    """Every round's plan carries its 50 stops as one block stop run and
    no stop copy: node_update is empty, Plan.append_update is never
    called, and the run names exactly the members materialize_prefix
    gives, on the same nodes."""
    fsm, planner, job, _job2, process = _block_roll()
    state = fsm.state
    appended = []
    orig = structs.Plan.append_update

    def spy(self, alloc, status, desc):
        appended.append(alloc.id)
        return orig(self, alloc, status, desc)
    monkeypatch.setattr(structs.Plan, "append_update", spy)
    rounds = 0
    while any(b.job.modify_index == job.modify_index
              for b in state.job_alloc_blocks(job.id)):
        assert rounds < 10, "still rolling"
        n_plans = len(planner.plans)
        process(_job2)
        rounds += 1
        (plan,) = planner.plans[n_plans:]
        assert plan.node_update == {}, rounds
        (run,) = plan.block_stops
        assert run.n == 50 and sum(run.node_counts) == 50
        want = run.block.materialize_prefix(run.n)
        assert run.alloc_ids() == [a.id for a in want]
        assert [nid for _p, nid in run.members()] == [a.node_id
                                                      for a in want]
        assert _keys(run.materialize()) == _keys(
            [_stop_copy(a) for a in want])
    assert rounds == 6 and appended == []
    assert (state.stop_books.members, state.stop_books.rows) == (300, 0)


def _stop_copy(alloc, status=STOP, desc=DESCRIPTIONS[0]):
    copy_ = alloc.copy()
    copy_.desired_status = status
    copy_.desired_description = desc
    return copy_


def _placed_pair(counts=(3, 2, 3)):
    """Both FSMs of ``_fsms`` holding the same 8-member block; returns
    (runs FSM, copies FSM, job, the block's ids)."""
    (cols, objs), job = _fsms(len(counts))
    batch = AllocBatch(
        eval_id="ev-1", job=job, tg_name=job.task_groups[0].name,
        resources=Resources(cpu=100, memory_mb=128),
        node_ids=[f"node-{i}" for i in range(len(counts))],
        node_counts=list(counts), name_idx=list(range(sum(counts))),
        ids_seed=0xC0FFEE)
    for fsm in (cols, objs):
        fsm.apply(100, "alloc_update", {"alloc_batches": [AllocBatch(
            eval_id=batch.eval_id, job=job, tg_name=batch.tg_name,
            resources=batch.resources, node_ids=list(batch.node_ids),
            node_counts=list(batch.node_counts),
            name_idx=list(batch.name_idx), ids_seed=batch.ids_seed)]})
    return cols, objs, job, [batch.alloc_id(i) for i in range(batch.n)]


@pytest.mark.parametrize("bulk", [False, True])
def test_a_partial_commit_drops_a_failed_nodes_run_members(bulk):
    """A plan stopping the block's first 4 members (3 on node-0, 1 on
    node-1) and placing one member too large for node-0 even after its
    stops, and members that fit on node-1: node-0 commits neither its
    stops nor its placement, node-1 both, exactly as the same plan with
    stop copies does; both committed states agree."""
    from nomad_tpu_torch.server.plan_pipeline import apply_result_to_snapshot

    cols, objs, job, ids = _placed_pair()
    (blk,) = cols.state.alloc_blocks()
    run = blk.stop_prefix(4, STOP, DESCRIPTIONS[0])
    assert run.node_ids == ["node-0", "node-1"] and run.node_counts == [3, 1]
    tg = job.task_groups[0].name

    def placements():
        return [
            AllocBatch(eval_id="ev-2", job=job, tg_name=tg,
                       resources=Resources(cpu=3950, memory_mb=128),
                       node_ids=["node-0"], node_counts=[1], name_idx=[8],
                       ids_seed=0xAAAA),
            AllocBatch(eval_id="ev-2", job=job, tg_name=tg,
                       resources=Resources(cpu=10, memory_mb=16),
                       node_ids=["node-1"], node_counts=[64 if bulk else 1],
                       name_idx=list(range(9, 73 if bulk else 10)),
                       ids_seed=0xBBBB)]

    by_runs = structs.Plan(eval_id="ev-2", alloc_batches=placements())
    by_runs.append_block_stop(run)
    by_copies = structs.Plan(eval_id="ev-2", alloc_batches=placements())
    for a in run.materialize():
        by_copies.node_update.setdefault(a.node_id, []).append(a)

    got = evaluate_plan(cols.state.snapshot(), by_runs)
    want = evaluate_plan(objs.state.snapshot(), by_copies)
    assert got.refresh_index and want.refresh_index
    assert got.node_update == {}
    stopped = [i for r in got.block_stops for i in r.alloc_ids()]
    assert stopped == [a.id for v in want.node_update.values() for a in v]
    assert stopped == [ids[3]]
    assert ([b.node_ids for b in got.alloc_batches]
            == [b.node_ids for b in want.alloc_batches] == [["node-1"]])

    snap = cols.state.snapshot()
    apply_result_to_snapshot(snap, got, 101)
    assert {a.id for a in snap.allocs_by_job(job.id)
            if a.terminal_status()} == {ids[3]}
    cols.apply(101, "alloc_update", {
        "block_stops": got.block_stops, "allocs": [],
        "alloc_batches": got.alloc_batches})
    objs.apply(101, "alloc_update", {
        "allocs": [a for v in want.node_update.values() for a in v],
        "alloc_batches": want.alloc_batches})
    assert (_keys(cols.state.allocs_by_job(job.id))
            == _keys(objs.state.allocs_by_job(job.id)))
    assert _keys(snap.allocs_by_job(job.id)) == _keys(
        cols.state.allocs_by_job(job.id))


def test_a_run_member_stopped_before_the_apply_is_not_stopped_twice():
    """A run of the block's first 4 members, one of which another entry
    stops after the run was built: staging and verify give back the usage
    of the 3 still live, and the commit stops those columnar and the
    other once, as the same stops by id do."""
    from nomad_tpu_torch.scheduler.context import EvalContext
    from nomad_tpu_torch.scheduler.util import ready_nodes_in_dcs
    from nomad_tpu_torch.server.plan_apply import block_stop_credit
    from nomad_tpu_torch.tpu.mirror import NodeMirror

    cols, objs, job, ids = _placed_pair()
    (blk,) = cols.state.alloc_blocks()
    run = blk.stop_prefix(4, STOP, DESCRIPTIONS[0])
    for fsm in (cols, objs):
        fsm.apply(101, "alloc_update", {"allocs_stopped": [
            _run([ids[1]], STOP, DESCRIPTIONS[1])]})
    snap = cols.state.snapshot()
    assert run.live_counts(snap).tolist() == [2, 1]
    rows = {"node-0": 0, "node-1": 1}
    credit = block_stop_credit(snap, [run], 2, rows.get)
    assert credit.tolist() == [[200, 256, 0, 0], [100, 128, 0, 0]]

    by_runs = structs.Plan(eval_id="ev-3")
    by_runs.append_block_stop(run)
    by_copies = structs.Plan(eval_id="ev-3")
    for a in run.materialize():
        by_copies.node_update.setdefault(a.node_id, []).append(a)
    mirror = NodeMirror(ready_nodes_in_dcs(snap, job.datacenters), "cpu")
    for fn in (mirror.build_usage, mirror._build_usage_walk):
        got = fn(EvalContext(snap, by_runs), job.id, job.task_groups[0].name)
        want = fn(EvalContext(snap, by_copies), job.id,
                  job.task_groups[0].name)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())

    cols.apply(102, "alloc_update", {"block_stops": [run], "allocs": []})
    objs.apply(102, "alloc_update", {"allocs_stopped": [run.id_run()],
                                     "allocs": []})
    allocs = cols.state.allocs_by_job(job.id)
    assert len(allocs) == 8 and len({a.id for a in allocs}) == 8
    assert _keys(allocs) == _keys(objs.state.allocs_by_job(job.id))
    assert {a.id for a in allocs if a.terminal_status()} == set(ids[:4])
    assert cols.state.stop_books.members == 1 + 3


def test_a_plans_stop_map_is_built_once_and_follows_its_runs():
    """The plan's node -> stopped ids map is the runs' ids (each run's
    ``materialize()`` ids on each node), built once a plan and rebuilt
    after ``append_block_stop``; ``live_rows`` names the rows that still
    hold a live member, and none without a row."""
    cols, _objs, job, ids = _placed_pair()
    (blk,) = cols.state.alloc_blocks()
    plan = structs.Plan(eval_id="ev-3")
    assert plan.block_stop_ids() == {}
    plan.append_block_stop(blk.stop_prefix(4, STOP, DESCRIPTIONS[0]))
    first = plan.block_stop_ids()
    assert first == {"node-0": set(ids[:3]), "node-1": {ids[3]}}
    assert plan.block_stop_ids() is first
    plan.append_block_stop(blk.stop_run([6, 7], STOP, DESCRIPTIONS[0]))
    assert plan.block_stop_ids() == {"node-0": set(ids[:3]),
                                     "node-1": {ids[3]},
                                     "node-2": set(ids[6:8])}
    want = {}
    for run in plan.block_stops:
        for a in run.materialize():
            want.setdefault(a.node_id, set()).add(a.id)
    assert plan.block_stop_ids() == want

    cols.apply(101, "alloc_update", {"allocs_stopped": [
        _run(ids[:3], STOP, DESCRIPTIONS[1])]})
    rows, counts = plan.block_stops[0].live_rows(
        cols.state.snapshot(), {"node-0": 0, "node-1": 5}.get)
    assert rows.tolist() == [5] and counts.tolist() == [1]
    rows, counts = plan.block_stops[1].live_rows(
        cols.state.snapshot(), {"node-0": 0}.get)
    assert rows.tolist() == [] and counts.tolist() == []


class _JournalRaft:
    """The leader's replication as the FSM sees it: each entry encoded by
    the raft codec, through JSON, decoded and applied."""

    def __init__(self, fsm):
        self.fsm = fsm
        self.applied_index = 1000

    def apply(self, msg_type, payload):
        from concurrent.futures import Future

        self.applied_index += 1
        entry = json.loads(json.dumps(
            log_codec.encode_payload(msg_type, payload)))
        self.fsm.apply(self.applied_index, msg_type,
                       log_codec.decode_payload(msg_type, entry))
        future = Future()
        future.set_result(self.applied_index)
        return future


class _LeaderPlanner:
    """Submits plans as the leader's pipeline does: verified and rolled
    into an optimistic snapshot (evaluate_plans), then replicated by the
    pipeline's own ``_apply`` through ``_JournalRaft``."""

    def __init__(self, fsm):
        from nomad_tpu_torch.server.plan_pipeline import PlanPipeline

        self.fsm = fsm
        self.plans = []
        self.pipeline = PlanPipeline(None, None, _JournalRaft(fsm), fsm)

    def submit_plan(self, plan):
        from nomad_tpu_torch.server.plan_pipeline import evaluate_plans

        self.plans.append(plan)
        (result,) = evaluate_plans(self.fsm.state.snapshot(), [plan])
        result.alloc_index = self.pipeline._apply(result, plan).result()
        return result, None

    def update_eval(self, ev):
        pass

    def create_eval(self, ev):
        pass


def test_a_block_roll_round_builds_no_stop_copy_on_the_leaders_path(
        monkeypatch):
    """Reconcile, staging, verify, the optimistic snapshot, the raft
    encode and the FSM of a block-path rolling round: no Allocation is
    copied or materialized from a block anywhere, and the round's 100
    stops commit as one stopped block. (A round of 100 placements takes
    the bulk verifier, as a 1,000-task round does; below
    FAST_VERIFY_THRESHOLD the per-node check reads nodes as objects.)"""
    from nomad_tpu_torch.state import blocks as blocks_mod

    fsm, planner, job, job2, process = _block_roll(_LeaderPlanner,
                                                   max_parallel=100)
    state = fsm.state
    made = []
    orig_copy = structs.Allocation.copy
    orig_span = structs.AllocBatch._materialize_span

    def spy_copy(self):
        made.append(("copy", self.id))
        return orig_copy(self)

    def spy_span(self, template, node_id, start, end, out):
        made.append(("materialize", start, end))
        return orig_span(self, template, node_id, start, end, out)
    monkeypatch.setattr(structs.Allocation, "copy", spy_copy)
    monkeypatch.setattr(blocks_mod.StoredAllocBlock, "_materialize_span",
                        spy_span)
    for rounds in range(1, 4):
        process(job2)
        plan = planner.plans[-1]
        assert [r.n for r in plan.block_stops] == [100]
        assert not plan.node_update
        assert made == [], (rounds, made[:4])
        assert (state.stop_books.blocks, state.stop_books.members,
                state.stop_books.rows) == (rounds, 100 * rounds, 0)
    assert not any(b.job.modify_index == job.modify_index
                   for b in state.job_alloc_blocks(job.id))
