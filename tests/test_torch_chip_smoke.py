"""chip_smoke.py's count of the bytes and operations that bound the
water-fill, on its own instances, made on the CPU."""

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
