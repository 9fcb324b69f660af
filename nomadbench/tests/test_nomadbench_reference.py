"""The plain reference catches each kind of fault in a committed state,
and passes the state it should."""

import pytest

from nomadbench import reference

CFG = {"nodes": {"count": 4, "id_format": "n{i}",
                 "datacenters": ["dc1", "dc2"],
                 "attributes": {"kernel.name": "linux"},
                 "resources": {"cpu": 1000, "memory_mb": 1024,
                               "disk_mb": 0, "iops": 0}}}
JOB = {"count": 4, "cpu": 100, "memory_mb": 128, "env": {"V": "1"},
       "datacenters": ["dc1"], "spread": "waterfill",
       "constraints": [{"attribute": "$attr.kernel.name", "value": "linux"}]}


def rows(placement, cpu=100, env=None):
    return [("j", nid, cnt, cpu, 128, 0, 0, env or {"V": "1"})
            for nid, cnt in placement]


def judge(placement, job=JOB, **kw):
    return reference.judge(reference.NodeTable(CFG), {"j": job},
                           rows(placement, **kw))


def test_a_sound_state_has_no_violation():
    got = judge([("n0", 2), ("n2", 2)])
    assert reference.verdict(got), got


@pytest.mark.parametrize("placement,kw,kind", [
    ([("n0", 2), ("n2", 1)], {}, "count_gap"),
    ([("n0", 2), ("n1", 2)], {}, "off_eligible"),
    ([("n0", 2), ("n9", 2)], {}, "off_eligible"),
    ([("n0", 3), ("n2", 1)], {}, "spread_gap"),
    ([("n0", 2), ("n2", 2)], {"cpu": 107}, "ask_mismatch"),
    ([("n0", 2), ("n2", 2)], {"env": {"V": "0"}}, "stale_version"),
])
def test_each_fault_is_caught(placement, kw, kind):
    got = judge(placement, **kw)
    assert got[kind] > 0 and not reference.verdict(got), got


def test_over_capacity_and_doubled_are_caught():
    job = dict(JOB, count=11, spread=None, one_per_node=True)
    got = judge([("n0", 11)], job=job)
    assert got["over_capacity"] == 1 and got["doubled"] == 1


def test_stop_path_and_evals():
    job = dict(JOB, count=0)
    got = reference.judge(reference.NodeTable(CFG), {"j": job},
                          rows([("n0", 1)]), ["complete", "failed", ""])
    assert got["count_gap"] == 1 and got["evals_not_complete"] == 2


@pytest.mark.parametrize("after,destructive,kind", [
    ([("a1", "e1"), ("b1", "u1")], True, "not_replaced"),
    ([("b0", "u1"), ("b1", "e0")], True, "not_created"),
    ([("a0", "u1"), ("b1", "u1")], False, "not_in_place"),
    ([("a0", "u1")], False, "not_in_place"),
])
def test_update_diff_faults_are_caught(after, destructive, kind):
    got = reference.judge_update(["a0", "a1"], after, ["u0", "u1"],
                                 destructive)
    assert got[kind] > 0 and sum(got.values()) == got[kind], got


@pytest.mark.parametrize("after,destructive", [
    ([("b0", "u0"), ("b1", "u1")], True),
    ([("a0", "u1"), ("a1", "u1")], False),
])
def test_a_sound_update_diff_has_no_violation(after, destructive):
    got = reference.judge_update(["a0", "a1"], after, ["u0", "u1"],
                                 destructive)
    assert not any(got.values()), got
