"""The port's raft & recovery observatory (raft_observe.py) and the raft
node's books behind it, against nomad_tpu's.

- ``RaftObserveConfig.parse``: the same values and the same rejections.
- ``stage_partition`` on seeded anchor sets (numpy draws: anchors left
  out, out of order, equal) gives nomad_tpu's stages, and the stages sum
  to ``resolved - submit``.
- ``RaftObservatory``: the same write-path records, drained in the same
  batches from a stand-in node through both packages' observatories, give
  equal snapshots (the commit-advance rate, a wall-clock series, aside);
  ``absorb`` of a predecessor gives equal books too; every record's
  stages reconcile with its submit→applied.
- ``fsm_state_digest``: the same writes applied to each package's store
  give the same hex.
- The port's raft node: its own write-path records reconcile, the ring
  overflow is counted, a three-member port cell's followers reach the
  leader's FSM digest after catch-up, and a cold restart from the data
  dir replays the pre-kill digest with a populated recovery timeline.

Tolerance: exact (host code on identical inputs), apart from the
per-record reconciliation, which sums floats (1e-9 ms).
"""

import pickle
import time

import numpy as np
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu import raft_observe as jro
from nomad_tpu import structs as jstructs
from nomad_tpu.api.codec import to_dict
from nomad_tpu.state.store import StateStore as JaxStore
from nomad_tpu_torch import mock
from nomad_tpu_torch import raft_observe as pro
from nomad_tpu_torch import structs as pstructs
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.raft.node import RaftConfig, RaftNode
from nomad_tpu_torch.rpc import ConnPool, RPCServer
from nomad_tpu_torch.server.cluster import (
    ClusterConfig,
    form_cluster,
    wait_for_leader,
)
from nomad_tpu_torch.server.server import ServerConfig
from nomad_tpu_torch.state.store import StateStore as PortStore
from test_torch_cluster import relaxed_cluster, retry_write


def _wait(predicate, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


# -- config -------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    None, {}, {"enabled": False},
    {"poll_interval": 0.25, "events_interval": 0},
])
def test_config_parse_equals_reference(spec):
    assert (vars(pro.RaftObserveConfig.parse(spec))
            == vars(jro.RaftObserveConfig.parse(spec)))


@pytest.mark.parametrize("spec", [
    {"poll_interval": 0}, {"events_interval": -1}, {"pollinterval": 1.0},
    "nope",
])
def test_config_rejections_equal_reference(spec):
    with pytest.raises(ValueError) as got:
        pro.RaftObserveConfig.parse(spec)
    with pytest.raises(ValueError) as ref:
        jro.RaftObserveConfig.parse(spec)
    assert str(got.value) == str(ref.value)


# -- stage partition ----------------------------------------------------------


def anchor_sets(seed, n=60):
    """Anchor dicts: increasing stamps with some anchors left out, some
    equal, and some out of order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = float(rng.uniform(0.0, 100.0))
        anchors = {}
        for name in pro.ANCHORS:
            t += float(rng.choice([0.0, rng.exponential(0.004)]))
            if rng.random() < 0.15:
                continue  # left out
            stamp = t
            if rng.random() < 0.1:
                stamp -= float(rng.exponential(0.002))  # out of order
            anchors[name] = stamp
        anchors.setdefault("submit", t - 0.01)
        anchors["resolved"] = max(anchors.get("resolved", t), t)
        out.append(anchors)
    return out


def test_anchor_and_stage_names_equal_reference():
    assert pro.ANCHORS == jro.ANCHORS and pro.STAGES == jro.STAGES


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_stage_partition_equals_reference(seed):
    for anchors in anchor_sets(seed):
        got = pro.stage_partition(anchors)
        assert got == jro.stage_partition(anchors)
        assert all(ms >= 0 for ms in got.values())
        total = (anchors["resolved"] - anchors["submit"]) * 1000.0
        assert sum(got.values()) == pytest.approx(total, abs=1e-9)


# -- the observatory over the same records ------------------------------------


class BookNode:
    """A stand-in raft node serving a fixed record stream in drains."""

    def __init__(self, records, ring=1024):
        self.records = records
        self.ring = ring
        self.seq = 0
        self.applied_index = 0
        self.commit_index = 0
        self.recovery = {"cold_start": True, "entries_replayed": 40,
                         "replay_wall_ms": 12.5, "snapshot_restore_ms": 3.0}

    def advance(self, n):
        self.seq = min(self.seq + n, len(self.records))
        self.applied_index = self.commit_index = 3 * self.seq

    def write_path_records(self, since):
        n = self.seq - int(since)
        if n <= 0:
            return self.seq, []
        done = self.records[max(0, self.seq - self.ring):self.seq]
        return self.seq, list(done[-min(n, len(done)):])

    def observe_stats(self):
        return {"state": "leader", "applied_index": self.applied_index,
                "commit_index": self.commit_index,
                "peers": {"b": {"lag_entries": 2}},
                "log": {"entries": self.seq, "bytes": 10 * self.seq},
                "snapshot": {"index": 0}}


class RestoreFSM:
    last_restore = {"wall_ms": 1.5, "nodes": 3, "placements": 9}


def records(seed, n=300):
    rng = np.random.default_rng(seed)
    types = ["alloc_update", "eval_update", "job_register",
             "node_batch_register"]
    return [{"index": i + 1, "msg_type": str(rng.choice(types)),
             "bytes": int(rng.integers(100, 5000)), "anchors": a}
            for i, a in enumerate(anchor_sets(seed, n))]


def observe(mod, recs, drains, ring=1024):
    node = BookNode(recs, ring=ring)
    obs = mod.RaftObservatory(lambda: node, fsm_getter=lambda: RestoreFSM())
    for n in drains:
        node.advance(n)
        obs.refresh()
    return obs


def comparable(snap):
    snap = dict(snap)
    snap["replication"] = {k: v for k, v in snap["replication"].items()
                           if k != "commit_advance"}
    return snap


@pytest.mark.parametrize("seed, drains, ring", [
    (1, [300], 1024),
    (2, [17, 0, 83, 200], 1024),
    (3, [50, 250], 64),  # the ring overflows: drops are counted
])
def test_observatory_snapshot_equals_reference(seed, drains, ring):
    recs = records(seed)
    got = observe(pro, recs, drains, ring)
    ref = observe(jro, recs, drains, ring)
    assert comparable(got.snapshot()) == comparable(ref.snapshot())
    assert got.summary() == ref.summary()
    assert got.records_dropped == ref.records_dropped
    assert got.records_ingested + got.records_dropped == len(recs)
    if ring < len(recs):
        assert got.records_dropped > 0
    snap = got.snapshot()
    assert snap["recovery"]["fsm_restore"] == RestoreFSM.last_restore
    assert snap["recovery"]["replay_entries_per_s"] == 3200.0
    # The stage books partition each record's submit→applied.
    for rec in recs:
        stages = pro.stage_partition(rec["anchors"])
        total = (rec["anchors"]["resolved"]
                 - rec["anchors"]["submit"]) * 1000.0
        assert sum(stages.values()) == pytest.approx(total, abs=1e-9)


def test_absorb_equals_reference():
    recs_a, recs_b = records(5, 120), records(6, 80)
    books = []
    for mod in (pro, jro):
        old = observe(mod, recs_a, [60, 60])
        new = observe(mod, recs_b, [80])
        new.absorb(old)
        new.absorb(None)
        books.append(new)
    assert comparable(books[0].snapshot()) == comparable(books[1].snapshot())
    assert books[0].records_ingested == 200
    # The predecessor is drained once more on absorb: 1 + (2 + 1) polls.
    assert books[0].polls == books[1].polls == 4


def test_raft_event_is_observer_topic():
    from nomad_tpu_torch.events import OBSERVER_TOPICS, EventBroker

    broker = EventBroker(capacity=16)
    node = BookNode(records(9, 10))
    node.advance(10)
    obs = pro.RaftObservatory(lambda: node, events=broker)
    obs.refresh()
    obs.publish_event()
    _latest, evs, _truncated = broker.events_after(0)
    assert [(e.topic, e.type, e.key) for e in evs] == [
        ("Raft", "RaftSnapshot", "raft")]
    assert "Raft" in OBSERVER_TOPICS


# -- fsm_state_digest ---------------------------------------------------------


def state_writes(seed):
    """[(method, reference args)] drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    nodes = [jmock.node() for _ in range(6)]
    job = jmock.job()
    ev = jmock.evaluation()
    ev.job_id = job.id
    out = [("upsert_nodes", (nodes,)), ("upsert_job", (job,)),
           ("upsert_evals", ([ev],))]
    allocs = []
    for k in range(int(rng.integers(3, 9))):
        a = jmock.alloc()
        a.job_id, a.job = job.id, job
        a.node_id = nodes[int(rng.integers(len(nodes)))].id
        allocs.append(a)
    out.append(("upsert_allocs", (allocs,)))
    out.append(("update_node_drain", (nodes[int(rng.integers(6))].id,
                                      True)))
    out.append(("update_node_status", (nodes[int(rng.integers(6))].id,
                                       "down")))
    batch = dict(
        eval_id=ev.id, job=job, tg_name=job.task_groups[0].name,
        node_ids=[nodes[0].id, nodes[1].id], node_counts=[2, 1],
        name_idx=[0, 1, 2], ids_seed=int(rng.integers(1, 2**62)))
    out.append(("upsert_alloc_blocks", ([batch],)))
    return out


def as_ref(arg):
    if isinstance(arg, list):
        return [as_ref(a) for a in arg]
    if isinstance(arg, dict):  # an AllocBatch's fields
        return jstructs.AllocBatch(
            resources=jstructs.Resources(cpu=100, memory_mb=128), **arg)
    return arg


def to_port(arg):
    if isinstance(arg, list):
        return [to_port(a) for a in arg]
    if isinstance(arg, dict):
        return pstructs.AllocBatch(
            resources=pstructs.Resources(cpu=100, memory_mb=128),
            **{**arg, "job": to_port(arg["job"])})
    if isinstance(arg, (jstructs.Node, jstructs.Job, jstructs.Evaluation,
                        jstructs.Allocation)):
        return structs_from_reference(to_dict(arg), type(arg).__name__)
    return arg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fsm_state_digest_equals_reference(seed):
    ref, port = JaxStore(), PortStore()
    digests = []
    for index, (method, args) in enumerate(state_writes(seed), start=1):
        getattr(ref, method)(index, *[as_ref(a) for a in args])
        getattr(port, method)(index, *[to_port(a) for a in args])
        got, want = pro.fsm_state_digest(port), jro.fsm_state_digest(ref)
        assert got == want, method
        digests.append(got)
    assert len(set(digests)) == len(digests)  # every write moved it


# -- the port's raft node -----------------------------------------------------


class KVFSM:
    def __init__(self):
        self.data = {}

    def apply(self, index, msg_type, payload):
        self.data[payload["k"]] = payload["v"]

    def snapshot_bytes(self):
        return pickle.dumps(self.data)

    def restore_bytes(self, data):
        self.data = pickle.loads(data)


def make_node(node_id, peers):
    rpc = RPCServer()
    rpc.start()
    peers[node_id] = rpc.addr
    cfg = RaftConfig(node_id=node_id, peers=peers, bootstrap_expect=1)
    return RaftNode(cfg, KVFSM(), rpc, pool=ConnPool(timeout=2.0)), rpc


def test_write_path_records_reconcile_on_live_node():
    node, rpc = make_node("a", {})
    node.start()
    try:
        _wait(lambda: node.is_leader, msg="leadership")
        for i in range(20):
            node.apply("kv", {"k": f"k{i}", "v": i}).result(5.0)
        _seq, recs = node.write_path_records(0)
        kv = [r for r in recs if r["msg_type"] == "kv"]
        assert len(kv) == 20
        for rec in kv:
            assert set(rec["anchors"]) >= {"submit", "persisted",
                                           "committed", "fsm_start",
                                           "fsm_end", "resolved"}
            stages = pro.stage_partition(rec["anchors"])
            total = (rec["anchors"]["resolved"]
                     - rec["anchors"]["submit"]) * 1000.0
            assert sum(stages.values()) == pytest.approx(total, abs=1e-9)
            assert rec["bytes"] > 0
        obs = pro.RaftObservatory(lambda: node)
        obs.refresh()
        snap = obs.snapshot()
        assert snap["write_path"]["kv"]["count"] == 20
        assert snap["raft"]["commit_index"] == snap["raft"]["applied_index"]
        assert snap["log"]["appended_entries"] >= 20
        assert snap["log"]["bytes"] > 0
    finally:
        node.shutdown()
        rpc.shutdown()


def test_write_path_ring_overflow_is_counted():
    node, rpc = make_node("a", {})
    node.start()
    try:
        _wait(lambda: node.is_leader, msg="leadership")
        obs = pro.RaftObservatory(lambda: node)
        obs.refresh()
        for i in range(1100):  # the ring holds 1024
            node.apply("kv", {"k": "k", "v": i}).result(5.0)
        obs.refresh()
        assert obs.records_dropped > 0
        assert obs.records_ingested + obs.records_dropped >= 1100
    finally:
        node.shutdown()
        rpc.shutdown()


def cell_config():
    return ServerConfig(device="cpu", scheduler_backend="host",
                        scheduler_workers=1, min_heartbeat_ttl=3600.0,
                        prewarm_shapes=False)


def test_followers_reach_the_leaders_fsm_digest():
    servers = form_cluster(3, cell_config(), base_cluster=relaxed_cluster())
    try:
        leader = wait_for_leader(servers, timeout=30.0)
        nodes = [mock.node() for _ in range(5)]
        retry_write(lambda: leader.node_batch_register(nodes))
        leader = wait_for_leader(servers, timeout=30.0)
        job = mock.job()
        job.task_groups[0].count = 3
        eid, _ = retry_write(lambda: leader.job_register(job))
        leader.wait_for_eval(eid, timeout=30.0)
        applied = leader.raft.applied_index
        _wait(lambda: all(s.raft.applied_index >= applied for s in servers),
              msg="followers catch up")
        want = pro.fsm_state_digest(leader.state_store)
        for srv in servers:
            _wait(lambda s=srv: pro.fsm_state_digest(s.state_store) == want,
                  msg="digest equality")
        snap = leader.raft_observatory.snapshot()
        assert set(snap["replication"]["peers"]) == {
            s.cluster.node_id for s in servers if s is not leader}
    finally:
        for srv in servers:
            srv.shutdown(drain_timeout=2.0)


def test_cold_restart_replays_the_pre_kill_digest(tmp_path):
    ccfg = ClusterConfig(raft_data_dir=str(tmp_path / "raft"))
    (srv,) = form_cluster(1, cell_config(), ccfg)
    job = mock.job()
    job.task_groups[0].count = 2
    try:
        wait_for_leader([srv])
        for _ in range(6):
            srv.node_register(mock.node())
        eid, _ = srv.job_register(job)
        srv.wait_for_eval(eid, timeout=30.0)
        applied = srv.raft.applied_index
        before = pro.fsm_state_digest(srv.state_store)
        assert srv.raft.recovery["cold_start"] is False
    finally:
        srv.shutdown()
    (srv2,) = form_cluster(1, cell_config(), ClusterConfig(
        raft_data_dir=str(tmp_path / "raft")))
    try:
        wait_for_leader([srv2])
        _wait(lambda: srv2.raft.applied_index >= applied, msg="replay")
        _wait(lambda: srv2.raft.recovery["time_to_serving_ms"] is not None,
              msg="serving stamp")
        obs = srv2.raft_observatory
        obs.refresh()
        recovery = obs.snapshot()["recovery"]
        assert recovery["cold_start"] is True
        assert recovery["entries_replayed"] > 0
        assert recovery["replayed_by_type"].get("node_register", 0) >= 6
        assert recovery["replay_wall_ms"] is not None
        assert recovery["time_to_leader_ms"] is not None
        assert pro.fsm_state_digest(srv2.state_store) == before
        assert len(srv2.state_store.allocs_by_job(job.id)) == 2
    finally:
        srv2.shutdown()


def test_snapshot_restore_is_stamped(tmp_path):
    """A restart from a compacted log restores the FSM snapshot first: the
    FSM's ``last_restore`` and the timeline's restore wall are set."""
    ccfg = ClusterConfig(raft_data_dir=str(tmp_path / "raft"),
                         snapshot_threshold=4, trailing_logs=1)
    (srv,) = form_cluster(1, cell_config(), ccfg)
    try:
        wait_for_leader([srv])
        for _ in range(12):
            srv.node_register(mock.node())
        _wait(lambda: srv.raft.compactions >= 1, msg="a compaction")
        before = pro.fsm_state_digest(srv.state_store)
        applied = srv.raft.applied_index
    finally:
        srv.shutdown()
    (srv2,) = form_cluster(1, cell_config(), ClusterConfig(
        raft_data_dir=str(tmp_path / "raft"), snapshot_threshold=4,
        trailing_logs=1))
    try:
        wait_for_leader([srv2])
        _wait(lambda: srv2.raft.applied_index >= applied, msg="replay")
        recovery = srv2.raft_observatory.snapshot()["recovery"]
        assert recovery["snapshot_index"] > 0
        assert recovery["snapshot_bytes"] > 0
        assert recovery["fsm_restore"]["nodes"] >= 1
        assert pro.fsm_state_digest(srv2.state_store) == before
        assert isinstance(srv2.fsm.last_restore, dict)
    finally:
        srv2.shutdown()


def test_port_structs_digest_ignores_nothing_replicated():
    """The digest covers node status and drain: flipping either moves it."""
    store = PortStore()
    node = mock.node()
    store.upsert_nodes(1, [node])
    d0 = pro.fsm_state_digest(store)
    store.update_node_drain(2, node.id, True)
    d1 = pro.fsm_state_digest(store)
    store.update_node_status(3, node.id, pstructs.NODE_STATUS_DOWN)
    assert len({d0, d1, pro.fsm_state_digest(store)}) == 3
