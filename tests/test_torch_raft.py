"""The port's raft (nomad_tpu_torch.raft) against nomad_tpu's.

- The codec: every message type of ``_SCHEMAS`` encodes to the same wire
  form in both packages, and each package decodes the other's to
  ``to_dict``-equal payloads.
- The on-disk format: a nomad_tpu ``RaftNode`` writes a journal and a
  snapshot and a port ``RaftNode`` restarts from that directory to the
  same FSM state; and the other way round.
- The port's raft alone: self-election, three-node replication, restart
  from the journal, and a lagging follower caught up by a chunked
  InstallSnapshot.

Tolerance: exact (state tables compared as ``to_dict`` rows). Raft timing
is widened by the measured scheduling stall of the moment (``load_factor``)
so a loaded test box keeps its leaders.
"""

import copy
import io
import json
import pickle
import time

import pytest

from nomad_tpu import mock as jax_mock
from nomad_tpu import structs as jst
from nomad_tpu.api.codec import to_dict as jax_to_dict
from nomad_tpu.raft import RaftConfig as JaxRaftConfig
from nomad_tpu.raft import RaftNode as JaxRaftNode
from nomad_tpu.raft import log_codec as jax_codec
from nomad_tpu.rpc import RPCServer as JaxRPCServer
from nomad_tpu.server.fsm import FSM as JaxFSM
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.api.codec import to_dict as port_to_dict
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.raft import NotLeaderError, RaftConfig, RaftNode
from nomad_tpu_torch.raft import log_codec as port_codec
from nomad_tpu_torch.rpc import MAX_FRAME, RPCServer
from nomad_tpu_torch.server.fsm import FSM

SEED = 11


def load_factor() -> float:
    """Scheduling-stall multiplier for raft timing: time a few short
    sleeps and scale by the overshoot (capped at 4)."""
    t0 = time.monotonic()
    for _ in range(5):
        time.sleep(0.01)
    return min(4.0, max(1.0, (time.monotonic() - t0) / 0.05))


def raft_timing() -> dict:
    f = load_factor()
    return dict(heartbeat_interval=0.1 * f, election_timeout_min=0.4 * f,
                election_timeout_max=0.8 * f)


def wait_until(pred, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def port(obj, cls):
    return structs_from_reference(jax_to_dict(obj), cls)


# -- payloads of every message type ------------------------------------------------


def _jax_payloads():
    nodes = [jax_mock.node() for _ in range(3)]
    job = jax_mock.job()
    ev = jax_mock.evaluation()
    ev.job_id = job.id
    alloc = jax_mock.alloc()
    alloc.node_id = nodes[0].id
    batch = jst.AllocBatch(
        eval_id=ev.id, job=job, tg_name=job.task_groups[0].name,
        resources=jst.Resources(cpu=100, memory_mb=128),
        node_ids=[nodes[0].id, nodes[1].id], node_counts=[2, 1],
        name_idx=[0, 1, 2], ids_seed=0x1234_5678_9ABC_DEF0_1234_5678)
    ubatch = jst.AllocUpdateBatch(
        eval_id=ev.id, job=job, tg_name=job.task_groups[0].name,
        resources=jst.Resources(cpu=150, memory_mb=256),
        alloc_ids=[alloc.id, "a-2", "a-3"])
    return {
        "node_register": {"node": nodes[0]},
        "node_batch_register": {"nodes": nodes},
        "node_deregister": {"node_id": nodes[2].id},
        "node_status_update": {"node_id": nodes[1].id, "status": "down"},
        "node_drain_update": {"node_id": nodes[1].id, "drain": True},
        "job_register": {"job": job},
        "job_deregister": {"job_id": job.id},
        "eval_update": {"evals": [ev]},
        "eval_delete": {"evals": [ev.id], "allocs": [alloc.id]},
        "alloc_update": {"allocs": [alloc], "alloc_batches": [batch],
                         "update_batches": [ubatch]},
        "alloc_client_update": {"allocs": [alloc]},
    }


_PORT_CLASS = {"node": "Node", "nodes": "Node", "job": "Job",
               "evals": "Evaluation", "allocs": "Allocation"}


def _port_payload(msg_type, payload):
    out = {}
    for key, value in payload.items():
        if key == "alloc_batches":
            out[key] = [pst.AllocBatch.from_wire(b.to_wire()) for b in value]
        elif key == "update_batches":
            out[key] = [pst.AllocUpdateBatch.from_wire(b.to_wire())
                        for b in value]
        elif msg_type != "eval_delete" and key in _PORT_CLASS:
            cls = _PORT_CLASS[key]
            out[key] = ([port(v, cls) for v in value]
                        if isinstance(value, list) else port(value, cls))
        else:
            out[key] = value
    return out


def _wire(obj):
    return json.loads(json.dumps(obj))


def test_codec_covers_every_message_type():
    assert set(_jax_payloads()) == set(jax_codec._SCHEMAS)
    assert set(port_codec._SCHEMAS) == set(jax_codec._SCHEMAS)


@pytest.mark.parametrize("msg_type", sorted(jax_codec._SCHEMAS))
def test_codec_matches_jax(msg_type):
    jax_payload = _jax_payloads()[msg_type]
    port_payload = _port_payload(msg_type, jax_payload)
    enc_jax = _wire(jax_codec.encode_payload(msg_type, jax_payload))
    enc_port = _wire(port_codec.encode_payload(msg_type, port_payload))
    assert enc_port == enc_jax
    # Each package decodes the other's entry to the same payload.
    from_jax = port_codec.decode_payload(msg_type, enc_jax)
    from_port = jax_codec.decode_payload(msg_type, enc_port)
    assert _wire(port_to_dict(from_jax)) == _wire(jax_to_dict(from_port))
    assert _wire(port_to_dict(from_jax)) == _wire(jax_to_dict(jax_payload))


# -- on-disk format -------------------------------------------------------------------


class _JaxFSMReadingPort(JaxFSM):
    """nomad_tpu's FSM, reading snapshots that name the port's classes
    (the mirror image of the port's own module-path mapping)."""

    def restore_bytes(self, data):
        class _Unpickler(pickle.Unpickler):
            def find_class(self, module, name):
                if module.startswith("nomad_tpu_torch"):
                    module = "nomad_tpu" + module[len("nomad_tpu_torch"):]
                return super().find_class(module, name)

        payload = _Unpickler(io.BytesIO(data)).load()
        super().restore_bytes(pickle.dumps(payload))


def _start_single(node_cls, cfg_cls, rpc_cls, fsm, data_dir, **kw):
    rpc = rpc_cls()
    node = node_cls(cfg_cls(node_id="d0", peers={"d0": rpc.addr},
                            data_dir=str(data_dir), **raft_timing(), **kw),
                    fsm, rpc)
    rpc.start()
    node.start()
    assert wait_until(lambda: node.is_leader)
    return node, rpc


def _write_history(node, mod, payloads, n_snap):
    """Apply entries until at least one compaction has run, then a tail
    past the snapshot: the directory holds a snapshot AND a journal."""
    idx = 0
    nodes = [mod.node() for _ in range(n_snap)]
    for nd in nodes:
        idx = node.apply("node_register", {"node": nd}).result(10)
    assert wait_until(lambda: node.compactions >= 1)
    for msg_type, payload in payloads:
        idx = node.apply(msg_type, payload).result(10)
    return idx


def _tail(mod, structs_mod):
    job = mod.job()
    job.type = structs_mod.JOB_TYPE_BATCH
    ev = mod.evaluation()
    ev.job_id = job.id
    ev.status = "complete"
    alloc = mod.alloc()
    alloc.job_id = job.id
    alloc.job = job
    batch = structs_mod.AllocBatch(
        eval_id=ev.id, job=job, tg_name=job.task_groups[0].name,
        resources=structs_mod.Resources(cpu=100, memory_mb=128),
        node_ids=[alloc.node_id], node_counts=[3], name_idx=[0, 1, 2],
        ids_seed=0xABCDEF)
    return [("job_register", {"job": job}),
            ("eval_update", {"evals": [ev]}),
            ("alloc_update", {"allocs": [alloc], "alloc_batches": [batch]})]


def _state(store, to_dict):
    snap = store.snapshot()
    allocs = []
    for job in snap.jobs():
        allocs.extend(snap.allocs_by_job(job.id))
    return _wire({
        "nodes": sorted((to_dict(n) for n in snap.nodes()),
                        key=lambda d: d["id"]),
        "jobs": sorted((to_dict(j) for j in snap.jobs()),
                       key=lambda d: d["id"]),
        "evals": sorted((to_dict(e) for e in snap.evals()),
                        key=lambda d: d["id"]),
        "allocs": sorted((to_dict(a) for a in allocs),
                         key=lambda d: d["id"]),
        "indexes": {t: snap.get_index(t)
                    for t in ("nodes", "jobs", "evals", "allocs")},
    })


@pytest.mark.parametrize("direction", ["jax-writes", "port-writes"])
def test_on_disk_format_restarts_across_packages(tmp_path, direction):
    from nomad_tpu_torch import mock as port_mock

    if direction == "jax-writes":
        writer = (JaxRaftNode, JaxRaftConfig, JaxRPCServer, JaxFSM(),
                  jax_mock, jst, jax_to_dict)
        reader = (RaftNode, RaftConfig, RPCServer, FSM(), port_to_dict)
    else:
        writer = (RaftNode, RaftConfig, RPCServer, FSM(), port_mock, pst,
                  port_to_dict)
        reader = (JaxRaftNode, JaxRaftConfig, JaxRPCServer,
                  _JaxFSMReadingPort(), jax_to_dict)
    w_node, w_rpc = _start_single(*writer[:4], tmp_path,
                                  snapshot_threshold=8, trailing_logs=2)
    try:
        last = _write_history(w_node, writer[4], _tail(writer[4], writer[5]),
                              n_snap=10)
        assert sorted(p.name for p in tmp_path.iterdir() if
                      p.name.startswith("raft-snap-"))
        want = _state(writer[3].state, writer[6])
    finally:
        w_node.shutdown()
        w_rpc.shutdown()
    r_node, r_rpc = _start_single(*reader[:4], tmp_path,
                                  snapshot_threshold=1 << 20)
    try:
        assert r_node.snapshot_index > 0
        assert wait_until(lambda: r_node.applied_index >= last)
        assert _state(reader[3].state, reader[4]) == want
    finally:
        r_node.shutdown()
        r_rpc.shutdown()


# -- the port's raft alone ------------------------------------------------------------


def _cluster(n, prefix="r", start=None, **kw):
    rpcs = [RPCServer() for _ in range(n)]
    peers = {f"{prefix}{i}": r.addr for i, r in enumerate(rpcs)}
    timing = raft_timing()
    nodes = []
    for i, rpc in enumerate(rpcs):
        node = RaftNode(RaftConfig(node_id=f"{prefix}{i}", peers=dict(peers),
                                   seed=SEED, **timing, **kw), FSM(), rpc)
        nodes.append(node)
    for i in (range(n) if start is None else start):
        rpcs[i].start()
        nodes[i].start()
    return nodes, rpcs


def _stop(nodes, rpcs):
    for node in nodes:
        node.shutdown()
    for rpc in rpcs:
        rpc.shutdown()


def _leader(nodes, timeout=20.0):
    found = []
    assert wait_until(lambda: found.extend(
        n for n in nodes if n.is_leader) or found, timeout)
    return found[0]


def test_single_node_elects_itself_and_commits():
    nodes, rpcs = _cluster(1)
    try:
        leader = _leader(nodes)
        node = pst.Node(id="n-1", datacenter="dc1", name="n1",
                        status="ready")
        index = leader.apply("node_register", {"node": node}).result(5)
        assert leader.applied_index == index
        assert leader.fsm.state.node_by_id("n-1") is not None
        assert leader.barrier(5) > index
        assert leader.read_index(2.0) >= index
    finally:
        _stop(nodes, rpcs)


def test_three_nodes_replicate_and_followers_refuse_writes():
    from nomad_tpu_torch import mock as port_mock

    nodes, rpcs = _cluster(3)
    try:
        leader = _leader(nodes)
        follower = next(n for n in nodes if n is not leader)
        with pytest.raises(NotLeaderError):
            follower.apply("node_register",
                           {"node": port_mock.node()}).result(5)
        last = 0
        for _ in range(20):
            last = leader.apply("node_register",
                                {"node": port_mock.node()}).result(10)
        assert wait_until(lambda: all(n.applied_index >= last for n in nodes))
        states = [_state(n.fsm.state, port_to_dict) for n in nodes]
        assert states[0] == states[1] == states[2]
        assert len(states[0]["nodes"]) == 20
        assert wait_until(lambda: follower.leader_addr == leader.rpc.addr)
    finally:
        _stop(nodes, rpcs)


def test_restart_replays_the_journal(tmp_path):
    from nomad_tpu_torch import mock as port_mock

    fsm = FSM()
    node, rpc = _start_single(RaftNode, RaftConfig, RPCServer, fsm, tmp_path)
    try:
        last = 0
        for _ in range(6):
            last = node.apply("node_register",
                              {"node": port_mock.node()}).result(5)
        want = _state(fsm.state, port_to_dict)
        term = node.current_term
    finally:
        node.shutdown()
        rpc.shutdown()
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("raft-snap")]
    fsm2 = FSM()
    node2, rpc2 = _start_single(RaftNode, RaftConfig, RPCServer, fsm2,
                                tmp_path)
    try:
        assert node2.current_term > term
        assert wait_until(lambda: node2.applied_index >= last)
        assert _state(fsm2.state, port_to_dict) == want
    finally:
        node2.shutdown()
        rpc2.shutdown()


def test_lagging_follower_catches_up_by_install_snapshot():
    """A member that comes up after the leader compacted past it cannot be
    served by AppendEntries: the leader streams its snapshot in chunks,
    then replicates the tail."""
    from nomad_tpu_torch import mock as port_mock

    kw = dict(snapshot_threshold=16, trailing_logs=4,
              snapshot_chunk_bytes=512)
    nodes, rpcs = _cluster(3, start=(0, 1), **kw)
    # The third member is down (its port refuses) until the log compacts.
    late_port = int(rpcs[2].addr.rsplit(":", 1)[1])
    nodes[2].shutdown()
    rpcs[2].shutdown()
    try:
        leader = _leader(nodes[:2])
        last = 0
        for _ in range(40):
            last = leader.apply("node_register",
                                {"node": port_mock.node()}).result(10)
        assert wait_until(lambda: leader.compactions >= 1)
        assert leader.log_offset > 0
        rpcs[2] = RPCServer(port=late_port)
        nodes[2] = RaftNode(RaftConfig(
            node_id="r2", peers=dict(leader.config.peers), seed=SEED,
            **raft_timing(), **kw), FSM(), rpcs[2])
        rpcs[2].start()
        nodes[2].start()
        assert wait_until(lambda: nodes[2].applied_index >= last, 30.0)
        assert nodes[2].snapshots_installed >= 1
        assert leader.snapshots_sent >= 1
        assert (_state(nodes[2].fsm.state, port_to_dict)
                == _state(leader.fsm.state, port_to_dict))
    finally:
        _stop(nodes, rpcs)


def test_stops_cross_the_wire_as_ids():
    """Stop copies (the deregister's 100,000 at the headline) ride an
    alloc_update entry and a forwarded plan as id runs, and the receiver's
    rebuild from its own store gives the state the objects give."""
    from nomad_tpu_torch import mock as port_mock
    from nomad_tpu_torch.server.cluster import _stops_from_wire, _stops_to_wire

    nodes = [port_mock.node() for _ in range(4)]
    for i, nd in enumerate(nodes):
        nd.id = f"node-{i}"
    job = port_mock.job()
    job.id = "job-stop"
    obj = port_mock.alloc()
    obj.id, obj.node_id, obj.job_id, obj.job = "obj-1", "node-2", job.id, job

    def seeded_fsm():
        fsm = FSM()
        for i, nd in enumerate(nodes):
            fsm.apply(1 + i, "node_register", {"node": copy.deepcopy(nd)})
        fsm.apply(10, "job_register", {"job": job})
        batch = pst.AllocBatch(
            eval_id="ev-1", job=job, tg_name=job.task_groups[0].name,
            resources=pst.Resources(cpu=100, memory_mb=128),
            node_ids=["node-0", "node-1"], node_counts=[30, 20],
            name_idx=list(range(50)), ids_seed=0xBEEF)
        fsm.apply(11, "alloc_update", {"allocs": [obj.copy()],
                                       "alloc_batches": [batch]})
        return fsm

    fsm_obj, fsm_wire = seeded_fsm(), seeded_fsm()
    plan = pst.Plan(eval_id="ev-2")
    for a in fsm_obj.state.allocs_by_job(job.id):
        plan.append_update(a, "stop", "alloc not needed due to job update")
    stops = [a for lst in plan.node_update.values() for a in lst]
    assert len(stops) == 51

    fsm_obj.apply(12, "alloc_update", {"allocs": stops})
    entry = _wire(port_codec.encode_payload("alloc_update", {"allocs": stops}))
    assert entry["allocs"] == [] and len(entry["allocs_stopped"]) == 1
    assert len(json.dumps(entry)) < 60 * len(stops)
    # As objects (nomad_tpu's form) the headline's 100,000 stops would
    # not fit one RPC frame.
    per_stop = len(json.dumps([port_to_dict(a) for a in stops])) / len(stops)
    assert per_stop * 100_000 > MAX_FRAME
    fsm_wire.apply(12, "alloc_update",
                   port_codec.decode_payload("alloc_update", entry))
    assert (_state(fsm_wire.state, port_to_dict)
            == _state(fsm_obj.state, port_to_dict))
    assert all(a.terminal_status()
               for a in fsm_wire.state.allocs_by_job(job.id))

    wire = _wire(_stops_to_wire(plan))
    assert wire["node_update"] == {}
    back = _stops_from_wire(pst.Plan, wire, fsm_obj.state.alloc_by_id)
    assert ({k: [a.id for a in v] for k, v in back.node_update.items()}
            == {k: [a.id for a in v] for k, v in plan.node_update.items()})
    assert all(a.desired_status == "stop"
               for v in back.node_update.values() for a in v)
