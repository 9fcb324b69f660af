"""The port's cluster tier (nomad_tpu_torch.server.cluster) on the CPU.

- Decisions: a one-member port cell and a one-member nomad_tpu cell, one
  worker each, ``eval_batch_size=1``, the same seed and
  ``scheduler_backend="tpu"``, go through register (water-fill and greedy
  scan), partial placement and deregister and commit the same node ids
  per job. Tolerance: exact. The nodes take a few fixed shapes, so no two
  candidate BestFit scores sit within the pow contract's 256-ulp band
  (ROADMAP, Queue 3); the band's count over every usage level the jobs
  can reach is computed and asserted to be 0.
- Three-member port cells: a follower forwards writes and every member's
  store holds the commits; the cell survives its leader's death; the
  port of nomad_tpu's ``test_leader_death_mid_coalesced_burst`` commits
  every job exactly once.
- The four RPC and raft fault sites fire on a three-member cell.
- No fallback: a ``ClusterServer`` with no ``device`` raises without a card.
"""

import os
import time

import numpy as np
import pytest
import torch

from nomad_tpu import structs as jst
from nomad_tpu.scheduler import wait_for_device
from nomad_tpu.server.cluster import form_cluster as jax_form_cluster
from nomad_tpu.server.server import ServerConfig as JaxServerConfig
from nomad_tpu_torch import faults
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.backoff import Backoff, retry_undelivered
from nomad_tpu_torch.ops.fit import score_fit
from nomad_tpu_torch.raft import NotLeaderError
from nomad_tpu_torch.rpc import RemoteError, RPCError
from nomad_tpu_torch.server.cluster import (
    ClusterConfig,
    ClusterServer,
    form_cluster,
    wait_for_leader,
)
from nomad_tpu_torch.server.server import ServerConfig
from test_torch_raft import raft_timing, wait_until
from test_torch_server import job_view, loop_cluster, loop_job, port
from test_torch_waterfill import ULP_TOLERANCE, f32_ulp_gap

torch.set_num_threads(2)

SEED = 7
WAIT_S = 60.0


def relaxed_cluster() -> ClusterConfig:
    """Raft timing for three members in one interpreter, widened by the
    measured scheduling stall of the moment."""
    return ClusterConfig(**raft_timing())


def port_cfg(**kw) -> ServerConfig:
    cfg = dict(device="cpu", scheduler_backend="tpu", num_schedulers=1,
               min_heartbeat_ttl=3600.0, seed=SEED)
    cfg.update(kw)
    return ServerConfig(**cfg)


def retry_write(fn, timeout=20.0):
    """Retry a cluster write across a leader transition (the client's
    posture: NotLeaderError, transport errors and a forwarded
    NotLeaderError are retried; other remote errors surface)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except RemoteError as e:
            if "not the leader" not in str(e) or time.monotonic() > deadline:
                raise
        except (NotLeaderError, RPCError, TimeoutError):
            if time.monotonic() > deadline:
                raise
        time.sleep(0.1)


def shutdown_all(servers):
    for srv in servers:
        srv.shutdown(drain_timeout=5.0)


def small_batch_job(count, cpu=50, mem=32, dcs=("dc1",)):
    job = port_mock.job()
    job.type = pst.JOB_TYPE_BATCH
    job.datacenters = list(dcs)
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources = pst.Resources(cpu=cpu, memory_mb=mem)
    return job


# -- decisions: one-member cells of both packages ------------------------------


def band_instances(nodes, asks, kmax):
    """Pairs of distinct candidate BestFit scores within the pow
    contract's band, over every per-node usage the jobs can reach (each
    job placing 0..kmax copies of its ask on a node), for every node
    shape of the cluster."""
    shapes = sorted({(n.resources.cpu, n.resources.memory_mb,
                      n.reserved.cpu if n.reserved else 0,
                      n.reserved.memory_mb if n.reserved else 0)
                     for n in nodes})
    grid = np.stack(np.meshgrid(*[np.arange(kmax + 1)] * len(asks),
                                indexing="ij"), -1).reshape(-1, len(asks))
    ask = np.asarray(asks, dtype=np.float64)
    scores = set()
    for cpu, mem, rcpu, rmem in shapes:
        used = grid @ ask + np.array([rcpu, rmem])
        cap = np.array([cpu - rcpu, mem - rmem], dtype=np.float32)
        fits = np.all(used <= np.array([cpu, mem]), axis=1)
        s = score_fit(torch.tensor(np.broadcast_to(cap, used.shape).copy()),
                      torch.tensor(used.astype(np.float32)))
        scores.update(float(x) for x in s[torch.tensor(fits)].tolist())
    vals = sorted(scores)
    return sum(1 for a, b in zip(vals, vals[1:])
               if f32_ulp_gap(a, b) <= ULP_TOLERANCE)


def test_one_member_cells_commit_the_same_nodes():
    assert wait_for_device(timeout=120.0) is not None
    nodes = loop_cluster(SEED, 48)
    common = dict(scheduler_backend="tpu", num_schedulers=1,
                  eval_batch_size=1, seed=SEED, min_heartbeat_ttl=3600.0)
    (jax_srv,) = jax_form_cluster(1, JaxServerConfig(**common))
    (port_srv,) = form_cluster(1, ServerConfig(device="cpu", **common))
    try:
        for srv in (jax_srv, port_srv):
            wait_for_leader([srv])
        jax_srv.node_batch_register(nodes)
        port_srv.node_batch_register([port(n, "Node") for n in nodes])
        jobs = [
            loop_job("batch200", jst.JOB_TYPE_BATCH, 200, cpu=250, mem=256),
            loop_job("service20", jst.JOB_TYPE_SERVICE, 20, cpu=250,
                     mem=256),
            loop_job("big", jst.JOB_TYPE_BATCH, 300, cpu=1900, mem=3000),
        ]
        for job in jobs:
            ja, _ = jax_srv.job_register(job)
            pa, _ = port_srv.job_register(port(job, "Job"))
            assert jax_srv.wait_for_eval(ja, WAIT_S).status == "complete"
            assert port_srv.wait_for_eval(pa, WAIT_S).status == "complete"
        for job in jobs:
            assert job_view(port_srv, job.id) == job_view(jax_srv, job.id)
        assert sum(job_view(port_srv, jobs[0].id)[0].values()) == 200
        placed, failed, _ = job_view(port_srv, jobs[2].id)
        assert failed > 0 and sum(placed.values()) + failed == 300
        for job in jobs[:2]:
            ja, _ = jax_srv.job_deregister(job.id)
            pa, _ = port_srv.job_deregister(job.id)
            jax_srv.wait_for_eval(ja, WAIT_S)
            port_srv.wait_for_eval(pa, WAIT_S)
            assert job_view(port_srv, job.id) == job_view(jax_srv, job.id)
            assert job_view(port_srv, job.id)[0] == {}
        assert band_instances(
            nodes, [(250, 256), (1900, 3000)], kmax=32) == 0
    finally:
        jax_srv.shutdown()
        port_srv.shutdown()


# -- three-member port cells ------------------------------------------------------


def test_follower_forwards_writes_and_every_member_commits():
    servers = form_cluster(3, port_cfg(), base_cluster=relaxed_cluster())
    try:
        leader = wait_for_leader(servers, timeout=20.0)
        follower = next(s for s in servers if s is not leader)
        nodes = [port_mock.node() for _ in range(12)]
        retry_write(lambda: follower.node_batch_register(nodes))
        job = small_batch_job(150, dcs=("dc1",))
        eid, _ = retry_write(lambda: follower.job_register(job))
        assert leader.wait_for_eval(eid, WAIT_S).status == "complete"
        applied = leader.raft.applied_index
        assert wait_until(lambda: all(s.raft.applied_index >= applied
                                      for s in servers))
        for srv in servers:
            live = [a for a in srv.state_store.allocs_by_job(job.id)
                    if not a.terminal_status()]
            assert len(live) == 150
            assert srv.state_store.eval_by_id(eid).status == "complete"
        # Blocking reads are served from local state on a follower.
        out = follower.pool.call(follower.rpc_addr, "Eval.GetEval",
                                 {"eval_id": eid, "min_index": 0})
        assert out["eval"]["status"] == "complete"
        members = follower.members()
        assert len(members) == 3 and sum(m["leader"] for m in members) == 1
    finally:
        shutdown_all(servers)


def test_cluster_survives_leader_failover():
    servers = form_cluster(3, port_cfg(), base_cluster=relaxed_cluster())
    try:
        leader = wait_for_leader(servers, timeout=20.0)
        retry_write(lambda: leader.node_batch_register(
            [port_mock.node() for _ in range(8)]))
        assert leader.shutdown(drain_timeout=5.0)
        survivors = [s for s in servers if s is not leader]
        new_leader = wait_for_leader(survivors, timeout=30.0)
        job = small_batch_job(40)
        eid, _ = retry_write(lambda: survivors[0].job_register(job))
        assert new_leader.wait_for_eval(eid, WAIT_S).status == "complete"
        assert len(new_leader.state_store.allocs_by_job(job.id)) == 40
    finally:
        shutdown_all(servers)


def test_leader_death_mid_coalesced_burst():
    """The port of nomad_tpu's test of the same name: kill the leader
    while a burst of coalesced evals is in flight. Every eval is raft-
    committed at registration, so the new leader's restored broker must
    finish all of them exactly once — full placement per job, no node
    over capacity. Seeded by NOMAD_TPU_CHAOS_SEED."""
    seed = int(os.environ.get("NOMAD_TPU_CHAOS_SEED", "0"))
    rng = np.random.default_rng(seed)
    servers = form_cluster(3, port_cfg(num_schedulers=2, eval_batch_size=4,
                                       min_heartbeat_ttl=300.0),
                           base_cluster=relaxed_cluster())
    try:
        leader = wait_for_leader(servers, timeout=20.0)
        nodes = [port_mock.node() for _ in range(20)]
        for node in nodes:
            retry_write(lambda n=node: leader.node_register(n))
        jobs, eval_ids = [], []
        for _ in range(8):
            job = port_mock.job()
            ev_id, _ = retry_write(lambda j=job: leader.job_register(j))
            jobs.append(job)
            eval_ids.append(ev_id)
        time.sleep(float(rng.uniform(0.05, 0.6)))
        # The survivors keep the shared coalescer busy: bound the dead
        # member's device drain short.
        leader.shutdown(drain_timeout=0.5)
        survivors = [s for s in servers if s is not leader]
        new_leader = wait_for_leader(survivors, timeout=30.0)

        def all_terminal():
            evs = [new_leader.state_store.eval_by_id(i) for i in eval_ids]
            return all(ev is not None and ev.terminal_status() for ev in evs)

        assert wait_until(all_terminal, 60.0)

        def fully_placed():
            return all(
                len(pst.filter_terminal_allocs(
                    new_leader.state_store.allocs_by_job(j.id)))
                == j.task_groups[0].count for j in jobs)

        assert wait_until(fully_placed, 60.0), [
            len(pst.filter_terminal_allocs(
                new_leader.state_store.allocs_by_job(j.id))) for j in jobs]
        applied = new_leader.raft.applied_index
        assert wait_until(lambda: all(s.raft.applied_index >= applied
                                      for s in survivors))
        for srv in survivors:
            snap = srv.state_store.snapshot()
            for node in nodes:
                live = pst.filter_terminal_allocs(snap.allocs_by_node(node.id))
                cpu = sum(a.resources.cpu for a in live)
                mem = sum(a.resources.memory_mb for a in live)
                assert cpu + node.reserved.cpu <= node.resources.cpu
                assert mem + node.reserved.memory_mb <= node.resources.memory_mb
            for job in jobs:
                live = pst.filter_terminal_allocs(snap.allocs_by_job(job.id))
                assert len({a.id for a in live}) == job.task_groups[0].count
    finally:
        shutdown_all(servers)


def test_cluster_server_needs_its_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the rule is for hosts without")
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterServer(ServerConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        form_cluster(1, ServerConfig(device="cuda"))


# -- fault sites -------------------------------------------------------------------


def _fault_rpc_send(servers, leader, follower, reg):
    """A dropped frame is provably undelivered: retry_undelivered replays
    it, and a forwarded write survives one dropped forward."""
    rule = reg.configure("rpc.send", mode="drop", count=1,
                         match=f"{leader.rpc_addr} Status.Leader")
    out = retry_undelivered(
        lambda: follower.pool.call(leader.rpc_addr, "Status.Leader", {}),
        backoff=Backoff(base=0.001, max_delay=0.002))
    assert out == leader.rpc_addr
    assert rule.fired == 1
    fwd = reg.configure("rpc.send", mode="drop", count=1,
                        match=f"{leader.rpc_addr} Job.Register")
    eid, _ = follower.job_register(small_batch_job(10))
    assert fwd.fired == 1
    assert leader.wait_for_eval(eid, WAIT_S).status == "complete"


def _fault_rpc_recv(servers, leader, follower, reg):
    """An injected receive error fails the request without running it."""
    rule = reg.configure("rpc.recv", mode="error", count=1,
                         match="Job.Register")
    job = small_batch_job(10)
    with pytest.raises(RemoteError, match="injected fault: rpc.recv"):
        follower.job_register(job)
    assert rule.fired == 1
    assert leader.state_store.job_by_id(job.id) is None
    eid, _ = follower.job_register(job)
    assert leader.wait_for_eval(eid, WAIT_S).status == "complete"


def _fault_raft_append(servers, leader, follower, reg):
    """Dropped AppendEntries are ordinary message loss: the next pass
    retries, and the write still reaches every member."""
    edge = f"{leader.cluster.node_id}->{follower.cluster.node_id}"
    rule = reg.configure("raft.append", mode="drop", count=1, match=edge)
    assert wait_until(lambda: rule.fired == 1)
    node = port_mock.node()
    retry_write(lambda: follower.node_register(node))
    assert wait_until(lambda: all(
        s.state_store.node_by_id(node.id) is not None for s in servers))


_FAULT_CASES = {
    "rpc.send": _fault_rpc_send,
    "rpc.recv": _fault_rpc_recv,
    "raft.append": _fault_raft_append,
}


@pytest.mark.parametrize("site", ["rpc.send", "rpc.recv", "raft.append",
                                  "raft.vote"])
def test_fault_site_fires_on_a_three_member_cell(site):
    reg = faults.get_registry()
    reg.clear()
    if site == "raft.vote":
        # server-0 is cut off before the cell forms: its vote requests
        # never leave and no AppendEntries reaches it.
        vote = reg.configure("raft.vote", mode="partition",
                             match="server-0->")
        reg.configure("raft.append", mode="partition", match="->server-0")
    servers = form_cluster(3, port_cfg(), base_cluster=relaxed_cluster())
    try:
        leader = wait_for_leader(servers, timeout=20.0)
        if site == "raft.vote":
            assert wait_until(lambda: vote.fired >= 1)
            deadline = time.monotonic() + 1.0
            while time.monotonic() < deadline:
                assert not servers[0].raft.is_leader
                time.sleep(0.02)
            assert leader is not servers[0]
            assert servers[0].raft.current_term > leader.raft.current_term
            return
        retry_write(lambda: leader.node_batch_register(
            [port_mock.node() for _ in range(4)]))
        follower = next(s for s in servers if s is not leader)
        _FAULT_CASES[site](servers, leader, follower, reg)
    finally:
        reg.clear()
        shutdown_all(servers)
