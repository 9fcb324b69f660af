"""ClusterServer: a Raft-replicated, network-RPC member of a server cluster.

Port of nomad_tpu/server/cluster.py. Upstream composition: nomad/server.go
(Raft + RPC wiring), nomad/leader.go (leadership monitor enabling broker/
plan queue, restoring broker state, renewing heartbeat timers on
failover), nomad/rpc.go:163-228 (leader forwarding). Every server runs
workers; followers forward Eval.Dequeue / Plan.Submit / write RPCs to the
leader, exactly like upstream's optimistically-concurrent worker pool.

Every member of a process solves on the same device through the
process-wide coalescer, so workers of different members stack their
solves into one dispatch. Every member runs the SLO monitor, the
admission front door (consulted on the leader: followers forward writes
before checking anything), the express lane (placing only on the leader;
leadership loss demotes it) and the read plane (a follower's linearizable
lane confirms its read index over ``Raft.ReadIndex``). Left out until
their modules are ported: TLS (``ServerConfig.tls`` stays in
NOT_PORTED). Like nomad_tpu's, ``start`` runs no shape warmer.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch import prng, trace
from nomad_tpu_torch.api.codec import from_dict, to_dict
from nomad_tpu_torch.backoff import Backoff
from nomad_tpu_torch.raft import NotLeaderError, RaftConfig, RaftNode
from nomad_tpu_torch.rpc import (
    ConnPool,
    RPCError,
    RPCServer,
    RPCUndeliveredError,
    RemoteError,
)
from nomad_tpu_torch.server.blocking import blocking_query
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.server.worker import Worker
from nomad_tpu_torch.state.store import item_alloc_node, item_eval, item_job
from nomad_tpu_torch.structs import (
    Allocation,
    Evaluation,
    Job,
    Node,
    Plan,
    PlanResult,
    expand_stop_runs,
    parse_reject,
    stop_runs,
)


@dataclass
class ClusterConfig:
    """Cluster membership for one server (static peer set; the reference's
    bootstrap_expect posture, serf.go:76-134)."""

    node_id: str = ""
    bind_host: str = "127.0.0.1"
    bind_port: int = 0
    # node_id -> rpc addr for all members, incl. self; filled in by
    # form_cluster for tests or by configuration.
    peers: Dict[str, str] = field(default_factory=dict)
    raft_data_dir: str = ""
    heartbeat_interval: float = 0.05
    election_timeout_min: float = 0.15
    election_timeout_max: float = 0.30
    # Hold elections until this many members are known (serf.go:76-134
    # maybeBootstrap). 0/1 = bootstrap immediately (single-server / dev).
    bootstrap_expect: int = 1
    # Addresses to Serf.Join at startup (retry-join posture,
    # command/agent/command.go retry_join handling).
    start_join: List[str] = field(default_factory=list)
    # FSM snapshot / log-compaction cadence (raft.FileSnapshotStore retains
    # 2 at nomad/server.go:453).
    snapshot_threshold: int = 8192
    snapshot_retain: int = 2
    # Entries retained past the snapshot at compaction (hashicorp/raft
    # TrailingLogs; RaftConfig.trailing_logs).
    trailing_logs: int = 1024
    # InstallSnapshot transfer chunk size (RaftConfig.snapshot_chunk_bytes):
    # raw snapshot bytes per RPC on the catch-up path.
    snapshot_chunk_bytes: int = 256 * 1024
    # Gossip-style failure detection (serf memberlist probing, serf.go:136-
    # 194): each server pings its same-region peers every probe_interval;
    # suspicion_threshold consecutive failures mark a member failed. The
    # leader reconciles membership (leader.go:263-343): failed members are
    # removed from the Raft configuration and reaped from the member table;
    # gossip-known members missing from Raft are added.
    probe_interval: float = 1.0
    probe_timeout: float = 1.0
    suspicion_threshold: int = 5
    # Keep retrying start_join addresses until one succeeds (the agent's
    # retry-join posture, command/agent/command.go).
    retry_join_interval: float = 2.0


class ClusterServer(Server):
    def __init__(self, config: Optional[ServerConfig] = None,
                 cluster: Optional[ClusterConfig] = None,
                 logger: Optional[logging.Logger] = None):
        self.cluster = cluster or ClusterConfig()
        super().__init__(config, logger)

        self.rpc = RPCServer(
            self.cluster.bind_host, self.cluster.bind_port,
            self.logger.getChild("rpc"),
        )
        self.rpc_addr = self.rpc.addr
        # One stream-multiplexed connection per peer carries control
        # traffic AND long-polls (Eval.Dequeue, blocking queries) — the
        # yamux posture (nomad/rpc.go:120-137); see nomad_tpu_torch/rpc.py.
        self.pool = ConnPool(timeout=5.0)

        if not self.cluster.node_id:
            self.cluster.node_id = self.config.node_name
        self.cluster.peers.setdefault(self.cluster.node_id, self.rpc_addr)
        # Cross-region federation table: region -> {node_id: rpc_addr}.
        # Raft membership stays per-region (the reference replicates within
        # a region and WAN-gossips across, server.go:503-538); only the
        # same-region branch of a join touches cluster.peers.
        self.region_peers: Dict[str, Dict[str, str]] = {
            self.config.region: self.cluster.peers
        }

        # Member liveness from the probing loop: node_id -> "alive"/"failed"
        # (absent = alive, never probed bad).
        self._member_status: Dict[str, str] = {}
        self._probe_failures: Dict[str, int] = {}

        # Replace the in-process replication layer with Raft. Raft keeps
        # its OWN peer table (seeded from the gossip view at start, then
        # changed only by committed _config entries via the leader's
        # reconciliation) — the gossip table converges eventually, the
        # Raft configuration changes one committed step at a time.
        self.raft = RaftNode(
            RaftConfig(
                node_id=self.cluster.node_id,
                peers={self.cluster.node_id: self.rpc_addr},
                heartbeat_interval=self.cluster.heartbeat_interval,
                election_timeout_min=self.cluster.election_timeout_min,
                election_timeout_max=self.cluster.election_timeout_max,
                data_dir=self.cluster.raft_data_dir,
                bootstrap_expect=max(self.cluster.bootstrap_expect, 1),
                snapshot_threshold=self.cluster.snapshot_threshold,
                snapshot_retain=self.cluster.snapshot_retain,
                trailing_logs=self.cluster.trailing_logs,
                snapshot_chunk_bytes=self.cluster.snapshot_chunk_bytes,
                seed=self.config.seed,
            ),
            self.fsm,
            self.rpc,
            logger=self.logger.getChild("raft"),
            # Raft keeps its own (shorter-timeout) pool.
            pool=ConnPool(timeout=2.0),
        )
        self.raft.on_leadership_change = self._leadership_changed
        # Only a current leader feeds its broker during FSM apply; raft role
        # flips synchronously under the raft lock, unlike the async
        # leadership notification that enables/disables the broker.
        self.fsm.enqueue_guard = lambda: self.raft.is_leader
        # Plan applier must ride the raft replication layer
        self.plan_applier.raft = self.raft
        self._register_endpoints()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.rpc.start()
        joined = not self.cluster.start_join
        for addr in self.cluster.start_join:
            try:
                n = self.join(addr)
                self.logger.info("cluster: joined %d peers via %s", n, addr)
                joined = True
            except RPCError as e:
                self.logger.warning("cluster: start_join %s failed: %s", addr, e)
        # Seed the Raft peer table from the gossip view as of startup;
        # later membership moves only via committed _config entries.
        self.raft.config.peers.update(self.cluster.peers)
        if not joined:
            threading.Thread(
                target=self._retry_join_loop, daemon=True,
                name=f"retry-join-{self.cluster.node_id}",
            ).start()
        threading.Thread(
            target=self._membership_loop, daemon=True,
            name=f"membership-{self.cluster.node_id}",
        ).start()
        self.raft.start()
        self.plan_applier.start()
        if self.slo_monitor is not None:
            self.slo_monitor.start()
        self.express_lane.start()
        self.capacity_accountant.start()
        self.raft_observatory.start()
        self.read_observatory.start()
        self.runtime_observatory.start()
        for i in range(self.config.scheduler_workers):
            worker = Worker(self, i)
            worker.start()
            self.workers.append(worker)
        reaper = threading.Thread(
            target=self._reap_failed_evaluations, daemon=True,
            name="failed-eval-reaper",
        )
        reaper.start()
        self._start_readmission()

    def shutdown(self, drain_timeout: float = 10.0) -> bool:
        """Stop the loop and leave the cluster (raft, RPC listener, peer
        connections) at once, then drain device work. The coalescer is
        process-wide and the surviving members keep solving on it, so the
        drain is bounded by ``drain_timeout`` and logged; returns whether
        it drained."""
        self._stop_loop()
        self.raft.shutdown()
        self.rpc.shutdown()
        self.pool.shutdown()
        return self._drain_device(drain_timeout)

    def _leadership_changed(self, is_leader: bool) -> None:
        """establishLeadership / revokeLeadership (leader.go:99-140,
        240-260)."""
        self.fsm.events.publish(
            "Leader", "LeaderAcquired" if is_leader else "LeaderLost",
            key=self.cluster.node_id,
            payload={"term": getattr(self.raft, "current_term", 0)},
        )
        if is_leader:
            self.logger.info("cluster: %s gained leadership",
                             self.cluster.node_id)
            # Leader barrier BEFORE enabling the broker (leader.go
            # establishLeadership's raft.Barrier): the FSM must contain
            # every entry committed by prior terms — in particular any
            # plan a dying leader applied for a still-pending eval — so
            # restore_eval_broker's wait_index covers it and no worker
            # schedules that eval against a pre-plan snapshot.
            try:
                self.raft.barrier(timeout=10.0)
            except Exception as e:
                # Stalled quorum; proceed — a low wait_index degrades to
                # the pre-barrier behavior rather than wedging leadership
                # establishment.
                self.logger.warning("cluster: leader barrier failed: %s", e)
            # Leadership callbacks run on unordered daemon threads: the
            # lose-handler may have fully run (disable+flush) DURING the
            # barrier. Enabling now would leave broker/plan queue live on
            # a follower — re-check before touching anything.
            if not self.raft.is_leader:
                self.logger.info(
                    "cluster: %s lost leadership during establishment",
                    self.cluster.node_id)
                return
            self.plan_queue.set_enabled(True)
            self.eval_broker.set_enabled(True)
            self.restore_eval_broker()
            # Renew heartbeat TTLs so nodes aren't marked down during the
            # transition (heartbeat.go:13-42): one batched arm, the same
            # per-node renewal as nomad_tpu's loop of single resets.
            self.heartbeat.reset_many([
                node.id for node in self.state_store.nodes()
                if not node.terminal_status()
            ])
            # The recovery timeline's terminal anchor: leadership is
            # established, the broker restored, TTLs renewed, so this
            # server schedules again (time-to-serving). Idempotent.
            self.raft.mark_serving()
        else:
            self.logger.info("cluster: %s lost leadership",
                             self.cluster.node_id)
            self.plan_queue.set_enabled(False)
            self.eval_broker.set_enabled(False)
            self.heartbeat.clear_all()
            # Express leases are leader-local promises against a view this
            # server no longer owns: drop them (counted). Pending express
            # commits reconcile to the new leader through the committer's
            # forward path.
            self.express_lane.demote()

    # -- forwarding (rpc.go:163-228) ------------------------------------------
    #
    # Forwarding audit: ONLY writes and leader-owned machinery cross the
    # wire from a follower — Eval.* broker ops, Plan.Submit,
    # Express.Reconcile, Job.*/Node.* mutations, and the linearizable
    # lane's Raft.ReadIndex (an index exchange, not the read itself).
    # Every read RPC in _register_endpoints below
    # (Node.GetAllocs, Eval.GetEval, Job.GetJob, Alloc.GetAlloc, Status.*)
    # runs against LOCAL state on whichever server was dialed.

    def _forward(self, method: str, args: dict,
                 timeout: Optional[float] = None):
        """Forward an RPC to the current leader. Waits briefly for leader
        discovery (a follower learns the leader from the first heartbeat of a
        term); raises NotLeaderError if none appears — callers back off and
        retry like the reference worker (worker.go:398-411).

        Undelivered requests (stale leader address across an election, a
        connection the peer closed before the frame went out) are retried
        twice against the freshly-discovered leader — the handler provably
        never ran, so even non-idempotent RPCs are safe to replay (the
        RPCUndeliveredError contract; policy shared with
        backoff.retry_undelivered). Timeouts and lost responses are NOT
        retried: the request may have executed, and the delivery
        guarantees belong to the caller (the broker's Nack machinery,
        raft-upsert idempotency)."""
        deadline = time.monotonic() + 1.0
        # Jittered, not flat: every follower worker forwarding to a dead
        # leader retries on this path at once, and the decorrelation is
        # what keeps the freshly-elected leader from absorbing a synchro-
        # nized thundering herd.
        retry_bo = Backoff(base=0.05, max_delay=0.5)
        discover_bo = Backoff(base=0.02, max_delay=0.2)
        # At most one retry per address: a severed-but-healthy leader conn
        # reconnects on the first retry; a blackholed leader (connect
        # timeout) must not burn attempt x connect-timeout before failing.
        undelivered_to: dict = {}
        while True:
            leader = self.raft.leader_addr
            if leader:
                try:
                    return self.pool.call(leader, method, args,
                                          timeout=timeout)
                except RemoteError as e:
                    # Recover typed rejections from the error envelope:
                    # the typed contract must not depend on which server
                    # the client dialed.
                    rejection = parse_reject(str(e))
                    if rejection is not None:
                        raise rejection from e
                    raise
                except RPCUndeliveredError:
                    if undelivered_to.get(leader, 0) >= 1 or \
                            len(undelivered_to) >= 3:
                        raise
                    undelivered_to[leader] = 1
                    deadline = time.monotonic() + 1.0
                    retry_bo.sleep()
                    continue
            if self.raft.is_leader or time.monotonic() >= deadline:
                raise NotLeaderError("")
            discover_bo.sleep()

    # -- overridden server seams ----------------------------------------------

    def eval_dequeue(self, schedulers: List[str], timeout: float):
        if self.raft.is_leader:
            return super().eval_dequeue(schedulers, timeout)
        out = self._forward(
            "Eval.Dequeue", {"schedulers": schedulers, "timeout": timeout},
            timeout=timeout + 5.0,
        )
        if out.get("eval") is None:
            return None, "", 0
        ev = from_dict(Evaluation, out["eval"])
        # Adopt the leader broker's root span context so this follower's
        # worker spans parent correctly across the RPC boundary.
        trace.get_tracer().adopt_root(ev.id, out.get("span_ctx") or {})
        return ev, out["token"], int(out.get("wait_index", 0))

    def eval_dequeue_batch(self, schedulers: List[str], max_batch: int,
                           timeout: float):
        if self.raft.is_leader:
            return super().eval_dequeue_batch(schedulers, max_batch, timeout)
        out = self._forward(
            "Eval.DequeueBatch",
            {"schedulers": schedulers, "max_batch": max_batch,
             "timeout": timeout},
            timeout=timeout + 5.0,
        )
        batch = []
        tracer = trace.get_tracer()
        for item in out["batch"]:
            ev = from_dict(Evaluation, item["eval"])
            tracer.adopt_root(ev.id, item.get("span_ctx") or {})
            batch.append((ev, item["token"],
                          int(item.get("wait_index", 0))))
        return batch

    def eval_ack(self, eval_id: str, token: str) -> None:
        if self.raft.is_leader:
            self.eval_broker.ack(eval_id, token)
            return
        self._forward("Eval.Ack", {"eval_id": eval_id, "token": token})

    def eval_nack(self, eval_id: str, token: str) -> None:
        if self.raft.is_leader:
            self.eval_broker.nack(eval_id, token)
            return
        self._forward("Eval.Nack", {"eval_id": eval_id, "token": token})

    def eval_touch(self, eval_id: str, token: str) -> None:
        if self.raft.is_leader:
            self.eval_broker.outstanding_reset(eval_id, token)
            return
        self._forward("Eval.Reset", {"eval_id": eval_id, "token": token})

    def eval_upsert(self, evals: List[Evaluation]) -> int:
        if self.raft.is_leader:
            return self.raft.apply("eval_update", {"evals": evals}).result()
        return self._forward(
            "Eval.Upsert", {"evals": [to_dict(e) for e in evals]}
        )

    def plan_submit(self, plan: Plan) -> PlanResult:
        if self.raft.is_leader:
            return self.plan_queue.enqueue(plan).wait()
        out = self._forward("Plan.Submit", {"plan": _stops_to_wire(plan)})
        return _stops_from_wire(PlanResult, out, self.state_store.alloc_by_id)

    def confirmed_read_index(self, timeout: float = 2.0) -> int:
        """The linearizable lane's read index: the leader confirms through
        its own read lease or a quorum round; a follower asks the leader
        over Raft.ReadIndex, the only read-path traffic that crosses the
        wire (the data is served from local state once applied catches
        up, read_path._await_read_index)."""
        if self.raft.is_leader:
            return self.raft.read_index(timeout=timeout)
        try:
            out = self._forward("Raft.ReadIndex", {"timeout": timeout},
                                timeout=timeout + 2.0)
        except RemoteError as e:
            # A leader-side refusal (deposed mid-call, stalled quorum)
            # crosses the wire untyped; surface it as the retriable
            # refusal the lane maps to a typed STALE_BOUND reject.
            raise TimeoutError(f"read index forward failed: {e}") from e
        return int(out["index"])

    def express_reconcile(self, job: Job, evals: List[Evaluation]) -> int:
        """Express slow-path reconciliation rides to the CURRENT leader: a
        deposed server's committer must be able to hand its uncommitted
        express placements over durably (server/express.py)."""
        if self.raft.is_leader:
            return super().express_reconcile(job, evals)
        return self._forward(
            "Express.Reconcile",
            {"job": to_dict(job), "evals": [to_dict(e) for e in evals]},
        )

    def job_register(self, job: Job, client_id: str = ""):
        # Cross-region submissions route to the owning region first
        # (rpc.go:163-177 forward: region mismatch -> forwardRegion).
        # client_id rides every hop so the LEADER sees the true submitter,
        # not the forwarding server.
        if job.region and job.region != self.config.region:
            out = self.forward_region(
                job.region, "Job.Register",
                {"job": to_dict(job), "client_id": client_id},
            )
            return out["eval_id"], out["index"]
        if self.raft.is_leader:
            return super().job_register(job, client_id=client_id)
        out = self._forward(
            "Job.Register", {"job": to_dict(job), "client_id": client_id}
        )
        return out["eval_id"], out["index"]

    def job_evaluate(self, job_id: str, client_id: str = ""):
        # Forward before checking anything locally: the leader's state
        # is the one that decides.
        if self.raft.is_leader:
            return super().job_evaluate(job_id, client_id=client_id)
        out = self._forward(
            "Job.Evaluate", {"job_id": job_id, "client_id": client_id}
        )
        return out["eval_id"], out["index"]

    def job_deregister(self, job_id: str):
        if self.raft.is_leader:
            return super().job_deregister(job_id)
        out = self._forward("Job.Deregister", {"job_id": job_id})
        return out["eval_id"], out["index"]

    def node_register(self, node: Node):
        if self.raft.is_leader:
            return super().node_register(node)
        return self._forward("Node.Register", {"node": to_dict(node)})

    def node_batch_register(self, nodes: List[Node]):
        if self.raft.is_leader:
            return super().node_batch_register(nodes)
        return self._forward(
            "Node.BatchRegister", {"nodes": [to_dict(n) for n in nodes]},
            # A whole tranche rides one frame; give the leader time to
            # apply + arm before the caller's deadline fires.
            timeout=30.0,
        )

    def node_batch_heartbeat(self, node_ids: List[str]):
        if self.raft.is_leader:
            return super().node_batch_heartbeat(node_ids)
        # Same extended deadline as BatchRegister: a tranche of non-ready
        # nodes costs the leader one raft apply + eval fan-out EACH.
        return self._forward("Node.BatchHeartbeat", {"node_ids": node_ids},
                             timeout=30.0)

    def node_update_status(self, node_id: str, status: str):
        if self.raft.is_leader:
            return super().node_update_status(node_id, status)
        return self._forward(
            "Node.UpdateStatus", {"node_id": node_id, "status": status}
        )

    def node_update_drain(self, node_id: str, drain: bool):
        if self.raft.is_leader:
            return super().node_update_drain(node_id, drain)
        return self._forward(
            "Node.UpdateDrain", {"node_id": node_id, "drain": drain}
        )

    def update_allocs_from_client(self, allocs: List[Allocation]) -> int:
        if self.raft.is_leader:
            return super().update_allocs_from_client(allocs)
        return self._forward(
            "Node.UpdateAlloc", {"allocs": [to_dict(a) for a in allocs]}
        )

    # -- RPC endpoint registration (server.go:130-137) -------------------------

    def _register_endpoints(self) -> None:
        r = self.rpc.register
        r("Status.Ping", lambda args: "pong")
        r("Status.Leader", lambda args: self.raft.leader_addr)
        r("Status.Peers", lambda args: list(self.cluster.peers.values()))
        r("Status.Stats", lambda args: {**self.stats(), **self.raft.stats()})
        r("Status.Regions", lambda args: self.regions())

        r("Eval.Dequeue", self._rpc_eval_dequeue)
        r("Eval.DequeueBatch", self._rpc_eval_dequeue_batch)
        r("Eval.Ack", lambda a: self.eval_ack(a["eval_id"], a["token"]))
        r("Eval.Nack", lambda a: self.eval_nack(a["eval_id"], a["token"]))
        r("Eval.Reset", lambda a: self.eval_touch(a["eval_id"], a["token"]))
        r("Eval.Upsert", lambda a: self.eval_upsert(
            [from_dict(Evaluation, e) for e in a["evals"]]
        ))
        r("Plan.Submit", self._rpc_plan_submit)
        r("Express.Reconcile", lambda a: self.express_reconcile(
            from_dict(Job, a["job"]),
            [from_dict(Evaluation, e) for e in a["evals"]],
        ))
        r("Job.Register", self._rpc_job_register)
        r("Job.Evaluate", self._rpc_job_evaluate)
        r("Job.Deregister", self._rpc_job_deregister)
        r("Node.Register", lambda a: self.node_register(from_dict(Node, a["node"])))
        r("Node.BatchRegister", lambda a: self.node_batch_register(
            [from_dict(Node, n) for n in a["nodes"]]
        ))
        r("Node.BatchHeartbeat", lambda a: self.node_batch_heartbeat(
            list(a["node_ids"])
        ))
        r("Node.UpdateStatus", lambda a: self.node_update_status(
            a["node_id"], a["status"]
        ))
        r("Node.UpdateDrain", lambda a: self.node_update_drain(
            a["node_id"], a["drain"]
        ))
        r("Node.UpdateAlloc", lambda a: self.update_allocs_from_client(
            [from_dict(Allocation, x) for x in a["allocs"]]
        ))
        r("Node.GetAllocs", self._rpc_node_get_allocs)
        r("Eval.GetEval", self._rpc_eval_get)
        r("Job.GetJob", self._rpc_job_get)
        r("Alloc.GetAlloc", self._rpc_alloc_get)
        r("Serf.Join", self._rpc_serf_join)
        r("Serf.PeerUpdate", self._rpc_serf_peer_update)

    def _rpc_eval_dequeue(self, args: dict):
        ev, token, wait_index = self.eval_dequeue(
            args["schedulers"], min(float(args.get("timeout", 0.5)), 10.0)
        )
        if ev is None:
            return {"eval": None, "token": ""}
        return {"eval": to_dict(ev), "token": token,
                "wait_index": wait_index,
                "span_ctx": trace.get_tracer().root_ctx(ev.id)}

    def _rpc_eval_dequeue_batch(self, args: dict):
        batch = self.eval_dequeue_batch(
            args["schedulers"], int(args.get("max_batch", 1)),
            min(float(args.get("timeout", 0.5)), 10.0),
        )
        tracer = trace.get_tracer()
        return {"batch": [
            {"eval": to_dict(ev), "token": token, "wait_index": wait_index,
             "span_ctx": tracer.root_ctx(ev.id)}
            for ev, token, wait_index in batch
        ]}

    def _rpc_plan_submit(self, args: dict):
        plan = _stops_from_wire(Plan, args["plan"],
                                self.state_store.alloc_by_id)
        return _stops_to_wire(self.plan_submit(plan))

    def _rpc_job_register(self, args: dict):
        eval_id, index = self.job_register(
            from_dict(Job, args["job"]),
            client_id=str(args.get("client_id", "") or ""),
        )
        return {"eval_id": eval_id, "index": index}

    def _rpc_job_evaluate(self, args: dict):
        eval_id, index = self.job_evaluate(
            args["job_id"],
            client_id=str(args.get("client_id", "") or ""),
        )
        return {"eval_id": eval_id, "index": index}

    def _rpc_job_deregister(self, args: dict):
        eval_id, index = self.job_deregister(args["job_id"])
        return {"eval_id": eval_id, "index": index}

    def _rpc_node_get_allocs(self, args: dict):
        """Blocking Node.GetAllocs (node_endpoint.go:328) over the shared
        blocking_query machinery (server/blocking.py; rpc.go:270-335).
        Served from local (possibly follower) state — the stale-read
        path.

        The index is the node's own, as upstream's GetAllocs computes it:
        the highest modify index among the node's allocs, or the allocs
        table's index when it has none. nomad_tpu answers with the table
        index, so a write to any node's allocs sends every parked client
        its whole alloc list again: eight clients re-listing on each
        other's status reports saturated the interpreter."""
        node_id = args["node_id"]
        min_index = int(args.get("min_index", 0))

        def run(store):
            allocs = store.allocs_by_node(node_id)
            if allocs:
                return max(a.modify_index for a in allocs), allocs
            return store.get_index("allocs") or 1, allocs

        index, allocs = blocking_query(
            get_store=lambda: self.state_store,
            items=lambda store: [item_alloc_node(node_id)],
            run=run,
            min_index=min_index,
            timeout=float(args.get("timeout", 0.5)),
        )
        if index <= min_index:
            return {"allocs": None, "index": index}
        return {"allocs": [to_dict(a) for a in allocs], "index": index}

    def _rpc_eval_get(self, args: dict):
        """Blocking Eval.GetEval (eval_endpoint.go GetEval + rpc.go
        blockingRPC): long-poll an evaluation's modify index — the RPC-tier
        feed for eval monitors."""
        eval_id = args["eval_id"]
        min_index = int(args.get("min_index", 0))

        def run(store):
            ev = store.eval_by_id(eval_id)
            if ev is None:
                # Not-yet-created evals resolve on the table index, like
                # the reference's table-default QueryMeta.Index.
                return store.get_index("evals"), None
            return ev.modify_index, ev

        # item_eval fires on create, update, AND delete (store.py
        # upsert_evals/delete_eval), so the table-wide item is unnecessary
        # — and watching it would wake every parked monitor on every
        # unrelated eval write.
        index, ev = blocking_query(
            get_store=lambda: self.state_store,
            items=lambda store: [item_eval(eval_id)],
            run=run,
            min_index=min_index,
            timeout=float(args.get("timeout", 0.5)),
        )
        return {"eval": None if ev is None else to_dict(ev), "index": index}

    def _rpc_job_get(self, args: dict):
        """Blocking Job.GetJob (job_endpoint.go GetJob + rpc.go
        blockingRPC)."""
        job_id = args["job_id"]
        min_index = int(args.get("min_index", 0))

        def run(store):
            job = store.job_by_id(job_id)
            if job is None:
                return store.get_index("jobs"), None
            return job.modify_index, job

        index, job = blocking_query(
            get_store=lambda: self.state_store,
            items=lambda store: [item_job(job_id)],
            run=run,
            min_index=min_index,
            timeout=float(args.get("timeout", 0.5)),
        )
        return {"job": None if job is None else to_dict(job), "index": index}

    def _rpc_alloc_get(self, args: dict):
        alloc = self.state_store.alloc_by_id(args["alloc_id"])
        return None if alloc is None else to_dict(alloc)

    # -- membership (serf-lite; reference: nomad/serf.go + hashicorp/serf) ----

    def _retry_join_loop(self) -> None:
        """Keep retrying start_join until one address answers
        (command/agent/command.go retry-join)."""
        while not self._periodic_stop.is_set():
            self._periodic_stop.wait(self.cluster.retry_join_interval)
            if self._periodic_stop.is_set():
                return
            for addr in self.cluster.start_join:
                try:
                    n = self.join(addr)
                    self.logger.info(
                        "cluster: retry-join reached %d peers via %s", n, addr
                    )
                    return
                except RPCError:
                    continue

    def _membership_loop(self) -> None:
        """Failure detector + leader reconciliation (serf.go:136-194 member
        probing -> nodeFailed; leader.go:263-343 reconcile)."""
        leaderless_since = None
        while not self._periodic_stop.is_set():
            self._periodic_stop.wait(self.cluster.probe_interval)
            if self._periodic_stop.is_set():
                return
            try:
                self._probe_members()
                if self.raft.is_leader:
                    leaderless_since = None
                    self._reconcile_membership()
                elif self.raft.leader_addr:
                    leaderless_since = None
                else:
                    # No leader known. A server that was removed while
                    # partitioned (it never saw its own removal commit and
                    # members ignore its votes) self-heals here: re-join
                    # through gossip so the leader's reconciliation re-adds
                    # it to the Raft configuration.
                    now = time.monotonic()
                    if leaderless_since is None:
                        leaderless_since = now
                    elif now - leaderless_since > max(
                        5 * self.cluster.probe_interval, 3.0
                    ):
                        leaderless_since = now
                        self._rejoin_any_member()
            except Exception:  # pragma: no cover - keep the loop alive
                self.logger.exception("cluster: membership pass failed")

    def _rejoin_any_member(self) -> None:
        for pid, addr in list(self.cluster.peers.items()):
            if pid == self.cluster.node_id:
                continue
            if self._member_status.get(pid) == "failed":
                continue
            try:
                self.join(addr)
                self.logger.info(
                    "cluster: leaderless; re-announced to %s via gossip", pid
                )
                return
            except (RPCError, RemoteError):
                continue

    def _probe_members(self) -> None:
        for pid, addr in list(self.cluster.peers.items()):
            if pid == self.cluster.node_id:
                continue
            try:
                self.pool.call(
                    addr, "Status.Ping", {},
                    timeout=self.cluster.probe_timeout,
                )
            except (RPCError, RemoteError):
                n = self._probe_failures.get(pid, 0) + 1
                self._probe_failures[pid] = n
                if (n >= self.cluster.suspicion_threshold
                        and self._member_status.get(pid) != "failed"):
                    self._member_status[pid] = "failed"
                    self.logger.warning(
                        "cluster: member %s failed (%d missed probes)",
                        pid, n,
                    )
            else:
                self._probe_failures.pop(pid, None)
                if self._member_status.get(pid) == "failed":
                    self.logger.info("cluster: member %s recovered", pid)
                self._member_status[pid] = "alive"

    def _reconcile_membership(self) -> None:
        """Leader-only: converge the Raft configuration with the gossip
        member table, one committed change at a time (leader.go:263-343;
        Raft single-server membership change)."""
        raft_peers = dict(self.raft.config.peers)
        # Members known to gossip but absent from Raft: add (nodeJoin ->
        # addRaftPeer, serf.go:76-134).
        for pid, addr in list(self.cluster.peers.items()):
            if pid in raft_peers or self._member_status.get(pid) == "failed":
                continue
            try:
                self.raft.add_peer(pid, addr).result(2.0)
                self.logger.info("cluster: added raft peer %s", pid)
            except Exception as e:
                self.logger.debug("cluster: add_peer %s deferred: %s", pid, e)
                return
        # Failed members still in Raft: remove and reap from the member
        # table (nodeFailed -> removeRaftPeer, serf.go:136-194).
        for pid in list(raft_peers):
            if pid == self.cluster.node_id:
                continue
            if self._member_status.get(pid) != "failed":
                continue
            try:
                self.raft.remove_peer(pid).result(2.0)
            except Exception as e:
                self.logger.debug(
                    "cluster: remove_peer %s deferred: %s", pid, e
                )
                return
            self.cluster.peers.pop(pid, None)
            self.logger.warning(
                "cluster: reaped failed member %s (now %d members)",
                pid, len(self.cluster.peers),
            )
            self._broadcast_peers()

    def join(self, addr: str) -> int:
        """Join an existing cluster member at ``addr`` (serf gossip join →
        nodeJoin → Raft peer add, serf.go:76-134). Joining a server of
        another region federates (region table only); same region adds
        raft peers. Returns servers joined."""
        out = self.pool.call(
            addr, "Serf.Join",
            {
                "node_id": self.cluster.node_id,
                "addr": self.rpc_addr,
                "region": self.config.region,
            },
        )
        peers = out.get("peers", {})
        self._merge_peers(peers)
        self._merge_region_peers(out.get("regions", {}))
        return len(peers) + sum(
            len(m) for r, m in out.get("regions", {}).items()
            if r != self.config.region
        )

    def force_leave(self, node_id: str) -> None:
        """Remove a member and broadcast the removal (serf.go nodeFailed /
        server-force-leave). Marks the member failed so the leader's
        reconciliation also drops it from the Raft configuration."""
        self.cluster.peers.pop(node_id, None)
        self._member_status[node_id] = "failed"
        if self.raft.is_leader and node_id in self.raft.config.peers:
            try:
                self.raft.remove_peer(node_id).result(2.0)
            except Exception as e:
                self.logger.warning(
                    "cluster: force-leave raft removal of %s deferred: %s",
                    node_id, e,
                )
        self._broadcast_peers()

    def members(self):
        return [
            {
                "name": pid,
                "addr": addr,
                "status": self._member_status.get(pid, "alive"),
                "leader": addr == self.raft.leader_addr,
            }
            for pid, addr in sorted(self.cluster.peers.items())
        ]

    def _merge_peers(self, peers: Dict[str, str]) -> None:
        before = dict(self.cluster.peers)
        self.cluster.peers.update(peers)
        if self.cluster.peers != before:
            self.logger.info(
                "cluster: peer set now %s", sorted(self.cluster.peers)
            )
            # Pre-bootstrap, discovered members seed Raft directly so the
            # first election can reach bootstrap_expect (maybeBootstrap);
            # afterwards the leader commits the additions.
            self.raft.seed_peers(dict(self.cluster.peers))

    def _merge_region_peers(self, regions: Dict[str, Dict[str, str]]) -> None:
        for region, members in regions.items():
            if region == self.config.region:
                continue  # own region raft membership only moves via joins
            self.region_peers.setdefault(region, {}).update(members)

    def _region_table(self) -> Dict[str, Dict[str, str]]:
        return {region: dict(m) for region, m in self.region_peers.items()}

    def regions(self) -> List[str]:
        """Known federated regions (reference: region tables built from serf
        tags, nomad/serf.go nodeJoin)."""
        return sorted(self.region_peers)

    def forward_region(self, region: str, method: str, args: dict):
        """RPC to any server of another region (rpc.go:204-228
        forwardRegion picks a random server from the region table)."""
        members = self.region_peers.get(region)
        if not members:
            raise RPCError(f"no path to region {region!r}")
        addrs = list(members.values())
        # Load-spreading shuffle over region servers; a per-instance
        # name-salted stream decorrelates successive forwards without
        # the global random cursor.
        rng = getattr(self, "_region_rng", None)
        if rng is None:
            rng = self._region_rng = prng.stream(
                prng.salt(self.config.node_name), "cluster.forward_region"
            )
        rng.shuffle(addrs)
        last: Optional[Exception] = None
        for addr in addrs:
            try:
                return self.pool.call(addr, method, args)
            except RemoteError as e:
                # Typed rejection from the remote region: surface it typed
                # (and final — another server of the same region would
                # consult the same leader).
                rejection = parse_reject(str(e))
                if rejection is not None:
                    raise rejection from e
                last = e
            except RPCError as e:
                last = e
        raise last

    def _broadcast_peers(self) -> None:
        snapshot = dict(self.cluster.peers)
        regions = self._region_table()
        targets = dict(snapshot)
        for members in regions.values():
            targets.update(members)
        for pid, addr in list(targets.items()):
            if pid == self.cluster.node_id:
                continue
            try:
                self.pool.call(
                    addr, "Serf.PeerUpdate",
                    {"peers": snapshot, "regions": regions,
                     "region": self.config.region},
                )
            except RPCError:
                pass  # gossip is best-effort; next join/update converges

    def _rpc_serf_join(self, args: dict):
        joiner_region = args.get("region", self.config.region)
        if joiner_region == self.config.region:
            self._merge_peers({args["node_id"]: args["addr"]})
        else:
            self.region_peers.setdefault(joiner_region, {})[
                args["node_id"]
            ] = args["addr"]
        self._broadcast_peers()
        return {
            "peers": dict(self.cluster.peers)
            if joiner_region == self.config.region
            else {},
            "regions": self._region_table(),
        }

    def _rpc_serf_peer_update(self, args: dict):
        sender_region = args.get("region", self.config.region)
        if sender_region == self.config.region:
            self._merge_peers(dict(args.get("peers", {})))
        else:
            self.region_peers.setdefault(sender_region, {}).update(
                args.get("peers", {})
            )
        self._merge_region_peers(dict(args.get("regions", {})))
        return {}


def _stops_to_wire(obj) -> dict:
    """A Plan or PlanResult as its wire dict, with the stop copies of
    ``node_update`` as id runs (structs.stop_runs), so a deregister of a
    100,000-task job fits one RPC frame."""
    flat = [a for allocs in obj.node_update.values() for a in allocs]
    runs, rest = stop_runs(flat)
    node_update: Dict[str, List[Allocation]] = {}
    for a in rest:
        node_update.setdefault(a.node_id, []).append(a)
    out = to_dict(dataclasses.replace(obj, node_update=node_update))
    if runs:
        out["node_update_stopped"] = runs
    return out


def _stops_from_wire(cls, data: dict, lookup):
    """Inverse of _stops_to_wire against the receiver's store."""
    obj = from_dict(cls, data)
    for a in expand_stop_runs(data.get("node_update_stopped") or [], lookup):
        obj.node_update.setdefault(a.node_id, []).append(a)
    return obj


def form_cluster(
    n: int,
    server_config: Optional[ServerConfig] = None,
    base_cluster: Optional[ClusterConfig] = None,
    logger: Optional[logging.Logger] = None,
) -> List[ClusterServer]:
    """Build an n-server cluster on localhost with a shared static peer set
    (the in-process multi-server posture of upstream server tests,
    nomad/server_test.go:26-87). Every member takes ``server_config``'s
    device: pass ``ServerConfig(device="cpu")`` where there is no card."""
    servers: List[ClusterServer] = []
    peers: Dict[str, str] = {}
    for i in range(n):
        cfg = copy.deepcopy(server_config) if server_config else ServerConfig()
        cfg.node_name = f"server-{i}"
        cluster = copy.deepcopy(base_cluster) if base_cluster else ClusterConfig()
        cluster.node_id = cfg.node_name
        cluster.peers = peers  # shared dict: filled as servers bind
        srv = ClusterServer(cfg, cluster, logger)
        servers.append(srv)
    for srv in servers:
        srv.start()
    return servers


def wait_for_leader(servers: List[ClusterServer], timeout: float = 10.0):
    """testutil.WaitForLeader (testutil/wait.go:33)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for srv in servers:
            if srv.raft.is_leader:
                return srv
        time.sleep(0.02)
    raise TimeoutError("no cluster leader elected")
