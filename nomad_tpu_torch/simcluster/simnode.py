"""SimNode fleet: thousands of in-process node agents on shared RPC conns.

Port of nomad_tpu/simcluster/simnode.py over the port's RPC tier
(``nomad_tpu_torch.rpc.ConnPool``): the same fleet, ids and RPCs.

A real client (``nomad_tpu/client/client.py``, not ported yet) carries an
AllocRunner, TaskRunner, fingerprint probes and a persistence layer —
~none of which load the CONTROL PLANE. A SimNode is only the parts the
server can see: a fingerprint-shaped registration, TTL heartbeat
renewals, and alloc acknowledgement. That reduction is what lets one
test process sustain 10k live nodes against a real ``ClusterServer``:

- **Batched registration**: tranches of nodes ride one ``Node.BatchRegister``
  RPC each (one raft entry + one heartbeat-manager lock hold per tranche,
  server/server.py:node_batch_register) instead of 10k individual applies.
- **Shared connections**: all nodes multiplex over ``n_conns`` pooled
  stream-multiplexed connections (rpc.py ConnPool — the yamux posture),
  not one socket per node.
- **Heap-paced heartbeats**: one thread holds a (due, node_id) heap and
  renews due nodes in ``Node.BatchHeartbeat`` tranches at
  ``beat_fraction`` of each node's granted TTL — the same aggregate load
  a fleet of real clients produces, without 10k beat threads.

``fail(node_ids)`` silences nodes (beats stop; the server's TTL expiry
marks them down through the REAL heartbeat wheel) — the node-failure
half of the churn scenarios.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

from nomad_tpu_torch import structs
from nomad_tpu_torch.api.codec import to_dict
from nomad_tpu_torch.rpc import ConnPool, RPCError
from nomad_tpu_torch.structs import Node, Resources

DEFAULT_BATCH = 500


def sim_node(i: int, datacenter: str = "dc1", cpu: int = 4000,
             memory_mb: int = 8192) -> Node:
    """One fingerprint-shaped node (mock.node()'s cluster shape, with a
    deterministic id so seeded runs replay the same fleet)."""
    return Node(
        id=f"sim-{i:05d}",
        datacenter=datacenter,
        name=f"sim-{i:05d}",
        attributes={
            "kernel.name": "linux",
            "arch": "amd64",
            "driver.exec": "1",
            "driver.raw_exec": "1",
        },
        resources=Resources(
            cpu=cpu, memory_mb=memory_mb, disk_mb=100 * 1024, iops=150,
        ),
        status=structs.NODE_STATUS_READY,
    )


class SimFleet:
    """A fleet of SimNodes against one server RPC address."""

    def __init__(self, addr: str, n_conns: int = 2,
                 batch_size: int = DEFAULT_BATCH,
                 beat_fraction: float = 0.8,
                 tick: float = 0.25,
                 rpc_timeout: float = 30.0,
                 logger: Optional[logging.Logger] = None):
        self.addr = addr
        self.batch_size = max(1, int(batch_size))
        # Beat late in the granted TTL: the rate cap the server computes
        # (rate_scaled_interval) assumes ~one renewal per TTL; beating at
        # half the TTL would double the leader-side reset load.
        self.beat_fraction = min(max(beat_fraction, 0.1), 0.95)
        self.tick = tick
        self.rpc_timeout = rpc_timeout
        self.logger = logger or logging.getLogger(
            "nomad_tpu_torch.simfleet")
        # The "small number of shared RPC connections": each ConnPool holds
        # one multiplexed conn per address; round-robining K pools spreads
        # frame serialization across K sockets.
        self._pools = [ConnPool(timeout=rpc_timeout)
                       for _ in range(max(1, n_conns))]
        self._rr = 0
        self._lock = threading.Lock()
        # node_id -> granted ttl (0.0-grants keep the previous cadence,
        # the client.py `if ttl:` posture).
        self.granted: Dict[str, float] = {}
        self._failed: set = set()
        # (due, node_id) beat schedule.
        self._due: List[tuple] = []
        self._stop = threading.Event()
        self._beater: Optional[threading.Thread] = None
        # Counters for the scenario artifact.
        self.beats_sent = 0
        self.beat_batches = 0
        self.beat_errors = 0
        self.acked_allocs = 0

    def _pool(self) -> ConnPool:
        with self._lock:
            self._rr += 1
            return self._pools[self._rr % len(self._pools)]

    # -- registration -------------------------------------------------------

    def register(self, nodes: Sequence[Node]) -> Dict:
        """Register ``nodes`` in batched tranches. Returns
        {"seconds", "nodes_per_sec", "batches"}; granted TTLs arm the beat
        schedule."""
        start = time.perf_counter()
        batches = 0
        for lo in range(0, len(nodes), self.batch_size):
            tranche = nodes[lo:lo + self.batch_size]
            out = self._pool().call(
                self.addr, "Node.BatchRegister",
                {"nodes": [to_dict(n) for n in tranche]},
                timeout=self.rpc_timeout,
            )
            batches += 1
            ttls = out.get("heartbeat_ttls", {})
            # Deadline base = THIS tranche's grant time: a multi-second
            # bring-up must not make late tranches beat at 0.3x their TTL
            # (which would inflate the leader-side renewal transient).
            now = time.monotonic()
            with self._lock:
                for nid, ttl in ttls.items():
                    ttl = float(ttl)
                    if ttl <= 0:
                        continue
                    self.granted[nid] = ttl
                    heapq.heappush(
                        self._due, (now + self.beat_fraction * ttl, nid)
                    )
        seconds = time.perf_counter() - start
        return {
            "n": len(nodes),
            "seconds": round(seconds, 3),
            "nodes_per_sec": round(len(nodes) / seconds, 1) if seconds else 0,
            "batches": batches,
        }

    # -- heartbeats ---------------------------------------------------------

    def start_heartbeats(self) -> None:
        if self._beater is not None:
            return
        self._beater = threading.Thread(
            target=self._beat_loop, daemon=True, name="simfleet-beats",
        )
        self._beater.start()

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.tick):
            now = time.monotonic()
            due: List[str] = []
            with self._lock:
                while self._due and self._due[0][0] <= now:
                    _, nid = heapq.heappop(self._due)
                    if nid in self._failed or nid not in self.granted:
                        continue
                    due.append(nid)
            for lo in range(0, len(due), self.batch_size):
                tranche = due[lo:lo + self.batch_size]
                try:
                    out = self._pool().call(
                        self.addr, "Node.BatchHeartbeat",
                        {"node_ids": tranche}, timeout=self.rpc_timeout,
                    )
                except RPCError as e:
                    self.beat_errors += 1
                    self.logger.debug("simfleet: beat tranche failed: %s", e)
                    # Re-queue quickly; a real client keeps beating at its
                    # stale cadence through transient failures.
                    with self._lock:
                        for nid in tranche:
                            heapq.heappush(
                                self._due, (now + self.tick * 2, nid)
                            )
                    continue
                self.beat_batches += 1
                self.beats_sent += len(tranche)
                ttls = out.get("heartbeat_ttls", {})
                with self._lock:
                    for nid in tranche:
                        if nid in self._failed:
                            continue
                        ttl = float(ttls.get(nid, 0.0) or 0.0)
                        if ttl > 0:
                            self.granted[nid] = ttl
                        else:
                            # 0.0 grant (dropped renewal / unknown): keep
                            # the stale cadence, like client.py.
                            ttl = self.granted.get(nid, 0.0)
                            if ttl <= 0:
                                continue
                        heapq.heappush(
                            self._due,
                            (time.monotonic() + self.beat_fraction * ttl,
                             nid),
                        )

    def scheduled_renewals_per_sec(self) -> float:
        """The steady-state leader-side timer-reset rate this fleet is
        scheduled to produce: Σ 1/(beat_fraction·ttl) over live nodes.
        This is the measurable form of the rate_scaled_interval cap at
        production TTLs (200s+ at 10k nodes) — waiting out a real window
        would take minutes; the grants bound the rate exactly."""
        with self._lock:
            return sum(
                1.0 / (self.beat_fraction * ttl)
                for nid, ttl in self.granted.items()
                if ttl > 0 and nid not in self._failed
            )

    # -- failure churn ------------------------------------------------------

    def fail(self, node_ids: Iterable[str]) -> None:
        """Stop beating these nodes. Their armed server-side TTLs run out
        through the real heartbeat wheel and the node-down eval fan-out
        follows (heartbeat.go:84-104 posture)."""
        with self._lock:
            self._failed.update(node_ids)

    def live_nodes(self) -> List[str]:
        with self._lock:
            return [n for n in self.granted if n not in self._failed]

    # -- alloc acknowledgement ----------------------------------------------

    def ack_allocs(self, allocs, client_status: str = "running") -> int:
        """Acknowledge allocations the way a client agent does: stamp
        client_status and push ``Node.UpdateAlloc`` batches (the
        alloc_client_update raft path). Returns the number acked."""
        acked = 0
        for lo in range(0, len(allocs), self.batch_size):
            tranche = []
            for a in allocs[lo:lo + self.batch_size]:
                a = a.copy()
                a.client_status = client_status
                tranche.append(to_dict(a))
            self._pool().call(
                self.addr, "Node.UpdateAlloc", {"allocs": tranche},
                timeout=self.rpc_timeout,
            )
            acked += len(tranche)
        self.acked_allocs += acked
        return acked

    # -- lifecycle ----------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        if self._beater is not None:
            self._beater.join(timeout=2.0)
        for pool in self._pools:
            pool.shutdown()
