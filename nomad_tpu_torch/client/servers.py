"""Client→server endpoints: in-process short-circuit or network RPC.

The reference client talks to servers through one seam, ``Client.RPC``
(upstream client/client.go:210-214): either a test/in-process
``RPCHandler`` (client/config/config.go:44-46) or msgpack-RPC over the
connection pool to a configured server list with failover
(client.go:226-253 picks a random server, rotates on failure).

``InProcessEndpoint`` is the RPCHandler posture; ``RemoteEndpoint`` is the
network posture. Both expose the same surface, including the blocking
allocation watch that powers client.go:629-675 (server side:
Node.GetAllocs with MinQueryIndex, node_endpoint.go:328).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from nomad_tpu_torch import prng
from nomad_tpu_torch.api.codec import from_dict, to_dict
from nomad_tpu_torch.backoff import Backoff
from nomad_tpu_torch.rpc import ConnPool, RPCError
from nomad_tpu_torch.structs import Allocation, Node

WATCH_POLL_LIMIT = 10.0  # max single blocking-query duration
# How long a Node.UpdateAlloc waits for its reply. nomad_tpu's calls time
# out with the pool (5 s), but a timed-out update may still be applied
# after the alloc's next one, leaving a stale client status; upstream's
# RPC waits for the reply.
UPDATE_ALLOC_TIMEOUT = 120.0


class InProcessEndpoint:
    """Direct method calls into an in-process Server (dev mode / tests)."""

    def __init__(self, server):
        self.server = server

    def node_register(self, node: Node) -> dict:
        return self.server.node_register(node)

    def node_update_status(self, node_id: str, status: str) -> dict:
        return self.server.node_update_status(node_id, status)

    def node_heartbeat(self, node_id: str) -> float:
        return self.server.node_heartbeat(node_id)

    def update_allocs(self, allocs: List[Allocation]) -> int:
        return self.server.update_allocs_from_client(allocs)

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self.server.state_store.alloc_by_id(alloc_id)

    def get_allocs_blocking(
        self, node_id: str, cursor, timeout: float
    ) -> Tuple[Optional[List[Allocation]], object]:
        """Blocking alloc query against the local state watch. ``cursor`` is
        an opaque change marker; returns (allocs|None-if-unchanged, cursor)."""
        import time as _time

        from nomad_tpu_torch.state.store import item_alloc_node

        item = item_alloc_node(node_id)
        end = _time.monotonic() + timeout
        while True:
            # Re-read the store each pass: a raft snapshot install rebinds
            # fsm.state, and a watch parked on the orphaned store would
            # never fire again. Register (sampling the coalesced
            # registry's bucket generations) before reading so a write
            # between read and wait still wakes us.
            store = self.server.state_store
            ticket = store.watch.register([item])
            try:
                allocs = store.allocs_by_node(node_id)
                view = frozenset((a.id, a.modify_index) for a in allocs)
                if view != cursor:
                    return allocs, view
                remaining = end - _time.monotonic()
                if remaining <= 0:
                    return None, cursor
                # Identity re-check closes the register-vs-rebind race; a
                # rebind after registration fires notify_all on the old
                # store, so a full-length wait is safe.
                if self.server.state_store is store:
                    store.watch.wait(ticket, timeout=remaining)
            finally:
                store.watch.unregister(ticket)


class RemoteEndpoint:
    """Network RPC to a server list with rotation on failure
    (client.go:226-253; pool: nomad/pool.go)."""

    def __init__(self, servers: List[str], timeout: float = 5.0,
                 ssl_context=None):
        if not servers:
            raise ValueError("RemoteEndpoint requires at least one server addr")
        self.servers = list(servers)
        # Spread clients over the servers: each endpoint draws its own
        # order from a named stream (no process-global random).
        prng.stream(id(self), "client.servers").shuffle(self.servers)
        # One stream-multiplexed connection per server: blocking queries
        # interleave with control traffic on the same conn (nomad_tpu_torch/rpc.py).
        self.pool = ConnPool(timeout=timeout, ssl_context=ssl_context)

    def shutdown(self) -> None:
        self.pool.shutdown()

    def _call(self, method: str, args: dict,
              timeout: Optional[float] = None):
        last: Optional[Exception] = None
        for _ in range(len(self.servers)):
            addr = self.servers[0]
            try:
                # One IMMEDIATE same-server replay for provably-
                # undelivered frames (a severed pooled conn re-dials on
                # retry; the handler never ran, rpc.py:78-83) BEFORE
                # burning the rotation — a healthy server must not be
                # skipped over a stale connection. No sleep: the replay
                # either re-dials instantly or fails instantly, and a
                # dead server should rotate without added latency.
                # Timeouts/lost responses rotate immediately.
                return self.pool.call_retry(
                    addr, method, args, timeout=timeout, retries=1,
                    backoff=Backoff(base=0.0, jitter=0.0),
                )
            except RPCError as e:
                last = e
                # Rotate the failed server to the back (client.go:246-252)
                self.servers.append(self.servers.pop(0))
        raise last if last is not None else RPCError("no servers")

    def node_register(self, node: Node) -> dict:
        return self._call("Node.Register", {"node": to_dict(node)})

    def node_update_status(self, node_id: str, status: str) -> dict:
        return self._call(
            "Node.UpdateStatus", {"node_id": node_id, "status": status}
        )

    def node_heartbeat(self, node_id: str) -> float:
        reply = self.node_update_status(node_id, "ready")
        return float(reply.get("heartbeat_ttl", 0.0) or 0.0)

    def update_allocs(self, allocs: List[Allocation]) -> int:
        return self._call(
            "Node.UpdateAlloc", {"allocs": [to_dict(a) for a in allocs]},
            timeout=UPDATE_ALLOC_TIMEOUT,
        )

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        out = self._call("Alloc.GetAlloc", {"alloc_id": alloc_id})
        if out is None:
            return None
        return from_dict(Allocation, out)

    def get_allocs_blocking(
        self, node_id: str, cursor, timeout: float
    ) -> Tuple[Optional[List[Allocation]], object]:
        """Node.GetAllocs with MinQueryIndex (node_endpoint.go:328): the
        server holds the request until the allocs table passes the cursor
        index or the timeout lapses."""
        min_index = int(cursor or 0)
        timeout = min(timeout, WATCH_POLL_LIMIT)
        out = self._call(
            "Node.GetAllocs",
            {"node_id": node_id, "min_index": min_index, "timeout": timeout},
            timeout=timeout + 5.0,
        )
        index = int(out.get("index", 0))
        if out.get("allocs") is None:
            return None, max(min_index, index)
        allocs = [from_dict(Allocation, a) for a in out["allocs"]]
        return allocs, index
