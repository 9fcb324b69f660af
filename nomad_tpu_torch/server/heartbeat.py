"""Leader-side node heartbeat TTL tracking.

Port of nomad_tpu/server/heartbeat.py (upstream nomad/heartbeat.go).
Each ready node gets a TTL timer; a missed heartbeat marks the node down,
which fans out node-update evaluations (node_endpoint.go:459-551) so
schedulers migrate its allocs.
TTLs are rate-scaled so total heartbeats/sec stays bounded
(heartbeat.go:52-54, util.go:123).

Scale posture: the reference arms one ``time.AfterFunc`` per node; the
first cut here mirrored that with one ``threading.Timer`` per node — which
is one OS THREAD per node in CPython, and a 10k-node cluster (the
north-star scale, driven by nomad_tpu's simcluster) would sit on 10k
parked threads just to wait for TTLs. This version is a timer wheel: all
deadlines live in one heap serviced by a single daemon thread; arming,
renewing and cancelling are O(log n) heap pushes guarded by one lock.
Stale heap entries (superseded by a later renewal or a cancel) are
lazily discarded by generation check when they surface.

Counters (the simcluster scenario runner's heartbeat-load feed): ``arms``
(first timer for a node), ``renewals`` (an existing timer re-armed — the
leader-side "timer resets" the ≤ max_heartbeats_per_second cap is about),
``expirations``. Renewals also count into telemetry
(``heartbeat.renewal``).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Dict, List, Tuple

from nomad_tpu_torch import faults, prng, telemetry
from nomad_tpu_torch.structs import NODE_STATUS_DOWN


def rate_scaled_interval(rate: float, min_interval: float, count: int) -> float:
    """Scale the heartbeat interval so ``count`` nodes produce at most
    ``rate`` heartbeats/sec (reference: nomad/util.go:110-123)."""
    interval = count / rate if rate > 0 else min_interval
    return max(interval, min_interval)


class _Entry:
    """One node's armed TTL. ``gen`` invalidates stale heap residue: a
    renewal bumps the generation, so the old heap tuple surfaces, sees a
    newer gen, and is dropped without firing."""

    __slots__ = ("node_id", "deadline", "ttl", "gen")

    def __init__(self, node_id: str, deadline: float, ttl: float, gen: int):
        self.node_id = node_id
        self.deadline = deadline
        self.ttl = ttl
        self.gen = gen


class HeartbeatManager:
    _gen = itertools.count(1)

    def __init__(self, server):
        self.server = server
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # node_id -> live _Entry (the identity a renewal preserves when an
        # injected heartbeat.tick drop discards it).
        self._timers: Dict[str, _Entry] = {}
        # (deadline, gen, node_id) min-heap; entries whose gen no longer
        # matches the live entry are stale and skipped.
        self._heap: List[Tuple[float, int, str]] = []
        self._thread = None
        self._stopped = False
        # Load counters (monotonic; simcluster's heartbeat-load metric).
        self.arms = 0
        self.renewals = 0
        self.expirations = 0

    # -- arming -------------------------------------------------------------

    def reset_heartbeat_timer(self, node_id: str) -> float:
        """(Re)arm the TTL timer for a node; returns the granted TTL
        (heartbeat.go:13-54). Delegates to the batch path so the
        armed-check/fault-fire/arm sequence exists exactly once."""
        return self.reset_many([node_id])[node_id]

    def reset_many(self, node_ids: List[str]) -> Dict[str, float]:
        """Batch arm/renew under ONE lock hold — the leader half of batched
        registration/heartbeat RPCs (Node.BatchRegister/BatchHeartbeat).

        Injected missed beat (the per-node ``heartbeat.tick`` hook fires
        per RENEWAL, outside the lock): a drop discards the renewal so
        the already-armed TTL keeps running toward expiry — the node-down
        eval fan-out path (heartbeat.go:84-104) driven on demand. Only
        renewals are droppable: the initial arm must happen or no TTL
        timer exists to expire and the node would sit unmonitored forever
        (the opposite of a missed beat). The 0.0 granted for a dropped
        node is DISCARDED by the client (`if ttl:` in client.py), which
        keeps beating at its stale cadence — so one dropped renewal only
        races the old timer against the next beat; deterministically
        downing a node needs a PERSISTENT drop rule (probability 1, no
        count), which starves the timer until it fires. Matches a renewal
        lost in flight."""
        droppable = set()
        with self._lock:
            armed = {nid for nid in node_ids if nid in self._timers}
        for nid in node_ids:
            if nid in armed:
                fault = faults.fire("heartbeat.tick", target=nid)
                if fault is not None and fault.mode in ("drop", "partition"):
                    droppable.add(nid)
        out: Dict[str, float] = {}
        with self._lock:
            for nid in node_ids:
                out[nid] = 0.0 if nid in droppable else self._arm_locked(nid)
        return out

    def _arm_locked(self, node_id: str) -> float:
        cfg = self.server.config
        existing = self._timers.get(node_id)
        if existing is None:
            self.arms += 1
        else:
            self.renewals += 1
            telemetry.incr_counter(("heartbeat", "renewal"))
        # count excludes the node being (re)armed, like the reference
        # (len of OTHER timers at arm time).
        others = len(self._timers) - (0 if existing is None else 1)
        ttl = rate_scaled_interval(
            cfg.max_heartbeats_per_second, cfg.min_heartbeat_ttl, others,
        )
        # Jitter like the reference, but deterministic: the jitter exists
        # to spread NODES apart (decorrelate beat storms), which a
        # name-salted hash fraction does without a PRNG cursor — the
        # grant for a node is a pure function of (seed, node).
        ttl += ttl * prng.fraction(
            "heartbeat.jitter", cfg.seed, node_id,
        )
        gen = next(self._gen)
        entry = _Entry(node_id, time.monotonic() + ttl, ttl, gen)
        self._timers[node_id] = entry
        heapq.heappush(self._heap, (entry.deadline, gen, node_id))
        self._ensure_thread_locked()
        self._wake.notify()
        return ttl

    def _ensure_thread_locked(self) -> None:
        if (self._stopped or self._thread is None
                or not self._thread.is_alive()):
            self._stopped = False
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="heartbeat-wheel",
            )
            self._thread.start()

    # -- the wheel ----------------------------------------------------------

    def _run(self) -> None:
        me = threading.current_thread()
        while True:
            expired: List[str] = []
            with self._lock:
                # A superseded wheel (clear_all then re-arm started a fresh
                # thread) exits here instead of double-servicing the heap.
                if self._stopped or self._thread is not me:
                    return
                now = time.monotonic()
                # Collect EVERYTHING already due in one pass: correlated
                # death (a rack's whole TTL cohort landing together) must
                # expire as a batch so the re-placement evals ride one
                # raft apply + one broker enqueue instead of storming the
                # broker one node at a time.
                while self._heap:
                    deadline, gen, node_id = self._heap[0]
                    live = self._timers.get(node_id)
                    if live is None or live.gen != gen:
                        heapq.heappop(self._heap)  # stale residue
                        continue
                    if deadline > now:
                        break
                    heapq.heappop(self._heap)
                    del self._timers[node_id]
                    self.expirations += 1
                    expired.append(node_id)
                if not expired:
                    timeout = None
                    if self._heap:
                        timeout = max(self._heap[0][0] - now, 0.0)
                    self._wake.wait(timeout)
                    continue
            if len(expired) == 1:
                self._invalidate_heartbeat(expired[0])
            else:
                self._expire_batch(expired)

    def _invalidate_heartbeat(self, node_id: str) -> None:
        """Missed TTL: mark the node down (heartbeat.go:84-104)."""
        self.server.logger.warning(
            "heartbeat: node '%s' TTL expired, marking down", node_id
        )
        # TTL expiry is a state transition the replicated log only shows
        # as the resulting NodeStatusUpdated; the expiry itself is a
        # leader-local decision, published from here (events.py).
        self.server.fsm.events.publish(
            "Node", "NodeHeartbeatExpired", key=node_id
        )
        try:
            self.server.node_update_status(node_id, NODE_STATUS_DOWN)
        except Exception:
            self.server.logger.exception(
                "heartbeat: failed to update status for node %s", node_id
            )

    def _expire_batch(self, node_ids: List[str]) -> None:
        """Mass expiry: the same per-node expiry event each node would get
        alone, then ONE server call that batches every node's down-status
        raft apply and coalesces the re-placement evaluations into a
        single eval_upsert — the broker sees one enqueue for the whole
        dead rack, not a per-node storm."""
        self.server.logger.warning(
            "heartbeat: %d node TTLs expired together, marking down",
            len(node_ids),
        )
        for node_id in node_ids:
            self.server.fsm.events.publish(
                "Node", "NodeHeartbeatExpired", key=node_id
            )
        try:
            self.server.node_batch_expire(node_ids)
        except Exception:
            self.server.logger.exception(
                "heartbeat: failed batch expiry for %d nodes", len(node_ids)
            )

    # -- cancel/stats -------------------------------------------------------

    def clear_heartbeat_timer(self, node_id: str) -> None:
        with self._lock:
            self._timers.pop(node_id, None)
            # Heap residue is discarded lazily by the gen check.

    def clear_all(self) -> None:
        with self._lock:
            self._timers.clear()
            self._heap.clear()
            self._stopped = True
            self._wake.notify_all()

    def num_timers(self) -> int:
        with self._lock:
            return len(self._timers)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "active": len(self._timers),
                "arms": self.arms,
                "renewals": self.renewals,
                "expirations": self.expirations,
            }

