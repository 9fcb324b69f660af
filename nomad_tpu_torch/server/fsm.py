"""Replicated state machine: applies log entries to the state store.

Port of nomad_tpu/server/fsm.py (upstream nomad/fsm.go). Message types mirror
fsm.go:116-144; applying an eval update enqueues pending evals into the
broker (fsm.go:243-250). Snapshot/restore serializes the full state through
StateRestore (fsm.go:299-593).

``InProcRaft`` is the DevMode replication layer: synchronous apply with a
monotonic index (the reference's testing posture, raft.NewInmemStore at
server.go:420-427). The multi-server replicated log slots in behind the same
``apply``/``applied_index`` interface. The restore forensics and the
write-path and read-index books that nomad_tpu's observatories read come
with those observatories.
"""

from __future__ import annotations

import io
import logging
import pickle
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, TYPE_CHECKING

from nomad_tpu_torch import faults, telemetry, trace

if TYPE_CHECKING:  # injected collaborator; import would be circular
    from nomad_tpu_torch.server.eval_broker import EvalBroker
from nomad_tpu_torch.events import EventBroker
from nomad_tpu_torch.state import StateStore


class FSM:
    """Applies replicated messages to a fresh StateStore
    (reference: nomad/fsm.go:38-114)."""

    def __init__(
        self,
        eval_broker: Optional["EvalBroker"] = None,
        logger: Optional[logging.Logger] = None,
        events: Optional[EventBroker] = None,
    ):
        self.state = StateStore()
        self.eval_broker = eval_broker
        # Per-FSM event broker (nomad_tpu_torch.events): every apply publishes
        # the state transition it just made, stamped with its raft index.
        # Per-replica ownership is what makes the log exactly-once: each
        # server applies each committed entry exactly once, so each
        # server's event stream records exactly one PlanApplied per plan.
        self.events = events if events is not None else EventBroker()
        # Gate for broker enqueue on apply: in a cluster this is raft
        # leadership, checked synchronously at apply time. The broker's own
        # enabled flag lags leadership changes (they notify asynchronously),
        # so a deposed leader could otherwise enqueue replicated evals into
        # its stale broker and double-deliver.
        self.enqueue_guard = lambda: True
        self.logger = logger or logging.getLogger("nomad_tpu_torch.fsm")
        # Last snapshot-restore forensics (plain data, read by
        # raft_observe.py for the recovery timeline): wall cost and
        # per-table row counts of the most recent restore_bytes, None
        # until one happens.
        self.last_restore: Optional[Dict[str, Any]] = None
        # The span of the entry being applied (NULL_SPAN outside a traced
        # apply): handlers annotate it with what the entry did.
        self._span = trace.NULL_SPAN
        self._handlers: Dict[str, Callable[[int, dict], Any]] = {
            "node_register": self._apply_node_register,
            "node_batch_register": self._apply_node_batch_register,
            "node_deregister": self._apply_node_deregister,
            "node_status_update": self._apply_node_status_update,
            "node_drain_update": self._apply_node_drain_update,
            "job_register": self._apply_job_register,
            "job_deregister": self._apply_job_deregister,
            "eval_update": self._apply_eval_update,
            "eval_delete": self._apply_eval_delete,
            "alloc_update": self._apply_alloc_update,
            "alloc_client_update": self._apply_alloc_client_update,
        }

    def apply(self, index: int, msg_type: str, payload: dict) -> Any:
        handler = self._handlers.get(msg_type)
        if handler is None:
            raise ValueError(f"failed to apply request: unknown type {msg_type!r}")
        # Injected apply stall (mode 'delay' only — fire() sleeps it; an
        # injected ERROR would make a deterministic FSM diverge per
        # replica, which is not a failure mode production exhibits).
        faults.fire("fsm.apply", target=msg_type)
        # Per-message-type apply timing (reference: nomad/fsm.go:148
        # `defer metrics.MeasureSince([]string{"nomad","fsm",...})`), plus
        # a child span when the applying thread carries one (the plan
        # applier's synchronous-raft posture).
        start = time.perf_counter()
        parent = trace.current_span()
        span = (
            trace.get_tracer().start_span(
                parent.trace_id, "fsm.apply", parent=parent,
                annotations={"msg_type": msg_type, "index": index},
            )
            if parent is not None else trace.NULL_SPAN
        )
        self._span = span
        try:
            return handler(index, payload)
        finally:
            self._span = trace.NULL_SPAN
            span.finish()
            telemetry.measure_since(("fsm", "apply", msg_type), start)

    # -- handlers (fsm.go:146-297) ----------------------------------------

    def _apply_node_register(self, index: int, payload: dict) -> None:
        node = payload["node"]
        self.state.upsert_node(index, node)
        self.events.publish("Node", "NodeRegistered", key=node.id,
                            raft_index=index,
                            payload={"status": node.status})

    def _apply_node_batch_register(self, index: int, payload: dict) -> None:
        """Bulk registration (one log entry for a whole fleet tranche —
        the Node.BatchRegister path). ONE event per batch, not per node:
        a 10k-node fleet bring-up must not evict the whole event ring
        (the same granularity cut the columnar alloc commits make)."""
        nodes = payload["nodes"]
        self.state.upsert_nodes(index, nodes)
        self.events.publish(
            "Node", "NodeBatchRegistered",
            key=nodes[0].id if nodes else "", raft_index=index,
            payload={"count": len(nodes)},
        )

    def _apply_node_deregister(self, index: int, payload: dict) -> None:
        self.state.delete_node(index, payload["node_id"])
        self.events.publish("Node", "NodeDeregistered",
                            key=payload["node_id"], raft_index=index)

    def _apply_node_status_update(self, index: int, payload: dict) -> None:
        self.state.update_node_status(index, payload["node_id"], payload["status"])
        self.events.publish("Node", "NodeStatusUpdated",
                            key=payload["node_id"], raft_index=index,
                            payload={"status": payload["status"]})

    def _apply_node_drain_update(self, index: int, payload: dict) -> None:
        self.state.update_node_drain(index, payload["node_id"], payload["drain"])
        self.events.publish("Node", "NodeDrainUpdated",
                            key=payload["node_id"], raft_index=index,
                            payload={"drain": bool(payload["drain"])})

    def _apply_job_register(self, index: int, payload: dict) -> None:
        job = payload["job"]
        self.state.upsert_job(index, job)
        self.events.publish("Job", "JobRegistered", key=job.id,
                            raft_index=index, payload={"type": job.type})

    def _apply_job_deregister(self, index: int, payload: dict) -> None:
        self.state.delete_job(index, payload["job_id"])
        self.events.publish("Job", "JobDeregistered",
                            key=payload["job_id"], raft_index=index)

    def _apply_eval_update(self, index: int, payload: dict) -> None:
        evals = payload["evals"]
        self.state.upsert_evals(index, evals)
        for ev in evals:
            self.events.publish("Eval", "EvalUpdated", key=ev.id,
                                raft_index=index,
                                payload={"status": ev.status,
                                         "job_id": ev.job_id,
                                         "triggered_by": ev.triggered_by})
        # On the leader, hand pending evals to the broker (fsm.go:243-250).
        # wait_index = the eval's own apply index: the worker's snapshot
        # must contain at least the write that created the eval.
        if self.eval_broker is not None and self.enqueue_guard():
            # One lock hold for the whole entry: a coalescing batch
            # dequeuer parked on the broker wakes to the full burst, not
            # to whichever prefix the per-eval notify race exposed.
            pending = [ev for ev in evals if ev.should_enqueue()]
            if pending:
                # A committed entry cannot fail: past the broker's
                # pending cap enqueue_many SPILLS (typed, counted) and
                # the server's readmission loop re-enqueues from state
                # as capacity frees — bounded queue, no lost evals.
                spilled = self.eval_broker.enqueue_many(
                    pending, wait_index=index)
                if spilled:
                    telemetry.incr_counter(
                        ("broker", "enqueue_spilled"), spilled)

    def _apply_eval_delete(self, index: int, payload: dict) -> None:
        self.state.delete_eval(index, payload["evals"], payload["allocs"])
        for ev_id in payload["evals"]:
            self.events.publish("Eval", "EvalDeleted", key=ev_id,
                                raft_index=index)

    def _apply_alloc_update(self, index: int, payload: dict) -> None:
        allocs = payload.get("allocs") or []
        stopped = [*(payload.get("block_stops") or ()),
                   *(payload.get("allocs_stopped") or ())]
        if stopped:
            # Block stop runs (an in-process raft hands the plan's over as
            # they are) and stops that crossed the wire as ids
            # (structs.stop_id_runs): live block members commit as stopped
            # blocks, one a source block and run; every other id is
            # rebuilt into a stop copy from this replica's store, ahead of
            # the rest as in the plan's own order.
            blocks, copies = self.state.stop_block_members(index, stopped)
            allocs = copies + allocs
            columnar = sum(b.n_live for b in blocks)
            self._span.annotate("stops_columnar", columnar)
            self._span.annotate("stops_rows", len(copies))
            # One event a stopped member, as for the stop copies below:
            # the event stream (and the digests that replay it) reads as
            # the object path's.
            for b in blocks:
                for alloc_id, node_id in b.live_members():
                    self.events.publish(
                        "Alloc", "AllocUpserted", key=alloc_id,
                        raft_index=index,
                        payload={"node_id": node_id, "job_id": b.job_id,
                                 "desired_status": b.desired_status},
                    )
        if allocs:
            self.state.upsert_allocs(index, allocs)
            # Per-alloc events only for object rows: bounded by plan size.
            for a in allocs:
                self.events.publish(
                    "Alloc", "AllocUpserted", key=a.id, raft_index=index,
                    payload={"node_id": a.node_id, "job_id": a.job_id,
                             "desired_status": a.desired_status},
                )
        # Columnar placements commit as stored blocks — O(node runs), no
        # per-Allocation expansion (state/blocks.py).
        batches = payload.get("alloc_batches") or []
        if batches:
            self.state.upsert_alloc_blocks(index, batches)
            # One event per BLOCK, keyed by eval — per-member fan-out
            # would cost O(placements) per commit (the state watch makes
            # the same granularity cut for bulk columnar transitions).
            for b in batches:
                self.events.publish(
                    "Alloc", "AllocUpserted", key=b.eval_id,
                    raft_index=index,
                    payload={"columnar": True,
                             "count": int(sum(b.node_counts))},
                )
        # Columnar in-place updates: whole-block field swaps where a batch
        # covers a stored block, row re-stamps elsewhere.
        ubatches = payload.get("update_batches") or []
        if ubatches:
            self.state.apply_update_batches(index, ubatches)
        # The plan applier marks plan commits (plan_apply.py _apply): one
        # PlanApplied per committed plan entry, after its alloc events.
        plan_meta = payload.get("plan")
        if plan_meta:
            self.events.publish(
                "Plan", "PlanApplied", key=plan_meta.get("eval_id", ""),
                raft_index=index,
                payload={k: v for k, v in plan_meta.items()
                         if k != "eval_id"},
            )

    def _apply_alloc_client_update(self, index: int, payload: dict) -> None:
        self.state.update_allocs_from_client(index, payload["allocs"])
        for a in payload["allocs"]:
            # eval_id/job_id ride the payload so lifecycle consumers can
            # close the submit→running loop from the event stream alone.
            self.events.publish(
                "Alloc", "AllocClientUpdated", key=a.id, raft_index=index,
                payload={"client_status": a.client_status,
                         "eval_id": a.eval_id, "job_id": a.job_id},
            )

    # -- snapshot/restore (fsm.go:299-593) ---------------------------------

    def snapshot_cow(self):
        """Cheap copy-on-write snapshot handle, safe to take under the raft
        lock; serialization happens off-lock via serialize_cow (the
        reference's nomadSnapshot holds a StateSnapshot the same way,
        fsm.go:299-311)."""
        return self.state.snapshot()

    def snapshot_bytes(self) -> bytes:
        """Serialize the full FSM state. The reference streams msgpack with
        type tags (fsm.go:414-593); we serialize table dumps (internal
        format, not a wire protocol)."""
        return self.serialize_cow(self.snapshot_cow())

    def serialize_cow(self, snap) -> bytes:
        payload = {
            "nodes": snap.nodes(),
            "jobs": snap.jobs(),
            "evals": snap.evals(),
            # Object rows and columnar blocks persist in their native forms:
            # a 100k-placement block snapshots as its runs, not 100k rows.
            "allocs": snap.allocs_objects(),
            "blocks": snap.alloc_blocks(),
            "indexes": {
                t: snap.get_index(t) for t in ("nodes", "jobs", "evals", "allocs")
            },
        }
        stopped = snap.stopped_alloc_blocks()
        if stopped:
            # Only where there are any: nomad_tpu's FSM has no such table,
            # and a snapshot without one stays readable by it.
            payload["stopped_blocks"] = stopped
        return pickle.dumps(payload)

    def restore_bytes(self, data: bytes) -> None:
        """Rebuild a fresh state store from a snapshot (fsm.go:313-410).
        Reads nomad_tpu's snapshots too (see _SnapshotUnpickler)."""
        t0 = time.perf_counter()
        payload = _SnapshotUnpickler(io.BytesIO(data)).load()
        old_store = self.state
        self.state = StateStore()
        # The watcher-registration cap is configuration, not state: a
        # snapshot install must not silently unbound the fresh registry.
        self.state.watch.max_watchers = old_store.watch.max_watchers
        restore = self.state.restore()
        for node in payload["nodes"]:
            restore.node_restore(node)
        for job in payload["jobs"]:
            restore.job_restore(job)
        for ev in payload["evals"]:
            restore.eval_restore(ev)
        for alloc in payload["allocs"]:
            restore.alloc_restore(alloc)
        for block in payload.get("blocks", []):
            restore.block_restore(block)
        for block in payload.get("stopped_blocks", []):
            restore.stopped_block_restore(block)
        for table, index in payload["indexes"].items():
            restore.index_restore(table, index)
        restore.commit()
        blocks = payload.get("blocks", [])
        stopped = payload.get("stopped_blocks", [])
        self.last_restore = {
            "wall_ms": round((time.perf_counter() - t0) * 1000.0, 3),
            "bytes": len(data),
            "nodes": len(payload["nodes"]),
            "jobs": len(payload["jobs"]),
            "evals": len(payload["evals"]),
            "allocs": len(payload["allocs"]),
            "blocks": len(blocks),
            "stopped_blocks": len(stopped),
            # Placements the snapshot re-materialized: object rows plus
            # the columnar blocks' live members.
            "placements": len(payload["allocs"]) + sum(
                cnt for b in blocks for _nid, cnt in b.live_node_counts()
            ),
        }
        # Blocking queries parked on the replaced store would never be
        # notified again; wake them so they re-check against the live one.
        old_store.watch.notify_all()


class _SnapshotUnpickler(pickle.Unpickler):
    """A snapshot written by nomad_tpu's FSM names its classes by
    nomad_tpu's module paths (``nomad_tpu.structs``,
    ``nomad_tpu.state.blocks``); the port holds copies of those classes
    under ``nomad_tpu_torch``. Mapping the path lets a port server restart
    from a nomad_tpu server's raft data directory without importing
    anything of nomad_tpu."""

    def find_class(self, module: str, name: str):
        if module == "nomad_tpu" or module.startswith("nomad_tpu."):
            module = "nomad_tpu_torch" + module[len("nomad_tpu"):]
        return super().find_class(module, name)


class InProcRaft:
    """Single-process replication layer: synchronous apply, monotonic index.

    Interface contract shared with the future multi-server layer:
    - apply(msg_type, payload) -> Future resolving to the log index
    - applied_index property
    """

    def __init__(self, fsm: FSM):
        self.fsm = fsm
        self._lock = threading.Lock()
        self._index = 0
        # Write-path anchor records (the RaftNode book surface that
        # raft_observe.py drains): no persistence or replication, so those
        # stages are zero wide and fsm_apply dominates. Entry bytes stay
        # 0: payloads are live objects, never serialized here.
        self._wp_done: "deque" = deque(maxlen=1024)
        self._wp_seq = 0
        # Read-index books (server/read_path.py): a quorum of one is
        # always itself, so every linearizable read confirms trivially,
        # counted as a lease hit.
        self.read_index_calls = 0
        self.read_lease_hits = 0
        self.read_quorum_confirms = 0
        self.read_index_refused = 0

    @property
    def applied_index(self) -> int:
        with self._lock:
            return self._index

    @property
    def is_leader(self) -> bool:
        """A quorum of one: always the leader of itself."""
        return True

    def read_index(self, timeout: float = 2.0) -> int:
        """Trivially confirmed linearizable read point: replication is
        synchronous, so the applied index is the commit index."""
        del timeout
        with self._lock:
            self.read_index_calls += 1
            self.read_lease_hits += 1
            return self._index

    def last_contact_s(self) -> float:
        """The single member is its own leader: contact age is zero."""
        return 0.0

    def write_path_records(self, since: int):
        """(sequence, finalized records newer than ``since``): the raft
        observatory's drain, RaftNode's contract."""
        with self._lock:
            seq = self._wp_seq
            n = seq - int(since)
            if n <= 0:
                return seq, []
            n = min(n, len(self._wp_done))
            return seq, list(self._wp_done)[-n:]

    def apply(self, msg_type: str, payload: dict) -> Future:
        """Apply under the lock, publishing the index only after the FSM has
        executed the entry — readers of applied_index (worker wait_for_index)
        must never observe an index whose entry is not yet visible, and
        entries must hit the FSM in log order.

        A failed apply still consumes its index: the log entry committed and
        the FSM error is deterministic, matching replicated-raft semantics.
        """
        future: Future = Future()
        t_submit = time.monotonic()
        with self._lock:
            index = self._index + 1
            # Synchronous quorum of one: append, persist, replicate and
            # commit all collapse to the lock acquisition.
            anchors = {"submit": t_submit}
            anchors["persisted"] = anchors["committed"] = time.monotonic()
            anchors["fsm_start"] = time.monotonic()
            try:
                self.fsm.apply(index, msg_type, payload)
            except Exception as e:
                self._index = index
                anchors["fsm_end"] = time.monotonic()
                future.set_exception(e)
            else:
                self._index = index
                anchors["fsm_end"] = time.monotonic()
                future.set_result(index)
            anchors["resolved"] = time.monotonic()
            self._wp_done.append({"index": index, "msg_type": msg_type,
                                  "bytes": 0, "anchors": anchors})
            self._wp_seq += 1
        return future
