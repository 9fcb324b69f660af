"""The Raft node: election, replication, commitment.

Port of nomad_tpu/raft/node.py: a compact Raft core (Ongaro & Ousterhout's
algorithm) over the port's RPC layer, speaking nomad_tpu's RPC methods and
writing its on-disk format (meta, checksummed journal and snapshot files),
so a port node restarts from a nomad_tpu node's data directory. Two
differences on purpose: election jitter comes from a per-node seeded
stream (``RaftConfig.seed`` salted by the node id, nomad_tpu_torch.prng)
rather than the global ``random``. The plain-data books the
observatories read (write-path anchor records, ``observe_stats``, the
recovery timeline, the read-index books) are kept as in nomad_tpu; this
module never imports ``raft_observe.py``. Scope notes vs the paper:
- log compaction via FSM snapshots (paper §7): each node snapshots its own
  FSM every ``snapshot_threshold`` applied entries and truncates the log
  prefix, keeping ``trailing_logs`` entries past the snapshot so followers
  behind by less than the tail catch up via ordinary AppendEntries (the
  reference raft library's TrailingLogs behavior); followers further back
  take the InstallSnapshot RPC. The reference keeps its log in BoltDB and
  snapshots through raft.FileSnapshotStore retaining 2
  (nomad/server.go:437,453); we retain ``snapshot_retain`` snapshot files
  the same way.
- membership change: single-server add/remove committed through the log
  as ``_config`` entries (add_peer/remove_peer, one change at a time).
  The cluster layer drives them from gossip events the way the
  reference's leader reconciles Serf members with Raft peers
  (nomad/serf.go:76-134, nomad/leader.go:263-343). A server that applies
  its own removal stops starting elections (no removed-server disruption)
  until a leader contacts it again after a re-add.

Persistence: term/vote/log journal + snapshot files to ``data_dir`` when
set; on restart the newest valid snapshot is restored into the FSM and the
log tail replayed (fsm.go:313-410 posture). In-memory otherwise (the
reference's DevMode InmemStore, server.go:420-427). Journal lines carry a
crc32 prefix (``<crc32:08x> <json body>``): a torn or bit-flipped tail is
truncated back to the last whole checksummed entry on load — counted
(``raft.journal.truncated_tail``), never a crash — and the clean prefix is
rewritten so the next append lands on a valid journal. Legacy unprefixed
lines still load (json-parse is their only check).

Log indexing is absolute: ``self.log[k]`` holds entry ``log_offset+k+1``,
where ``log_offset <= snapshot_index`` (the gap is the retained trailing
tail; they are equal right after restore or InstallSnapshot).
"""

from __future__ import annotations

import base64
import glob
import json
import logging
import os
import threading
import time
import zlib
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch import faults, prng, telemetry
from nomad_tpu_torch.raft.log_codec import decode_payload, encode_payload
from nomad_tpu_torch.rpc import ConnPool, RPCError, RPCServer, RemoteError

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


class NotLeaderError(Exception):
    def __init__(self, leader_addr: str = ""):
        super().__init__(
            f"not the leader (leader: {leader_addr or 'unknown'})"
        )
        self.leader_addr = leader_addr


@dataclass
class RaftConfig:
    node_id: str = ""
    # node_id -> rpc addr for every member, including self
    peers: Dict[str, str] = field(default_factory=dict)
    heartbeat_interval: float = 0.05
    election_timeout_min: float = 0.15
    election_timeout_max: float = 0.30
    data_dir: str = ""
    # Do not run elections until this many members are known — the
    # reference's bootstrap_expect posture (nomad/serf.go:76-134
    # maybeBootstrap: servers idle until the expected count joins).
    bootstrap_expect: int = 1
    # Take an FSM snapshot and truncate the log prefix after this many
    # applied entries past the last snapshot (raft.FileSnapshotStore
    # posture, nomad/server.go:453). Snapshot files retained: snapshot_retain.
    snapshot_threshold: int = 8192
    snapshot_retain: int = 2
    # Entries retained past the snapshot index at compaction so slightly
    # lagging followers replicate normally instead of taking a full
    # InstallSnapshot (hashicorp/raft TrailingLogs posture).
    trailing_logs: int = 1024
    # InstallSnapshot transfer chunk size (raw snapshot bytes per RPC,
    # paper §7's offset/done framing): a multi-MB FSM snapshot must not
    # ride one RPC — each chunk resets the follower's election timer and
    # interleaves with live AppendEntries instead of stalling behind one
    # giant frame.
    snapshot_chunk_bytes: int = 256 * 1024
    # Leader read lease as a fraction of election_timeout_min: a quorum
    # ack within the last (fraction × election_timeout_min) seconds lets
    # read_index() confirm leadership from the books instead of a fresh
    # quorum round — the lease rides the existing heartbeat traffic. The
    # fraction < 1 is the clock-skew guard: a peer that acked at time T
    # waits at least election_timeout_min of ITS clock past T before
    # electing anyone, so serving within a strict fraction of that window
    # tolerates bounded timer drift (clamped to 0.9 defensively).
    read_lease_fraction: float = 0.75
    # Seed of the election-jitter stream, salted by node_id: members of one
    # cell draw independent timeouts, and a run replays its draws.
    seed: int = 0


@dataclass
class _Entry:
    term: int
    msg_type: str
    payload: dict  # encoded (wire) form
    # Serialized (wire/journal) size; 0 when never measured. Kept on the
    # entry so the log's byte economy (raft_observe.py) is a cheap sum,
    # not a re-serialization per poll.
    wire_bytes: int = 0

    def to_wire(self) -> dict:
        return {"term": self.term, "type": self.msg_type, "payload": self.payload}

    @staticmethod
    def from_wire(d: dict) -> "_Entry":
        return _Entry(d["term"], d["type"], d["payload"])


def _atomic_write(path: str, text: str) -> None:
    """Crash-consistent file replace: write tmp, flush+fsync, rename, fsync
    the directory so the rename itself is durable."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


class RaftNode:
    """One Raft participant. Exposes the replication-layer interface the
    server uses: apply(msg_type, payload) -> Future[index], applied_index,
    plus on_leadership_change notifications."""

    def __init__(self, config: RaftConfig, fsm, rpc: RPCServer,
                 pool: Optional[ConnPool] = None,
                 logger: Optional[logging.Logger] = None):
        self.config = config
        self.fsm = fsm
        self.rpc = rpc
        self.pool = pool or ConnPool(timeout=2.0)
        self.logger = logger or logging.getLogger(
            f"nomad_tpu_torch.raft.{config.node_id}"
        )

        # Persistent state
        self.current_term = 0
        self.voted_for: Optional[str] = None
        self.log: List[_Entry] = []  # log[k] is entry log_offset+k+1
        # Compaction state: everything at or below snapshot_index is covered
        # by the FSM snapshot; the log itself starts after log_offset, which
        # trails snapshot_index by up to trailing_logs entries so lagging
        # followers can catch up without a full snapshot transfer.
        self.snapshot_index = 0
        self.snapshot_term = 0
        self.log_offset = 0
        self.log_offset_term = 0
        self._snap_data: Optional[bytes] = None
        self._compacting = False

        # Volatile
        self.commit_index = 0
        self.last_applied = 0
        self.role = FOLLOWER
        self.leader_id: Optional[str] = None
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        # Set when this node applies its own removal from the peer set; a
        # removed server must not start elections (it would disrupt the
        # cluster with ever-higher terms). Cleared when a leader contacts
        # us again (re-added via a later _config entry).
        self.removed = False

        self._lock = threading.RLock()
        self._apply_futures: Dict[int, Future] = {}
        self._rng = prng.stream(config.seed, f"raft.election.{config.node_id}")
        self._election_deadline = self._random_deadline()
        self._shutdown = threading.Event()
        self._replicate_now = threading.Event()
        self.on_leadership_change: Optional[Callable[[bool], None]] = None

        # -- observability books (plain data, mutated under _lock; read
        # by raft_observe.py — this module never imports the observer)
        # Per-entry write-path anchor records: index -> open record with
        # monotonic stamps (submit/persisted/first_ack/committed/
        # fsm_start/fsm_end/resolved); finalized records move to a
        # bounded ring the observatory drains by sequence number.
        self._wp_open: Dict[int, dict] = {}
        self._wp_done: "deque" = deque(maxlen=1024)
        self._wp_seq = 0
        # Peer ack stamps of the current term: the leader's read lease.
        self._peer_ack_at: Dict[str, float] = {}
        # Read-index books (server/read_path.py's linearizable lane):
        # calls, how each confirmed (lease hit riding heartbeat acks vs an
        # explicit quorum round), refusals; and the last accepted leader
        # contact (follower side), the stale lane's measured age.
        self._last_leader_contact: Optional[float] = None
        self.read_index_calls = 0
        self.read_lease_hits = 0
        self.read_quorum_confirms = 0
        self.read_index_refused = 0
        self.commit_advances = 0
        self.entries_appended = 0
        self.bytes_appended = 0
        self.entries_truncated = 0
        self.compactions = 0
        self.compaction_wall_ms = 0.0
        self.snapshot_persist_ms = 0.0
        self.snapshot_last_bytes = 0
        self.snapshot_disk_bytes = 0
        self.snapshots_installed = 0
        self.snapshots_sent = 0
        self.snapshot_chunks_sent = 0
        self.snapshot_chunks_received = 0
        # In-flight chunked InstallSnapshot reassembly (follower side):
        # buffer plus its (index, term) identity; an offset or identity
        # mismatch discards the transfer and the leader restarts it.
        self._snap_chunks: Optional[bytearray] = None
        self._snap_chunks_key: Optional[Tuple[int, int]] = None
        # Per-peer replication in-flight guard (leader side). A chunked
        # snapshot transfer outlives _broadcast_append's 1s join, and
        # without the guard every later heartbeat tick would start a
        # SECOND stream to the same peer whose offset-0 chunk resets the
        # follower's reassembly buffer — the competing transfers then
        # fail each other's offset checks forever and the follower never
        # installs. One stream per peer at a time.
        self._replicating_peers: set = set()
        # Restart-replay timeline: populated by _load_persistent (cold
        # start), advanced by the replaying applies, closed out by
        # leadership + mark_serving(). All ms fields are relative to
        # construction time.
        self._recovery_t0 = time.monotonic()
        self._replay_started: Optional[float] = None
        self.recovery: Dict[str, Any] = {
            "cold_start": False,
            "snapshot_restore_ms": 0.0,
            "snapshot_index": 0,
            "snapshot_bytes": 0,
            "log_entries_loaded": 0,
            "journal_truncated_tail": 0,
            "replay_target": 0,
            "entries_replayed": 0,
            "replayed_by_type": {},
            "replay_wall_ms": None,
            "time_to_leader_ms": None,
            "time_to_serving_ms": None,
        }

        self._load_persistent()
        rpc.register("Raft.RequestVote", self._handle_request_vote)
        rpc.register("Raft.AppendEntries", self._handle_append_entries)
        rpc.register("Raft.InstallSnapshot", self._handle_install_snapshot)
        rpc.register("Raft.ReadIndex", self._handle_read_index)

        self._threads: List[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        # Construction (e.g. jit warmup elsewhere in the server) may predate
        # start by a while; don't let the first election fire instantly.
        with self._lock:
            self._election_deadline = self._random_deadline()
        for target, name in ((self._election_loop, "raft-election"),
                             (self._leader_loop, "raft-leader")):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"{name}-{self.config.node_id}")
            t.start()
            self._threads.append(t)

    def shutdown(self) -> None:
        self._shutdown.set()
        self._replicate_now.set()
        self.pool.shutdown()

    # -- public interface ---------------------------------------------------

    @property
    def applied_index(self) -> int:
        with self._lock:
            return self.last_applied

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self.role == LEADER

    @property
    def leader_addr(self) -> str:
        with self._lock:
            if self.leader_id is None:
                return ""
            return self.config.peers.get(self.leader_id, "")

    def apply(self, msg_type: str, payload: dict) -> Future:
        """Append + replicate + commit + FSM-apply. Resolves with the log
        index; raises NotLeaderError through the future on followers."""
        future: Future = Future()
        t_submit = time.monotonic()
        with self._lock:
            if self.role != LEADER:
                future.set_exception(NotLeaderError(self.leader_addr))
                return future
            entry = _Entry(
                self.current_term, msg_type, encode_payload(msg_type, payload)
            )
            self.log.append(entry)
            index = self.log_offset + len(self.log)
            self._apply_futures[index] = future
            # Serialize ONCE: the journal line doubles as the entry's
            # byte measurement (in-memory mode pays the same dumps).
            line = json.dumps({"index": index, **entry.to_wire()})
            entry.wire_bytes = len(line)
            self._persist_entry_line(line)
            self.entries_appended += 1
            self.bytes_appended += entry.wire_bytes
            self._wp_open[index] = {
                "index": index,
                "msg_type": msg_type,
                "bytes": entry.wire_bytes,
                "anchors": {"submit": t_submit,
                            "persisted": time.monotonic()},
            }
            if len(self._wp_open) > 4096:
                # Bound the open table: insertion order is index order,
                # so the first key is the oldest record.
                self._wp_open.pop(next(iter(self._wp_open)))
            if len(self.config.peers) == 1:
                self._advance_commit_locked()
        self._replicate_now.set()
        return future

    def barrier(self, timeout: float = 5.0) -> int:
        """Commit a no-op and wait for it — the leader's read barrier."""
        future = self.apply("_noop", {})
        return future.result(timeout)

    # -- linearizable reads without a log write (dissertation §6.4) ---------

    def lease_window_s(self) -> float:
        """How long a quorum ack keeps the leader's read lease valid.
        Strictly inside election_timeout_min (see RaftConfig
        .read_lease_fraction — the clock-skew guard)."""
        fraction = min(max(self.config.read_lease_fraction, 0.0), 0.9)
        return self.config.election_timeout_min * fraction

    def last_contact_s(self) -> Optional[float]:
        """Age of the last accepted leader contact (AppendEntries or an
        InstallSnapshot chunk that passed the term check): 0.0 on the
        leader itself, None when this node never heard from a leader."""
        with self._lock:
            if self.role == LEADER:
                return 0.0
            if self._last_leader_contact is None:
                return None
            return max(time.monotonic() - self._last_leader_contact, 0.0)

    def _lease_valid_locked(self, now: float) -> bool:
        """Quorum of peers acked within the lease window (self counts).
        Acks are only ever recorded for the CURRENT term
        (_replicate_to_locked_out re-checks term before stamping), so a
        fresh quorum proves no higher term could have been committed
        when the newest qualifying ack landed."""
        window = self.lease_window_s()
        need = len(self.config.peers) // 2 + 1
        fresh = 1 + sum(
            1 for pid in self._other_peers()
            if now - self._peer_ack_at.get(pid, float("-inf")) <= window
        )
        return fresh >= need

    def read_index(self, timeout: float = 2.0) -> int:
        """Linearizable read point WITHOUT a log write (the ReadIndex
        protocol): capture the commit index, confirm leadership, return
        the index once both hold. The caller serves the read after its
        applied index reaches the returned value. Confirmation is free
        when the heartbeat-riding lease is fresh; otherwise one explicit
        quorum wait (acks newer than the request) — still no log entry.
        Raises NotLeaderError on a non-leader or a deposed leader, and
        TimeoutError when no quorum confirms in time."""
        deadline = time.monotonic() + timeout
        with self._lock:
            if self.role != LEADER:
                self.read_index_refused += 1
                raise NotLeaderError(self.leader_addr)
            self.read_index_calls += 1
            term_ok = (self.commit_index > self.log_offset
                       or self.commit_index > 0) and (
                self._term_at(self.commit_index) == self.current_term)
        if not term_ok:
            # Right after election the current-term no-op may not have
            # committed yet, so commit_index can lag commits a prior
            # leader made that we haven't learned of (§5.4.2). Commit a
            # barrier no-op — the one case the linearizable lane ever
            # touches the log, once per term.
            self.barrier(max(deadline - time.monotonic(), 0.001))
        with self._lock:
            if self.role != LEADER:
                self.read_index_refused += 1
                raise NotLeaderError(self.leader_addr)
            read_idx = self.commit_index
            if self._lease_valid_locked(time.monotonic()):
                self.read_lease_hits += 1
                return read_idx
        # Lease expired (quiet cluster, stalled heartbeats, or a
        # partitioned leader): one explicit confirmation round. A quorum
        # of acks newer than t_req proves this node's leadership — and
        # therefore read_idx's currency — at the time of the request.
        t_req = time.monotonic()
        self._replicate_now.set()
        while True:
            with self._lock:
                if self.role != LEADER:
                    self.read_index_refused += 1
                    raise NotLeaderError(self.leader_addr)
                need = len(self.config.peers) // 2 + 1
                fresh = 1 + sum(
                    1 for pid in self._other_peers()
                    if self._peer_ack_at.get(pid, 0.0) >= t_req
                )
                if fresh >= need:
                    self.read_quorum_confirms += 1
                    return read_idx
            if time.monotonic() >= deadline:
                with self._lock:
                    self.read_index_refused += 1
                raise TimeoutError(
                    f"read_index: no leadership confirmation in "
                    f"{timeout:.3f}s"
                )
            time.sleep(0.002)
            self._replicate_now.set()

    def _handle_read_index(self, args: dict) -> dict:
        """Raft.ReadIndex RPC: a follower's linearizable lane asks the
        leader for a confirmed read index (no log write). Raises through
        the RPC envelope on a non-leader; the forwarding layer retries
        against the new leader."""
        timeout = min(max(float(args.get("timeout") or 1.0), 0.001), 5.0)
        index = self.read_index(timeout=timeout)
        with self._lock:
            return {"index": index, "term": self.current_term}

    # -- membership change (single-server, committed through the log) -------

    def seed_peers(self, peers: Dict[str, str]) -> bool:
        """Pre-bootstrap membership seeding (the reference's maybeBootstrap,
        serf.go:76-134): while nothing has ever committed, gossip-discovered
        members go straight into the peer table so the first election can
        reach bootstrap_expect. Once the cluster has state, membership
        moves only via committed _config entries. Returns True if seeded."""
        with self._lock:
            if self.commit_index > 0:
                return False
            self.config.peers.update(peers)
            return True

    def add_peer(self, pid: str, addr: str) -> Future:
        """Leader-only: commit the addition of a peer. Takes effect (on
        every node, incl. replication targets and quorum math) when the
        entry applies."""
        return self.apply("_config", {"op": "add", "id": pid, "addr": addr})

    def remove_peer(self, pid: str) -> Future:
        """Leader-only: commit the removal of a peer (a leader never
        removes itself — transfer leadership by crashing instead)."""
        if pid == self.config.node_id:
            future: Future = Future()
            future.set_exception(
                ValueError("a leader cannot remove itself")
            )
            return future
        return self.apply("_config", {"op": "remove", "id": pid})

    def _apply_config_locked(self, payload: dict) -> None:
        op, pid = payload.get("op"), payload.get("id")
        if op == "add":
            addr = payload.get("addr", "")
            if self.config.peers.get(pid) != addr:
                self.config.peers[pid] = addr
                self.logger.info(
                    "raft: node %s peer set += %s (%d members)",
                    self.config.node_id, pid, len(self.config.peers),
                )
        elif op == "remove":
            if pid == self.config.node_id:
                self.removed = True
                self.role = FOLLOWER
                self.logger.info(
                    "raft: node %s removed from the cluster; standing down",
                    self.config.node_id,
                )
            if self.config.peers.pop(pid, None) is not None:
                self.logger.info(
                    "raft: node %s peer set -= %s (%d members)",
                    self.config.node_id, pid, len(self.config.peers),
                )
            self.next_index.pop(pid, None)
            self.match_index.pop(pid, None)
        self._persist_meta()  # the peer table is durable state

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self.role,
                "term": self.current_term,
                "leader_id": self.leader_id,
                "commit_index": self.commit_index,
                "applied_index": self.last_applied,
                "last_log_index": self.log_offset + len(self.log),
                "snapshot_index": self.snapshot_index,
                "num_peers": len(self.config.peers) - 1,
            }

    # -- observability surface (read by raft_observe.py) ---------------------

    def mark_serving(self) -> None:
        """Close the recovery timeline: leadership is established and the
        broker restored, so the node serves again. Called by the cluster
        layer's establish-leadership path; first call wins."""
        with self._lock:
            if self.recovery["time_to_serving_ms"] is None:
                self.recovery["time_to_serving_ms"] = round(
                    (time.monotonic() - self._recovery_t0) * 1000.0, 3
                )

    def write_path_records(self, since: int):
        """(sequence, finalized write-path records newer than ``since``),
        the raft observatory's drain. Records fall off the bounded ring;
        the sequence gap tells the consumer how many it missed."""
        with self._lock:
            seq = self._wp_seq
            n = seq - int(since)
            if n <= 0:
                return seq, []
            n = min(n, len(self._wp_done))
            return seq, list(self._wp_done)[-n:]

    def observe_stats(self) -> Dict[str, Any]:
        """One locked read of the replication/log/snapshot books: per-
        follower lag, log byte economy, compaction counters. Disk sizes
        are stamps taken at write, so no I/O happens under the lock."""
        with self._lock:
            now = time.monotonic()
            last_idx = self.log_offset + len(self.log)
            peers = {}
            for pid in sorted(self._other_peers()):
                match = self.match_index.get(pid, 0)
                ack = self._peer_ack_at.get(pid)
                peers[pid] = {
                    "match_index": match,
                    "next_index": self.next_index.get(pid, 0),
                    "lag_entries": max(last_idx - match, 0),
                    "last_ack_age_s": (
                        round(now - ack, 3) if ack is not None else None
                    ),
                }
            return {
                "node_id": self.config.node_id,
                "state": self.role,
                "term": self.current_term,
                "leader_id": self.leader_id,
                "commit_index": self.commit_index,
                "applied_index": self.last_applied,
                "last_log_index": last_idx,
                "commit_advances": self.commit_advances,
                "inflight_writes": len(self._wp_open),
                "peers": peers,
                "log": {
                    "entries": len(self.log),
                    "bytes": sum(e.wire_bytes for e in self.log),
                    "offset": self.log_offset,
                    "appended_entries": self.entries_appended,
                    "appended_bytes": self.bytes_appended,
                    "truncated_entries": self.entries_truncated,
                    # The trailing_logs economy: entries kept in the log
                    # although the snapshot already covers them.
                    "retained_below_snapshot": max(
                        self.snapshot_index - self.log_offset, 0
                    ),
                },
                "read_index": {
                    "calls": self.read_index_calls,
                    "lease_hits": self.read_lease_hits,
                    "quorum_confirms": self.read_quorum_confirms,
                    "refused": self.read_index_refused,
                    "lease_window_s": round(self.lease_window_s(), 4),
                    "last_contact_s": (
                        None if self._last_leader_contact is None
                        or self.role == LEADER
                        else round(now - self._last_leader_contact, 4)
                    ),
                },
                "snapshot": {
                    "index": self.snapshot_index,
                    "term": self.snapshot_term,
                    "threshold": self.config.snapshot_threshold,
                    "trailing_logs": self.config.trailing_logs,
                    "compactions": self.compactions,
                    "compaction_wall_ms": round(self.compaction_wall_ms, 3),
                    "persist_wall_ms": round(self.snapshot_persist_ms, 3),
                    "last_bytes": self.snapshot_last_bytes,
                    "disk_bytes": self.snapshot_disk_bytes,
                    "installs_received": self.snapshots_installed,
                    "installs_sent": self.snapshots_sent,
                    "chunks_sent": self.snapshot_chunks_sent,
                    "chunks_received": self.snapshot_chunks_received,
                },
            }

    # -- persistence --------------------------------------------------------

    def _paths(self) -> Tuple[str, str]:
        d = self.config.data_dir
        return os.path.join(d, "raft-meta.json"), os.path.join(d, "raft-log.jsonl")

    def _persist_meta(self) -> None:
        if not self.config.data_dir:
            return
        meta_path, _ = self._paths()
        # The peer table rides the meta file: _config entries are compacted
        # out of the log, and the snapshot holds only FSM state, so without
        # this a restart from snapshot would come up with peers == {self}.
        _atomic_write(meta_path, json.dumps(
            {"term": self.current_term, "voted_for": self.voted_for,
             "peers": dict(self.config.peers)}
        ))

    @staticmethod
    def _journal_frame(body: str) -> str:
        """Checksummed journal line: crc32 of the JSON body, fixed-width
        hex, one space, body. The crc covers torn writes AND bit flips;
        the body alone stays the wire-byte measure so leader/follower/
        reloaded byte books agree."""
        return f"{zlib.crc32(body.encode()):08x} {body}"

    @staticmethod
    def _journal_parse(raw: str) -> Optional[str]:
        """Validate one journal line; returns the JSON body, or None when
        the line is torn/corrupt. Legacy lines (pre-checksum journals
        start straight at ``{``) pass through — json-parse downstream is
        their only integrity check."""
        if raw.startswith("{"):
            return raw
        if len(raw) < 10 or raw[8] != " ":
            return None
        prefix, body = raw[:8], raw[9:]
        try:
            want = int(prefix, 16)
        except ValueError:
            return None
        if zlib.crc32(body.encode()) != want:
            return None
        return body

    def _persist_entry_line(self, body: str) -> None:
        """Append one pre-serialized journal body (apply() builds it once
        so the byte measurement and the journal share one dumps); the
        crc32 frame is added here."""
        if not self.config.data_dir:
            return
        _, log_path = self._paths()
        with open(log_path, "a") as f:
            f.write(self._journal_frame(body) + "\n")

    def _truncate_persisted_log(self) -> None:
        if not self.config.data_dir:
            return
        _, log_path = self._paths()
        _atomic_write(log_path, "".join(
            self._journal_frame(
                json.dumps({"index": i, **entry.to_wire()})
            ) + "\n"
            for i, entry in enumerate(self.log, start=self.log_offset + 1)
        ))

    def _snap_path(self, index: int) -> str:
        return os.path.join(self.config.data_dir, f"raft-snap-{index:016d}.json")

    def _write_snapshot_file(self, index: int, term: int, data: bytes) -> None:
        """Write a snapshot to disk, retaining the newest
        ``snapshot_retain`` files (raft.FileSnapshotStore, server.go:453)."""
        self.snapshot_last_bytes = len(data)
        if not self.config.data_dir:
            return
        t0 = time.monotonic()
        path = self._snap_path(index)
        _atomic_write(path, json.dumps({
            "index": index,
            "term": term,
            "data": base64.b64encode(data).decode("ascii"),
        }))
        self._prune_snapshots()
        self.snapshot_persist_ms += (time.monotonic() - t0) * 1000.0
        try:
            self.snapshot_disk_bytes = os.path.getsize(path)
        except OSError:
            pass

    def _prune_snapshots(self) -> None:
        snaps = sorted(glob.glob(
            os.path.join(self.config.data_dir, "raft-snap-*.json")
        ))
        retain = max(1, self.config.snapshot_retain)
        for old in snaps[:-retain]:
            try:
                os.remove(old)
            except OSError:
                pass

    def _load_persistent(self) -> None:
        if not self.config.data_dir:
            return
        os.makedirs(self.config.data_dir, exist_ok=True)
        meta_path, log_path = self._paths()
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            self.current_term = meta.get("term", 0)
            self.voted_for = meta.get("voted_for")
            persisted_peers = meta.get("peers") or {}
            persisted_peers.pop(self.config.node_id, None)
            self.config.peers.update(persisted_peers)
        except (OSError, ValueError):
            pass
        # Newest valid snapshot first (fall back through retained copies),
        # restored into the FSM before the log tail replays over it. Restore
        # failures of any kind (corrupt file, truncated pickle, …) fall
        # through to the older retained copy — that is what retain=2 is for.
        snaps = sorted(glob.glob(
            os.path.join(self.config.data_dir, "raft-snap-*.json")
        ), reverse=True)
        for path in snaps:
            try:
                with open(path) as f:
                    snap = json.load(f)
                data = base64.b64decode(snap["data"])
                t_restore0 = time.monotonic()
                self.fsm.restore_bytes(data)
                self.recovery["snapshot_restore_ms"] = round(
                    (time.monotonic() - t_restore0) * 1000.0, 3
                )
                self.recovery["snapshot_index"] = snap["index"]
                self.recovery["snapshot_bytes"] = len(data)
            except Exception:
                # Restore failures of ANY kind fall through to the older
                # retained copy (that is what retain=2 is for) — but a
                # skipped snapshot is forensic gold after a bad restart,
                # so it counts, not just logs.
                telemetry.incr_counter(("raft", "snapshot_restore_failed"))
                self.logger.warning("raft: skipping unreadable snapshot %s", path)
                continue
            self.snapshot_index = snap["index"]
            self.snapshot_term = snap["term"]
            self._snap_data = data
            self.commit_index = self.last_applied = self.snapshot_index
            # Any trailing tail persisted before the restart is discarded by
            # the contiguity rule below; the log restarts at the snapshot.
            self.log_offset = self.snapshot_index
            self.log_offset_term = self.snapshot_term
            break
        # Replay the log tail only if it joins the snapshot contiguously:
        # log[k] must hold entry log_offset+k+1. A gap (e.g. the newest
        # snapshot was unreadable and we fell back to an older one whose
        # successor entries were already compacted away) would mis-index
        # every entry, so the tail is discarded and re-fetched from the
        # leader instead.
        torn = False
        try:
            with open(log_path) as f:
                for line in f:
                    raw = line.rstrip("\n")
                    body = self._journal_parse(raw) if raw else None
                    if body is None:
                        # Torn/corrupt line: a crash mid-append (or a bit
                        # flip) must not brick the node. Everything before
                        # this line replayed cleanly; everything from it
                        # on is untrustworthy and is truncated below.
                        torn = True
                        break
                    try:
                        d = json.loads(body)
                    except ValueError:
                        torn = True
                        break
                    if d["index"] <= self.log_offset:
                        continue
                    if d["index"] != self.log_offset + len(self.log) + 1:
                        self.logger.warning(
                            "raft: discarding log from non-contiguous "
                            "index %d (expected %d)",
                            d["index"], self.log_offset + len(self.log) + 1,
                        )
                        break
                    entry = _Entry.from_wire(d)
                    # The journal body's own length is the byte measure
                    # (the convention apply() stamps).
                    entry.wire_bytes = len(body)
                    self.log.append(entry)
        except OSError:
            pass
        if torn:
            telemetry.incr_counter(("raft", "journal", "truncated_tail"))
            self.recovery["journal_truncated_tail"] += 1
            self.logger.warning(
                "raft: journal tail torn/corrupt; truncated to last whole "
                "checksummed entry (index %d)",
                self.log_offset + len(self.log),
            )
            # Rewrite the clean prefix so the NEXT append lands on a valid
            # journal instead of extending a corrupt tail.
            self._truncate_persisted_log()
        # Close out the recovery bookkeeping for this load: the tail past
        # last_applied is what leadership (or the next leader's commit
        # advance) will replay into the FSM; an empty tail means replay
        # is already done (wall 0), and a warm start (no durable state)
        # leaves the whole record inert.
        self.recovery["log_entries_loaded"] = len(self.log)
        self.recovery["replay_target"] = self.log_offset + len(self.log)
        self.recovery["cold_start"] = bool(
            self.recovery["snapshot_index"] or self.log
        )
        if self.recovery["replay_target"] <= self.last_applied:
            self.recovery["replay_wall_ms"] = 0.0

    # -- helpers ------------------------------------------------------------

    def _random_deadline(self) -> float:
        # Election-timeout jitter (split-vote avoidance, raft §5.2) from
        # this node's own seeded stream: no global random cursor.
        return time.monotonic() + self._rng.uniform(
            self.config.election_timeout_min, self.config.election_timeout_max
        )

    def _last_log(self) -> Tuple[int, int]:
        if not self.log:
            return self.log_offset, self.log_offset_term
        return self.log_offset + len(self.log), self.log[-1].term

    def _entry_at(self, index: int) -> _Entry:
        return self.log[index - self.log_offset - 1]

    def _term_at(self, index: int) -> int:
        if index == self.log_offset:
            return self.log_offset_term
        return self._entry_at(index).term

    def _other_peers(self) -> Dict[str, str]:
        return {
            pid: addr
            for pid, addr in self.config.peers.items()
            if pid != self.config.node_id
        }

    def _become_follower(self, term: int, leader_id: Optional[str]) -> None:
        was_leader = self.role == LEADER
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._persist_meta()
        self.role = FOLLOWER
        if leader_id is not None:
            self.leader_id = leader_id
        if was_leader and self.on_leadership_change:
            threading.Thread(
                target=self.on_leadership_change, args=(False,), daemon=True
            ).start()
        # Fail outstanding leader futures
        for future in self._apply_futures.values():
            if not future.done():
                future.set_exception(NotLeaderError(self.leader_addr))
        self._apply_futures.clear()
        # Open write-path records belong to the deposed leadership: the
        # entries may still commit under the new leader, but this node
        # can no longer attribute their submit→applied path honestly.
        self._wp_open.clear()

    # -- election (paper §5.2) ----------------------------------------------

    def _election_loop(self) -> None:
        while not self._shutdown.is_set():
            time.sleep(0.01)
            with self._lock:
                if self.role == LEADER:
                    continue
                if self.removed:
                    # Not a member: don't disrupt the cluster with elections.
                    self._election_deadline = self._random_deadline()
                    continue
                if len(self.config.peers) < self.config.bootstrap_expect:
                    # Not yet bootstrapped: wait for peers to join.
                    self._election_deadline = self._random_deadline()
                    continue
                if time.monotonic() < self._election_deadline:
                    continue
                # Start an election
                self.role = CANDIDATE
                self.current_term += 1
                self.voted_for = self.config.node_id
                self._persist_meta()
                term = self.current_term
                last_idx, last_term = self._last_log()
                self._election_deadline = self._random_deadline()
            self._run_election(term, last_idx, last_term)

    def _run_election(self, term: int, last_idx: int, last_term: int) -> None:
        votes = 1
        needed = len(self.config.peers) // 2 + 1
        votes_lock = threading.Lock()
        done = threading.Event()

        def request(pid: str, addr: str) -> None:
            nonlocal votes
            # Injected vote loss: the request never leaves this candidate
            # (one edge, one direction — target "<self>-><peer>").
            fault = faults.fire(
                "raft.vote", target=f"{self.config.node_id}->{pid}"
            )
            if fault is not None and fault.mode in ("drop", "partition"):
                return
            try:
                resp = self.pool.call(addr, "Raft.RequestVote", {
                    "term": term,
                    "candidate_id": self.config.node_id,
                    "last_log_index": last_idx,
                    "last_log_term": last_term,
                }, timeout=1.0)
            except (RPCError, RemoteError):
                return
            with self._lock:
                if resp["term"] > self.current_term:
                    self._become_follower(resp["term"], None)
                    done.set()
                    return
            if resp.get("vote_granted"):
                with votes_lock:
                    votes += 1
                    if votes >= needed:
                        done.set()

        threads = [
            threading.Thread(target=request, args=(pid, addr), daemon=True)
            for pid, addr in self._other_peers().items()
        ]
        for t in threads:
            t.start()
        if needed == 1:
            done.set()
        done.wait(timeout=self.config.election_timeout_max)

        with self._lock:
            if self.role != CANDIDATE or self.current_term != term:
                return
            with votes_lock:
                won = votes >= needed
            if not won:
                return
            # Become leader (paper §5.3)
            self.role = LEADER
            self.leader_id = self.config.node_id
            last_idx, _ = self._last_log()
            for pid in self._other_peers():
                self.next_index[pid] = last_idx + 1
                self.match_index[pid] = 0
            self.logger.info(
                "raft: node %s won election for term %d",
                self.config.node_id, term,
            )
            if self.recovery["time_to_leader_ms"] is None:
                self.recovery["time_to_leader_ms"] = round(
                    (time.monotonic() - self._recovery_t0) * 1000.0, 3
                )
        # Commit a no-op immediately: a leader may only count replicas for
        # current-term entries (paper §5.4.2), so this is what commits any
        # prior-term tail — including a freshly replayed log.
        self.apply("_noop", {})
        if self.on_leadership_change:
            threading.Thread(
                target=self.on_leadership_change, args=(True,), daemon=True
            ).start()
        self._replicate_now.set()

    def _handle_request_vote(self, args: dict) -> dict:
        with self._lock:
            # Votes from non-members are ignored WITHOUT adopting their
            # term: a server removed while partitioned (it never saw its
            # removal commit) would otherwise depose live leaders with
            # ever-higher terms forever (hashicorp/raft guards the same
            # way; the cluster layer re-joins such a server via gossip).
            if args["candidate_id"] not in self.config.peers:
                return {"term": self.current_term, "vote_granted": False}
            term = args["term"]
            if term > self.current_term:
                self._become_follower(term, None)
            granted = False
            if term == self.current_term and self.voted_for in (
                None, args["candidate_id"]
            ):
                last_idx, last_term = self._last_log()
                up_to_date = (args["last_log_term"], args["last_log_index"]) >= (
                    last_term, last_idx
                )
                if up_to_date:
                    granted = True
                    self.voted_for = args["candidate_id"]
                    self._persist_meta()
                    self._election_deadline = self._random_deadline()
            return {"term": self.current_term, "vote_granted": granted}

    # -- replication (paper §5.3) --------------------------------------------

    def _leader_loop(self) -> None:
        while not self._shutdown.is_set():
            fired = self._replicate_now.wait(self.config.heartbeat_interval)
            self._replicate_now.clear()
            with self._lock:
                if self.role != LEADER:
                    continue
            self._broadcast_append()
            del fired

    def _broadcast_append(self) -> None:
        peers = self._other_peers()
        if not peers:
            with self._lock:
                self._advance_commit_locked()
            return
        threads = [
            threading.Thread(
                target=self._replicate_to, args=(pid, addr), daemon=True
            )
            for pid, addr in peers.items()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=1.0)

    def _replicate_to(self, pid: str, addr: str) -> None:
        with self._lock:
            if self.role != LEADER or pid in self._replicating_peers:
                return
            self._replicating_peers.add(pid)
        try:
            self._replicate_to_locked_out(pid, addr)
        finally:
            with self._lock:
                self._replicating_peers.discard(pid)

    def _replicate_to_locked_out(self, pid: str, addr: str) -> None:
        with self._lock:
            if self.role != LEADER:
                return
            term = self.current_term
            next_idx = self.next_index.get(pid, 1)
            if next_idx <= self.log_offset:
                # The entries this follower needs were compacted away (it is
                # behind even the trailing tail): ship the snapshot instead
                # (paper §7 InstallSnapshot).
                snap = (self.snapshot_index, self.snapshot_term, self._snap_data)
            else:
                snap = None
                prev_idx = next_idx - 1
                prev_term = self._term_at(prev_idx) if prev_idx > 0 else 0
                entries = [
                    e.to_wire()
                    for e in self.log[next_idx - self.log_offset - 1:]
                ]
            commit = self.commit_index
        # Injected append loss (covers the InstallSnapshot arm too: both
        # are the leader's replication stream to this peer). A drop here is
        # ordinary message loss — the next heartbeat retries, exactly the
        # redundancy Raft's correctness argument assumes.
        fault = faults.fire(
            "raft.append", target=f"{self.config.node_id}->{pid}"
        )
        if fault is not None and fault.mode in ("drop", "partition"):
            return
        if snap is not None:
            self._send_snapshot(pid, addr, term, *snap)
            return
        try:
            resp = self.pool.call(addr, "Raft.AppendEntries", {
                "term": term,
                "leader_id": self.config.node_id,
                "prev_log_index": prev_idx,
                "prev_log_term": prev_term,
                "entries": entries,
                "leader_commit": commit,
            }, timeout=1.0)
        except (RPCError, RemoteError):
            return
        with self._lock:
            if resp["term"] > self.current_term:
                self._become_follower(resp["term"], None)
                return
            if self.role != LEADER or self.current_term != term:
                return
            if resp.get("success"):
                old_match = self.match_index.get(pid, 0)
                self.match_index[pid] = prev_idx + len(entries)
                self.next_index[pid] = self.match_index[pid] + 1
                now = time.monotonic()
                self._peer_ack_at[pid] = now
                # First-ack anchors for the write-path partition: the
                # freshly covered indexes' replicate stage ends here.
                for i in range(old_match + 1, self.match_index[pid] + 1):
                    rec = self._wp_open.get(i)
                    if rec is not None:
                        rec["anchors"].setdefault("first_ack", now)
                self._advance_commit_locked()
            else:
                # Back off and retry (fast backtrack via follower hint)
                hint = resp.get("conflict_index")
                self.next_index[pid] = max(
                    1, hint if hint else self.next_index.get(pid, 2) - 1
                )
                self._replicate_now.set()

    def _send_snapshot(self, pid: str, addr: str, term: int,
                       snap_index: int, snap_term: int,
                       data: Optional[bytes]) -> None:
        """Stream one snapshot in ``snapshot_chunk_bytes`` pieces (paper
        §7's offset/done framing). Each chunk is a bounded RPC, so a
        multi-MB snapshot interleaves with live traffic and keeps
        resetting the follower's election timer; leadership is re-checked
        between chunks so a deposed leader stops streaming immediately.
        match/next advance only after the final chunk's ack — a transfer
        aborted midway retries whole on the next replication pass."""
        if data is None:
            return
        chunk = max(1, int(self.config.snapshot_chunk_bytes))
        total = len(data)
        offset = 0
        while True:
            with self._lock:
                if self.role != LEADER or self.current_term != term:
                    return
            piece = data[offset:offset + chunk]
            done = offset + len(piece) >= total
            try:
                resp = self.pool.call(addr, "Raft.InstallSnapshot", {
                    "term": term,
                    "leader_id": self.config.node_id,
                    "last_included_index": snap_index,
                    "last_included_term": snap_term,
                    "offset": offset,
                    "done": done,
                    "data": base64.b64encode(piece).decode("ascii"),
                }, timeout=5.0)
            except (RPCError, RemoteError):
                return
            with self._lock:
                if resp["term"] > self.current_term:
                    self._become_follower(resp["term"], None)
                    return
                if self.role != LEADER or self.current_term != term:
                    return
                self.snapshot_chunks_sent += 1
            if not resp.get("success", True):
                # The follower discarded the reassembly (identity/offset
                # mismatch — e.g. it restarted mid-transfer): abort; the
                # next pass restarts from offset 0.
                return
            if done:
                break
            offset += len(piece)
        with self._lock:
            if self.role != LEADER or self.current_term != term:
                return
            self.match_index[pid] = max(self.match_index.get(pid, 0), snap_index)
            self.next_index[pid] = snap_index + 1
            self._peer_ack_at[pid] = time.monotonic()
            self.snapshots_sent += 1
        self._replicate_now.set()

    def _handle_install_snapshot(self, args: dict) -> dict:
        # Decode outside the lock: the payload can be MBs and is a pure
        # function of the request. (FSM restore + file writes stay under the
        # lock: they must be ordered against concurrent AppendEntries.)
        decoded = base64.b64decode(args["data"])
        with self._lock:
            term = args["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.role != FOLLOWER:
                self._become_follower(term, args["leader_id"])
            self.leader_id = args["leader_id"]
            self._election_deadline = self._random_deadline()
            self._last_leader_contact = time.monotonic()

            snap_index = args["last_included_index"]
            snap_term = args["last_included_term"]
            # Chunk reassembly (legacy single-shot senders omit offset/
            # done: one whole-payload chunk). Identity- and offset-checked:
            # any mismatch — a competing transfer, a dropped chunk, our own
            # restart mid-transfer — discards the buffer and fails the RPC
            # so the leader restarts from offset 0. Live AppendEntries
            # interleave freely between chunks; the suffix-retention rule
            # below reconciles whatever appended during the transfer.
            offset = int(args.get("offset", 0))
            done = bool(args.get("done", True))
            key = (snap_index, snap_term)
            if offset == 0:
                self._snap_chunks = bytearray()
                self._snap_chunks_key = key
            elif (self._snap_chunks is None
                    or self._snap_chunks_key != key
                    or len(self._snap_chunks) != offset):
                self._snap_chunks = None
                self._snap_chunks_key = None
                return {"term": self.current_term, "success": False}
            self._snap_chunks.extend(decoded)
            self.snapshot_chunks_received += 1
            if not done:
                return {"term": self.current_term, "success": True}
            data = bytes(self._snap_chunks)
            self._snap_chunks = None
            self._snap_chunks_key = None
            if snap_index <= self.commit_index:
                # Stale snapshot: we already have (and applied) everything
                # it contains.
                return {"term": self.current_term, "success": True}
            self.fsm.restore_bytes(data)
            # Paper §7: retain any log suffix that extends past the snapshot
            # and agrees with it; otherwise discard the whole log.
            last_idx, _ = self._last_log()
            if (last_idx > snap_index
                    and snap_index >= self.log_offset
                    and self._term_at(snap_index) == snap_term):
                del self.log[: snap_index - self.log_offset]
            else:
                self.log = []
            self.snapshot_index = snap_index
            self.snapshot_term = snap_term
            self.log_offset = snap_index
            self.log_offset_term = snap_term
            self._snap_data = data
            self.commit_index = max(self.commit_index, snap_index)
            self.last_applied = max(self.last_applied, snap_index)
            self._write_snapshot_file(snap_index, snap_term, data)
            self._truncate_persisted_log()
            self.snapshots_installed += 1
            self.logger.info(
                "raft: node %s installed snapshot at index %d",
                self.config.node_id, snap_index,
            )
            return {"term": self.current_term, "success": True}

    def _advance_commit_locked(self) -> None:
        """Advance commit index over majority-matched entries of the current
        term (paper §5.4.2), then apply."""
        last_idx, _ = self._last_log()
        old_commit = self.commit_index
        for n in range(last_idx, self.commit_index, -1):
            if self._term_at(n) != self.current_term:
                break
            votes = 1 + sum(
                1 for pid in self._other_peers() if self.match_index.get(pid, 0) >= n
            )
            if votes >= len(self.config.peers) // 2 + 1:
                self.commit_index = n
                break
        if self.commit_index > old_commit:
            self.commit_advances += 1
            now = time.monotonic()
            for i in range(old_commit + 1, self.commit_index + 1):
                rec = self._wp_open.get(i)
                if rec is not None:
                    rec["anchors"].setdefault("committed", now)
        self._apply_committed_locked()

    def _apply_committed_locked(self) -> None:
        while self.last_applied < self.commit_index:
            index = self.last_applied + 1
            entry = self._entry_at(index)
            rec = self._wp_open.get(index)
            if rec is not None:
                rec["anchors"]["fsm_start"] = time.monotonic()
            replaying = (index <= self.recovery["replay_target"]
                         and self.recovery["replay_wall_ms"] is None)
            if replaying and self._replay_started is None:
                self._replay_started = time.monotonic()
            try:
                if entry.msg_type == "_config":
                    self._apply_config_locked(entry.payload)
                elif entry.msg_type != "_noop":
                    self.fsm.apply(
                        index, entry.msg_type,
                        decode_payload(entry.msg_type, entry.payload),
                    )
                error = None
            except Exception as e:  # deterministic FSM error
                # Counted because the error is SWALLOWED for entries
                # nobody holds a future for (replicated followers): a
                # silently diverging FSM would otherwise leave zero
                # evidence.
                telemetry.incr_counter(("raft", "fsm_apply_error"))
                error = e
            self.last_applied = index
            if replaying:
                # Restart-replay accounting: entries re-applied from the
                # persisted tail, per msg_type, closed out when the tail
                # is exhausted (the recovery report's replay rate).
                self.recovery["entries_replayed"] += 1
                by_type = self.recovery["replayed_by_type"]
                by_type[entry.msg_type] = by_type.get(entry.msg_type, 0) + 1
                if index >= self.recovery["replay_target"]:
                    self.recovery["replay_wall_ms"] = round(
                        (time.monotonic() - self._replay_started) * 1000.0,
                        3,
                    )
            future = self._apply_futures.pop(index, None)
            if rec is not None:
                rec["anchors"]["fsm_end"] = time.monotonic()
            if future is not None and not future.done():
                if error is None:
                    future.set_result(index)
                else:
                    future.set_exception(error)
            if rec is not None:
                rec["anchors"]["resolved"] = time.monotonic()
                self._wp_open.pop(index, None)
                self._wp_done.append(rec)
                self._wp_seq += 1
        if (self.last_applied - self.snapshot_index
                >= self.config.snapshot_threshold and not self._compacting):
            self._compacting = True
            threading.Thread(
                target=self._compact_async, daemon=True,
                name=f"raft-compact-{self.config.node_id}",
            ).start()

    def _compact_async(self) -> None:
        """Snapshot the FSM and drop the log prefix (paper §7). The
        expensive parts — FSM serialization and the snapshot file write —
        run off the node lock so replication and elections aren't stalled
        (the reference snapshots in a background goroutine the same way).
        Only a cheap copy-on-write handle is taken under the lock."""
        t_compact0 = time.monotonic()
        try:
            with self._lock:
                idx = self.last_applied
                snap_term = self._term_at(idx)
                cow = getattr(self.fsm, "snapshot_cow", None)
                serialize = getattr(self.fsm, "serialize_cow", None)
                if cow is not None and serialize is not None:
                    handle = cow()
                    data = None
                else:
                    # FSMs without a COW snapshot serialize under the lock,
                    # stalling heartbeats/elections for the duration —
                    # acceptable only for small test FSMs. Production FSMs
                    # must provide snapshot_cow()/serialize_cow() (the
                    # server FSM does) so only a cheap handle is taken
                    # here.
                    data = self.fsm.snapshot_bytes()
            if data is None:
                data = serialize(handle)
            # Durability order: the snapshot file must hit disk before the
            # log prefix it replaces is truncated.
            self._write_snapshot_file(idx, snap_term, data)
            with self._lock:
                if idx <= self.snapshot_index:
                    return  # an InstallSnapshot overtook us
                # Keep a trailing tail of entries past the snapshot so
                # followers behind by < trailing_logs replicate normally.
                keep_from = max(
                    self.log_offset, idx - max(0, self.config.trailing_logs)
                )
                if keep_from > self.log_offset:
                    self.entries_truncated += keep_from - self.log_offset
                    self.log_offset_term = self._term_at(keep_from)
                    del self.log[: keep_from - self.log_offset]
                    self.log_offset = keep_from
                self.snapshot_index = idx
                self.snapshot_term = snap_term
                self._snap_data = data
                self._truncate_persisted_log()
                self.compactions += 1
                self.compaction_wall_ms += (
                    time.monotonic() - t_compact0
                ) * 1000.0
            self.logger.info(
                "raft: node %s compacted log through index %d "
                "(%d bytes snapshot)", self.config.node_id, idx, len(data),
            )
        finally:
            self._compacting = False

    def _handle_append_entries(self, args: dict) -> dict:
        with self._lock:
            term = args["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            # Valid leader for this term
            if term > self.current_term or self.role != FOLLOWER:
                self._become_follower(term, args["leader_id"])
            self.leader_id = args["leader_id"]
            self._election_deadline = self._random_deadline()
            self._last_leader_contact = time.monotonic()
            if self.removed:
                # A leader talking to us means we are a member again
                # (re-added by a committed _config entry on its side).
                self.removed = False

            prev_idx = args["prev_log_index"]
            prev_term = args["prev_log_term"]
            entries = args["entries"]
            if prev_idx < self.snapshot_index:
                # Everything at or below our snapshot index is committed and
                # matches the leader by definition; skip the overlap.
                skip = self.snapshot_index - prev_idx
                entries = entries[skip:]
                prev_idx = self.snapshot_index
                prev_term = self.snapshot_term
            last_idx, _ = self._last_log()
            if prev_idx > self.snapshot_index:
                if last_idx < prev_idx:
                    return {"term": self.current_term, "success": False,
                            "conflict_index": last_idx + 1}
                if self._term_at(prev_idx) != prev_term:
                    # Find the first index of the conflicting term
                    conflict_term = self._term_at(prev_idx)
                    first = prev_idx
                    while (first > self.log_offset + 1
                           and self._term_at(first - 1) == conflict_term):
                        first -= 1
                    return {"term": self.current_term, "success": False,
                            "conflict_index": first}

            # Append any new entries, truncating conflicts
            changed = False
            for i, wire in enumerate(entries):
                idx = prev_idx + 1 + i
                entry = _Entry.from_wire(wire)
                pos = idx - self.log_offset - 1
                append = False
                if len(self.log) > pos:
                    if self.log[pos].term != entry.term:
                        del self.log[pos:]
                        append = True
                else:
                    append = True
                if append:
                    # One dumps per appended entry, in the journal-line
                    # convention (index key included), so leader/follower/
                    # reloaded byte books agree for identical entries.
                    entry.wire_bytes = len(
                        json.dumps({"index": idx, **entry.to_wire()})
                    )
                    self.log.append(entry)
                    self.entries_appended += 1
                    self.bytes_appended += entry.wire_bytes
                    changed = True
            if changed:
                self._truncate_persisted_log()

            if args["leader_commit"] > self.commit_index:
                last_idx, _ = self._last_log()
                self.commit_index = min(args["leader_commit"], last_idx)
                self._apply_committed_locked()
            return {"term": self.current_term, "success": True}
