"""Raft & recovery observatory: write-path attribution, replication lag,
log/snapshot economy, and the restart-replay timeline.

Port of nomad_tpu/raft_observe.py, plain host Python as there: it reads
the raft node's and the FSM's plain-data books and no decision path
imports it.

ROADMAP item 2 says the replicated write path must "survive production
traffic and restarts" — but until now it was a black box: "every plan is
one raft entry" was a sentence, not a measured cost; follower lag,
log-growth vs compaction economy, and how long a cold restart takes to
replay back to serving were all unobserved. Before the durability arc
(group-commit, log batching) can be built honestly, its baseline must be
measurable — this module is to item 2 what the capacity observatory
(``capacity.py``) was to the defrag arc.

:class:`RaftObservatory` is a READ-ONLY observer (the Omega shared-state
posture): it drains the plain-data books the raft node itself keeps —
``RaftNode`` records one bounded anchor record per leader-submitted
entry (submit → persisted → first-ack → committed → fsm-apply →
future-resolve wall stamps, zero imports of this module) plus log/
snapshot/peer counters, and ``server/fsm.py`` stamps its last
snapshot-restore wall and row counts — and aggregates them. It holds no
hot-path hook, takes no lock any decision path takes, and decision-path
modules are statically barred from importing it (nomadlint OBS001, the
same composition-root rule as the capacity accountant).

What it reports (the ``/v1/agent/raft`` body):

- **write-path attribution**: per ``msg_type``, a stage PARTITION of
  submit→applied — ``append_persist`` / ``replicate`` / ``quorum`` /
  ``apply_wait`` / ``fsm_apply`` / ``future_resolve`` — with p50/p95/p99
  per stage and bytes-per-entry. The stages are consecutive anchor
  differences (a missing anchor collapses to zero width), so the stage
  sums reconcile with the measured submit→applied by construction — the
  same contract ``lifecycle.py`` pins for the eval waterfall.
- **replication & log economy**: per-follower lag (match-index delta and
  last-ack age), leader commit-index advance rate, log length/bytes,
  compaction and snapshot counters with wall cost and on-disk size, and
  the entries-retained-vs-truncated split (the ``snapshot_threshold`` /
  ``trailing_logs`` economy).
- **recovery timeline**: a cold restart's structured report — snapshot-
  restore wall (+ the FSM's restored row counts), log entries replayed
  with per-type counts and replay rate, time-to-leader, and
  time-to-serving (leadership established, broker restored).

Surfaces: ``/v1/agent/raft`` (JSON; ``?format=prometheus`` answers 501
until the telemetry sinks are ported), SDK ``client.agent().raft()``,
periodic ``Raft``-topic snapshot events (observer topic — excluded from
the canonical determinism digest by construction,
``events.OBSERVER_TOPICS``), and a ``raft`` section in every scenario
artifact (the ``restart-under-load`` scenario banks the recovery
timeline).
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from nomad_tpu_torch import telemetry

# The write-path anchor chain, in wall order. Each stage below is the
# difference between consecutive anchors; an anchor the entry never hit
# (e.g. first_ack on a single-member cluster) carries the previous
# anchor's stamp forward, so its stage is exactly zero wide and the
# partition property (stage sums == resolved - submit) holds regardless.
ANCHORS = ("submit", "persisted", "first_ack", "committed",
           "fsm_start", "fsm_end", "resolved")

# Stage i spans ANCHORS[i] -> ANCHORS[i+1].
STAGES = ("append_persist", "replicate", "quorum", "apply_wait",
          "fsm_apply", "future_resolve")


def stage_partition(anchors: Dict[str, float]) -> Dict[str, float]:
    """Reduce one entry's anchor stamps into the stage partition (ms).

    Contract (unit-pinned in tests/test_raft_observe.py): the returned
    stage widths are non-negative and sum EXACTLY to
    ``resolved - submit`` — missing or out-of-order intermediate anchors
    clamp to the running cursor instead of going negative, the same
    reconciliation discipline as lifecycle.py's waterfall."""
    cursor = anchors.get("submit", 0.0)
    out: Dict[str, float] = {}
    for stage, anchor in zip(STAGES, ANCHORS[1:]):
        t = anchors.get(anchor)
        if t is None or t < cursor:
            t = cursor
        out[stage] = (t - cursor) * 1000.0
        cursor = t
    return out


@dataclass
class RaftObserveConfig:
    """The ``server { raft_observe { ... } }`` block, parse-time
    validated (the CapacityConfig posture: typos and nonsense ranges
    fail config load, not first use)."""

    enabled: bool = True
    # Cadence of the observatory's drain of the raft node's books. The
    # node's record ring is bounded (overflow is counted as
    # records_dropped, never silent), so any cadence is safe.
    poll_interval: float = 1.0
    # Cadence of Raft-topic snapshot events (0 disables). Observer
    # topic: excluded from the canonical event digest by construction.
    events_interval: float = 10.0

    @classmethod
    def parse(cls, spec: Optional[Dict[str, Any]]) -> "RaftObserveConfig":
        if spec is None:
            return cls()
        if not isinstance(spec, dict):
            raise ValueError("raft_observe config must be a mapping")
        known = set(cls.__dataclass_fields__)
        unknown = [k for k in spec if k not in known]
        if unknown:
            raise ValueError(
                f"unknown raft_observe config key(s): {sorted(unknown)} "
                f"(have: {sorted(known)})"
            )
        out = cls(**{
            k: (bool(v) if k == "enabled" else float(v))
            for k, v in spec.items()
        })
        if out.poll_interval <= 0:
            raise ValueError("raft_observe.poll_interval must be > 0")
        if out.events_interval < 0:
            raise ValueError("raft_observe.events_interval must be >= 0")
        return out


class _MsgBooks:
    """Per-msg_type aggregates: entry count, bytes, total submit→applied
    quantiles, and per-stage quantiles (reservoir-backed
    telemetry.AggregateSample — the /v1/agent/metrics posture)."""

    __slots__ = ("count", "bytes_total", "bytes_sample", "total",
                 "stages")

    def __init__(self):
        self.count = 0
        self.bytes_total = 0
        self.bytes_sample = telemetry.AggregateSample()
        self.total = telemetry.AggregateSample()
        self.stages = {s: telemetry.AggregateSample() for s in STAGES}

    def ingest(self, record: Dict[str, Any]) -> None:
        anchors = record.get("anchors") or {}
        stages = stage_partition(anchors)
        total_ms = sum(stages.values())
        self.count += 1
        nbytes = int(record.get("bytes", 0))
        self.bytes_total += nbytes
        self.bytes_sample.ingest(float(nbytes))
        self.total.ingest(total_ms)
        for stage, ms in stages.items():
            self.stages[stage].ingest(ms)

    @staticmethod
    def _q(sample) -> Dict[str, float]:
        return {
            "mean": round(sample.mean, 4),
            "max": round(sample.max, 4),
            **{k: round(v, 4) for k, v in sample.quantiles().items()},
        }

    def snapshot(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "bytes_total": self.bytes_total,
            "bytes_per_entry": self._q(self.bytes_sample),
            "total_ms": self._q(self.total),
            "stages_ms": {s: self._q(agg)
                          for s, agg in self.stages.items()},
        }


class RaftObservatory:
    """Aggregates the raft node's plain-data observability books.

    ``raft_getter`` re-reads per refresh (the InProcRaft → RaftNode and
    restart rebind cases); a node without the book surface (DevMode
    InProcRaft) degrades to the applied-index view. All aggregate state
    lives under ``_lock``; no decision path ever takes it."""

    # Commit-index samples retained for the advance-rate window.
    RATE_SAMPLES = 600

    def __init__(self, raft_getter: Callable[[], Any],
                 config: Optional[RaftObserveConfig] = None,
                 events=None,
                 fsm_getter: Optional[Callable[[], Any]] = None):
        self._raft = raft_getter
        self._fsm = fsm_getter
        self.config = config or RaftObserveConfig()
        self._events = events
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cursor = 0
        self._raft_id = None  # id() of the node the cursor belongs to
        self._msg: Dict[str, _MsgBooks] = {}
        # (monotonic t, commit_index) ring for the advance-rate series.
        self._commit_samples: "deque" = deque(maxlen=self.RATE_SAMPLES)
        self.polls = 0
        self.records_ingested = 0
        self.records_dropped = 0
        self.events_published = 0

    # -- refresh -------------------------------------------------------------

    def refresh(self) -> None:
        """One poll: drain finalized write-path records from the raft
        node and fold them into the per-msg_type books. Safe to call
        from tests without the thread."""
        raft = self._raft()
        if raft is None:
            return
        drain = getattr(raft, "write_path_records", None)
        with self._lock:
            self.polls += 1
            if id(raft) != self._raft_id:
                # A restart (or InProc→Raft rebind) replaced the node:
                # its record sequence starts over. Books are cumulative
                # across the process (the restart story WANTS the pre-
                # and post-kill write costs side by side); only the
                # cursor resets.
                self._raft_id = id(raft)
                self._cursor = 0
            if drain is not None:
                seq, records = drain(self._cursor)
                missed = (seq - self._cursor) - len(records)
                if missed > 0:
                    # Counted even across a restart's cursor reset (or a
                    # late attach): a finalized record the observatory
                    # never ingested is a drop, never silent.
                    self.records_dropped += missed
                self._cursor = seq
                for rec in records:
                    self._msg.setdefault(
                        rec.get("msg_type", "?"), _MsgBooks()
                    ).ingest(rec)
                    self.records_ingested += 1
            import time as _time

            self._commit_samples.append(
                (_time.monotonic(), int(getattr(raft, "commit_index",
                                                raft.applied_index)))
            )

    def absorb(self, other: Optional["RaftObservatory"]) -> None:
        """Adopt a predecessor observatory's cumulative books. The
        restart scenario replaces the whole server object mid-run; the
        write-path attribution must span both lives (pre-kill plan
        commits next to post-restart ones). The predecessor must be
        stopped — it is drained once more here and never touched again.
        Locks are taken sequentially, never nested."""
        if other is None:
            return
        other.refresh()  # final drain of the dead node's record ring
        with other._lock:
            msg = dict(other._msg)
            ingested = other.records_ingested
            dropped = other.records_dropped
            polls = other.polls
            samples = list(other._commit_samples)
        with self._lock:
            for msg_type, books in msg.items():
                self._msg.setdefault(msg_type, books)
            self.records_ingested += ingested
            self.records_dropped += dropped
            self.polls += polls
            for s in samples:
                self._commit_samples.append(s)

    def _advance_rate(self) -> Dict[str, Any]:
        """Commit-index advance rate over the retained sample window
        (entries committed per second, as the observatory saw it)."""
        with self._lock:
            samples = list(self._commit_samples)
        if len(samples) < 2:
            return {"entries_per_s": 0.0, "window_s": 0.0}
        t0, c0 = samples[0]
        t1, c1 = samples[-1]
        dt = max(t1 - t0, 1e-9)
        return {
            "entries_per_s": round(max(c1 - c0, 0) / dt, 2),
            "window_s": round(dt, 1),
        }

    # -- exposition ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``/v1/agent/raft`` body."""
        raft = self._raft()
        observe = getattr(raft, "observe_stats", None)
        if observe is not None:
            core = observe()
        else:
            # DevMode InProcRaft: no replication layer to attribute.
            core = {
                "state": "inproc",
                "applied_index": (raft.applied_index
                                  if raft is not None else 0),
            }
        # A replication layer without a recovery record (DevMode
        # InProcRaft) still serves a stable shape: never cold-started.
        recovery = dict(getattr(raft, "recovery", None)
                        or {"cold_start": False})
        fsm = self._fsm() if self._fsm is not None else None
        restore = getattr(fsm, "last_restore", None)
        if restore is not None:
            recovery["fsm_restore"] = dict(restore)
        replayed = recovery.get("entries_replayed") or 0
        replay_wall_ms = recovery.get("replay_wall_ms")
        if replayed and replay_wall_ms:
            recovery["replay_entries_per_s"] = round(
                replayed / (replay_wall_ms / 1000.0), 1)
        with self._lock:
            write_path = {m: b.snapshot()
                          for m, b in sorted(self._msg.items())}
            observer = {
                "polls": self.polls,
                "records_ingested": self.records_ingested,
                "records_dropped": self.records_dropped,
                "events_published": self.events_published,
            }
        return {
            "raft": core,
            "write_path": write_path,
            "replication": {
                "peers": core.get("peers", {}),
                "commit_advance": self._advance_rate(),
            },
            "log": core.get("log", {}),
            "snapshot": core.get("snapshot", {}),
            "recovery": recovery,
            "observer": observer,
        }

    def summary(self) -> Dict[str, Any]:
        """Compact agent-info line: applied index, log economy headline,
        worst write-path p95."""
        snap = self.snapshot()
        worst = 0.0
        for books in snap["write_path"].values():
            worst = max(worst, books["total_ms"].get("p95", 0.0))
        return {
            "applied_index": snap["raft"].get("applied_index", 0),
            "log_entries": snap["log"].get("entries", 0),
            "write_p95_ms_worst": round(worst, 3),
            "recovered": bool(snap["recovery"].get("cold_start")),
        }

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if not self.config.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="raft-observatory"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        import time as _time

        next_event = (
            _time.monotonic() + self.config.events_interval
            if self.config.events_interval else None
        )
        while not self._stop.wait(self.config.poll_interval):
            try:
                self.refresh()
                if (next_event is not None
                        and _time.monotonic() >= next_event):
                    next_event = (
                        _time.monotonic() + self.config.events_interval
                    )
                    self.publish_event()
            except Exception:
                # The observer must never take the agent down; the poll
                # loop retries next tick. Counted, not silent.
                telemetry.incr_counter(("raft_observe", "poll_errors"))

    def publish_event(self) -> None:
        """One Raft-topic snapshot event (trimmed payload). Observer
        topic: excluded from canonical event digests by construction
        (events.OBSERVER_TOPICS), so publishing cadence can never
        perturb the determinism contract."""
        if self._events is None:
            return
        snap = self.snapshot()
        self._events.publish(
            "Raft", "RaftSnapshot", key="raft",
            payload={
                "applied_index": snap["raft"].get("applied_index", 0),
                "commit_index": snap["raft"].get("commit_index", 0),
                "log_entries": snap["log"].get("entries", 0),
                "log_bytes": snap["log"].get("bytes", 0),
                "peers": {
                    pid: {"lag_entries": p.get("lag_entries")}
                    for pid, p in snap["replication"]["peers"].items()
                },
                "write_p95_ms": {
                    m: b["total_ms"].get("p95", 0.0)
                    for m, b in snap["write_path"].items()
                },
            },
        )
        self.events_published += 1


def fsm_state_digest(store) -> str:
    """Canonical digest of a state store's replicated contents — the
    restart contract's yardstick: a cold restart's replayed FSM must
    reproduce the pre-kill digest exactly (tests/test_raft_observe.py
    e2e; the restart-under-load scenario asserts the placement subset).
    Reduces each table to sorted, order-independent rows of the fields
    replication is responsible for."""
    snap = store.snapshot()
    doc = {
        "nodes": sorted(
            (n.id, n.status, bool(n.drain), n.modify_index)
            for n in snap.nodes()
        ),
        "jobs": sorted(
            (j.id, j.type, j.modify_index) for j in snap.jobs()
        ),
        "evals": sorted(
            (e.id, e.status, e.modify_index) for e in snap.evals()
        ),
        "allocs": sorted(
            (a.id, a.node_id, a.job_id, a.desired_status,
             a.client_status)
            for a in snap.allocs()
        ),
        "indexes": {
            t: snap.get_index(t)
            for t in ("nodes", "jobs", "evals", "allocs")
        },
    }
    return hashlib.sha256(
        json.dumps(doc, separators=(",", ":"), sort_keys=True).encode()
    ).hexdigest()
