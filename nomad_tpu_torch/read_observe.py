"""Read-path observatory: per-endpoint serving attribution, the
watch/long-poll economy, and freshness accounting.

Port of nomad_tpu/read_observe.py (host code). ``/v1/agent/reads`` serves
the JSON body; the Prometheus exposition waits for the telemetry sinks.

The read-path scale-out (stale-read lanes, leader read-index,
per-follower watch registries) needs a measurement substrate: every
``/v1`` read, blocking query and SSE tail is attributed here. Borg
found the Borgmaster read-mostly and scaled it with link shards serving
cached state; Omega made read freshness a first-class number. Before
follower serving can be built honestly, its baseline must be banked —
this module is to the read arc what ``capacity.py`` was to defrag and
``raft_observe.py`` to durability.

:class:`ReadObservatory` is a READ-ONLY observer in the established
composition-root posture: constructed only in ``server/server.py``,
statically barred from decision paths (nomadlint OBS001). It owns a
:class:`ReadRecorder` — plain-data hot-path books the HTTP layer (the
exposition layer, outside the OBS001 decision scope) writes into — and
drains three ledgers:

- **per-endpoint serving attribution**: route-template-keyed request
  counts, latency p50/p95/p99, bytes out, and a plain/blocking/SSE lane
  split. Blocking queries are PARTITIONED into register→wake ``hold``
  time vs wake→respond ``serve`` time (the seam follower serving moves:
  hold stays wherever the watch lives, serve moves to whoever owns the
  data), reconciling by construction (serve = total − hold). SSE
  session books track active streams, frames delivered, ring
  truncations survived, and per-session lag vs the broker head.
- **watch-registry economy**: occupancy and wake fan-out of the
  coalesced index-bucketed registry (``state/store.py _Watch``) —
  watchers per bucket, wakes delivered per publish, the spurious-wake
  re-probe rate, and multi-bucket ticket-park depth. The registry keeps
  these as plain counters itself (zero imports of this module); the
  observatory just reads them.
- **freshness accounting**: every read response is stamped with the
  serving server's last-applied raft index and its age vs the leader
  commit index (``X-Nomad-Applied-Index`` / ``X-Nomad-Staleness``
  headers, stamped unconditionally — a protocol feature, not an
  observatory one), and the ages aggregate into a staleness
  distribution here so "staleness bounds honored" has a measured
  meaning before any stale read is ever served.

Surfaces: ``/v1/agent/reads`` (JSON + ``?format=prometheus``), SDK
``client.agent().reads()``, periodic ``Read``-topic snapshot events
(observer topic — excluded from the canonical determinism digest by
construction, ``events.OBSERVER_TOPICS``), the debug bundle's ``reads``
section, ``nomad_read_*`` lines on the main Prometheus scrape, and a
``reads`` section in every SIMLOAD artifact (the ``read-storm``
scenario banks the leader-only baseline).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from nomad_tpu_torch import telemetry

LANES = ("plain", "blocking", "sse")


@dataclass
class ReadObserveConfig:
    """The ``server { reads { ... } }`` block, parse-time validated
    (the CapacityConfig posture: typos and nonsense ranges fail config
    load, not first use)."""

    enabled: bool = True
    # Cadence of the observatory's watch-economy / freshness poll. The
    # recorder's books are live (the HTTP layer writes them in-line), so
    # any cadence is safe.
    poll_interval: float = 1.0
    # Cadence of Read-topic snapshot events (0 disables). Observer
    # topic: excluded from the canonical event digest by construction.
    events_interval: float = 10.0

    @classmethod
    def parse(cls, spec: Optional[Dict[str, Any]]) -> "ReadObserveConfig":
        if spec is None:
            return cls()
        if not isinstance(spec, dict):
            raise ValueError("reads config must be a mapping")
        known = set(cls.__dataclass_fields__)
        unknown = [k for k in spec if k not in known]
        if unknown:
            raise ValueError(
                f"unknown reads config key(s): {sorted(unknown)} "
                f"(have: {sorted(known)})"
            )
        out = cls(**{
            k: (bool(v) if k == "enabled" else float(v))
            for k, v in spec.items()
        })
        if out.poll_interval <= 0:
            raise ValueError("reads.poll_interval must be > 0")
        if out.events_interval < 0:
            raise ValueError("reads.events_interval must be >= 0")
        return out


def _q(sample) -> Dict[str, float]:
    return {
        "mean": round(sample.mean, 4),
        "max": round(sample.max, 4),
        **{k: round(v, 4) for k, v in sample.quantiles().items()},
    }


class _RouteBooks:
    """Per-route-template aggregates: request count, error count, bytes
    out, end-to-end latency quantiles, and the lane split."""

    __slots__ = ("count", "errors", "bytes_total", "latency", "lanes")

    def __init__(self):
        self.count = 0
        self.errors = 0
        self.bytes_total = 0
        self.latency = telemetry.AggregateSample()
        self.lanes = {lane: 0 for lane in LANES}

    def snapshot(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "errors": self.errors,
            "bytes_total": self.bytes_total,
            "lanes": dict(self.lanes),
            "latency_ms": _q(self.latency),
        }


class _BlockingBooks:
    """Per-route blocking-query partition: register→wake hold vs
    wake→respond serve, wake-vs-timeout outcome counts. Serve is derived
    as total − hold at record time, so ``hold.sum + serve.sum ==
    total.sum`` holds by construction (the stage_partition contract)."""

    __slots__ = ("count", "wakes", "timeouts", "hold", "serve", "total")

    def __init__(self):
        self.count = 0
        self.wakes = 0
        self.timeouts = 0
        self.hold = telemetry.AggregateSample()
        self.serve = telemetry.AggregateSample()
        self.total = telemetry.AggregateSample()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "wakes": self.wakes,
            "timeouts": self.timeouts,
            "hold_ms": _q(self.hold),
            "serve_ms": _q(self.serve),
            "total_ms": _q(self.total),
        }


class ReadRecorder:
    """The hot-path books: plain data under one lock, written by the
    HTTP layer per request and snapshotted by the observatory. Lives
    here (not in api/) so the books and their exposition share one
    module; api/ is exposition scope, outside the OBS001 decision bar,
    so the import direction is legal."""

    def __init__(self):
        self._lock = threading.Lock()
        self._routes: Dict[str, _RouteBooks] = {}
        self._blocking: Dict[str, _BlockingBooks] = {}
        # SSE session books.
        self.sse_started = 0
        self.sse_active = 0
        self.sse_frames = 0
        self.sse_truncations = 0
        self.sse_heartbeats = 0
        self._sse_lag = telemetry.AggregateSample()
        # Freshness: per-response staleness (leader commit − applied, in
        # raft entries) as stamped on the wire — the flat aggregate plus
        # a (serving role × consistency lane) split. Before follower
        # serving, one ledger was honest; with it, leader-served default
        # reads and follower-served stale reads are different promises
        # and averaging them together hides exactly the number the
        # stale-bound contract is about.
        self.responses_stamped = 0
        self._staleness = telemetry.AggregateSample()
        self._staleness_split: Dict[tuple, Any] = {}

    # -- per-request attribution --------------------------------------------

    def record_request(self, route: str, lane: str, status: int,
                       duration_s: float, nbytes: int) -> None:
        with self._lock:
            books = self._routes.get(route)
            if books is None:
                books = self._routes[route] = _RouteBooks()
            books.count += 1
            if status >= 400:
                books.errors += 1
            books.bytes_total += int(nbytes)
            books.latency.ingest(duration_s * 1000.0)
            books.lanes[lane] = books.lanes.get(lane, 0) + 1

    def record_blocking(self, route: str, hold_s: float, total_s: float,
                        woke: bool) -> None:
        """One finished blocking query: ``hold_s`` is register→wake wall
        (the time parked on the watch), ``total_s`` the whole request;
        serve = total − hold (clamped non-negative)."""
        hold_ms = max(hold_s, 0.0) * 1000.0
        total_ms = max(total_s, hold_s, 0.0) * 1000.0
        with self._lock:
            books = self._blocking.get(route)
            if books is None:
                books = self._blocking[route] = _BlockingBooks()
            books.count += 1
            if woke:
                books.wakes += 1
            else:
                books.timeouts += 1
            books.hold.ingest(hold_ms)
            books.serve.ingest(total_ms - hold_ms)
            books.total.ingest(total_ms)

    # -- SSE session books ---------------------------------------------------

    def sse_session_start(self) -> None:
        with self._lock:
            self.sse_started += 1
            self.sse_active += 1

    def sse_session_end(self) -> None:
        with self._lock:
            self.sse_active -= 1

    def sse_delivered(self, frames: int, lag_entries: int) -> None:
        """One delivered SSE batch: ``frames`` event frames went out and
        the session now trails the broker head (for its filter) by
        ``lag_entries``."""
        with self._lock:
            self.sse_frames += int(frames)
            self._sse_lag.ingest(float(max(lag_entries, 0)))

    def sse_truncated(self) -> None:
        """A session's cursor fell off the bounded ring: the Truncated
        frame is COUNTED, never absorbed into the ordinary frame books —
        a lagging tail that lost events must show up as loss."""
        with self._lock:
            self.sse_truncations += 1

    def sse_heartbeat(self) -> None:
        with self._lock:
            self.sse_heartbeats += 1

    # -- freshness ------------------------------------------------------------

    def record_staleness(self, age_entries: int, role: str = "leader",
                         lane: str = "default") -> None:
        """One stamped response: ``role`` is the serving server's raft
        role at stamp time, ``lane`` the consistency lane served
        (default/stale/linearizable — NOT the transport lane)."""
        with self._lock:
            self.responses_stamped += 1
            self._staleness.ingest(float(max(age_entries, 0)))
            key = (role or "leader", lane or "default")
            split = self._staleness_split.get(key)
            if split is None:
                split = self._staleness_split[key] = {
                    "count": 0, "sample": telemetry.AggregateSample(),
                }
            split["count"] += 1
            split["sample"].ingest(float(max(age_entries, 0)))

    # -- exposition -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "endpoints": {r: b.snapshot()
                              for r, b in sorted(self._routes.items())},
                "blocking": {r: b.snapshot()
                             for r, b in sorted(self._blocking.items())},
                "sse": {
                    "started": self.sse_started,
                    "active": self.sse_active,
                    "frames": self.sse_frames,
                    "truncations": self.sse_truncations,
                    "heartbeats": self.sse_heartbeats,
                    "lag_entries": _q(self._sse_lag),
                },
                "freshness": {
                    "responses_stamped": self.responses_stamped,
                    "staleness_entries": _q(self._staleness),
                    "by_role": {
                        role: {
                            lane: {
                                "count": split["count"],
                                "staleness_entries": _q(split["sample"]),
                            }
                            for (r, lane), split
                            in sorted(self._staleness_split.items())
                            if r == role
                        }
                        for role in sorted({
                            r for r, _ in self._staleness_split
                        })
                    },
                },
            }


class ReadObservatory:
    """Aggregates the read-path books: the recorder it owns (written by
    the HTTP layer), the watch registries' plain counters, and the raft
    node's applied/commit indexes. ``store_getter``/``raft_getter``
    re-read per refresh (snapshot installs rebind fsm.state; restarts
    rebind the node). All derived state lives under ``_lock``; no
    decision path ever takes it."""

    def __init__(self, store_getter: Callable[[], Any],
                 raft_getter: Callable[[], Any],
                 config: Optional[ReadObserveConfig] = None,
                 events=None):
        self._store = store_getter
        self._raft = raft_getter
        self.config = config or ReadObserveConfig()
        self._events = events
        self.recorder = ReadRecorder()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.polls = 0
        self.events_published = 0
        self._watch_state: Dict[str, Any] = {}
        self._watch_events: Dict[str, Any] = {}

    # -- refresh --------------------------------------------------------------

    def refresh(self) -> None:
        """One poll: sample the watch registries' economy counters. The
        recorder's books are live; this only captures the registry view.
        Safe to call from tests without the thread."""
        store = self._store()
        state_stats = (store.watch.stats()
                       if store is not None else {})
        broker = self._events
        event_stats = (broker.watch.stats()
                       if broker is not None else {})
        with self._lock:
            self.polls += 1
            self._watch_state = state_stats
            self._watch_events = event_stats

    def _freshness_core(self) -> Dict[str, Any]:
        raft = self._raft()
        applied = int(getattr(raft, "applied_index", 0) or 0)
        commit = int(getattr(raft, "commit_index", applied) or applied)
        return {
            "applied_index": applied,
            "commit_index": commit,
            "age_entries": max(commit - applied, 0),
        }

    # -- exposition -----------------------------------------------------------

    @staticmethod
    def _watch_view(stats: Dict[str, Any]) -> Dict[str, Any]:
        """One registry's economy view: occupancy spread + fan-out
        ratios derived from the plain counters (absent on older stats
        shapes degrade to zeros, never KeyError)."""
        buckets = stats.get("bucket_watchers") or []
        occupied = [n for n in buckets if n]
        notifies = stats.get("notifies", 0)
        wakes = stats.get("wakes_delivered", 0)
        return {
            **{k: stats.get(k, 0)
               for k in ("watchers", "peak_watchers", "max_watchers",
                         "rejected", "notifies", "buckets",
                         "wakes_delivered", "spurious_wakes",
                         "multi_waiters")},
            "buckets_occupied": len(occupied),
            "bucket_max_watchers": max(occupied, default=0),
            "wakes_per_notify": round(wakes / notifies, 4) if notifies
            else 0.0,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The ``/v1/agent/reads`` body."""
        body = self.recorder.snapshot()
        body["freshness"].update(self._freshness_core())
        with self._lock:
            body["watch"] = {
                "state": self._watch_view(self._watch_state),
                "events": self._watch_view(self._watch_events),
            }
            body["observer"] = {
                "polls": self.polls,
                "events_published": self.events_published,
            }
        return body

    def summary(self) -> Dict[str, Any]:
        """Compact agent-info line: request volume, worst endpoint p95,
        live SSE sessions, staleness headline."""
        snap = self.snapshot()
        worst = 0.0
        requests = 0
        for books in snap["endpoints"].values():
            requests += books["count"]
            worst = max(worst, books["latency_ms"].get("p95", 0.0))
        return {
            "requests": requests,
            "read_p95_ms_worst": round(worst, 3),
            "sse_active": snap["sse"]["active"],
            "staleness_p99_entries":
                snap["freshness"]["staleness_entries"].get("p99", 0.0),
            "watchers": snap["watch"]["state"]["watchers"],
        }

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if not self.config.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="read-observatory"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        next_event = (
            time.monotonic() + self.config.events_interval
            if self.config.events_interval else None
        )
        while not self._stop.wait(self.config.poll_interval):
            try:
                self.refresh()
                if (next_event is not None
                        and time.monotonic() >= next_event):
                    next_event = (
                        time.monotonic() + self.config.events_interval
                    )
                    self.publish_event()
            except Exception:
                # The observer must never take the agent down; the poll
                # loop retries next tick. Counted, not silent.
                telemetry.incr_counter(("read_observe", "poll_errors"))

    def publish_event(self) -> None:
        """One Read-topic snapshot event (trimmed payload). Observer
        topic: excluded from canonical event digests by construction
        (events.OBSERVER_TOPICS), so publishing cadence can never
        perturb the determinism contract."""
        if self._events is None:
            return
        snap = self.snapshot()
        self._events.publish(
            "Read", "ReadSnapshot", key="reads",
            payload={
                "requests": sum(b["count"]
                                for b in snap["endpoints"].values()),
                "lanes": {
                    lane: sum(b["lanes"].get(lane, 0)
                              for b in snap["endpoints"].values())
                    for lane in LANES
                },
                "sse_active": snap["sse"]["active"],
                "watchers": snap["watch"]["state"]["watchers"],
                "staleness_p99_entries":
                    snap["freshness"]["staleness_entries"].get("p99",
                                                               0.0),
            },
        )
        self.events_published += 1
