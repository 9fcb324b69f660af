"""SLO layer: declarative latency objectives, burn rates, live monitoring.

Port of nomad_tpu/slo.py (host code, no device work); the port's Server
builds the monitor as nomad_tpu's does.

The default target is p95 submit→placed under 250 ms. The artifacts
measure plan latency per run; this module is the live surface that says
"are we inside the objective right now, and how fast is the error budget
burning?":

- **Objectives** are declared in agent config (``telemetry { slo {
  submit_to_placed_p95_ms = 250 } }``) or ``ServerConfig.slo_objectives``;
  the spelling ``<metric>_p<NN>_ms = <threshold>`` is parsed into
  (metric, percentile objective, threshold).
- **Samples** come from the server's own event stream, not from new
  hot-path instruments: an :class:`SLOMonitor` thread tails the FSM's
  event broker (``EvalUpdated(pending)`` → ``PlanApplied`` →
  ``AllocClientUpdated(running)``) and computes submit→placed /
  submit→running per eval — read-only on decisions by construction, the
  same posture as the lifecycle stitcher.
- **Error budgets** ride :class:`telemetry.BurnRateWindow`: each sample
  is good iff it lands under the threshold; the objective percentile is
  the budget (p95 → 5% of samples may be bad per window).
- **Exposition**: ``/v1/agent/slo`` serves :meth:`SLOMonitor.snapshot`;
  the monitor also publishes ``slo.<name>.burn_rate`` /
  ``slo.<name>.budget_remaining`` gauges and a ``slo.<name>.breach``
  counter through the ordinary telemetry sink, so the Prometheus scrape
  carries them with zero extra wiring.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

from nomad_tpu_torch import structs, telemetry

# The metrics an objective may bind to. submit_to_placed is Sparrow's
# headline cut to durable placement; submit_to_running extends through the
# client ack (PAPERS.md); express_placed is the express lane's in-line
# submit→placed latency (server/express.py — sampled from ExpressPlaced
# events' placed_ms payload, the lane's own clock: PlanApplied lands
# asynchronously and would measure the commit, not the placement).
METRICS = ("submit_to_placed", "submit_to_running", "express_placed")

# Default objectives when none are configured: the placement target plus
# a looser end-to-end bound through the client ack.
DEFAULT_OBJECTIVES: Dict[str, float] = {
    "submit_to_placed_p95_ms": 250.0,
    "submit_to_running_p95_ms": 1000.0,
}

# The express lane's target (p50 submit→placed < 1 ms for
# express-eligible tasks at steady-10k). Merged over the defaults when a
# server runs with the lane enabled and no explicit objective set; NOT
# part of DEFAULT_OBJECTIVES — a lane-off server must keep its exact
# pre-express objective surface.
EXPRESS_OBJECTIVES: Dict[str, float] = {
    "express_placed_p50_ms": 1.0,
}

# Scenario-scoped objectives: SIMLOAD families whose CONTRACT is not the
# default cell SLO. The gate (tools/bench_watch.py) and the scenario
# runner's in-artifact slo_check both consult this table by scenario
# name, so a banked artifact and its CI verdict can never disagree about
# which promise was being judged.
#
# - churn-fragmentation (and its tier-1 smoke): the scenario's claim is
#   the capacity/stranding trajectory, and its probe wave INTENTIONALLY
#   races a deregistration stop storm of thousands of allocs — the p95
#   tail is the storm, not placement health. The scenario-scoped bound
#   (1 s) catches a real regression without pretending the run ever
#   promised the 250 ms steady-state SLO.
# - restart-under-load (and its smoke): evals caught mid-flight by the
#   leader kill wait out the downtime (re-election + snapshot restore +
#   log replay) and THEN place — survival and recovery speed
#   are the contract (the recovery gate judges those), so the placed
#   bound absorbs the declared downtime.
# - read-storm (and its smoke): the leader's HTTP front end serves an
#   impolite read fleet BY DESIGN while the steady-10k write load
#   places — the GIL contention between serving and planning is the
#   number the artifact banks (plan p50 under read pressure), and the
#   read lanes themselves are judged by bench_watch's read gate. The
#   1s placed bound catches a real write-path regression without
#   pretending the run ever promised the uncontended 250ms SLO.
SCENARIO_OBJECTIVES: Dict[str, Dict[str, float]] = {
    "churn-fragmentation": {**DEFAULT_OBJECTIVES,
                            "submit_to_placed_p95_ms": 1000.0},
    "churn-frag-200": {**DEFAULT_OBJECTIVES,
                       "submit_to_placed_p95_ms": 1000.0},
    "restart-under-load": {**DEFAULT_OBJECTIVES,
                           "submit_to_placed_p95_ms": 15000.0},
    "restart-800": {**DEFAULT_OBJECTIVES,
                    "submit_to_placed_p95_ms": 15000.0},
    # The read-storm families run a REPLICATED 3-member cell: every plan
    # is one raft entry fsynced and replicated on the 100 ms heartbeat
    # cadence, under election timeouts widened to 2.5-5 s for digest
    # determinism — placement p95 is replication-dominated, not
    # scheduler-bound.
    # The bound catches a pile-up regression on top of that floor; the
    # read-lane gate separately holds the leader's plan p50 to the
    # leader-only contrast arm.
    "read-storm": {**DEFAULT_OBJECTIVES,
                   "submit_to_placed_p95_ms": 5000.0},
    "read-storm-800": {**DEFAULT_OBJECTIVES,
                       "submit_to_placed_p95_ms": 5000.0},
    # Chaos families (nomad_tpu_torch/simcluster/chaos.py; the specs declare
    # the SAME bounds and register() re-merges them — declared here too
    # so a process that never imports the chaos compiler, like the
    # bench_watch slo-gate scan, judges the banked artifacts against
    # the declared bounds, and test_chaos.py pins the two in sync):
    # - rack-failure drains a 256-job full-node fill through ONE
    #   scheduler worker (determinism) — the fill's serial queue
    #   backlog IS the p95, and the chaos gate separately judges the
    #   expiry->re-placement quantiles the family actually promises.
    # - partition-flap drops the leader's append stream half of every
    #   flap period BY DESIGN — commit stalls during the storm are the
    #   scenario's point; the bound catches a real scheduling
    #   regression on top of the declared partition stalls.
    # - follower-crash-rejoin runs a 2-worker raft cell while a
    #   chunked snapshot streams to the rejoining follower; plans
    #   queued behind the kill/restart window wait it out.
    "rack-failure": {**DEFAULT_OBJECTIVES,
                     "submit_to_placed_p95_ms": 15000.0},
    "partition-flap": {**DEFAULT_OBJECTIVES,
                       "submit_to_placed_p95_ms": 5000.0},
    "follower-crash-rejoin": {**DEFAULT_OBJECTIVES,
                              "submit_to_placed_p95_ms": 5000.0},
}

# Read-lane objectives (the follower read plane): not
# latency-percentile objectives — contract checks on the consistency
# lanes a read-carrying artifact banks in its ``reads.lanes`` section.
# Judged offline by evaluate_read_lanes (the bench_watch read-lane
# gate), never by the live SLOMonitor: the lanes' promises (bound
# honored, share served by followers, zero linearizable violations) are
# per-run invariants, not rolling budgets.
READ_LANE_OBJECTIVES: Dict[str, float] = {
    # Followers must absorb at least this share of lane-entered reads
    # when the plane is on and the cell has followers to serve.
    "follower_serve_share_min": 0.80,
    # Served stale ages must sit inside the client bound: observed
    # stale-age p95 / bound must stay <= this ratio (1.0 = the bound
    # itself — the refusal path keeps anything past it off the books).
    "stale_age_p95_bound_ratio_max": 1.0,
    # Linearizable-lane responses observed with applied < read index.
    "linear_violations_max": 0.0,
    # Read responses missing the freshness stamp (every stale answer
    # must carry last-applied index + age — the acceptance contract).
    "stamp_missing_max": 0.0,
}


_NAME_RE = re.compile(r"^(?P<metric>[a-z_]+)_p(?P<pct>\d{1,2})_ms$")


@dataclass(frozen=True)
class Objective:
    """One parsed objective: ``percentile`` of ``metric`` samples must
    land at or under ``threshold_ms`` over the rolling window."""

    name: str
    metric: str
    percentile: float
    threshold_ms: float
    window_s: float = 3600.0

    @classmethod
    def parse(cls, name: str, threshold_ms: float,
              window_s: float = 3600.0) -> "Objective":
        m = _NAME_RE.match(name)
        if m is None:
            raise ValueError(
                f"SLO objective {name!r} must look like "
                "<metric>_p<NN>_ms (e.g. submit_to_placed_p95_ms)"
            )
        metric = m.group("metric")
        if metric not in METRICS:
            raise ValueError(
                f"SLO metric {metric!r} unknown (have: {METRICS})"
            )
        pct = int(m.group("pct"))
        if not 1 <= pct <= 99:
            raise ValueError(f"SLO percentile must be in [1, 99], got {pct}")
        threshold = float(threshold_ms)
        if threshold <= 0:
            raise ValueError(f"SLO threshold must be positive, got {threshold}")
        return cls(name=name, metric=metric, percentile=pct / 100.0,
                   threshold_ms=threshold, window_s=window_s)


def parse_objectives(spec: Optional[Dict[str, float]],
                     window_s: float = 3600.0) -> List[Objective]:
    """Config block -> objective list; None/empty means the defaults."""
    items = spec if spec else DEFAULT_OBJECTIVES
    return [Objective.parse(name, ms, window_s)
            for name, ms in sorted(items.items())]


class _Tracker:
    """One objective's rolling accounting: burn-rate window + a bounded
    reservoir so the snapshot reports the observed percentile next to
    the target."""

    __slots__ = ("objective", "window", "sample")

    def __init__(self, objective: Objective):
        self.objective = objective
        self.window = telemetry.BurnRateWindow(
            window_s=objective.window_s, objective=objective.percentile,
        )
        self.sample = telemetry.AggregateSample()

    def record(self, value_ms: float) -> bool:
        good = value_ms <= self.objective.threshold_ms
        self.window.record(good)
        self.sample.ingest(value_ms)
        return good

    def reset(self) -> None:
        """Fresh window + reservoir (the monitor's warmup boundary)."""
        o = self.objective
        self.window = telemetry.BurnRateWindow(
            window_s=o.window_s, objective=o.percentile,
        )
        self.sample = telemetry.AggregateSample()

    def snapshot(self) -> Dict[str, Any]:
        o = self.objective
        stats = self.window.stats()
        quantiles = self.sample.quantiles()
        return {
            "name": o.name,
            "metric": o.metric,
            "percentile": o.percentile,
            "threshold_ms": o.threshold_ms,
            "observed": {
                "count": self.sample.count,
                "max_ms": round(self.sample.max, 2),
                **{k: round(v, 2) for k, v in quantiles.items()},
            },
            # Inside the objective iff the bad fraction stays within the
            # budget the percentile grants.
            "met": stats["burn_rate"] <= 1.0,
            **stats,
        }


class SLOMonitor(threading.Thread):
    """Tails one server's event broker and keeps the SLO books.

    Deliberately a CONSUMER of the bounded event ring rather than a
    hot-path hook: the control plane publishes exactly what it published
    before (SIMLOAD event digests pin this), and a wedged monitor can
    never block an apply. The cost of that posture is honesty about
    loss: if the monitor ever falls further behind than the ring, the
    gap is counted (``truncated_gaps``), not silently absorbed."""

    # Bounded pending/placed maps: an eval that never places (or whose
    # running ack never arrives) must not leak forever.
    MAX_TRACKED = 8192

    def __init__(self, broker, objectives: Optional[Dict[str, float]] = None,
                 window_s: float = 3600.0, poll_interval: float = 0.25):
        super().__init__(daemon=True, name="slo-monitor")
        self.broker = broker
        self.trackers = [_Tracker(o)
                         for o in parse_objectives(objectives, window_s)]
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # Serializes whole drain-and-record passes (poll) against the
        # warmup-boundary wipe (reset): without it a concurrent poll
        # could fetch warmup events BEFORE the wipe and record them
        # AFTER, leaking exactly the sample reset() exists to exclude.
        self._poll_lock = threading.Lock()
        self._cursor = 0
        # eval id -> EvalUpdated(pending) wall stamp / PlanApplied stamp.
        self._pending: "Dict[str, float]" = {}
        self._placed: "Dict[str, float]" = {}
        # Insertion-ordered dedup table (value unused): evals whose
        # running transition is already counted. A dict, not a set, so
        # overflow evicts oldest-first like the other tables — wiping it
        # would let every later alloc ack of an already-counted eval
        # re-record an inflated submit_to_running sample.
        self._running_seen: "Dict[str, bool]" = {}
        self.samples = {m: telemetry.AggregateSample() for m in METRICS}
        self.truncated_gaps = 0
        # Warmup boundary accounting (reset()): how many times the books
        # were wiped and how many samples each wipe discarded — honesty
        # about what the live monitor is NOT counting.
        self.resets = 0
        self.reset_excluded = 0

    # -- lifecycle -----------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            self.poll()
        self.poll()  # final drain so short-lived servers still account

    def poll(self) -> None:
        with self._poll_lock:
            latest, events, truncated = self.broker.events_after(
                self._cursor)
            if truncated and self._cursor:
                self.truncated_gaps += 1
                telemetry.incr_counter(("slo", "monitor", "truncated_gap"))
            self._cursor = latest
            if events:
                self.observe(events)

    # -- accounting ----------------------------------------------------------

    def observe(self, events: Iterable) -> None:
        """Feed a batch of events (Event objects) through the lifecycle
        accounting. Separated from the thread loop so tests drive it
        synchronously with synthetic streams."""
        with self._lock:
            for e in events:
                if e.topic == "Eval" and e.type == "EvalUpdated":
                    if (e.payload.get("status")
                            == structs.EVAL_STATUS_PENDING
                            and e.key not in self._pending
                            and e.key not in self._placed):
                        self._pending[e.key] = e.time
                        self._evict_locked(self._pending)
                elif e.topic == "Plan" and e.type == "PlanApplied":
                    t0 = self._pending.pop(e.key, None)
                    if t0 is not None and e.key not in self._placed:
                        self._placed[e.key] = t0
                        self._evict_locked(self._placed)
                        self._record_locked(
                            "submit_to_placed", (e.time - t0) * 1000.0
                        )
                elif e.topic == "Express" and e.type == "ExpressPlaced":
                    # The express lane's in-line placement latency rides
                    # the event payload (the async PlanApplied would
                    # measure the commit, not the sub-ms placement).
                    ms = e.payload.get("placed_ms")
                    if ms is not None:
                        self._record_locked("express_placed", float(ms))
                elif e.topic == "Alloc" and e.type == "AllocClientUpdated":
                    ev_id = e.payload.get("eval_id", "")
                    if (ev_id
                            and e.payload.get("client_status")
                            == structs.ALLOC_CLIENT_STATUS_RUNNING
                            and ev_id not in self._running_seen):
                        t0 = self._placed.get(ev_id)
                        if t0 is not None:
                            self._running_seen[ev_id] = True
                            self._evict_locked(self._running_seen)
                            self._record_locked(
                                "submit_to_running", (e.time - t0) * 1000.0
                            )
            self._publish_gauges_locked()

    def reset(self) -> None:
        """Drop every sample and error-budget window accumulated so far
        (counted — ``resets``/``reset_excluded`` surface in snapshot()).
        The scenario runner calls this at the warmup boundary so the
        live monitor judges the measured window's steady state: without
        it, warmup's cold-compile evaluations burn the error budget and
        ``/v1/agent/slo`` reports a breach the steady state never had.
        Drains the event ring first so a
        warmup eval whose events are still unpolled can't leak across
        the boundary; serialized with poll() so an in-flight drain can
        never record pre-boundary events after the wipe."""
        with self._poll_lock:
            # Drain under the poll lock ONLY (the broker lock must not
            # nest inside the monitor lock — poll()'s observe() orders
            # them broker-then-monitor), then wipe under the monitor
            # lock.
            latest, _events, _trunc = self.broker.events_after(
                self._cursor)
            self._cursor = latest
            self._reset_books_locked()

    def _reset_books_locked(self) -> None:
        with self._lock:
            excluded = sum(agg.count for agg in self.samples.values())
            self.resets += 1
            self.reset_excluded += excluded
            for tr in self.trackers:
                tr.reset()
            self.samples = {m: telemetry.AggregateSample()
                            for m in METRICS}
            self._pending.clear()
            self._placed.clear()
            self._running_seen.clear()
            self._publish_gauges_locked()

    def _evict_locked(self, table: Dict[str, Any]) -> None:
        # Oldest-inserted eviction (dict preserves insertion order): an
        # abandoned eval costs one slot, never unbounded growth.
        while len(table) > self.MAX_TRACKED:
            table.pop(next(iter(table)))

    def _record_locked(self, metric: str, value_ms: float) -> None:
        self.samples[metric].ingest(value_ms)
        telemetry.add_sample(("slo", metric), value_ms)
        for tr in self.trackers:
            if tr.objective.metric == metric:
                if not tr.record(value_ms):
                    telemetry.incr_counter(
                        ("slo", tr.objective.name, "breach")
                    )

    def _publish_gauges_locked(self) -> None:
        for tr in self.trackers:
            stats = tr.window.stats()
            telemetry.set_gauge(
                ("slo", tr.objective.name, "burn_rate"),
                stats["burn_rate"],
            )
            telemetry.set_gauge(
                ("slo", tr.objective.name, "budget_remaining"),
                stats["budget_remaining_fraction"],
            )

    # -- exposition ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``/v1/agent/slo`` body: every objective's target vs
        observed percentiles, budget state, burn rate; plus the raw
        per-metric sample aggregates."""
        with self._lock:
            objectives = [tr.snapshot() for tr in self.trackers]
            samples = {
                m: {
                    "count": agg.count,
                    "mean_ms": round(agg.mean, 2),
                    "max_ms": round(agg.max, 2),
                    **{k: round(v, 2) for k, v in agg.quantiles().items()},
                }
                for m, agg in self.samples.items()
            }
            return {
                "objectives": objectives,
                "samples": samples,
                "pending_evals": len(self._pending),
                "truncated_gaps": self.truncated_gaps,
                "resets": self.resets,
                "reset_excluded": self.reset_excluded,
            }

    def burn_rate(self, metric: str = "submit_to_placed") -> float:
        """Worst (max) error-budget burn rate over the objectives bound
        to ``metric`` — the admission front door's shed signal
        (server/admission.py): >1.0 means the budget runs out before the
        window does. 0.0 with no matching objective."""
        with self._lock:
            return max(
                (tr.window.stats()["burn_rate"] for tr in self.trackers
                 if tr.objective.metric == metric),
                default=0.0,
            )

    def summary(self) -> Dict[str, Any]:
        """Compact agent-info line: objective name -> met/burn_rate."""
        with self._lock:
            return {
                tr.objective.name: {
                    "met": tr.window.stats()["burn_rate"] <= 1.0,
                    "burn_rate": tr.window.stats()["burn_rate"],
                    "count": tr.sample.count,
                }
                for tr in self.trackers
            }


def evaluate_artifact(attribution: Dict[str, Any],
                      objectives: Optional[Dict[str, float]] = None,
                      ) -> List[Dict[str, Any]]:
    """Offline check of a SIMLOAD ``latency_attribution`` section against
    objectives (the bench_watch / CI gate path): for each objective,
    compare the artifact's observed percentile of the metric against the
    threshold. Artifact percentiles come at fixed cuts (p50/p95/p99) —
    an objective at another percentile is checked against the next
    STRICTER recorded cut (conservative, never lenient)."""
    out: List[Dict[str, Any]] = []
    cuts = (0.50, 0.95, 0.99)
    for o in parse_objectives(objectives):
        block = attribution.get(o.metric + "_ms") or {}
        stricter = [c for c in cuts if c >= o.percentile]
        cut = min(stricter) if stricter else max(cuts)
        observed = block.get(f"p{int(cut * 100)}_ms")
        n = block.get("n", 0)
        met = None if (observed is None or not n) else observed <= o.threshold_ms
        out.append({
            "objective": o.name,
            "threshold_ms": o.threshold_ms,
            "checked_percentile": cut,
            "observed_ms": observed,
            "n": n,
            "met": met,
        })
    return out


def evaluate_read_lanes(artifact: Dict[str, Any],
                        objectives: Optional[Dict[str, float]] = None,
                        ) -> List[Dict[str, Any]]:
    """Offline check of a SIMLOAD artifact's ``reads.lanes`` section
    against the read-lane objectives (the bench_watch read-lane gate
    path). Empty when the artifact never ran the read plane (no lanes
    section, or ``enabled: false`` — the leader-only contrast arm):
    the lane contract can only be judged where lanes were served."""
    lanes = ((artifact.get("reads") or {}).get("lanes")) or {}
    if not lanes.get("enabled"):
        return []
    obj = dict(READ_LANE_OBJECTIVES)
    obj.update(objectives or {})
    rows: List[Dict[str, Any]] = []

    def row(name: str, threshold: float, observed, met) -> None:
        rows.append({"objective": name, "threshold": threshold,
                     "observed": observed, "met": met})

    share = lanes.get("follower_serve_share")
    # A single-member cell has no followers to serve; the share
    # objective only binds where the cell could route around the leader.
    members = int(lanes.get("members", 1) or 1)
    row("follower_serve_share",
        obj["follower_serve_share_min"], share,
        None if (share is None or members <= 1)
        else share >= obj["follower_serve_share_min"])

    bound = lanes.get("stale_bound_ms")
    age_p95 = (lanes.get("stale_age_ms") or {}).get("p95")
    ratio = (None if (bound is None or age_p95 is None or not bound)
             else age_p95 / float(bound))
    row("stale_age_p95_bound_ratio",
        obj["stale_age_p95_bound_ratio_max"],
        None if ratio is None else round(ratio, 4),
        None if ratio is None
        else ratio <= obj["stale_age_p95_bound_ratio_max"])

    for name, key in (("linear_violations", "linear_violations"),
                      ("stamp_missing", "stamp_missing")):
        observed = lanes.get(key)
        row(name, obj[name + "_max"], observed,
            None if observed is None
            else observed <= obj[name + "_max"])
    return rows
