"""Admission control & backpressure: the cluster's bounded front door.

Port of nomad_tpu/server/admission.py (host code, the same seeded shed
stream from the port's prng.py).

The SLO monitor makes submit→placed latency and the 250 ms objective a
live, burn-rate-monitored metric; this bounds what hits the broker (a
burst only works unbounded when its injector is polite).
Borg's front door admits by quota and sheds rather than queues
unboundedly, and Sparrow's framing is exactly task latency under overload
(PAPERS.md): serving millions of users means rejecting fast and cheap so
admitted work keeps its latency promise, instead of degrading for
everyone. This module is that front door, checked at the job-registration
/ eval-ingress RPC boundaries BEFORE any raft apply — a rejection
provably had zero side effects, which is what makes the typed retry
contract (structs.RejectError) safe to honor blindly.

Three gates, in order (token-free capacity gates first, so a rejection
they issue never burns the client's rate token — a consumed token always
corresponds to an actual admission):

1. **Acceptance-queue bound.** When the broker's pending total (ready +
   blocked + waiting) is at ``eval_pending_cap``, reject ``QUEUE_FULL``
   — the front-door twin of the broker's own enforced cap
   (eval_broker.py), which remains as defense in depth for internally
   generated evals.
2. **SLO-coupled load shedding.** When the placed-latency error budget
   burns hot (slo.SLOMonitor burn rate for ``submit_to_placed``), shed
   the batch lane first with probability ramping from 0 at
   ``shed_start_burn`` to 1 at ``shed_full_burn`` — service lanes keep
   flowing (Borg's priority posture: batch yields). Shed draws come from
   a name-salted seeded stream (nomad_tpu_torch/prng.py), so given the same
   decision sequence the shed pattern replays — and nomadlint DET001
   stays clean.
3. **Per-client token-bucket rate lanes.** Each (client, lane) pair owns
   a bucket of ``client_burst`` tokens refilling at ``client_rate``/s
   (lane = "batch" for batch jobs, "service" otherwise). An empty bucket
   rejects ``RATE_LIMITED`` with a deterministic retry-after hint
   ((deficit)/rate — exactly when the next token lands). The client
   table is bounded (``max_clients``, oldest-client eviction).

Every decision is counted (``admission.*`` telemetry), every rejection is
an event-stream-visible action (``Admission`` topic, one
``AdmissionRejected`` type whose payload carries the reason — a single
type keeps the canonical event digest stable across reason mixes) and a
row in a bounded decision ring served at ``/v1/agent/admission`` and in
the debug bundle's ``admission`` section.

Default-permissive: with no caps and no rate configured the controller
admits on a no-lock fast path, draws nothing, and publishes nothing —
decision-invariance the banked steady-10k / burst-100k digests pin.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from nomad_tpu_torch import prng, structs, telemetry
from nomad_tpu_torch.structs import (
    REJECT_QUEUE_FULL,
    REJECT_RATE_LIMITED,
    REJECT_SHED,
    RejectError,
)

LANE_SERVICE = "service"
LANE_BATCH = "batch"
# Express submissions (Job.express, nomad_tpu_torch/server/express.py) ride
# their OWN rate lane — a client's express traffic and its bulk batch
# traffic meter independently — but the SLO-coupled shedder treats the
# lane as batch-yielding: express is a latency lane, not a rate-limit
# (or shed) bypass.
LANE_EXPRESS = "express"

# Lanes the SLO-coupled shedder turns away when the placed-latency
# budget burns hot; service keeps flowing (Borg's priority posture).
SHED_LANES = (LANE_BATCH, LANE_EXPRESS)

# Decision-ring depth: enough to see a rejection storm's shape, bounded
# so the controller can never become its own unbounded queue.
DECISION_RING = 256


def lane_for(job_type: str) -> str:
    """Rate/shed lane for a job: batch yields first (Borg posture);
    service and system ride the protected lane."""
    return LANE_BATCH if job_type == structs.JOB_TYPE_BATCH else LANE_SERVICE


def lane_for_job(job) -> str:
    """Lane classification off the job model: express-flagged batch work
    gets the express lane; everything else classifies by type."""
    if getattr(job, "express", False) \
            and job.type == structs.JOB_TYPE_BATCH:
        return LANE_EXPRESS
    return lane_for(job.type)


@dataclass
class AdmissionConfig:
    """Front-door tunables. The defaults are PERMISSIVE (admit
    everything, no draws, no events): admission only bites where the
    operator configured it — the decision-invariance contract the banked
    pre-admission SIMLOAD digests pin."""

    enabled: bool = True
    # Per-(client, lane) token bucket: rate in admissions/s, burst =
    # bucket size. 0 rate = unlimited (the permissive default).
    client_rate: float = 0.0
    client_burst: float = 0.0
    # Bound on distinct (client, lane) buckets tracked; oldest-touched
    # eviction past it (a client flood must not grow the table forever).
    max_clients: int = 4096
    # SLO-coupled shedding of the batch lane: shed probability ramps 0→1
    # as the submit_to_placed burn rate crosses start→full. 0 start
    # disables shedding entirely (the default).
    shed_start_burn: float = 0.0
    shed_full_burn: float = 4.0
    # Retry-after hints for reasons with no natural schedule.
    queue_full_retry_after: float = 1.0
    shed_retry_after: float = 2.0

    @classmethod
    def parse(cls, spec: Optional[Dict[str, Any]]) -> "AdmissionConfig":
        """Validated construction from a config mapping (the agent-config
        ``server { admission { ... } }`` block / ServerConfig.admission).
        Typos and out-of-range values fail at parse time, like
        scheduler_workers."""
        if spec is None:
            return cls()
        if not isinstance(spec, dict):
            raise ValueError("admission config must be a mapping")
        known = {f for f in cls.__dataclass_fields__}
        unknown = [k for k in spec if k not in known]
        if unknown:
            raise ValueError(
                f"unknown admission config key(s): {sorted(unknown)} "
                f"(have: {sorted(known)})"
            )
        out = cls(**{
            k: (bool(v) if k == "enabled"
                else int(v) if k == "max_clients"
                else float(v))
            for k, v in spec.items()
        })
        if out.client_rate < 0:
            raise ValueError("admission.client_rate must be >= 0")
        if out.client_burst < 0:
            raise ValueError("admission.client_burst must be >= 0")
        if not 1 <= out.max_clients <= 1_000_000:
            raise ValueError(
                "admission.max_clients must be in [1, 1000000], got "
                f"{out.max_clients}"
            )
        if out.shed_start_burn < 0:
            raise ValueError("admission.shed_start_burn must be >= 0")
        if (out.shed_start_burn
                and out.shed_full_burn <= out.shed_start_burn):
            raise ValueError(
                "admission.shed_full_burn must exceed shed_start_burn"
            )
        return out

    @property
    def burst(self) -> float:
        """Effective bucket size: an unset burst with a set rate defaults
        to one second's worth of tokens (floor 1 — a bucket that can
        never hold a whole token admits nothing)."""
        if self.client_burst > 0:
            return self.client_burst
        return max(1.0, self.client_rate)


class _TokenBucket:
    """One (client, lane) rate lane. Mutated under the controller lock;
    monotonic-clock refill (wall clock would let an NTP step mint or
    burn tokens)."""

    __slots__ = ("tokens", "last")

    def __init__(self, burst: float, now: float):
        self.tokens = burst
        self.last = now

    def take(self, rate: float, burst: float, now: float) -> float:
        """Try to consume one token. Returns 0.0 on success, else the
        retry-after hint (seconds until a whole token accrues)."""
        elapsed = max(0.0, now - self.last)
        self.last = now
        self.tokens = min(burst, self.tokens + elapsed * rate)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / rate


class AdmissionController:
    """The bounded front door. One per server; consulted by
    ``Server.job_register`` / ``Server.job_evaluate`` before any raft
    apply. ``admit`` either returns (admitted) or raises a typed
    ``RejectError`` — cheap by construction: the reject path touches one
    bucket, two counters, and a deque.

    Collaborators are injected as callables so the controller stays
    import-light and trivially testable:

    - ``queue_depth``: current broker pending total (the acceptance
      queue the ``eval_pending_cap`` bounds).
    - ``burn_rate``: the live submit_to_placed error-budget burn rate
      (slo.SLOMonitor.burn_rate; 0.0 when no monitor runs).
    - ``events``: an EventBroker for the ``Admission`` topic (None in
      bare tests).
    """

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 seed: int = 0,
                 queue_depth: Optional[Callable[[], int]] = None,
                 queue_cap: int = 0,
                 burn_rate: Optional[Callable[[], float]] = None,
                 events=None):
        self.config = config or AdmissionConfig()
        self.queue_depth = queue_depth or (lambda: 0)
        self.queue_cap = int(queue_cap)
        self.burn_rate = burn_rate or (lambda: 0.0)
        self.events = events
        self._lock = threading.Lock()
        # (client, lane) -> bucket; insertion-ordered for oldest-first
        # eviction (move-to-end on touch keeps actives resident).
        self._buckets: "Dict[tuple, _TokenBucket]" = {}
        # Seeded shed stream: the n-th shed draw is fixed per seed, so a
        # replayed decision sequence sheds identically (prng.py posture).
        self._shed_rng = prng.stream(seed, "admission.shed")
        self._decisions: "deque" = deque(maxlen=DECISION_RING)
        # Monotonic totals. Mutated ONLY under self._lock: RPC dispatch
        # admits on concurrent threads, and an unlocked read-modify-write
        # on a dict entry drops increments under GIL preemption — the
        # artifact's controller-vs-injector cross-check would then
        # mismatch intermittently. Reads (snapshot/summary) stay
        # lock-free: a torn read is a stale count, never a lost one.
        self.admitted = 0
        self.rejected = 0
        self.evicted_clients = 0
        self.by_reason: Dict[str, int] = {}
        self.by_lane: Dict[str, Dict[str, int]] = {}

    # -- the decision -------------------------------------------------------

    def admit_job(self, job, client_id: str = "") -> None:
        """Front-door check for one job registration / evaluation
        request. Raises RejectError (typed, retry-after-hinted) or
        returns with the request admitted."""
        self.admit(client_id, lane_for_job(job), ref=job.id)

    def admit(self, client_id: str, lane: str, ref: str = "") -> None:
        cfg = self.config
        if not cfg.enabled or (
            cfg.client_rate <= 0
            and self.queue_cap <= 0
            and cfg.shed_start_burn <= 0
        ):
            # Permissive fast path: count and go. No lane table, no
            # draws, no events — decision-invariant with the
            # pre-admission stack. (The counter still takes the lock:
            # loss-free totals are the whole point of having them.)
            with self._lock:
                self.admitted += 1
            telemetry.incr_counter(("admission", "admit"))
            return
        # Gate 1: the acceptance queue's bound. Checked BEFORE the rate
        # lane so a capacity rejection never burns the client's token —
        # a client that honors a QUEUE_FULL retry-after must not find
        # its lane drained by the very rejections it was handed.
        if self.queue_cap > 0 and self.queue_depth() >= self.queue_cap:
            self._reject(
                REJECT_QUEUE_FULL, client_id, lane,
                cfg.queue_full_retry_after, ref,
                f"eval acceptance queue at cap ({self.queue_cap})",
            )
        # Gate 2: SLO-coupled shedding — batch AND express yield first
        # (a shed batch door must shed express too: express is a latency
        # lane, not a rate-limit bypass); the service lane keeps flowing
        # regardless of burn. Also token-free.
        if cfg.shed_start_burn > 0 and lane in SHED_LANES:
            burn = self.burn_rate()
            if burn > cfg.shed_start_burn:
                frac = min(1.0, (burn - cfg.shed_start_burn)
                           / (cfg.shed_full_burn - cfg.shed_start_burn))
                with self._lock:
                    draw = self._shed_rng.random()
                if draw < frac:
                    self._reject(
                        REJECT_SHED, client_id, lane,
                        cfg.shed_retry_after, ref,
                        f"batch lane shed (placed-latency burn "
                        f"{burn:.2f} > {cfg.shed_start_burn:.2f})",
                    )
        # Gate 3: the client's rate lane — the LAST gate, so a consumed
        # token always corresponds to an actual admission.
        if cfg.client_rate > 0:
            now = time.monotonic()
            key = (client_id, lane)
            with self._lock:
                bucket = self._buckets.get(key)
                if bucket is None:
                    bucket = _TokenBucket(cfg.burst, now)
                    self._buckets[key] = bucket
                    while len(self._buckets) > cfg.max_clients:
                        self._buckets.pop(next(iter(self._buckets)))
                        self.evicted_clients += 1
                else:
                    # Touch-order eviction: re-insert on use.
                    self._buckets.pop(key)
                    self._buckets[key] = bucket
                hint = bucket.take(cfg.client_rate, cfg.burst, now)
            if hint > 0.0:
                self._reject(
                    REJECT_RATE_LIMITED, client_id, lane, hint, ref,
                    f"client {client_id or '<anonymous>'} {lane} lane "
                    f"rate limited",
                )
        with self._lock:
            self.admitted += 1
            lanes = self.by_lane.setdefault(lane, {"admit": 0, "reject": 0})
            lanes["admit"] += 1
        telemetry.incr_counter(("admission", "admit"))

    def _reject(self, reason: str, client_id: str, lane: str,
                retry_after: float, ref: str, message: str) -> None:
        with self._lock:
            self.rejected += 1
            self.by_reason[reason] = self.by_reason.get(reason, 0) + 1
            lanes = self.by_lane.setdefault(lane, {"admit": 0, "reject": 0})
            lanes["reject"] += 1
            self._decisions.append({
                # nomadlint: allow(DET002) -- operator-facing decision-
                # log stamp on /v1/agent/admission; never interval math.
                "time": time.time(),
                "reason": reason,
                "client_id": client_id,
                "lane": lane,
                "retry_after": round(retry_after, 3),
                "ref": ref,
            })
        telemetry.incr_counter(("admission", "reject", reason))
        if self.events is not None:
            # ONE event type for every reason: the reason rides the
            # payload, so the canonical digest (key + type sequences)
            # stays stable when only the reject-reason mix shifts.
            self.events.publish(
                "Admission", "AdmissionRejected",
                key=client_id or "anonymous",
                payload={"reason": reason, "lane": lane, "ref": ref,
                         "retry_after": round(retry_after, 3)},
            )
        raise RejectError(reason, message, retry_after=retry_after)

    # -- exposition ---------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Compact totals for /v1/agent/metrics and agent-info."""
        return {
            "enabled": self.config.enabled,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "by_reason": dict(self.by_reason),
            "clients": len(self._buckets),
            "evicted_clients": self.evicted_clients,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The /v1/agent/admission body (and the debug bundle's
        ``admission`` section): config, totals, per-lane split, the
        rate-lane table summary, current SLO coupling, and the recent
        rejection ring."""
        with self._lock:
            lanes = {
                str(key): {"tokens": round(b.tokens, 3)}
                for key, b in self._buckets.items()
            }
            decisions = list(self._decisions)
        try:
            burn = self.burn_rate()
        except Exception:
            burn = None
        return {
            **self.summary(),
            "config": {
                "client_rate": self.config.client_rate,
                "client_burst": self.config.burst,
                "max_clients": self.config.max_clients,
                "queue_cap": self.queue_cap,
                "shed_start_burn": self.config.shed_start_burn,
                "shed_full_burn": self.config.shed_full_burn,
            },
            "by_lane": {k: dict(v) for k, v in self.by_lane.items()},
            "rate_lanes": lanes,
            "placed_burn_rate": burn,
            "recent_rejections": decisions,
        }
