"""Eval broker: leader-only, in-memory, at-least-once evaluation queue.

Port of nomad_tpu/server/eval_broker.py, with the semantics of the
reference broker (upstream nomad/eval_broker.go:33-633):

- priority queues per scheduler type; highest priority dequeued first,
  ties broken by create index (eval_broker.go:597-605)
- per-job serialization: one outstanding eval per JobID, later ones block
  (eval_broker.go:173-183)
- unack tracking with Nack timers; missing Ack within nack_timeout
  redelivers (eval_broker.go:318-328)
- delivery limit: after N deliveries the eval lands in the ``_failed``
  queue for the leader to reap (eval_broker.go:19, 489-495)
- wait/time-delay evals for rolling updates (eval_broker.go:143-151)
- blocking Dequeue with timeout (eval_broker.go:214-246)

Additionally, ``dequeue_batch`` implements the TPU north-star extension
(SURVEY.md §7 "Batched evals"): drain up to B compatible ready evals in one
call so the worker can coalesce them into a single device dispatch.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch import faults, prng, telemetry, trace
from nomad_tpu_torch.structs import Evaluation, generate_uuid

FAILED_QUEUE = "_failed"


class BrokerError(Exception):
    pass


class BrokerFullError(BrokerError):
    """Typed NACK for an enqueue past the broker's pending cap: the eval
    stays durable in the state store (it was committed through raft) and
    is NOT tracked by the broker — the server's readmission loop
    re-enqueues it when capacity frees. Never silent growth."""


ERR_NOT_OUTSTANDING = "evaluation is not outstanding"
ERR_TOKEN_MISMATCH = "evaluation token does not match"
ERR_NACK_TIMEOUT_REACHED = "evaluation nack timeout reached"
ERR_DISABLED = "eval broker disabled"
ERR_QUEUE_FULL = "eval broker pending cap reached"


@dataclass
class SchedulerStats:
    ready: int = 0
    unacked: int = 0


@dataclass
class BrokerStats:
    total_ready: int = 0
    total_unacked: int = 0
    total_blocked: int = 0
    total_waiting: int = 0
    by_scheduler: Dict[str, SchedulerStats] = field(default_factory=dict)

    def sched(self, queue: str) -> SchedulerStats:
        if queue not in self.by_scheduler:
            self.by_scheduler[queue] = SchedulerStats()
        return self.by_scheduler[queue]


class _PriorityQueue:
    """Max-priority heap of evaluations: highest priority first, then oldest
    create index (eval_broker.go:597-605)."""

    _counter = itertools.count()

    def __init__(self) -> None:
        self._heap: List[Tuple[int, int, int, Evaluation]] = []

    def push(self, ev: Evaluation) -> None:
        heapq.heappush(
            self._heap, (-ev.priority, ev.create_index, next(self._counter), ev)
        )

    def pop(self) -> Optional[Evaluation]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[3]

    def peek(self) -> Optional[Evaluation]:
        if not self._heap:
            return None
        return self._heap[0][3]

    def __len__(self) -> int:
        return len(self._heap)


class _UnackEval:
    __slots__ = ("eval", "token", "nack_timer")

    def __init__(self, ev: Evaluation, token: str, nack_timer: threading.Timer):
        self.eval = ev
        self.token = token
        self.nack_timer = nack_timer


class EvalBroker:
    """At-least-once evaluation broker (reference: eval_broker.go:43-111)."""

    def __init__(self, nack_timeout: float = 60.0, delivery_limit: int = 3,
                 seed: int = 0, pending_cap: int = 0):
        if nack_timeout < 0:
            raise ValueError("timeout cannot be negative")
        import logging as _logging

        self.logger = _logging.getLogger("nomad_tpu_torch.eval_broker")
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit
        # Enforced bound on pending work (ready + blocked + waiting).
        # 0 = unbounded (the historical posture). An enqueue past the cap
        # raises BrokerFullError — typed NACK, counted as
        # broker.depth_limit_breach — and sets the spill flag the
        # server's readmission loop polls (spilled evals stay durable in
        # state; the broker never silently grows past the cap).
        self.pending_cap = int(pending_cap)
        self._spilled = False
        # Scheduler-queue tie-break stream: seeded per broker (name-salted,
        # the faults.py pattern) so the choice among equal-priority queues
        # never couples to the process-global random cursor.
        self._rng = prng.stream(seed, "broker.scheduler_choice")
        self._enabled = False
        self._lock = threading.Lock()
        self._work_available = threading.Condition(self._lock)
        self.stats = BrokerStats()

        # eval ID -> delivery attempts
        self._evals: Dict[str, int] = {}
        # JobID -> outstanding eval ID (serialization)
        self._job_evals: Dict[str, str] = {}
        # JobID -> blocked evals
        self._blocked: Dict[str, _PriorityQueue] = {}
        # scheduler type -> ready evals
        self._ready: Dict[str, _PriorityQueue] = {}
        # eval ID -> unacked delivery
        self._unack: Dict[str, _UnackEval] = {}
        # eval ID -> wait timer
        self._time_wait: Dict[str, threading.Timer] = {}
        # eval ID -> count of token-verified plans currently in the
        # applier (redelivery deferred while nonzero; see plan_inflight).
        self._inflight_plans: Dict[str, int] = {}
        # Trace spans (nomad_tpu_torch.trace): the root 'eval' span opened at
        # enqueue (finished at ack/flush) and the current 'broker.wait'
        # span (enqueue/nack -> dequeue). The broker is the trace's
        # birthplace: trace_id IS the eval id.
        self._trace_root: Dict[str, object] = {}
        self._trace_wait: Dict[str, object] = {}
        # A delayed eval's 'broker.delay' span (enqueue -> its wait timer
        # fires), so broker.wait keeps to the ready/blocked wait.
        self._trace_delay: Dict[str, object] = {}
        # eval ID -> raft index the processing worker must observe in ITS
        # local FSM before snapshotting. For a freshly-created eval this is
        # the eval's own apply index (same as modify_index); for an eval
        # re-enqueued after a leadership change it is the new leader's
        # post-barrier applied index — which covers any plan an earlier
        # delivery committed right before the old leader died. Without it
        # a redelivered eval can be scheduled against a snapshot that
        # predates its own first plan and be placed TWICE (the failover
        # exactly-once hole; newer reference releases carry the same
        # mechanism as Dequeue's WaitIndex).
        self._wait_index: Dict[str, int] = {}

    # -- enable/disable ----------------------------------------------------

    @property
    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
        if not enabled:
            self.flush()

    # -- enqueue -----------------------------------------------------------

    def enqueue(self, ev: Evaluation, wait_index: int = 0) -> None:
        """eval_broker.go:131-155. Raises BrokerFullError past the
        pending cap (the eval stays durable in state; see pending_cap)."""
        with self._lock:
            self._enqueue_one_locked(ev, wait_index)

    def enqueue_many(self, evals, wait_index: int = 0) -> int:
        """Atomic multi-enqueue: every eval of one raft entry becomes
        ready under a single lock hold. Without this, the first eval's
        notify races the rest into the queue and a coalescing batch
        dequeuer (dequeue_batch) wakes to a fragment — the burst then
        solves as several small dispatches instead of one stacked one.

        The FSM path: a committed entry cannot fail, so over-cap evals
        SPILL (counted, flag set for the readmission loop) instead of
        raising; returns how many spilled."""
        spilled = 0
        with self._lock:
            for ev in evals:
                try:
                    self._enqueue_one_locked(ev, wait_index)
                except BrokerFullError:
                    spilled += 1
        if spilled:
            self.logger.debug(
                "broker %x: SPILL %d evals past pending cap %d",
                id(self), spilled, self.pending_cap)
        return spilled

    def pending_total(self) -> int:
        """Current pending depth (ready + blocked + waiting) — the
        quantity pending_cap bounds; the admission front door's
        acceptance-queue probe."""
        with self._lock:
            return self._pending_total_locked()

    def _pending_total_locked(self) -> int:
        return (self.stats.total_ready + self.stats.total_blocked
                + self.stats.total_waiting)

    def reclaim_spilled(self) -> bool:
        """The readmission handshake: True exactly once per spill episode
        once capacity has freed (the server then re-enqueues pending
        evals from state). The flag re-arms on the next over-cap
        enqueue."""
        with self._lock:
            if not self._spilled:
                return False
            if (self.pending_cap
                    and self._pending_total_locked() >= self.pending_cap):
                return False
            self._spilled = False
            return True

    def _enqueue_one_locked(self, ev: Evaluation, wait_index: int) -> None:
        if ev.id in self._evals:
            # Already tracked (redelivery bookkeeping): only refresh the
            # wait index — never counts against the cap.
            if wait_index:
                self._wait_index[ev.id] = max(
                    wait_index, self._wait_index.get(ev.id, 0)
                )
            return
        if (self._enabled and self.pending_cap
                and self._pending_total_locked() >= self.pending_cap):
            # Typed NACK before ANY tracking state mutates: a spilled
            # eval leaves zero residue here (its wait-index floor is
            # re-derived from the leader's applied index at readmission).
            self._spilled = True
            telemetry.incr_counter(("broker", "depth_limit_breach"))
            raise BrokerFullError(ERR_QUEUE_FULL)
        if wait_index:
            self._wait_index[ev.id] = max(
                wait_index, self._wait_index.get(ev.id, 0)
            )
        if self._enabled:
            self._evals[ev.id] = 0
            telemetry.incr_counter(("broker", "enqueue"))
            if ev.id not in self._trace_root:
                root = trace.get_tracer().start_span(
                    ev.id, "eval", root=True,
                    annotations={
                        "job_id": ev.job_id, "type": ev.type,
                        "priority": ev.priority,
                        "triggered_by": ev.triggered_by,
                    },
                )
                if root is not trace.NULL_SPAN:
                    self._trace_root[ev.id] = root

        if ev.wait > 0:
            root = self._trace_root.get(ev.id)
            if root is not None:
                self._trace_delay[ev.id] = trace.get_tracer().start_span(
                    ev.id, "broker.delay", parent=root,
                    annotations={"wait_s": ev.wait},
                )
            timer = threading.Timer(ev.wait, self._enqueue_waiting, args=(ev,))
            timer.daemon = True
            timer.start()
            self._time_wait[ev.id] = timer
            self.stats.total_waiting += 1
            return

        self._enqueue_locked(ev, ev.type)

    def _enqueue_waiting(self, ev: Evaluation) -> None:
        with self._lock:
            self._time_wait.pop(ev.id, None)
            delay = self._trace_delay.pop(ev.id, None)
            if delay is not None:
                delay.finish()
            self.stats.total_waiting -= 1
            self._enqueue_locked(ev, ev.type)

    def _enqueue_locked(self, ev: Evaluation, queue: str) -> None:
        """eval_broker.go:166-212 (lock held)"""
        if not self._enabled:
            return

        # The ready/blocked wait starts here (redeliveries and
        # blocked->ready promotions restart it); finished at dequeue so
        # the span covers the full queue wait. A still-open prior wait
        # span (the eval transited the blocked queue) is finished first —
        # overwriting it would leak an open span into the trace forever.
        root = self._trace_root.get(ev.id)
        if root is not None:
            prior = self._trace_wait.pop(ev.id, None)
            if prior is not None:
                prior.finish()
            self._trace_wait[ev.id] = trace.get_tracer().start_span(
                ev.id, "broker.wait", parent=root,
                annotations={"queue": queue},
            )

        pending_eval = self._job_evals.get(ev.job_id, "")
        if pending_eval == "":
            self._job_evals[ev.job_id] = ev.id
        elif pending_eval != ev.id:
            blocked = self._blocked.setdefault(ev.job_id, _PriorityQueue())
            blocked.push(ev)
            self.stats.total_blocked += 1
            wait = self._trace_wait.get(ev.id)
            if wait is not None:
                wait.annotate("blocked", True)
            return

        ready = self._ready.setdefault(queue, _PriorityQueue())
        ready.push(ev)
        self.stats.total_ready += 1
        self.stats.sched(queue).ready += 1
        self._work_available.notify_all()

    # -- dequeue -----------------------------------------------------------

    def dequeue(
        self, schedulers: List[str], timeout: Optional[float] = None
    ) -> Tuple[Optional[Evaluation], str]:
        """Blocking dequeue of the highest-priority ready eval for any of the
        given scheduler types (eval_broker.go:214-246). Returns (None, "")
        on timeout."""
        # Injected dequeue failure/stall BEFORE the lock: the worker's
        # dequeue loop sees exactly what a leader-transition blip looks
        # like (BrokerError -> backoff + retry), and a delay never holds
        # the broker lock against acks/nacks.
        fault = faults.fire("broker.dequeue", target=",".join(schedulers))
        if fault is not None and fault.mode in ("error", "drop"):
            raise BrokerError("injected fault: broker.dequeue")
        deadline = None
        with self._lock:
            while True:
                if not self._enabled:
                    raise BrokerError(ERR_DISABLED)
                out = self._scan_for_schedulers(schedulers)
                if out is not None:
                    return out
                if timeout is not None:
                    import time as _time

                    if deadline is None:
                        deadline = _time.monotonic() + timeout
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        return None, ""
                    self._work_available.wait(remaining)
                else:
                    self._work_available.wait()

    def dequeue_batch(
        self,
        schedulers: List[str],
        max_batch: int,
        timeout: Optional[float] = None,
    ) -> List[Tuple[Evaluation, str]]:
        """Coalescing dequeue: blocks for the first eval, then drains up to
        ``max_batch - 1`` more ready evals without blocking. Every returned
        eval has its own token + nack timer; each must be Ack'd/Nack'd
        individually. Per-job serialization still holds (distinct jobs only).
        """
        first = self.dequeue(schedulers, timeout)
        if first[0] is None:
            return []
        batch = [first]
        with self._lock:
            while len(batch) < max_batch:
                out = self._scan_for_schedulers(schedulers)
                if out is None:
                    break
                batch.append(out)
        return batch

    def wait_index(self, eval_id: str) -> int:
        """The raft index a worker must observe locally before snapshotting
        for this eval (0 when none was recorded)."""
        with self._lock:
            return self._wait_index.get(eval_id, 0)

    def _scan_for_schedulers(
        self, schedulers: List[str]
    ) -> Optional[Tuple[Evaluation, str]]:
        """Pick the highest-priority eval across queues (lock held)
        (eval_broker.go:248-304)."""
        eligible: List[str] = []
        eligible_priority = 0
        for sched in schedulers:
            pending = self._ready.get(sched)
            if pending is None:
                continue
            ready = pending.peek()
            if ready is None:
                continue
            if not eligible or ready.priority > eligible_priority:
                eligible = [sched]
                eligible_priority = ready.priority
            elif eligible_priority == ready.priority:
                eligible.append(sched)

        if not eligible:
            return None
        sched = eligible[0] if len(eligible) == 1 else self._rng.choice(eligible)
        return self._dequeue_for_sched(sched)

    def _dequeue_for_sched(self, sched: str) -> Tuple[Evaluation, str]:
        """eval_broker.go:306-341 (lock held)"""
        ev = self._ready[sched].pop()
        token = generate_uuid()

        nack_timer = threading.Timer(
            self.nack_timeout, self._nack_from_timer, args=(ev.id, token)
        )
        nack_timer.daemon = True
        nack_timer.start()

        self._unack[ev.id] = _UnackEval(ev, token, nack_timer)
        self._evals[ev.id] = self._evals.get(ev.id, 0) + 1
        self.logger.debug(
            "broker %x: DELIVER eval=%s token=%s attempt=%d wait_index=%d",
            id(self), ev.id[:8], token[:8], self._evals[ev.id],
            self._wait_index.get(ev.id, 0),
        )

        self.stats.total_ready -= 1
        self.stats.total_unacked += 1
        by_sched = self.stats.sched(sched)
        by_sched.ready -= 1
        by_sched.unacked += 1

        telemetry.incr_counter(("broker", "dequeue"))
        wait_span = self._trace_wait.pop(ev.id, None)
        if wait_span is not None:
            wait_span.annotate("attempt", self._evals[ev.id])
            wait_span.finish()
            if wait_span.end is not None:
                telemetry.add_sample(
                    ("broker", "wait"),
                    (wait_span.end - wait_span.start) * 1000.0,
                )
        return ev, token

    def _nack_from_timer(self, eval_id: str, token: str,
                         from_timer: bool = True) -> None:
        # ``from_timer`` rides deferral re-arms so a deferred WORKER nack
        # retried through this callback is not miscounted as a timeout.
        # Defer redelivery while a plan for this delivery sits in the
        # applier: nacking now would hand the eval to a second worker whose
        # snapshot races the in-flight plan's commit — the duplicate-
        # placement window the exactly-once chaos test caught. The applier
        # bounds the deferral by clearing the inflight mark (and re-arming
        # the timer via outstanding_reset) when the commit finishes.
        try:
            # nack() itself defers (short re-check) while a plan from this
            # delivery is mid-commit in the applier.
            self.nack(eval_id, token, _from_timer=from_timer)
        except BrokerError:
            pass

    def outstanding_reset_and_mark(self, eval_id: str, token: str) -> None:
        """Atomic token verification + inflight mark for the plan applier
        (one lock hold). Two separate calls leave a window where the nack
        timer fires between the reset and the mark — redelivering the
        eval while its plan is about to commit, which is exactly the
        double-placement race the mark exists to close. Raises
        BrokerError like outstanding_reset."""
        with self._lock:
            self._outstanding_reset_locked(eval_id, token)
            self._inflight_plans[eval_id] = \
                self._inflight_plans.get(eval_id, 0) + 1
            self.logger.debug(
                "broker %x: PLAN-MARK eval=%s token=%s",
                id(self), eval_id[:8], token[:8])

    def plan_done(self, eval_id: str, commit_index: int = 0) -> None:
        """Clear the inflight mark; bump the eval's wait_index to the
        plan's commit index FIRST (same lock), so any deferred redelivery
        that proceeds next forces the worker's snapshot past the plan."""
        with self._lock:
            # Only bump while the eval is still tracked: ack may have won
            # the race with this finally-block and already dropped the
            # eval — re-inserting would leak an entry until flush.
            if commit_index and (eval_id in self._unack
                                 or eval_id in self._evals):
                self._wait_index[eval_id] = max(
                    commit_index, self._wait_index.get(eval_id, 0)
                )
            n = self._inflight_plans.get(eval_id, 0) - 1
            if n <= 0:
                self._inflight_plans.pop(eval_id, None)
            else:
                self._inflight_plans[eval_id] = n

    # -- outstanding/ack/nack ---------------------------------------------

    def outstanding(self, eval_id: str) -> Tuple[str, bool]:
        """eval_broker.go:384-394"""
        with self._lock:
            unack = self._unack.get(eval_id)
            if unack is None:
                return "", False
            return unack.token, True

    def outstanding_reset(self, eval_id: str, token: str) -> None:
        """Reset the Nack timer if the token matches
        (eval_broker.go:396-412); raises BrokerError otherwise."""
        with self._lock:
            self._outstanding_reset_locked(eval_id, token)

    def _outstanding_reset_locked(self, eval_id: str, token: str) -> None:
        unack = self._unack.get(eval_id)
        if unack is None:
            raise BrokerError(ERR_NOT_OUTSTANDING)
        if unack.token != token:
            raise BrokerError(ERR_TOKEN_MISMATCH)
        unack.nack_timer.cancel()
        new_timer = threading.Timer(
            self.nack_timeout, self._nack_from_timer, args=(eval_id, token)
        )
        new_timer.daemon = True
        new_timer.start()
        unack.nack_timer = new_timer

    def ack(self, eval_id: str, token: str) -> None:
        """Positive acknowledgment; unblocks the next eval for the job
        (eval_broker.go:414-462)."""
        with self._lock:
            unack = self._unack.get(eval_id)
            if unack is None:
                raise BrokerError("Evaluation ID not found")
            if unack.token != token:
                raise BrokerError("Token does not match for Evaluation ID")
            job_id = unack.eval.job_id
            unack.nack_timer.cancel()

            self.stats.total_unacked -= 1
            queue = unack.eval.type
            if self._evals.get(eval_id, 0) >= self.delivery_limit:
                queue = FAILED_QUEUE
            self.stats.sched(queue).unacked -= 1

            del self._unack[eval_id]
            self._evals.pop(eval_id, None)
            self._job_evals.pop(job_id, None)
            self._wait_index.pop(eval_id, None)
            self.logger.debug("broker %x: ACK eval=%s token=%s",
                              id(self), eval_id[:8], token[:8])

            telemetry.incr_counter(("broker", "ack"))
            wait = self._trace_wait.pop(eval_id, None)
            if wait is not None:
                wait.finish()
            root = self._trace_root.pop(eval_id, None)
            if root is not None:
                root.annotate("outcome", "ack").finish()
                trace.get_tracer().mark_done(eval_id)

            blocked = self._blocked.get(job_id)
            if blocked is not None and len(blocked) > 0:
                ev = blocked.pop()
                if len(blocked) == 0:
                    del self._blocked[job_id]
                self.stats.total_blocked -= 1
                self._enqueue_locked(ev, ev.type)

    def nack(self, eval_id: str, token: str, _from_timer: bool = False) -> None:
        """Negative acknowledgment: redeliver or fail
        (eval_broker.go:464-497). ``_from_timer`` marks the nack-timeout
        path so the broker.nack_timeout counter counts only ACTUAL
        timeout redeliveries — not deferral retries or stale timer fires."""
        with self._lock:
            unack = self._unack.get(eval_id)
            if unack is None:
                raise BrokerError("Evaluation ID not found")
            if unack.token != token:
                raise BrokerError("Token does not match for Evaluation ID")
            if eval_id in self._inflight_plans:
                # A plan from THIS delivery is mid-commit in the applier
                # (e.g. the worker lost the submit response and gave up):
                # redelivering now hands the eval to a worker whose
                # snapshot races the commit — double placement. Defer: a
                # short re-check timer retries the nack after plan_done
                # has bumped wait_index past the commit.
                unack.nack_timer.cancel()
                # Propagate the ORIGIN of this nack into the retry: a
                # deferred worker nack must not count as a timeout when
                # the retry lands.
                retry = threading.Timer(
                    0.25, self._nack_from_timer,
                    args=(eval_id, token, _from_timer),
                )
                retry.daemon = True
                unack.nack_timer = retry
                retry.start()
                self.logger.debug(
                    "broker %x: NACK-DEFER eval=%s token=%s (plan inflight)",
                    id(self), eval_id[:8], token[:8])
                return
            unack.nack_timer.cancel()
            del self._unack[eval_id]
            self.logger.debug("broker %x: NACK eval=%s token=%s",
                              id(self), eval_id[:8], token[:8])

            telemetry.incr_counter(("broker", "nack"))
            if _from_timer:
                telemetry.incr_counter(("broker", "nack_timeout"))
            self.stats.total_unacked -= 1
            self.stats.sched(unack.eval.type).unacked -= 1

            if self._evals.get(eval_id, 0) >= self.delivery_limit:
                self._enqueue_locked(unack.eval, FAILED_QUEUE)
            else:
                self._enqueue_locked(unack.eval, unack.eval.type)

    # -- flush/stats -------------------------------------------------------

    def flush(self) -> None:
        """eval_broker.go:499-532"""
        with self._lock:
            for unack in self._unack.values():
                unack.nack_timer.cancel()
            for timer in self._time_wait.values():
                timer.cancel()
            for delay in self._trace_delay.values():
                delay.annotate("cancelled", True).finish()
            for wait in self._trace_wait.values():
                wait.finish()
            for root in self._trace_root.values():
                root.annotate("outcome", "flush").finish()
            self._trace_root = {}
            self._trace_wait = {}
            self._trace_delay = {}
            self.stats = BrokerStats()
            self._evals = {}
            self._job_evals = {}
            self._blocked = {}
            self._ready = {}
            self._unack = {}
            self._time_wait = {}
            self._wait_index = {}
            self._inflight_plans = {}
            self._spilled = False
            self.logger.debug("broker %x: FLUSH", id(self))
            self._work_available.notify_all()

    def snapshot_stats(self) -> BrokerStats:
        with self._lock:
            out = BrokerStats(
                total_ready=self.stats.total_ready,
                total_unacked=self.stats.total_unacked,
                total_blocked=self.stats.total_blocked,
                total_waiting=self.stats.total_waiting,
            )
            for sched, sub in self.stats.by_scheduler.items():
                out.by_scheduler[sched] = SchedulerStats(sub.ready, sub.unacked)
            return out
