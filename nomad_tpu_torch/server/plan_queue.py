"""Plan queue: leader-only priority-FIFO queue of submitted plans.

Port of nomad_tpu/server/plan_queue.py (upstream nomad/plan_queue.go).
Each enqueue returns a future the submitting worker blocks on; the plan
applier dequeues, verifies, applies, and responds through the future.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from concurrent.futures import Future
from typing import List, Optional, Tuple

from nomad_tpu_torch import telemetry, trace
from nomad_tpu_torch.structs import Plan, PlanResult


class PlanQueueError(Exception):
    pass


ERR_QUEUE_DISABLED = "plan queue is disabled"
ERR_QUEUE_FULL = "plan queue depth cap reached"


class PendingPlan:
    """A submitted plan + its response future (plan_queue.go:50-69).
    ``enqueue_time`` stamps queue admission so the applier can emit the
    plan.queue_wait span without a side channel."""

    __slots__ = ("plan", "future", "enqueue_time")

    def __init__(self, plan: Plan):
        self.plan = plan
        self.future: Future = Future()
        self.enqueue_time = trace.now()

    def respond(self, result: Optional[PlanResult], err: Optional[Exception]) -> None:
        # Idempotent: a racing flush() and pipeline error path must not
        # turn an already-unblocked worker into an InvalidStateError.
        if self.future.done():
            return
        if err is not None:
            self.future.set_exception(err)
        else:
            self.future.set_result(result)

    def wait(self, timeout: Optional[float] = None) -> PlanResult:
        return self.future.result(timeout)


class PlanQueue:
    """Priority-FIFO plan queue, enabled only on the leader
    (plan_queue.go:9-115)."""

    _counter = itertools.count()

    def __init__(self, max_depth: int = 0) -> None:
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._enabled = False
        # Enforced depth cap (0 = unbounded): an enqueue past it raises a
        # typed PlanQueueError(ERR_QUEUE_FULL) — the submitting worker
        # fails its eval into the nack/redelivery machinery instead of
        # the queue growing without bound. Counted as
        # plan.queue_limit_breach.
        self.max_depth = int(max_depth)
        self._heap: List[Tuple[int, int, PendingPlan]] = []

    @property
    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            # Wake a dequeue parked on the disabled queue (a follower's
            # pipeline loop) the moment leadership enables it.
            self._work.notify_all()
        if not enabled:
            self.flush()

    def enqueue(self, plan: Plan) -> PendingPlan:
        """plan_queue.go:94-115"""
        with self._lock:
            if not self._enabled:
                raise PlanQueueError(ERR_QUEUE_DISABLED)
            if self.max_depth and len(self._heap) >= self.max_depth:
                telemetry.incr_counter(("plan", "queue_limit_breach"))
                raise PlanQueueError(ERR_QUEUE_FULL)
            pending = PendingPlan(plan)
            heapq.heappush(
                self._heap, (-plan.priority, next(self._counter), pending)
            )
            # Depth is gauged by the server's 1 Hz stats loop (the single
            # writer — it keeps the series alive through idle intervals);
            # the enqueue counter here gives the rate side.
            telemetry.incr_counter(("plan", "queue_enqueue"))
            self._work.notify_all()
            return pending

    def dequeue(self, timeout: Optional[float] = None) -> Optional[PendingPlan]:
        """Blocking dequeue; returns None on timeout or when disabled while
        waiting (plan_queue.go:118-147). A dequeue that finds the queue
        already disabled parks until it is enabled or the timeout passes:
        nomad_tpu returns at once, and a follower's plan pipeline loop
        then spins on its disabled queue, holding the GIL that the other
        members' raft and solver threads share (upstream runs the plan
        applier on the leader only)."""
        import time as _time

        deadline = None
        with self._lock:
            was_enabled = False
            while True:
                if self._enabled:
                    was_enabled = True
                    if self._heap:
                        _, _, pending = heapq.heappop(self._heap)
                        return pending
                elif was_enabled:
                    return None
                if timeout is not None:
                    if deadline is None:
                        deadline = _time.monotonic() + timeout
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        return None
                    self._work.wait(remaining)
                else:
                    self._work.wait()

    def dequeue_batch(self, max_batch: int,
                      timeout: Optional[float] = None
                      ) -> List[PendingPlan]:
        """Blocking drain: wait for one pending plan (``dequeue``
        semantics), then take up to ``max_batch - 1`` more that are
        already queued, in priority-FIFO order — the plan pipeline's
        K-at-a-time intake. Never blocks for followers: a lone plan
        returns alone."""
        first = self.dequeue(timeout)
        if first is None:
            return []
        out = [first]
        with self._lock:
            while self._enabled and self._heap and len(out) < max_batch:
                _, _, pending = heapq.heappop(self._heap)
                out.append(pending)
        return out

    def flush(self) -> None:
        """Fail all pending plans (plan_queue.go:170-186). Runs on
        stop()/leadership loss: every outstanding future must resolve —
        with ERR_QUEUE_DISABLED, so a worker blocked in submit_plan
        during failover unblocks promptly instead of leaking until its
        eval's nack timer fires."""
        with self._lock:
            for _, _, pending in self._heap:
                pending.respond(None, PlanQueueError(ERR_QUEUE_DISABLED))
            self._heap = []
            self._work.notify_all()

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)
