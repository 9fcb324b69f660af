"""GenericScheduler: service + batch evaluation processing.

Reference: upstream scheduler/generic_sched.go. The flow:
process eval -> diff required vs existing allocs -> stop/migrate/in-place
update under the rolling limit -> place missing groups via the Stack ->
submit plan -> retry on refresh/partial commit.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional

from nomad_tpu_torch import trace
from nomad_tpu_torch.scheduler import SetStatusError
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.stack import GenericStack
from nomad_tpu_torch.scheduler.util import (
    AllocTuple,
    diff_allocs,
    evict_and_place,
    inplace_update,
    materialize_task_groups,
    ready_nodes_in_dcs,
    retry_max,
    set_status,
    tainted_nodes,
)
from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_FAILED,
    ALLOC_DESIRED_STATUS_RUN,
    ALLOC_DESIRED_STATUS_STOP,
    EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED,
    EVAL_TRIGGER_EXPRESS_RECONCILE,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_NODE_UPDATE,
    EVAL_TRIGGER_ROLLING_UPDATE,
    Allocation,
    Evaluation,
    filter_terminal_allocs,
    generate_uuid,
)

# Retry + status constants (reference: generic_sched.go:10-30)
MAX_SERVICE_SCHEDULE_ATTEMPTS = 5
MAX_BATCH_SCHEDULE_ATTEMPTS = 2

ALLOC_NOT_NEEDED = "alloc not needed due to job update"
ALLOC_MIGRATING = "alloc is being migrated"
ALLOC_UPDATING = "alloc is being updated due to job update"


class GenericScheduler:
    """Scheduler for 'service' and 'batch' jobs
    (reference: generic_sched.go:42-298)."""

    def __init__(self, state, planner, logger: logging.Logger, batch: bool):
        self.state = state
        self.planner = planner
        self.logger = logger
        self.batch = batch

        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[GenericStack] = None
        self.limit_reached = False
        self.next_eval: Optional[Evaluation] = None
        # This attempt's open 'sched.reconcile' span, if the pass is traced.
        self._reconcile_span = None

    # -- stack construction (overridden by the TPU scheduler) -------------

    def make_stack(self, ctx: EvalContext) -> GenericStack:
        return GenericStack(self.batch, ctx)

    def process(self, ev: Evaluation) -> None:
        """Handle a single evaluation (generic_sched.go:85-114)."""
        self.eval = ev
        if ev.triggered_by not in (
            EVAL_TRIGGER_JOB_REGISTER,
            EVAL_TRIGGER_NODE_UPDATE,
            EVAL_TRIGGER_JOB_DEREGISTER,
            EVAL_TRIGGER_ROLLING_UPDATE,
            # A bounced-out/failed-over express entry reconciling
            # through the slow path (server/express.py): semantically a
            # fresh job registration — the reconciler places the job's
            # whole desired state.
            EVAL_TRIGGER_EXPRESS_RECONCILE,
        ):
            desc = f"scheduler cannot handle '{ev.triggered_by}' evaluation reason"
            set_status(
                self.logger, self.planner, ev, self.next_eval, EVAL_STATUS_FAILED, desc
            )
            return

        limit = MAX_BATCH_SCHEDULE_ATTEMPTS if self.batch else MAX_SERVICE_SCHEDULE_ATTEMPTS
        try:
            retry_max(limit, self._process)
        except SetStatusError as e:
            set_status(
                self.logger, self.planner, ev, self.next_eval, e.eval_status, str(e)
            )
            return
        set_status(
            self.logger, self.planner, ev, self.next_eval, EVAL_STATUS_COMPLETE, ""
        )

    def _process(self) -> bool:
        """One scheduling attempt; returns True when done
        (generic_sched.go:116-184)."""
        parent = trace.current_span()
        if parent is not None:
            self._reconcile_span = trace.get_tracer().start_span(
                parent.trace_id, "sched.reconcile", parent=parent)
        self.job = self.state.job_by_id(self.eval.job_id)
        self.plan = self.eval.make_plan(self.job)
        self.ctx = EvalContext(self.state, self.plan, self.logger)
        self.stack = self.make_stack(self.ctx)
        if self.job is not None:
            self.stack.set_job(self.job)

        try:
            self.compute_job_allocs()
        finally:
            # Every path finishes the span before it places; this one
            # finishes it where the pass raised first.
            self._reconcile_done("error", 0)

        if self.plan.is_noop():
            return True

        if self.limit_reached and self.next_eval is None:
            self.next_eval = self.eval.next_rolling_eval(self.job.update.stagger)
            self.planner.create_eval(self.next_eval)
            self.logger.debug(
                "sched: %s: rolling update limit reached, next eval '%s' created",
                self.eval, self.next_eval.id,
            )

        result, new_state = self.planner.submit_plan(self.plan)

        if new_state is not None:
            self.logger.debug("sched: %s: refresh forced", self.eval)
            self.state = new_state
            return False

        full_commit, expected, actual = result.full_commit(self.plan)
        if not full_commit:
            self.logger.debug(
                "sched: %s: attempted %d placements, %d placed",
                self.eval, expected, actual,
            )
            return False
        return True

    def compute_job_allocs(self) -> None:
        """Reconcile job vs existing allocations (generic_sched.go:186-243)."""
        groups = materialize_task_groups(self.job)

        allocs = self.state.allocs_by_job(self.eval.job_id)
        allocs = filter_terminal_allocs(allocs)
        tainted = tainted_nodes(self.state, allocs)

        diff = diff_allocs(self.job, tainted, groups, allocs)
        self.logger.debug("sched: %s: %r", self.eval, diff)

        for e in diff.stop:
            self.plan.append_update(e.alloc, ALLOC_DESIRED_STATUS_STOP, ALLOC_NOT_NEEDED)

        diff.update = self.inplace_updates(diff.update)

        limit = [len(diff.update) + len(diff.migrate)]
        if self.job is not None and self.job.update.rolling():
            limit = [self.job.update.max_parallel]

        # Migrations = eviction + new placement (generic_sched.go:230-234)
        self.limit_reached = evict_and_place(
            self.ctx, diff, diff.migrate, ALLOC_MIGRATING, limit
        )
        self.limit_reached = evict_and_place(
            self.ctx, diff, diff.update, ALLOC_UPDATING, limit
        )

        self._reconcile_done("diff", len(diff.place))
        if not diff.place:
            return
        self.compute_placements(diff.place)

    def _reconcile_done(self, path: str, place: int) -> None:
        """Finish this attempt's ``sched.reconcile`` span (once), annotated
        with the path taken, the plan's stops (and of them those carried
        as block stop runs) and in-place updates so far and the
        placements to make."""
        span, self._reconcile_span = self._reconcile_span, None
        if span is None:
            return
        plan = self.plan
        span.annotate("path", path)
        if plan is not None:
            stop_run = sum(r.n for r in plan.block_stops)
            span.annotate(
                "stop", sum(len(v) for v in plan.node_update.values())
                + stop_run)
            span.annotate("stop_run", stop_run)
            span.annotate("update", sum(b.n for b in plan.update_batches)
                          + sum(len(v) for v in plan.node_allocation.values()))
        span.annotate("place", place)
        span.finish()

    def inplace_updates(self, updates: List[AllocTuple]) -> List[AllocTuple]:
        """In-place update attempt; returns the updates still needing
        destructive handling. Seam for the TPU scheduler's columnar
        variant."""
        return inplace_update(self.ctx, self.eval, self.job, self.stack, updates)

    def compute_placements(self, place: List[AllocTuple]) -> None:
        """Place missing allocations via the stack
        (generic_sched.go:245-298)."""
        nodes = ready_nodes_in_dcs(self.state, self.job.datacenters)
        self.stack.set_nodes(nodes)

        failed_tg = {}
        for missing in place:
            key = id(missing.task_group)
            if key in failed_tg:
                failed_tg[key].metrics.coalesced_failures += 1
                continue

            option, size = self.stack.select(missing.task_group)

            alloc = Allocation(
                id=generate_uuid(),
                eval_id=self.eval.id,
                name=missing.name,
                job_id=self.job.id,
                job=self.job,
                task_group=missing.task_group.name,
                resources=size,
                metrics=self.ctx.metrics(),
            )

            if option is not None:
                alloc.node_id = option.node.id
                alloc.task_resources = option.task_resources
                alloc.desired_status = ALLOC_DESIRED_STATUS_RUN
                alloc.client_status = ALLOC_CLIENT_STATUS_PENDING
                self.plan.append_alloc(alloc)
            else:
                alloc.desired_status = ALLOC_DESIRED_STATUS_FAILED
                alloc.desired_description = "failed to find a node for placement"
                alloc.client_status = ALLOC_CLIENT_STATUS_FAILED
                self.plan.append_failed(alloc)
                failed_tg[key] = alloc


def new_service_scheduler(state, planner, logger) -> GenericScheduler:
    return GenericScheduler(state, planner, logger, batch=False)


def new_batch_scheduler(state, planner, logger) -> GenericScheduler:
    return GenericScheduler(state, planner, logger, batch=True)
