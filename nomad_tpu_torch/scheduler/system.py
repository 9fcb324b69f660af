"""SystemScheduler: one allocation per eligible node.

Reference: upstream scheduler/system_sched.go.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from nomad_tpu_torch.scheduler import SchedulerError, SetStatusError
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.generic import ALLOC_NOT_NEEDED, ALLOC_UPDATING
from nomad_tpu_torch.scheduler.stack import SystemStack
from nomad_tpu_torch.scheduler.util import (
    AllocTuple,
    diff_system_allocs,
    evict_and_place,
    inplace_update,
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
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_NODE_UPDATE,
    EVAL_TRIGGER_ROLLING_UPDATE,
    Allocation,
    Evaluation,
    filter_terminal_allocs,
    generate_uuid,
)

MAX_SYSTEM_SCHEDULE_ATTEMPTS = 5  # reference: system_sched.go:10-14
ALLOC_NODE_TAINTED = "system alloc not needed as node is tainted"


class SystemScheduler:
    """Scheduler for 'system' jobs (reference: system_sched.go:21-265)."""

    def __init__(self, state, planner, logger: logging.Logger):
        self.state = state
        self.planner = planner
        self.logger = logger

        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[SystemStack] = None
        self.nodes = []
        self.limit_reached = False
        self.next_eval: Optional[Evaluation] = None

    def make_stack(self, ctx: EvalContext) -> SystemStack:
        return SystemStack(ctx)

    def process(self, ev: Evaluation) -> None:
        self.eval = ev
        if ev.triggered_by not in (
            EVAL_TRIGGER_JOB_REGISTER,
            EVAL_TRIGGER_NODE_UPDATE,
            EVAL_TRIGGER_JOB_DEREGISTER,
            EVAL_TRIGGER_ROLLING_UPDATE,
        ):
            desc = f"scheduler cannot handle '{ev.triggered_by}' evaluation reason"
            set_status(
                self.logger, self.planner, ev, self.next_eval, EVAL_STATUS_FAILED, desc
            )
            return

        try:
            retry_max(MAX_SYSTEM_SCHEDULE_ATTEMPTS, self._process)
        except SetStatusError as e:
            set_status(
                self.logger, self.planner, ev, self.next_eval, e.eval_status, str(e)
            )
            return
        set_status(
            self.logger, self.planner, ev, self.next_eval, EVAL_STATUS_COMPLETE, ""
        )

    def _process(self) -> bool:
        """One attempt (system_sched.go:76-152)."""
        self.job = self.state.job_by_id(self.eval.job_id)
        self.nodes = (
            ready_nodes_in_dcs(self.state, self.job.datacenters) if self.job else []
        )
        self.plan = self.eval.make_plan(self.job)
        self.ctx = EvalContext(self.state, self.plan, self.logger)
        self.stack = self.make_stack(self.ctx)
        if self.job is not None:
            self.stack.set_job(self.job)

        self.compute_job_allocs()

        if self.plan.is_noop():
            return True

        if self.limit_reached and self.next_eval is None:
            self.next_eval = self.eval.next_rolling_eval(self.job.update.stagger)
            self.planner.create_eval(self.next_eval)

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
        """system_sched.go:154-202"""
        allocs = self.state.allocs_by_job(self.eval.job_id)
        allocs = filter_terminal_allocs(allocs)
        tainted = tainted_nodes(self.state, allocs)

        diff = diff_system_allocs(self.job, self.nodes, tainted, allocs)
        self.logger.debug("sched: %s: %r", self.eval, diff)

        for e in diff.stop:
            self.plan.append_update(e.alloc, ALLOC_DESIRED_STATUS_STOP, ALLOC_NOT_NEEDED)

        diff.update = inplace_update(self.ctx, self.eval, self.job, self.stack, diff.update)

        limit = [len(diff.update)]
        if self.job is not None and self.job.update.rolling():
            limit = [self.job.update.max_parallel]

        self.limit_reached = evict_and_place(
            self.ctx, diff, diff.update, ALLOC_UPDATING, limit
        )

        if not diff.place:
            return
        self.compute_placements(diff.place)

    def compute_placements(self, place: List[AllocTuple]) -> None:
        """Placements pinned per node (system_sched.go:204-265)."""
        node_by_id = {node.id: node for node in self.nodes}
        failed_tg = {}

        for missing in place:
            node = node_by_id.get(missing.alloc.node_id)
            if node is None:
                raise SchedulerError(f"could not find node {missing.alloc.node_id!r}")

            self.stack.set_nodes([node])
            option, size = self.stack.select(missing.task_group)

            if option is None:
                key = id(missing.task_group)
                if key in failed_tg:
                    failed_tg[key].metrics.coalesced_failures += 1
                    continue

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
                failed_tg[id(missing.task_group)] = alloc


def new_system_scheduler(state, planner, logger) -> SystemScheduler:
    return SystemScheduler(state, planner, logger)
