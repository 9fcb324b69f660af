"""Placement stacks: the chained-iterator pipelines schedulers select with.

Reference: upstream scheduler/stack.go. ``GenericStack`` is the
service/batch pipeline (random -> constraints -> drivers -> distinct_hosts ->
binpack -> anti-affinity -> limit -> max-score); ``SystemStack`` is the
one-node pipeline. The TPU path implements the same ``Stack`` protocol with a
dense tensor solve (nomad_tpu.tpu.solver.TPUStack).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.feasible import (
    ConstraintIterator,
    DriverIterator,
    ProposedAllocConstraintIterator,
    StaticIterator,
    shuffle_nodes,
)
from nomad_tpu_torch.scheduler.rank import (
    BinPackIterator,
    FeasibleRankIterator,
    JobAntiAffinityIterator,
    RankedNode,
)
from nomad_tpu_torch.scheduler.select_iter import LimitIterator, MaxScoreIterator
from nomad_tpu_torch.scheduler.util import task_group_constraints
from nomad_tpu_torch.structs import Job, Node, Resources, TaskGroup

# Anti-affinity penalties (reference: stack.go:10-19)
SERVICE_JOB_ANTI_AFFINITY_PENALTY = 10.0
BATCH_JOB_ANTI_AFFINITY_PENALTY = 5.0


class GenericStack:
    """Service/batch placement stack (reference: stack.go:37-159)."""

    def __init__(self, batch: bool, ctx: EvalContext):
        self.batch = batch
        self.ctx = ctx

        # Randomized source reduces scheduler collisions and load-balances
        # (stack.go:59-62)
        self.source = StaticIterator(ctx, [])
        self.job_constraint = ConstraintIterator(ctx, self.source)
        self.task_group_drivers = DriverIterator(ctx, self.job_constraint)
        self.task_group_constraint = ConstraintIterator(ctx, self.task_group_drivers)
        self.proposed_alloc_constraint = ProposedAllocConstraintIterator(
            ctx, self.task_group_constraint
        )
        rank_source = FeasibleRankIterator(ctx, self.proposed_alloc_constraint)
        # Eviction only for service (stack.go:79-83)
        self.bin_pack = BinPackIterator(ctx, rank_source, not batch, 0)
        penalty = (
            BATCH_JOB_ANTI_AFFINITY_PENALTY
            if batch
            else SERVICE_JOB_ANTI_AFFINITY_PENALTY
        )
        self.job_anti_aff = JobAntiAffinityIterator(ctx, self.bin_pack, penalty, "")
        self.limit = LimitIterator(ctx, self.job_anti_aff, 2)
        self.max_score = MaxScoreIterator(ctx, self.limit)

    def set_nodes(self, base_nodes: List[Node]) -> None:
        shuffle_nodes(base_nodes, self.ctx.prng("feasible.shuffle"))
        self.source.set_nodes(base_nodes)
        # Power-of-two-choices: batch inspects 2 nodes, service ~log2(n)
        # (stack.go:109-121)
        limit = 2
        n = len(base_nodes)
        if not self.batch and n > 0:
            log_limit = int(math.ceil(math.log2(n))) if n > 1 else 1
            limit = max(limit, log_limit)
        self.limit.set_limit(limit)

    def set_job(self, job: Job) -> None:
        self.job_constraint.set_constraints(job.constraints)
        self.proposed_alloc_constraint.set_job(job)
        self.bin_pack.set_priority(job.priority)
        self.job_anti_aff.set_job(job.id)

    def select(self, tg: TaskGroup) -> Tuple[Optional[RankedNode], Resources]:
        """Find the best node for one task group (stack.go:131-159)."""
        self.max_score.reset()
        self.ctx.reset()
        start = time.perf_counter()

        tg_constr = task_group_constraints(tg)
        self.task_group_drivers.set_drivers(tg_constr.drivers)
        self.task_group_constraint.set_constraints(tg_constr.constraints)
        self.proposed_alloc_constraint.set_task_group(tg)
        self.bin_pack.set_tasks(tg.tasks)

        option = self.max_score.next()
        if option is not None and len(option.task_resources) != len(tg.tasks):
            for task in tg.tasks:
                option.set_task_resources(task, task.resources)

        self.ctx.metrics().allocation_time = time.perf_counter() - start
        return option, tg_constr.size


class SystemStack:
    """System-job stack: static order, no anti-affinity/limit, eviction on
    (reference: stack.go:163-237)."""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.source = StaticIterator(ctx, [])
        self.job_constraint = ConstraintIterator(ctx, self.source)
        self.task_group_drivers = DriverIterator(ctx, self.job_constraint)
        self.task_group_constraint = ConstraintIterator(ctx, self.task_group_drivers)
        rank_source = FeasibleRankIterator(ctx, self.task_group_constraint)
        self.bin_pack = BinPackIterator(ctx, rank_source, True, 0)

    def set_nodes(self, base_nodes: List[Node]) -> None:
        self.source.set_nodes(base_nodes)

    def set_job(self, job: Job) -> None:
        self.job_constraint.set_constraints(job.constraints)
        self.bin_pack.set_priority(job.priority)

    def select(self, tg: TaskGroup) -> Tuple[Optional[RankedNode], Resources]:
        self.bin_pack.reset()
        self.ctx.reset()
        start = time.perf_counter()

        tg_constr = task_group_constraints(tg)
        self.task_group_drivers.set_drivers(tg_constr.drivers)
        self.task_group_constraint.set_constraints(tg_constr.constraints)
        self.bin_pack.set_tasks(tg.tasks)

        option = self.bin_pack.next()
        if option is not None and len(option.task_resources) != len(tg.tasks):
            for task in tg.tasks:
                option.set_task_resources(task, task.resources)

        self.ctx.metrics().allocation_time = time.perf_counter() - start
        return option, tg_constr.size
