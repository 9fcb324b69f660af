"""Scheduler helpers: diffing, materialization, retry, taint detection,
in-place updates, rolling limits.

Reference: upstream scheduler/util.go.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    ALLOC_DESIRED_STATUS_STOP,
    EVAL_STATUS_FAILED,
    NODE_STATUS_READY,
    Allocation,
    Constraint,
    Evaluation,
    Job,
    Node,
    Resources,
    TaskGroup,
    should_drain_node,
)


@dataclass(slots=True)
class AllocTuple:
    """(name, task group, existing alloc) tuple (reference: util.go:12-17)."""

    name: str
    task_group: Optional[TaskGroup]
    alloc: Optional[Allocation] = None


@dataclass
class DiffResult:
    """Five-way diff output (reference: util.go:36-52)."""

    place: List[AllocTuple] = field(default_factory=list)
    update: List[AllocTuple] = field(default_factory=list)
    migrate: List[AllocTuple] = field(default_factory=list)
    stop: List[AllocTuple] = field(default_factory=list)
    ignore: List[AllocTuple] = field(default_factory=list)

    def append(self, other: "DiffResult") -> None:
        self.place.extend(other.place)
        self.update.extend(other.update)
        self.migrate.extend(other.migrate)
        self.stop.extend(other.stop)
        self.ignore.extend(other.ignore)

    def __repr__(self) -> str:
        return (
            f"allocs: (place {len(self.place)}) (update {len(self.update)}) "
            f"(migrate {len(self.migrate)}) (stop {len(self.stop)}) "
            f"(ignore {len(self.ignore)})"
        )


def materialize_task_groups(job: Optional[Job]) -> Dict[str, TaskGroup]:
    """Count expansion to names ``job.tg[i]`` (reference: util.go:19-34)."""
    out: Dict[str, TaskGroup] = {}
    if job is None:
        return out
    for tg in job.task_groups:
        for i in range(tg.count):
            out[f"{job.name}.{tg.name}[{i}]"] = tg
    return out


def diff_allocs(
    job: Optional[Job],
    tainted_nodes: Dict[str, bool],
    required: Dict[str, TaskGroup],
    allocs: List[Allocation],
) -> DiffResult:
    """Set difference of target vs existing allocations
    (reference: util.go:54-131)."""
    result = DiffResult()

    if not allocs:
        # Fresh registration fast path: everything is a placement. Hot at
        # bench scale (100k names); skips per-name membership checks.
        result.place = [AllocTuple(name, tg) for name, tg in required.items()]
        return result

    existing: Set[str] = set()

    for exist in allocs:
        name = exist.name
        existing.add(name)
        tg = required.get(name)

        if tg is None:
            result.stop.append(AllocTuple(name, tg, exist))
            continue

        if tainted_nodes.get(exist.node_id, False):
            result.migrate.append(AllocTuple(name, tg, exist))
            continue

        if job.modify_index != exist.job.modify_index:
            result.update.append(AllocTuple(name, tg, exist))
            continue

        result.ignore.append(AllocTuple(name, tg, exist))

    for name, tg in required.items():
        if name not in existing:
            result.place.append(AllocTuple(name, tg))
    return result


def diff_system_allocs(
    job: Optional[Job],
    nodes: List[Node],
    tainted_nodes: Dict[str, bool],
    allocs: List[Allocation],
) -> DiffResult:
    """Per-node diff for system jobs; migrate becomes stop
    (reference: util.go:133-173)."""
    if not allocs:
        # Fresh registration: with no existing allocations every node's
        # diff degenerates to place-everything — one flat loop instead of
        # a full diff_allocs per node (the 10k-node hot case).
        required = materialize_task_groups(job)
        items = list(required.items())
        result = DiffResult()
        for node in nodes:
            for name, tg in items:
                tup = AllocTuple(name, tg)
                tup.alloc = Allocation(node_id=node.id)
                result.place.append(tup)
        return result
    node_allocs: Dict[str, List[Allocation]] = {}
    for alloc in allocs:
        node_allocs.setdefault(alloc.node_id, []).append(alloc)
    for node in nodes:
        node_allocs.setdefault(node.id, [])

    required = materialize_task_groups(job)
    result = DiffResult()
    for node_id, nallocs in node_allocs.items():
        diff = diff_allocs(job, tainted_nodes, required, nallocs)
        for tup in diff.place:
            tup.alloc = Allocation(node_id=node_id)
        # A tainted node invalidates the job there outright.
        diff.stop.extend(diff.migrate)
        diff.migrate = []
        result.append(diff)
    return result


def ready_nodes_in_dcs(state, dcs: List[str]) -> List[Node]:
    """All ready, non-draining nodes in the given datacenters
    (reference: util.go:175-209)."""
    dc_set = set(dcs)
    out = []
    for node in state.nodes():
        if node.status != NODE_STATUS_READY:
            continue
        if node.drain:
            continue
        if node.datacenter not in dc_set:
            continue
        out.append(node)
    return out


def retry_max(max_attempts: int, cb) -> None:
    """Retry cb() until it reports done or attempts are exhausted
    (reference: util.go:211-229)."""
    from nomad_tpu_torch.scheduler import SetStatusError

    attempts = 0
    while attempts < max_attempts:
        done = cb()
        if done:
            return
        attempts += 1
    raise SetStatusError(
        f"maximum attempts reached ({max_attempts})", EVAL_STATUS_FAILED
    )


def tainted_nodes(state, allocs: List[Allocation]) -> Dict[str, bool]:
    """node_id -> should-migrate for nodes hosting the allocs
    (reference: util.go:231-254)."""
    out: Dict[str, bool] = {}
    for alloc in allocs:
        if alloc.node_id in out:
            continue
        node = state.node_by_id(alloc.node_id)
        if node is None:
            out[alloc.node_id] = True
            continue
        out[alloc.node_id] = should_drain_node(node.status) or node.drain
    return out


def tasks_updated(a: TaskGroup, b: TaskGroup) -> bool:
    """Whether two task groups differ in a way that defeats in-place update
    (reference: util.go:265-302)."""
    if len(a.tasks) != len(b.tasks):
        return True
    for at in a.tasks:
        bt = b.lookup_task(at.name)
        if bt is None:
            return True
        if at.driver != bt.driver:
            return True
        if at.config != bt.config:
            return True
        if at.env != bt.env:
            return True
        if len(at.resources.networks) != len(bt.resources.networks):
            return True
        for an, bn in zip(at.resources.networks, bt.resources.networks):
            if len(an.dynamic_ports) != len(bn.dynamic_ports):
                return True
    return False


def set_status(
    logger: logging.Logger,
    planner,
    ev: Evaluation,
    next_eval: Optional[Evaluation],
    status: str,
    desc: str,
) -> None:
    """Update eval status via the planner (reference: util.go:304-314)."""
    logger.debug("sched: %s: setting status to %s", ev, status)
    new_eval = ev.copy()
    new_eval.status = status
    new_eval.status_description = desc
    if next_eval is not None:
        new_eval.next_eval = next_eval.id
    planner.update_eval(new_eval)


ALLOC_IN_PLACE = "alloc updating in-place"


def inplace_update(
    ctx,
    ev: Evaluation,
    job: Job,
    stack,
    updates: List[AllocTuple],
) -> List[AllocTuple]:
    """Try to update allocations in place; returns the updates that still
    need destructive handling (reference: util.go:316-398)."""
    remaining: List[AllocTuple] = []
    inplace = 0
    for update in updates:
        existing_tg = update.alloc.job.lookup_task_group(update.task_group.name)
        if existing_tg is None or tasks_updated(update.task_group, existing_tg):
            remaining.append(update)
            continue

        node = ctx.state.node_by_id(update.alloc.node_id)
        if node is None:
            remaining.append(update)
            continue

        # Stage an eviction so the current alloc is discounted during
        # feasibility, then pop it after select (util.go:346-358).
        stack.set_nodes([node])
        ctx.plan.append_update(update.alloc, ALLOC_DESIRED_STATUS_STOP, ALLOC_IN_PLACE)
        option, size = stack.select(update.task_group)
        ctx.plan.pop_update(update.alloc)

        if option is None:
            remaining.append(update)
            continue

        # Network resources cannot change in-place; restore existing offers
        # (guarded by tasks_updated), util.go:365-372.
        for task_name, resources in option.task_resources.items():
            existing_res = update.alloc.task_resources.get(task_name)
            if existing_res is not None:
                resources.networks = existing_res.networks

        new_alloc = update.alloc.copy()
        new_alloc.eval_id = ev.id
        new_alloc.job = job
        new_alloc.resources = size
        new_alloc.task_resources = option.task_resources
        new_alloc.metrics = ctx.metrics()
        new_alloc.desired_status = ALLOC_DESIRED_STATUS_RUN
        new_alloc.desired_description = ""
        new_alloc.client_status = ALLOC_CLIENT_STATUS_PENDING
        ctx.plan.append_alloc(new_alloc)
        inplace += 1

    if updates:
        ctx.logger.debug(
            "sched: %s: %d in-place updates of %d", ev, inplace, len(updates)
        )
    return remaining


def evict_and_place(
    ctx,
    diff: DiffResult,
    allocs: List[AllocTuple],
    desc: str,
    limit: List[int],
) -> bool:
    """Evict up to limit[0] allocs and queue them for placement; returns True
    if the rolling-update limit was hit (reference: util.go:400-416).
    ``limit`` is a single-element list so the caller sees the decrement."""
    n = len(allocs)
    for i in range(min(n, limit[0])):
        a = allocs[i]
        ctx.plan.append_update(a.alloc, ALLOC_DESIRED_STATUS_STOP, desc)
        diff.place.append(a)
    if n <= limit[0]:
        limit[0] -= n
        return False
    limit[0] = 0
    return True


@dataclass
class TgConstrainTuple:
    """Aggregated task-group constraints (reference: util.go:418-447)."""

    constraints: List[Constraint]
    drivers: Set[str]
    size: Resources


def task_group_constraints(tg: TaskGroup) -> TgConstrainTuple:
    constraints = list(tg.constraints)
    drivers: Set[str] = set()
    size = Resources()
    for task in tg.tasks:
        drivers.add(task.driver)
        constraints.extend(task.constraints)
        size.add(task.resources)
    return TgConstrainTuple(constraints=constraints, drivers=drivers, size=size)
