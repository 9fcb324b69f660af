"""Feasibility filtering: the host-side equivalent of the reference's
chained FeasibleIterators (upstream scheduler/feasible.go).

The TPU path computes the same predicates as dense boolean masks
(nomad_tpu.tpu.mirror NodeMirror.constraint_mask/driver_mask); this
module is the scalar oracle it is
differential-tested against, and handles the rare data-dependent cases
(regex, distinct_hosts) that stay host-side in both paths.
"""

from __future__ import annotations

import re
from random import Random
from typing import Dict, List, Optional, Set, Tuple

from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.structs import (
    CONSTRAINT_DISTINCT_HOSTS,
    CONSTRAINT_REGEX,
    CONSTRAINT_VERSION,
    Constraint,
    Job,
    Node,
    TaskGroup,
)
from nomad_tpu_torch.version import check_version_constraint


def shuffle_nodes(nodes: List[Node], rng: Random) -> None:
    """In-place Fisher-Yates (reference: scheduler/util.go:257-263).

    ``rng`` is the caller's name-salted seeded stream (EvalContext.prng)
    — the shuffle exists to decorrelate concurrent schedulers, and a
    per-eval seeded stream does that without coupling the decision to
    the process-global random cursor (nomadlint DET001)."""
    rng.shuffle(nodes)


class StaticIterator:
    """Yields nodes in fixed order; base of every chain
    (reference: feasible.go:29-72)."""

    def __init__(self, ctx: EvalContext, nodes: Optional[List[Node]] = None):
        self.ctx = ctx
        self.nodes: List[Node] = nodes or []
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[Node]:
        n = len(self.nodes)
        if self.offset == n or self.seen == n:
            if self.seen != n:
                self.offset = 0
            else:
                return None
        option = self.nodes[self.offset]
        self.offset += 1
        self.seen += 1
        self.ctx.metrics().evaluate_node()
        return option

    def reset(self) -> None:
        self.seen = 0

    def set_nodes(self, nodes: List[Node]) -> None:
        self.nodes = nodes
        self.offset = 0
        self.seen = 0


def new_random_iterator(ctx: EvalContext, nodes: List[Node]) -> StaticIterator:
    """Shuffled StaticIterator (reference: feasible.go:74-83)."""
    shuffle_nodes(nodes, ctx.prng("feasible.shuffle"))
    return StaticIterator(ctx, nodes)


class DriverIterator:
    """Filters nodes lacking the drivers a task group needs; drivers are
    node attributes like ``driver.exec=1`` (reference: feasible.go:85-151)."""

    def __init__(self, ctx: EvalContext, source, drivers: Optional[Set[str]] = None):
        self.ctx = ctx
        self.source = source
        self.drivers = drivers or set()

    def set_drivers(self, drivers: Set[str]) -> None:
        self.drivers = drivers

    def next(self) -> Optional[Node]:
        while True:
            option = self.source.next()
            if option is None:
                return None
            if self.has_drivers(option):
                return option
            self.ctx.metrics().filter_node(option, "missing drivers")

    def reset(self) -> None:
        self.source.reset()

    def has_drivers(self, option: Node) -> bool:
        for driver in self.drivers:
            value = option.attributes.get(f"driver.{driver}")
            if value is None:
                return False
            enabled = _parse_bool(value)
            if enabled is None:
                self.ctx.logger.warning(
                    "node %s has invalid driver setting driver.%s: %s",
                    option.id, driver, value,
                )
                return False
            if not enabled:
                return False
        return True


def _parse_bool(value: str) -> Optional[bool]:
    """Go strconv.ParseBool semantics."""
    if value in ("1", "t", "T", "TRUE", "true", "True"):
        return True
    if value in ("0", "f", "F", "FALSE", "false", "False"):
        return False
    return None


class ProposedAllocConstraintIterator:
    """distinct_hosts against proposed allocations
    (reference: feasible.go:153-251)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source
        self.tg: Optional[TaskGroup] = None
        self.job: Optional[Job] = None
        self.tg_distinct_hosts = False
        self.job_distinct_hosts = False

    def set_task_group(self, tg: TaskGroup) -> None:
        self.tg = tg
        self.tg_distinct_hosts = _has_distinct_hosts(tg.constraints)

    def set_job(self, job: Job) -> None:
        self.job = job
        self.job_distinct_hosts = _has_distinct_hosts(job.constraints)

    def next(self) -> Optional[Node]:
        while True:
            option = self.source.next()
            if option is None or not (self.job_distinct_hosts or self.tg_distinct_hosts):
                return option
            if not self._satisfies_distinct_hosts(option):
                self.ctx.metrics().filter_node(option, CONSTRAINT_DISTINCT_HOSTS)
                continue
            return option

    def _satisfies_distinct_hosts(self, option: Node) -> bool:
        proposed = self.ctx.proposed_allocs(option.id)
        for alloc in proposed:
            job_collision = alloc.job_id == self.job.id
            task_collision = alloc.task_group == self.tg.name
            if (self.job_distinct_hosts and job_collision) or (
                job_collision and task_collision
            ):
                return False
        return True

    def reset(self) -> None:
        self.source.reset()


def _has_distinct_hosts(constraints: List[Constraint]) -> bool:
    return any(c.operand == CONSTRAINT_DISTINCT_HOSTS for c in constraints)


class ConstraintIterator:
    """Filters on a set of constraints (reference: feasible.go:253-317)."""

    def __init__(self, ctx: EvalContext, source, constraints: Optional[List[Constraint]] = None):
        self.ctx = ctx
        self.source = source
        self.constraints = constraints or []

    def set_constraints(self, constraints: List[Constraint]) -> None:
        self.constraints = constraints

    def next(self) -> Optional[Node]:
        while True:
            option = self.source.next()
            if option is None:
                return None
            if self.meets_constraints(option):
                return option

    def reset(self) -> None:
        self.source.reset()

    def meets_constraints(self, option: Node) -> bool:
        for constraint in self.constraints:
            if not self.meets_constraint(constraint, option):
                self.ctx.metrics().filter_node(option, str(constraint))
                return False
        return True

    def meets_constraint(self, constraint: Constraint, option: Node) -> bool:
        l_val, l_ok = resolve_constraint_target(constraint.l_target, option)
        r_val, r_ok = resolve_constraint_target(constraint.r_target, option)
        if not l_ok or not r_ok:
            return False
        return check_constraint(self.ctx, constraint.operand, l_val, r_val)


def resolve_constraint_target(target: str, node: Node) -> Tuple[Optional[str], bool]:
    """Resolve interpolation targets ``$node.*``, ``$attr.*``, ``$meta.*``
    or return the literal (reference: feasible.go:320-351)."""
    if not target.startswith("$"):
        return target, True
    if target == "$node.id":
        return node.id, True
    if target == "$node.datacenter":
        return node.datacenter, True
    if target == "$node.name":
        return node.name, True
    if target.startswith("$attr."):
        attr = target[len("$attr."):]
        if attr in node.attributes:
            return node.attributes[attr], True
        return None, False
    if target.startswith("$meta."):
        meta = target[len("$meta."):]
        if meta in node.meta:
            return node.meta[meta], True
        return None, False
    return None, False


def check_constraint(ctx: EvalContext, operand: str, l_val: str, r_val: str) -> bool:
    """Evaluate one constraint operand (reference: feasible.go:353-377)."""
    if operand == CONSTRAINT_DISTINCT_HOSTS:
        return True  # handled by ProposedAllocConstraintIterator
    if operand in ("=", "==", "is"):
        return l_val == r_val
    if operand in ("!=", "not"):
        return l_val != r_val
    if operand in ("<", "<=", ">", ">="):
        return check_lexical_order(operand, l_val, r_val)
    if operand == CONSTRAINT_VERSION:
        return check_version_constraint(l_val, r_val)
    if operand == CONSTRAINT_REGEX:
        return check_regexp_constraint(ctx, l_val, r_val)
    return False


def check_lexical_order(op: str, l_val: str, r_val: str) -> bool:
    """String ordering (reference: feasible.go:379-403)."""
    if not isinstance(l_val, str) or not isinstance(r_val, str):
        return False
    if op == "<":
        return l_val < r_val
    if op == "<=":
        return l_val <= r_val
    if op == ">":
        return l_val > r_val
    if op == ">=":
        return l_val >= r_val
    return False


def check_regexp_constraint(ctx: EvalContext, l_val: str, r_val: str) -> bool:
    """Regex match with per-eval compile cache (reference: feasible.go:448-479)."""
    if not isinstance(l_val, str) or not isinstance(r_val, str):
        return False
    pattern = ctx.regexp_cache.get(r_val)
    if pattern is None:
        try:
            pattern = re.compile(r_val)
        except re.error:
            return False
        ctx.regexp_cache[r_val] = pattern
    return pattern.search(l_val) is not None
