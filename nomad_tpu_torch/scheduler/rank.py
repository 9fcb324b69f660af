"""Ranking: bin-pack scoring and job anti-affinity.

Reference: upstream scheduler/rank.go. The BinPackIterator here is
the scalar oracle for the fused fit+score kernel in nomad_tpu.ops.fit.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from nomad_tpu_torch.network import NetworkIndex
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.structs import (
    Allocation,
    Node,
    Resources,
    Task,
    allocs_fit,
    score_fit,
)


class RankedNode:
    """A node + accumulated score + per-task resources
    (reference: rank.go:12-45)."""

    def __init__(self, node: Node):
        self.node = node
        self.score = 0.0
        self.task_resources: Dict[str, Resources] = {}
        self.proposed: Optional[List[Allocation]] = None

    def __repr__(self) -> str:
        return f"<Node: {self.node.id} Score: {self.score:.3f}>"

    def proposed_allocs(self, ctx: EvalContext) -> List[Allocation]:
        if self.proposed is None:
            self.proposed = ctx.proposed_allocs(self.node.id)
        return self.proposed

    def set_task_resources(self, task: Task, resources: Resources) -> None:
        self.task_resources[task.name] = resources


class FeasibleRankIterator:
    """Upgrades a FeasibleIterator to a RankIterator
    (reference: rank.go:59-89)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        return RankedNode(option)

    def reset(self) -> None:
        self.source.reset()


class StaticRankIterator:
    """Fixed RankedNode list; used in tests (reference: rank.go:91-129)."""

    def __init__(self, ctx: EvalContext, nodes: List[RankedNode]):
        self.ctx = ctx
        self.nodes = nodes
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[RankedNode]:
        n = len(self.nodes)
        if self.offset == n or self.seen == n:
            if self.seen != n:
                self.offset = 0
            else:
                return None
        option = self.nodes[self.offset]
        self.offset += 1
        self.seen += 1
        return option

    def reset(self) -> None:
        self.seen = 0


class BinPackIterator:
    """Scores nodes by bin-packing the task group's total ask on top of the
    node's proposed allocations (reference: rank.go:131-238).

    Per node: proposed allocs -> NetworkIndex -> per-task network offer ->
    AllocsFit -> ScoreFit. Nodes that do not fit are skipped (eviction is
    acknowledged but unimplemented in the reference too, rank.go:222-226).
    """

    def __init__(self, ctx: EvalContext, source, evict: bool, priority: int):
        self.ctx = ctx
        self.source = source
        self.evict = evict
        self.priority = priority
        self.tasks: List[Task] = []

    def set_priority(self, priority: int) -> None:
        self.priority = priority

    def set_tasks(self, tasks: List[Task]) -> None:
        self.tasks = tasks

    def next(self) -> Optional[RankedNode]:
        while True:
            option = self.source.next()
            if option is None:
                return None

            proposed = option.proposed_allocs(self.ctx)

            # Index existing network usage. Port draws ride THIS eval's
            # seeded stream: concurrent evals with stale snapshots must
            # draw independently (see NetworkIndex.__init__).
            net_idx = NetworkIndex(self.ctx.prng("network.dynamic_ports"))
            net_idx.set_node(option.node)
            net_idx.add_allocs(proposed)

            # Assign resources (and network offers) per task
            total = Resources()
            exhausted = False
            for task in self.tasks:
                task_resources = task.resources.copy()
                if task_resources.networks:
                    ask = task_resources.networks[0]
                    offer, err = net_idx.assign_network(ask)
                    if offer is None:
                        self.ctx.metrics().exhausted_node(
                            option.node, f"network: {err}"
                        )
                        exhausted = True
                        break
                    # Reserve to prevent a sibling task colliding
                    net_idx.add_reserved(offer)
                    task_resources.networks = [offer]
                option.set_task_resources(task, task_resources)
                total.add(task_resources)
            if exhausted:
                continue

            # Check fit of proposed + new ask
            proposed_plus = proposed + [Allocation(resources=total)]
            fit, dim, util = allocs_fit(option.node, proposed_plus, net_idx)
            if not fit:
                self.ctx.metrics().exhausted_node(option.node, dim)
                continue

            fitness = score_fit(option.node, util)
            option.score += fitness
            self.ctx.metrics().score_node(option.node, "binpack", fitness)
            return option

    def reset(self) -> None:
        self.source.reset()


class JobAntiAffinityIterator:
    """Penalizes co-placement with allocs of the same job
    (reference: rank.go:240-302)."""

    def __init__(self, ctx: EvalContext, source, penalty: float, job_id: str):
        self.ctx = ctx
        self.source = source
        self.penalty = penalty
        self.job_id = job_id

    def set_job(self, job_id: str) -> None:
        self.job_id = job_id

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        proposed = option.proposed_allocs(self.ctx)
        collisions = sum(1 for a in proposed if a.job_id == self.job_id)
        if collisions > 0:
            score_penalty = -1.0 * collisions * self.penalty
            option.score += score_penalty
            self.ctx.metrics().score_node(option.node, "job-anti-affinity", score_penalty)
        return option

    def reset(self) -> None:
        self.source.reset()
