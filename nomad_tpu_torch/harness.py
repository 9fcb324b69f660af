"""In-process scheduler harness (port of nomad_tpu's tests/sched_harness.py).

A real in-memory StateStore plus a Planner that records every plan and
applies it straight to the store (reference: upstream
scheduler/scheduler_test.go:32-176); ``planner`` overrides what a
submitted plan does (``RejectPlan`` forces the refresh/retry path).
"""

from __future__ import annotations

import logging
import threading
from typing import List

from nomad_tpu_torch.scheduler import new_scheduler
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import Allocation, Evaluation, Plan, PlanResult

logger = logging.getLogger("nomad_tpu_torch.harness")


class RejectPlan:
    """Always rejects the plan and forces a state refresh
    (reference: scheduler_test.go:13-30)."""

    def __init__(self, harness: "Harness"):
        self.harness = harness

    def submit_plan(self, plan: Plan):
        result = PlanResult()
        result.refresh_index = self.harness.next_index()
        return result, self.harness.state

    def update_eval(self, ev: Evaluation) -> None:
        pass

    def create_eval(self, ev: Evaluation) -> None:
        pass


class Harness:
    """Lightweight scheduler harness (reference: scheduler_test.go:32-158)."""

    def __init__(self) -> None:
        self.state = StateStore()
        self.planner = None  # custom planner override
        self._plan_lock = threading.Lock()
        self.plans: List[Plan] = []
        self.evals: List[Evaluation] = []
        self.create_evals: List[Evaluation] = []
        self._next_index = 1
        self._index_lock = threading.Lock()

    # -- Planner interface -------------------------------------------------

    def submit_plan(self, plan: Plan):
        with self._plan_lock:
            self.plans.append(plan)
            if self.planner is not None:
                return self.planner.submit_plan(plan)

            index = self.next_index()
            result = PlanResult(
                node_update=plan.node_update,
                node_allocation=plan.node_allocation,
                alloc_batches=plan.alloc_batches,
                update_batches=plan.update_batches,
                block_stops=plan.block_stops,
                alloc_index=index,
            )

            allocs: List[Allocation] = []
            for run in plan.block_stops:
                allocs.extend(run.materialize())
            for update_list in plan.node_update.values():
                allocs.extend(update_list)
            for alloc_list in plan.node_allocation.values():
                allocs.extend(alloc_list)
            for batch in plan.alloc_batches:
                allocs.extend(batch.materialize())
            for batch in plan.update_batches:
                allocs.extend(batch.materialize())
            allocs.extend(plan.failed_allocs)

            self.state.upsert_allocs(index, allocs)
            return result, None

    def update_eval(self, ev: Evaluation) -> None:
        with self._plan_lock:
            self.evals.append(ev)
            if self.planner is not None:
                self.planner.update_eval(ev)

    def create_eval(self, ev: Evaluation) -> None:
        with self._plan_lock:
            self.create_evals.append(ev)
            if self.planner is not None:
                self.planner.create_eval(ev)

    # -- helpers -----------------------------------------------------------

    def next_index(self) -> int:
        with self._index_lock:
            idx = self._next_index
            self._next_index += 1
            return idx

    def snapshot(self):
        return self.state.snapshot()

    def process(self, factory_name: str, ev: Evaluation, device=None) -> None:
        """Run one eval through the named scheduler against a fresh
        snapshot. ``device`` defaults to the CUDA card for ``tpu-*``."""
        sched = new_scheduler(factory_name, self.snapshot(), self, logger,
                              device=device)
        sched.process(ev)
