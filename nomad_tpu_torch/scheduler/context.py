"""Per-evaluation placement context.

Reference: upstream scheduler/context.go:11-126. The key method is
``proposed_allocs``: the optimistic per-node view every ranking decision is
made against — existing allocs, minus terminal, minus planned evictions,
plus planned placements.
"""

from __future__ import annotations

import logging
from random import Random
from typing import Dict, List, Optional, Pattern

from nomad_tpu_torch import prng

from nomad_tpu_torch.structs import (
    Allocation,
    AllocMetric,
    Plan,
    filter_terminal_allocs,
    remove_allocs,
)


class EvalContext:
    """Context for one evaluation (reference: context.go:59-126)."""

    def __init__(self, state, plan: Plan, logger: Optional[logging.Logger] = None):
        self._state = state
        self._plan = plan
        self._logger = logger or logging.getLogger("nomad_tpu.sched")
        self._metrics = AllocMetric()
        self.regexp_cache: Dict[str, Pattern] = {}
        self.constraint_cache: Dict[str, object] = {}
        self._prngs: Dict[str, Random] = {}

    def prng(self, name: str) -> Random:
        """Name-salted seeded stream scoped to THIS evaluation (the
        faults.py pattern, nomadlint DET001): seeded from the eval id so
        two workers' concurrent evals draw independently, salted by
        ``name`` so two sites inside one eval never share a cursor."""
        rng = self._prngs.get(name)
        if rng is None:
            rng = self._prngs[name] = prng.stream(
                prng.salt(self._plan.eval_id), name
            )
        return rng

    @property
    def state(self):
        return self._state

    def set_state(self, state) -> None:
        self._state = state

    @property
    def plan(self) -> Plan:
        return self._plan

    @property
    def logger(self) -> logging.Logger:
        return self._logger

    def metrics(self) -> AllocMetric:
        return self._metrics

    def reset(self) -> None:
        """Invoked after each placement (context.go:99-101)."""
        self._metrics = AllocMetric()

    def _proposed(self, node_id: str,
                  existing: List[Allocation]) -> List[Allocation]:
        existing = filter_terminal_allocs(existing)
        update = self._plan.node_update.get(node_id, [])
        proposed = remove_allocs(existing, update) if update else existing
        return proposed + self._plan.node_allocation.get(node_id, [])

    def proposed_allocs(self, node_id: str) -> List[Allocation]:
        """Existing allocs − terminal − planned evictions + planned
        placements (context.go:103-126)."""
        return self._proposed(node_id, self._state.allocs_by_node(node_id))

    def proposed_allocs_objects(self, node_id: str) -> List[Allocation]:
        """``proposed_allocs`` over the object table only. Callers that
        account stored columnar blocks separately (the device mirror's
        usage tensorization) use this to avoid per-node materialization; a
        state without the split view falls back to the full one."""
        getter = getattr(self._state, "allocs_by_node_objects", None)
        if getter is None:
            getter = self._state.allocs_by_node
        return self._proposed(node_id, getter(node_id))
