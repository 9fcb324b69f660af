"""Selection iterators: limit + max-score.

Reference: upstream scheduler/select.go. The TPU path replaces these
with masked top-k/argmax over the whole node axis (nomad_tpu.ops.binpack).
"""

from __future__ import annotations

from typing import Optional

from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.rank import RankedNode


class LimitIterator:
    """Stops after ``limit`` options — the power-of-two-choices bound
    (reference: select.go:3-43)."""

    def __init__(self, ctx: EvalContext, source, limit: int):
        self.ctx = ctx
        self.source = source
        self.limit = limit
        self.seen = 0

    def set_limit(self, limit: int) -> None:
        self.limit = limit

    def next(self) -> Optional[RankedNode]:
        if self.seen == self.limit:
            return None
        option = self.source.next()
        if option is None:
            return None
        self.seen += 1
        return option

    def reset(self) -> None:
        self.source.reset()
        self.seen = 0


class MaxScoreIterator:
    """Consumes all options, returns only the max-score one
    (reference: select.go:45-85)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source
        self.max: Optional[RankedNode] = None

    def next(self) -> Optional[RankedNode]:
        if self.max is not None:
            return None
        while True:
            option = self.source.next()
            if option is None:
                return self.max
            if self.max is None or option.score > self.max.score:
                self.max = option

    def reset(self) -> None:
        self.source.reset()
        self.max = None
