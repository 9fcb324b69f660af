"""Fit and BestFit score over the node axis (port of nomad_tpu.ops.fit).

- ``fit_mask``: ``all(used + ask <= total, axis=-1)`` — the Superset check
  (upstream nomad/structs/structs.go:577-594) over N nodes.
- ``score_fit``: Google "BestFit v3" — ``20 - 10^freeCpu - 10^freeMem``,
  clamped to [0, 18], with free fractions against schedulable capacity
  (total - reserved) and utilization including the node's reserved
  resources (upstream nomad/structs/funcs.go:44-124).

Same operation order as the JAX functions, in float32. ``torch.pow`` and
XLA's ``jnp.power`` round differently on ~1.8% of inputs (at most 1 ulp);
the parity tests state that contract.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def score_fit(sched_capacity: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    """BestFit v3 score per node.

    sched_capacity: [..., N, 2] float32 schedulable cpu, mem.
    used:           [..., N, 2] float32 utilization including reserved.
    Returns [..., N] float32 scores in [0, 18]; higher = fuller.
    """
    # nomad_tpu counts jit traces here; eager torch has no trace to count.
    safe_cap = torch.clamp(sched_capacity, min=1.0)
    free = 1.0 - used / safe_cap
    # Zero schedulable capacity -> -inf free -> 10**x underflows to 0.
    free = torch.where(sched_capacity > 0, free,
                       torch.full_like(free, NEG_INF))
    total = torch.pow(10.0, free).sum(dim=-1)
    return torch.clamp(20.0 - total, 0.0, 18.0)


def fit_mask(total: torch.Tensor, used_plus_ask: torch.Tensor) -> torch.Tensor:
    """Dimension-wise resource fit per node: [..., N, D] ints -> [..., N]."""
    return torch.all(used_plus_ask <= total, dim=-1)
