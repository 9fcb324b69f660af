"""Bin-pack solve helpers and the async dispatch API (port of
nomad_tpu.ops.binpack).

Two solves over the node axis, each a hand-written CUDA kernel with its
plain PyTorch version in the same module:

- the exact greedy scan (``ops/greedy.py``) for counts up to
  ``EXACT_THRESHOLD``: k masked-argmax placements, each recomputing fit +
  BestFit score + anti-affinity penalty against the utilization carried
  from earlier placements (upstream scheduler/stack.go:131-159);
- the closed-form water-fill (``ops/waterfill.py``) for larger counts:
  every full round places one copy on every fitting node, so a level
  bisection plus one scored top-k partial round replaces the round loop.

Both go through the coalescing dispatcher (``ops/coalesce.py``), which
stacks concurrent evals' solves on an eval axis. ``solve_rounds_fused``
(the JAX package's fuzz oracle) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from nomad_tpu_torch import trace
from nomad_tpu_torch.ops.fit import NEG_INF, score_fit

# Counts at or below this route through the exact greedy scan (padded to a
# power-of-two count bucket); larger counts take the water-fill.
EXACT_THRESHOLD = 128


def bucket(n: int, floor: int = 8) -> int:
    """Next power-of-two bucket for padded shapes."""
    b = floor
    while b < n:
        b *= 2
    return b


_DEVICE_CONST_CACHE: dict = {}


def device_const(kind: str, value, device: torch.device) -> torch.Tensor:
    """Small device-resident constants (ask vectors, bandwidth asks),
    cached so repeat evals upload nothing."""
    key = (kind, value, str(device))
    cached = _DEVICE_CONST_CACHE.get(key)
    if cached is None:
        if kind == "ask":
            cached = torch.tensor(list(value), dtype=torch.int32,
                                  device=device)
        elif kind == "i32":
            cached = torch.tensor(value, dtype=torch.int32, device=device)
        else:
            cached = torch.tensor(value, dtype=torch.float32, device=device)
        if len(_DEVICE_CONST_CACHE) > 512:
            _DEVICE_CONST_CACHE.clear()
        _DEVICE_CONST_CACHE[key] = cached
    return cached


def _monotone_u32(score: torch.Tensor) -> torch.Tensor:
    """Map float32 -> an order-preserving unsigned 32-bit key (flip all
    bits of negatives, only the sign bit of positives). Held in int64:
    torch's uint32 operators are incomplete on the CPU. The CUDA kernel
    computes the same key as a real uint32."""
    bits = score.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits >> 31) == 1
    return torch.where(neg, (~bits) & 0xFFFFFFFF, bits | 0x80000000)


def _greedy_step_state(
    total, sched_cap, used, job_count, tg_count, bw_avail, bw_used,
    eligible, ask, bw_ask, penalty, job_distinct: bool, tg_distinct: bool,
):
    """(score, fit) for one placement given current utilization.

    job_distinct/tg_distinct mirror the two distinct_hosts scopes of
    ProposedAllocConstraintIterator (feasible.go:218-247)."""
    used_plus = used + ask.unsqueeze(-2)
    fit = torch.all(used_plus <= total, dim=-1)
    fit = fit & ((bw_used + bw_ask) <= bw_avail)
    fit = fit & eligible
    if job_distinct:
        fit = fit & (job_count == 0)
    if tg_distinct:
        fit = fit & (tg_count == 0)
    score = score_fit(sched_cap, used_plus[..., :2].to(torch.float32))
    score = score - penalty * job_count.to(torch.float32)
    score = torch.where(fit, score, torch.full_like(score, NEG_INF))
    return score, fit


def solve_many_async(
    total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
    eligible, ask, bw_ask, count: int, penalty: float,
    job_distinct: bool = False, tg_distinct: bool = False,
    exact_threshold: int = EXACT_THRESHOLD,
):
    """Dispatch the solve for ``count`` copies of one ask; return a fetch()
    closure that blocks on the device and yields (node_indices, ok) as
    numpy. The exact scan returns true greedy order; the water-fill path
    expands per-node counts, so indices come grouped by node. Unplaceable
    tail is idx -1 / ok False."""
    from nomad_tpu_torch.ops.coalesce import GLOBAL_SOLVER

    if count <= exact_threshold:
        return GLOBAL_SOLVER.submit_exact(
            total, sched_cap, used0, job_count0, tg_count0, bw_avail,
            bw_used0, eligible, ask, bw_ask, count, penalty,
            job_distinct=job_distinct, tg_distinct=tg_distinct,
        )

    fetch_counts = solve_counts_async(
        total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
        eligible, ask, bw_ask, count, penalty,
        job_distinct=job_distinct, tg_distinct=tg_distinct,
    )

    def fetch_fused():
        counts, _unplaced = fetch_counts()
        with trace.stage("readback"):
            idxs = np.repeat(
                np.arange(counts.shape[0], dtype=np.int64), counts
            )
            n_placed = idxs.shape[0]
            out_idx = np.full(count, -1, dtype=np.int64)
            out_idx[:n_placed] = idxs[:count]
            oks = np.zeros(count, dtype=bool)
            oks[: min(n_placed, count)] = True
        return out_idx, oks

    return fetch_fused


def solve_counts_async(
    total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
    eligible, ask, bw_ask, count: int, penalty: float,
    job_distinct: bool = False, tg_distinct: bool = False,
):
    """Water-fill dispatch returning per-node placement *counts* through
    the coalescing engine. fetch() -> (counts[N] np.int32, n_unplaced)."""
    from nomad_tpu_torch.ops.coalesce import GLOBAL_SOLVER

    return GLOBAL_SOLVER.submit(
        total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
        eligible, ask, bw_ask, count, penalty,
        job_distinct=job_distinct, tg_distinct=tg_distinct,
    )
