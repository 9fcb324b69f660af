"""The yardstick of the kernels' rooflines: the card's published peaks
and the work each kernel's inputs need.

Frozen copies of ``chip_smoke.py``'s ``bound_ms`` (``:583``),
``waterfill_work`` (``:595``) and the greedy scan's byte and operation
count (``phase_kernels``, ``:688``), so later changes to that script do
not move the yardstick. They count what the data needs, whatever
implements the kernel. NumPy only.
"""

from __future__ import annotations

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Per-node float32 operations of one BestFit score (2 div, 2 sub, 2 pow,
# 2 max, add, sub, 2 clamp, mul, sub). The greedy scan needs N + k scores
# an eval: every node once, then the placed node once a step.
SCORE_OPS = 15


def bound_ms(n_bytes: int, n_ops: int):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def waterfill_work(total, sched_cap, used, job_count, tg_count, bw_avail,
                   bw_used, eligible, ask, bw_ask, count, penalty, jd, td):
    """(bytes, score operations) the water-fill must spend on these
    inputs (NumPy arrays, stacked on the eval axis as the wrapper takes
    them), from the plain version's caps and level: each row's eligible
    flag (1 B); an eligible row's totals, usage and bandwidth (40 B), and
    its job or group count where a distinct flag reads it; a candidate's
    (cap > level, with tasks left after the base) schedulable capacity
    and job count, and one score; each eval's ask, bandwidth ask, count
    and penalty; the counts and remaining written once."""
    as64 = lambda t: np.asarray(t).astype(np.int64)
    total, used, jc, tc, bwa, bwu, ask, bwk, cnt = map(
        as64, (total, used, job_count, tg_count, bw_avail, bw_used, ask,
               bw_ask, count))
    elig = np.asarray(eligible, dtype=bool)
    b, n, _ = total.shape
    avail = total - used
    nonneg = (avail >= 0).all(-1) & (bwu <= bwa)
    a = ask[:, None, :]
    cap = np.where(a > 0, avail // np.maximum(a, 1), 1 << 30).min(-1)
    bw_cap = (bwa - bwu) // np.maximum(bwk, 1)[:, None]
    cap = np.where(bwk[:, None] > 0, np.minimum(cap, bw_cap), cap)
    if jd:
        cap = np.minimum(cap, jc == 0)
    if td:
        cap = np.minimum(cap, tc == 0)
    cap = np.where(elig & nonneg, np.clip(cap, 0, cnt[:, None]), 0)
    cands = 0
    for e in range(b):
        lo, hi = 0, int(min(cnt[e], cap[e].max()))
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if np.minimum(cap[e], mid).sum() <= cnt[e]:
                lo = mid
            else:
                hi = mid - 1
        if cnt[e] > np.minimum(cap[e], lo).sum():
            cands += int((cap[e] > lo).sum())
    live = int(elig.sum())
    n_bytes = (b * n + live * (40 + 4 * jd + 4 * td)
               + cands * (8 + 4 * (not jd)) + b * (16 + 4 + 4 + 4)
               + b * n * 4 + b * 4)
    return n_bytes, SCORE_OPS * cands


def greedy_work(b: int, n: int, k: int):
    """(bytes, score operations) of one batched exact scan of B evals over
    N shared node rows and k steps: every input read once (the node
    tensors [N, 4] int32, [N, 2] float32, [N] int32 shared; per eval the
    usage [N, 4], job, group and bandwidth counts [N] int32, the eligible
    flags [N] bool, the ask [4], bandwidth ask, k active flags and the
    penalty) and the outputs written once (idx int32, ok bool, score
    float32 per step); N + k scores an eval."""
    shared = n * (16 + 8 + 4)
    per_eval = n * (16 + 4 + 4 + 4 + 1) + 16 + 4 + k + 4
    out = k * (4 + 1 + 4)
    return shared + b * (per_eval + out), SCORE_OPS * b * (n + k)
