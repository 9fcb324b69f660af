"""The water-fill solve: the CUDA kernel (``csrc/waterfill.cu``), its
wrapper, and its plain PyTorch version.

Port of nomad_tpu/ops/pallas_solve.py (the Pallas TPU kernel at :272) and
of the jnp function it is bit-identical to, nomad_tpu/ops/binpack.py
``solve_waterfill``. The wrapper launches the kernel for CUDA tensors and
calls the plain version for CPU tensors; it never falls back from one to
the other. nomad_tpu's enablement switch (``pallas_mode``,
``mark_pallas_failed``, ``is_proven``) is not carried over: a kernel fault
raises to the caller.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.ops.binpack import _greedy_step_state, _monotone_u32

# Kernel launches made by the wrapper (the plain path never counts).
LAUNCHES = 0

_BIG = 2**30


def block_rows(n: int) -> int:
    """Rows of an eval of n rows that one block of the kernel holds (the
    kernel spreads an eval over a cluster of blocks; csrc/waterfill.cu
    decides)."""
    return kernels.entry("waterfill", "nomad_waterfill_block_rows", 0, 1,
                         stream=False)(n)


def needs_scratch(n: int) -> bool:
    """Whether the kernel keeps an eval's caps and keys in a [B, N] device
    scratch rather than shared memory (csrc/waterfill.cu decides)."""
    return bool(kernels.entry("waterfill", "nomad_waterfill_needs_scratch",
                              0, 1, stream=False)(n))


def solve_waterfill(
    total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
    eligible, ask, bw_ask, count: int, penalty: float,
    job_distinct: bool, tg_distinct: bool,
) -> Tuple[torch.Tensor, int]:
    """Plain version for one eval, in the operation order of
    binpack.solve_waterfill. Returns (counts[N] int32, unplaced int).

    Diverges from the jnp function only in form: the level search runs as
    a host loop, and selection keys are int64 (``_monotone_u32``)."""
    count = int(count)
    bw_ask_v = int(bw_ask)
    avail = total - used0
    nonneg = torch.all(avail >= 0, dim=-1) & (bw_used0 <= bw_avail)
    safe_ask = torch.clamp(ask, min=1).unsqueeze(0)
    dim_cap = torch.where(
        ask.unsqueeze(0) > 0,
        torch.div(avail, safe_ask, rounding_mode="floor"),
        torch.full_like(avail, _BIG),
    )
    cap = dim_cap.min(dim=-1).values
    if bw_ask_v > 0:
        bw_cap = torch.div(bw_avail - bw_used0, bw_ask_v, rounding_mode="floor")
        cap = torch.minimum(cap, bw_cap)
    zero = torch.zeros_like(cap)
    if job_distinct:
        cap = torch.minimum(cap, (job_count0 == 0).to(cap.dtype))
    if tg_distinct:
        cap = torch.minimum(cap, (tg_count0 == 0).to(cap.dtype))
    cap = torch.where(eligible & nonneg, torch.clamp(cap, 0, count),
                      zero).to(torch.int32)

    # Largest L in [0, min(count, max cap)] with sum(min(cap, L)) <= count.
    lo, hi = 0, min(count, int(cap.max()) if cap.numel() else 0)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if int(torch.clamp(cap, max=mid).sum()) <= count:
            lo = mid
        else:
            hi = mid - 1
    level = lo

    base = torch.clamp(cap, max=level)
    remaining = count - int(base.sum())

    # Partial round: top-`remaining` by score among nodes with headroom.
    bw_ask_t = torch.as_tensor(bw_ask_v, dtype=torch.int32, device=total.device)
    score, fit = _greedy_step_state(
        total, sched_cap, used0 + base.unsqueeze(-1) * ask.unsqueeze(0),
        job_count0 + base, tg_count0 + base, bw_avail,
        bw_used0 + base * bw_ask_t, eligible, ask, bw_ask_t, penalty,
        job_distinct, tg_distinct,
    )
    candidates = fit & (cap > level)
    u = torch.where(candidates, _monotone_u32(score),
                    torch.zeros_like(score, dtype=torch.int64))
    tlo, thi = 0, 0xFFFFFFFE
    for _ in range(32):
        if tlo >= thi:
            break  # the bisection has converged; later steps change nothing
        mid = tlo + (thi - tlo + 1) // 2
        if int((candidates & (u >= mid)).sum()) >= remaining:
            tlo = mid
        else:
            thi = mid - 1
    thresh = tlo
    above = candidates & (u > thresh)
    boundary = candidates & (u == thresh)
    fill = remaining - int(above.sum())
    order = torch.cumsum(boundary.to(torch.int32), dim=-1)
    selected = (above | (boundary & (order <= fill))) & (remaining > 0)
    counts = base + selected.to(torch.int32)
    return counts, count - int(counts.sum())


def solve_waterfill_batched_plain(
    total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
    eligible, ask, bw_ask, count, penalty, job_distinct: bool,
    tg_distinct: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the batched kernel: each eval solved alone."""
    outs = [
        solve_waterfill(
            total[b], sched_cap[b], used0[b], job_count0[b], tg_count0[b],
            bw_avail[b], bw_used0[b], eligible[b], ask[b], bw_ask[b],
            int(count[b]), float(penalty[b]), job_distinct, tg_distinct,
        )
        for b in range(total.shape[0])
    ]
    counts = torch.stack([c for c, _ in outs])
    remaining = torch.tensor([r for _, r in outs], dtype=torch.int32,
                             device=total.device)
    return counts, remaining


def _check(name, t, dtype, shape, device, align=1):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def check_inputs(total, sched_cap, used0, job_count0, tg_count0, bw_avail,
                 bw_used0, eligible, ask, bw_ask, count, penalty):
    """Device, dtype, shape and contiguity of a batched water-fill call."""
    if total.dim() != 3 or total.shape[-1] != 4:
        raise ValueError(f"total must be [B, N, 4], got {tuple(total.shape)}")
    b, n, _ = total.shape
    dev = total.device
    i32, f32 = torch.int32, torch.float32
    _check("total", total, i32, (b, n, 4), dev, 16)
    _check("used0", used0, i32, (b, n, 4), dev, 16)
    _check("sched_cap", sched_cap, f32, (b, n, 2), dev, 8)
    for name, t in (("job_count0", job_count0), ("tg_count0", tg_count0),
                    ("bw_avail", bw_avail), ("bw_used0", bw_used0)):
        _check(name, t, i32, (b, n), dev)
    _check("eligible", eligible, torch.bool, (b, n), dev)
    _check("ask", ask, i32, (b, 4), dev, 16)
    _check("bw_ask", bw_ask, i32, (b,), dev)
    _check("count", count, i32, (b,), dev)
    _check("penalty", penalty, f32, (b,), dev)


def solve_waterfill_batched(
    total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
    eligible, ask, bw_ask, count, penalty, job_distinct: bool,
    tg_distinct: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched water-fill, one eval per row: every input stacked on axis 0
    ([B, N, 4] / [B, N, 2] / [B, N] node tensors, [B, 4] ask, [B] bw_ask,
    count, penalty). Returns (counts [B, N] int32, remaining [B] int32).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    check_inputs(total, sched_cap, used0, job_count0, tg_count0, bw_avail,
                 bw_used0, eligible, ask, bw_ask, count, penalty)
    dev = total.device
    if dev.type == "cpu":
        return solve_waterfill_batched_plain(
            total, sched_cap, used0, job_count0, tg_count0, bw_avail,
            bw_used0, eligible, ask, bw_ask, count, penalty, job_distinct,
            tg_distinct,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    global LAUNCHES
    launch, outs = _bind_launch(
        total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
        eligible, ask, bw_ask, count, penalty, job_distinct, tg_distinct)
    kernels.check_launch(launch(), "waterfill")
    LAUNCHES += 1
    return outs


def _bind_launch(total, sched_cap, used0, job_count0, tg_count0, bw_avail,
                 bw_used0, eligible, ask, bw_ask, count, penalty,
                 job_distinct, tg_distinct):
    """Allocate the outputs and scratch of one launch on the current
    stream; returns (a zero-argument call that launches the kernel and
    returns its cudaError_t, (counts, remaining))."""
    b, n, _ = total.shape
    dev = total.device
    fn = kernels.entry("waterfill", "nomad_waterfill", 16, 4)
    counts = torch.empty((b, n), dtype=torch.int32, device=dev)
    remaining = torch.empty((b,), dtype=torch.int32, device=dev)
    scratch = needs_scratch(n)
    cap_scratch = (torch.empty((b, n), dtype=torch.int32, device=dev)
                   if scratch else None)
    key_scratch = (torch.empty((b, n), dtype=torch.int32, device=dev)
                   if scratch else None)
    ptrs = [t.data_ptr() for t in (
        total, used0, sched_cap, job_count0, tg_count0, bw_avail, bw_used0,
        eligible, ask, bw_ask, count, penalty, counts, remaining)]
    ptrs += [None if t is None else t.data_ptr()
             for t in (cap_scratch, key_scratch)]
    args = (*ptrs, b, n, int(bool(job_distinct)), int(bool(tg_distinct)),
            torch.cuda.current_stream(dev).cuda_stream)
    bufs = (counts, remaining, cap_scratch, key_scratch)

    def launch():
        with torch.cuda.device(dev):
            return fn(*args)

    launch.buffers = bufs  # keeps the scratch alive as long as the call
    return launch, (counts, remaining)


def kernel_only(*inputs):
    """For timing the kernel apart from its wrapper: checks the inputs of
    ``solve_waterfill_batched`` once, allocates its buffers once, and
    returns a zero-argument call that only launches the kernel (no checks,
    no allocation, not counted in ``LAUNCHES``)."""
    check_inputs(*inputs[:12])
    if inputs[0].device.type != "cuda":
        raise ValueError("kernel_only needs CUDA tensors")
    launch, _outs = _bind_launch(*inputs)

    def run():
        kernels.check_launch(launch(), "waterfill")

    return run
