"""The exact greedy scan: the CUDA kernel (``csrc/greedy.cu``), its
wrapper, and its plain PyTorch version.

Port of nomad_tpu/ops/binpack.py ``solve_greedy`` and its eval-axis form
``solve_greedy_batched_shared`` (:115-199), an XLA program in the JAX
package (no Pallas kernel). The node tensors (total, sched_cap, bw_avail)
are shared by every eval of a dispatch; the per-eval tensors are stacked.
The wrapper launches the kernel for CUDA tensors and calls the plain
version for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.ops.binpack import _greedy_step_state
from nomad_tpu_torch.ops.fit import NEG_INF
from nomad_tpu_torch.ops.waterfill import _check

# Kernel launches made by the wrapper (the plain path never counts).
LAUNCHES = 0

# Node rows up to which the kernel keeps an eval's score cache in shared
# memory (kSmemCacheRows in csrc/greedy.cu); above it the wrapper allocates
# a [B, N] float32 scratch for it.
SMEM_CACHE_ROWS = 16384


def solve_greedy(
    total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
    eligible, ask, bw_ask, active, penalty, k: int, job_distinct: bool,
    tg_distinct: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version for one eval: k sequential placements of one ask, in
    the operation order of binpack.solve_greedy (a host loop in place of
    lax.scan). Returns (idx[k] int32, ok[k] bool, score[k] float32)."""
    used = used0.clone()
    job_count = job_count0.clone()
    tg_count = tg_count0.clone()
    bw_used = bw_used0.clone()
    bw_ask_t = torch.as_tensor(int(bw_ask), dtype=torch.int32,
                               device=total.device)
    idxs, oks, scores = [], [], []
    for step in range(k):
        score, _fit = _greedy_step_state(
            total, sched_cap, used, job_count, tg_count, bw_avail, bw_used,
            eligible, ask, bw_ask_t, penalty, job_distinct, tg_distinct,
        )
        idx = int(torch.argmax(score))  # first maximal index, as jnp.argmax
        s = score[idx]
        ok = bool(s > NEG_INF) and bool(active[step])
        if ok:
            used[idx] += ask
            job_count[idx] += 1
            tg_count[idx] += 1
            bw_used[idx] += bw_ask_t
        idxs.append(idx)
        oks.append(ok)
        scores.append(s)
    dev = total.device
    return (torch.tensor(idxs, dtype=torch.int32, device=dev),
            torch.tensor(oks, dtype=torch.bool, device=dev),
            torch.stack(scores) if scores
            else torch.zeros(0, dtype=torch.float32, device=dev))


def solve_greedy_batched_shared_plain(
    total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
    eligible, ask, bw_ask, active, penalty, k: int, job_distinct: bool,
    tg_distinct: bool,
):
    """Plain version of the batched kernel: each eval scanned alone against
    the shared node tensors."""
    outs = [
        solve_greedy(
            total, sched_cap, used0[b], job_count0[b], tg_count0[b],
            bw_avail, bw_used0[b], eligible[b], ask[b], bw_ask[b],
            active[b], float(penalty[b]), k, job_distinct, tg_distinct,
        )
        for b in range(used0.shape[0])
    ]
    return tuple(torch.stack(col) for col in zip(*outs))


def check_inputs(total, sched_cap, used0, job_count0, tg_count0, bw_avail,
                 bw_used0, eligible, ask, bw_ask, active, penalty, k):
    if used0.dim() != 3 or used0.shape[-1] != 4:
        raise ValueError(f"used0 must be [B, N, 4], got {tuple(used0.shape)}")
    b, n, _ = used0.shape
    dev = used0.device
    i32, f32 = torch.int32, torch.float32
    _check("total", total, i32, (n, 4), dev, 16)
    _check("sched_cap", sched_cap, f32, (n, 2), dev, 8)
    _check("bw_avail", bw_avail, i32, (n,), dev)
    _check("used0", used0, i32, (b, n, 4), dev, 16)
    for name, t in (("job_count0", job_count0), ("tg_count0", tg_count0),
                    ("bw_used0", bw_used0)):
        _check(name, t, i32, (b, n), dev)
    _check("eligible", eligible, torch.bool, (b, n), dev)
    _check("ask", ask, i32, (b, 4), dev, 16)
    _check("bw_ask", bw_ask, i32, (b,), dev)
    _check("active", active, torch.bool, (b, k), dev)
    _check("penalty", penalty, f32, (b,), dev)


def solve_greedy_batched_shared(
    total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
    eligible, ask, bw_ask, active, penalty, k: int, job_distinct: bool,
    tg_distinct: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched exact scan: node tensors shared ([N, 4], [N, 2], [N]),
    per-eval tensors stacked on axis 0, ``active`` [B, k] masks the padded
    steps. Returns (idx [B, k] int32, ok [B, k] bool, score [B, k] f32).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    check_inputs(total, sched_cap, used0, job_count0, tg_count0, bw_avail,
                 bw_used0, eligible, ask, bw_ask, active, penalty, k)
    dev = used0.device
    if dev.type == "cpu":
        return solve_greedy_batched_shared_plain(
            total, sched_cap, used0, job_count0, tg_count0, bw_avail,
            bw_used0, eligible, ask, bw_ask, active, penalty, k,
            job_distinct, tg_distinct,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    global LAUNCHES
    launch, outs = _bind_launch(
        total, sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0,
        eligible, ask, bw_ask, active, penalty, k, job_distinct, tg_distinct)
    kernels.check_launch(launch(), "greedy")
    LAUNCHES += 1
    return outs


def _bind_launch(total, sched_cap, used0, job_count0, tg_count0, bw_avail,
                 bw_used0, eligible, ask, bw_ask, active, penalty, k,
                 job_distinct, tg_distinct):
    """Allocate the outputs and scratch of one launch on the current
    stream; returns (a zero-argument call that launches the kernel and
    returns its cudaError_t, (idx, ok, score))."""
    b, n, _ = used0.shape
    dev = used0.device
    fn = kernels.entry("greedy", "nomad_greedy", 17, 5)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    ok = torch.empty((b, k), dtype=torch.bool, device=dev)
    score = torch.empty((b, k), dtype=torch.float32, device=dev)
    placed = torch.empty((b, n), dtype=torch.int32, device=dev)
    cache = (torch.empty((b, n), dtype=torch.float32, device=dev)
             if n > SMEM_CACHE_ROWS else None)
    ptrs = [t.data_ptr() for t in (
        total, sched_cap, bw_avail, used0, job_count0, tg_count0, bw_used0,
        eligible, ask, bw_ask, active, penalty, idx, ok, score, placed)]
    ptrs.append(None if cache is None else cache.data_ptr())
    args = (*ptrs, b, n, int(k), int(bool(job_distinct)),
            int(bool(tg_distinct)), torch.cuda.current_stream(dev).cuda_stream)
    bufs = (idx, ok, score, placed, cache)

    def launch():
        with torch.cuda.device(dev):
            return fn(*args)

    launch.buffers = bufs  # keeps the scratch alive as long as the call
    return launch, (idx, ok, score)


def kernel_only(*inputs):
    """For timing the kernel apart from its wrapper: checks the inputs of
    ``solve_greedy_batched_shared`` once, allocates its buffers once, and
    returns a zero-argument call that only launches the kernel (no checks,
    no allocation, not counted in ``LAUNCHES``)."""
    check_inputs(*inputs[:13])
    if inputs[3].device.type != "cuda":
        raise ValueError("kernel_only needs CUDA tensors")
    launch, _outs = _bind_launch(*inputs)

    def run():
        kernels.check_launch(launch(), "greedy")

    return run


# -- the node-sharded exact scan --------------------------------------------
#
# The counterpart of nomad_tpu's solve_greedy / solve_greedy_batched under
# node-axis shardings (XLA SPMD, an argmax collective every step). A
# node's score depends on its own state alone, so the global scan,
# restricted to one shard's rows, picks them in the order the shard's own
# k-step scan does: each shard runs the kernel above on its rows for all k
# steps, the [S, B, k] sequences gather on the first shard's device, and
# one merge (csrc/greedy.cu merge_kernel, a small kernel rather than a
# host loop: the gathered sequences already sit on the card, and a host
# loop would copy them down and walk S x B x k heads in Python) picks the
# global order. One gather a solve in place of one collective a step. The
# merge stages each eval's sequences in shared memory (a window of each
# shard's where they do not all fit) and runs its steps from registers.

# Launches of the merge kernel (the plain merge never counts).
MERGE_LAUNCHES = 0

MAX_SHARDS = 512  # kMaxShards in csrc/greedy.cu


def merge_window(n_shards: int, k: int) -> int:
    """Entries of each shard's sequence the merge kernel stages at a time:
    k where every shard's fit the block's shared memory, else a window
    (csrc/greedy.cu merge_window decides)."""
    return kernels.entry("greedy", "nomad_greedy_merge_window", 0, 2,
                         stream=False)(n_shards, k)


def solve_greedy_sharded(shards, active, k: int, job_distinct: bool,
                         tg_distinct: bool):
    """The batched exact scan over node shards. ``shards[i]`` =
    ((total, sched_cap, bw_avail): shard i's shared node rows, ``[n_s,
    ...]``; (used0, job_count0, tg_count0, bw_used0, eligible): its
    per-eval rows, ``[B, n_s, ...]``; (ask [B, 4], bw_ask [B], penalty
    [B])), all on shard i's device, every shard n_s rows; ``active``
    [B, k] on the first shard's device. Returns (idx [B, k] int32 global
    node index, ok [B, k] bool, score [B, k] float32) there, equal to the
    unsharded scan's."""
    return _solve_sharded(shards, active, k, job_distinct, tg_distinct,
                          solve_greedy_batched_shared, merge_greedy)


def solve_greedy_sharded_plain(shards, active, k: int, job_distinct: bool,
                               tg_distinct: bool):
    """Plain version of solve_greedy_sharded: each shard's scan and the
    merge in plain PyTorch, on whatever device the shards are."""
    return _solve_sharded(
        shards, active, k, job_distinct, tg_distinct,
        solve_greedy_batched_shared_plain, merge_greedy_plain)


def _solve_sharded(shards, active, k, job_distinct, tg_distinct, scan,
                   merge):
    home = shards[0][0][0].device
    n_s = shards[0][0][0].shape[0]
    b = active.shape[0]
    idxs, scores = [], []
    for (total, sched_cap, bw_avail), per, (ask, bw_ask, penalty) in shards:
        used0, job_count0, tg_count0, bw_used0, eligible = per
        every = torch.ones((b, k), dtype=torch.bool, device=total.device)
        idx, _ok, score = scan(
            total, sched_cap, used0, job_count0, tg_count0, bw_avail,
            bw_used0, eligible, ask, bw_ask, every, penalty, k,
            job_distinct, tg_distinct)
        idxs.append(idx.to(home))
        scores.append(score.to(home))
    return merge(torch.stack(idxs), torch.stack(scores), active, n_s)


def merge_greedy_plain(idx, score, active, n_s: int):
    """Plain version of the merge: k steps, each an argmax over the S
    shards' next picks (torch.argmax takes the first maximum: the lower
    shard), vectorized over the evals."""
    s_count, b, k = score.shape
    dev = score.device
    sc = score.permute(1, 0, 2)
    ix = idx.permute(1, 0, 2)
    head = torch.zeros((b, s_count), dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    out_idx, out_ok, out_score = [], [], []
    for step in range(k):
        heads = sc.gather(2, head.unsqueeze(2))[:, :, 0]
        best_s = torch.argmax(heads, dim=1)
        best = heads[rows, best_s]
        live = best > NEG_INF
        ok = live & active[:, step]
        local = ix[rows, best_s, head[rows, best_s]]
        out_idx.append(torch.where(live, best_s.to(torch.int32) * n_s + local,
                                   torch.zeros_like(local)))
        out_ok.append(ok)
        out_score.append(torch.where(live, best,
                                     torch.full_like(best, NEG_INF)))
        head[rows, best_s] += ok.to(torch.int64)
    return (torch.stack(out_idx, 1), torch.stack(out_ok, 1),
            torch.stack(out_score, 1))


def _check_merge(idx, score, active):
    if idx.dim() != 3:
        raise ValueError(f"idx must be [S, B, k], got {tuple(idx.shape)}")
    s_count, b, k = idx.shape
    if not 1 <= s_count <= MAX_SHARDS:
        raise ValueError(f"{s_count} shards: the merge takes 1 to "
                         f"{MAX_SHARDS}")
    dev = idx.device
    _check("idx", idx, torch.int32, (s_count, b, k), dev)
    _check("score", score, torch.float32, (s_count, b, k), dev)
    _check("active", active, torch.bool, (b, k), dev)


def merge_greedy(idx, score, active, n_s: int):
    """Merge S shard-local scans (``idx``, ``score``: [S, B, k], shard i's
    rows [i n_s, (i+1) n_s)) into the global scan under ``active`` [B, k].
    CUDA tensors launch the merge kernel; CPU tensors take the plain
    version."""
    _check_merge(idx, score, active)
    if idx.device.type == "cpu":
        return merge_greedy_plain(idx, score, active, n_s)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    global MERGE_LAUNCHES
    launch, outs = _bind_merge(idx, score, active, n_s)
    kernels.check_launch(launch(), "greedy_merge")
    MERGE_LAUNCHES += 1
    return outs


def _bind_merge(idx, score, active, n_s: int):
    s_count, b, k = idx.shape
    dev = idx.device
    fn = kernels.entry("greedy", "nomad_greedy_merge", 6, 4)
    out_idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    out_ok = torch.empty((b, k), dtype=torch.bool, device=dev)
    out_score = torch.empty((b, k), dtype=torch.float32, device=dev)
    args = ([t.data_ptr() for t in (idx, score, active, out_idx, out_ok,
                                    out_score)]
            + [s_count, b, k, int(n_s),
               torch.cuda.current_stream(dev).cuda_stream])

    def launch():
        with torch.cuda.device(dev):
            return fn(*args)

    launch.buffers = (out_idx, out_ok, out_score)
    return launch, (out_idx, out_ok, out_score)


def merge_kernel_only(idx, score, active, n_s: int):
    """For timing the merge kernel apart from its wrapper: checks once,
    allocates once, and returns a zero-argument call that only launches
    it (not counted in ``MERGE_LAUNCHES``)."""
    _check_merge(idx, score, active)
    if idx.device.type != "cuda":
        raise ValueError("merge_kernel_only needs CUDA tensors")
    launch, _outs = _bind_merge(idx, score, active, n_s)

    def run():
        kernels.check_launch(launch(), "greedy_merge")

    return run
