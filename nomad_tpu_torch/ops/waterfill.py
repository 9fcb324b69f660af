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

import array
from typing import List, NamedTuple, Tuple

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


# -- the node-sharded water-fill --------------------------------------------
#
# The counterpart of nomad_tpu's solve_waterfill under node-axis shardings
# (XLA SPMD over a mesh). ``shard_route`` decides, from the shards' devices
# and rows and before any launch, how a solve runs (csrc/waterfill_shard.cu
# has the design):
#
# - every shard of the solve on one device, at most MAX_CLUSTER blocks an
#   eval: the whole solve in one launch (route 1, one cluster an eval);
# - else the per-pass protocol (route 2): the shards grouped by device (up
#   to GROUP_SHARDS consecutive shards a group), one launch a pass for each
#   group, which combines its shards' partials on its device, and between
#   passes the caller's ``reduce`` sums or maxes the groups' rows
#   (parallel/mesh.py MeshReduce, parallel/dcn.py DistReduce). The rounds
#   are the unsharded kernel's sync points: 1 (max cap) + the level passes
#   + 4 (threshold) + 1 (boundary prefix).
#
# CUDA shards launch the kernels; CPU shards take the plain passes
# (_PlainShard) over the same routes and groups.

# Launches of csrc/waterfill_shard.cu, both routes (the plain passes never
# count), and of them the single-launch route's.
SHARD_LAUNCHES = 0
SHARD_SOLVE_LAUNCHES = 0

PART_WIDTH = 512  # int64 columns of a partial: 256 bin counts, 256 sums
N_STATE = 16      # int64 slots of an eval's decision state
GROUP_SHARDS = 16  # most shards one launch binds (kGroupShards)
MAX_CLUSTER = 8    # the portable cluster limit (waterfill_cluster.cuh)
SMEM_ROWS = 16384  # rows a block keeps in shared memory (kSmemRows)
_PHASES = {"caps": 0, "level_first": 1, "level": 2, "keys": 3, "radix": 4,
           "boundary": 5, "counts": 6}
_RADIX_SHIFTS = (16, 8, 0)
# The word table of a binding (csrc/waterfill_shard.cu enum Word): 9
# pointers a shard for GROUP_SHARDS shards, then these.
_SHARD_PTRS = 9
_WORDS = ("ask", "bw_ask", "count", "penalty", "cap", "key", "state",
          "parts", "block_hist", "remaining", "stream", "batch", "rows",
          "group", "column", "n_shards", "job_distinct", "tg_distinct",
          "device")
_WORD = {name: GROUP_SHARDS * _SHARD_PTRS + i for i, name in enumerate(_WORDS)}
N_WORDS = GROUP_SHARDS * _SHARD_PTRS + len(_WORDS)


def level_shifts(max_count: int) -> list:
    """The shifts of the level passes for a batch whose largest count is
    ``max_count``: 8 bits a pass from the top, at least one pass."""
    bits = max(int(max_count), 0).bit_length()
    return list(range(8 * (max((bits + 7) // 8, 1) - 1), -1, -8))


def _passes(max_count: int) -> list:
    """(phase, shift, combine op) of each pass of a solve, in order; the
    counts pass is last and has no combine."""
    return ([("caps", 0, "max")]
            + [("level_first" if j == 0 else "level", s, "sum")
               for j, s in enumerate(level_shifts(max_count))]
            + [("keys", 0, "sum")]
            + [("radix", s, "sum") for s in _RADIX_SHIFTS]
            + [("boundary", 0, "sum"), ("counts", 0, None)])


def shard_rounds(max_count: int) -> int:
    """Combines between the passes of one sharded solve (route 2)."""
    return len(_passes(max_count)) - 1


def shard_blocks(n_s: int) -> int:
    """Blocks a shard of ``n_s`` rows is spread over: the next power of two
    of n_s / SMEM_ROWS, at least 1, at most MAX_CLUSTER (waterfill.cu's
    rule, cluster_size in csrc/waterfill_cluster.cuh)."""
    ncl = 1
    while ncl < MAX_CLUSTER and ncl * SMEM_ROWS < n_s:
        ncl *= 2
    return ncl


class ShardRoute(NamedTuple):
    """How a sharded solve runs: ``single`` (route 1: the whole solve in one
    launch) or not (route 2: the passes); ``groups``: (start, stop) of each
    group of consecutive shards on one device, one launch a pass each."""

    single: bool
    groups: List[Tuple[int, int]]


def shard_route(devices, n_s: int, whole: bool = True) -> ShardRoute:
    """The route of a solve over shards of ``n_s`` rows on ``devices`` (one
    a shard, in node order). ``whole``: these are every shard of the solve
    (false for one process's part of a DCN solve). One launch where every
    shard is on one device and the solve needs at most MAX_CLUSTER blocks
    an eval; else groups of consecutive shards on one device, at most
    GROUP_SHARDS each."""
    devices = [torch.device(d) for d in devices]
    groups, start = [], 0
    for i in range(1, len(devices) + 1):
        if (i == len(devices) or devices[i] != devices[start]
                or i - start == GROUP_SHARDS):
            groups.append((start, i))
            start = i
    single = (whole and len(groups) == 1
              and len(devices) * shard_blocks(n_s) <= MAX_CLUSTER)
    return ShardRoute(single, groups)


def solve_waterfill_sharded(shards, small, max_count: int,
                            job_distinct: bool, tg_distinct: bool, reduce,
                            first_index: int = 0, n_shards=None):
    """The batched water-fill over node shards. ``shards[i]``: the 8
    node-axis inputs of shard i (total, sched_cap, used0, job_count0,
    tg_count0, bw_avail, bw_used0, eligible; each ``[B, n_s, ...]`` on the
    shard's device; every shard holds n_s rows, shard i the global rows
    from ``(first_index + i) * n_s``); ``small[i]``: (ask [B, 4], bw_ask
    [B], count [B] int32, penalty [B] float32) on the same device, equal on
    every shard; ``max_count``: the largest count of the batch; ``reduce(
    parts, op)``: the seam, "sum" or "max" over every device group's
    partial in the solve (``n_shards`` shards in all, default
    ``len(shards)``). Returns (counts per shard, [B, n_s] int32 each,
    remaining [B] int32 on the first shard's device). The route follows
    from the devices and shapes (shard_route); CUDA shards launch the
    shard kernels, CPU shards take the plain passes."""
    return _solve_sharded(shards, small, max_count, job_distinct,
                          tg_distinct, reduce, first_index, n_shards, False)


def solve_waterfill_sharded_plain(shards, small, max_count: int,
                                  job_distinct: bool, tg_distinct: bool,
                                  reduce, first_index: int = 0,
                                  n_shards=None):
    """Plain version of solve_waterfill_sharded: the same routes, groups
    and seam, every pass plain PyTorch on whatever device the shards
    are."""
    return _solve_sharded(shards, small, max_count, job_distinct,
                          tg_distinct, reduce, first_index, n_shards, True)


def _local(parts, _op):
    """The seam of a solve that is one group: its partial is the
    combine."""
    return parts


def _solve_sharded(shards, small, max_count, job_distinct, tg_distinct,
                   reduce, first_index, n_shards, plain):
    n_shards = len(shards) if n_shards is None else n_shards
    route = shard_route([s[0].device for s in shards], shards[0][0].shape[1],
                        whole=first_index == 0 and n_shards == len(shards))
    kernel = not plain and shards[0][0].device.type == "cuda"
    if route.single and kernel:
        return _KernelSolve(shards, small[0], job_distinct,
                            tg_distinct).run()
    groups = [
        (_KernelGroup if kernel else _PlainShard)(
            shards[lo:hi], small[lo], first_index + lo, n_shards,
            job_distinct, tg_distinct)
        for lo, hi in route.groups
    ]
    seam = _local if route.single else reduce
    comb = [None] * len(groups)
    for phase, shift, op in _passes(max_count):
        parts = [g.run(phase, c, shift) for g, c in zip(groups, comb)]
        if op is not None:
            comb = seam(parts, op)
    return [c for g in groups for c in g.counts], groups[0].remaining


_NODE_INPUTS = ("total", "sched_cap", "used0", "job_count0", "tg_count0",
                "bw_avail", "bw_used0", "eligible")


def _check_shards(shards, small4):
    """The first shard's inputs and the small ones as check_inputs takes
    them; every other shard's like the first's (dtype, shape, device,
    contiguous)."""
    check_inputs(*shards[0], *small4)
    for q, inputs8 in enumerate(shards[1:], 1):
        for name, t, ref in zip(_NODE_INPUTS, inputs8, shards[0]):
            if not (t.dtype == ref.dtype and t.shape == ref.shape
                    and t.device == ref.device and t.is_contiguous()):
                raise ValueError(
                    f"shard {q}'s {name} is a {t.dtype} {tuple(t.shape)} on "
                    f"{t.device} (contiguous: {t.is_contiguous()}); every "
                    f"shard's must be shard 0's {ref.dtype} "
                    f"{tuple(ref.shape)} on {ref.device}, contiguous")


def _check_word_table():
    """csrc/waterfill_shard.cu reads as many words as this module
    writes."""
    got = kernels.entry("waterfill_shard", "nomad_waterfill_shard_words",
                        0, 0, stream=False)()
    if got != N_WORDS:
        raise RuntimeError(f"csrc/waterfill_shard.cu reads {got} words of a "
                           f"binding, ops/waterfill.py writes {N_WORDS}")


class _Binding:
    """The shards of one device bound once a solve for
    csrc/waterfill_shard.cu: inputs checked, outputs and scratch
    allocated, and every pointer in one int64 word table, so a launch is
    one ctypes call of integers."""

    def __init__(self, shards, small4, column, n_shards, jd, td, scratch,
                 pass_buffers):
        if len(shards) > GROUP_SHARDS:
            raise ValueError(f"{len(shards)} shards: one launch binds at "
                             f"most {GROUP_SHARDS}")
        _check_shards(shards, small4)
        b, n_s, _ = shards[0][0].shape
        dev = shards[0][0].device
        s = len(shards)
        i32, i64 = torch.int32, torch.int64
        # One [S, B, n_s] tensor: counts[q] is shard q's, contiguous.
        self.counts = list(torch.empty((s, b, n_s), dtype=i32,
                                       device=dev).unbind(0))
        self.remaining = torch.empty((b,), dtype=i32, device=dev)
        self.cap = (torch.empty((b, s, n_s), dtype=i32, device=dev)
                    if scratch else None)
        self.key = (torch.empty((b, s, n_s), dtype=i32, device=dev)
                    if scratch else None)
        self.state = self.parts = self.block_hist = None
        if pass_buffers:
            g = s * shard_blocks(n_s)
            self.state = torch.empty((2, b, N_STATE), dtype=i64, device=dev)
            self.parts = torch.zeros((3, b, PART_WIDTH), dtype=i64,
                                     device=dev)
            self.block_hist = torch.empty((b, g, 256), dtype=i32, device=dev)
        words = [0] * N_WORDS
        for q, inputs8 in enumerate(shards):
            total, sched_cap, used0, jc, tc, bwa, bwu, elig = inputs8
            ptrs = [t.data_ptr() for t in (total, used0, sched_cap, jc, tc,
                                           bwa, bwu, elig, self.counts[q])]
            if ptrs[0] % 16 or ptrs[1] % 16 or ptrs[2] % 8:
                raise ValueError(f"shard {q}'s total and used0 must be "
                                 "16-byte aligned, sched_cap 8-byte")
            words[_SHARD_PTRS * q:_SHARD_PTRS * (q + 1)] = ptrs
        ptr = lambda t: 0 if t is None else t.data_ptr()
        values = dict(zip(("ask", "bw_ask", "count", "penalty"),
                          map(ptr, small4)))
        values.update(
            cap=ptr(self.cap), key=ptr(self.key), state=ptr(self.state),
            parts=ptr(self.parts), block_hist=ptr(self.block_hist),
            remaining=ptr(self.remaining),
            stream=torch.cuda.current_stream(dev).cuda_stream, batch=b,
            rows=n_s, group=s, column=column, n_shards=n_shards,
            job_distinct=int(bool(jd)), tg_distinct=int(bool(td)),
            device=dev.index if dev.index is not None
            else torch.cuda.current_device())
        for name, v in values.items():
            words[_WORD[name]] = v
        _check_word_table()
        self.words = array.array("q", words)
        self.addr = self.words.buffer_info()[0]
        self.inputs = (shards, small4)  # alive as long as the binding


class _KernelSolve(_Binding):
    """Route 1: a solve whose every shard is on this device, one launch of
    csrc/waterfill_shard.cu's solve_kernel."""

    def __init__(self, shards, small4, jd, td, counted=True):
        n_s = shards[0][0].shape[1]
        blocks = shard_blocks(n_s)
        super().__init__(shards, small4, 0, len(shards), jd, td,
                         -(-n_s // blocks) > SMEM_ROWS, False)
        self.counted = counted
        self.fn = kernels.entry("waterfill_shard",
                                "nomad_waterfill_shard_solve", 1, 0,
                                stream=False)

    def launch(self):
        global SHARD_LAUNCHES, SHARD_SOLVE_LAUNCHES
        kernels.check_launch(self.fn(self.addr), "waterfill_shard")
        if self.counted:
            SHARD_LAUNCHES += 1
            SHARD_SOLVE_LAUNCHES += 1

    def run(self):
        self.launch()
        return self.counts, self.remaining


class _KernelGroup(_Binding):
    """Route 2: one device's group of shards, one launch of
    csrc/waterfill_shard.cu's pass_kernel a pass, which leaves the group's
    combined partial in one of three rotating buffers."""

    def __init__(self, shards, small4, column, n_shards, jd, td,
                 counted=True):
        super().__init__(shards, small4, column, n_shards, jd, td, True,
                         True)
        self.counted = counted
        self.turn = 0
        self.fn = kernels.entry("waterfill_shard",
                                "nomad_waterfill_shard_pass", 2, 3,
                                stream=False)

    def run(self, phase: str, comb, shift: int):
        """Launch one pass; returns its partial (None for the counts
        pass)."""
        global SHARD_LAUNCHES
        err = self.fn(self.addr, None if comb is None else comb.data_ptr(),
                      _PHASES[phase], shift, self.turn)
        kernels.check_launch(err, "waterfill_shard")
        if self.counted:
            SHARD_LAUNCHES += 1
        part = self.parts[self.turn % 3]
        self.turn += 1
        return None if phase == "counts" else part


def shard_kernel_only(inputs8, small4, max_count: int, job_distinct: bool,
                      tg_distinct: bool):
    """For timing the pass kernel apart from its wrapper and the seam:
    binds one shard once, and returns a zero-argument call that launches
    every pass of a solve over that shard alone (one shard of one, so
    each combine is the shard's own partial and no other operation runs;
    not counted in ``SHARD_LAUNCHES``)."""
    if inputs8[0].device.type != "cuda":
        raise ValueError("shard_kernel_only needs CUDA tensors")
    group = _KernelGroup([inputs8], small4, 0, 1, job_distinct, tg_distinct,
                         counted=False)
    passes = _passes(max_count)

    def run():
        comb = None
        for phase, shift, _op in passes:
            comb = group.run(phase, comb, shift)

    return run


def shard_solve_only(shards, small4, job_distinct: bool, tg_distinct: bool):
    """For timing the single-launch route apart from its wrapper: binds
    the shards once and returns a zero-argument call that launches the
    solve (not counted)."""
    if shards[0][0].device.type != "cuda":
        raise ValueError("shard_solve_only needs CUDA tensors")
    solve = _KernelSolve(shards, small4, job_distinct, tg_distinct,
                         counted=False)
    return solve.launch


class _PlainShard:
    """One device group's passes in plain PyTorch: the same partials,
    decisions and state as the kernels', over the group's shards side by
    side ([B, S n_s] tensors, in node order)."""

    def __init__(self, shards, small4, column, n_shards, jd, td):
        _check_shards(shards, small4)
        self.n_s = shards[0][0].shape[1]
        cols = [torch.cat(col, 1) if len(shards) > 1 else col[0]
                for col in zip(*shards)]
        (self.total, self.sched_cap, self.used0, self.job_count0,
         self.tg_count0, self.bw_avail, self.bw_used0, self.eligible) = cols
        self.ask, self.bw_ask, count, self.penalty = small4
        self.count = count.to(torch.int64)
        self.jd, self.td = bool(jd), bool(td)
        self.index, self.n_shards = column, n_shards
        b = self.total.shape[0]
        z = torch.zeros(b, dtype=torch.int64, device=self.total.device)
        self.st = {k: z.clone() for k in (
            "hcap", "prefix", "sum_below", "n_above", "base_sum", "level",
            "remaining", "k_above", "tprefix", "done", "tie", "t_eff",
            "fill", "nsel", "dstar")}
        self.cap = None
        self.key = None
        self.last_part = None
        self.counts = None
        self.remaining = None

    def run(self, phase: str, comb, shift: int):
        part = getattr(self, "_" + phase)(comb, shift)
        self.last_part = part
        return part

    def _new_part(self):
        return torch.zeros((self.total.shape[0], PART_WIDTH),
                           dtype=torch.int64, device=self.total.device)

    def _hist(self, bins, mask, values=None):
        """[B, 512] partial: per-eval counts (and sums of ``values``) of
        the rows in ``mask`` by ``bins``."""
        part = self._new_part()
        bins = torch.where(mask, bins, torch.zeros_like(bins))
        part[:, :256].scatter_add_(1, bins, mask.to(torch.int64))
        if values is not None:
            part[:, 256:].scatter_add_(
                1, bins, torch.where(mask, values, torch.zeros_like(values)))
        return part

    def _caps(self, _comb, _shift):
        ask = self.ask.unsqueeze(1)
        avail = self.total - self.used0
        nonneg = (torch.all(avail >= 0, dim=-1)
                  & (self.bw_used0 <= self.bw_avail))
        dim_cap = torch.where(
            ask > 0, torch.div(avail, torch.clamp(ask, min=1),
                               rounding_mode="floor"),
            torch.full_like(avail, _BIG))
        cap = dim_cap.min(dim=-1).values
        bw_ask = self.bw_ask.unsqueeze(1)
        bw_cap = torch.div(self.bw_avail - self.bw_used0,
                           torch.clamp(bw_ask, min=1), rounding_mode="floor")
        cap = torch.where(bw_ask > 0, torch.minimum(cap, bw_cap), cap)
        if self.jd:
            cap = torch.minimum(cap, (self.job_count0 == 0).to(cap.dtype))
        if self.td:
            cap = torch.minimum(cap, (self.tg_count0 == 0).to(cap.dtype))
        cap = torch.minimum(torch.clamp(cap.to(torch.int64), min=0),
                            self.count.unsqueeze(1))
        self.cap = torch.where(self.eligible & nonneg, cap,
                               torch.zeros_like(cap))
        part = self._new_part()
        if self.cap.shape[1]:
            part[:, 0] = self.cap.max(dim=1).values
        return part

    def _decide_level(self, comb, s):
        st = self.st
        cnt, sm = comb[:, :256], comb[:, 256:]
        below_c = torch.cumsum(cnt, 1) - cnt
        below_s = torch.cumsum(sm, 1) - sm
        tot = cnt.sum(1, keepdim=True)
        d = torch.arange(256, dtype=torch.int64, device=comb.device)
        lv = st["prefix"][:, None] + (d << s)
        ge = st["n_above"][:, None] + tot - below_c
        f = st["sum_below"][:, None] + below_s + lv * ge
        valid = (lv <= st["hcap"][:, None]) & (f <= self.count[:, None])
        at = torch.where(valid, d, -1).amax(1, keepdim=True)
        st["prefix"] = lv.gather(1, at)[:, 0]
        st["base_sum"] = f.gather(1, at)[:, 0]
        st["sum_below"] = st["sum_below"] + below_s.gather(1, at)[:, 0]
        st["n_above"] = (ge - cnt).gather(1, at)[:, 0]

    def _level_first(self, comb, shift):
        st = self.st
        st["hcap"] = torch.minimum(self.count, comb[:, 0])
        for k in ("prefix", "sum_below", "n_above", "base_sum"):
            st[k] = torch.zeros_like(st[k])
        return self._level_hist(shift)

    def _level(self, comb, shift):
        self._decide_level(comb, shift + 8)
        return self._level_hist(shift)

    def _level_hist(self, s):
        prefix = self.st["prefix"][:, None]
        d = (self.cap - prefix) >> s
        mask = (self.cap >= prefix) & (d < 256)
        return self._hist(d, mask, self.cap)

    def _keys(self, comb, _shift):
        st = self.st
        self._decide_level(comb, 0)
        st["level"] = st["prefix"].clone()
        st["remaining"] = self.count - st["base_sum"]
        for k in ("k_above", "tprefix", "tie", "t_eff", "fill", "nsel",
                  "dstar"):
            st[k] = torch.zeros_like(st[k])
        st["done"] = (st["remaining"] <= 0).to(torch.int64)
        level = st["level"][:, None]
        base = torch.minimum(self.cap, level).to(torch.int32)
        bw_ask = self.bw_ask[:, None]
        score, fit = _greedy_step_state(
            self.total, self.sched_cap,
            self.used0 + base.unsqueeze(-1) * self.ask.unsqueeze(1),
            self.job_count0 + base, self.tg_count0 + base, self.bw_avail,
            self.bw_used0 + base * bw_ask, self.eligible, self.ask, bw_ask,
            self.penalty[:, None], self.jd, self.td,
        )
        cand = fit & (self.cap > level) & (st["remaining"] > 0)[:, None]
        self.key = torch.where(cand, _monotone_u32(score),
                               torch.zeros_like(score, dtype=torch.int64))
        return self._hist(self.key >> 24, cand)

    def _decide_radix(self, comb, s):
        """The radix step for the evals whose threshold is open; returns
        (open evals, keys at the chosen bin, the bin)."""
        st = self.st
        cnt = comb[:, :256]
        tot = cnt.sum(1)
        open_ = st["done"] == 0
        rem = st["remaining"]
        if s == 24:
            take_all = open_ & (rem >= tot)
            st["done"] = torch.where(take_all, 1, st["done"])
            st["nsel"] = torch.where(take_all, tot, st["nsel"])
            open_ = open_ & ~take_all
        d = torch.arange(256, dtype=torch.int64, device=comb.device)
        gt = st["k_above"][:, None] + tot[:, None] - torch.cumsum(cnt, 1)
        hit = (gt < rem[:, None]) & (rem[:, None] <= gt + cnt)
        dstar = torch.where(hit, d, -1).amax(1).clamp(min=0)
        at = dstar[:, None]
        st["k_above"] = torch.where(open_, gt.gather(1, at)[:, 0],
                                    st["k_above"])
        tp = st["tprefix"] | (dstar << s)
        return open_, cnt.gather(1, at)[:, 0], dstar, tp

    def _radix(self, comb, shift):
        st = self.st
        open_, _n_at, _dstar, tp = self._decide_radix(comb, shift + 8)
        st["tprefix"] = torch.where(open_, tp, st["tprefix"])
        hi = shift + 8
        mask = ((self.key != 0)
                & ((self.key >> hi) == (st["tprefix"] >> hi)[:, None])
                & (st["done"] == 0)[:, None])
        return self._hist((self.key >> shift) & 0xFF, mask)

    def _boundary(self, comb, _shift):
        st = self.st
        open_, n_at, dstar, tp = self._decide_radix(comb, 0)
        f = st["remaining"] - st["k_above"]
        tie = open_ & (f < n_at)
        st["tie"] = torch.where(open_, tie.to(torch.int64), st["tie"])
        st["t_eff"] = torch.where(open_, torch.where(tie, tp, tp - 1),
                                  st["t_eff"])
        st["fill"] = torch.where(open_, f, st["fill"])
        st["nsel"] = torch.where(open_, st["remaining"], st["nsel"])
        st["dstar"] = torch.where(open_, dstar, st["dstar"])
        st["done"] = torch.where(open_, 1, st["done"])
        own = self.last_part.gather(1, st["dstar"][:, None])[:, 0]
        part = self._new_part()
        part[:, self.index] = torch.where(st["tie"] != 0, own, 0)
        return part

    def _counts(self, comb, _shift):
        st = self.st
        block_off = comb[:, :self.index].sum(1)
        rem = st["remaining"][:, None]
        key = self.key
        at = (st["tie"] != 0)[:, None] & (key == st["t_eff"][:, None])
        rank = block_off[:, None] + torch.cumsum(at.to(torch.int64), 1) - 1
        sel = (rem > 0) & ((key > st["t_eff"][:, None])
                           | (at & (rank < st["fill"][:, None])))
        level = st["level"][:, None]
        counts = (torch.minimum(self.cap, level)
                  + sel.to(torch.int64)).to(torch.int32)
        self.counts = list(counts.split(self.n_s, 1))
        self.remaining = (st["remaining"] - st["nsel"]).to(torch.int32)
        return None
