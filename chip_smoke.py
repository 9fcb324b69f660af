#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nomad_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. build: compile every kernel under nomad_tpu_torch/csrc with nvcc for
   sm_90a; print the build seconds, ptxas' register report and the card.
2. kernels vs plain: each kernel's wrapper against its plain PyTorch
   version on the same CUDA tensors, at the main path's shapes, the
   buckets up to 262144 rows and the edge cases of each design (see
   WF_SHAPES, GREEDY_SHAPES); outputs must be exactly equal. Prints
   kernel ms (CUDA events around a CUDA graph of back-to-back launches of
   the kernel alone, pre-checked and pre-allocated; cross-checked against
   torch.profiler's device time), the full wrapper's ms, and plain ms.
   ptxas must report no spill.
3. headline: 10,000 nodes (dc1/dc2, 4000 MHz / 8192 MB, kernel.name=linux,
   driver exec) and one batch job of 100,000 tasks restricted to dc1,
   through new_scheduler("tpu-batch", ..., device="cuda"): 1 warm-up and 5
   timed evals. Every task placed, only on dc1 nodes, capacity held.
4. service: a tpu-service job of count 100 over both datacenters (the
   object path and the exact greedy scan): 1 warm-up and 5 timed evals,
   with e2e p50 and the solver's stage p50s.
5. burst: 8 batch evals of 12,500 tasks from 8 threads through the
   coalescer.
6. server: the same 10,000 nodes through the port's Server
   (nomad_tpu_torch.server: eval broker, worker, plan queue, plan
   pipeline, FSM) on the card, by node_batch_register. The headline job
   and the service job, each 1 warm-up and 5 timed rounds of register ->
   complete -> deregister -> complete, and, on a fresh server once its
   start-time warm is done, an 8-eval burst drained by one worker
   (eval_batch_size=8) as one width-8 dispatch. Each round checks the
   COMMITTED allocs in the server's state store (count, datacenter,
   constraint, and every node's summed asks within its capacity, in
   numpy) and that every eval ended complete. Logs register->complete and
   deregister->complete p50 and placements/s, and the p50 of each span
   stage from the tracer.
7. cluster: a three-member ClusterServer cell (raft over loopback RPC,
   workers on every member, one card). The 10,000 nodes through a
   follower (forwarded, then replicated); the headline and the service
   job, each 1 warm-up and 3 timed rounds of register (through a
   follower) -> complete -> deregister -> complete, with the time until
   every member has applied each and check_committed on every member's
   store; then 8 batch jobs of 12,500 tasks through the leader, the
   leader shut down at a seeded point of their flight, and every eval
   complete on the survivors with exactly 12,500 live tasks per job on
   dc1 and no node over capacity, on both survivors' stores.

Each path's launch counts are set to 0 just before it runs and read just
after; a kernel of the path that was never launched fails the run. The
line before the last is one JSON object with every kernel's numbers, the
last {"ok": true, "device": {...}}. Any failure raises: the exit code is
then non-zero and no result is printed. Needs one CUDA card; imports
nothing of jax or nomad_tpu.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_NODES = 10_000
N_TASKS = 100_000
BURST_EVALS = 8
BURST_TASKS = 12_500
SERVICE_COUNT = 100
TIMED_EVALS = 5
SEED = 42

# Kernel-vs-plain shapes. The headline eval restricts its job to dc1, so
# its mirror holds 5,000 nodes in the 8192-row bucket; the service job
# spans both datacenters (16384 rows, count bucket 128).
# Water-fill rows are (N, B, job_distinct, tg_distinct, node data):
# "random" draws nodes, usage and count; "headline" is the headline eval's
# 5,000 empty nodes and 100,000 tasks (remaining 0 after the level);
# "ties" repeats the headline node with 2.5 tasks a node (the burst's
# 12,500 on 5,000 at N=8192; above it every row is live and 5,001 more
# tasks cut the boundary inside a block of cluster rank > 0, so the fill
# crosses iterations, warps, blocks and ranks); "saturated" asks more than
# every cap together (no candidates); "count0" asks nothing; "ineligible"
# has no eligible node; "bigcaps" gives caps above 2^16 (3 or 4 level
# passes).
# The kernel holds an eval's rows in one block up to 16384, in a cluster
# of 2-8 blocks up to 131072, and in a device scratch above.
WF_SHAPES = [(8192, 1, False, False, "random"),
             (8192, 8, False, False, "random"),
             (8192, 1, False, False, "headline"),
             (8192, 8, False, False, "ties"),
             (16384, 1, False, False, "random"),
             (16384, 8, False, False, "random"),
             (16384, 8, True, False, "random"),
             (16384, 8, False, True, "random"),
             (32768, 2, False, False, "random"),
             (32768, 1, False, False, "ties"),
             (131072, 1, False, False, "random"),
             (131072, 8, True, True, "random"),
             (131072, 1, False, False, "ties"),
             (8192, 2, False, False, "saturated"),
             (8192, 2, False, False, "count0"),
             (8192, 2, False, False, "ineligible"),
             (8192, 2, False, False, "bigcaps"),
             (64, 1, False, False, "random"),
             (262144, 1, False, False, "random")]
# Greedy rows are (N, B, k, job_distinct, tg_distinct, node data): the
# score cache sits in shared memory up to 16384 rows and in a device
# scratch above; "ties" is the headline's identical nodes with identical
# usage (the lowest index decides every step), "infeasible" an eval no node
# fits, and N = 64 has fewer nodes than the kernel's 1024 slots.
GREEDY_SHAPES = [(16384, 1, 8, False, False, "random"),
                 (16384, 1, 128, False, False, "random"),
                 (16384, 8, 128, False, False, "random"),
                 (8192, 1, 128, False, False, "random"),
                 (16384, 8, 128, True, False, "random"),
                 (16384, 8, 128, False, True, "random"),
                 (131072, 1, 128, False, False, "random"),
                 (131072, 8, 128, False, False, "random"),
                 (16384, 2, 128, False, False, "ties"),
                 (16384, 1, 128, False, False, "infeasible"),
                 (64, 1, 8, False, False, "random")]
MAIN_WF_SHAPE = (8192, 1, False, False, "headline")
MAIN_GREEDY_SHAPE = (16384, 1, 128, False, False, "random")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(bind, reps: int) -> float:
    """Mean ms a launch of a kernel alone: CUDA events around one replay of
    a CUDA graph that holds ``reps`` back-to-back launches. ``bind()``
    returns a zero-argument launch bound to the current stream (a
    ``kernel_only``); a graph keeps the host's launch rate out of the
    time, which events around launches from Python do not for kernels
    under about 0.02 ms."""
    import torch

    run = bind()
    run()  # first launch: one-time set-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run = bind()
        for _ in range(reps):
            run()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiler_ms(fn, reps: int, kernel: str):
    """Mean device time of the CUDA kernel named ``kernel`` over ``reps``
    calls of ``fn``, from torch.profiler's CUPTI trace; None where the
    trace holds no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            total_us += us
            count += ev.count
    if count == 0 or total_us <= 0:
        return None
    return total_us / count / 1000.0


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def host_ms(fn, reps: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / reps


# -- random solve instances (numpy-seeded, then moved to the card) ---------


def node_arrays(rng, n: int, live: int):
    total = np.zeros((n, 4), dtype=np.int32)
    total[:live, 0] = rng.integers(2000, 16001, live)
    total[:live, 1] = rng.integers(4096, 65537, live)
    total[:live, 2] = rng.integers(50_000, 200_001, live)
    total[:live, 3] = rng.integers(100, 301, live)
    reserved = (total * rng.uniform(0.0, 0.05, (n, 1))).astype(np.int32)
    sched = (total - reserved)[:, :2].astype(np.float32)
    bw_avail = np.zeros(n, dtype=np.int32)
    bw_avail[:live] = rng.choice([0, 1000, 10_000], live)
    return total, sched, bw_avail


def eval_arrays(rng, total, bw_avail, live: int):
    n = total.shape[0]
    used = (total * rng.uniform(0.0, 0.9, (n, 1))).astype(np.int32)
    used[rng.random(n) < 0.01] += 100_000  # a few over-committed rows
    job_count = rng.integers(0, 3, n).astype(np.int32)
    tg_count = np.minimum(job_count, rng.integers(0, 2, n)).astype(np.int32)
    bw_used = (bw_avail * rng.uniform(0.0, 0.8, n)).astype(np.int32)
    eligible = np.zeros(n, dtype=bool)
    eligible[:live] = rng.random(live) < 0.9
    ask = np.array([rng.integers(50, 500), rng.integers(64, 1024),
                    rng.integers(0, 300), rng.integers(0, 2)],
                   dtype=np.int32)
    bw_ask = np.int32(rng.choice([0, 0, 10]))
    return used, job_count, tg_count, bw_used, eligible, ask, bw_ask


def headline_arrays(n: int, live: int):
    """The headline's node (4000 MHz, 8192 MB, 100 GiB disk, 150 iops, no
    network), empty, in the first ``live`` of n rows (the rest are
    padding), and its 100 MHz / 128 MB ask."""
    total = np.zeros((n, 4), dtype=np.int32)
    total[:live] = [4000, 8192, 100 * 1024, 150]
    zeros = np.zeros(n, dtype=np.int32)
    eligible = np.arange(n) < live
    return (total, total[:, :2].astype(np.float32), np.zeros((n, 4), np.int32),
            zeros, zeros, zeros, zeros, eligible,
            np.array([100, 128, 0, 0], np.int32), np.int32(0))


def waterfill_case(rng, n: int, b: int, jd: bool, td: bool, mode: str, dev):
    """B evals (see WF_SHAPES for the modes), each with its own node
    rows, as the coalescer stacks them."""
    import torch

    live = min(n, int(n * 0.61) + 1)
    cols = [[] for _ in range(12)]
    for _ in range(b):
        if mode in ("headline", "ties"):
            nodes = min(n, 5000) if (mode == "headline" or n <= 8192) else n
            row = headline_arrays(n, nodes)
            count = (N_TASKS if mode == "headline" else nodes * 5 // 2
                     + (5001 if n > 8192 else 0))
            penalty = 10.0
        else:
            total, sched, bw_avail = node_arrays(rng, n, live)
            used, jc, tc, bwu, elig, ask, bw_ask = eval_arrays(
                rng, total, bw_avail, live)
            count = int(rng.integers(1, 4 * live))
            if mode == "bigcaps":
                total[:live, :2] = rng.integers(1 << 17, 1 << 24, (live, 2))
                sched = total[:, :2].astype(np.float32)
                used = (total * rng.uniform(0.0, 0.5, (n, 1))).astype(np.int32)
                ask = np.array([1, 1, 0, 0], np.int32)
                bw_ask = np.int32(0)
                count = 1 << 30
            elif mode == "saturated":
                count = 2_000_000_000
            elif mode == "count0":
                count = 0
            elif mode == "ineligible":
                elig = np.zeros(n, dtype=bool)
            row = (total, sched, used, jc, tc, bw_avail, bwu, elig, ask,
                   bw_ask)
            penalty = float(rng.choice([10.0, 5.0, 0.0]))
        for i, v in enumerate((*row, count, penalty)):
            cols[i].append(v)
    dt = [torch.int32, torch.float32, torch.int32, torch.int32, torch.int32,
          torch.int32, torch.int32, torch.bool, torch.int32, torch.int32,
          torch.int32, torch.float32]
    args = [torch.tensor(np.stack(c), dtype=t, device=dev)
            for c, t in zip(cols, dt)]
    return (*args, jd, td)


def check_wf_mode(mode: str, counts, left, count, block_rows: int) -> None:
    """The row reached the case its mode names. ``block_rows``: the rows
    one block of the kernel holds."""
    placed = counts.sum(dim=1)
    if mode == "ties" and block_rows < counts.shape[1]:
        # Every row is live and identical: the first `fill` rows take one
        # copy more than the rest, and that cut must fall inside a block
        # of cluster rank > 0.
        for c in counts:
            top = int(c.max())
            cut = int((c == top).sum())
            if not (top > int(c.min()) and bool((c[:cut] == top).all())
                    and cut > block_rows and cut % block_rows):
                raise AssertionError("water-fill row 'ties' did not cut "
                                     "the boundary inside a block of rank "
                                     "> 0")
    want = {"headline": bool((left == 0).all()),
            "ties": bool((left == 0).all()),
            "saturated": bool((left > 0).all() and (placed > 0).all()),
            "count0": bool((placed == 0).all() and (left == 0).all()),
            "ineligible": bool((placed == 0).all() and (left == count).all()),
            "bigcaps": bool((counts.max() > 1 << 16).item()
                            and (left == 0).all())}
    if not want.get(mode, True):
        raise AssertionError(f"water-fill row {mode!r} missed its case")


def tie_arrays(n: int):
    """headline_arrays with every one of the n nodes live and a quarter
    used, in the order greedy_case takes them."""
    total, sched, used, jc, tc, bw_avail, bw_used, elig, ask, bw_ask = (
        headline_arrays(n, n))
    used[:] = [1000, 2048, 0, 0]
    return total, sched, bw_avail, used, jc, tc, bw_used, elig, ask, bw_ask


def greedy_case(rng, n: int, b: int, k: int, dev, jd: bool = False,
                td: bool = False, mode: str = "random"):
    """B evals over one shared node set. ``mode`` "random" draws nodes and
    usage; "ties" repeats one node (penalties 0 and 10 alternate, so a
    node is both chosen again and passed over); "infeasible" is random with
    no node eligible."""
    import torch

    if mode == "ties":
        total, sched, bw_avail, *one = tie_arrays(n)
        per = [one] * b
        penalty = np.resize([0.0, 10.0], b)
    else:
        live = min(n, int(n * 0.61) + 1)
        total, sched, bw_avail = node_arrays(rng, n, live)
        per = [list(eval_arrays(rng, total, bw_avail, live))
               for _ in range(b)]
        if mode == "infeasible":
            for p in per:
                p[4] = np.zeros(n, dtype=bool)
        penalty = rng.choice([10.0, 5.0], b)
    t = lambda a, dtype: torch.tensor(np.stack(a), dtype=dtype, device=dev)
    counts = rng.integers(1, k + 1, b)
    counts[0] = k
    active = np.arange(k)[None, :] < counts[:, None]
    return (
        torch.tensor(total, device=dev), torch.tensor(sched, device=dev),
        t([p[0] for p in per], torch.int32), t([p[1] for p in per], torch.int32),
        t([p[2] for p in per], torch.int32), torch.tensor(bw_avail, device=dev),
        t([p[3] for p in per], torch.int32), t([p[4] for p in per], torch.bool),
        t([p[5] for p in per], torch.int32), t([p[6] for p in per], torch.int32),
        torch.tensor(active, device=dev),
        torch.tensor(penalty, dtype=torch.float32, device=dev),
        k, jd, td,
    )


def bytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "numel"))


def bound_ms(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Per-node float32 operations of one BestFit score (2 div, 2 sub, 2 pow,
# 2 max, add, sub, 2 clamp, mul, sub). The greedy scan needs N + k scores
# an eval: every node once, then the placed node once a step.
SCORE_OPS = 15


def waterfill_work(total, sched_cap, used, job_count, tg_count, bw_avail,
                   bw_used, eligible, ask, bw_ask, count, penalty, jd, td):
    """(bytes, score operations) the water-fill must spend on these
    inputs, from the plain version's caps and level (numpy): each row's
    eligible flag (1 B); an eligible row's totals, usage and bandwidth (40
    B), and its job or group count where a distinct flag reads it; a
    candidate's (cap > level, with tasks left after the base) schedulable
    capacity and job count, and one score; each eval's ask, bandwidth ask,
    count and penalty; the counts and remaining written once."""
    np_ = lambda t: t.cpu().numpy().astype(np.int64)
    total, used, jc, tc, bwa, bwu, ask, bwk, cnt = map(
        np_, (total, used, job_count, tg_count, bw_avail, bw_used, ask,
              bw_ask, count))
    elig = eligible.cpu().numpy()
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


def phase_kernels(dev, rng):
    import torch
    from nomad_tpu_torch.ops import greedy, waterfill

    results = {"waterfill": {}, "greedy": {}}
    worst = 0
    for row in WF_SHAPES:
        n, b, jd, td, mode = row
        args = waterfill_case(rng, n, b, jd, td, mode, dev)
        counts_k, rem_k = waterfill.solve_waterfill_batched(*args)
        counts_p, rem_p = waterfill.solve_waterfill_batched_plain(*args)
        torch.cuda.synchronize()
        err = max(int((counts_k - counts_p).abs().max()),
                  int((rem_k - rem_p).abs().max()))
        worst = max(worst, err)
        if not (torch.equal(counts_k, counts_p) and torch.equal(rem_k, rem_p)):
            raise AssertionError(
                f"waterfill kernel != plain at {row}: max abs err {err}")
        check_wf_mode(mode, counts_k, rem_k, args[10],
                      waterfill.block_rows(n))
        k_ms = graph_ms(lambda: waterfill.kernel_only(*args), 20)
        prof_ms = profiler_ms(waterfill.kernel_only(*args), 20,
                              "waterfill_kernel")
        w_ms = cuda_ms(lambda: waterfill.solve_waterfill_batched(*args), 20)
        p_ms = host_ms(lambda: waterfill.solve_waterfill_batched_plain(*args),
                       1)
        bms, by = bound_ms(*waterfill_work(*args))
        placed = int(counts_k.sum())
        log(f"waterfill N={n} B={b} jd={jd} td={td} {mode}: equal, "
            f"placed={placed} unplaced={int(rem_k.sum())} "
            f"kernel_ms={k_ms:.4f} profiler_kernel_ms={fmt_ms(prof_ms)} "
            f"wrapper_ms={w_ms:.4f} plain_ms={p_ms:.2f} "
            f"bound_ms={bms:.6f} ({by})")
        results["waterfill"][row] = dict(
            ms=k_ms, profiler_ms=prof_ms, wrapper_ms=w_ms, plain_ms=p_ms,
            bound_ms=bms, bound_by=by)
    results["waterfill_err"] = worst

    worst = 0
    for row in GREEDY_SHAPES:
        n, b, k, jd, td, mode = row
        args = greedy_case(rng, n, b, k, dev, jd, td, mode)
        out_k = greedy.solve_greedy_batched_shared(*args)
        out_p = greedy.solve_greedy_batched_shared_plain(*args)
        torch.cuda.synchronize()
        err = max(int((out_k[0] - out_p[0]).abs().max()),
                  int((out_k[1] != out_p[1]).sum()))
        worst = max(worst, err)
        if not all(torch.equal(x, y) for x, y in zip(out_k, out_p)):
            raise AssertionError(
                f"greedy kernel != plain at {row}: idx max abs err {err}")
        if mode == "infeasible" and (bool(out_k[1].any())
                                     or bool(out_k[0].any())):
            raise AssertionError("an all-infeasible eval must give idx 0 "
                                 "and ok false at every step")
        k_ms = graph_ms(lambda: greedy.kernel_only(*args), 10)
        prof_ms = profiler_ms(greedy.kernel_only(*args), 10, "greedy_kernel")
        w_ms = cuda_ms(lambda: greedy.solve_greedy_batched_shared(*args), 10)
        p_ms = host_ms(
            lambda: greedy.solve_greedy_batched_shared_plain(*args), 1)
        in_bytes = bytes_of(*args[:12]) + bytes_of(*out_k)
        ops = SCORE_OPS * b * (n + k)
        bms, by = bound_ms(in_bytes, ops)
        log(f"greedy N={n} B={b} k={k} jd={jd} td={td} {mode}: equal, "
            f"placed={int(out_k[1].sum())} kernel_ms={k_ms:.4f} "
            f"profiler_kernel_ms={fmt_ms(prof_ms)} wrapper_ms={w_ms:.4f} "
            f"plain_ms={p_ms:.2f} bound_ms={bms:.6f} ({by})")
        results["greedy"][row] = dict(
            ms=k_ms, profiler_ms=prof_ms, wrapper_ms=w_ms, plain_ms=p_ms,
            bound_ms=bms, bound_by=by)
    results["greedy_err"] = worst
    return results


# -- the port's main path ---------------------------------------------------


class FixedStatePlanner:
    """Commits every plan in full without applying it, so each eval is
    scheduled against the same cluster state (the harness still records
    the plans and evals)."""

    def __init__(self, harness):
        self.harness = harness

    def submit_plan(self, plan):
        from nomad_tpu_torch.structs import PlanResult

        return PlanResult(
            node_update=plan.node_update,
            node_allocation=plan.node_allocation,
            alloc_batches=plan.alloc_batches,
            update_batches=plan.update_batches,
            alloc_index=self.harness.next_index(),
        ), None

    def update_eval(self, ev):
        pass

    def create_eval(self, ev):
        pass


def cluster_nodes():
    """bench.py's 10,000 nodes: dc1/dc2 alternating, 4000 MHz / 8192 MB,
    kernel.name=linux, driver exec."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.structs import Node, Resources

    return [Node(
        id=f"node-{i:05d}",
        datacenter="dc1" if i % 2 == 0 else "dc2",
        name=f"n{i}",
        attributes={"kernel.name": "linux", "driver.exec": "1"},
        resources=Resources(cpu=4000, memory_mb=8192,
                            disk_mb=100 * 1024, iops=150),
        status=structs.NODE_STATUS_READY,
    ) for i in range(N_NODES)]


def build_cluster():
    from nomad_tpu_torch.harness import Harness

    h = Harness()
    h.planner = FixedStatePlanner(h)
    for node in cluster_nodes():
        h.state.upsert_node(h.next_index(), node)
    return h


def make_job(name: str, typ: str, count: int, dcs):
    from nomad_tpu_torch.structs import (
        Constraint, Job, Resources, RestartPolicy, Task, TaskGroup,
        generate_uuid,
    )

    return Job(
        region="global", id=generate_uuid(), name=name, type=typ,
        priority=50, datacenters=list(dcs),
        constraints=[Constraint(l_target="$attr.kernel.name",
                                r_target="linux", operand="=")],
        task_groups=[TaskGroup(
            name="work", count=count,
            restart_policy=RestartPolicy(attempts=1, interval=600.0,
                                         delay=5.0),
            tasks=[Task(name="work", driver="exec",
                        resources=Resources(cpu=100, memory_mb=128))],
        )],
    )


def register_eval(h, job):
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.structs import Evaluation, generate_uuid

    h.state.upsert_job(h.next_index(), job)
    return Evaluation(id=generate_uuid(), priority=job.priority,
                      type=job.type,
                      triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER,
                      job_id=job.id)


def check_plan(state, plan, job, want: int) -> int:
    """Every task placed, only in the job's datacenters, and each node's
    summed asks within its capacity (numpy over the plan's columns)."""
    per_node = {}
    vec_of = {}
    for b in plan.alloc_batches:
        vec = np.asarray(b.resources.as_vector(), dtype=np.int64)
        for nid, cnt in zip(b.node_ids, b.node_counts):
            per_node[nid] = per_node.get(nid, 0) + int(cnt)
            vec_of[nid] = vec
    for nid, allocs in plan.node_allocation.items():
        for a in allocs:
            per_node[nid] = per_node.get(nid, 0) + 1
            vec_of[nid] = np.asarray(a.resources.as_vector(), dtype=np.int64)
    placed = sum(per_node.values())
    if placed != want or plan.failed_allocs:
        raise AssertionError(f"placed {placed} of {want}, "
                             f"{len(plan.failed_allocs)} failed allocs")
    ids = sorted(per_node)
    nodes = [state.node_by_id(nid) for nid in ids]
    if any(n.datacenter not in job.datacenters for n in nodes):
        raise AssertionError("a placement landed outside the job's "
                             "datacenters")
    cap = np.array([n.resources.as_vector() for n in nodes], dtype=np.int64)
    res = np.array([n.reserved.as_vector() if n.reserved else (0, 0, 0, 0)
                    for n in nodes], dtype=np.int64)
    ask = np.array([vec_of[nid] * per_node[nid] for nid in ids])
    if np.any(ask + res > cap):
        raise AssertionError("a node's placements exceed its capacity")
    return placed


class StageSpan:
    """Collects the solver's stage cuts (staging/transfer/execute/
    readback) of the evals run under it."""

    def __init__(self):
        self.ms = {}

    def annotate(self, key, value):
        pass

    def record_stages(self, stages, prefix):
        for name, t0, t1 in stages:
            self.ms[name] = self.ms.get(name, 0.0) + (t1 - t0) * 1000.0


def timed_evals(h, dev, job, factory: str, label: str):
    """1 warm-up and TIMED_EVALS timed evals of ``job`` through ``factory``,
    each plan checked; returns (e2e ms, stage ms) of the timed ones."""
    import torch
    from nomad_tpu_torch import structs, trace

    e2e, stage_ms = [], []
    for i in range(1 + TIMED_EVALS):
        ev = register_eval(h, job)
        span = StageSpan()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with trace.use_span(span):
            h.process(factory, ev, device=dev)
        wall = (time.perf_counter() - t0) * 1000.0
        placed = check_plan(h.state, h.plans[-1], job,
                            job.task_groups[0].count)
        if h.evals[-1].status != structs.EVAL_STATUS_COMPLETE:
            raise AssertionError(f"eval status {h.evals[-1].status}")
        if i:
            e2e.append(wall)
            stage_ms.append(span.ms)
        log(f"{label} eval {i}{' (warm-up)' if i == 0 else ''}: "
            f"placed={placed} e2e_ms={wall:.2f} stages_ms="
            + json.dumps({k: round(v, 3) for k, v in span.ms.items()}))
    return e2e, stage_ms


def stage_p50s(stage_ms):
    return {k: float(np.median([s.get(k, 0.0) for s in stage_ms]))
            for k in ("staging", "transfer", "execute", "readback")}


def phase_headline(h, dev):
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import greedy, waterfill

    job = make_job("bench-batch", structs.JOB_TYPE_BATCH, N_TASKS, ["dc1"])
    waterfill.LAUNCHES = 0
    greedy.LAUNCHES = 0
    e2e, stage_ms = timed_evals(h, dev, job, "tpu-batch", "headline")
    launches = waterfill.LAUNCHES
    if launches == 0:
        raise AssertionError("the headline eval never launched the "
                             "water-fill kernel")
    solve = [sum(s.values()) for s in stage_ms]
    p50 = float(np.median(solve))
    e2e_p50 = float(np.median(e2e))
    stages_p50 = stage_p50s(stage_ms)
    log(f"headline: {N_NODES} nodes x {N_TASKS} tasks, solve_p50_ms="
        f"{p50:.3f} e2e_p50_ms={e2e_p50:.3f} placements_per_s="
        f"{N_TASKS / (e2e_p50 / 1000.0):.0f} waterfill_launches={launches} "
        f"greedy_launches={greedy.LAUNCHES}")
    log("headline stage p50 ms: " + json.dumps(
        {k: round(v, 3) for k, v in stages_p50.items()}))
    return launches


def phase_service(h, dev):
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import greedy

    job = make_job("svc", structs.JOB_TYPE_SERVICE, SERVICE_COUNT,
                   ["dc1", "dc2"])
    greedy.LAUNCHES = 0
    e2e, stage_ms = timed_evals(h, dev, job, "tpu-service", "service")
    launches = greedy.LAUNCHES
    if launches == 0:
        raise AssertionError("the service eval never launched the greedy "
                             "kernel")
    solve = [sum(s.values()) for s in stage_ms]
    log(f"service: count {SERVICE_COUNT}, solve_p50_ms="
        f"{float(np.median(solve)):.3f} e2e_p50_ms="
        f"{float(np.median(e2e)):.3f} greedy_launches={launches}")
    log("service stage p50 ms: " + json.dumps(
        {k: round(v, 3) for k, v in stage_p50s(stage_ms).items()}))
    return launches


def phase_burst(h, dev):
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import waterfill
    from nomad_tpu_torch.ops.coalesce import GLOBAL_SOLVER
    from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

    jobs = [make_job(f"burst-{i}", structs.JOB_TYPE_BATCH, BURST_TASKS,
                     ["dc1"]) for i in range(BURST_EVALS)]
    evs = [register_eval(h, j) for j in jobs]
    before = dict(SOLVER_PANEL.snapshot()["batch_widths"])
    n_plans = len(h.plans)
    errors = []
    waterfill.LAUNCHES = 0
    token = GLOBAL_SOLVER.hint_burst(BURST_EVALS)

    def run(ev):
        try:
            GLOBAL_SOLVER.burst_begin(token)
            h.process("tpu-batch", ev, device=dev)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)
        finally:
            GLOBAL_SOLVER.burst_done()

    threads = [threading.Thread(target=run, args=(ev,)) for ev in evs]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = (time.perf_counter() - t0) * 1000.0
    launches = waterfill.LAUNCHES
    if errors:
        raise errors[0]
    plans = h.plans[n_plans:]
    by_eval = {p.eval_id: p for p in plans}
    placed = sum(check_plan(h.state, by_eval[ev.id], j, BURST_TASKS)
                 for j, ev in zip(jobs, evs))
    widths = dispatch_widths(before)
    if launches == 0:
        raise AssertionError("the burst never launched the water-fill")
    log(f"burst: {BURST_EVALS} evals x {BURST_TASKS} tasks placed={placed} "
        f"wall_ms={wall:.2f} waterfill_launches={launches} "
        f"dispatch_widths={json.dumps(widths)}")
    return launches


# -- the server loop -----------------------------------------------------------

# No client heartbeats reach the server in this run: the TTL outlives it.
SERVER_HEARTBEAT_TTL_S = 3600.0
SERVER_WAIT_S = 120.0
# Span stages read from each eval's trace, in pipeline order. The solver's
# four cuts are children of worker.invoke_scheduler. worker.wait_for_index
# is a follower's worker waiting for the eval's raft index to reach its
# own store. The last is derived: worker.submit_plan less the three plan.*
# spans inside it, the hand-offs between the worker and the plan
# pipeline's thread that no span covers.
SERVER_STAGES = ("broker.wait", "worker.wait_for_index",
                 "worker.invoke_scheduler", "solver.staging",
                 "solver.transfer", "solver.execute", "solver.readback",
                 "worker.submit_plan", "plan.queue_wait", "plan.evaluate",
                 "plan.apply", "fsm.apply:alloc_update",
                 "submit_plan.outside_plan_spans")


def check_committed(snap, job, want: int) -> int:
    """From a state snapshot: ``job`` holds ``want`` live tasks, all on
    nodes of its datacenters with kernel.name=linux (make_job's
    constraint), and every node's summed live asks of all jobs plus its
    reserved resources fit its capacity (numpy over the stored blocks'
    runs and the object rows). Returns the live count."""
    usage, job_nodes = {}, {}

    def add(nid, vec, cnt, own):
        usage[nid] = usage.get(nid, 0) + vec * cnt
        if own:
            job_nodes[nid] = job_nodes.get(nid, 0) + cnt

    for blk in snap.alloc_blocks():
        vec = np.asarray(blk.resource_vector(), dtype=np.int64)
        for nid, cnt in blk.live_node_counts():
            add(nid, vec, int(cnt), blk.job_id == job.id)
    for a in snap.allocs_objects():
        if not a.terminal_status():
            add(a.node_id, np.asarray(a.resources.as_vector(),
                                      dtype=np.int64), 1, a.job_id == job.id)
    live = sum(job_nodes.values())
    if live != want:
        raise AssertionError(f"{live} live tasks of job {job.name} "
                             f"committed, want {want}")
    for nid in sorted(job_nodes):
        node = snap.node_by_id(nid)
        if (node is None or node.datacenter not in job.datacenters
                or node.attributes.get("kernel.name") != "linux"):
            raise AssertionError(f"a task of job {job.name} was committed "
                                 f"on {nid}, outside its datacenters or "
                                 "its constraint")
    ids = sorted(usage)
    if not ids:
        return live
    nodes = [snap.node_by_id(nid) for nid in ids]
    if any(n is None for n in nodes):
        raise AssertionError("a task was committed on an unknown node")
    cap = np.array([n.resources.as_vector() for n in nodes], dtype=np.int64)
    res = np.array([n.reserved.as_vector() if n.reserved else (0, 0, 0, 0)
                    for n in nodes], dtype=np.int64)
    used = np.array([usage[nid] for nid in ids], dtype=np.int64)
    over = np.any(used + res > cap, axis=1)
    if over.any():
        raise AssertionError(f"node {ids[int(np.argmax(over))]}'s committed "
                             "tasks exceed its capacity")
    return live


def wait_complete(srv, eval_id: str) -> float:
    """Poll the state store (0.5 ms) until the eval is terminal; returns
    the perf_counter stamp it was seen. Any end but complete fails."""
    from nomad_tpu_torch import structs

    deadline = time.perf_counter() + SERVER_WAIT_S
    while time.perf_counter() < deadline:
        ev = srv.state_store.eval_by_id(eval_id)
        if ev is not None and ev.terminal_status():
            if ev.status != structs.EVAL_STATUS_COMPLETE:
                raise AssertionError(f"server eval {eval_id} ended "
                                     f"{ev.status}: {ev.status_description}")
            return time.perf_counter()
        time.sleep(0.0005)
    raise AssertionError(f"server eval {eval_id} did not end in "
                         f"{SERVER_WAIT_S}s")


def eval_stages(eval_id: str):
    """ms per span stage of one eval's trace (SERVER_STAGES), summed over
    the eval's spans of that name; fsm.apply is split by message type."""
    from nomad_tpu_torch import trace

    out = {}
    for span in trace.get_tracer().get_trace(eval_id) or []:
        name = span["name"]
        if name == "fsm.apply":
            name += ":" + str(span["annotations"].get("msg_type"))
        if span["duration_ms"] is not None:
            out[name] = out.get(name, 0.0) + span["duration_ms"]
    out["submit_plan.outside_plan_spans"] = out.get(
        "worker.submit_plan", 0.0) - sum(
        out.get(k, 0.0) for k in ("plan.queue_wait", "plan.evaluate",
                                  "plan.apply"))
    return out


def p50(xs) -> float:
    return float(np.median(xs)) if len(xs) else float("nan")


def server_round(srv, job):
    """register -> complete -> check -> deregister -> complete -> check ->
    reap. Returns (register ms, deregister ms, live tasks, eval id)."""
    t0 = time.perf_counter()
    eid, _ = srv.job_register(job)
    reg = (wait_complete(srv, eid) - t0) * 1000.0
    live = check_committed(srv.state_store.snapshot(), job,
                           job.task_groups[0].count)
    t0 = time.perf_counter()
    did, _ = srv.job_deregister(job.id)
    dereg = (wait_complete(srv, did) - t0) * 1000.0
    snap = srv.state_store.snapshot()
    check_committed(snap, job, 0)
    # The stopped allocs stay as object rows until the eval GC reaps them;
    # reap this round's now (outside the timed spans), so every round
    # starts from the same state.
    srv.eval_reap([eid, did], [a.id for a in snap.allocs_by_job(job.id)])
    return reg, dereg, live, eid


def server_rounds(srv, job, label: str):
    """1 warm-up and TIMED_EVALS timed server_rounds. Returns (register
    ms, deregister ms, stage ms dicts) of the timed rounds."""
    reg_ms, dereg_ms, stages = [], [], []
    for i in range(1 + TIMED_EVALS):
        reg, dereg, live, eid = server_round(srv, job)
        st = eval_stages(eid)
        if i:
            reg_ms.append(reg)
            dereg_ms.append(dereg)
            stages.append(st)
        log(f"server {label} round {i}{' (warm-up)' if i == 0 else ''}: "
            f"committed={live} register_ms={reg:.2f} "
            f"deregister_ms={dereg:.2f} stages_ms="
            + json.dumps({k: round(st.get(k, 0.0), 3)
                          for k in SERVER_STAGES}))
    return reg_ms, dereg_ms, stages


def log_server_summary(label: str, tasks: int, reg_ms, dereg_ms, stages):
    reg = p50(reg_ms)
    log(f"server {label}: register_complete_p50_ms={reg:.3f} "
        f"placements_per_s={tasks / (reg / 1000.0):.0f} "
        f"deregister_complete_p50_ms={p50(dereg_ms):.3f}")
    log(f"server {label} stage p50 ms: " + json.dumps(
        {k: round(p50([s.get(k, 0.0) for s in stages]), 3)
         for k in SERVER_STAGES}))


def dispatch_widths(before):
    """Coalesced dispatches per eval-axis width since ``before`` (a
    SOLVER_PANEL batch_widths snapshot), widths with none left out."""
    from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

    after = SOLVER_PANEL.snapshot()["batch_widths"]
    widths = {w: row["dispatches"] - before.get(w, {}).get("dispatches", 0)
              for w, row in after.items()}
    return {w: d for w, d in widths.items() if d}


def new_server(dev, **kw):
    """A started Server (prewarm_shapes on, its default) holding the
    10,000 nodes, returned once its start-time warmer has warmed them:
    the warmer's dispatch count is watched, not a sleep."""
    from nomad_tpu_torch.server.server import Server, ServerConfig

    srv = Server(ServerConfig(scheduler_backend="tpu", device=str(dev),
                              min_heartbeat_ttl=SERVER_HEARTBEAT_TTL_S,
                              **kw))
    srv.start()
    t0 = time.perf_counter()
    srv.node_batch_register(cluster_nodes())
    t1 = time.perf_counter()
    log(f"server: {N_NODES} nodes by node_batch_register in "
        f"{(t1 - t0) * 1000.0:.1f} ms")
    deadline = t1 + SERVER_WAIT_S
    while srv.warm_dispatches == 0:
        if time.perf_counter() > deadline:
            raise AssertionError("the server's start-time warm did not run")
        time.sleep(0.005)
    log(f"server: start-time warm done {(time.perf_counter() - t1) * 1000.0:.1f}"
        f" ms after registration, {srv.warm_dispatches} dispatches")
    return srv


def phase_server(dev):
    """The headline and the service job through the server loop. Returns
    (water-fill launches, greedy launches) of the two runs."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import greedy, waterfill

    srv = new_server(dev)
    try:
        job = make_job("server-batch", structs.JOB_TYPE_BATCH, N_TASKS,
                       ["dc1"])
        waterfill.LAUNCHES = 0
        reg, dereg, stages = server_rounds(srv, job, "headline")
        wf = waterfill.LAUNCHES
        if wf == 0:
            raise AssertionError("the server's headline rounds never "
                                 "launched the water-fill kernel")
        log_server_summary("headline", N_TASKS, reg, dereg, stages)

        job = make_job("server-svc", structs.JOB_TYPE_SERVICE, SERVICE_COUNT,
                       ["dc1", "dc2"])
        greedy.LAUNCHES = 0
        reg, dereg, stages = server_rounds(srv, job, "service")
        gr = greedy.LAUNCHES
        if gr == 0:
            raise AssertionError("the server's service rounds never "
                                 "launched the greedy kernel")
        log_server_summary("service", SERVICE_COUNT, reg, dereg, stages)
        log(f"server: waterfill_launches={wf} greedy_launches={gr} "
            f"stats={json.dumps(srv.solver_stats())}")
    finally:
        srv.shutdown()
    return wf, gr


def phase_server_burst(dev):
    """On a fresh server, once its start-time warm is done (no warm-up
    round), 8 batch jobs of 12,500 dc1 tasks registered while the one
    worker is paused, then drained by it as one broker batch
    (eval_batch_size=8): one width-8 water-fill dispatch. Returns the
    water-fill launches."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import waterfill
    from nomad_tpu_torch.server.worker import DEQUEUE_TIMEOUT
    from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

    srv = new_server(dev, num_schedulers=1, eval_batch_size=BURST_EVALS)
    try:
        worker = srv.workers[0]
        worker.set_pause(True)
        # The worker parks once its current dequeue times out.
        time.sleep(DEQUEUE_TIMEOUT + 0.2)
        jobs = [make_job(f"server-burst-{i}", structs.JOB_TYPE_BATCH,
                         BURST_TASKS, ["dc1"]) for i in range(BURST_EVALS)]
        eids = [srv.job_register(j)[0] for j in jobs]
        before = dict(SOLVER_PANEL.snapshot()["batch_widths"])
        waterfill.LAUNCHES = 0
        t0 = time.perf_counter()
        worker.set_pause(False)
        done = max(wait_complete(srv, eid) for eid in eids)
        wall = (done - t0) * 1000.0
        launches = waterfill.LAUNCHES
        snap = srv.state_store.snapshot()
        placed = sum(check_committed(snap, j, BURST_TASKS) for j in jobs)
        widths = dispatch_widths(before)
        if worker.last_batch_size != BURST_EVALS:
            raise AssertionError(f"the worker drained {worker.last_batch_size}"
                                 f" evals at once, want {BURST_EVALS}")
        if widths != {str(BURST_EVALS): 1}:
            raise AssertionError("the server burst was not one width-"
                                 f"{BURST_EVALS} water-fill dispatch: "
                                 f"{widths}")
        if launches == 0:
            raise AssertionError("the server burst never launched the "
                                 "water-fill kernel")
        stages = [eval_stages(eid) for eid in eids]
        log(f"server burst: {BURST_EVALS} evals x {BURST_TASKS} tasks "
            f"committed={placed} wall_ms={wall:.2f} placements_per_s="
            f"{placed / (wall / 1000.0):.0f} worker_batch="
            f"{worker.last_batch_size} waterfill_launches={launches} "
            f"dispatch_widths={json.dumps(widths)}")
        log("server burst stage p50 ms: " + json.dumps(
            {k: round(p50([s.get(k, 0.0) for s in stages]), 3)
             for k in SERVER_STAGES}))
    finally:
        srv.shutdown()
    return launches


# -- the cluster tier ------------------------------------------------------------

CLUSTER_MEMBERS = 3
CLUSTER_ROUNDS = 3
# Raft timing for three members' raft, RPC, broker, worker and pipeline
# threads in one interpreter (nomad_tpu's tests widen theirs by the stall
# they measure): 0.1 s heartbeats, 10-15 s elections. A raft node applies
# committed entries under its lock, as nomad_tpu's does, and the headline
# deregister's entry (100,000 stops) holds it 3.6-6.1 s on each member of
# this cell on the H100's host: no heartbeat leaves the leader meanwhile.
# With 1-2 s elections every such deregister cost 4-8 elections, and one
# never completed: its plan was resubmitted across leader changes until
# the wait ran out.
CLUSTER_RAFT = dict(heartbeat_interval=0.1, election_timeout_min=10.0,
                    election_timeout_max=15.0)
# Nodes per Node.BatchRegister frame through the follower (all of them in
# one frame, under the RPC tier's 64 MB cap).
CLUSTER_NODE_CHUNK = N_NODES
# Leader death: the kill lands this long (seeded draw, seconds) after the
# burst's last registration, inside its flight window.
CLUSTER_KILL_S = (0.0, 0.15)


def cluster_call(fn, what: str):
    """A cluster write through a member, retried across a leader change
    (NotLeaderError, transport errors); each retry is logged."""
    from nomad_tpu_torch.raft import NotLeaderError
    from nomad_tpu_torch.rpc import RemoteError, RPCError

    deadline = time.perf_counter() + SERVER_WAIT_S
    while True:
        try:
            return fn()
        except (NotLeaderError, RPCError) as exc:
            if (isinstance(exc, RemoteError)
                    and "not the leader" not in str(exc)):
                raise
            if time.perf_counter() > deadline:
                raise
            log(f"cluster: {what} retried after {type(exc).__name__}: {exc}")
            time.sleep(0.05)


def current_leader(servers):
    from nomad_tpu_torch.server.cluster import wait_for_leader

    return wait_for_leader(servers, timeout=SERVER_WAIT_S)


def terms(servers):
    return [s.raft.current_term for s in servers]


def wait_members(servers, eval_id: str, index: int) -> float:
    """Poll every member (0.5 ms) until it has applied ``index`` and its
    store shows ``eval_id`` complete; returns the stamp of the last."""
    from nomad_tpu_torch import structs

    deadline = time.perf_counter() + SERVER_WAIT_S
    pending = list(servers)
    while pending:
        if time.perf_counter() > deadline:
            raise AssertionError(f"{len(pending)} member(s) never applied "
                                 f"index {index}")
        for srv in list(pending):
            ev = srv.state_store.eval_by_id(eval_id)
            if (srv.raft.applied_index >= index and ev is not None
                    and ev.status == structs.EVAL_STATUS_COMPLETE):
                pending.remove(srv)
        time.sleep(0.0005)
    return time.perf_counter()


def fsm_applies(msg_type: str, since: int):
    """ms of the FSM applies of ``msg_type`` recorded (by every member of
    the process) after the first ``since`` samples, longest first."""
    from nomad_tpu_torch import telemetry

    return sorted(telemetry.samples(("fsm", "apply", msg_type))[since:],
                  reverse=True)


def n_fsm_applies(msg_type: str) -> int:
    from nomad_tpu_torch import telemetry

    return len(telemetry.samples(("fsm", "apply", msg_type)))


def settle(servers, index: int) -> None:
    """Wait until every member has applied ``index`` and a leader is
    known, so the next timed step starts on a quiet cell."""
    deadline = time.perf_counter() + SERVER_WAIT_S
    while min(s.raft.applied_index for s in servers) < index:
        if time.perf_counter() > deadline:
            raise AssertionError(f"members never applied index {index}")
        time.sleep(0.0005)
    current_leader(servers)


def cluster_round(servers, leader, follower, job):
    """register through ``follower`` -> complete on the leader -> every
    member applied and checked; the same for the deregister; then the
    leader reaps the round and the cell settles (every member applied
    the reap) before the next round. Returns (register ms, all-members
    ms, deregister ms, dereg all-members ms, live, eval id, notes)."""
    want = job.task_groups[0].count
    terms0 = terms(servers)
    t0 = time.perf_counter()
    eid, _ = cluster_call(lambda: follower.job_register(job), "Job.Register")
    reg = (wait_complete(leader, eid) - t0) * 1000.0
    every = (wait_members(servers, eid, leader.raft.applied_index)
             - t0) * 1000.0
    lives = [check_committed(s.state_store.snapshot(), job, want)
             for s in servers]
    terms1 = terms(servers)
    n_alloc = n_fsm_applies("alloc_update")
    t0 = time.perf_counter()
    did, _ = cluster_call(lambda: follower.job_deregister(job.id),
                          "Job.Deregister")
    dereg = (wait_complete(leader, did) - t0) * 1000.0
    dereg_every = (wait_members(servers, did, leader.raft.applied_index)
                   - t0) * 1000.0
    stop_applies = fsm_applies("alloc_update", n_alloc)[:CLUSTER_MEMBERS]
    terms2 = terms(servers)
    for srv in servers:
        check_committed(srv.state_store.snapshot(), job, 0)
    snap = leader.state_store.snapshot()
    stopped = [a.id for a in snap.allocs_by_job(job.id)]
    n_delete = n_fsm_applies("eval_delete")
    t0 = time.perf_counter()
    index = cluster_call(lambda: current_leader(servers).eval_reap(
        [eid, did], stopped), "reap")
    settle(servers, index)
    notes = {
        "terms": [terms0, terms1, terms2, terms(servers)],
        "stop_fsm_apply_ms": [round(x, 1) for x in stop_applies],
        "reap_settled_ms": round((time.perf_counter() - t0) * 1000.0, 1),
        "reap_fsm_apply_ms": [round(x, 1) for x in
                              fsm_applies("eval_delete", n_delete)[:3]],
    }
    return reg, every, dereg, dereg_every, lives[0], eid, notes


def cluster_rounds(servers, job, label: str):
    """1 warm-up and CLUSTER_ROUNDS timed cluster_rounds, each through a
    follower of the leader of the moment."""
    rows = []
    for i in range(1 + CLUSTER_ROUNDS):
        leader = current_leader(servers)
        follower = next(s for s in servers if s is not leader)
        reg, every, dereg, dereg_every, live, eid, notes = cluster_round(
            servers, leader, follower, job)
        st = eval_stages(eid)
        if i:
            rows.append((reg, every, dereg, dereg_every, st))
        # terms: before the register, after it, after the deregister,
        # after the reap settled; a rise is an election.
        log(f"cluster {label} round {i}{' (warm-up)' if i == 0 else ''}: "
            f"committed={live} on each of {len(servers)} members "
            f"register_ms={reg:.2f} all_members_ms={every:.2f} "
            f"deregister_ms={dereg:.2f} "
            f"deregister_all_members_ms={dereg_every:.2f} "
            f"{json.dumps(notes)} stages_ms="
            + json.dumps({k: round(st.get(k, 0.0), 3)
                          for k in SERVER_STAGES}))
    tasks = job.task_groups[0].count
    reg = p50([r[0] for r in rows])
    log(f"cluster {label}: register_complete_p50_ms={reg:.3f} "
        f"placements_per_s={tasks / (reg / 1000.0):.0f} "
        f"all_members_p50_ms={p50([r[1] for r in rows]):.3f} "
        f"deregister_complete_p50_ms={p50([r[2] for r in rows]):.3f} "
        f"deregister_all_members_p50_ms={p50([r[3] for r in rows]):.3f}")
    log(f"cluster {label} stage p50 ms: " + json.dumps(
        {k: round(p50([r[4].get(k, 0.0) for r in rows]), 3)
         for k in SERVER_STAGES}))


def cluster_leader_death(servers, rng):
    """8 batch jobs of 12,500 dc1 tasks through the leader, the leader
    shut down at a seeded point of the burst's flight; the survivors
    elect, finish every eval, and each survivor's store holds exactly
    12,500 live tasks per job on dc1 with no node over capacity. Returns
    the survivors."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.server.cluster import wait_for_leader
    from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

    leader = wait_for_leader(servers, timeout=SERVER_WAIT_S)
    jobs = [make_job(f"cluster-burst-{i}", structs.JOB_TYPE_BATCH,
                     BURST_TASKS, ["dc1"]) for i in range(BURST_EVALS)]
    before = dict(SOLVER_PANEL.snapshot()["batch_widths"])
    t0 = time.perf_counter()
    eids = [cluster_call(lambda j=j: leader.job_register(j),
                         "Job.Register")[0] for j in jobs]
    delay = float(rng.uniform(*CLUSTER_KILL_S))
    time.sleep(delay)
    done_at_kill = sum(
        1 for eid in eids
        if getattr(leader.state_store.eval_by_id(eid), "status", "")
        == structs.EVAL_STATUS_COMPLETE)
    t_kill = time.perf_counter()
    drained = leader.shutdown(drain_timeout=1.0)
    t_down = time.perf_counter()
    survivors = [s for s in servers if s is not leader]
    new_leader = wait_for_leader(survivors, timeout=SERVER_WAIT_S)
    t_elect = time.perf_counter()
    done = max(wait_complete(new_leader, eid) for eid in eids)
    wait_members(survivors, eids[-1], new_leader.raft.applied_index)
    widths = dispatch_widths(before)
    for srv in survivors:
        snap = srv.state_store.snapshot()
        for eid in eids:
            ev = snap.eval_by_id(eid)
            if ev is None or ev.status != structs.EVAL_STATUS_COMPLETE:
                raise AssertionError(f"eval {eid} not complete on "
                                     f"{srv.cluster.node_id}")
        placed = sum(check_committed(snap, j, BURST_TASKS) for j in jobs)
        log(f"cluster leader death: {srv.cluster.node_id} holds "
            f"{placed} live tasks of {BURST_EVALS} jobs x {BURST_TASKS}")
    log(f"cluster leader death: killed {leader.cluster.node_id} "
        f"{(t_kill - t0) * 1000.0:.1f} ms after the first registration "
        f"(seeded delay {delay * 1000.0:.1f} ms, {done_at_kill} of "
        f"{BURST_EVALS} evals complete at the kill), shutdown "
        f"{(t_down - t_kill) * 1000.0:.1f} ms (drained={drained}), "
        f"new leader {new_leader.cluster.node_id} "
        f"{(t_elect - t_kill) * 1000.0:.1f} ms after the kill, every eval "
        f"complete {(done - t_kill) * 1000.0:.1f} ms after the kill, "
        f"terms={terms(survivors)}, dispatch widths of every member's "
        f"workers together {json.dumps(widths)}")
    return survivors


def phase_cluster(dev, rng):
    """The headline, the service job and a leader death through a
    three-member ClusterServer cell on the card. Returns (water-fill
    launches, greedy launches) of the phase."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import greedy, waterfill
    from nomad_tpu_torch.server.cluster import (
        ClusterConfig, form_cluster, wait_for_leader,
    )
    from nomad_tpu_torch.server.server import ServerConfig

    waterfill.LAUNCHES = 0
    greedy.LAUNCHES = 0
    t0 = time.perf_counter()
    servers = form_cluster(CLUSTER_MEMBERS, ServerConfig(
        scheduler_backend="tpu", device=str(dev),
        min_heartbeat_ttl=SERVER_HEARTBEAT_TTL_S,
    ), base_cluster=ClusterConfig(bind_host="127.0.0.1", **CLUSTER_RAFT))
    live = servers
    try:
        leader = wait_for_leader(servers, timeout=SERVER_WAIT_S)
        log(f"cluster: {CLUSTER_MEMBERS} members, leader "
            f"{leader.cluster.node_id} after "
            f"{(time.perf_counter() - t0) * 1000.0:.1f} ms")
        follower = next(s for s in servers if s is not leader)
        nodes = cluster_nodes()
        before = terms(servers)
        t0 = time.perf_counter()
        for start in range(0, N_NODES, CLUSTER_NODE_CHUNK):
            chunk = nodes[start:start + CLUSTER_NODE_CHUNK]
            cluster_call(lambda c=chunk: follower.node_batch_register(c),
                         "Node.BatchRegister")
        t1 = time.perf_counter()
        index = max(s.raft.applied_index for s in servers)
        deadline = t1 + SERVER_WAIT_S
        while min(s.raft.applied_index for s in servers) < index:
            if time.perf_counter() > deadline:
                raise AssertionError("the node registration never reached "
                                     "every member")
            time.sleep(0.0005)
        counts = [len(s.state_store.nodes()) for s in servers]
        if counts != [N_NODES] * CLUSTER_MEMBERS:
            raise AssertionError(f"members hold {counts} nodes")
        log(f"cluster: {N_NODES} nodes through follower "
            f"{follower.cluster.node_id} in frames of {CLUSTER_NODE_CHUNK}: "
            f"{(t1 - t0) * 1000.0:.1f} ms to the reply, "
            f"{(time.perf_counter() - t0) * 1000.0:.1f} ms to every member, "
            f"terms={before}->{terms(servers)}")

        cluster_rounds(servers, make_job(
            "cluster-batch", structs.JOB_TYPE_BATCH, N_TASKS, ["dc1"]),
            "headline")
        cluster_rounds(servers, make_job(
            "cluster-svc", structs.JOB_TYPE_SERVICE, SERVICE_COUNT,
            ["dc1", "dc2"]), "service")
        live = cluster_leader_death(servers, rng)
    finally:
        for srv in live:
            srv.shutdown()
    wf, gr = waterfill.LAUNCHES, greedy.LAUNCHES
    log(f"cluster: waterfill_launches={wf} greedy_launches={gr}")
    if wf == 0 or gr == 0:
        raise AssertionError("the cluster phase did not launch both hand "
                             f"kernels (water-fill {wf}, greedy {gr})")
    return wf, gr


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import nomad_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the nomad_tpu_torch package is missing ({exc})",
              file=sys.stderr)
        return 2
    from nomad_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    torch.manual_seed(SEED)

    # 1. build
    t0 = time.perf_counter()
    kernels.library("waterfill")
    kernels.library("greedy")
    log(f"build: {kernels.BUILD_INFO.get('built')} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, report in sorted(kernels.BUILD_INFO.get("ptxas", {}).items()):
        for line in report.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                log(f"ptxas {name}: {line.strip()}")
            if re.search(r"\b[1-9]\d* bytes spill", line):
                raise AssertionError(f"ptxas reports spills in {name}")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. kernels vs plain
    kres = phase_kernels(dev, rng)

    # 3-5. the main path through the harness
    t0 = time.perf_counter()
    h = build_cluster()
    log(f"cluster: {N_NODES} nodes in {time.perf_counter() - t0:.1f}s")
    wf_launches = phase_headline(h, dev)
    gr_launches = phase_service(h, dev)
    wf_launches += phase_burst(h, dev)

    # 6. the server loop
    wf, gr = phase_server(dev)
    wf_launches += wf + phase_server_burst(dev)
    gr_launches += gr

    # 7. the cluster tier
    wf, gr = phase_cluster(dev, rng)
    wf_launches += wf
    gr_launches += gr

    wf = kres["waterfill"][MAIN_WF_SHAPE]
    gr = kres["greedy"][MAIN_GREEDY_SHAPE]
    kernels_line = {"kernels": [
        {"name": "waterfill", "route": "cuda",
         "source": "nomad_tpu_torch/csrc/waterfill.cu",
         "replaces": "nomad_tpu/ops/pallas_solve.py:272",
         "launches": wf_launches, "max_abs_err": kres["waterfill_err"],
         "ms": wf["ms"], "wrapper_ms": wf["wrapper_ms"],
         "profiler_ms": wf["profiler_ms"], "plain_ms": wf["plain_ms"],
         "bound_ms": wf["bound_ms"], "bound_by": wf["bound_by"],
         "library_ms": None},
        {"name": "greedy", "route": "cuda",
         "source": "nomad_tpu_torch/csrc/greedy.cu",
         "replaces": "nomad_tpu/ops/binpack.py:115",
         "launches": gr_launches, "max_abs_err": kres["greedy_err"],
         "ms": gr["ms"], "wrapper_ms": gr["wrapper_ms"],
         "profiler_ms": gr["profiler_ms"], "plain_ms": gr["plain_ms"],
         "bound_ms": gr["bound_ms"], "bound_by": gr["bound_by"],
         "library_ms": None},
    ]}
    log(f"card: {card}")
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
