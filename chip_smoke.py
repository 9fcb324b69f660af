#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nomad_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. build: compile every kernel under nomad_tpu_torch/csrc with nvcc for
   sm_90a; print the build seconds, ptxas' register report and the card.
2. kernels vs plain: each kernel's wrapper against its plain PyTorch
   version on the same CUDA tensors, at the main path's shapes and the
   water-fill's 16384/131072-row buckets; outputs must be exactly equal.
   Prints kernel ms (CUDA events around back-to-back launches of the
   kernel alone, pre-checked and pre-allocated; cross-checked against
   torch.profiler's device time), the full wrapper's ms, and plain ms.
3. headline: 10,000 nodes (dc1/dc2, 4000 MHz / 8192 MB, kernel.name=linux,
   driver exec) and one batch job of 100,000 tasks restricted to dc1,
   through new_scheduler("tpu-batch", ..., device="cuda"): 1 warm-up and 5
   timed evals. Every task placed, only on dc1 nodes, capacity held.
4. service: a tpu-service job of count 100 over both datacenters (the
   object path and the exact greedy scan).
5. burst: 8 batch evals of 12,500 tasks from 8 threads through the
   coalescer.

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
WF_SHAPES = [(8192, 1, False, False), (8192, 8, False, False),
             (16384, 1, False, False), (16384, 8, False, False),
             (16384, 8, True, False),
             (16384, 8, False, True), (131072, 1, False, False),
             (131072, 8, True, True)]
GREEDY_SHAPES = [(16384, 1, 8), (16384, 1, 128), (16384, 8, 128),
                 (8192, 1, 128)]
MAIN_WF_SHAPE = (8192, 1, False, False)
MAIN_GREEDY_SHAPE = (16384, 1, 128)


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


def waterfill_case(rng, n: int, b: int, jd: bool, td: bool, dev):
    import torch

    live = min(n, int(n * 0.61) + 1)
    cols = [[] for _ in range(12)]
    for _ in range(b):
        total, sched, bw_avail = node_arrays(rng, n, live)
        used, jc, tc, bwu, elig, ask, bw_ask = eval_arrays(
            rng, total, bw_avail, live)
        count = int(rng.integers(1, 4 * live))
        penalty = float(rng.choice([10.0, 5.0, 0.0]))
        for i, v in enumerate((total, sched, used, jc, tc, bw_avail, bwu,
                               elig, ask, bw_ask, count, penalty)):
            cols[i].append(v)
    dt = [torch.int32, torch.float32, torch.int32, torch.int32, torch.int32,
          torch.int32, torch.int32, torch.bool, torch.int32, torch.int32,
          torch.int32, torch.float32]
    args = [torch.tensor(np.stack(c), dtype=t, device=dev)
            for c, t in zip(cols, dt)]
    return (*args, jd, td)


def greedy_case(rng, n: int, b: int, k: int, dev):
    import torch

    live = min(n, int(n * 0.61) + 1)
    total, sched, bw_avail = node_arrays(rng, n, live)
    per = [eval_arrays(rng, total, bw_avail, live) for _ in range(b)]
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
        torch.tensor(rng.choice([10.0, 5.0], b), dtype=torch.float32,
                     device=dev),
        k, False, False,
    )


def bytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "numel"))


def bound_ms(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Per-node float32 operations of one BestFit score (2 div, 2 sub, 2 pow,
# 2 max, add, sub, 2 clamp, mul, sub).
SCORE_OPS = 15


def phase_kernels(dev, rng):
    import torch
    from nomad_tpu_torch.ops import greedy, waterfill

    results = {"waterfill": {}, "greedy": {}}
    worst = 0
    for n, b, jd, td in WF_SHAPES:
        args = waterfill_case(rng, n, b, jd, td, dev)
        counts_k, rem_k = waterfill.solve_waterfill_batched(*args)
        counts_p, rem_p = waterfill.solve_waterfill_batched_plain(*args)
        torch.cuda.synchronize()
        err = max(int((counts_k - counts_p).abs().max()),
                  int((rem_k - rem_p).abs().max()))
        worst = max(worst, err)
        if not (torch.equal(counts_k, counts_p) and torch.equal(rem_k, rem_p)):
            raise AssertionError(
                f"waterfill kernel != plain at N={n} B={b} jd={jd} td={td}: "
                f"max abs err {err}")
        raw = waterfill.kernel_only(*args)
        k_ms = cuda_ms(raw, 20)
        prof_ms = profiler_ms(raw, 20, "waterfill_kernel")
        w_ms = cuda_ms(lambda: waterfill.solve_waterfill_batched(*args), 20)
        p_ms = host_ms(lambda: waterfill.solve_waterfill_batched_plain(*args),
                       1)
        in_bytes = bytes_of(*args[:12]) + bytes_of(counts_k, rem_k)
        ops = SCORE_OPS * n * b
        bms, by = bound_ms(in_bytes, ops)
        placed = int(counts_k.sum())
        log(f"waterfill N={n} B={b} jd={jd} td={td}: equal, placed={placed} "
            f"kernel_ms={k_ms:.4f} profiler_kernel_ms={fmt_ms(prof_ms)} "
            f"wrapper_ms={w_ms:.4f} plain_ms={p_ms:.2f} "
            f"bound_ms={bms:.6f} ({by})")
        results["waterfill"][(n, b, jd, td)] = dict(
            ms=k_ms, profiler_ms=prof_ms, wrapper_ms=w_ms, plain_ms=p_ms,
            bound_ms=bms, bound_by=by)
    results["waterfill_err"] = worst

    worst = 0
    for n, b, k in GREEDY_SHAPES:
        args = greedy_case(rng, n, b, k, dev)
        out_k = greedy.solve_greedy_batched_shared(*args)
        out_p = greedy.solve_greedy_batched_shared_plain(*args)
        torch.cuda.synchronize()
        err = max(int((out_k[0] - out_p[0]).abs().max()),
                  int((out_k[1] != out_p[1]).sum()))
        worst = max(worst, err)
        if not all(torch.equal(x, y) for x, y in zip(out_k, out_p)):
            raise AssertionError(
                f"greedy kernel != plain at N={n} B={b} k={k}: "
                f"idx max abs err {err}")
        raw = greedy.kernel_only(*args)
        k_ms = cuda_ms(raw, 10)
        prof_ms = profiler_ms(raw, 10, "greedy_kernel")
        w_ms = cuda_ms(lambda: greedy.solve_greedy_batched_shared(*args), 10)
        p_ms = host_ms(
            lambda: greedy.solve_greedy_batched_shared_plain(*args), 1)
        in_bytes = bytes_of(*args[:12]) + bytes_of(*out_k)
        ops = SCORE_OPS * n * b * k
        bms, by = bound_ms(in_bytes, ops)
        log(f"greedy N={n} B={b} k={k}: equal, placed="
            f"{int(out_k[1].sum())} kernel_ms={k_ms:.4f} "
            f"profiler_kernel_ms={fmt_ms(prof_ms)} wrapper_ms={w_ms:.4f} "
            f"plain_ms={p_ms:.2f} bound_ms={bms:.6f} ({by})")
        results["greedy"][(n, b, k)] = dict(
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


def build_cluster():
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.harness import Harness
    from nomad_tpu_torch.structs import Node, Resources

    h = Harness()
    h.planner = FixedStatePlanner(h)
    for i in range(N_NODES):
        h.state.upsert_node(h.next_index(), Node(
            id=f"node-{i:05d}",
            datacenter="dc1" if i % 2 == 0 else "dc2",
            name=f"n{i}",
            attributes={"kernel.name": "linux", "driver.exec": "1"},
            resources=Resources(cpu=4000, memory_mb=8192,
                                disk_mb=100 * 1024, iops=150),
            status=structs.NODE_STATUS_READY,
        ))
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


def phase_headline(h, dev):
    import torch
    from nomad_tpu_torch import structs, trace
    from nomad_tpu_torch.ops import greedy, waterfill

    job = make_job("bench-batch", structs.JOB_TYPE_BATCH, N_TASKS, ["dc1"])
    e2e, stage_ms = [], []
    waterfill.LAUNCHES = 0
    greedy.LAUNCHES = 0
    for i in range(1 + TIMED_EVALS):
        ev = register_eval(h, job)
        span = StageSpan()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with trace.use_span(span):
            h.process("tpu-batch", ev, device=dev)
        wall = (time.perf_counter() - t0) * 1000.0
        placed = check_plan(h.state, h.plans[-1], job, N_TASKS)
        if h.evals[-1].status != structs.EVAL_STATUS_COMPLETE:
            raise AssertionError(f"eval status {h.evals[-1].status}")
        if i:
            e2e.append(wall)
            stage_ms.append(span.ms)
        log(f"headline eval {i}{' (warm-up)' if i == 0 else ''}: "
            f"placed={placed} e2e_ms={wall:.2f} stages_ms="
            + json.dumps({k: round(v, 3) for k, v in span.ms.items()}))
    launches = waterfill.LAUNCHES
    if launches == 0:
        raise AssertionError("the headline eval never launched the "
                             "water-fill kernel")
    solve = [sum(s.values()) for s in stage_ms]
    p50 = float(np.median(solve))
    e2e_p50 = float(np.median(e2e))
    stages_p50 = {k: float(np.median([s.get(k, 0.0) for s in stage_ms]))
                  for k in ("staging", "transfer", "execute", "readback")}
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
    ev = register_eval(h, job)
    greedy.LAUNCHES = 0
    t0 = time.perf_counter()
    h.process("tpu-service", ev, device=dev)
    wall = (time.perf_counter() - t0) * 1000.0
    launches = greedy.LAUNCHES
    placed = check_plan(h.state, h.plans[-1], job, SERVICE_COUNT)
    if launches == 0:
        raise AssertionError("the service eval never launched the greedy "
                             "kernel")
    log(f"service: placed={placed} e2e_ms={wall:.2f} "
        f"greedy_launches={launches}")
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
    after = SOLVER_PANEL.snapshot()["batch_widths"]
    widths = {w: row["dispatches"] - before.get(w, {}).get("dispatches", 0)
              for w, row in after.items()}
    widths = {w: d for w, d in widths.items() if d}
    if launches == 0:
        raise AssertionError("the burst never launched the water-fill")
    log(f"burst: {BURST_EVALS} evals x {BURST_TASKS} tasks placed={placed} "
        f"wall_ms={wall:.2f} waterfill_launches={launches} "
        f"dispatch_widths={json.dumps(widths)}")


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
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. kernels vs plain
    kres = phase_kernels(dev, rng)

    # 3-5. the main path
    t0 = time.perf_counter()
    h = build_cluster()
    log(f"cluster: {N_NODES} nodes in {time.perf_counter() - t0:.1f}s")
    wf_launches = phase_headline(h, dev)
    gr_launches = phase_service(h, dev)
    phase_burst(h, dev)

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
