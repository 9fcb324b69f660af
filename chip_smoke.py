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
   job, each 1 warm-up and 2 timed rounds of register (through a
   follower) -> complete -> deregister -> complete, with the time until
   every member has applied each and check_committed on every member's
   store; then 8 batch jobs of 12,500 tasks through the leader, the
   leader shut down at a seeded point of their flight, and every eval
   complete on the survivors with exactly 12,500 live tasks per job on
   dc1 and no node over capacity, on both survivors' stores.
8. simcluster: the port's scenario runner (nomad_tpu_torch.simcluster)
   runs steady-10k (24 service jobs x 420 tasks paced over ~18 s against
   10,000 beating nodes, with node-refresh writes) and burst-100k (8
   batch jobs x 12,500 tasks at once on the same fleet), each through a
   ClusterServer and loopback RPC on the card, seed 42. Each run must
   place every task (10,080 and 100,000), complete every eval, keep
   every node within its capacity in the leader's store, launch the
   water-fill, and give the canonical event digest that nomad_tpu's
   runner gave on the same scenario and seed
   (nomad_tpu_torch/simcluster/reference_digests.json). steady-10k runs
   its profiler-off contrast arm too, which must give the same digest;
   its profiled arm (the lock watchdog installed) must carry role wall
   shares, a lock-contention table with no lock-order violation and the
   byte ledger's 1M-row projection. Logs registration nodes/s,
   placements/s, plan and eval latency, device dispatches, window and
   wall seconds, the span stage p50s, the profiler's overhead on plan
   p50, the byte ledger (per-row bytes, the projection, the CUDA bytes
   of the resident mirrors) and the role shares.
9. system: BASELINE config 4 (bench.py run_config4) through the port's
   tpu-system scheduler: the same 10,000 nodes and a system job on dc1
   (kernel.name = linux, 50 MHz / 64 MB), 1 warm-up and 5 timed evals,
   each on a fresh alloc-free store, verified (evaluate_plan) and
   committed columnar; every eval must commit one task on each of the
   5,000 dc1 nodes and none elsewhere (check_committed). Logs e2e p50,
   placements/s and the one fit dispatch's ms apart from verify and
   commit.
10. agent: the head of the main path. The port's Agent in server mode
   (one ClusterServer member, RPC and HTTP on port 0) on the card, the
   10,000 nodes over RPC from a beating SimFleet, and the headline,
   service and system jobs as HCL files, each 1 warm-up and 3 timed
   rounds of ``cli.main(["run", "-detach", file])`` -> complete (HTTP
   blocking queries) -> ``stop -detach`` -> complete, checked through
   /v1/job/:id/allocations and check_committed; one monitored ``run``;
   then ``python -m nomad_tpu_torch agent -config`` as a subprocess with
   ``run`` and ``status`` subprocesses against it, /v1/agent/self naming
   the card, stopped by SIGINT with exit code 0. Logs register->complete
   and stop->complete p50 per job and the ms to read the headline's
   100,000 alloc stubs over HTTP.
11. client: node agents run what the card placed. The same server-mode
   Agent and beating SimFleet, and CLIENT_NODES real Clients
   (nomad_tpu_torch.client) in this process over RPC, each registering
   with the GPU fingerprint's attributes (held to torch.cuda's), with
   mock_driver and raw_exec enabled. Every job asks $attr.driver.gpu = 1,
   so only the clients take it: client-batch (256 mock tasks of 0.2 s,
   1 + 2 rounds, one water-fill each) must end 256 allocs dead with exit
   0 on the GPU nodes; client-service (8 raw_exec /bin/sleep tasks
   through spawn daemons, the greedy scan) must run, then after
   ``stop -detach`` leave no daemon or task pid; client-fail (2 tasks
   that exit 3 under a batch restart policy of 2 attempts) must end
   failed after 3 starts each. Logs placement->running and
   register->all-dead p50, stop->pids-gone, the Node.UpdateAlloc round
   trip and spawn start p50, the fingerprint and register ms and the
   clients' shutdown seconds. Then ``python -m nomad_tpu_torch agent
   -dev`` on the card (the GPU fingerprint on in its config file) runs a
   one-task raw_exec job through ``run``, ``status`` and
   ``alloc-status`` subprocesses (dead, exit 0, its stdout in the alloc
   dir), lists its server through ``client-config -servers`` and exits 0
   on SIGINT.
12. planes: the server's front door and fast lanes through the port's
   scenario runner on the card (seed 42, the attribution layer on, no
   contrast arm): express-1k (the greedy scan), express-mix (a ~300-task
   express stream placed in-line by the leader beside steady-10k's
   service load), overdrive-100k (5 impolite clients offering 250 jobs
   of 400 tasks to admission control) and read-storm (steady-10k's load
   on a three-member cell while an impolite read fleet rides the
   followers' HTTP fronts on the stale and linearizable lanes). Each must
   give nomad_tpu's canonical digest, respect every queue cap, admit and
   reject what nomad_tpu's door did, commit or reconcile every express
   placement, and keep the read lanes' promises; every job's tasks are
   committed and every eval complete. Logs plan p50/p95, submit->placed,
   its stage waterfall and the SLO verdicts, express submit->placed
   p50/p95 (and the lane's own p50/p99), the lane's commits, bounces and
   fallbacks, admission by reason, the follower serve share and lane
   counts, and the launches.
13. recovery: the recovery and chaos slice through the port's scenario
   runner on the card (seed 42, each at its registry size):
   churn-fragmentation (600 nodes, 18 x 1000 fill tasks, half
   deregistered, 3 x 150 probes, the capacity accountant polled every
   0.25 s) with its capacity-off contrast arm, which must give the same
   digest; restart-under-load (10,000 nodes, steady-10k's load, a
   durable raft log compacted every 64 entries, the leader killed at
   t=9 s and restarted from its data dir on the same port);
   rack-failure, partition-flap and follower-crash-rejoin (the chaos
   families of simcluster/chaos.py). Each must give nomad_tpu's digest,
   each family's chaos verdict must be ok with its named checks (a real
   multi-chunk InstallSnapshot for the rejoin), every pre-kill placement
   must survive the restart with a populated recovery timeline, and
   every registered job's tasks are committed within every node's
   capacity. Logs the recovery timeline, the write-path stage p50s by
   message type, stranded capacity and placeable counts before and after
   the deregistration, the chaos checks and fault books, plan p50/p95,
   placements/s, wall and the launches.
14. operator: the agent's operator surface. A port Agent in server mode
   built from a config file (telemetry { statsd_address = a UDP port
   this script binds, lock_watchdog = true, histogram_buckets },
   enable_debug, server { profile { enabled = true } }), the 10,000
   nodes over RPC from a beating SimFleet, and the headline and the
   count-100 service job through the SDK, each 1 warm-up and 2 timed
   rounds of register -> complete -> deregister -> complete. Then
   /v1/agent/metrics (JSON, and its Prometheus scrape parsed line by line
   with nomad_tpu's families and the configured buckets), the statsd
   lines, /v1/agent/solver (both kernels' solves), /v1/agent/runtime and
   /profile in every format, capacity/raft/reads as Prometheus text,
   /v1/agent/debug and the debug bundle's every section, and no
   lock-order violation. Logs the ten lock sites with the most wait, the
   raft and store locks over each headline deregister, the profiler's
   role shares over each job's rounds and the scrape's size and time.
15. mesh: the solver mesh (nomad_tpu_torch.parallel). (a) The node-shard
   water-fill (csrc/waterfill_shard.cu) and the greedy merge
   (csrc/greedy.cu) against their plain versions on CUDA tensors, and
   each sharded solve against the unsharded kernel, exactly, at S = 1, 2,
   4 and 8 shards on the card (each shard its own tensor), at the
   headline bucket (16384 rows) and the 131072-row one, B in {1, 8}, and
   the edge cases (MESH_WF_SHAPES, MESH_GREEDY_SHAPES); logs the sharded
   and unsharded solve ms per S, the rounds a solve and the merge ms.
   (b) configure_node_sharding(4, devices=[cuda:0] * 4), then the
   headline, the count-100 service job and config 4 through
   new_scheduler(..., device="cuda"), 1 warm-up and 2 timed evals each:
   every plan checked, the per-node counts equal to the unsharded run's,
   no node tensor resharded on the evals after the warm-up, the shard
   kernels launched and the unsharded water-fill not; then a Server with
   solver_mesh { node_shards = 4 } on the one card logs the too-few-cards
   warning and places the service job single-device on the card. (c) Two
   DCN ranks on the one card over gloo (spawn_dcn_workers), 256 and
   16,384 nodes: both ranks ok, their counts equal to the unsharded
   kernel's.
16. secure: TLS, the uplink, the native verifier and the fuzz oracle.
   Certificates from the openssl CLI (a CA, a loopback-SAN server pair,
   a client pair, a pair from a CA nothing trusts). (a) A three-member
   ClusterServer cell over mutual TLS (raft, forwarding and the pools
   too): a plaintext dial and the untrusted pair refused, the client pair
   answered; the 10,000 nodes, the headline and the count-100 service job
   through a follower, committed on every member (the headline is not
   deregistered); one real Client over TLS runs 4 mock_driver tasks to
   dead; the plan verifier's native fit_check called. (b) A server-mode
   Agent from a config file (tls { uplink = true }, atlas { endpoint })
   dials an UplinkBroker over mutual TLS; the headline is registered
   through the tunnel, its 100,000 alloc stubs read back through it, and
   a blocking query parked through it wakes on a second registration.
   (c) The native library (nomad_tpu_torch/native, built with c++ at
   first use) against its plain version, exactly, on the cell's 10,000
   verifier rows. (d) solve_rounds_fused (plain torch on the card)
   against the water-fill kernel at the headline shape and the 60 fuzz
   seeds of tests/test_fuzz_differential.py: equal, or inside the pow
   contract's 256-ulp band with equal totals and sound counts (the band
   count is logged). Logs each job's register->complete ms, the stub
   read's ms, native and plain fit_check us, the oracle's ms.
17. update: the job-update path. (a) BASELINE config 5 (bench.py
   run_config5) through the harness, plans verified and committed
   columnar: 50,000 dc1 nodes (a 65,536-row mirror), a service job of
   10,000 tasks placed by the water-fill; a cpu bump updates all 10,000
   in place (AllocUpdateBatch, no kernel launch, no stop, no placement);
   an env change's first rolling eval stops and places max_parallel =
   1,000 through the water-fill with the anti-affinity penalty weighing
   the survivors, and creates one follow-up eval of wait 10 s. Logs the
   in-place and rolled updates/s as bench.py prints them. (b) The same
   place, bump and whole roll through one Server (the follow-up evals
   wait 1 s in the broker, a depth cut of the 10 s stagger): ten rolling
   evals, every eval of the job complete once, 10,000 live tasks of the
   new version and none of the old, check_committed. (c) On phase 6's
   10,000 nodes, each given one IP and port 22 reserved: the count-100
   service job placed, 10 of its nodes drained (replacements through the
   greedy scan, none left on a drained node), then a count-20 service
   job asking two dynamic ports and one reserved port (every port
   distinct on its node and outside the reserved set). (d)
   steady-100k-nodes through run_checked, held to nomad_tpu's digest, its
   solves on the 131,072-row mirror; logs its plan p50/p95 and
   registration nodes/s beside steady-10k's.

Every phase logs ``phase N: <s> s``, and the script its total.

Each path's launch counts are set to 0 just before it runs and read just
after; a kernel of the path that was never launched fails the run. The
line before the last is one JSON object with every kernel's numbers, the
last {"ok": true, "device": {...}}. Any failure raises: the exit code is
then non-zero and no result is printed. Needs one CUDA card; imports
nothing of jax or nomad_tpu.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# "config5" is BASELINE config 5's placement: 50,000 of those nodes in the
# 65,536-row bucket and its 10,000 service tasks (penalty 10);
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
             (65536, 1, False, False, "config5"),
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
        if mode == "config5":
            row = headline_arrays(n, min(n, CONFIG5_NODES))
            count, penalty = CONFIG5_TASKS, 10.0
        elif mode in ("headline", "ties"):
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
            "config5": bool((left == 0).all()),
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


def make_job(name: str, typ: str, count: int, dcs, cpu: int = 100,
             mem: int = 128, job_id: str = ""):
    from nomad_tpu_torch.structs import (
        Constraint, Job, Resources, RestartPolicy, Task, TaskGroup,
        generate_uuid,
    )

    return Job(
        region="global", id=job_id or generate_uuid(), name=name, type=typ,
        priority=50, datacenters=list(dcs),
        constraints=[Constraint(l_target="$attr.kernel.name",
                                r_target="linux", operand="=")],
        task_groups=[TaskGroup(
            name="work", count=count,
            restart_policy=RestartPolicy(attempts=1, interval=600.0,
                                         delay=5.0),
            tasks=[Task(name="work", driver="exec",
                        resources=Resources(cpu=cpu, memory_mb=mem))],
        )],
    )


def job_hcl(name: str, typ: str, count: int, dcs, cpu: int = 100,
            mem: int = 128) -> str:
    """make_job's job as a jobspec file; its id is its name."""
    datacenters = ", ".join(f'"{dc}"' for dc in dcs)
    return f"""job "{name}" {{
    region = "global"
    type = "{typ}"
    priority = 50
    datacenters = [{datacenters}]

    constraint {{
        attribute = "$attr.kernel.name"
        value = "linux"
    }}

    group "work" {{
        count = {count}

        restart {{
            attempts = 1
            interval = "10m"
            delay = "5s"
        }}

        task "work" {{
            driver = "exec"

            resources {{
                cpu = {cpu}
                memory = {mem}
            }}
        }}
    }}
}}
"""


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


def committed_usage(snap, job_id: str = ""):
    """From a state snapshot: each node's summed live asks of all jobs
    (int64 [4] by node id), and each node's live task count of
    ``job_id`` (numpy over the stored blocks' runs and the object rows)."""
    usage, job_nodes = {}, {}

    def add(nid, vec, cnt, own):
        usage[nid] = usage.get(nid, 0) + vec * cnt
        if own:
            job_nodes[nid] = job_nodes.get(nid, 0) + cnt

    for blk in snap.alloc_blocks():
        vec = np.asarray(blk.resource_vector(), dtype=np.int64)
        for nid, cnt in blk.live_node_counts():
            add(nid, vec, int(cnt), blk.job_id == job_id)
    for a in snap.allocs_objects():
        if not a.terminal_status():
            add(a.node_id, np.asarray(a.resources.as_vector(),
                                      dtype=np.int64), 1, a.job_id == job_id)
    return usage, job_nodes


def check_committed(snap, job, want: int, per_node: int = 0) -> int:
    """From a state snapshot: ``job`` holds ``want`` live tasks, all on
    nodes of its datacenters with kernel.name=linux (make_job's
    constraint), and every node's summed live asks of all jobs plus its
    reserved resources fit its capacity (numpy over the stored blocks'
    runs and the object rows). With ``per_node`` (a system job: 1), every
    node that holds the job holds exactly that many. Returns the live
    count."""
    usage, job_nodes = committed_usage(snap, job.id)
    live = sum(job_nodes.values())
    if live != want:
        raise AssertionError(f"{live} live tasks of job {job.name} "
                             f"committed, want {want}")
    if per_node and any(c != per_node for c in job_nodes.values()):
        raise AssertionError(f"a node holds other than {per_node} task(s) "
                             f"of job {job.name}")
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


def new_server(dev, nodes=None, **kw):
    """A started Server (prewarm_shapes on, its default) holding
    ``nodes`` (the 10,000 nodes by default), returned once its start-time
    warmer has warmed them: the warmer's dispatch count is watched, not a
    sleep."""
    from nomad_tpu_torch.server.server import Server, ServerConfig

    nodes = nodes or cluster_nodes()
    srv = Server(ServerConfig(scheduler_backend="tpu", device=str(dev),
                              min_heartbeat_ttl=SERVER_HEARTBEAT_TTL_S,
                              **kw))
    srv.start()
    t0 = time.perf_counter()
    srv.node_batch_register(nodes)
    t1 = time.perf_counter()
    log(f"server: {len(nodes)} nodes by node_batch_register in "
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
# 3 until the operator phase was added; cut to 2 to keep the script's
# command time near 600 s (each round carries a headline deregister).
CLUSTER_ROUNDS = 2
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


# -- simcluster --------------------------------------------------------------

SIM_SCENARIOS = ("steady-10k", "burst-100k")
SIM_DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "nomad_tpu_torch", "simcluster",
                           "reference_digests.json")
SIM_REF_KEYS = ("by_type", "digest", "evals_injected", "heartbeat_timers",
                "placed", "plans_applied", "reproduced", "seed")


def load_reference_digests(path: str = SIM_DIGESTS):
    """nomad_tpu's canonical digests per scenario, from the committed file;
    every entry must carry SIM_REF_KEYS."""
    with open(path) as f:
        data = json.load(f)
    scenarios = data.get("scenarios")
    if not data.get("nomad_tpu_commit") or not scenarios:
        raise AssertionError(f"{path} names no nomad_tpu commit or no "
                             "scenario")
    for name, ref in scenarios.items():
        missing = [k for k in SIM_REF_KEYS if k not in ref]
        if missing:
            raise AssertionError(f"{path}: {name} lacks {missing}")
    return scenarios


def check_scenario(art, ref) -> bool:
    """Hold one run's artifact to nomad_tpu's reference entry: every task
    placed, every injected eval planned, the fleet's timers armed, no
    event lost to the ring, and, where nomad_tpu reproduced its own
    digest, the same digest and per-type counts; where its runs gave
    several (``digests_seen``), one of them. Returns whether the digest
    was compared."""
    name = art["scenario"]
    got = art["placements"]
    for key in ("placed", "evals_injected", "plans_applied"):
        if got[key] != ref[key]:
            raise AssertionError(f"{name}: {key}={got[key]}, nomad_tpu "
                                 f"{ref[key]}")
    if art["heartbeat"]["timers"] != ref["heartbeat_timers"]:
        raise AssertionError(f"{name}: {art['heartbeat']['timers']} "
                             f"heartbeat timers, want "
                             f"{ref['heartbeat_timers']}")
    if art["events"]["truncated"]:
        raise AssertionError(f"{name}: the event ring truncated")
    # Where nomad_tpu's own runs disagreed, the port's digest must be one
    # of those it gave (digests_seen); with none listed, nothing to hold.
    seen = ({ref["digest"]: ref} if ref["reproduced"]
            else ref.get("digests_seen"))
    if not seen:
        return False
    want = seen.get(art["events"]["digest"])
    if want is None or art["events"]["by_type"] != want["by_type"]:
        raise AssertionError(
            f"{name}: canonical digest {art['events']['digest']} "
            f"{art['events']['by_type']}, nomad_tpu "
            + "; ".join(f"{d} {r['by_type']}" for d, r in seen.items()))
    return True


def check_profile(name: str, art) -> None:
    """The profiled arm's profile section: enabled, role wall shares, a
    non-empty lock-contention table with no lock-order violation, and the
    mirror byte ledger's 1M-row projection."""
    prof = art.get("profile") or {}
    if not prof.get("enabled"):
        raise AssertionError(f"{name}: the profile section is not enabled")
    roles = prof["profiler"]["roles"]
    if not roles or not any(r["wall_share"] for r in roles.values()):
        raise AssertionError(f"{name}: no role wall shares {roles}")
    locks = prof["locks"]
    if not locks.get("installed") or not locks.get("contention"):
        raise AssertionError(f"{name}: no lock-contention table {locks}")
    if locks["violations"]:
        raise AssertionError(f"{name}: {locks['violations']} lock-order "
                             "violations")
    if not prof["bytes"]["mirror"].get("projected_1m_bytes"):
        raise AssertionError(f"{name}: the byte ledger has no 1M-row "
                             f"projection {prof['bytes']['mirror']}")


def run_checked(name: str, spec, dev, refs):
    """One arm of one scenario on the card: held to nomad_tpu's digest,
    every job's tasks committed within capacity, every eval complete.
    Returns (artifact, water-fill launches, span stages, digest
    compared)."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import waterfill
    from nomad_tpu_torch.simcluster.scenario import ScenarioRunner

    runner = ScenarioRunner(spec, seed=SEED, device=str(dev))
    waterfill.LAUNCHES = 0
    art = runner.run()
    launches = waterfill.LAUNCHES
    if launches == 0:
        raise AssertionError(f"simcluster {name} never launched the "
                             "water-fill kernel")
    compared = check_scenario(art, refs[name])
    snap = runner._srv.state_store.snapshot()
    stages = []
    for job in runner._jobs.values():
        check_committed(snap, job, job.task_groups[0].count)
        for ev in snap.evals_by_job(job.id):
            if ev.status != structs.EVAL_STATUS_COMPLETE:
                raise AssertionError(f"simcluster {name}: eval {ev.id} "
                                     f"of {job.id} ended {ev.status}")
            stages.append(eval_stages(ev.id))
    return art, launches, stages, compared


def phase_simcluster(dev, card: str, names=SIM_SCENARIOS):
    """Each scenario of ``names`` through the port's scenario runner on
    the card, held to nomad_tpu's digest and to the committed allocs of
    the leader's store; a scenario with a contrast arm (steady-10k's
    profiler-off arm) runs it too, and it must give the same digest. The
    profiled arm's profile section is checked (check_profile). Returns
    the water-fill launches of the phase."""
    from nomad_tpu_torch.simcluster.scenario import (
        SCENARIOS,
        _contrast_spec,
        profiler_overhead,
    )
    from nomad_tpu_torch.tpu.mirror import GLOBAL_MIRROR_CACHE

    refs = load_reference_digests()
    total = 0
    for name in names:
        spec = SCENARIOS[name]
        art, launches, stages, compared = run_checked(name, spec, dev, refs)
        total += launches
        check_profile(name, art)
        mirror = art["profile"]["bytes"]["mirror"]
        log(f"simcluster {name}: byte ledger per_row_bytes="
            f"{mirror['per_row_bytes']} padded_rows={mirror['padded_rows']} "
            f"projected_1m_rows={mirror['projected_1m_rows']} "
            f"projected_1m_bytes={mirror['projected_1m_bytes']} "
            f"by_bucket_dtype={json.dumps(mirror['by_bucket_dtype'])} "
            f"cuda_bytes_of_resident_mirrors="
            f"{GLOBAL_MIRROR_CACHE.device_bytes()} [{card}]")
        log(f"simcluster {name}: role wall shares " + json.dumps(
            {r: v["wall_share"]
             for r, v in art["profile"]["profiler"]["roles"].items()})
            + f" lock sites timed {len(art['profile']['locks']['contention'])}"
            " violations 0")
        if spec.contrast_overrides is not None:
            off, off_launches, _st, _c = run_checked(
                name, _contrast_spec(spec), dev, refs)
            total += off_launches
            if off["events"]["digest"] != art["events"]["digest"]:
                raise AssertionError(
                    f"simcluster {name}: the contrast arm's digest "
                    f"{off['events']['digest']} is not the main arm's")
            if off["profile"] != {"enabled": False}:
                raise AssertionError(f"{name}: the profiler-off arm profiled")
            log(f"simcluster {name}: profiler-off arm digest equal, "
                f"waterfill_launches={off_launches}, wall_seconds="
                f"{off['wall_seconds']}, profiler_overhead "
                + json.dumps(profiler_overhead(art, off)) + f" [{card}]")
        pl, reg = art["placements"], art["registration"]
        SIM_NUMBERS[name] = sim_numbers(art)
        rows = [
            f"registration nodes_per_s={reg['nodes_per_sec']} "
            f"seconds={reg['seconds']} batches={reg['batches']}",
            f"placed={pl['placed']} placements_per_s="
            f"{pl['placements_per_sec']}",
            "plan_latency_ms p50={p50_ms} p95={p95_ms} max={max_ms} "
            "n={n}".format(**art["plan_latency_ms"]),
            f"eval_latency_ms p50={art['eval_latency_ms']['p50_ms']} "
            f"n={art['eval_latency_ms']['n']}",
            f"device_dispatches={pl['device_dispatches']} "
            f"waterfill_launches={launches}",
            f"window_seconds={pl['window_seconds']} "
            f"wall_seconds={art['wall_seconds']}",
            "stage p50 ms " + json.dumps(
                {k: round(p50([s.get(k, 0.0) for s in stages]), 3)
                 for k in SERVER_STAGES}),
            f"digest={art['events']['digest']} "
            f"{'equals' if compared else 'not compared with'} nomad_tpu's",
            "peaks " + json.dumps(art["peaks"]) + " heartbeat "
            + json.dumps(art["heartbeat"]),
            "plan_pipeline " + json.dumps(
                {k: v for k, v in art["plan_pipeline"].items()
                 if k != "conflict_rate_vs_load"})
            + " mirror " + json.dumps(art["mirror"]),
            "solver_panel window " + json.dumps(
                art["solver_panel"]["window"]),
        ]
        for row in rows:
            log(f"simcluster {name}: {row} [{card}]")
    return total


# -- the front door and the fast lanes -----------------------------------------

# express-1k drives the greedy scan on this path (its 60-task service jobs
# and 100-task warmup); the three 10,000-node scenarios drive the water-fill.
PLANE_SCENARIOS = ("express-1k", "express-mix", "overdrive-100k",
                   "read-storm")


def check_planes(art, ref) -> None:
    """The front door's and the fast lanes' checks on one artifact: every
    queue cap respected, the door admitting and rejecting exactly what
    nomad_tpu's admitted and rejected, every express placement committed
    or reconciled with no lease left, and, where the read plane served,
    no linearizable read older than its read index, no response without
    its freshness stamp and every read-lane objective met."""
    from nomad_tpu_torch import slo

    name = art["scenario"]
    adm = art["admission"]
    if not adm["caps_respected"]:
        raise AssertionError(f"{name}: a queue cap was exceeded (peaks "
                             f"{art['peaks']}, caps {adm['caps']})")
    want = ref.get("admission_injector")
    if want is not None and adm["injector"] != want:
        raise AssertionError(f"{name}: the door gave {adm['injector']}, "
                             f"nomad_tpu {want}")
    lane = (art.get("express") or {}).get("lane")
    if lane is not None:
        if lane["committed"] + lane["reconciled"] != lane["placed"]:
            raise AssertionError(
                f"{name}: {lane['placed']} express placements, "
                f"{lane['committed']} committed and {lane['reconciled']} "
                "reconciled")
        if lane["ledger"]["active"] or lane["backlog"]:
            raise AssertionError(f"{name}: express leases or commits left "
                                 "at quiescence")
    lanes = (art.get("reads") or {}).get("lanes") or {}
    if lanes.get("enabled"):
        if lanes["linear_violations"] or lanes["stamp_missing"]:
            raise AssertionError(
                f"{name}: {lanes['linear_violations']} linearizable reads "
                f"older than their read index, {lanes['stamp_missing']} "
                "responses without a freshness stamp")
        failed = [r["objective"] for r in slo.evaluate_read_lanes(art)
                  if r["met"] is False]
        if failed:
            raise AssertionError(f"{name}: read-lane objectives missed: "
                                 f"{failed}")


def plane_rows(art):
    """The phase's log rows for one artifact: latency, the door, the
    express lane, the read plane."""
    pl = art["plan_latency_ms"]
    adm = art["admission"]
    rows = [
        f"plan_latency_ms p50={pl.get('p50_ms')} p95={pl.get('p95_ms')} "
        f"n={pl['n']}",
        "admission injector " + json.dumps(adm["injector"])
        + " controller admitted=" + str(adm["controller"]["admitted"])
        + " rejected_by_reason=" + json.dumps(
            adm["controller"]["by_reason"])
        + f" caps_respected={adm['caps_respected']}",
    ]
    att = art.get("latency_attribution") or {}
    placed = att.get("submit_to_placed_ms")
    if placed:
        rows.append("submit_to_placed_ms " + json.dumps(placed))
    if att.get("waterfall"):
        rows.append("waterfall mean/p95 ms " + json.dumps(
            {w["stage"]: [w["mean_ms"], w["p95_ms"]]
             for w in att["waterfall"] if w["total_ms"]}))
    if att.get("slo_check"):
        rows.append("slo_check " + json.dumps(
            {r["objective"]: [r["observed_ms"], r["met"]]
             for r in att["slo_check"]}))
    if "express" in art:
        lane = art["express"]["lane"]
        rows.append(
            "express submit_to_placed_ms "
            + json.dumps(att.get("express_placed_ms"))
            + " lane place_ms " + json.dumps(
                {k: lane["place_ms"].get(k)
                 for k in ("count", "p50", "p95", "p99", "max")}))
        rows.append(
            f"express placed={lane['placed']} committed={lane['committed']}"
            f" bounces={lane['bounces']} reconciled={lane['reconciled']}"
            " fallbacks=" + json.dumps(lane["fallbacks"]))
    lanes = (art.get("reads") or {}).get("lanes")
    if lanes and lanes.get("enabled"):
        rows.append(
            f"reads follower_serve_share={lanes['follower_serve_share']} "
            "served=" + json.dumps(lanes["served"])
            + " by_lane=" + json.dumps(lanes["by_lane"])
            + f" stale_reads={lanes['client']['stale_reads']}"
            f" linear_reads={lanes['linear_reads']}"
            f" stale_refused={lanes['stale_refused']}"
            f" linear_refused={lanes['linear_refused']}"
            " stale_age_ms=" + json.dumps(lanes["stale_age_ms"]))
    return rows


def phase_planes(dev, card: str, names=PLANE_SCENARIOS):
    """The server's front door and fast lanes through the port's scenario
    runner on the card (seed 42, contrast arms off, the attribution layer
    on): each scenario held to nomad_tpu's digest (check_scenario), to
    check_planes, and to the committed allocs and complete evals of the
    leader's store. Returns the phase's (water-fill, greedy) launches;
    each kernel must have launched."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import greedy, waterfill
    from nomad_tpu_torch.simcluster.scenario import SCENARIOS, ScenarioRunner

    refs = load_reference_digests()
    wf_total = gr_total = 0
    for name in names:
        runner = ScenarioRunner(SCENARIOS[name], seed=SEED, device=str(dev),
                                attribution_layer=True)
        waterfill.LAUNCHES = 0
        greedy.LAUNCHES = 0
        art = runner.run()
        wf, gr = waterfill.LAUNCHES, greedy.LAUNCHES
        wf_total += wf
        gr_total += gr
        compared = check_scenario(art, refs[name])
        check_planes(art, refs[name])
        snap = runner._srv.state_store.snapshot()
        jobs = list(runner._jobs.values())
        for job in jobs:
            want = sum(tg.count for tg in job.task_groups)
            live = [a for a in snap.allocs_by_job(job.id)
                    if not a.terminal_status()]
            if len(live) != want:
                raise AssertionError(f"planes {name}: job {job.id} holds "
                                     f"{len(live)} live tasks, want {want}")
            for ev in snap.evals_by_job(job.id):
                if ev.status != structs.EVAL_STATUS_COMPLETE:
                    raise AssertionError(f"planes {name}: eval {ev.id} of "
                                         f"{job.id} ended {ev.status}")
        # Placement, datacenters, constraint and every node's capacity,
        # over the whole store (one pass covers every job's nodes).
        biggest = max(jobs, key=lambda j: j.task_groups[0].count)
        check_committed(snap, biggest, biggest.task_groups[0].count)
        pl = art["placements"]
        rows = [
            f"placed={pl['placed']} placements_per_s="
            f"{pl['placements_per_sec']} evals={pl['evals_injected']} "
            f"plans={pl['plans_applied']}",
            *plane_rows(art),
            f"waterfill_launches={wf} greedy_launches={gr} "
            f"device_dispatches={pl['device_dispatches']}",
            f"window_seconds={pl['window_seconds']} "
            f"wall_seconds={art['wall_seconds']}",
            f"digest={art['events']['digest']} "
            f"{'equals' if compared else 'not compared with'} nomad_tpu's",
        ]
        for row in rows:
            log(f"planes {name}: {row} [{card}]")
    log(f"planes: waterfill_launches={wf_total} greedy_launches={gr_total} "
        f"[{card}]")
    if wf_total == 0 or gr_total == 0:
        raise AssertionError("the planes phase launched the water-fill "
                             f"{wf_total} times and the greedy {gr_total}")
    return wf_total, gr_total


# -- recovery and chaos -------------------------------------------------------

# churn-fragmentation (the capacity observatory, with its capacity-off
# contrast arm), restart-under-load (the leader killed and replayed from
# its durable log) and the three chaos families, each at its registry
# size. Counts above 128 take the water-fill; rack-failure's one-task
# jobs and follower-crash-rejoin's 120-task jobs take the greedy scan.
RECOVERY_SCENARIOS = ("churn-fragmentation", "restart-under-load",
                      "rack-failure", "partition-flap",
                      "follower-crash-rejoin")
# The named checks each family's chaos section must carry, all ok (a
# name ending in "[" matches a check per storm site).
CHAOS_CHECKS = {
    "rack-failure": ("exactly_once_replacement", "all_killed_expired"),
    "partition-flap": ("no_duplicate_plans", "leader_stable",
                       "storm_transitions["),
    "follower-crash-rejoin": ("rejoin_digest_equal",
                              "require_install_snapshot"),
}
RECOVERY_TIMELINE = ("snapshot_restore_ms", "entries_replayed",
                     "replay_entries_per_s", "time_to_leader_ms",
                     "time_to_serving_ms")


def check_recovery(art, contrast=None) -> None:
    """The slice's own verdicts on one artifact: each chaos family's
    section ok with its named checks (a real multi-chunk install for the
    rejoin), the leader restart's pre-kill placements all back on their
    nodes with a populated recovery timeline, and the capacity-off arm
    (``contrast``, an artifact) on the main arm's digest."""
    name = art["scenario"]
    want = CHAOS_CHECKS.get(name)
    if want is not None:
        chaos = art.get("chaos") or {}
        if chaos.get("ok") is not True:
            raise AssertionError(f"{name}: chaos verdict {chaos}")
        checks = {c["check"]: c for c in chaos["checks"]}
        for check in want:
            hits = [c for n, c in checks.items()
                    if n == check or (check.endswith("[")
                                      and n.startswith(check))]
            if not hits or not all(c["ok"] for c in hits):
                raise AssertionError(f"{name}: check {check} missing or "
                                     f"failed: {chaos['checks']}")
        if name == "follower-crash-rejoin":
            chunks = checks["require_install_snapshot"]["chunks_received"]
            if chunks <= 1:
                raise AssertionError(f"{name}: the rejoin received "
                                     f"{chunks} snapshot chunk(s)")
    raft = art.get("raft") or {}
    if name == "restart-under-load":
        restart = raft.get("restart") or {}
        if not restart.get("placements_survived"):
            raise AssertionError(f"{name}: pre-kill placements lost: "
                                 f"{restart}")
        recovery = raft["recovery"]
        if not recovery.get("cold_start") or any(
                recovery.get(k) is None for k in RECOVERY_TIMELINE):
            raise AssertionError(f"{name}: recovery timeline {recovery}")
    if contrast is not None:
        if contrast["capacity"] != {"enabled": False}:
            raise AssertionError(f"{name}: the contrast arm ran the "
                                 "capacity observatory")
        if (contrast["events"]["digest"] != art["events"]["digest"]
                or contrast["events"]["by_type"]
                != art["events"]["by_type"]):
            raise AssertionError(
                f"{name}: the capacity-off arm gave "
                f"{contrast['events']['digest']}, the main arm "
                f"{art['events']['digest']}")


def check_recovery_store(name: str, runner) -> None:
    """The leader's store after the run: every registered job holds its
    count live, a deregistered one nothing, and no node over capacity."""
    snap = runner._srv.state_store.snapshot()
    biggest, most = None, -1
    for job in runner._jobs.values():
        registered = snap.job_by_id(job.id) is not None
        want = sum(tg.count for tg in job.task_groups) if registered else 0
        live = sum(1 for a in snap.allocs_by_job(job.id)
                   if not a.terminal_status())
        if live != want:
            raise AssertionError(f"recovery {name}: job {job.id} holds "
                                 f"{live} live tasks, want {want}")
        if want > most:
            biggest, most = job, want
    check_committed(snap, biggest, most)


def stranded_at(trajectory, t_s: float):
    """The last capacity sample taken at or before ``t_s`` seconds into the
    window: {shape: [stranded %, placeable]}."""
    rows = [s for s in trajectory if s["t_s"] <= t_s]
    if not rows:
        return None
    s = rows[-1]
    return {shape: [s["stranded"][shape], s["placeable"][shape]]
            for shape in sorted(s["stranded"])}


def recovery_rows(name: str, art, spec):
    """The phase's log rows for one artifact: plan latency, placements/s
    and wall; the write-path stage p50s by message type; the recovery
    timeline; stranded capacity before and after the deregistration; the
    chaos checks."""
    pl = art["placements"]
    lat = art["plan_latency_ms"]
    rows = [
        f"placed={pl['placed']} placements_per_s={pl['placements_per_sec']}"
        f" plan_latency_ms p50={lat.get('p50_ms')} p95={lat.get('p95_ms')}"
        f" n={lat['n']} window_seconds={pl['window_seconds']} "
        f"wall_seconds={art['wall_seconds']}",
    ]
    raft = art.get("raft") or {}
    for msg_type, books in sorted((raft.get("write_path") or {}).items()):
        rows.append(
            f"write_path {msg_type} n={books['count']} total_p50_ms="
            f"{books['total_ms'].get('p50')} stage_p50_ms " + json.dumps(
                {st: b.get("p50") for st, b in books["stages_ms"].items()}))
    recovery = raft.get("recovery") or {}
    if recovery.get("cold_start"):
        rows.append("recovery " + json.dumps(
            {k: recovery.get(k) for k in RECOVERY_TIMELINE
             + ("replayed_by_type", "replay_wall_ms", "snapshot_index")}))
        rows.append("restart " + json.dumps(raft.get("restart")))
    cap = art.get("capacity") or {}
    inj = spec.injectors(SEED)[0]
    if cap.get("enabled") and hasattr(inj, "dereg_start"):
        before = stranded_at(cap["trajectory"], inj.dereg_start)
        after = stranded_at(cap["trajectory"], inj.probe_start)
        rows.append("stranded_pct/placeable before deregistration "
                    + json.dumps(before) + " after " + json.dumps(after))
        acct = cap["final"]["accountant"]
        rows.append(f"capacity polls={acct['polls']} rolls={acct['rolls']}"
                    f" rebuilds={acct['rebuilds']}")
    chaos = art.get("chaos")
    if chaos:
        rows.append("chaos " + json.dumps(
            {c["check"]: {k: v for k, v in c.items() if k != "check"}
             for c in chaos["checks"]}))
        if chaos.get("time_to_rejoin_ms") is not None:
            rows.append(f"time_to_rejoin_ms={chaos['time_to_rejoin_ms']}")
    if art.get("faults"):
        rows.append("faults " + json.dumps(
            {site: [{k: r.get(k) for k in ("mode", "fired", "transitions")}
                    for r in rules]
             for site, rules in art["faults"]["sites"].items()}))
    return rows


def phase_recovery(dev, card: str, names=RECOVERY_SCENARIOS):
    """The recovery and chaos slice through the port's scenario runner on
    the card (seed 42, the attribution layer on): each scenario held to
    nomad_tpu's digest (check_scenario), to check_recovery and to its
    leader's store; churn-fragmentation's capacity-off contrast arm must
    give the main arm's digest. Returns the phase's (water-fill, greedy)
    launches; each kernel must have launched."""
    import torch

    from nomad_tpu_torch.ops import greedy, waterfill
    from nomad_tpu_torch.simcluster.scenario import (
        SCENARIOS,
        ScenarioRunner,
        _contrast_spec,
    )

    refs = load_reference_digests()
    wf_total = gr_total = 0
    for name in names:
        spec = SCENARIOS[name]
        waterfill.LAUNCHES = 0
        greedy.LAUNCHES = 0
        runner = ScenarioRunner(spec, seed=SEED, device=str(dev))
        art = runner.run()
        contrast = None
        if spec.contrast_digest_invariant and spec.contrast_overrides:
            contrast = ScenarioRunner(_contrast_spec(spec), seed=SEED,
                                      device=str(dev)).run()
        wf, gr = waterfill.LAUNCHES, greedy.LAUNCHES
        wf_total += wf
        gr_total += gr
        compared = check_scenario(art, refs[name])
        check_recovery(art, contrast)
        check_recovery_store(name, runner)
        for row in recovery_rows(name, art, spec):
            log(f"recovery {name}: {row} [{card}]")
        log(f"recovery {name}: waterfill_launches={wf} greedy_launches={gr}"
            f" digest={art['events']['digest']} "
            f"{'equals' if compared else 'not compared with'} nomad_tpu's"
            + (f", the capacity-off arm's too (wall "
               f"{contrast['wall_seconds']} s)" if contrast else "")
            + (f"; cuda memory allocated "
               f"{torch.cuda.memory_allocated(dev)} bytes"
               if dev.type == "cuda" else "") + f" [{card}]")
    log(f"recovery: waterfill_launches={wf_total} greedy_launches="
        f"{gr_total} [{card}]")
    if wf_total == 0 or gr_total == 0:
        raise AssertionError("the recovery phase launched the water-fill "
                             f"{wf_total} times and the greedy {gr_total}")
    return wf_total, gr_total


# -- the system scheduler (BASELINE config 4) --------------------------------------

SYSTEM_CPU, SYSTEM_MEM = 50, 64


def system_placed() -> int:
    """bench.py's config 4: the system job on dc1 places one task on each
    dc1 node, every other node of cluster_nodes()."""
    return (N_NODES + 1) // 2


def system_job(job_id: str = ""):
    from nomad_tpu_torch import structs

    return make_job("bench-sys", structs.JOB_TYPE_SYSTEM, 1, ["dc1"],
                    cpu=SYSTEM_CPU, mem=SYSTEM_MEM, job_id=job_id)


class VerifyingPlanner:
    """bench.py's config-4 planner: verify each plan against the store
    (evaluate_plan, as the plan pipeline does) and commit the result
    columnar, as the FSM does. Keeps the verify and commit ms."""

    def __init__(self, state, index: int):
        self.state = state
        self.index = index
        self.verify_ms = 0.0
        self.commit_ms = 0.0

    def submit_plan(self, plan):
        from nomad_tpu_torch.server.plan_apply import evaluate_plan

        t0 = time.perf_counter()
        result = evaluate_plan(self.state.snapshot(), plan)
        t1 = time.perf_counter()
        result.alloc_index = self.index
        allocs = [a for lst in result.node_update.values() for a in lst]
        allocs += [a for lst in result.node_allocation.values() for a in lst]
        if allocs:
            self.state.upsert_allocs(self.index, allocs)
        if result.alloc_batches:
            self.state.upsert_alloc_blocks(self.index, result.alloc_batches)
        if result.update_batches:
            self.state.apply_update_batches(self.index, result.update_batches)
        self.verify_ms += (t1 - t0) * 1000.0
        self.commit_ms += (time.perf_counter() - t1) * 1000.0
        return result, None

    def update_eval(self, ev):
        self.status = ev.status

    def create_eval(self, ev):
        pass


def system_store(job):
    """A fresh alloc-free store: the 10,000 nodes and the system job."""
    from nomad_tpu_torch.state import StateStore

    state = StateStore()
    state.upsert_nodes(1, cluster_nodes())
    state.upsert_job(2, job)
    return state


def phase_system(dev):
    """BASELINE config 4 through the port's tpu-system scheduler (as
    bench.py's run_config4 does): 1 warm-up and TIMED_EVALS timed evals,
    each on a fresh alloc-free store whose mirror and node table are made
    resident first; every eval commits 5,000 one-per-node tasks, checked
    with check_committed. Logs e2e p50, placements/s and the system fit's
    dispatch ms (the solver panel's wall of its one fit per eval) apart
    from verify and commit."""
    import logging

    from nomad_tpu_torch import structs
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.server.plan_apply import _node_table
    from nomad_tpu_torch.structs import Evaluation, generate_uuid
    from nomad_tpu_torch.tpu.mirror import GLOBAL_MIRROR_CACHE
    from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

    job = system_job()
    rows = []
    for i in range(1 + TIMED_EVALS):
        state = system_store(job)
        snap = state.snapshot()
        GLOBAL_MIRROR_CACHE.get(snap, job.datacenters, dev)
        _node_table(snap)
        planner = VerifyingPlanner(state, 3)
        ev = Evaluation(id=generate_uuid(), priority=job.priority,
                        type=job.type,
                        triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER,
                        job_id=job.id)
        fit0, solves0 = SOLVER_PANEL.device_ms, SOLVER_PANEL.solves
        t0 = time.perf_counter()
        new_scheduler("tpu-system", snap, planner,
                      logging.getLogger("chip_smoke.system"),
                      device=dev).process(ev)
        e2e = (time.perf_counter() - t0) * 1000.0
        fit_ms = SOLVER_PANEL.device_ms - fit0
        if SOLVER_PANEL.solves - solves0 != 1:
            raise AssertionError("the system eval was not one fit dispatch")
        if planner.status != structs.EVAL_STATUS_COMPLETE:
            raise AssertionError(f"system eval ended {planner.status}")
        placed = check_committed(state.snapshot(), job, system_placed(),
                                 per_node=1)
        row = {"e2e_ms": e2e, "fit_ms": fit_ms,
               "verify_ms": planner.verify_ms, "commit_ms": planner.commit_ms}
        if i:
            rows.append(row)
        log(f"system eval {i}{' (warm-up)' if i == 0 else ''}: "
            f"placed={placed} " + " ".join(
                f"{k}={v:.3f}" for k, v in row.items()))
    e2e = p50([r["e2e_ms"] for r in rows])
    log(f"system: {N_NODES} nodes, {system_placed()} one-per-node placements, "
        f"e2e_p50_ms={e2e:.3f} placements_per_s="
        f"{system_placed() / (e2e / 1000.0):.0f} " + " ".join(
            f"{k[:-3]}_p50_ms={p50([r[k] for r in rows]):.3f}"
            for k in ("fit_ms", "verify_ms", "commit_ms")))


# -- the head of the main path: the agent, HTTP and the CLI --------------------------

AGENT_ROUNDS = 3
AGENT_WAIT_S = 120.0
# The agent's min heartbeat TTL, longer than the phase. At the server's
# default (10 s) the first ~500 nodes registered get 10-20 s TTLs and
# SimFleet beats them at 0.8 of that, 2-4 s before they expire; a
# Node.BatchHeartbeat reads a store snapshot, which waits on the store
# lock that the headline stop's apply holds for seconds (ROADMAP Queue 3
# item 4), so a beat could land late, the node went down and the system
# job placed on 4,999 nodes. HeartbeatProbe measures that wait.
AGENT_MIN_HEARTBEAT_TTL_S = 3600.0
PROBE_EVERY_S = 0.1


class HeartbeatProbe:
    """One Node.BatchHeartbeat for one node every PROBE_EVERY_S on a
    connection of its own, each round trip timed: how long a node's beat
    waits on the server while the agent's jobs run."""

    def __init__(self, addr: str, node_id: str):
        from nomad_tpu_torch.rpc import ConnPool

        self.addr = addr
        self.node_id = node_id
        self.pool = ConnPool(timeout=AGENT_WAIT_S)
        self.ms = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="heartbeat-probe")

    def _run(self) -> None:
        while not self._stop.wait(PROBE_EVERY_S):
            t0 = time.perf_counter()
            self.pool.call(self.addr, "Node.BatchHeartbeat",
                           {"node_ids": [self.node_id]},
                           timeout=AGENT_WAIT_S)
            self.ms.append((time.perf_counter() - t0) * 1000.0)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=AGENT_WAIT_S)
        self.pool.shutdown()
        ms = self.ms or [0.0]
        return {"beats": len(self.ms), "p50_ms": round(p50(ms), 3),
                "max_ms": round(max(ms), 3)}


def agent_jobs():
    """(job, HCL text) of the three jobs the agent phase runs: the
    headline, the service job and the system job."""
    from nomad_tpu_torch import structs

    specs = [
        ("agent-headline", structs.JOB_TYPE_BATCH, N_TASKS, ["dc1"], 100,
         128),
        ("agent-service", structs.JOB_TYPE_SERVICE, SERVICE_COUNT,
         ["dc1", "dc2"], 100, 128),
        ("agent-system", structs.JOB_TYPE_SYSTEM, 1, ["dc1"], SYSTEM_CPU,
         SYSTEM_MEM),
    ]
    return [(make_job(name, typ, count, dcs, cpu, mem, job_id=name),
             job_hcl(name, typ, count, dcs, cpu, mem))
            for name, typ, count, dcs, cpu, mem in specs]


def cli_out(argv) -> str:
    """Run the port's CLI in this process; its stdout, or a failure."""
    import contextlib
    import io

    from nomad_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    if rc != 0:
        raise AssertionError(f"cli {argv} exited {rc}: "
                             f"{buf.getvalue()[-2000:]}")
    return buf.getvalue()


def http_wait_complete(client, eval_id: str) -> float:
    """Blocking queries on the eval over HTTP until it is terminal;
    returns the perf_counter stamp it was read complete."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.api import QueryOptions

    deadline = time.perf_counter() + AGENT_WAIT_S
    index = 0
    while time.perf_counter() < deadline:
        ev, meta = client.evaluations().info(
            eval_id, q=QueryOptions(wait_index=index, wait_time="5s"))
        if ev.terminal_status():
            if ev.status != structs.EVAL_STATUS_COMPLETE:
                raise AssertionError(f"agent eval {eval_id} ended "
                                     f"{ev.status}: {ev.status_description}")
            return time.perf_counter()
        index = meta.last_index
    raise AssertionError(f"agent eval {eval_id} did not end in "
                         f"{AGENT_WAIT_S}s")


def agent_round(client, addr: str, srv, path: str, job, want: int,
                per_node: int):
    """``run -detach`` -> complete (HTTP) -> checks -> ``stop -detach`` ->
    complete -> check -> reap. Returns (register ms, stop ms, ms to read
    the job's alloc stubs over HTTP, the register eval's span stages)."""
    t0 = time.perf_counter()
    eid = cli_out(["--address", addr, "run", "-detach", path]).strip()
    reg = (http_wait_complete(client, eid) - t0) * 1000.0
    t0 = time.perf_counter()
    stubs, _ = client.jobs().allocations(job.id)
    read_ms = (time.perf_counter() - t0) * 1000.0
    live = sum(1 for a in stubs if a["desired_status"] == "run")
    if live != want:
        down = sum(1 for n in srv.state_store.snapshot().nodes()
                   if n.status != "ready")
        raise AssertionError(f"/v1/job/{job.id}/allocations lists {live} "
                             f"live allocs, want {want}; {down} nodes not "
                             f"ready, heartbeat {srv.heartbeat.stats()}")
    check_committed(srv.state_store.snapshot(), job, want, per_node)
    t0 = time.perf_counter()
    did = cli_out(["--address", addr, "stop", "-detach", job.id]).strip()
    stop = (http_wait_complete(client, did) - t0) * 1000.0
    snap = srv.state_store.snapshot()
    check_committed(snap, job, 0)
    stages = eval_stages(eid)
    srv.eval_reap([eid, did], [a.id for a in snap.allocs_by_job(job.id)])
    return reg, stop, read_ms, stages


def agent_config_hcl(data_dir: str, device: str) -> str:
    return f"""data_dir = "{data_dir}"
bind_addr = "127.0.0.1"
device = "{device}"

ports {{
    http = 0
    rpc = 0
}}

server {{
    enabled = true
    bootstrap_expect = 1
}}
"""


def phase_agent_agent(dev, data_dir: str):
    """The agent phase's Agent, not started: server mode, one
    ClusterServer member, RPC and HTTP on port 0, node TTLs of at least
    AGENT_MIN_HEARTBEAT_TTL_S."""
    from nomad_tpu_torch.agent import Agent, AgentConfig

    agent = Agent(AgentConfig(
        server_enabled=True, node_name="agent-1", device=str(dev),
        data_dir=data_dir, http_port=0, rpc_port=0, bootstrap_expect=1))
    agent.server.config.min_heartbeat_ttl = AGENT_MIN_HEARTBEAT_TTL_S
    return agent


def phase_agent(dev, card: str, tmp: str):
    """The head of the main path on the card: the port's Agent in server
    mode (one ClusterServer member, RPC and HTTP on port 0), the 10,000
    nodes registered over RPC by a beating SimFleet, and the headline,
    service and system jobs written as HCL files and run through the CLI
    (``run -detach``, then ``stop -detach``) with completion read by
    HTTP blocking queries: 1 warm-up and AGENT_ROUNDS timed rounds each,
    checked through /v1/job/:id/allocations and check_committed. Then an
    agent subprocess (``python -m nomad_tpu_torch agent -config``) with
    ``run`` and ``status`` subprocesses against it, stopped by SIGINT.
    Returns (water-fill launches, greedy launches)."""
    from nomad_tpu_torch import jobspec
    from nomad_tpu_torch.api import ApiClient
    from nomad_tpu_torch.ops import greedy, waterfill
    from nomad_tpu_torch.simcluster.simnode import SimFleet

    jobs = agent_jobs()
    paths = []
    for job, text in jobs:
        path = os.path.join(tmp, f"{job.id}.hcl")
        with open(path, "w") as f:
            f.write(text)
        parsed = jobspec.parse_file(path)
        if (parsed.id, parsed.type, parsed.task_groups[0].count) != (
                job.id, job.type, job.task_groups[0].count):
            raise AssertionError(f"{path} does not parse to its job")
        paths.append(path)

    agent = phase_agent_agent(dev, os.path.join(tmp, "agent"))
    fleet = probe = None
    waterfill.LAUNCHES = 0
    greedy.LAUNCHES = 0
    try:
        agent.start()
        srv = agent.server
        deadline = time.perf_counter() + AGENT_WAIT_S
        while not srv.raft.is_leader:
            if time.perf_counter() > deadline:
                raise AssertionError("the agent's server never led")
            time.sleep(0.01)
        addr = f"http://127.0.0.1:{agent.http.port}"
        client = ApiClient(address=addr)
        fleet = SimFleet(srv.rpc_addr)
        reg = fleet.register(cluster_nodes())
        fleet.start_heartbeats()
        probe = HeartbeatProbe(srv.rpc_addr, cluster_nodes()[0].id)
        probe.start()
        log(f"agent: {N_NODES} nodes over RPC in {reg['seconds']} s "
            f"({reg['nodes_per_sec']} nodes/s, {reg['batches']} frames) "
            f"[{card}]")
        for (job, _text), path in zip(jobs, paths):
            is_system = job.type == "system"
            want = system_placed() if is_system else job.task_groups[0].count
            rows = []
            for i in range(1 + AGENT_ROUNDS):
                row = agent_round(client, addr, srv, path, job, want,
                                  per_node=1 if is_system else 0)
                if i:
                    rows.append(row)
                log(f"agent {job.id} round {i}"
                    f"{' (warm-up)' if i == 0 else ''}: committed={want} "
                    f"register_complete_ms={row[0]:.2f} "
                    f"stop_complete_ms={row[1]:.2f} "
                    f"alloc_stubs_read_ms={row[2]:.2f}")
            log(f"agent {job.id}: register_complete_p50_ms="
                f"{p50([r[0] for r in rows]):.3f} placements_per_s="
                f"{want / (p50([r[0] for r in rows]) / 1000.0):.0f} "
                f"stop_complete_p50_ms={p50([r[1] for r in rows]):.3f} "
                f"alloc_stubs_read_p50_ms={p50([r[2] for r in rows]):.3f} "
                f"({want} stubs) [{card}]")
            log(f"agent {job.id} stage p50 ms: " + json.dumps(
                {k: round(p50([r[3].get(k, 0.0) for r in rows]), 3)
                 for k in SERVER_STAGES}))

        # One monitored run (the CLI's 0.2 s polling monitor) of the
        # service job.
        job, path = jobs[1][0], paths[1]
        t0 = time.perf_counter()
        out = cli_out(["--address", addr, "run", path])
        wall = (time.perf_counter() - t0) * 1000.0
        created = out.count("Allocation \"")
        if created != job.task_groups[0].count or "complete" not in out:
            raise AssertionError(f"monitored run reported {created} allocs")
        log(f"agent: monitored run of {job.id} wall_ms={wall:.1f} "
            f"({created} allocs reported) [{card}]")
        did = cli_out(["--address", addr, "stop", "-detach", job.id]).strip()
        http_wait_complete(client, did)
        wf, gr = waterfill.LAUNCHES, greedy.LAUNCHES
        if wf == 0 or gr == 0:
            raise AssertionError(f"the agent's jobs launched water-fill {wf} "
                                 f"and greedy {gr} times; both must rise")
        log(f"agent: waterfill_launches={wf} greedy_launches={gr} "
            f"stats={json.dumps(srv.solver_stats())}")
        beats = probe.stop()
        probe = None
        hb = srv.heartbeat.stats()
        log(f"agent: heartbeat round trip over the phase "
            f"{json.dumps(beats)}, server timers {json.dumps(hb)} [{card}]")
        if hb["expirations"]:
            raise AssertionError(f"{hb['expirations']} node TTLs expired in "
                                 "the agent phase")
    finally:
        if probe is not None:
            probe.stop()
        if fleet is not None:
            fleet.stop()
        agent.shutdown()
    agent_subprocess(dev, jobs[1][0], paths[1], card, tmp)
    return wf, gr


def agent_subprocess(dev, job, path: str, card: str, tmp: str) -> None:
    """``python -m nomad_tpu_torch agent -config <file>`` on the card, the
    10,000 nodes over RPC, ``run`` and ``status`` as subprocesses against
    it, /v1/agent/self naming the card, then SIGINT: exit code 0."""
    import queue
    import signal

    import torch

    from nomad_tpu_torch.api import ApiClient
    from nomad_tpu_torch.simcluster.simnode import SimFleet

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    cfg = os.path.join(tmp, "agent-sub.hcl")
    with open(cfg, "w") as f:
        f.write(agent_config_hcl(os.path.join(tmp, "agent-sub"), dev.type))
    err_path = os.path.join(tmp, "agent-sub.err")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "nomad_tpu_torch", "agent", "-config",
             cfg], stdout=subprocess.PIPE, stderr=err, text=True, cwd=here,
            env=env)
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout],
        daemon=True)
    reader.start()
    fleet = None
    try:
        addr = None
        deadline = time.perf_counter() + AGENT_WAIT_S
        while addr is None:
            try:
                line = lines.get(timeout=max(deadline - time.perf_counter(),
                                             0.01))
            except queue.Empty:
                raise AssertionError("the agent subprocess printed no HTTP "
                                     "address")
            m = re.search(r"HTTP at (http://\S+)", line)
            if m:
                addr = m.group(1)
        started = (time.perf_counter() - t0) * 1000.0
        client = ApiClient(address=addr)
        info = client.agent().self_info()
        name = info["stats"]["device"].get("name", dev.type)
        if name != (torch.cuda.get_device_name(0) if dev.type == "cuda"
                    else "cpu"):
            raise AssertionError(f"/v1/agent/self names device {name!r}")
        rpc = client.agent().servers()[0]
        # The leader's RPC address once its raft has elected itself.
        while client.status().leader() != rpc:
            if time.perf_counter() > deadline:
                raise AssertionError("the agent subprocess never led")
            time.sleep(0.05)
        fleet = SimFleet(rpc)
        fleet.register(cluster_nodes())
        fleet.start_heartbeats()

        def cli_proc(*argv):
            out = subprocess.run(
                [sys.executable, "-m", "nomad_tpu_torch", "--address", addr,
                 *argv], capture_output=True, text=True, cwd=here, env=env,
                timeout=AGENT_WAIT_S)
            if out.returncode != 0:
                raise AssertionError(f"nomad_tpu_torch {argv} exited "
                                     f"{out.returncode}: {out.stdout[-1000:]}"
                                     f" {out.stderr[-2000:]}")
            return out.stdout

        eid = cli_proc("run", "-detach", path).strip()
        http_wait_complete(client, eid)
        status = cli_proc("status", job.id)
        stubs, _ = client.jobs().allocations(job.id)
        if (len(stubs) != job.task_groups[0].count
                or status.count(" run ") != job.task_groups[0].count):
            raise AssertionError(f"the subprocess agent holds {len(stubs)} "
                                 f"allocs of {job.id}; status:\n{status}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=AGENT_WAIT_S)
        if rc != 0:
            raise AssertionError(f"the agent subprocess exited {rc} on "
                                 "SIGINT")
        log(f"agent subprocess: started in {started:.0f} ms, device "
            f"{name}, {len(stubs)} allocs of {job.id} through run and "
            f"status subprocesses, SIGINT -> exit 0 [{card}]")
    finally:
        if fleet is not None:
            fleet.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
            with open(err_path) as f:
                log("agent subprocess stderr tail: " + f.read()[-3000:])


# -- the client: node agents run what the card placed ---------------------------

CLIENT_NODES = 8
CLIENT_BATCH_COUNT = 256
# 3 until the operator phase was added; cut to 2 for the same reason.
CLIENT_BATCH_ROUNDS = 2
CLIENT_SERVICE_COUNT = 8
CLIENT_FAIL_COUNT = 2
CLIENT_FAIL_ATTEMPTS = 2
CLIENT_TASK_CPU, CLIENT_TASK_MEM = 100, 64
CLIENT_WAIT_S = 120.0
CLIENT_OPTIONS = {"fingerprint.gpu.enable": "1",
                  "driver.raw_exec.enable": "1",
                  "driver.mock_driver.enable": "1"}
GPU_ATTRS = ("gpu.count", "gpu.platform", "gpu.device_kind", "gpu.capability",
             "driver.gpu")


# The smoke runs without network access. The client's cloud-metadata
# fingerprints (AWS, GCE) would dial the link-local metadata address: urllib goes
# through a closed loopback port instead, so each fails at once, and the
# loopback itself stays direct.
NO_NETWORK_ENV = {"http_proxy": "http://127.0.0.1:1",
                  "no_proxy": "127.0.0.1,localhost"}


def no_outside_network() -> None:
    """NO_NETWORK_ENV for this process (set before its first urlopen:
    urllib keeps the proxies it first read) and every subprocess."""
    os.environ.update(NO_NETWORK_ENV)


def gpu_attrs(dev) -> dict:
    """The attributes GPUFingerprint gives a node on the card.
    On the CPU (dry runs) there is no card, so a client is given them by
    hand."""
    import torch

    if dev.type != "cuda":
        return {"gpu.count": "1", "gpu.platform": "cuda",
                "gpu.device_kind": "none (set by hand)",
                "gpu.capability": "0.0", "driver.gpu": "1"}
    major, minor = torch.cuda.get_device_capability(0)
    return {"gpu.count": str(torch.cuda.device_count()),
            "gpu.platform": "cuda",
            "gpu.device_kind": torch.cuda.get_device_name(0),
            "gpu.capability": f"{major}.{minor}", "driver.gpu": "1"}


def client_job(job_id: str, typ: str, count: int, driver: str, config: dict,
               attempts: int = 0):
    """A job only GPU-fingerprinted nodes take ($attr.driver.gpu = 1): the
    SimFleet's nodes advertise raw_exec too, but run nothing."""
    from nomad_tpu_torch.structs import (
        Constraint, Job, Resources, RestartPolicy, Task, TaskGroup,
    )

    return Job(
        region="global", id=job_id, name=job_id, type=typ, priority=50,
        datacenters=["dc1", "dc2"],
        constraints=[Constraint(l_target="$attr.driver.gpu", r_target="1",
                                operand="=")],
        task_groups=[TaskGroup(
            name="work", count=count,
            restart_policy=RestartPolicy(attempts=attempts, interval=600.0,
                                         delay=0.1),
            tasks=[Task(name="work", driver=driver, config=dict(config),
                        resources=Resources(cpu=CLIENT_TASK_CPU,
                                            memory_mb=CLIENT_TASK_MEM))],
        )],
    )


class ClientBooks:
    """What the server and the clients saw, stamped on one clock: each
    plan's commit (the FSM's alloc_update, by eval), each alloc's first
    report of each client status (the server's Node.UpdateAlloc), each
    client's Node.UpdateAlloc round trip, and each spawn daemon start."""

    def __init__(self, srv):
        from nomad_tpu_torch.client.driver import spawn

        self.lock = threading.Lock()
        self.commit = {}
        self.first = {}
        self.stopped = set()
        self.update_ms = []
        self.spawn_ms = []
        self.spawns = {}
        apply = srv.fsm.apply
        update = srv.update_allocs_from_client

        def fsm_apply(index, msg_type, payload):
            out = apply(index, msg_type, payload)
            if msg_type == "alloc_update" and "plan" in payload:
                with self.lock:
                    self.commit.setdefault(payload["plan"]["eval_id"],
                                           time.perf_counter())
            return out

        def update_allocs(allocs):
            out = update(allocs)
            now = time.perf_counter()
            with self.lock:
                for a in allocs:
                    self.first.setdefault((a.id, a.client_status),
                                          (now, a.eval_id))
                    if a.client_description == "alloc stopped":
                        self.stopped.add(a.id)
            return out

        srv.fsm.apply = fsm_apply
        srv.update_allocs_from_client = update_allocs
        self._spawn_mod = spawn
        self._spawn = spawn.spawn_detached

        def spawn_detached(command, args, env, cwd, *rest, **kw):
            t0 = time.perf_counter()
            pid = self._spawn(command, args, env, cwd, *rest, **kw)
            with self.lock:
                self.spawn_ms.append((time.perf_counter() - t0) * 1000.0)
                self.spawns[cwd] = self.spawns.get(cwd, 0) + 1
            return pid
        spawn.spawn_detached = spawn_detached

    def time_updates(self, client) -> None:
        endpoint = client.endpoint
        inner = endpoint.update_allocs

        def update_allocs(allocs):
            t0 = time.perf_counter()
            out = inner(allocs)
            with self.lock:
                self.update_ms.append((time.perf_counter() - t0) * 1000.0)
            return out
        endpoint.update_allocs = update_allocs

    def close(self) -> None:
        self._spawn_mod.spawn_detached = self._spawn

    def running_ms(self, alloc_ids):
        """placement -> running, per alloc: its plan's commit to the
        server's first report of it running."""
        out = []
        with self.lock:
            for aid in alloc_ids:
                now, eval_id = self.first[(aid, "running")]
                out.append((now - self.commit[eval_id]) * 1000.0)
        return out


def start_clients(dev, addr: str, tmp: str, n: int):
    """n Clients over RPC to ``addr``, each with its own state and alloc
    dirs. Returns (clients, fingerprint ms, register ms)."""
    from nomad_tpu_torch.client import Client, ClientConfig

    clients, fp_ms, reg_ms = [], [], []
    try:
        for i in range(n):
            root = os.path.join(tmp, f"client-{i}")
            t0 = time.perf_counter()
            client = Client(ClientConfig(
                state_dir=os.path.join(root, "state"),
                alloc_dir=os.path.join(root, "allocs"), datacenter="dc1",
                node_name=f"gpu-client-{i}", servers=[addr],
                options=dict(CLIENT_OPTIONS)))
            fp_ms.append((time.perf_counter() - t0) * 1000.0)
            clients.append(client)
            if dev.type != "cuda":
                client.node.attributes.update(gpu_attrs(dev))
            t0 = time.perf_counter()
            client.start()
            reg_ms.append((time.perf_counter() - t0) * 1000.0)
    except BaseException:
        for client in clients:
            client.shutdown(destroy_allocs=True)
        raise
    return clients, fp_ms, reg_ms


def wait_for(what: str, pred, timeout: float = CLIENT_WAIT_S) -> float:
    """Poll pred every 5 ms; returns the perf_counter stamp it held."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return time.perf_counter()
        time.sleep(0.005)
    raise AssertionError(f"{what}: not within {timeout}s")


def client_statuses(srv, job_id: str):
    from collections import Counter

    return Counter(a.client_status
                   for a in srv.state_store.snapshot().allocs_by_job(job_id))


def check_on_gpu_nodes(srv, job_id: str, want: int, gpu_ids) -> list:
    allocs = srv.state_store.snapshot().allocs_by_job(job_id)
    live = [a for a in allocs if a.desired_status == "run"]
    off = [a.node_id for a in live if a.node_id not in gpu_ids]
    if len(live) != want or off:
        raise AssertionError(f"{job_id}: {len(live)} live allocs (want "
                             f"{want}), {len(off)} off the GPU nodes")
    return live


def runners_of(clients, job_id: str):
    return [r for c in clients for r in list(c.alloc_runners.values())
            if r.alloc.job_id == job_id]


def stop_and_reap(srv, books, clients, job_id: str, eval_ids,
                  addr: str = "") -> float:
    """Deregister (``stop -detach`` over HTTP when ``addr`` is given),
    wait for the eval, for every client's stop report and for every task
    runner to end (its last report sent), then reap the evals and allocs
    so each client drops its runners. Returns the perf_counter stamp the
    deregister was sent."""
    t0 = time.perf_counter()
    if addr:
        did = cli_out(["--address", addr, "stop", "-detach", job_id]).strip()
    else:
        did, _ = srv.job_deregister(job_id)
    wait_complete(srv, did)
    ids = [a.id for a in srv.state_store.snapshot().allocs_by_job(job_id)]
    wait_for(f"{job_id} stop reports", lambda: books.stopped.issuperset(ids)
             and all(tr.wait_done(0) for r in runners_of(clients, job_id)
                     for tr in r.task_runners.values()))
    snap = srv.state_store.snapshot()
    srv.eval_reap(list(eval_ids) + [did],
                  [a.id for a in snap.allocs_by_job(job_id)])
    return t0


def spawn_daemons(tmp: str):
    """pids of live spawn daemons whose spec names a path under tmp."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except OSError:
            continue
        if "spawn-daemon" in cmd and tmp in cmd:
            out.append(int(pid))
    return out


def phase_client_jobs(dev, card: str, tmp: str):
    """CLIENT_NODES real Clients beside the 10,000 SimFleet nodes of a
    server-mode Agent, and the three client jobs. Returns (water-fill
    launches, greedy launches)."""
    from nomad_tpu_torch.client.driver import spawn
    from nomad_tpu_torch.ops import greedy, waterfill
    from nomad_tpu_torch.simcluster.simnode import SimFleet

    agent = phase_agent_agent(dev, os.path.join(tmp, "agent"))
    fleet = books = None
    clients = []
    try:
        agent.start()
        srv = agent.server
        wait_for("the client phase's server leads", lambda: srv.raft.is_leader)
        addr = f"http://127.0.0.1:{agent.http.port}"
        fleet = SimFleet(srv.rpc_addr)
        reg = fleet.register(cluster_nodes())
        fleet.start_heartbeats()
        books = ClientBooks(srv)

        from nomad_tpu_torch.client.fingerprint import GPUFingerprint
        from nomad_tpu_torch.client.config import ClientConfig
        from nomad_tpu_torch.structs import Node

        t0 = time.perf_counter()
        probe = Node(id="probe")
        GPUFingerprint().fingerprint(ClientConfig(options=CLIENT_OPTIONS),
                                     probe)
        gpu_fp_ms = (time.perf_counter() - t0) * 1000.0
        want_attrs = gpu_attrs(dev)
        if dev.type == "cuda" and {k: probe.attributes.get(k)
                                   for k in GPU_ATTRS} != want_attrs:
            raise AssertionError(f"GPUFingerprint gave {probe.attributes}")

        clients, fp_ms, reg_ms = start_clients(dev, srv.rpc_addr, tmp,
                                               CLIENT_NODES)
        for client in clients:
            books.time_updates(client)
        gpu_ids = {c.node.id for c in clients}
        snap = srv.state_store.snapshot()
        for client in clients:
            node = snap.node_by_id(client.node.id)
            got = {k: node.attributes.get(k) for k in GPU_ATTRS}
            if node.status != "ready" or got != want_attrs:
                raise AssertionError(f"client node {node.name} registered "
                                     f"{node.status} with {got}")
        log(f"client: {N_NODES} SimFleet nodes in {reg['seconds']} s, "
            f"{CLIENT_NODES} clients registered with {json.dumps(want_attrs)}"
            f"; construct (fingerprint) p50 {p50(fp_ms):.1f} ms, start "
            f"(register) p50 {p50(reg_ms):.1f} ms, GPUFingerprint alone "
            f"{gpu_fp_ms:.3f} ms [{card}]")

        waterfill.LAUNCHES = 0
        greedy.LAUNCHES = 0

        # client-batch: CLIENT_BATCH_COUNT mock tasks, 1 + rounds.
        batch_ms, batch_ids = [], []
        for i in range(1 + CLIENT_BATCH_ROUNDS):
            job = client_job(f"client-batch-{i}", "batch", CLIENT_BATCH_COUNT,
                             "mock_driver", {"run_for": 0.2})
            t0 = time.perf_counter()
            eid, _ = srv.job_register(job)
            wait_complete(srv, eid)
            live = check_on_gpu_nodes(srv, job.id, CLIENT_BATCH_COUNT,
                                      gpu_ids)
            done = wait_for(f"{job.id} dead", lambda: client_statuses(
                srv, job.id) == {"dead": CLIENT_BATCH_COUNT})
            runners = runners_of(clients, job.id)
            codes = [tr.handle.wait(timeout=0) for r in runners
                     for tr in r.task_runners.values()]
            states = {s for r in runners for s in r.task_status.values()}
            if (len(codes) != CLIENT_BATCH_COUNT or set(codes) != {0}
                    or states != {"dead"}):
                raise AssertionError(f"{job.id}: exit codes {set(codes)} "
                                     f"of {len(codes)}, task states {states}")
            ms = (done - t0) * 1000.0
            if i:
                batch_ms.append(ms)
                batch_ids += [a.id for a in live]
            log(f"client {job.id}{' (warm-up)' if i == 0 else ''}: "
                f"{CLIENT_BATCH_COUNT} allocs dead, exit 0, on "
                f"{len({a.node_id for a in live})} GPU nodes; "
                f"register_all_dead_ms={ms:.1f}")
            stop_and_reap(srv, books, clients, job.id, [eid])
            wait_for(f"{job.id} runners dropped",
                     lambda: not runners_of(clients, job.id))

        # client-service: long-lived raw_exec tasks through spawn daemons.
        job = client_job("client-service", "service", CLIENT_SERVICE_COUNT,
                         "raw_exec", {"command": "/bin/sleep",
                                      "args": ["3600"]})
        eid, _ = srv.job_register(job)
        wait_complete(srv, eid)
        live = check_on_gpu_nodes(srv, job.id, CLIENT_SERVICE_COUNT, gpu_ids)
        wait_for("client-service running", lambda: client_statuses(
            srv, job.id) == {"running": CLIENT_SERVICE_COUNT})
        service_ids = [a.id for a in live]
        handles = [tr.handle.id() for r in runners_of(clients, job.id)
                   for tr in r.task_runners.values()]
        pids = [spawn.read_pid(h) for h in handles]
        daemons = spawn_daemons(tmp)
        if (len(pids) != CLIENT_SERVICE_COUNT
                or not all(spawn.pid_alive(p) for p in pids)
                or len(daemons) != CLIENT_SERVICE_COUNT):
            raise AssertionError(f"client-service: user pids {pids}, spawn "
                                 f"daemons {daemons}")
        t0 = stop_and_reap(srv, books, clients, job.id, [eid], addr=addr)
        gone = wait_for("client-service pids gone", lambda: not any(
            spawn.pid_alive(p) for p in pids) and not spawn_daemons(tmp))
        stop_ms = (gone - t0) * 1000.0
        log(f"client client-service: {CLIENT_SERVICE_COUNT} raw_exec tasks "
            f"running on {len({a.node_id for a in live})} GPU nodes, "
            f"stop -detach -> every daemon and user pid gone in "
            f"{stop_ms:.1f} ms [{card}]")

        # client-fail: exit 3 under a batch restart policy.
        job = client_job("client-fail", "batch", CLIENT_FAIL_COUNT,
                         "raw_exec", {"command": "/bin/sh",
                                      "args": ["-c", "exit 3"]},
                         attempts=CLIENT_FAIL_ATTEMPTS)
        eid, _ = srv.job_register(job)
        wait_complete(srv, eid)
        live = check_on_gpu_nodes(srv, job.id, CLIENT_FAIL_COUNT, gpu_ids)
        wait_for("client-fail failed", lambda: client_statuses(
            srv, job.id) == {"failed": CLIENT_FAIL_COUNT})
        fail_ids = [a.id for a in live]
        starts = sorted(
            n for cwd, n in books.spawns.items()
            if any(aid in cwd for aid in fail_ids))
        restarts = [tr.restart_tracker.count
                    for r in runners_of(clients, job.id)
                    for tr in r.task_runners.values()]
        if (starts != [1 + CLIENT_FAIL_ATTEMPTS] * CLIENT_FAIL_COUNT
                or restarts != [CLIENT_FAIL_ATTEMPTS] * CLIENT_FAIL_COUNT):
            raise AssertionError(f"client-fail: starts {starts}, restarts "
                                 f"{restarts}")
        log(f"client client-fail: {CLIENT_FAIL_COUNT} allocs failed after "
            f"{1 + CLIENT_FAIL_ATTEMPTS} starts each")
        stop_and_reap(srv, books, clients, job.id, [eid])

        wf, gr = waterfill.LAUNCHES, greedy.LAUNCHES
        if wf < 1 + CLIENT_BATCH_ROUNDS or gr < 2:
            raise AssertionError(f"the client jobs launched water-fill {wf} "
                                 f"and greedy {gr} times")
        running = books.running_ms(batch_ids + service_ids + fail_ids)
        log(f"client: placement_running_p50_ms={p50(running):.1f} "
            f"(max {max(running):.1f}, {len(running)} allocs), "
            f"register_all_dead_p50_ms={p50(batch_ms):.1f} "
            f"({CLIENT_BATCH_COUNT} allocs), stop_pids_gone_ms="
            f"{stop_ms:.1f}, update_alloc_rtt_p50_ms="
            f"{p50(books.update_ms):.3f} ({len(books.update_ms)} calls), "
            f"spawn_start_p50_ms={p50(books.spawn_ms):.1f} "
            f"({len(books.spawn_ms)} starts), waterfill_launches={wf} "
            f"greedy_launches={gr} [{card}]")
        hb = srv.heartbeat.stats()
        if hb["expirations"]:
            raise AssertionError(f"{hb['expirations']} node TTLs expired in "
                                 "the client phase")
        t0 = time.perf_counter()
        for client in clients:
            client.shutdown(destroy_allocs=True)
        log(f"client: {CLIENT_NODES} clients shut down in "
            f"{time.perf_counter() - t0:.3f} s")
        clients = []
    finally:
        for client in clients:
            client.shutdown(destroy_allocs=True)
        if books is not None:
            books.close()
        if fleet is not None:
            fleet.stop()
        agent.shutdown()
    return wf, gr


DEV_JOB = '''job "dev-echo" {{
    type = "batch"
    datacenters = ["dc1"]
{constraint}
    group "g" {{
        count = 1
        task "echo" {{
            driver = "raw_exec"
            config {{
                command = "/bin/sh"
                args = ["-c", "echo {word}"]
            }}
            resources {{
                cpu = 100
                memory = 64
            }}
        }}
    }}
}}
'''
DEV_WORD = "placed-on-the-card"


def dev_agent_config_hcl(device: str) -> str:
    return f"""device = "{device}"

client {{
    options {{
        "fingerprint.gpu.enable" = "1"
    }}
}}
"""


def client_dev_agent(dev, card: str, tmp: str) -> None:
    """``python -m nomad_tpu_torch agent -dev`` on the card (server and
    client in one process, the GPU fingerprint on), a one-task raw_exec
    job through ``run``, ``status``, ``alloc-status`` and
    ``client-config -servers`` subprocesses, the task's stdout in its
    alloc dir, then SIGINT: exit code 0."""
    import queue
    import signal

    from nomad_tpu_torch.api import ApiClient

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, **NO_NETWORK_ENV)
    data = os.path.join(tmp, "dev")
    cfg = os.path.join(tmp, "dev.hcl")
    with open(cfg, "w") as f:
        f.write(dev_agent_config_hcl(dev.type))
    # On the CPU (dry runs) the node has no GPU attribute to select.
    constraint = ('    constraint {\n        attribute = "$attr.driver.gpu"\n'
                  '        value = "1"\n    }\n' if dev.type == "cuda" else "")
    job_path = os.path.join(tmp, "dev-echo.hcl")
    with open(job_path, "w") as f:
        f.write(DEV_JOB.format(constraint=constraint, word=DEV_WORD))
    err_path = os.path.join(tmp, "dev.err")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "nomad_tpu_torch", "agent", "-dev",
             "-config", cfg, "-http-port", "0", "-data-dir", data],
            stdout=subprocess.PIPE, stderr=err, text=True, cwd=here, env=env)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        addr = None
        deadline = time.perf_counter() + CLIENT_WAIT_S
        while addr is None:
            try:
                line = lines.get(timeout=max(deadline - time.perf_counter(),
                                             0.01))
            except queue.Empty:
                raise AssertionError("agent -dev printed no HTTP address")
            m = re.search(r"HTTP at (http://\S+)", line)
            if m:
                addr = m.group(1)
        started = (time.perf_counter() - t0) * 1000.0

        def cli_proc(*argv):
            out = subprocess.run(
                [sys.executable, "-m", "nomad_tpu_torch", "--address", addr,
                 *argv], capture_output=True, text=True, cwd=here, env=env,
                timeout=CLIENT_WAIT_S)
            if out.returncode != 0:
                raise AssertionError(f"nomad_tpu_torch {argv} exited "
                                     f"{out.returncode}: {out.stdout[-1000:]}"
                                     f" {out.stderr[-2000:]}")
            return out.stdout

        client = ApiClient(address=addr)
        info = client.agent().self_info()
        node_id = info["stats"]["client"]["node_id"]
        node, _ = client.nodes().info(node_id)
        want = gpu_attrs(dev) if dev.type == "cuda" else {}
        got = {k: node.attributes[k] for k in want}
        name = info["stats"]["device"].get("name", dev.type)
        if got != want or (dev.type == "cuda" and name != want[
                "gpu.device_kind"]):
            raise AssertionError(f"agent -dev: node {got}, device {name}")
        t1 = time.perf_counter()
        out = cli_proc("run", job_path)
        if "complete" not in out:
            raise AssertionError(f"agent -dev run: {out}")
        wait_for("dev-echo dead", lambda: " dead" in cli_proc(
            "status", "dev-echo"), timeout=CLIENT_WAIT_S)
        run_ms = (time.perf_counter() - t1) * 1000.0
        (stub,), _ = client.jobs().allocations("dev-echo")
        alloc, _ = client.allocations().info(stub["id"])
        status = cli_proc("alloc-status", stub["id"])
        if ("Client Status  = dead" not in status
                or alloc.client_description != "all tasks complete"):
            raise AssertionError(f"agent -dev alloc: {status} "
                                 f"{alloc.client_description!r}")
        with open(os.path.join(data, "allocs", stub["id"], "alloc", "logs",
                               "echo.stdout")) as f:
            echoed = f.read()
        if echoed != DEV_WORD + "\n":
            raise AssertionError(f"agent -dev task stdout {echoed!r}")
        servers = cli_proc("client-config", "-servers").split()
        if servers != [addr]:
            raise AssertionError(f"client-config -servers: {servers}")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=CLIENT_WAIT_S)
        if rc != 0:
            raise AssertionError(f"agent -dev exited {rc} on SIGINT")
        log(f"client agent -dev: started in {started:.0f} ms, device {name}, "
            f"node {json.dumps(got)}, run -> task dead exit 0 in "
            f"{run_ms:.0f} ms (stdout {echoed.strip()!r}), client-config "
            f"-servers {servers}, SIGINT -> exit 0 in "
            f"{time.perf_counter() - t1:.2f} s [{card}]")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
            with open(err_path) as f:
                log("agent -dev stderr tail: " + f.read()[-3000:])


def phase_client(dev, card: str, tmp: str):
    """The client phase: phase_client_jobs, then client_dev_agent.
    Returns (water-fill launches, greedy launches) of this process."""
    wf, gr = phase_client_jobs(dev, card, tmp)
    client_dev_agent(dev, card, tmp)
    return wf, gr


# -- the agent's operator surface ----------------------------------------------

OPERATOR_ROUNDS = 2
# Fixed Prometheus histogram bounds (ms) the operator agent is configured
# with: the sink's bucket exposition must carry exactly these.
OPERATOR_BUCKETS = (1.0, 10.0, 100.0, 1000.0, 10000.0)
# Families the main scrape must carry for the subsystems a server-mode
# agent runs under this load: nomad_tpu's family names
# (tests/test_torch_api.py holds this list to nomad_tpu's own scrape).
OPERATOR_FAMILIES = (
    "nomad_mirror_cache_hits_total", "nomad_mirror_cache_delta_rolls_total",
    "nomad_mirror_cache_roll_ms_total", "nomad_mirror_cache_entries",
    "nomad_plan_pipeline_plans_total", "nomad_plan_pipeline_max_batch",
    "nomad_trace_spans_dropped_total", "nomad_trace_retained",
    "nomad_admission_admitted_total", "nomad_admission_rejected_total",
    "nomad_express_placed_total", "nomad_express_leases",
    "nomad_capacity_nodes", "nomad_capacity_utilization",
    "nomad_capacity_stranded_pct", "nomad_raft_commit_index",
    "nomad_raft_applied_index", "nomad_raft_write_entries_total",
    "nomad_raft_write_ms", "nomad_read_requests_total",
    "nomad_read_latency_ms", "nomad_read_watchers",
    "nomad_read_applied_index", "nomad_profile_samples_total",
    "nomad_profile_role_share", "nomad_runtime_rss_bytes",
    "nomad_runtime_mirror_bytes", "nomad_runtime_mirror_per_row_bytes",
    "nomad_runtime_mirror_projected_1m_bytes", "nomad_lock_watchdog_installed",
    "nomad_lock_order_violations", "nomad_lock_acquisitions_total",
    "nomad_lock_wait_ms", "nomad_lock_hold_ms", "nomad_solver_solves_total",
    "nomad_solver_placed_total", "nomad_solver_bucket_solves_total",
    "nomad_solver_batch_dispatches_total",
)
RAFT_LOCK = "nomad_tpu_torch.raft.node.RaftNode._lock"
STORE_LOCK = "nomad_tpu_torch.state.store.StateStore._lock"
_PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})? (\S+)$')


def parse_prometheus(text: str) -> dict:
    """Read a text exposition (version 0.0.4) line by line: every line a
    ``# TYPE`` declaration (once per family, before its samples) or a
    sample with a float value. Returns {family: type}; raises on the
    first line that is neither."""
    types: dict = {}
    for i, line in enumerate(text.splitlines(), 1):
        if line.startswith("# TYPE "):
            parts = line.split()
            if (len(parts) != 4 or parts[3] not in
                    ("counter", "gauge", "summary", "histogram")):
                raise AssertionError(f"scrape line {i}: {line!r}")
            if parts[2] in types:
                raise AssertionError(f"scrape line {i}: family {parts[2]} "
                                     "declared twice")
            types[parts[2]] = parts[3]
            continue
        m = _PROM_SAMPLE.match(line)
        if m is None:
            raise AssertionError(f"scrape line {i}: {line!r}")
        float(m.group(3))
        name = m.group(1)
        family = next((f for f in (name, re.sub(
            r"_(bucket|sum|count)$", "", name)) if f in types), None)
        if family is None:
            raise AssertionError(f"scrape line {i}: sample {name} before "
                                 "its family's TYPE line")
    return types


def http_get(addr: str, path: str):
    """GET ``path`` from the agent: (status, content type, body text, ms)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(addr + path, timeout=AGENT_WAIT_S) as r:
            status, ctype, body = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        status, ctype, body = e.code, e.headers["Content-Type"], e.read()
    return (status, ctype, body.decode(),
            (time.perf_counter() - t0) * 1000.0)


def http_ok(addr: str, path: str) -> str:
    status, _ctype, body, _ms = http_get(addr, path)
    if status != 200:
        raise AssertionError(f"GET {path}: {status} {body[:500]}")
    return body


class StatsdListener:
    """A UDP socket on 127.0.0.1 that counts the statsd lines it gets."""

    def __init__(self):
        import socket

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self.lines = 0
        self.sample = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="statsd-listener")
        self._thread.start()

    def _run(self) -> None:
        import socket

        while not self._stop.is_set():
            try:
                data = self.sock.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            for line in data.decode(errors="replace").splitlines():
                self.lines += 1
                if len(self.sample) < 3:
                    self.sample.append(line)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.sock.close()


def operator_config_hcl(data_dir: str, device: str, statsd: str) -> str:
    buckets = ", ".join(str(b) for b in OPERATOR_BUCKETS)
    return f"""data_dir = "{data_dir}"
bind_addr = "127.0.0.1"
device = "{device}"
enable_debug = true

ports {{
    http = 0
    rpc = 0
}}

server {{
    enabled = true
    bootstrap_expect = 1
    profile {{
        enabled = true
    }}
}}

telemetry {{
    statsd_address = "{statsd}"
    lock_watchdog = true
    histogram_buckets = [{buckets}]
}}
"""


def phase_operator_agent(dev, tmp: str, statsd: str):
    """The operator phase's Agent, not started, from its config file (the
    agent_config parser and AgentConfig.from_file_config): server mode,
    statsd sink, lock watchdog, histogram buckets, debug routes and the
    runtime observatory on; node TTLs of at least
    AGENT_MIN_HEARTBEAT_TTL_S."""
    from nomad_tpu_torch import agent_config
    from nomad_tpu_torch.agent import Agent, AgentConfig

    path = os.path.join(tmp, "operator.hcl")
    with open(path, "w") as f:
        f.write(operator_config_hcl(os.path.join(tmp, "operator"), dev.type,
                                    statsd))
    fc = agent_config.default_config().merge(
        agent_config.load_config_file(path))
    cfg = AgentConfig.from_file_config(fc)
    cfg.node_name = "operator-1"
    agent = Agent(cfg)
    agent.server.config.min_heartbeat_ttl = AGENT_MIN_HEARTBEAT_TTL_S
    return agent


def lock_rows(wd) -> dict:
    return {r["lock"]: r for r in wd.stats()["contention"]}


def lock_delta(before: dict, after: dict, lock: str) -> dict:
    """Acquisitions, contended acquisitions and total wait of one lock
    between two contention tables (these three are additive)."""
    b, a = before.get(lock, {}), after.get(lock, {})
    return {k: round(a.get(k, 0) - b.get(k, 0), 3)
            for k in ("acquisitions", "contended", "wait_total_ms")}


def role_shares(before: dict, after: dict) -> dict:
    """Each role's share of the thread samples taken between two profile
    views."""
    delta = {r: after["roles"][r]["samples"]
             - before["roles"].get(r, {}).get("samples", 0)
             for r in after["roles"]}
    total = sum(delta.values()) or 1
    return {r: round(n / total, 4) for r, n in sorted(delta.items())}


def operator_round(client, srv, job, want: int, wd):
    """Register (SDK) -> complete -> check -> deregister -> complete ->
    check -> reap. Returns (register ms, deregister ms, the raft and store
    locks' books over the deregister)."""
    t0 = time.perf_counter()
    eid, _ = client.jobs().register(job)
    reg = (http_wait_complete(client, eid) - t0) * 1000.0
    check_committed(srv.state_store.snapshot(), job, want)
    before = lock_rows(wd)
    t0 = time.perf_counter()
    did, _ = client.jobs().deregister(job.id)
    dereg = (http_wait_complete(client, did) - t0) * 1000.0
    after = lock_rows(wd)
    snap = srv.state_store.snapshot()
    check_committed(snap, job, 0)
    srv.eval_reap([eid, did], [a.id for a in snap.allocs_by_job(job.id)])
    return reg, dereg, {"raft": lock_delta(before, after, RAFT_LOCK),
                        "store": lock_delta(before, after, STORE_LOCK)}


def check_operator_surface(agent, addr: str, client, statsd,
                           solver_before: dict) -> None:
    """Every /v1/agent/* route of the operator surface on the loaded
    agent: the metrics JSON and its Prometheus scrape (parsed line by
    line, OPERATOR_FAMILIES and the configured buckets present), the
    statsd lines, the solver panel's dispatches of both kernels, the
    runtime and profile routes in each format, the observatories'
    Prometheus texts, the debug routes and the bundle's sections, and no
    lock-order violation."""
    from nomad_tpu_torch.bundle import BUNDLE_SECTIONS

    # The observatories' JSON routes refresh their books first, so the
    # scrape does not depend on where each poller's 1 s tick fell.
    for route in ("capacity", "raft", "reads", "runtime"):
        http_ok(addr, f"/v1/agent/{route}")
    metrics = client.agent().metrics()
    if not metrics.get("intervals") or metrics.get("runtime") is None:
        raise AssertionError(f"/v1/agent/metrics: {list(metrics)}")
    status, ctype, text, scrape_ms = http_get(
        addr, "/v1/agent/metrics?format=prometheus")
    if status != 200 or not ctype.startswith("text/plain"):
        raise AssertionError(f"scrape: {status} {ctype}")
    families = parse_prometheus(text)
    missing = [f for f in OPERATOR_FAMILIES if f not in families]
    if missing:
        raise AssertionError(f"the scrape lacks {missing}")
    hists = [f for f, t in families.items() if t == "histogram"]
    les = set(re.findall(r'_hist_bucket\{le="([^"]+)"\}', text))
    want_les = {format(float(b), ".17g") for b in OPERATOR_BUCKETS} | {"+Inf"}
    if not hists or les != want_les:
        raise AssertionError(f"histogram buckets {sorted(les)}, want "
                             f"{sorted(want_les)}")
    log(f"operator: scrape {len(text)} bytes, {len(text.splitlines())} "
        f"lines, {len(families)} families in {scrape_ms:.2f} ms")
    if statsd.lines == 0:
        raise AssertionError("the statsd sink sent nothing")
    log(f"operator: statsd lines received {statsd.lines}, e.g. "
        f"{statsd.sample}")
    solver = client.agent().solver()
    panel, panel0 = solver["panel"], solver_before["panel"]
    exact = (sum(b["solves"] for b in panel["count_buckets"])
             - sum(b["solves"] for b in panel0["count_buckets"]))
    solves = panel["solves"] - panel0["solves"]
    dispatches = (solver["coalescer"]["dispatches"]
                  - solver_before["coalescer"]["dispatches"])
    if exact == 0 or solves - exact == 0 or dispatches == 0:
        raise AssertionError(f"/v1/agent/solver: {solves} solves, {exact} "
                             f"exact, {dispatches} dispatches")
    ledger = solver["mirror_cache"]["byte_ledger"]
    log(f"operator: /v1/agent/solver water-fill solves {solves - exact}, "
        f"greedy solves {exact}, coalescer dispatches {dispatches}, "
        f"mirror per_row_bytes {ledger['per_row_bytes']}")
    runtime = client.agent().runtime()
    if not runtime["locks"]["installed"] or runtime["locks"]["violations"]:
        raise AssertionError(f"/v1/agent/runtime locks {runtime['locks']}")
    parse_prometheus(http_ok(addr, "/v1/agent/runtime?format=prometheus"))
    prof = client.agent().profile()
    if not prof["profiler"]["samples"]:
        raise AssertionError("/v1/agent/profile: no samples")
    collapsed = http_ok(addr, "/v1/agent/profile?format=collapsed")
    if not re.match(r"^\S+;.* \d+$", collapsed.splitlines()[0]):
        raise AssertionError(f"collapsed: {collapsed[:200]!r}")
    doc = json.loads(http_ok(addr, "/v1/agent/profile?format=speedscope"))
    if doc["exporter"] != "nomad_tpu_torch.profile_observe" or not doc[
            "profiles"]:
        raise AssertionError(f"speedscope: {doc.get('exporter')}")
    for route in ("capacity", "raft", "reads"):
        fams = parse_prometheus(
            http_ok(addr, f"/v1/agent/{route}?format=prometheus"))
        if not fams:
            raise AssertionError(f"/v1/agent/{route}: empty exposition")
    debug = client.agent().debug()
    if not debug["threads"] or debug["device"]["device"] != str(
            agent.server.device):
        raise AssertionError(f"/v1/agent/debug: {list(debug)}")
    t0 = time.perf_counter()
    bundle = client.agent().debug_bundle()
    bundle_ms = (time.perf_counter() - t0) * 1000.0
    lacks = [k for k in BUNDLE_SECTIONS if k not in bundle]
    errors = [k for k in BUNDLE_SECTIONS
              if isinstance(bundle.get(k), dict) and set(bundle[k]) == {
                  "error"}]
    if lacks or errors or bundle["breaker"]["device"] != str(
            agent.server.device):
        raise AssertionError(f"bundle lacks {lacks}, errors in {errors}")
    log(f"operator: bundle {len(json.dumps(bundle))} bytes, "
        f"{len(BUNDLE_SECTIONS)} sections in {bundle_ms:.1f} ms")


def phase_operator(dev, card: str, tmp: str):
    """The agent's operator surface on the card: one port Agent in server
    mode built from its config file (statsd sink on a local UDP port this
    script binds, lock watchdog, histogram buckets, enable_debug, the
    runtime observatory), the 10,000 nodes over RPC from a beating
    SimFleet, and the headline and the count-100 service job through the
    SDK, each 1 warm-up and OPERATOR_ROUNDS timed rounds of register ->
    complete -> deregister -> complete (check_committed each). Then every
    operator route (check_operator_surface). Logs the ten lock sites with
    the most wait, the raft and store locks over the headline
    deregisters, the profiler's role shares under the headline, and the
    scrape's size and time. The watchdog is uninstalled and the global
    metrics registry restored before it returns. Returns (water-fill
    launches, greedy launches)."""
    from nomad_tpu_torch import structs, telemetry
    from nomad_tpu_torch.api import ApiClient
    from nomad_tpu_torch.ops import greedy, waterfill
    from nomad_tpu_torch.simcluster.simnode import SimFleet

    if threading.current_thread() is not threading.main_thread():
        raise AssertionError("the operator agent must be built on the main "
                             "thread (its SIGUSR1 dump)")
    metrics_was = telemetry.get_global()
    statsd = StatsdListener()
    agent = phase_operator_agent(dev, tmp, statsd.addr)
    fleet = None
    waterfill.LAUNCHES = 0
    greedy.LAUNCHES = 0
    try:
        wd = agent.lock_watchdog
        if wd is None:
            raise AssertionError("the operator agent installed no watchdog")
        agent.start()
        srv = agent.server
        deadline = time.perf_counter() + AGENT_WAIT_S
        while not srv.raft.is_leader:
            if time.perf_counter() > deadline:
                raise AssertionError("the operator agent never led")
            time.sleep(0.01)
        addr = f"http://127.0.0.1:{agent.http.port}"
        client = ApiClient(address=addr)
        fleet = SimFleet(srv.rpc_addr)
        reg = fleet.register(cluster_nodes())
        fleet.start_heartbeats()
        log(f"operator: {N_NODES} nodes over RPC in {reg['seconds']} s "
            f"[{card}]")
        solver_before = client.agent().solver()
        jobs = [
            make_job("operator-headline", structs.JOB_TYPE_BATCH, N_TASKS,
                     ["dc1"], job_id="operator-headline"),
            make_job("operator-service", structs.JOB_TYPE_SERVICE,
                     SERVICE_COUNT, ["dc1", "dc2"], job_id="operator-service"),
        ]
        for job in jobs:
            want = job.task_groups[0].count
            prof0 = client.agent().profile()["profiler"]
            rows = []
            for i in range(1 + OPERATOR_ROUNDS):
                row = operator_round(client, srv, job, want, wd)
                if i:
                    rows.append(row)
                log(f"operator {job.id} round {i}"
                    f"{' (warm-up)' if i == 0 else ''}: "
                    f"register_complete_ms={row[0]:.2f} "
                    f"deregister_complete_ms={row[1]:.2f} locks over the "
                    f"deregister {json.dumps(row[2])}")
            prof1 = client.agent().profile()["profiler"]
            log(f"operator {job.id}: register_complete_p50_ms="
                f"{p50([r[0] for r in rows]):.3f} "
                f"deregister_complete_p50_ms={p50([r[1] for r in rows]):.3f}"
                f" role shares over its rounds "
                f"{json.dumps(role_shares(prof0, prof1))} [{card}]")
        wf, gr = waterfill.LAUNCHES, greedy.LAUNCHES
        if wf == 0 or gr == 0:
            raise AssertionError(f"the operator phase launched water-fill "
                                 f"{wf} and greedy {gr} times; both must "
                                 "rise")
        check_operator_surface(agent, addr, client, statsd, solver_before)
        stats = wd.stats()
        if wd.violations:
            raise AssertionError(f"lock-order violations: {wd.violations}")
        log(f"operator: watchdog {stats['locks_tracked']} lock sites "
            f"acquired, violations {stats['violations']}; the ten with the "
            "most wait:")
        for row in stats["contention"][:10]:
            log(f"operator lock {row['lock']}: wait_total_ms="
                f"{row['wait_total_ms']} contended={row['contended']}/"
                f"{row['acquisitions']} wait_p50_ms={row['wait_ms']['p50']} "
                f"wait_p95_ms={row['wait_ms']['p95']} hold_p95_ms="
                f"{row['hold_ms']['p95']} [{card}]")
        for lock in (RAFT_LOCK, STORE_LOCK):
            row = next((r for r in stats["contention"] if r["lock"] == lock),
                       None)
            log(f"operator lock {lock} over the phase: {json.dumps(row)}")
        log(f"operator: waterfill_launches={wf} greedy_launches={gr}")
    finally:
        if fleet is not None:
            fleet.stop()
        agent.shutdown()
        statsd.stop()
        telemetry.set_global(metrics_was)
    if telemetry.active_lock_watchdog() is not None:
        raise AssertionError("the watchdog is still installed")
    return wf, gr


# -- 15. the solver mesh: node shards on the one card, and DCN --------------

# Shard counts of (a), each shard its own tensor on the card.
MESH_SHARDS = (1, 2, 4, 8)
# (b)'s mesh: 4 node shards on the card (configure_node_sharding with
# devices=[cuda:0] * 4).
MESH_NODE_SHARDS = 4
MESH_TIMED_EVALS = 2
# Water-fill rows of (a), as WF_SHAPES: the headline bucket (16384 rows,
# ~10,000 live in "random"; the headline's 5,000 nodes and 100,000 tasks)
# and the 131072-row bucket at B in {1, 8}, then the edge cases: "ties"
# (the boundary cut crosses shards), "saturated" (count above every cap:
# no candidate), "count0" (remaining 0), "ineligible", "bigcaps" (4 level
# passes).
MESH_WF_SHAPES = [(16384, 1, False, False, "random"),
                  (16384, 8, False, False, "random"),
                  (16384, 1, False, False, "headline"),
                  (16384, 8, True, True, "random"),
                  (131072, 1, False, False, "random"),
                  (131072, 8, False, False, "random"),
                  (16384, 2, False, False, "ties"),
                  (131072, 1, False, False, "ties"),
                  (16384, 2, False, False, "saturated"),
                  (16384, 2, False, False, "count0"),
                  (16384, 2, False, False, "ineligible"),
                  (16384, 2, False, False, "bigcaps")]
# Greedy rows of (a), as GREEDY_SHAPES ("random" evals have padding steps
# after their count; "infeasible" is an all -inf step every step).
MESH_GREEDY_SHAPES = [(16384, 1, 128, "random"), (16384, 8, 128, "random"),
                      (131072, 1, 128, "random"), (131072, 8, 128, "random"),
                      (16384, 2, 128, "ties"), (16384, 1, 128, "infeasible")]
# Rows of (a) on the per-pass route on the one card, (N, B, jd, td, mode,
# S, groups): groups > 1 is one solve as that many groups of one process
# each (a thread a group, first_index/n_shards, each group's shards
# combined on the card, then MeshReduce between the groups); groups = 1
# with S = 16 takes the per-pass route by rule (16 blocks an eval). At
# 131072 rows a shard is spread over 2 blocks (S = 4) or 4 (S = 2), and
# the "ties" cuts fall inside a block of a later shard (131072: after
# 70,537 rows, in group 1; 16384: after 13,193, in shard 12 of 16, or in
# shard 6 of 8, the fourth group's, whose boundary column is 6). The
# 16384 x 1 and 256 x 1 rows at S = 2 in two groups are the DCN ranks'
# shapes (DCN_CASES: one shard of 8,192 rows, or of 128, a rank).
MESH_PASS_ROWS = [(16384, 2, False, False, "random", 4, 2),
                  (16384, 1, False, False, "headline", 4, 2),
                  (131072, 1, False, False, "ties", 4, 2),
                  (131072, 2, True, True, "random", 2, 2),
                  (16384, 2, False, False, "ties", 16, 1),
                  (16384, 2, False, False, "ties", 8, 4),
                  (16384, 1, False, False, "headline", 2, 2),
                  (256, 1, False, False, "random", 2, 2)]
# The merge past the main path's widths, all staged and (S k above
# ~29,000) windowed, (N, B, k, S): 32 shards of 512 rows (a shard a lane),
# 64 of 256 (two a lane), 256 of 64, 512 of 32.
MESH_MERGE_WIDE = [(16384, 2, 128, 32), (16384, 2, 128, 64),
                   (16384, 1, 128, 256), (16384, 2, 128, 512)]
MERGE_SMEM_BYTES = 227 * 1024  # csrc/greedy.cu kMergeSmem
# The main path's shapes, for the kernels line: the headline eval on (b)'s
# mesh (8192-row bucket, 5,000 live, 100,000 tasks: one shard of 2,048
# rows) and the service eval's merge (16384 rows, k = 128, 4 shards).
MESH_MAIN_WF_ROWS = 8192
MESH_MAIN_GREEDY_SHAPE = (16384, 1, 128, "random")
# DCN rows (nodes, count): test_dcn.py's, and 16,384 nodes at level 6
# whose tie fill (10,000 of 16,384) crosses from rank 0 into rank 1.
DCN_CASES = [(256, 180), (16384, 16384 * 6 + 10_000)]


def shard_wf_args(args, s: int):
    """Batched water-fill args as S shards, each its own tensor."""
    n = args[0].shape[1]
    ns = n // s
    shards = [tuple(x[:, i * ns:(i + 1) * ns].contiguous()
                    for x in args[:8]) for i in range(s)]
    return shards, [tuple(args[8:12])] * s


def shard_greedy_args(args, s: int):
    """Batched exact-scan args as S shards, each its own tensor."""
    n = args[0].shape[0]
    ns = n // s
    out = []
    for i in range(s):
        rows = slice(i * ns, (i + 1) * ns)
        out.append((tuple(args[j][rows].contiguous() for j in (0, 1, 5)),
                    tuple(args[j][:, rows].contiguous()
                          for j in (2, 3, 4, 6, 7)),
                    (args[8], args[9], args[11])))
    return out


def group_solve(solve, shards, small, maxc, jd, td, groups: int = 2):
    """One solve as ``groups`` groups of one process each, as that many DCN
    ranks would run it: a thread a group, group g holding shards [g S/G,
    (g+1) S/G) (first_index g S/G, n_shards S), each running its passes
    with its shards combined on its device, and a seam that hands every
    group's row to MeshReduce. ``solve``: waterfill.solve_waterfill_sharded
    or its plain version. Returns (counts per shard, remaining), and
    raises if the groups' remaining differ."""
    import threading

    import torch
    from nomad_tpu_torch.parallel.mesh import MeshReduce

    per = len(shards) // groups
    barrier = threading.Barrier(groups, timeout=300)
    rows, out, errors = [None] * groups, [None] * groups, []

    def seam(g):
        def reduce(parts, op):
            (rows[g],) = parts
            barrier.wait()
            comb = MeshReduce()(list(rows), op)[g]
            barrier.wait()  # every group has read rows before the next round
            return [comb]
        return reduce

    def run(g):
        lo = g * per
        try:
            out[g] = solve(shards[lo:lo + per], small[lo:lo + per], maxc,
                           jd, td, seam(g), first_index=lo,
                           n_shards=len(shards))
        except Exception as exc:  # re-raised by the caller's thread
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(g,))
               for g in range(groups)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a group of the {groups}-group solve did not "
                           "finish")
    if not all(torch.equal(o[1], out[0][1]) for o in out):
        raise AssertionError(f"the {groups} groups' remaining differ")
    return [c for o in out for c in o[0]], out[0][1]


def mesh_pass_solve(row, shards, small, maxc: int, plain: bool):
    """A MESH_PASS_ROWS row's solve over its shards: its groups
    (group_solve) or one group on the per-pass route by rule. Returns
    (counts [B, N], remaining)."""
    import torch
    from nomad_tpu_torch.ops import waterfill
    from nomad_tpu_torch.parallel.mesh import MeshReduce

    jd, td, groups = row[2], row[3], row[6]
    solve = (waterfill.solve_waterfill_sharded_plain if plain
             else waterfill.solve_waterfill_sharded)
    if groups > 1:
        parts, rem = group_solve(solve, shards, small, maxc, jd, td, groups)
    else:
        parts, rem = solve(shards, small, maxc, jd, td, MeshReduce())
    return torch.cat(parts, 1), rem


def check_route(shards, single: bool, label: str, whole: bool = True):
    """The route shard_route gives these shards is the one a row means to
    run."""
    from nomad_tpu_torch.ops import waterfill

    route = waterfill.shard_route([x[0].device for x in shards],
                                  shards[0][0].shape[1], whole)
    if route.single != single:
        raise AssertionError(f"{label}: route single={route.single}, "
                             f"expected {single}")


def phase_mesh_kernels(dev, rng):
    """(a): each shard kernel against its plain version on CUDA tensors and
    the sharded solves against the unsharded kernels, exactly, at S in
    MESH_SHARDS (the single-launch route) and on MESH_PASS_ROWS (the
    per-pass route); the merge at MESH_GREEDY_SHAPES and, windowed, at
    MESH_MERGE_WIDE. Logs the sharded against the unsharded solve ms per
    S, the single launch alone per S, the rounds and the merge ms."""
    import torch
    from nomad_tpu_torch.ops import greedy, waterfill
    from nomad_tpu_torch.parallel.mesh import MeshReduce

    wf_err = 0
    for row in MESH_WF_SHAPES:
        n, b, jd, td, mode = row
        args = waterfill_case(rng, n, b, jd, td, mode, dev)
        want_c, want_r = waterfill.solve_waterfill_batched(*args)
        maxc = int(args[10].max())
        u_ms = cuda_ms(lambda: waterfill.solve_waterfill_batched(*args), 20)
        times, alone = {}, {}
        for s in MESH_SHARDS:
            shards, small = shard_wf_args(args, s)
            check_route(shards, True, f"{row} S={s}")
            parts, rem = waterfill.solve_waterfill_sharded(
                shards, small, maxc, jd, td, MeshReduce())
            p_parts, p_rem = waterfill.solve_waterfill_sharded_plain(
                shards, small, maxc, jd, td, MeshReduce())
            got = torch.cat(parts, 1)
            plain = torch.cat(p_parts, 1)
            torch.cuda.synchronize()
            err = max(int((got - plain).abs().max()),
                      int((got - want_c).abs().max()),
                      int((rem - want_r).abs().max()),
                      int((rem - p_rem).abs().max()))
            wf_err = max(wf_err, err)
            if not (torch.equal(got, plain) and torch.equal(rem, p_rem)):
                raise AssertionError(f"waterfill_shard kernel != plain at "
                                     f"{row} S={s}: max abs err {err}")
            if not (torch.equal(got, want_c) and torch.equal(rem, want_r)):
                raise AssertionError(f"sharded water-fill != unsharded "
                                     f"kernel at {row} S={s}")
            times[s] = cuda_ms(lambda: waterfill.solve_waterfill_sharded(
                shards, small, maxc, jd, td, MeshReduce()), 20)
            alone[s] = graph_ms(lambda: waterfill.shard_solve_only(
                shards, small[0], jd, td), 20)
        check_wf_mode(mode, want_c, want_r, args[10], n)
        log(f"mesh waterfill N={n} B={b} jd={jd} td={td} {mode}: equal at "
            f"S={list(MESH_SHARDS)}, one launch, unsharded_ms={u_ms:.4f} "
            "sharded_ms="
            + json.dumps({s: round(t, 4) for s, t in times.items()})
            + " solve_kernel_ms="
            + json.dumps({s: round(t, 5) for s, t in alone.items()}))

    pass_err = 0
    for row in MESH_PASS_ROWS:
        n, b, jd, td, mode, s, groups = row
        args = waterfill_case(rng, n, b, jd, td, mode, dev)
        want_c, want_r = waterfill.solve_waterfill_batched(*args)
        shards, small = shard_wf_args(args, s)
        maxc = int(args[10].max())
        half = s // groups
        for g in range(groups):
            check_route(shards[g * half:(g + 1) * half], False,
                        f"{row} group {g}", whole=groups == 1)
        got, rem = mesh_pass_solve(row, shards, small, maxc, False)
        plain, p_rem = mesh_pass_solve(row, shards, small, maxc, True)
        torch.cuda.synchronize()
        err = max(int((got - plain).abs().max()),
                  int((got - want_c).abs().max()),
                  int((rem - want_r).abs().max()))
        pass_err = max(pass_err, err)
        if not (torch.equal(got, plain) and torch.equal(rem, p_rem)):
            raise AssertionError(f"waterfill_shard pass kernel != plain at "
                                 f"{row}: max abs err {err}")
        if not (torch.equal(got, want_c) and torch.equal(rem, want_r)):
            raise AssertionError(f"per-pass sharded water-fill != "
                                 f"unsharded kernel at {row}")
        n_s = n // s
        check_wf_mode(mode, want_c, want_r, args[10],
                      -(-n_s // waterfill.shard_blocks(n_s)))
        ms = cuda_ms(lambda: mesh_pass_solve(row, shards, small, maxc,
                                             False), 3)
        log(f"mesh waterfill per-pass N={n} B={b} jd={jd} td={td} {mode} "
            f"S={s} groups={groups} blocks_a_shard="
            f"{waterfill.shard_blocks(n // s)}: equal, rounds="
            f"{waterfill.shard_rounds(maxc)} sharded_ms={ms:.4f}")

    merge_err = 0
    for row in MESH_GREEDY_SHAPES:
        n, b, k, mode = row
        args = greedy_case(rng, n, b, k, dev, mode=mode)
        want = greedy.solve_greedy_batched_shared(*args)
        u_ms = cuda_ms(lambda: greedy.solve_greedy_batched_shared(*args), 3)
        times, merge_ms = {}, {}
        for s in MESH_SHARDS:
            shards = shard_greedy_args(args, s)
            got = greedy.solve_greedy_sharded(shards, args[10], k, False,
                                              False)
            seq = gathered_sequences(shards, args[10], k)
            merge_err = max(merge_err, check_merge(seq, args[10], n // s,
                                                   got, want, f"{row} S={s}"))
            if mode == "infeasible" and (bool(got[1].any())
                                         or bool(got[0].any())):
                raise AssertionError("an all-infeasible sharded scan must "
                                     "give idx 0 and ok false")
            times[s] = cuda_ms(lambda: greedy.solve_greedy_sharded(
                shards, args[10], k, False, False), 3)
            merge_ms[s] = graph_ms(lambda: greedy.merge_kernel_only(
                *seq, args[10], n // s), 20)
        log(f"mesh greedy N={n} B={b} k={k} {mode}: equal at "
            f"S={list(MESH_SHARDS)}, unsharded_ms={u_ms:.4f} sharded_ms="
            + json.dumps({s: round(t, 4) for s, t in times.items()})
            + " merge_kernel_ms="
            + json.dumps({s: round(t, 5) for s, t in merge_ms.items()}))

    for n, b, k, s in MESH_MERGE_WIDE:
        window = greedy.merge_window(s, k)
        if (window < k) != (s * k * 8 + k > MERGE_SMEM_BYTES):
            raise AssertionError(f"the merge at S={s} k={k} staged "
                                 f"{window} entries a shard")
        args = greedy_case(rng, n, b, k, dev)
        want = greedy.solve_greedy_batched_shared(*args)
        shards = shard_greedy_args(args, s)
        got = greedy.solve_greedy_sharded(shards, args[10], k, False, False)
        seq = gathered_sequences(shards, args[10], k)
        merge_err = max(merge_err, check_merge(seq, args[10], n // s, got,
                                               want, f"wide S={s} k={k}"))
        ms = graph_ms(lambda: greedy.merge_kernel_only(*seq, args[10],
                                                       n // s), 20)
        log(f"mesh greedy merge warp path N={n} B={b} k={k} S={s} "
            f"window={window}: equal, merge_kernel_ms={ms:.5f}")
    return {"wf_err": wf_err, "pass_err": pass_err, "merge_err": merge_err}


def check_merge(seq, active, n_s: int, got, want, label: str) -> int:
    """The merge kernel against its plain version on the gathered
    sequences, and the sharded scan against the unsharded kernel; returns
    the largest difference."""
    import torch
    from nomad_tpu_torch.ops import greedy

    m_k = greedy.merge_greedy(*seq, active, n_s)
    m_p = greedy.merge_greedy_plain(*seq, active, n_s)
    torch.cuda.synchronize()
    err = max(int((m_k[0] - m_p[0]).abs().max()),
              int((m_k[1] != m_p[1]).sum()),
              int((got[0] - want[0]).abs().max()))
    if not all(torch.equal(x, y) for x, y in zip(m_k, m_p)):
        raise AssertionError(f"greedy_merge kernel != plain at {label}: "
                             f"max abs err {err}")
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"sharded scan != unsharded kernel at {label}")
    return err


def gathered_sequences(shards, active, k: int):
    """The [S, B, k] (local idx, score) sequences the sharded scan merges:
    each shard's scan over all k steps, as solve_greedy_sharded runs it."""
    import torch
    from nomad_tpu_torch.ops import greedy

    idxs, scores = [], []
    for (total, sched_cap, bw_avail), per, (ask, bw_ask, penalty) in shards:
        every = torch.ones_like(active)
        idx, _ok, score = greedy.solve_greedy_batched_shared(
            total, sched_cap, *per[:3], bw_avail, *per[3:], ask, bw_ask,
            every, penalty, k, False, False)
        idxs.append(idx)
        scores.append(score)
    return torch.stack(idxs), torch.stack(scores)


def mesh_kernel_numbers(dev):
    """The kernels line's numbers for the mesh's kernels at the main
    path's shapes: ms (CUDA graph of the kernel alone), plain ms and the
    bound."""
    import torch
    from nomad_tpu_torch.ops import greedy, waterfill
    from nomad_tpu_torch.parallel.mesh import MeshReduce

    n_s = MESH_MAIN_WF_ROWS // MESH_NODE_SHARDS
    rows = headline_arrays(MESH_MAIN_WF_ROWS, N_NODES // 2)
    dt = [torch.int32, torch.float32, torch.int32, torch.int32, torch.int32,
          torch.int32, torch.int32, torch.bool]
    shard = tuple(torch.tensor(np.asarray(a)[None, :n_s], dtype=t,
                               device=dev) for a, t in zip(rows[:8], dt))
    small = (torch.tensor(rows[8][None], device=dev),
             torch.tensor([int(rows[9])], dtype=torch.int32, device=dev),
             torch.tensor([N_TASKS], dtype=torch.int32, device=dev),
             torch.tensor([10.0], dtype=torch.float32, device=dev))
    wf_ms = graph_ms(lambda: waterfill.shard_kernel_only(
        shard, small, N_TASKS, False, False), 20)
    wf_plain = host_ms(lambda: waterfill.solve_waterfill_sharded_plain(
        [shard], [small], N_TASKS, False, False, MeshReduce()), 1)
    wf_bound, wf_by = bound_ms(*waterfill_work(*shard, *small, False, False))
    # The single launch: the whole headline eval, MESH_NODE_SHARDS shards.
    whole = tuple(torch.tensor(np.asarray(a)[None], dtype=t, device=dev)
                  for a, t in zip(rows[:8], dt))
    shards, smalls = shard_wf_args((*whole, *small), MESH_NODE_SHARDS)
    sv_ms = graph_ms(lambda: waterfill.shard_solve_only(
        shards, small, False, False), 20)
    sv_plain = host_ms(lambda: waterfill.solve_waterfill_sharded_plain(
        shards, smalls, N_TASKS, False, False, MeshReduce()), 1)
    sv_bound, sv_by = bound_ms(*waterfill_work(*whole, *small, False, False))

    rng = np.random.default_rng(SEED + 15)
    n, b, k, mode = MESH_MAIN_GREEDY_SHAPE
    args = greedy_case(rng, n, b, k, dev, mode=mode)
    seq = gathered_sequences(shard_greedy_args(args, MESH_NODE_SHARDS),
                             args[10], k)
    ns = n // MESH_NODE_SHARDS
    mg_ms = graph_ms(lambda: greedy.merge_kernel_only(*seq, args[10], ns), 20)
    mg_plain = host_ms(lambda: greedy.merge_greedy_plain(*seq, args[10], ns),
                       1)
    # Bytes: the [S, B, k] idx and score read once, active read, the three
    # [B, k] outputs written once; operations: one compare a shard a step.
    mg_bytes = bytes_of(*seq, args[10]) + b * k * (4 + 1 + 4)
    mg_bound, mg_by = bound_ms(mg_bytes, MESH_NODE_SHARDS * b * k)
    log(f"mesh kernels: waterfill_shard ms={wf_ms:.4f} "
        f"({waterfill.shard_rounds(N_TASKS) + 1} passes of one {n_s}-row "
        f"shard of the headline) plain_ms={wf_plain:.2f} "
        f"bound_ms={wf_bound:.6f} ({wf_by}); waterfill_shard_solve "
        f"ms={sv_ms:.5f} (one launch, {MESH_NODE_SHARDS} shards of the "
        f"headline's {MESH_MAIN_WF_ROWS} rows) plain_ms={sv_plain:.2f} "
        f"bound_ms={sv_bound:.6f} ({sv_by}); greedy_merge ms={mg_ms:.5f} "
        f"(S={MESH_NODE_SHARDS} B={b} k={k}) plain_ms={mg_plain:.2f} "
        f"bound_ms={mg_bound:.6f} ({mg_by})")
    return {"waterfill_shard": {"ms": wf_ms, "plain_ms": wf_plain,
                                "bound_ms": wf_bound, "bound_by": wf_by},
            "waterfill_shard_solve": {"ms": sv_ms, "plain_ms": sv_plain,
                                      "bound_ms": sv_bound,
                                      "bound_by": sv_by},
            "greedy_merge": {"ms": mg_ms, "plain_ms": mg_plain,
                             "bound_ms": mg_bound, "bound_by": mg_by}}


def plan_node_counts(plan):
    """Sorted multiset of a plan's per-node placement counts."""
    per_node = {}
    for b in plan.alloc_batches:
        for nid, cnt in zip(b.node_ids, b.node_counts):
            per_node[nid] = per_node.get(nid, 0) + int(cnt)
    for nid, allocs in plan.node_allocation.items():
        per_node[nid] = per_node.get(nid, 0) + len(allocs)
    return sorted(per_node.values())


def mesh_evals(h, dev, job, factory: str, label: str, want):
    """1 warm-up and MESH_TIMED_EVALS timed evals of ``job`` on the
    configured mesh: each plan checked (check_plan: all placed, capacity)
    with the unsharded run's per-node count multiset, and no node tensor
    resharded at dispatch on the evals after the warm-up. Returns the
    timed e2e ms."""
    import torch
    from nomad_tpu_torch.parallel import mesh as mesh_lib

    e2e = []
    for i in range(1 + MESH_TIMED_EVALS):
        ev = register_eval(h, job)
        mesh_lib.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h.process(factory, ev, device=dev)
        wall = (time.perf_counter() - t0) * 1000.0
        check_plan(h.state, h.plans[-1], job, job.task_groups[0].count)
        if plan_node_counts(h.plans[-1]) != want:
            raise AssertionError(f"mesh {label}: the per-node counts differ "
                                 "from the unsharded run's")
        stats = dict(mesh_lib.STATS)
        if i and stats["node_reshards"]:
            raise AssertionError(f"mesh {label}: a warm eval resharded a "
                                 f"node tensor at dispatch: {stats}")
        if i:
            e2e.append(wall)
        log(f"mesh {label} eval {i}{' (warm-up)' if i == 0 else ''}: "
            f"e2e_ms={wall:.2f} stats={json.dumps(stats)}")
    return e2e


def mesh_system_eval(dev, job):
    """One config-4 eval (a fresh alloc-free store, verified and committed
    as phase_system does); returns its committed per-node multiset and
    e2e ms."""
    import logging

    from nomad_tpu_torch import structs
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.structs import Evaluation, generate_uuid

    state = system_store(job)
    planner = VerifyingPlanner(state, 3)
    ev = Evaluation(id=generate_uuid(), priority=job.priority, type=job.type,
                    triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER,
                    job_id=job.id)
    t0 = time.perf_counter()
    new_scheduler("tpu-system", state.snapshot(), planner,
                  logging.getLogger("chip_smoke.mesh"), device=dev).process(ev)
    e2e = (time.perf_counter() - t0) * 1000.0
    if planner.status != structs.EVAL_STATUS_COMPLETE:
        raise AssertionError(f"mesh system eval ended {planner.status}")
    check_committed(state.snapshot(), job, system_placed(), per_node=1)
    counts = {}
    for blk in state.snapshot().alloc_blocks():
        if blk.job_id == job.id:
            for nid, cnt in blk.live_node_counts():
                counts[nid] = counts.get(nid, 0) + int(cnt)
    return sorted(counts.values()), e2e


def phase_mesh_scheduler(dev):
    """(b): the headline, the count-100 service job and config 4 through
    new_scheduler(..., device="cuda") on a 4-shard mesh of the one card,
    against the same evals unsharded. Returns the mesh kernels' launches
    (set to 0 just before the sharded evals, read just after: the shard
    kernel's, of them the single-launch route's, and the merge's) and
    the earlier kernels' launches there."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import greedy, waterfill
    from nomad_tpu_torch.parallel import mesh as mesh_lib

    jobs = [("headline", make_job("mesh-batch", structs.JOB_TYPE_BATCH,
                                  N_TASKS, ["dc1"]), "tpu-batch"),
            ("service", make_job("mesh-svc", structs.JOB_TYPE_SERVICE,
                                 SERVICE_COUNT, ["dc1", "dc2"]),
             "tpu-service")]
    sys_job = system_job("mesh-sys")
    h = build_cluster()
    want = {}
    for label, job, factory in jobs:
        h.process(factory, register_eval(h, job), device=dev)
        want[label] = plan_node_counts(h.plans[-1])
    want_sys, sys_u_ms = mesh_system_eval(dev, sys_job)

    mesh_lib.configure_node_sharding(MESH_NODE_SHARDS,
                                     devices=[dev] * MESH_NODE_SHARDS)
    try:
        h = build_cluster()  # a fresh store: its mirror is born sharded
        waterfill.SHARD_LAUNCHES = 0
        waterfill.SHARD_SOLVE_LAUNCHES = 0
        greedy.MERGE_LAUNCHES = 0
        waterfill.LAUNCHES = 0
        greedy.LAUNCHES = 0
        e2e = {}
        for label, job, factory in jobs:
            e2e[label] = p50(mesh_evals(h, dev, job, factory, label,
                                        want[label]))
        sys_ms = []
        for i in range(1 + MESH_TIMED_EVALS):
            mesh_lib.reset_stats()
            got, ms = mesh_system_eval(dev, sys_job)
            if got != want_sys:
                raise AssertionError("mesh system: the committed per-node "
                                     "counts differ from the unsharded run's")
            if mesh_lib.STATS["node_reshards"]:
                raise AssertionError(f"mesh system: a node tensor was "
                                     f"resharded: {mesh_lib.STATS}")
            if i:
                sys_ms.append(ms)
        e2e["system"] = p50(sys_ms)
        launches = {"waterfill_shard": waterfill.SHARD_LAUNCHES,
                    "waterfill_shard_solve": waterfill.SHARD_SOLVE_LAUNCHES,
                    "greedy_merge": greedy.MERGE_LAUNCHES,
                    "waterfill": waterfill.LAUNCHES,
                    "greedy": greedy.LAUNCHES}
    finally:
        mesh_lib.clear_node_sharding()
    if not (launches["waterfill_shard"] and launches["waterfill_shard_solve"]
            and launches["greedy_merge"] and launches["greedy"]):
        raise AssertionError(f"the mesh path missed a kernel: {launches}")
    if launches["waterfill"]:
        raise AssertionError("the sharded headline launched the unsharded "
                             "water-fill")
    log(f"mesh scheduler: {MESH_NODE_SHARDS} shards on one card, per-node "
        f"counts equal the unsharded runs', e2e_p50_ms="
        + json.dumps({k: round(v, 3) for k, v in e2e.items()})
        + f" (system unsharded eval {sys_u_ms:.3f} ms) launches="
        + json.dumps(launches))
    return launches


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_mesh_server(dev):
    """(b), the config face: a Server with solver_mesh { node_shards = 4 }
    on the one card logs nomad_tpu's too-few-devices warning, configures
    no mesh, and places the service job single-device on the card."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import greedy, waterfill
    from nomad_tpu_torch.parallel import mesh as mesh_lib

    records = _Records()
    logging.getLogger().addHandler(records)
    try:
        srv = new_server(dev, solver_mesh={"node_shards": MESH_NODE_SHARDS})
    finally:
        logging.getLogger().removeHandler(records)
    try:
        warned = [m for m in records.messages
                  if m.startswith(f"solver_mesh wants {MESH_NODE_SHARDS} "
                                  "device(s)")
                  and "solves stay single-device" in m]
        if not warned or mesh_lib.node_sharding_mesh() is not None:
            raise AssertionError("the server's solver_mesh on one card did "
                                 "not fall back with its warning")
        job = make_job("mesh-srv", structs.JOB_TYPE_SERVICE, SERVICE_COUNT,
                       ["dc1", "dc2"])
        greedy.LAUNCHES = 0
        greedy.MERGE_LAUNCHES = 0
        reg, _dereg, live, _eid = server_round(srv, job)
        if not greedy.LAUNCHES or greedy.MERGE_LAUNCHES:
            raise AssertionError("the fallen-back server did not solve "
                                 "single-device on the card")
        log(f"mesh server: {warned[0]!r}; service job committed={live} "
            f"register_ms={reg:.2f} single-device greedy_launches="
            f"{greedy.LAUNCHES}")
        return greedy.LAUNCHES
    finally:
        srv.shutdown()


def phase_mesh_dcn(dev):
    """(c): two ranks on the one card over gloo, per DCN_CASES; both
    DCN_RESULTs ok (each rank's pass kernel equal to the plain passes on
    its own shard through the same DistReduce) and their counts equal the
    unsharded kernel's. Returns (the ranks' launches of the shard kernel,
    the per-pass route's, each rank's count starting at 0 in its own
    process; the largest difference from the plain passes)."""
    import torch
    from nomad_tpu_torch.ops import waterfill
    from nomad_tpu_torch.parallel import dcn

    launches, err = 0, 0
    for n_nodes, count in DCN_CASES:
        t0 = time.perf_counter()
        results, _outs = dcn.spawn_dcn_workers(
            2, n_nodes, count, timeout=300.0, device=f"cuda:{dev.index or 0}")
        wall = time.perf_counter() - t0
        case = [torch.tensor(a, device=dev) for a in dcn.dcn_case(n_nodes,
                                                                  count)]
        want, rem = waterfill.solve_waterfill_batched(*case, False, False)
        digest = dcn.counts_digest(want[0].cpu().numpy())
        for r in results:
            if not (r["ok"] and r["plain_equal"]
                    and r["counts_sha256"] == digest
                    and r["backend"] == "gloo" and int(rem[0]) == 0
                    and r["shard_launches"] > 0):
                raise AssertionError(f"dcn rank result {r} != the "
                                     "unsharded kernel's")
            launches += r["shard_launches"]
            err = max(err, r["plain_max_abs_err"])
        log(f"mesh dcn: 2 ranks on {results[0]['device']} over gloo, "
            f"{n_nodes} nodes x {count} tasks: both ok, each rank's pass "
            "kernel equal to the plain passes on its shard, counts equal the "
            f"unsharded kernel's, nodes_used={results[0]['nodes_used']}, "
            f"shard_launches={[r['shard_launches'] for r in results]}, "
            f"{wall:.1f} s with the workers' start")
    return launches, err


def phase_mesh(dev, rng):
    """Phase 15. Returns (kernel numbers, launches on the main path)."""
    t0 = time.perf_counter()
    res = phase_mesh_kernels(dev, rng)
    numbers = mesh_kernel_numbers(dev)
    t1 = time.perf_counter()
    launches = phase_mesh_scheduler(dev)
    t2 = time.perf_counter()
    launches["greedy"] += phase_mesh_server(dev)
    t3 = time.perf_counter()
    dcn_launches, dcn_err = phase_mesh_dcn(dev)
    launches["waterfill_shard_pass"] = (
        launches["waterfill_shard"] - launches["waterfill_shard_solve"]
        + dcn_launches)
    res["pass_err"] = max(res["pass_err"], dcn_err)
    log(f"mesh: phase {time.perf_counter() - t0:.1f} s (kernels "
        f"{t1 - t0:.1f}, scheduler {t2 - t1:.1f}, server {t3 - t2:.1f}, "
        f"dcn {time.perf_counter() - t3:.1f})")
    return res, numbers, launches


# -- 16. the secure cell, the uplink, the native verifier, the oracle ------

SECURE_MEMBERS = 3
# The real Client's job: mock_driver tasks, which only a node whose
# client enabled that driver can take (none of the 10,000 fake nodes).
SECURE_CLIENT_COUNT = 4
SECURE_WAIT_S = 120.0
# The cell never deregisters the headline, so no FSM apply holds a raft
# lock for seconds (phase 7's reason for 10-15 s elections): 2-3 s.
SECURE_RAFT = dict(heartbeat_interval=0.1, election_timeout_min=2.0,
                   election_timeout_max=3.0)
SECURE_TOKEN = "chip-smoke-uplink"
SECURE_INFRA = "chip-smoke"
# tests/test_fuzz_differential.py's N_KERNEL_SEEDS and seed base.
ORACLE_SEEDS = 60
ORACLE_SEED_BASE = 10_000
# The pow contract's band (ROADMAP Queue 3 item 1): torch's CUDA pow is
# not the kernel's accurate powf, so two candidate scores this close may
# order differently.
ULP_BAND = 256
NATIVE_REPS = 20


def make_certs(d: str) -> dict:
    """Test-only keys, one day valid, made with the openssl CLI in ``d``:
    a CA; a server pair whose SAN is the loopback (localhost, 127.0.0.1),
    which the servers also present when they dial each other; a client
    pair signed by the CA; and a client pair signed by a second CA that
    nothing trusts."""
    def run(*args):
        subprocess.run(args, check=True, capture_output=True, timeout=60)

    def ca(name):
        key, crt = os.path.join(d, f"{name}.key"), os.path.join(d, f"{name}.crt")
        run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", key, "-out", crt, "-days", "1",
            "-subj", f"/CN=chip-smoke-{name}")
        return key, crt

    def pair(name, cn, ca_key, ca_crt, san):
        key, csr, crt = (os.path.join(d, f"{name}.{ext}")
                         for ext in ("key", "csr", "crt"))
        ext = os.path.join(d, f"{name}.cnf")
        with open(ext, "w") as f:
            f.write((f"subjectAltName={san}\n" if san else "")
                    + "basicConstraints=CA:FALSE\n")
        run("openssl", "req", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
            "-out", csr, "-subj", f"/CN={cn}")
        run("openssl", "x509", "-req", "-in", csr, "-CA", ca_crt, "-CAkey",
            ca_key, "-CAcreateserial", "-days", "1", "-extfile", ext,
            "-out", crt)
        return crt, key

    ca_key, ca_crt = ca("ca")
    rogue_key, rogue_crt = ca("rogue-ca")
    server = pair("server", "localhost", ca_key, ca_crt,
                  "DNS:localhost,IP:127.0.0.1")
    client = pair("client", "chip-smoke-client", ca_key, ca_crt, "")
    rogue = pair("rogue", "chip-smoke-rogue", rogue_key, rogue_crt, "")
    return {"ca": ca_crt, "server": server, "client": client,
            "rogue": rogue}


def secure_tls(certs: dict, pair: str = "server"):
    """Mutual TLS (verify_incoming on), trusting the CA, presenting
    ``pair``; hostnames not checked (one region-shared server pair)."""
    from nomad_tpu_torch.tlsutil import TLSConfig

    crt, key = certs[pair]
    return TLSConfig(enabled=True, ca_file=certs["ca"], cert_file=crt,
                     key_file=key, verify_incoming=True,
                     verify_hostname=False)


def check_refusals(certs: dict, addr: str) -> None:
    """A plaintext dial and a client presenting the untrusted CA's pair
    must both fail against a TLS listener; the client pair gets through."""
    from nomad_tpu_torch.rpc import ConnPool, RPCError

    for label, tls in (("plaintext", None),
                       ("untrusted certificate", secure_tls(certs, "rogue"))):
        pool = ConnPool(timeout=5.0, ssl_context=(
            tls.outgoing_context() if tls is not None else None))
        try:
            pool.call(addr, "Status.Ping", {})
        except RPCError as exc:
            log(f"secure: {label} dial refused ({type(exc).__name__}: {exc})")
        else:
            raise AssertionError(f"a {label} dial reached {addr}")
        finally:
            pool.shutdown()
    pool = ConnPool(timeout=5.0, ssl_context=secure_tls(
        certs, "client").outgoing_context())
    try:
        if pool.call(addr, "Status.Ping", {}) != "pong":
            raise AssertionError("the client pair's ping got no pong")
    finally:
        pool.shutdown()


def secure_register(servers, leader, follower, job) -> float:
    """Register ``job`` through ``follower``; wait for it complete on the
    leader and applied by every member, check every member's store;
    returns register->complete ms (on the leader)."""
    want = job.task_groups[0].count
    t0 = time.perf_counter()
    eid, _ = cluster_call(lambda: follower.job_register(job), "Job.Register")
    reg = (wait_complete(leader, eid) - t0) * 1000.0
    every = (wait_members(servers, eid, leader.raft.applied_index)
             - t0) * 1000.0
    for srv in servers:
        check_committed(srv.state_store.snapshot(), job, want)
    log(f"secure {job.name}: register_complete_ms={reg:.3f} "
        f"all_members_ms={every:.3f} committed={want} on each of "
        f"{len(servers)} members")
    return reg


def mock_job(job_id: str, count: int):
    """A batch job of ``count`` mock_driver tasks of 0.1 s, exit 0."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.structs import (
        Job, Resources, RestartPolicy, Task, TaskGroup,
    )

    return Job(region="global", id=job_id, name=job_id,
               type=structs.JOB_TYPE_BATCH, priority=50,
               datacenters=["dc1"], task_groups=[TaskGroup(
                   name="g", count=count,
                   restart_policy=RestartPolicy(attempts=0, interval=60.0,
                                                delay=1.0),
                   tasks=[Task(name="m", driver="mock_driver",
                               config={"run_for": 0.1, "exit_code": 0},
                               resources=Resources(cpu=100, memory_mb=64))],
               )])


def secure_client(certs: dict, servers, tmp: str) -> None:
    """One real Client over mutual TLS to a follower runs a count-
    SECURE_CLIENT_COUNT mock_driver job to dead."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.client import Client, ClientConfig

    leader = current_leader(servers)
    follower = next(s for s in servers if s is not leader)
    t0 = time.perf_counter()
    client = Client(ClientConfig(
        state_dir=os.path.join(tmp, "client", "state"),
        alloc_dir=os.path.join(tmp, "client", "allocs"),
        node_name="secure-client", servers=[follower.rpc_addr],
        options={"driver.mock_driver.enable": "1"},
        tls=secure_tls(certs, "client")))
    client.start()
    try:
        wait_for("the TLS client's node ready", lambda: (
            (n := leader.state_store.node_by_id(client.node.id)) is not None
            and n.status == structs.NODE_STATUS_READY), SECURE_WAIT_S)
        t1 = time.perf_counter()
        job = mock_job("secure-mock", SECURE_CLIENT_COUNT)
        eid, _ = cluster_call(lambda: follower.job_register(job),
                              "Job.Register")
        wait_complete(leader, eid)

        def all_dead():
            allocs = leader.state_store.allocs_by_job(job.id)
            return (len(allocs) == SECURE_CLIENT_COUNT and all(
                a.client_status == structs.ALLOC_CLIENT_STATUS_DEAD
                and a.node_id == client.node.id for a in allocs))
        wait_for("the TLS client's tasks dead", all_dead, SECURE_WAIT_S)
        log(f"secure client: node ready {(t1 - t0) * 1000.0:.1f} ms after "
            f"start, {SECURE_CLIENT_COUNT} mock tasks dead "
            f"{(time.perf_counter() - t1) * 1000.0:.1f} ms after register, "
            "every RPC over mutual TLS")
    finally:
        client.shutdown(destroy_allocs=True)


def committed_rows(snap):
    """Per node of ``snap`` (sorted by id), the summed live asks plus the
    reserved resources, and the totals, as int32 [N, 4] rows: the plan
    verifier's fit_check input."""
    usage, _ = committed_usage(snap)
    nodes = sorted(snap.nodes(), key=lambda n: n.id)
    zero = np.zeros(4, dtype=np.int64)
    used = np.array([usage.get(n.id, zero) + np.asarray(
        n.reserved.as_vector() if n.reserved else zero) for n in nodes],
        dtype=np.int64)
    total = np.array([n.resources.as_vector() for n in nodes],
                     dtype=np.int64)
    return used.astype(np.int32), total.astype(np.int32)


def phase_secure_cell(dev, certs: dict, tmp: str):
    """(a): a three-member ClusterServer cell over mutual TLS; the
    refusals; the 10,000 nodes, the headline and the count-100 service
    job through a follower, committed on every member (the headline is
    not deregistered: its 100,000-stop apply holds the raft lock for
    seconds); a real Client over TLS. Returns the verifier's fit_check
    rows of the leader's store."""
    from nomad_tpu_torch import native, structs
    from nomad_tpu_torch.server.cluster import ClusterConfig, form_cluster
    from nomad_tpu_torch.server.server import ServerConfig

    fit0 = native.CALLS["fit_check"]
    t0 = time.perf_counter()
    servers = form_cluster(SECURE_MEMBERS, ServerConfig(
        scheduler_backend="tpu", device=str(dev),
        min_heartbeat_ttl=SERVER_HEARTBEAT_TTL_S, tls=secure_tls(certs),
    ), base_cluster=ClusterConfig(bind_host="127.0.0.1", **SECURE_RAFT))
    try:
        leader = current_leader(servers)
        follower = next(s for s in servers if s is not leader)
        log(f"secure: {SECURE_MEMBERS} members over mutual TLS, leader "
            f"{leader.cluster.node_id} after "
            f"{(time.perf_counter() - t0) * 1000.0:.1f} ms")
        check_refusals(certs, follower.rpc_addr)
        t0 = time.perf_counter()
        cluster_call(lambda: follower.node_batch_register(cluster_nodes()),
                     "Node.BatchRegister")
        settle(servers, leader.raft.applied_index)
        counts = [len(s.state_store.nodes()) for s in servers]
        if counts != [N_NODES] * SECURE_MEMBERS:
            raise AssertionError(f"members hold {counts} nodes")
        log(f"secure: {N_NODES} nodes through a follower to every member in "
            f"{(time.perf_counter() - t0) * 1000.0:.1f} ms")
        secure_register(servers, leader, follower, make_job(
            "secure-batch", structs.JOB_TYPE_BATCH, N_TASKS, ["dc1"]))
        secure_register(servers, leader, follower, make_job(
            "secure-svc", structs.JOB_TYPE_SERVICE, SERVICE_COUNT,
            ["dc1", "dc2"]))
        secure_client(certs, servers, tmp)
        rows = committed_rows(current_leader(servers).state_store.snapshot())
    finally:
        for srv in servers:
            srv.shutdown(drain_timeout=5.0)
    calls = native.CALLS["fit_check"] - fit0
    log(f"secure: native fit_check calls on the verify path {calls}")
    if calls < 1:
        raise AssertionError("the plan verifier never called the native "
                             "fit_check")
    return rows


def uplink_config_hcl(data_dir: str, device: str, certs: dict,
                      endpoint: str) -> str:
    crt, key = certs["server"]
    return f"""data_dir = "{data_dir}"
name = "uplink-1"
bind_addr = "127.0.0.1"
device = "{device}"

ports {{
    http = 0
    rpc = 0
}}

server {{
    enabled = true
    bootstrap_expect = 1
}}

tls {{
    enabled = true
    ca_file = "{certs['ca']}"
    cert_file = "{crt}"
    key_file = "{key}"
    verify_incoming = true
    uplink = true
}}

atlas {{
    endpoint = "{endpoint}"
    infrastructure = "{SECURE_INFRA}"
    token = "{SECURE_TOKEN}"
}}
"""


def tunnel_json(broker, verb: str, path: str, body=None,
                timeout: float = 30.0):
    resp = broker.http(SECURE_INFRA, verb, path, body=body, timeout=timeout)
    if resp["status"] != 200:
        raise AssertionError(f"{verb} {path} through the uplink: "
                             f"{resp['status']} {resp['body'][:200]}")
    return json.loads(resp["body"]), resp["headers"]


def phase_secure_uplink(dev, certs: dict, tmp: str) -> None:
    """(b): a server-mode agent from a config file (TLS on its RPC tier,
    tls.uplink) dials an in-process UplinkBroker over mutual TLS; the
    headline is registered through the tunnel and its 100,000 alloc
    stubs read back through it; a blocking query parked through the
    tunnel wakes on a second registration."""
    from nomad_tpu_torch import agent_config, structs, telemetry
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api.codec import to_dict
    from nomad_tpu_torch.scada import UplinkBroker

    metrics_was = telemetry.get_global()
    broker = UplinkBroker(token=SECURE_TOKEN,
                          ssl_context=secure_tls(certs).incoming_context())
    path = os.path.join(tmp, "uplink.hcl")
    with open(path, "w") as f:
        f.write(uplink_config_hcl(os.path.join(tmp, "uplink"), dev.type,
                                  certs, broker.addr))
    cfg = AgentConfig.from_file_config(agent_config.default_config().merge(
        agent_config.load_config_file(path)))
    if not (cfg.tls_uplink and cfg.tls is not None and cfg.atlas_endpoint):
        raise AssertionError("the uplink config file lost its tls or atlas "
                             "block")
    agent = Agent(cfg)
    agent.server.config.min_heartbeat_ttl = SERVER_HEARTBEAT_TTL_S
    try:
        t0 = time.perf_counter()
        agent.start()
        srv = agent.server
        wait_for("the uplink agent leading", lambda: srv.raft.is_leader,
                 SECURE_WAIT_S)
        wait_for("the uplink session",
                 lambda: SECURE_INFRA in broker.sessions(), SECURE_WAIT_S)
        log(f"secure uplink: session up "
            f"{(time.perf_counter() - t0) * 1000.0:.1f} ms after start, "
            f"TLS on the tunnel and the RPC tier")
        check_refusals(certs, srv.rpc_addr)
        srv.node_batch_register(cluster_nodes())
        job = make_job("uplink-batch", structs.JOB_TYPE_BATCH, N_TASKS,
                       ["dc1"])
        t0 = time.perf_counter()
        out, _ = tunnel_json(broker, "PUT", "/v1/jobs",
                             {"job": to_dict(job)})
        reg = (wait_complete(srv, out["eval_id"]) - t0) * 1000.0
        check_committed(srv.state_store.snapshot(), job, N_TASKS)
        t0 = time.perf_counter()
        stubs, _ = tunnel_json(broker, "GET",
                               f"/v1/job/{job.id}/allocations",
                               timeout=SECURE_WAIT_S)
        read = (time.perf_counter() - t0) * 1000.0
        live = [a for a in stubs if a["desired_status"] == "run"]
        if len(live) != N_TASKS or {a["job_id"] for a in live} != {job.id}:
            raise AssertionError(f"{len(live)} live stubs of {job.name} "
                                 f"through the uplink, want {N_TASKS}")
        _, headers = tunnel_json(broker, "GET", "/v1/jobs")
        index = int(headers["X-Nomad-Index"])
        got = {}

        def poll():
            try:
                got["out"] = tunnel_json(
                    broker, "GET", f"/v1/jobs?index={index}&wait=60s",
                    timeout=90.0)
            except Exception as exc:  # surfaced below
                got["err"] = exc
        waiter = threading.Thread(target=poll, daemon=True)
        waiter.start()
        time.sleep(0.3)
        if got:
            raise AssertionError(f"the blocking query did not park: {got}")
        second = make_job("uplink-svc", structs.JOB_TYPE_SERVICE,
                          SERVICE_COUNT, ["dc1", "dc2"])
        t0 = time.perf_counter()
        out, _ = tunnel_json(broker, "PUT", "/v1/jobs",
                             {"job": to_dict(second)})
        waiter.join(SECURE_WAIT_S)
        woke = (time.perf_counter() - t0) * 1000.0
        if "out" not in got:
            raise AssertionError(f"the parked query never woke: {got}")
        jobs, headers = got["out"]
        if (int(headers["X-Nomad-Index"]) <= index
                or second.id not in {j["id"] for j in jobs}):
            raise AssertionError("the parked query woke without the second "
                                 "job")
        wait_complete(srv, out["eval_id"])
        check_committed(srv.state_store.snapshot(), second, SERVICE_COUNT)
        log(f"secure uplink: headline register_complete_ms={reg:.3f} "
            f"through the tunnel; {len(stubs)} alloc stubs read through it "
            f"in {read:.1f} ms; a parked blocking query woke "
            f"{woke:.1f} ms after the second registration; provider "
            f"sessions {agent.uplink.sessions}")
    finally:
        agent.shutdown()
        broker.shutdown()
        telemetry.set_global(metrics_was)


def phase_secure_native(rows) -> None:
    """(c): the native library, built at first use from the checkout's
    source, against its plain version, exactly, on the headline cell's
    verifier rows and on the same rows with every 97th pushed over one
    dimension; logs each alone over NATIVE_REPS calls."""
    from nomad_tpu_torch import native

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native library did not build or load")
    log(f"secure native: {native.library_path().name} available "
        f"({(time.perf_counter() - t0) * 1000.0:.1f} ms to load or build)")
    used, total = rows
    over = used.copy()
    pushed = np.arange(0, len(over), 97)
    over[pushed, pushed % 4] = total[pushed, pushed % 4] + 1
    for label, u in (("headline rows", used), ("rows pushed over", over)):
        got, want = native.fit_check(u, total), native.fit_check_plain(
            u, total)
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            raise AssertionError(f"native fit_check != plain on the {label}")
    if not native.fit_check(used, total)[0].all():
        raise AssertionError("a committed node does not fit its tasks")

    def alone_us(fn):
        fn(used, total)
        t0 = time.perf_counter()
        for _ in range(NATIVE_REPS):
            fn(used, total)
        return (time.perf_counter() - t0) * 1e6 / NATIVE_REPS
    log(f"secure native: fit_check on {used.shape[0]} x {used.shape[1]} "
        f"int32 rows equal to the plain version (and with "
        f"{int((~native.fit_check_plain(over, total)[0]).sum())} rows over); "
        f"native {alone_us(native.fit_check):.1f} us, plain "
        f"{alone_us(native.fit_check_plain):.1f} us a call")


def fuzz_solve_inputs(rng):
    """tests/test_fuzz_differential.py's _random_solve_inputs, draw for
    draw (that module imports jax)."""
    n = int(rng.choice([8, 16, 32, 64, 128]))
    total = np.zeros((n, 4), dtype=np.int32)
    total[:, 0] = rng.integers(200, 8000, n)
    total[:, 1] = rng.integers(128, 16384, n)
    total[:, 2] = rng.integers(1024, 200_000, n)
    total[:, 3] = rng.integers(10, 300, n)
    used = np.zeros((n, 4), dtype=np.int32)
    if rng.random() < 0.5:
        frac = rng.random((n, 1)) * rng.choice([0.5, 0.95])
        used = (total * frac).astype(np.int32)
    job_count = rng.integers(0, 3, n).astype(np.int32) * (rng.random() < 0.4)
    tg_count = np.minimum(job_count, rng.integers(0, 2, n)).astype(np.int32)
    bw_avail = rng.integers(100, 2000, n).astype(np.int32)
    bw_used = (bw_avail * rng.random(n) * 0.8).astype(np.int32) * (
        rng.random() < 0.5
    )
    eligible = rng.random(n) > rng.choice([0.0, 0.3, 0.9])
    ask = np.array([
        int(rng.integers(1, 1500)), int(rng.integers(1, 2048)),
        int(rng.integers(0, 2000)), int(rng.integers(0, 50)),
    ], dtype=np.int32)
    bw_ask = int(rng.integers(0, 200)) if rng.random() < 0.5 else 0
    count = int(rng.integers(1, 800))
    penalty = float(rng.choice([5.0, 10.0]))
    jd = bool(rng.random() < 0.15)
    td = bool(rng.random() < 0.15 and not jd)
    return dict(
        total=total, used=used, job_count=job_count, tg_count=tg_count,
        bw_avail=bw_avail, bw_used=bw_used, eligible=eligible, ask=ask,
        bw_ask=bw_ask, count=count, penalty=penalty, jd=jd, td=td,
    )


def fuzz_tensors(s, dev):
    """A fuzz_solve_inputs case as the ten node and ask tensors of one
    eval on ``dev``."""
    import torch

    i32 = lambda a: torch.tensor(np.asarray(a, dtype=np.int32), device=dev)
    return (i32(s["total"]),
            torch.tensor(s["total"][:, :2].astype(np.float32), device=dev),
            i32(s["used"]), i32(s["job_count"]), i32(s["tg_count"]),
            i32(s["bw_avail"]), i32(s["bw_used"]),
            torch.tensor(s["eligible"], device=dev), i32(s["ask"]),
            i32(s["bw_ask"]))


def kernel_counts(t, count: int, penalty: float, jd: bool, td: bool):
    """One eval through the water-fill wrapper (B = 1): the kernel on the
    card, its plain version on the CPU."""
    import torch

    from nomad_tpu_torch.ops import waterfill

    dev = t[0].device
    counts, left = waterfill.solve_waterfill_batched(
        *[x.unsqueeze(0) for x in t],
        torch.tensor([count], dtype=torch.int32, device=dev),
        torch.tensor([penalty], dtype=torch.float32, device=dev), jd, td)
    return counts[0].cpu().numpy(), int(left[0])


def f32_ulp_gap(a: float, b: float) -> int:
    def key(x):
        bits = int(np.asarray(x, dtype=np.float32).view(np.uint32))
        return (~bits & 0xFFFFFFFF) if bits >> 31 else bits | 0x80000000
    return abs(key(a) - key(b))


def boundary_gap(s, t):
    """ulp gap between the k-th and (k+1)-th candidate scores of the
    partial round (k = the tasks left after the full rounds), scored by
    torch on the tensors' device; None when that round takes all of its
    candidates or none."""
    import torch

    from nomad_tpu_torch.ops.binpack import _greedy_step_state

    total, used, ask, count = s["total"], s["used"], s["ask"], s["count"]
    avail = total.astype(np.int64) - used
    nonneg = np.all(avail >= 0, axis=1) & (s["bw_used"] <= s["bw_avail"])
    cap = np.where(ask > 0, avail // np.maximum(ask, 1), 2**30).min(axis=1)
    if s["bw_ask"] > 0:
        cap = np.minimum(cap, (s["bw_avail"] - s["bw_used"]) // s["bw_ask"])
    if s["jd"]:
        cap = np.minimum(cap, (s["job_count"] == 0).astype(cap.dtype))
    if s["td"]:
        cap = np.minimum(cap, (s["tg_count"] == 0).astype(cap.dtype))
    cap = np.where(s["eligible"] & nonneg, np.clip(cap, 0, count), 0)
    lo, hi = 0, min(count, int(cap.max()))
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if np.minimum(cap, mid).sum() <= count:
            lo = mid
        else:
            hi = mid - 1
    base = np.minimum(cap, lo)
    remaining = count - int(base.sum())
    dev = t[0].device
    b = torch.tensor(base.astype(np.int32), device=dev)
    score, fit = _greedy_step_state(
        t[0], t[1], t[2] + b.unsqueeze(-1) * t[8].unsqueeze(0), t[3] + b,
        t[4] + b, t[5], t[6] + b * t[9], t[7], t[8], t[9], s["penalty"],
        s["jd"], s["td"])
    cand = fit.cpu().numpy() & (cap > lo)
    scores = np.sort(score.cpu().numpy()[cand])[::-1]
    if remaining <= 0 or remaining >= len(scores):
        return None
    return f32_ulp_gap(scores[remaining - 1], scores[remaining])


def check_sound(s, counts) -> None:
    """Every placement fits its node under the case's constraints."""
    avail = s["total"].astype(np.int64) - s["used"]
    for i in np.flatnonzero(counts):
        n = int(counts[i])
        ok = (bool(s["eligible"][i]) and bool(np.all(s["ask"] * n <= avail[i]))
              and (s["bw_ask"] == 0 or s["bw_used"][i] + n * s["bw_ask"]
                   <= s["bw_avail"][i])
              and (not s["jd"] or (n <= 1 and s["job_count"][i] == 0))
              and (not s["td"] or (n <= 1 and s["tg_count"][i] == 0)))
        if not ok:
            raise AssertionError(f"node {i} holds {n} tasks it cannot")


def oracle_agrees(s, t) -> bool:
    """solve_rounds_fused against the water-fill on one case: equal, or
    (returns True) a pow-band instance with an equal total and both sound."""
    from nomad_tpu_torch.ops.binpack import solve_rounds_fused

    counts, left = kernel_counts(t, s["count"], s["penalty"], s["jd"],
                                 s["td"])
    oc, oleft = solve_rounds_fused(*t, s["count"], s["penalty"], s["jd"],
                                   s["td"])
    oc = oc.cpu().numpy()
    if np.array_equal(counts, oc) and left == oleft:
        return False
    gap = boundary_gap(s, t)
    if gap is None or gap > ULP_BAND:
        raise AssertionError(f"solve_rounds_fused != the water-fill outside "
                             f"the pow band (boundary gap {gap} ulp)")
    if int(counts.sum()) != int(oc.sum()) or left != oleft:
        raise AssertionError("solve_rounds_fused placed another total in "
                             "the pow band")
    check_sound(s, counts)
    check_sound(s, oc)
    return True


def phase_secure_oracle(dev, seeds: int = ORACLE_SEEDS):
    """(d): solve_rounds_fused (plain torch on ``dev``) against the
    water-fill at the headline shape and at the fuzz seeds. Returns the
    band count."""
    from nomad_tpu_torch.ops.binpack import solve_rounds_fused

    n, _b, jd, td, mode = MAIN_WF_SHAPE
    args = waterfill_case(np.random.default_rng(SEED), n, 1, jd, td, mode,
                          dev)
    t = [x[0] for x in args[:10]]
    count, penalty = int(args[10][0]), float(args[11][0])
    counts, left = kernel_counts(t, count, penalty, jd, td)
    oc, oleft = solve_rounds_fused(*t, count, penalty, jd, td)
    if not (np.array_equal(counts, oc.cpu().numpy()) and left == oleft
            and oleft == 0):
        raise AssertionError("solve_rounds_fused != the water-fill at the "
                             "headline shape")
    if dev.type == "cuda":
        ms = cuda_ms(lambda: solve_rounds_fused(*t, count, penalty, jd, td),
                     5)
        log(f"secure oracle: solve_rounds_fused at the headline shape "
            f"({n} rows, {count} tasks, {int(oc.max())} rounds) "
            f"{ms:.3f} ms, equal to the water-fill kernel")
    band = 0
    for seed in range(seeds):
        s = fuzz_solve_inputs(np.random.default_rng(ORACLE_SEED_BASE + seed))
        band += oracle_agrees(s, fuzz_tensors(s, dev))
    log(f"secure oracle: {seeds} fuzz seeds, {seeds - band} equal, {band} "
        f"in the {ULP_BAND}-ulp pow band (equal totals, sound)")
    return band


def phase_secure(dev, card: str, tmp: str):
    """Phase 16. Returns (water-fill launches, greedy launches) of (a) and
    (b), the main path of the phase; (c) and (d) launch only to compare."""
    from nomad_tpu_torch.ops import greedy, waterfill

    t0 = time.perf_counter()
    certs = make_certs(tmp)
    t1 = time.perf_counter()
    waterfill.LAUNCHES = 0
    greedy.LAUNCHES = 0
    rows = phase_secure_cell(dev, certs, tmp)
    t2 = time.perf_counter()
    phase_secure_uplink(dev, certs, tmp)
    t3 = time.perf_counter()
    wf, gr = waterfill.LAUNCHES, greedy.LAUNCHES
    log(f"secure: waterfill_launches={wf} greedy_launches={gr} ({card})")
    if wf == 0 or gr == 0:
        raise AssertionError("the secure phase did not launch both hand "
                             f"kernels (water-fill {wf}, greedy {gr})")
    phase_secure_native(rows)
    t4 = time.perf_counter()
    phase_secure_oracle(dev)
    log(f"secure: phase {time.perf_counter() - t0:.1f} s (certs "
        f"{t1 - t0:.1f}, cell {t2 - t1:.1f}, uplink {t3 - t2:.1f}, native "
        f"{t4 - t3:.1f}, oracle {time.perf_counter() - t4:.1f})")
    return wf, gr


# -- the job-update path (BASELINE config 5), drain, port asks, 100k nodes ----

# bench.py run_config5: 50,000 dc1 nodes (bench.py _mk_nodes, no network),
# a service job of 10,000 tasks of 100 MHz / 128 MB rolled at max_parallel
# 1,000 with a 10 s stagger. The mirror pads 50,000 rows to 65,536.
CONFIG5_NODES = 50_000
CONFIG5_TASKS = 10_000
CONFIG5_MAX_PARALLEL = 1_000
CONFIG5_STAGGER_S = 10.0
CONFIG5_ROWS = 65_536
# Depth cut of the roll through a Server: each follow-up eval waits this
# long in the broker instead of config 5's 10 s, so the ten rounds fit the
# script's time limit.
CONFIG5_SERVER_STAGGER_S = 1.0
# Nodes drained under the count-100 service job, and the port-ask job.
DRAIN_NODES = 10
PORT_JOB_COUNT = 20
PORT_RESERVED = 8080
NODE_RESERVED_PORT = 22
UPDATE_SCENARIOS = (("steady-100k-nodes", 131_072),)


def config5_nodes(n: int = 0):
    """bench.py's _mk_nodes(n, with_net=False) as port Nodes."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.structs import Node, Resources

    return [Node(
        id=f"bench-{i:06d}", datacenter="dc1", name=f"n{i}",
        attributes={"kernel.name": "linux", "driver.exec": "1"},
        resources=Resources(cpu=4000, memory_mb=8192, disk_mb=100 * 1024,
                            iops=150),
        status=structs.NODE_STATUS_READY,
    ) for i in range(n or CONFIG5_NODES)]


def config5_job(stagger: float):
    """bench.py run_config5's job (its task group and update strategy)."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.structs import (
        Job, Resources, RestartPolicy, Task, TaskGroup, UpdateStrategy,
        generate_uuid,
    )

    return Job(
        region="global", id=generate_uuid(), name="bench-roll",
        type=structs.JOB_TYPE_SERVICE, priority=50, datacenters=["dc1"],
        update=UpdateStrategy(stagger=stagger,
                              max_parallel=CONFIG5_MAX_PARALLEL),
        task_groups=[TaskGroup(
            name="web", count=CONFIG5_TASKS,
            restart_policy=RestartPolicy(attempts=2, interval=600.0,
                                         delay=5.0),
            tasks=[Task(name="t", driver="exec",
                        resources=Resources(cpu=100, memory_mb=128))],
        )],
    )


def bumped(job, cpu: int = 7):
    """A deep copy of ``job`` with its task's cpu raised (an in-place
    update: tasks_updated ignores resources)."""
    import copy

    new = copy.deepcopy(job)
    new.task_groups[0].tasks[0].resources.cpu += cpu
    return new


def env_changed(job):
    """A deep copy of ``job`` with a new env (a destructive update)."""
    import copy

    new = copy.deepcopy(job)
    new.task_groups[0].tasks[0].env = {"V": "2"}
    return new


class WaterfillCalls:
    """While active, records each batched water-fill the coalescer hands
    the wrapper: its rows, width, and (read after the timed section) the
    largest penalty and job count it was given. Launches stay counted by
    the wrapper alone."""

    def __init__(self):
        self._seen = []

    def __enter__(self):
        from nomad_tpu_torch.ops import coalesce

        self._inner = coalesce.solve_waterfill_batched

        def spy(*args, **kw):
            self._seen.append((tuple(args[0].shape[:2]), args[3], args[11]))
            return self._inner(*args, **kw)
        coalesce.solve_waterfill_batched = spy
        return self

    def __exit__(self, *exc):
        from nomad_tpu_torch.ops import coalesce

        coalesce.solve_waterfill_batched = self._inner

    def rows(self):
        return sorted({shape[1] for shape, _jc, _p in self._seen})

    def penalised(self) -> bool:
        """Some solve weighed the job's own allocs with a penalty."""
        return any(float(p.max()) > 0 and int(jc.max()) > 0
                   for _s, jc, p in self._seen)


def live_by_version(snap, job_id: str):
    """Live tasks of a job by job modify index, from the stored blocks'
    runs and the object rows."""
    out = {}
    for blk in snap.job_alloc_blocks(job_id):
        n = sum(int(c) for _nid, c in blk.live_node_counts())
        out[blk.job.modify_index] = out.get(blk.job.modify_index, 0) + n
    for a in snap.allocs_objects():
        if a.job_id == job_id and not a.terminal_status():
            out[a.job.modify_index] = out.get(a.job.modify_index, 0) + 1
    return {k: v for k, v in out.items() if v}


def check_cpu(snap, job_id: str, cpu: int) -> None:
    """Every live task of the job asks ``cpu``."""
    for blk in snap.job_alloc_blocks(job_id):
        if blk.resources.cpu != cpu and any(
                c for _n, c in blk.live_node_counts()):
            raise AssertionError(f"a block of {job_id} asks cpu "
                                 f"{blk.resources.cpu}, want {cpu}")
    for a in snap.allocs_objects():
        if (a.job_id == job_id and not a.terminal_status()
                and a.resources.cpu != cpu):
            raise AssertionError(f"alloc {a.id} asks cpu {a.resources.cpu},"
                                 f" want {cpu}")


def plan_counts(plans):
    """(placed, stopped, updated in place) over ``plans``."""
    placed = stopped = updated = 0
    for plan in plans:
        placed += sum(b.n for b in plan.alloc_batches)
        placed += sum(len(v) for v in plan.node_allocation.values())
        stopped += sum(len(v) for v in plan.node_update.values())
        updated += sum(b.n for b in plan.update_batches)
    return placed, stopped, updated


def phase_update_harness(dev, card: str):
    """Phase 17 (a): config 5 through the harness at full width. Place the
    job (the water-fill on a 65,536-row mirror), bump its cpu (10,000
    in-place updates in one AllocUpdateBatch commit, no solve), change its
    env (the first rolling eval stops and places max_parallel through the
    water-fill, the penalty weighing the survivors, and creates one
    follow-up eval of wait = stagger). Returns the water-fill launches."""
    import torch
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.harness import Harness
    from nomad_tpu_torch.ops import greedy, waterfill

    t0 = time.perf_counter()
    h = Harness()
    h.planner = planner = VerifyingPlanner(h.state, 0)
    for node in config5_nodes():
        h.state.upsert_node(h.next_index(), node)
    log(f"update: {CONFIG5_NODES} nodes in the harness in "
        f"{time.perf_counter() - t0:.1f} s")

    def run(job, what):
        ev = register_eval(h, job)
        planner.index = h.next_index()
        n_plans, n_created = len(h.plans), len(h.create_evals)
        wf0, gr0 = waterfill.LAUNCHES, greedy.LAUNCHES
        with WaterfillCalls() as calls:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            h.process("tpu-service", ev, device=dev)
            ms = (time.perf_counter() - t) * 1000.0
        if h.evals[-1].status != structs.EVAL_STATUS_COMPLETE:
            raise AssertionError(f"config 5 {what}: eval ended "
                                 f"{h.evals[-1].status}")
        return (ms, plan_counts(h.plans[n_plans:]),
                h.create_evals[n_created:], waterfill.LAUNCHES - wf0,
                greedy.LAUNCHES - gr0, calls)

    count, mp = CONFIG5_TASKS, CONFIG5_MAX_PARALLEL
    job = config5_job(CONFIG5_STAGGER_S)
    ms, (placed, stopped, updated), created, wf, gr, calls = run(job, "place")
    if (placed, stopped, updated) != (count, 0, 0) or wf == 0:
        raise AssertionError(f"config 5 place: placed {placed} stopped "
                             f"{stopped} updated {updated}, {wf} water-fill "
                             "launches")
    if calls.rows() != [CONFIG5_ROWS]:
        raise AssertionError(f"config 5 place: water-fill rows "
                             f"{calls.rows()}, want [{CONFIG5_ROWS}]")
    check_committed(h.state.snapshot(), job, count)
    total_wf = wf
    log(f"update config5 place: placed={placed} e2e_ms={ms:.2f} "
        f"waterfill_launches={wf} rows={calls.rows()} [{card}]")

    job2 = bumped(job)
    ms, (placed, stopped, updated), created, wf, gr, calls = run(
        job2, "in place")
    plan = h.plans[-1]
    if ((placed, stopped, updated) != (0, 0, count) or wf or gr
            or not plan.update_batches or created):
        raise AssertionError(f"config 5 in place: placed {placed} stopped "
                             f"{stopped} updated {updated}, launches "
                             f"{wf}/{gr}, {len(created)} follow-up evals")
    snap = h.state.snapshot()
    check_committed(snap, job2, count)
    check_cpu(snap, job.id, 107)
    if live_by_version(snap, job.id) != {job2.modify_index: count}:
        raise AssertionError("config 5 in place: live tasks by version "
                             f"{live_by_version(snap, job.id)}")
    inplace_ms = ms
    log(f"update config5 in place: inplace_updated={updated} "
        f"inplace_e2e_ms={ms:.2f} inplace_updates_per_sec="
        f"{count / (ms / 1000.0):.1f} batches={len(plan.update_batches)} "
        f"launches 0 [{card}]")

    job3 = env_changed(job2)
    ms, (placed, stopped, updated), created, wf, gr, calls = run(
        job3, "roll")
    if (placed, stopped, updated) != (mp, mp, 0) or wf == 0:
        raise AssertionError(f"config 5 roll: placed {placed} stopped "
                             f"{stopped} updated {updated}, {wf} water-fill "
                             "launches")
    if (len(created) != 1 or created[0].wait != CONFIG5_STAGGER_S
            or created[0].triggered_by
            != structs.EVAL_TRIGGER_ROLLING_UPDATE):
        raise AssertionError(f"config 5 roll: follow-up evals "
                             f"{[(e.triggered_by, e.wait) for e in created]}")
    if calls.rows() != [CONFIG5_ROWS] or not calls.penalised():
        raise AssertionError(f"config 5 roll: water-fill rows "
                             f"{calls.rows()}, penalty against the "
                             f"survivors {calls.penalised()}")
    snap = h.state.snapshot()
    check_committed(snap, job3, count)
    if live_by_version(snap, job.id) != {job2.modify_index: count - mp,
                                         job3.modify_index: mp}:
        raise AssertionError("config 5 roll: live tasks by version "
                             f"{live_by_version(snap, job.id)}")
    total_wf += wf
    log(f"update config5 roll: rolled={placed} stopped={stopped} "
        f"max_parallel={mp} e2e_ms={ms:.2f} rolled_updates_per_sec="
        f"{placed / (ms / 1000.0):.1f} follow_up_wait_s={created[0].wait} "
        f"waterfill_launches={wf} rows={calls.rows()} penalised=True "
        f"[{card}]")
    log(f"update config5: inplace_e2e_ms={inplace_ms:.2f} "
        f"inplace_updates_per_sec={count / (inplace_ms / 1000.0):.1f} "
        f"rolled={placed} e2e_ms={ms:.2f} rolled_updates_per_sec="
        f"{placed / (ms / 1000.0):.1f} [{card}]")
    return total_wf


def phase_update_server(dev, card: str):
    """Phase 17 (b): config 5's place, in-place bump and whole roll through
    one Server, the roll's follow-up evals waiting
    CONFIG5_SERVER_STAGGER_S in the broker (a depth cut of the 10 s
    stagger). Every eval of the chain completes once; the store ends with
    CONFIG5_TASKS live tasks of the new version, none of the old, within
    every node's capacity. Returns the water-fill launches."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import waterfill

    count, mp = CONFIG5_TASKS, CONFIG5_MAX_PARALLEL
    srv = new_server(dev, config5_nodes())
    try:
        waterfill.LAUNCHES = 0
        job = config5_job(CONFIG5_SERVER_STAGGER_S)
        t0 = time.perf_counter()
        eid, _ = srv.job_register(job)
        place_ms = (wait_complete(srv, eid) - t0) * 1000.0
        check_committed(srv.state_store.snapshot(), job, count)

        job2 = bumped(job)
        t0 = time.perf_counter()
        eid2, _ = srv.job_register(job2)
        inplace_ms = (wait_complete(srv, eid2) - t0) * 1000.0
        snap = srv.state_store.snapshot()
        check_committed(snap, job2, count)
        check_cpu(snap, job.id, 107)

        job3 = env_changed(job2)
        t0 = time.perf_counter()
        eid3, _ = srv.job_register(job3)
        chain, round_ms = [eid3], []
        while True:
            t = wait_complete(srv, chain[-1])
            round_ms.append((t - t0) * 1000.0)
            t0 = t
            nxt = srv.state_store.eval_by_id(chain[-1]).next_eval
            if not nxt:
                break
            chain.append(nxt)
            if len(chain) > count // mp + 1:
                raise AssertionError(f"the roll ran past {len(chain) - 1} "
                                     "rounds")
        roll_s = sum(round_ms) / 1000.0
        snap = srv.state_store.snapshot()
        want_rounds = -(-count // mp)
        if len(chain) != want_rounds:
            raise AssertionError(f"the roll took {len(chain)} evals, want "
                                 f"{want_rounds}")
        stored = srv.state_store.job_by_id(job.id)
        if live_by_version(snap, job.id) != {stored.modify_index: count}:
            raise AssertionError("after the roll, live tasks by version "
                                 f"{live_by_version(snap, job.id)}, want "
                                 f"{count} of {stored.modify_index}")
        check_committed(snap, job3, count)
        evals = snap.evals_by_job(job.id)
        ids = [e.id for e in evals]
        if (len(ids) != len(set(ids)) or len(ids) != 2 + want_rounds
                or any(e.status != structs.EVAL_STATUS_COMPLETE
                       for e in evals)
                or not {eid, eid2, *chain} == set(ids)):
            raise AssertionError("the job's evals: " + json.dumps(
                [(e.id, e.status, e.triggered_by) for e in evals]))
        wf = waterfill.LAUNCHES
        if wf == 0:
            raise AssertionError("the server roll never launched the "
                                 "water-fill kernel")
        log(f"update server config5: place_ms={place_ms:.2f} "
            f"inplace_ms={inplace_ms:.2f} inplace_updates_per_sec="
            f"{count / (inplace_ms / 1000.0):.1f} [{card}]")
        log(f"update server roll (stagger {CONFIG5_SERVER_STAGGER_S} s, a "
            f"depth cut of config 5's {CONFIG5_STAGGER_S} s): "
            f"rounds={len(chain)} roll_s={roll_s:.3f} "
            f"rolled_updates_per_sec={count / roll_s:.1f} round_ms="
            + json.dumps([round(x, 2) for x in round_ms])
            + f" evals complete once={len(ids)} waterfill_launches={wf} "
            f"[{card}]")
        for i, e in enumerate(chain):
            st = eval_stages(e)
            log(f"update server roll round {i + 1} stages_ms=" + json.dumps(
                {k: round(st.get(k, 0.0), 3) for k in SERVER_STAGES}))
    finally:
        srv.shutdown()
    return wf


def net_nodes():
    """cluster_nodes() with a network each: one IP (eth0, 1,000 Mbit) and
    port 22 reserved, as mock.node() has."""
    from nomad_tpu_torch.structs import NetworkResource, Resources

    nodes = cluster_nodes()
    for i, node in enumerate(nodes):
        ip = f"10.{i >> 16 & 255}.{i >> 8 & 255}.{i & 255}"
        node.resources.networks = [NetworkResource(
            device="eth0", cidr=f"{ip}/32", mbits=1000)]
        node.reserved = Resources(networks=[NetworkResource(
            device="eth0", ip=ip, reserved_ports=[NODE_RESERVED_PORT],
            mbits=1)])
    return nodes


def check_ports(snap, job, node_ids) -> None:
    """Every live alloc of ``job`` holds the reserved port and two dynamic
    ones outside the reserved set, and no (ip, port) is taken twice on a
    node (node reservations included)."""
    for nid in node_ids:
        node = snap.node_by_id(nid)
        seen = {(n.ip, p) for n in node.reserved.networks
                for p in n.reserved_ports}
        for a in snap.allocs_by_node(nid):
            if a.terminal_status():
                continue
            for r in a.task_resources.values():
                for net in r.networks:
                    ports = list(net.reserved_ports)
                    if a.job_id == job.id:
                        dyn = ports[len(ports) - len(net.dynamic_ports):]
                        if (PORT_RESERVED not in ports or len(dyn) != 2
                                or set(dyn) & {PORT_RESERVED,
                                               NODE_RESERVED_PORT}):
                            raise AssertionError(f"alloc {a.id} ports "
                                                 f"{ports}")
                    for p in ports:
                        if (net.ip, p) in seen:
                            raise AssertionError(f"port {net.ip}:{p} taken "
                                                 f"twice on {nid}")
                        seen.add((net.ip, p))


def phase_update_drain_ports(dev, card: str):
    """Phase 17 (c): on phase 6's 10,000 nodes (each given a network),
    the count-100 service job placed, DRAIN_NODES of its nodes drained
    (their replacements through the greedy scan, none left on a drained
    node), then a count-20 service job asking two dynamic ports and one
    reserved port. Returns (water-fill launches, greedy launches)."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import greedy, waterfill

    srv = new_server(dev, net_nodes())
    try:
        waterfill.LAUNCHES = greedy.LAUNCHES = 0
        job = make_job("drain-svc", structs.JOB_TYPE_SERVICE, SERVICE_COUNT,
                       ["dc1", "dc2"])
        eid, _ = srv.job_register(job)
        wait_complete(srv, eid)
        snap = srv.state_store.snapshot()
        check_committed(snap, job, SERVICE_COUNT)
        held = sorted({a.node_id for a in snap.allocs_by_job(job.id)
                       if not a.terminal_status()})[:DRAIN_NODES]
        moved = sum(1 for a in snap.allocs_by_job(job.id)
                    if not a.terminal_status() and a.node_id in held)
        gr0 = greedy.LAUNCHES
        t0 = time.perf_counter()
        eids = []
        for nid in held:
            eids += srv.node_update_drain(nid, True)["eval_ids"]
        for e in eids:
            wait_complete(srv, e)
        drain_ms = (time.perf_counter() - t0) * 1000.0
        gr_drain = greedy.LAUNCHES - gr0
        snap = srv.state_store.snapshot()
        check_committed(snap, job, SERVICE_COUNT)
        left = [a.id for a in snap.allocs_by_job(job.id)
                if not a.terminal_status() and a.node_id in held]
        if left or gr_drain == 0 or len(held) != DRAIN_NODES:
            raise AssertionError(f"drain: {len(left)} allocs left on "
                                 f"drained nodes, {gr_drain} greedy "
                                 f"launches, {len(held)} nodes drained")
        log(f"update drain: {len(held)} nodes drained, {moved} allocs "
            f"moved by {len(eids)} node-update evals in {drain_ms:.2f} ms, "
            f"greedy_launches={gr_drain} [{card}]")

        pjob = make_job("ports-svc", structs.JOB_TYPE_SERVICE,
                        PORT_JOB_COUNT, ["dc1", "dc2"])
        pjob.task_groups[0].tasks[0].resources.networks = [
            structs.NetworkResource(mbits=10, dynamic_ports=["http", "https"],
                                    reserved_ports=[PORT_RESERVED])]
        gr0 = greedy.LAUNCHES
        t0 = time.perf_counter()
        eid, _ = srv.job_register(pjob)
        ports_ms = (wait_complete(srv, eid) - t0) * 1000.0
        snap = srv.state_store.snapshot()
        check_committed(snap, pjob, PORT_JOB_COUNT)
        nodes = sorted({a.node_id for a in snap.allocs_by_job(pjob.id)
                        if not a.terminal_status()})
        if set(nodes) & set(held):
            raise AssertionError("the port job landed on a drained node")
        check_ports(snap, pjob, nodes)
        if greedy.LAUNCHES == gr0:
            raise AssertionError("the port job never launched the greedy "
                                 "kernel")
        log(f"update ports: {PORT_JOB_COUNT} allocs on {len(nodes)} nodes, "
            f"ports distinct and outside the reserved set, "
            f"register_complete_ms={ports_ms:.2f} [{card}]")
        wf, gr = waterfill.LAUNCHES, greedy.LAUNCHES
    finally:
        srv.shutdown()
    return wf, gr


# Phase 8's steady-10k numbers, for the 100k-node scenario's log line.
SIM_NUMBERS = {}


def sim_numbers(art) -> dict:
    return {"nodes_per_s": art["registration"]["nodes_per_sec"],
            "plan_p50_ms": art["plan_latency_ms"]["p50_ms"],
            "plan_p95_ms": art["plan_latency_ms"]["p95_ms"]}


def phase_update_sim(dev, card: str, names=UPDATE_SCENARIOS):
    """Phase 17 (d): each (scenario, rows) of ``names`` through
    run_checked, held to nomad_tpu's digest; its water-fill solves must
    have reached ``rows``. Returns the water-fill launches."""
    from nomad_tpu_torch.simcluster.scenario import SCENARIOS

    refs = load_reference_digests()
    total = 0
    for name, rows in names:
        with WaterfillCalls() as calls:
            art, launches, _stages, compared = run_checked(
                name, SCENARIOS[name], dev, refs)
        total += launches
        if not compared or max(calls.rows(), default=0) != rows:
            raise AssertionError(f"{name}: digest compared {compared}, "
                                 f"water-fill rows {calls.rows()}, want "
                                 f"{rows}")
        got = sim_numbers(art)
        base = SIM_NUMBERS.get("steady-10k")
        log(f"update {name}: digest equals nomad_tpu's, rows={calls.rows()} "
            f"placed={art['placements']['placed']} "
            f"registration nodes_per_s={got['nodes_per_s']} "
            f"plan_latency_ms p50={got['plan_p50_ms']} "
            f"p95={got['plan_p95_ms']} waterfill_launches={launches} "
            f"wall_seconds={art['wall_seconds']}; steady-10k "
            + (json.dumps(base) if base else "not run") + f" [{card}]")
    return total


def phase_update(dev, card: str):
    """Phase 17. Returns (water-fill launches, greedy launches)."""
    t0 = time.perf_counter()
    wf = phase_update_harness(dev, card)
    t1 = time.perf_counter()
    wf += phase_update_server(dev, card)
    t2 = time.perf_counter()
    w, gr = phase_update_drain_ports(dev, card)
    wf += w
    t3 = time.perf_counter()
    wf += phase_update_sim(dev, card, UPDATE_SCENARIOS)
    log(f"update: phase {time.perf_counter() - t0:.1f} s (harness "
        f"{t1 - t0:.1f}, server roll {t2 - t1:.1f}, drain and ports "
        f"{t3 - t2:.1f}, steady-100k-nodes {time.perf_counter() - t3:.1f}); "
        f"waterfill_launches={wf} greedy_launches={gr}")
    return wf, gr


def timed(n: int, fn, *args):
    """Run phase ``n`` and log its seconds as ``phase n: <s> s``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        log(f"phase {n}: {time.perf_counter() - t0:.1f} s")


def in_tmp(fn, *args):
    """fn(*args, tmp) with a fresh temporary directory, removed after."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        return fn(*args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_kernels():
    """Phase 1: build every kernel; print ptxas' report, fail on a spill."""
    from nomad_tpu_torch.ops import kernels

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


def harness_phases(dev):
    """Phases 3-5 through the harness; returns (water-fill launches,
    greedy launches)."""
    t0 = time.perf_counter()
    h = build_cluster()
    log(f"cluster: {N_NODES} nodes in {time.perf_counter() - t0:.1f}s")
    wf = timed(3, phase_headline, h, dev)
    gr = timed(4, phase_service, h, dev)
    wf += timed(5, phase_burst, h, dev)
    return wf, gr


def server_phases(dev):
    wf, gr = phase_server(dev)
    return wf + phase_server_burst(dev), gr


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

    t_main = time.perf_counter()
    no_outside_network()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    torch.manual_seed(SEED)

    # 1. build
    timed(1, build_kernels)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. kernels vs plain
    kres = timed(2, phase_kernels, dev, rng)

    # 3-5. the main path through the harness
    wf_launches, gr_launches = harness_phases(dev)

    # 6. the server loop
    wf, gr = timed(6, server_phases, dev)
    wf_launches += wf
    gr_launches += gr

    # 7. the cluster tier
    wf, gr = timed(7, phase_cluster, dev, rng)
    wf_launches += wf
    gr_launches += gr

    # 8. simcluster
    wf_launches += timed(8, phase_simcluster, dev, card)

    # 9. the system scheduler (BASELINE config 4)
    timed(9, phase_system, dev)

    # 10-14. the agent, HTTP and the CLI; the client; the front door and
    # the fast lanes; recovery and chaos; the agent's operator surface
    for n, fn, args in ((10, in_tmp, (phase_agent, dev, card)),
                        (11, in_tmp, (phase_client, dev, card)),
                        (12, phase_planes, (dev, card)),
                        (13, phase_recovery, (dev, card)),
                        (14, in_tmp, (phase_operator, dev, card))):
        wf, gr = timed(n, fn, *args)
        wf_launches += wf
        gr_launches += gr

    # 15. the solver mesh: node shards on the one card, and DCN
    mres, mnum, mlaunch = timed(15, phase_mesh, dev, rng)
    wf_launches += mlaunch["waterfill"]
    gr_launches += mlaunch["greedy"]

    # 16. the secure cell, the uplink, the native verifier, the oracle
    wf, gr = timed(16, in_tmp, phase_secure, dev, card)
    wf_launches += wf
    gr_launches += gr

    # 17. the job-update path: config 5, a roll through a server, a drain,
    # port asks, and steady-100k-nodes
    wf, gr = timed(17, phase_update, dev, card)
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
    ] + [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": mlaunch[count],
         "max_abs_err": mres[err], **mnum[name], "library_ms": None}
        for name, source, replaces, count, err in (
            ("waterfill_shard", "nomad_tpu_torch/csrc/waterfill_shard.cu",
             "nomad_tpu/ops/binpack.py:269", "waterfill_shard_pass",
             "pass_err"),
            ("waterfill_shard_solve",
             "nomad_tpu_torch/csrc/waterfill_shard.cu",
             "nomad_tpu/ops/binpack.py:269", "waterfill_shard_solve",
             "wf_err"),
            ("greedy_merge", "nomad_tpu_torch/csrc/greedy.cu",
             "nomad_tpu/ops/binpack.py:115", "greedy_merge", "merge_err"))
    ]}
    log(f"card: {card}")
    log(f"chip_smoke: phases 1-17 in {time.perf_counter() - t_main:.1f} s")
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
