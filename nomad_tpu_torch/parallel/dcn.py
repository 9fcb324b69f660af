"""Multi-process (DCN) scale-out of the node-axis solve (port of
nomad_tpu/parallel/dcn.py).

The cluster-state node axis spans processes: each rank holds its shard of
the node tensors on its device, and ONE water-fill solves globally. The
code path is the mesh's (ops/waterfill.py solve_waterfill_sharded): each
rank runs its shard's passes, and between passes ``DistReduce`` combines
the ranks' small partials with ``torch.distributed.all_reduce`` (SUM or
MAX; an all-gather is the all_reduce of a zeroed buffer in which each rank
writes its own row). nomad_tpu lets XLA insert the same collectives over
a (dcn, node) mesh.

The host-side analog in the reference is multi-region federation; this
module scales a SINGLE region's device solve beyond one process.

``initialize`` joins a ``torch.distributed`` group through a TCP store at
the coordinator's address: ``nccl`` where each rank has a card of its
own, ``gloo`` otherwise (on the CPU, or with several ranks on one card,
which NCCL refuses; gloo carries the CUDA partials itself). The dry run
(``spawn_dcn_workers``, tests/test_torch_dcn.py) runs the same code across
OS processes.
"""

from __future__ import annotations

import hashlib
from datetime import timedelta
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nomad_tpu_torch.parallel.mesh import NODE_AXIS

DCN_AXIS = "dcn"


class DCNUnsupported(RuntimeError):
    """torch.distributed cannot initialize in this environment."""


def spawn_dcn_workers(
    n_processes: int = 2, n_nodes: int = 256, count: int = 180,
    timeout: float = 240.0, device: str = "cuda",
) -> Tuple[List[Dict], List[str]]:
    """Launch the multi-process dry run (dcn_worker.py) and collect each
    worker's DCN_RESULT. ``device`` is each rank's device: "cpu", "cuda"
    (rank r on card r where there are enough cards, else every rank on
    card 0), or one card for every rank ("cuda:0").

    Worker stdout goes to temp files, not pipes -- a worker blocking on a
    full pipe mid-collective would stall the others. Raises DCNUnsupported
    when torch.distributed can't initialize here (exit code 3),
    TimeoutError with the collected output on a hang."""
    import json
    import os
    import socket
    import subprocess
    import sys
    import tempfile
    import time

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    procs = []
    files = []
    try:
        for i in range(n_processes):
            f = tempfile.TemporaryFile(mode="w+")
            files.append(f)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "nomad_tpu_torch.parallel.dcn_worker",
                 str(i), str(n_processes), str(port),
                 str(n_nodes), str(count), device],
                stdout=f, stderr=subprocess.STDOUT, text=True, env=env,
            ))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except BaseException as e:
        # ANY launch/wait failure must reap the already-spawned workers --
        # an orphan blocks in init_process_group waiting for its peers.
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        if isinstance(e, subprocess.TimeoutExpired):
            outs = [_read(f) for f in files]
            raise TimeoutError(
                "DCN dry run timed out:\n" + "\n".join(outs)
            ) from None
        raise
    finally:
        outs = [_read(f) for f in files]
        for f in files:
            f.close()

    for p, out in zip(procs, outs):
        if p.returncode == 3 or "DCN_UNSUPPORTED" in out:
            raise DCNUnsupported(out)
        if p.returncode != 0:
            raise AssertionError(
                f"dcn worker failed (rc={p.returncode}):\n{out}")
    results = [
        json.loads(line[len("DCN_RESULT "):])
        for out in outs
        for line in out.splitlines()
        if line.startswith("DCN_RESULT ")
    ]
    if len(results) != n_processes:
        raise AssertionError("missing DCN_RESULT lines:\n" + "\n".join(outs))
    return results, outs


def _read(f) -> str:
    try:
        f.seek(0)
        return f.read()
    except (OSError, ValueError):
        return ""


class DCNMesh:
    """This process's place in the (dcn, node) grid: its rank, the number
    of ranks, the device holding its node shard and the collective
    backend."""

    __slots__ = ("rank", "world", "device", "backend")

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str):
        self.rank = rank
        self.world = world
        self.device = device
        self.backend = backend

    @property
    def shape(self) -> Dict[str, int]:
        return {DCN_AXIS: self.world, NODE_AXIS: 1}


def rank_device(device: str, process_id: int,
                num_processes: int) -> Tuple[torch.device, str]:
    """(the device rank ``process_id`` holds its shard on, the backend):
    "cuda" gives rank r card r and nccl where every rank has a card of its
    own, else card 0 for every rank and gloo; "cuda:i" puts every rank on
    card i (gloo); "cpu" is gloo."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the DCN solve on the CPU")
        if dev.index is None and torch.cuda.device_count() >= num_processes:
            return torch.device("cuda", process_id), "nccl"
        return torch.device("cuda", dev.index or 0), "gloo"
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev, "gloo"


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device: str = "cuda") -> DCNMesh:
    """Join the multi-process group at ``coordinator_address``
    (host:port of the TCP store rank 0 serves). Returns this rank's
    DCNMesh."""
    dev, backend = rank_device(device, process_id, num_processes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=120),
    )
    return DCNMesh(process_id, num_processes, dev, backend)


def dcn_mesh() -> DCNMesh:
    """The DCNMesh of an initialized process (initialize's return)."""
    if not dist.is_initialized():
        raise RuntimeError("dcn.initialize has not run in this process")
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    return DCNMesh(dist.get_rank(), dist.get_world_size(), dev,
                   dist.get_backend())


class DistReduce:
    """The reduction seam across processes: this rank's one partial,
    all-reduced (SUM or MAX) with every other rank's. The partial is
    reduced in a copy: the shard's own partial stays for its next pass."""

    _OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

    def __call__(self, parts: List[torch.Tensor],
                 op: str) -> List[torch.Tensor]:
        (part,) = parts
        out = part.clone()
        dist.all_reduce(out, op=self._OPS[op])
        return [out]


def dcn_case(n_nodes: int, count: int):
    """The dry run's solve, whole: ``n_nodes`` identical empty nodes (4000
    MHz, 8192 MB, 100 GiB, 150 iops, 1000 Mbit/s) and ``count`` copies of a
    500 MHz / 256 MB ask, as the 12 numpy inputs of one eval (total,
    sched_cap, used0, job_count0, tg_count0, bw_avail, bw_used0, eligible,
    ask, bw_ask, count, penalty), each node tensor ``[1, N, ...]``."""
    total = np.zeros((1, n_nodes, 4), dtype=np.int32)
    total[..., 0] = 4000
    total[..., 1] = 8192
    total[..., 2] = 100 * 1024
    total[..., 3] = 150
    zeros = np.zeros((1, n_nodes), dtype=np.int32)
    return (total, total[..., :2].astype(np.float32),
            np.zeros((1, n_nodes, 4), dtype=np.int32), zeros, zeros,
            np.full((1, n_nodes), 1000, dtype=np.int32), zeros,
            np.ones((1, n_nodes), dtype=bool),
            np.array([[500, 256, 0, 0]], dtype=np.int32),
            np.zeros(1, dtype=np.int32), np.array([count], dtype=np.int32),
            np.array([10.0], dtype=np.float32))


def counts_digest(counts) -> str:
    """sha256 of a counts vector as little-endian int32 bytes: what the
    dry run reports in place of the counts themselves."""
    return hashlib.sha256(
        np.ascontiguousarray(counts, dtype="<i4").tobytes()).hexdigest()


def run_dcn_solve(mesh: DCNMesh, n_nodes: int = 1024,
                  count: int = 900) -> Dict[str, object]:
    """The production water-fill over node tensors sharded across every
    rank: rank r holds the rows [r N/P, (r+1) N/P) on its device and runs
    its shard's passes through DistReduce, then the same passes in plain
    PyTorch (solve_waterfill_sharded_plain) on the same shard through the
    same seam. Returns summary values that read identically on every rank,
    the digest of the whole counts vector (all-gathered), this rank's
    launches of the shard kernel (``shard_launches``), and whether its
    counts and remaining equal the plain passes' (``plain_equal``, with
    ``plain_max_abs_err``)."""
    from nomad_tpu_torch.ops import waterfill

    if n_nodes % mesh.world:
        raise ValueError(f"{n_nodes} nodes do not divide over "
                         f"{mesh.world} ranks")
    n_s = n_nodes // mesh.world
    lo = mesh.rank * n_s
    case = dcn_case(n_nodes, count)
    dev = mesh.device
    shard = tuple(torch.tensor(np.ascontiguousarray(a[:, lo:lo + n_s]),
                               device=dev) for a in case[:8])
    small = tuple(torch.tensor(a, device=dev) for a in case[8:])
    reduce = DistReduce()
    launches = waterfill.SHARD_LAUNCHES
    parts, remaining = waterfill.solve_waterfill_sharded(
        [shard], [small], count, False, False, reduce,
        first_index=mesh.rank, n_shards=mesh.world)
    launches = waterfill.SHARD_LAUNCHES - launches
    p_parts, p_remaining = waterfill.solve_waterfill_sharded_plain(
        [shard], [small], count, False, False, reduce,
        first_index=mesh.rank, n_shards=mesh.world)
    counts = parts[0][0]
    plain_err = max(int((counts - p_parts[0][0]).abs().max()),
                    int((remaining - p_remaining).abs().max()))
    whole = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    whole[lo:lo + n_s] = counts.to(torch.int64)
    (whole,) = reduce([whole], "sum")
    whole = whole.cpu().numpy()
    return {
        "n_nodes": n_nodes,
        "count": count,
        "placed": int(whole.sum()),
        "unplaced": int(remaining[0]),
        "nodes_used": int((whole > 0).sum()),
        "n_processes": mesh.world,
        "n_devices": mesh.world,
        "device": str(dev),
        "backend": mesh.backend,
        "counts_sha256": counts_digest(whole),
        "counts_sharded_over": [DCN_AXIS],
        "shard_launches": launches,
        "plain_equal": plain_err == 0,
        "plain_max_abs_err": plain_err,
    }
