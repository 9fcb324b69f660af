#!/usr/bin/env python3
"""Times kernels of two checkouts of the port on one card, on the same
draws, in the order A, B, B, A.

    python3 chip_ab.py DIR_A DIR_B          # the water-fill kernel alone
    python3 chip_ab.py --mesh DIR_A DIR_B   # the solver mesh's kernels

Each run is a process of its own that imports DIR's nomad_tpu_torch (its
kernels build into DIR's _build) and makes its instances from this
checkout's chip_smoke and seed. The default times each tree's
``waterfill.kernel_only`` at chip_smoke.WF_SHAPES with chip_smoke's timer
(CUDA events around one replay of a CUDA graph of 20 launches). ``--mesh``
times, at phase 15's shapes, the node-shard water-fill's passes over one
2,048-row shard of the headline (``shard_kernel_only``, graph), the
merge of the service eval's scans at S = 1, 2, 4, 8, 16
(``merge_kernel_only``, graph), and the headline eval's
unsharded and sharded solves at S = 1, 2, 4, 8 through their wrappers
(CUDA events around 20 host-paced solves). The two trees' outputs must be
equal at every row. Prints the card, one line a run and row, and last one
JSON object: each row's ms in the four runs.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
MERGE_SHARDS = (1, 2, 4, 8, 16)  # --mesh: the merge's widths


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(tree: str) -> None:
    """One run: a JSON line per WF_SHAPES row (ms and output digest)."""
    import numpy as np
    import torch

    cs = load_smoke()
    sys.path.insert(0, os.path.abspath(tree))
    from nomad_tpu_torch.ops import waterfill

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    for row in cs.WF_SHAPES:
        n, b, jd, td, mode = row
        args = cs.waterfill_case(rng, n, b, jd, td, mode, dev)
        counts, rem = waterfill.solve_waterfill_batched(*args)
        digest = hashlib.sha1(counts.cpu().numpy().tobytes()
                              + rem.cpu().numpy().tobytes()).hexdigest()
        ms = cs.graph_ms(lambda: waterfill.kernel_only(*args), 20)
        print(json.dumps({"row": list(row), "ms": ms, "digest": digest}),
              flush=True)


def digest_of(*tensors) -> str:
    return hashlib.sha1(b"".join(t.cpu().numpy().tobytes()
                                 for t in tensors)).hexdigest()


def run_one_mesh(tree: str) -> None:
    """One run of --mesh: a JSON line per row (ms and output digest)."""
    import numpy as np
    import torch

    cs = load_smoke()
    sys.path.insert(0, os.path.abspath(tree))
    from nomad_tpu_torch.ops import greedy, waterfill
    from nomad_tpu_torch.parallel.mesh import MeshReduce

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    emit = lambda row, ms, digest: print(json.dumps(
        {"row": row, "ms": ms, "digest": digest}), flush=True)

    n_s = cs.MESH_MAIN_WF_ROWS // cs.MESH_NODE_SHARDS
    args = cs.waterfill_case(rng, cs.MESH_MAIN_WF_ROWS, 1, False, False,
                             "headline", dev)
    shards, small = cs.shard_wf_args(args, cs.MESH_NODE_SHARDS)
    emit(["waterfill_shard", n_s], cs.graph_ms(
        lambda: waterfill.shard_kernel_only(shards[0], small[0], cs.N_TASKS,
                                            False, False), 20), "")

    n, b, k, mode = cs.MESH_MAIN_GREEDY_SHAPE
    gargs = cs.greedy_case(rng, n, b, k, dev, mode=mode)
    for s in MERGE_SHARDS:
        seq = cs.gathered_sequences(cs.shard_greedy_args(gargs, s),
                                    gargs[10], k)
        emit(["greedy_merge", s], cs.graph_ms(
            lambda: greedy.merge_kernel_only(*seq, gargs[10], n // s), 20),
            digest_of(*greedy.merge_greedy(*seq, gargs[10], n // s)))

    args = cs.waterfill_case(rng, 16384, 1, False, False, "headline", dev)
    maxc = int(args[10].max())
    emit(["unsharded", 16384], cs.cuda_ms(
        lambda: waterfill.solve_waterfill_batched(*args), 20),
        digest_of(*waterfill.solve_waterfill_batched(*args)))
    for s in cs.MESH_SHARDS:
        shards, small = cs.shard_wf_args(args, s)
        solve = lambda: waterfill.solve_waterfill_sharded(
            shards, small, maxc, False, False, MeshReduce())
        parts, rem = solve()
        emit(["sharded", 16384, s], cs.cuda_ms(solve, 20),
             digest_of(torch.cat(parts, 1), rem))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] in ("--one", "--one-mesh"):
        (run_one if sys.argv[1] == "--one" else run_one_mesh)(sys.argv[2])
        return 0
    mesh = len(sys.argv) == 4 and sys.argv[1] == "--mesh"
    if len(sys.argv) != 3 and not mesh:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 2
    cs = load_smoke()
    print(f"card: {cs.card_line()}", flush=True)
    a, b = sys.argv[-2], sys.argv[-1]
    runs = []
    for tree in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one-mesh" if mesh else "--one", tree],
                             capture_output=True, text=True, timeout=600,
                             check=True)
        rows = [json.loads(line) for line in out.stdout.splitlines()
                if line.startswith("{")]
        for r in rows:
            print(f"{tree} {tuple(r['row'])} ms={r['ms']:.5f}", flush=True)
        runs.append(rows)
    table = {}
    for i, row in enumerate(runs[0]):
        digests = {run[i]["digest"] for run in runs}
        if len(digests) != 1:
            raise AssertionError(f"the trees disagree at {row['row']}")
        table[str(tuple(row["row"]))] = [run[i]["ms"] for run in runs]
    print(json.dumps({"order": [a, b, b, a],
                      "ms" if mesh else "graph_ms": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
