#!/usr/bin/env python3
"""Times the water-fill kernel alone of two checkouts of the port on one
card, on the same draws, in the order A, B, B, A.

    python3 chip_ab.py DIR_A DIR_B

Each run is a process of its own that imports DIR's nomad_tpu_torch (its
kernels build into DIR's _build), makes the instances of this checkout's
chip_smoke.WF_SHAPES from chip_smoke's seed, and times each tree's
``waterfill.kernel_only`` with chip_smoke's timer (CUDA events around one
replay of a CUDA graph of 20 launches). The two trees' outputs must be
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


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 2
    cs = load_smoke()
    print(f"card: {cs.card_line()}", flush=True)
    a, b = sys.argv[1], sys.argv[2]
    runs = []
    for tree in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], capture_output=True, text=True,
                             timeout=600, check=True)
        rows = [json.loads(line) for line in out.stdout.splitlines()
                if line.startswith("{")]
        for r in rows:
            print(f"{tree} {tuple(r['row'])} graph_ms={r['ms']:.4f}",
                  flush=True)
        runs.append(rows)
    table = {}
    for i, row in enumerate(runs[0]):
        digests = {run[i]["digest"] for run in runs}
        if len(digests) != 1:
            raise AssertionError(f"the trees disagree at {row['row']}")
        table[str(tuple(row["row"]))] = [run[i]["ms"] for run in runs]
    print(json.dumps({"order": [a, b, b, a], "graph_ms": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
