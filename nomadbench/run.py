"""Run one cell of BENCHMARK.json once on one card and print its result.

    python3 -m nomadbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (CUDA start-up, the kernels' build on a first run, the nodes, what
the traffic needs and one warm-up round) is timed from the start of the
process; then the window runs for ``--seconds`` (to the end of the step
in flight, for a closed loop), the plain reference judges what it
committed, and the last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``) and, last, ``checks``: every number
compared with its limit, which also end standard error.

Exits non-zero with no result where no card is visible, where the cell
asks for more cards than there are, where the port is missing, or where
``jax``, ``jaxlib``, ``flax`` or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Set-up runs from the first start of this process, across the re-exec
# below (the monotonic clock is the system's, so it spans exec).
T_START = float(os.environ.get("NOMADBENCH_T0", time.monotonic()))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every build and kernel cache sits at a fixed path in the checkout, so
# only the first run of a checkout builds (the port's own nvcc cache is
# nomad_tpu_torch/_build/).
CACHES = {"CUDA_CACHE_PATH": "cuda", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def _fixed_caches() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".nomadbench_cache", sub)


def _fixed_hash_seed(argv) -> None:
    """Re-exec under PYTHONHASHSEED=0: every run then iterates the port's
    string-keyed sets and dicts in one order, whatever its --seed, so
    runs differ by the traffic the seed draws and not by the
    interpreter's per-process hash salt."""
    if os.environ.get("PYTHONHASHSEED") == "0":
        return
    env = dict(os.environ, PYTHONHASHSEED="0", NOMADBENCH_T0=str(T_START))
    os.execve(sys.executable, [sys.executable, "-m", "nomadbench.run",
                               *argv], env)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_hash_seed(argv)
    _fixed_caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    from nomadbench import harness

    manifest = harness.load_manifest()
    cell = harness.cell_of(manifest, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("nomadbench: no CUDA device is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"nomadbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        import nomad_tpu_torch  # noqa: F401  the system under test
    except ImportError as e:
        print(f"nomadbench: the port is missing: {e}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, manifest)
    found = harness.forbidden_modules()
    if found:
        print("nomadbench: loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}={c['value']} limit={c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
