"""Run a cell with a fault or the control planted under the timed path,
on several seeds, and print each run's compared numbers: the readings
the limits are set between (see ``faults``).

    python3 -m nomadbench.control --workload batch10k-waves \\
        --fault control --seeds 11,12,13 --seconds 5

``--fault none`` runs the cell sound, for the lower readings. One
process runs every seed, each on a fresh server; the benchmark's own
runs never plant anything.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from nomadbench import faults, harness, run as run_mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run_mod._fixed_caches()
    plant = None if args.fault == "none" else faults.by_name(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               args.device, time.monotonic(),
                               plant=plant)
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": res["correct"],
                          "failed": res["failed"],
                          "checks": {k: c["value"] for k, c
                                     in res["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
