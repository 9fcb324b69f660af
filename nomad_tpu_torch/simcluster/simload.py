"""Simcluster load-generation CLI for the port: run a named scale scenario
on the device and write its artifact.

    python -m nomad_tpu_torch.simcluster.simload --scenario steady-10k \
        --seed 42
    python -m nomad_tpu_torch.simcluster.simload --scenario steady-1k \\
        --device cpu --verify-determinism
    python -m nomad_tpu_torch.simcluster.simload --list

Writes ``SIMLOAD_<scenario>_s<seed>.json`` in the working directory
(override with --out) and prints one JSON summary line. The artifact
carries nomad_tpu's sections, ``profile`` among them (the runtime
observatory's role shares, the lock watchdog's table and the byte
ledger), and steady-10k's ``contrast.profiler_overhead``. ``--device``
defaults to the CUDA card; without one the run raises (pass ``cpu`` to
run the plain PyTorch path).

``--verify-determinism`` runs the scenario TWICE with the same seed and
requires equal canonical event digests (scenario.canonical_events); the
artifact records both digests and the verdict. Scenarios whose spec sets
``deterministic=False`` refuse verification instead of reporting a
vacuous pass. A scenario that needs a module the port does not have yet
exits with code 2 and names the module.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", default="steady-1k")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--nodes", type=int, default=None,
                    help="override the scenario's fleet size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default SIMLOAD_<name>_s<seed>.json)")
    ap.add_argument("--verify-determinism", action="store_true",
                    help="run twice with the same seed and require equal "
                         "canonical event digests")
    ap.add_argument("--list", action="store_true", help="list scenarios")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )

    from nomad_tpu_torch.simcluster.scenario import (
        SCENARIOS,
        NotPortedError,
        run_scenario,
        unported_needs,
    )

    if args.list:
        for name, spec in sorted(SCENARIOS.items()):
            needs = unported_needs(spec)
            state = ("runs" if not needs
                     else "waits for " + "; ".join(needs))
            print(f"{name:20s} n_nodes={spec.n_nodes:<6d} {state}")
        return 0

    spec = SCENARIOS.get(args.scenario)
    if spec is None:
        print(f"unknown scenario {args.scenario!r}; "
              f"have {sorted(SCENARIOS)}", file=sys.stderr)
        return 2
    if args.verify_determinism and not spec.deterministic:
        print(f"scenario {args.scenario!r} does not carry the "
              "per-entity determinism contract "
              "(spec.deterministic=False); refusing a vacuous verify",
              file=sys.stderr)
        return 2

    out_path = args.out or f"SIMLOAD_{args.scenario}_s{args.seed}.json"
    try:
        artifact = run_scenario(args.scenario, seed=args.seed,
                                n_nodes=args.nodes, device=args.device)
    except NotPortedError as e:
        print(str(e), file=sys.stderr)
        return 2

    if args.verify_determinism:
        # Main arms only: the contrast arm's digest is not part of the
        # determinism contract.
        second = run_scenario(args.scenario, seed=args.seed,
                              n_nodes=args.nodes, contrast=False,
                              device=args.device)
        match = (artifact["events"]["digest"] == second["events"]["digest"]
                 and artifact["events"]["by_type"]
                 == second["events"]["by_type"])
        artifact["determinism"] = {
            "verified": bool(match),
            "runs": 2,
            "digests": [artifact["events"]["digest"],
                        second["events"]["digest"]],
        }

    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=2, sort_keys=True)
        f.write("\n")
    print(json.dumps({
        "metric": f"simload.{args.scenario}",
        "seed": args.seed,
        "n_nodes": artifact["n_nodes"],
        "placed": artifact["placements"]["placed"],
        "placements_per_sec": artifact["placements"]["placements_per_sec"],
        "plan_latency_ms_p50": artifact["plan_latency_ms"].get("p50_ms"),
        "plan_latency_ms_p95": artifact["plan_latency_ms"].get("p95_ms"),
        "device_dispatches": artifact["placements"]["device_dispatches"],
        "digest": artifact["events"]["digest"],
        "determinism_verified": artifact.get("determinism", {}).get(
            "verified"),
        "backend": artifact["backend"],
        "artifact": out_path,
    }))
    if not artifact.get("determinism", {}).get("verified", True):
        print(json.dumps({"error": "determinism check FAILED",
                          "artifact": out_path}), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
