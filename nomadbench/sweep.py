"""Find the knee of an open-loop cell: the highest offered rate at which
the p95 of due→complete stays under the limit with no growing backlog.

    python3 -m nomadbench.sweep --workload service10k-open \\
        --rates 20,40,80,160 --seconds 10 --seed 7

One server and one set-up serve every rate in turn (lowest first); each
rate runs a window of ``--seconds`` of the cell's own mix at that rate,
waits for what it sent, then stops every job it left live. A line per
rate gives p50/p95 of the registrations and stops, the p95 over each half
of the window (a backlog that grows shows as a second half far above the
first) and how late the generator ran. The knee is read off these lines;
the cell's mix file keeps the rate chosen from it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from nomadbench import cluster, harness, run as run_mod, stats
from nomadbench.drivers import open_service


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run_mod._fixed_caches()
    manifest = harness.load_manifest()
    cell = harness.cell_of(manifest, args.workload)
    cfg = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    r = harness.Run(cell, cfg, traffic, args.seed, args.seconds, False,
                    args.device)
    data_dir = tempfile.mkdtemp(prefix="nomadbench-sweep-")
    try:
        r.srv = cluster.start_server(cfg, args.device, data_dir, args.seed)
        r.srv.node_batch_register(cluster.build_nodes(cfg))
        open_service.setup(r)
        for rate in sorted(float(x) for x in args.rates.split(",")):
            r.traffic = dict(traffic, rate_per_s=rate)
            r.records = []
            t0 = time.perf_counter()
            loop = open_service.OpenLoop(r, t0, args.seconds, True, r.rng)
            loop.drive()
            loop.settle()
            regs = stats.latencies_ms(r.records, "register")
            half = [x for x, rec in zip(regs, r.window_records("register"))
                    if rec["due"] >= t0 + args.seconds / 2]
            first = regs[:len(regs) - len(half)]
            late = [(x["sent"] - x["due"]) * 1000.0 for x in loop.recs]
            print(json.dumps({
                "rate_per_s": rate, "sent": len(regs),
                "failed": sum(1 for x in regs if x >= stats.FAILED_MS),
                "eval_p50_ms": stats.pct(regs, 50),
                "eval_p95_ms": stats.pct(regs, 95),
                "eval_p95_ms_first_half": stats.pct(first, 95),
                "eval_p95_ms_second_half": stats.pct(half, 95),
                "stop_p95_ms": stats.pct(
                    stats.latencies_ms(r.records, "deregister"), 95),
                "generator_late_p50_ms": stats.pct(late, 50),
                "generator_late_max_ms": max(late) if late else None,
            }), flush=True)
            open_service._stop_all(r, loop)
    finally:
        if r.srv is not None:
            cluster.shutdown(r.srv)
        shutil.rmtree(data_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
