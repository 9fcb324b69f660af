"""One process of the multi-process DCN dry run.

Usage: python -m nomad_tpu_torch.parallel.dcn_worker <process_id>
       <num_processes> <coordinator_port> [n_nodes] [count] [device]

``device`` is "cuda" (the default), "cuda:<i>" or "cpu" (see
dcn.rank_device). Prints one line ``DCN_RESULT {json}`` and exits 0 on
success; prints ``DCN_UNSUPPORTED ...`` and exits 3 when
torch.distributed cannot initialize here -- the contract consumed by
dcn.spawn_dcn_workers.
"""

import json
import sys


def _main() -> None:
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    port = sys.argv[3]
    n_nodes = int(sys.argv[4]) if len(sys.argv) > 4 else 1024
    count = int(sys.argv[5]) if len(sys.argv) > 5 else 900
    device = sys.argv[6] if len(sys.argv) > 6 else "cuda"

    import torch
    import torch.distributed as dist

    from nomad_tpu_torch.parallel import dcn

    torch.set_num_threads(1)
    try:
        mesh = dcn.initialize(f"127.0.0.1:{port}", num_processes, process_id,
                              device)
    except (RuntimeError, ValueError) as e:
        print(f"DCN_UNSUPPORTED {type(e).__name__}: {e}", flush=True)
        sys.exit(3)
    try:
        out = dcn.run_dcn_solve(mesh, n_nodes=n_nodes, count=count)
    finally:
        dist.destroy_process_group()
    out["process_id"] = process_id
    out["ok"] = bool(
        out["placed"] == count and out["unplaced"] == 0
        and out["n_processes"] == num_processes and out["plain_equal"]
    )
    print("DCN_RESULT " + json.dumps(out), flush=True)
    sys.exit(0 if out["ok"] else 1)


if __name__ == "__main__":
    _main()
