"""The port's multi-process (DCN) solve (nomad_tpu_torch.parallel.dcn):
two OS processes on the CPU, joined over gloo, each holding one node
shard, solve ONE water-fill through torch.distributed.all_reduce between
passes. Held to tests/test_dcn.py's expectations and to the port's
unsharded counts on the same inputs (integers, tolerance 0).
"""

import socket
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nomad_tpu_torch.ops import waterfill
from nomad_tpu_torch.parallel import dcn
from nomad_tpu_torch.parallel.dcn import DCNUnsupported, spawn_dcn_workers

torch.set_num_threads(2)


def unsharded_counts(n_nodes, count):
    case = [torch.tensor(a) for a in dcn.dcn_case(n_nodes, count)]
    counts, remaining = waterfill.solve_waterfill_batched_plain(
        *case, False, False)
    return counts[0].numpy(), int(remaining[0])


@pytest.mark.parametrize("n_nodes, count, nodes_used", [
    (256, 180, 180),             # test_dcn.py's case: one task a node
    (1024, 1024 * 6 + 700, 1024),  # level 6, the tie fill spans both ranks
])
def test_two_process_dcn_solve(n_nodes, count, nodes_used):
    try:
        results, _outs = spawn_dcn_workers(
            n_processes=2, n_nodes=n_nodes, count=count, device="cpu")
    except DCNUnsupported as e:
        pytest.skip(f"torch.distributed unsupported here: {e}")
    want, want_rem = unsharded_counts(n_nodes, count)
    assert want_rem == 0
    for r in results:
        assert r["ok"] is True
        assert r["plain_equal"] is True and r["plain_max_abs_err"] == 0
        assert r["n_processes"] == 2
        assert r["n_devices"] == 2  # one node shard a rank
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["placed"] == count and r["unplaced"] == 0
        # The partial round genuinely spread over the global node axis.
        assert r["nodes_used"] == nodes_used
        assert r["counts_sha256"] == dcn.counts_digest(want)
    assert sorted(r["process_id"] for r in results) == [0, 1]
    assert results[0]["counts_sha256"] == results[1]["counts_sha256"]


def test_one_rank_group_runs_the_same_solve():
    """A group of one rank in this process: the DistReduce seam around one
    shard gives the unsharded counts."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=60))
    try:
        mesh = dcn.dcn_mesh()
        assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, "gloo")
        out = dcn.run_dcn_solve(mesh, n_nodes=64, count=100)
    finally:
        dist.destroy_process_group()
    want, _rem = unsharded_counts(64, 100)
    assert out["counts_sha256"] == dcn.counts_digest(want)
    assert out["placed"] == 100 and out["unplaced"] == 0
    assert out["plain_equal"] is True


def test_rank_devices_and_backends():
    assert dcn.rank_device("cpu", 1, 2) == (torch.device("cpu"), "gloo")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dcn.rank_device("cuda", 0, 2)
    with pytest.raises(ValueError):
        dcn.rank_device("meta", 0, 2)


def test_dcn_case_is_test_dcn_inputs():
    """The dry run's inputs are nomad_tpu's run_dcn_solve's."""
    case = dcn.dcn_case(8, 5)
    assert case[0].shape == (1, 8, 4)
    np.testing.assert_array_equal(case[0][0, 0], [4000, 8192, 100 * 1024,
                                                  150])
    np.testing.assert_array_equal(case[8][0], [500, 256, 0, 0])
    assert int(case[10][0]) == 5 and float(case[11][0]) == 10.0
    assert case[7].all() and (case[5] == 1000).all()
