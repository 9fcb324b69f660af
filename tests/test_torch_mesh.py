"""The port's solver mesh (nomad_tpu_torch.parallel.mesh) against
nomad_tpu's (tests/test_mesh_solve.py, ported).

The same inputs, made from a seed with numpy, go through nomad_tpu's
``solve_waterfill`` / ``solve_greedy`` on its 8-virtual-device mesh
(``shard_waterfill_args``, ``replicate_on_mesh``) and through the port's
sharded solves on S ``cpu`` shards, whose passes are the plain versions
of csrc/waterfill_shard.cu and csrc/greedy.cu's merge (the CPU route of
the same wrappers). Counts, remaining, idx and ok are integers and must
be equal: tolerance 0.

Two contracts of the inputs, both stated where they are made:

- port sharded against port unsharded: any input (the random instances
  of chip_smoke.py's kernel phase); every decision is on integers and
  every score the same float32 arithmetic, so the shards change nothing.
  One caveat of the CPU route only: torch's CPU ``pow`` takes a
  vectorized path over whole vector steps (32 float32 with AVX-512) and a
  scalar one for the rest, which may differ by an ulp. A shard of at least
  16 rows (32 values of the [n, 2] free fractions) takes the vectorized
  path throughout, as the whole tensor does, so the random instances use
  128 or 256 rows; on the card every element takes the same ``powf``
  whatever the shard (chip_smoke.py holds it there at 2,048 rows a shard
  and up).
- port against nomad_tpu: nodes from a few fixed shapes and usage in
  whole asks, so candidate scores either tie exactly or differ by far
  more than the one ulp by which torch's and XLA's ``pow`` may differ
  (tests/test_torch_waterfill.py states that contract).
"""

import copy
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nomad_tpu import mock as jax_mock
from nomad_tpu import structs as jst
from nomad_tpu.ops.binpack import solve_greedy as jax_solve_greedy
from nomad_tpu.ops.binpack import solve_waterfill as jax_solve_waterfill
from nomad_tpu.parallel import mesh as jmesh
from nomad_tpu.scheduler import wait_for_device
from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.harness import Harness
from nomad_tpu_torch.ops import coalesce, greedy, waterfill
from nomad_tpu_torch.ops.coalesce import CoalescingSolver
from nomad_tpu_torch.parallel import mesh as pmesh
from nomad_tpu_torch.structs import Evaluation, generate_uuid

from sched_harness import Harness as JaxHarness

torch.set_num_threads(2)

SHARDS = [1, 2, 4, 8]
SHAPES = [(2000, 4096), (4000, 8192), (8000, 16384)]
N = 64


@pytest.fixture
def node_mesh():
    """Configure the port's solve mesh over S entries of ``cpu``; cleared
    after the test."""
    def configure(s=8, eval_parallel=1):
        return pmesh.configure_node_sharding(
            s * eval_parallel, eval_parallel=eval_parallel,
            devices=["cpu"] * (s * eval_parallel))
    try:
        yield configure
    finally:
        pmesh.clear_node_sharding()


@pytest.fixture(scope="module")
def _jax_device_path():
    """nomad_tpu's tpu-* factories fall back to its host oracle until the
    device probe succeeds; the comparison needs its device solver."""
    assert wait_for_device(timeout=120.0) is not None


# -- inputs -------------------------------------------------------------------


def shaped_case(seed, mode="shaped", n=N):
    """One eval's 12 solve inputs (numpy), nodes from SHAPES, usage in
    whole asks. ``mode`` picks an edge case of the sharded water-fill:
    "rem0" (the level places every task: remaining 0), "over" (count
    above the total capacity: no candidate is left), "tie" (identical
    nodes: the partial round's boundary crosses every shard), "count0",
    "ineligible" (no eligible node)."""
    rng = np.random.default_rng(seed)
    ask = np.array([100, 128, 0, 0], dtype=np.int32)
    live = n - n // 8
    total = np.zeros((n, 4), dtype=np.int32)
    pick = rng.integers(0, len(SHAPES), live) if mode != "tie" else 0
    total[:live, :2] = np.array(SHAPES)[pick]
    total[:live, 2] = 100 * 1024
    total[:live, 3] = 150
    used = np.zeros((n, 4), dtype=np.int32)
    if mode != "tie":
        used[:live] = ask * rng.integers(0, 4, (live, 1))
    eligible = np.zeros(n, dtype=bool)
    eligible[:live] = mode != "ineligible"
    job_count = (rng.integers(0, 2, n) * (mode != "tie")).astype(np.int32)
    cap = np.where(eligible, ((total - used)[:, :2] // ask[:2]).min(1), 0)
    count = {"rem0": int(np.minimum(cap, 2).sum()),
             "over": int(cap.sum()) + 7,
             "tie": int(cap[:live].min()) * live // 2 + live // 2 + 3,
             "count0": 0, "ineligible": 500}.get(mode)
    if count is None:
        count = int(rng.integers(50, 2 * cap.sum()))
    zeros = np.zeros(n, dtype=np.int32)
    return (total, total[:, :2].astype(np.float32), used, job_count, zeros,
            zeros, zeros, eligible, ask, np.int32(0), count, 10.0)


def port_row(case, device="cpu"):
    """A coalescer row (the 10 tensors, count, penalty, flags)."""
    t = [torch.tensor(np.asarray(a), device=device) for a in case[:10]]
    return (*t, int(case[10]), float(case[11]), False, False)


def port_sharded_row(case):
    """port_row with its node tensors born sharded on the configured mesh,
    as the mirror's are."""
    row = list(port_row(case))
    for i in range(8):
        row[i] = pmesh.put_node_sharded(np.asarray(case[i]), "cpu")
    return tuple(row)


def batch_args(case):
    """The case as the batched solve's 12 inputs, B = 1 (CPU)."""
    row = port_row(case)
    return (*(x.unsqueeze(0) for x in row[:10]),
            torch.tensor([case[10]], dtype=torch.int32),
            torch.tensor([case[11]], dtype=torch.float32))


def per_pass_waterfill(case, s, groups=None):
    """The case over S shards on the per-pass route, as ``groups`` groups
    of one process each (default S: one shard a group), through
    chip_smoke.group_solve: a thread a group, each group's plain passes
    with its shards combined locally, MeshReduce between the groups.
    Returns (counts [N] numpy, remaining)."""
    shards, small = chip_smoke.shard_wf_args(batch_args(case), s)
    parts, rem = chip_smoke.group_solve(
        waterfill.solve_waterfill_sharded, shards, small, case[10], False,
        False, s if groups is None else groups)
    return torch.cat(parts, 1)[0].numpy(), int(rem[0])


def jax_sharded_waterfill(case, s):
    mesh = jmesh.configure_node_sharding(s)
    try:
        args10 = jmesh.shard_waterfill_args(
            mesh, tuple(jnp.asarray(a) for a in case[:10]))
        count, penalty = jmesh.replicate_on_mesh(
            mesh, jnp.int32(case[10]), jnp.float32(case[11]))
        counts, remaining = jax_solve_waterfill(
            *args10, count, penalty, False, False)
        return np.asarray(counts), int(remaining)
    finally:
        jmesh.clear_node_sharding()


def jax_sharded_greedy(case, k, s):
    mesh = jmesh.configure_node_sharding(s)
    try:
        args10 = jmesh.shard_waterfill_args(
            mesh, tuple(jnp.asarray(a) for a in case[:10]))
        active, penalty = jmesh.replicate_on_mesh(
            mesh, jnp.arange(k) < case[10], jnp.float32(case[11]))
        idx, ok, _score = jax_solve_greedy(
            *args10, active, penalty, k, False, False)
        return np.asarray(idx), np.asarray(ok)
    finally:
        jmesh.clear_node_sharding()


# -- the water-fill -----------------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
def test_waterfill_sharded_matches_single_device(node_mesh, s):
    """The closed-form water-fill, dispatched with node-axis shardings,
    gives identical counts: the port's single-entry mesh arm against its
    unsharded solve and against nomad_tpu's sharded solve_waterfill; and
    the same case on the per-pass route, one shard a group, each shard's
    partials through the MeshReduce seam (per_pass_waterfill)."""
    node_mesh(s)
    for trial in range(4):
        case = shaped_case(100 + trial)
        row = port_sharded_row(case)
        counts, remaining = coalesce._stack_and_solve([row], False, False)
        plain_c, plain_r = waterfill.solve_waterfill(
            *port_row(case)[:10], case[10], case[11], False, False)
        jax_c, jax_r = jax_sharded_waterfill(case, s)
        pass_c, pass_r = per_pass_waterfill(case, s)
        np.testing.assert_array_equal(counts[0].numpy(), plain_c.numpy())
        np.testing.assert_array_equal(counts[0].numpy(), jax_c)
        np.testing.assert_array_equal(pass_c, jax_c)
        assert int(remaining[0]) == plain_r == jax_r == pass_r


@pytest.mark.parametrize("mode", ["rem0", "over", "tie", "count0",
                                  "ineligible"])
@pytest.mark.parametrize("s", SHARDS)
def test_waterfill_sharded_edge_cases(node_mesh, s, mode):
    node_mesh(s)
    case = shaped_case(7, mode)
    counts, remaining = coalesce._stack_and_solve(
        [port_sharded_row(case)], False, False)
    jax_c, jax_r = jax_sharded_waterfill(case, s)
    np.testing.assert_array_equal(counts[0].numpy(), jax_c)
    assert int(remaining[0]) == jax_r
    # The per-pass route, one shard a group, through the MeshReduce seam.
    pass_c, pass_r = per_pass_waterfill(case, s)
    np.testing.assert_array_equal(pass_c, jax_c)
    assert pass_r == jax_r
    placed = int(counts.sum())
    if mode in ("rem0", "tie"):
        assert jax_r == 0 and placed == case[10]
    if mode == "over":
        assert jax_r > 0 and placed > 0
    if mode == "tie":  # the boundary's fill ends inside a later shard
        c = counts[0].numpy()[: N - N // 8]
        assert c.max() > c.min() and (c[:np.argmin(c)] == c.max()).all()
    if mode in ("count0", "ineligible"):
        assert placed == 0 and jax_r == case[10]


@pytest.mark.parametrize("s", SHARDS)
def test_waterfill_sharded_equals_unsharded_on_random_instances(s):
    """Every mode of chip_smoke.py's kernel phase (over-committed rows,
    bandwidth asks, distinct-hosts scopes, caps above 2^16), sharded,
    against the unsharded plain version: the whole solve (one device
    group: its shards' rows side by side), and the per-pass route with
    one shard a group, each shard's plain passes and the MeshReduce seam
    between them (chip_smoke.group_solve). Tolerance 0."""
    rng = np.random.default_rng(5 + s)
    modes = ["random", "headline", "ties", "saturated", "count0",
             "ineligible", "bigcaps"]
    for trial in range(14):
        mode = modes[trial % len(modes)]
        n = int(rng.choice([128, 256]))
        jd, td = bool(rng.random() < 0.3), bool(rng.random() < 0.3)
        args = chip_smoke.waterfill_case(rng, n, int(rng.integers(1, 4)),
                                         jd, td, mode, "cpu")
        want_c, want_r = waterfill.solve_waterfill_batched_plain(*args)
        shards, small = chip_smoke.shard_wf_args(args, s)
        parts, rem = waterfill.solve_waterfill_sharded(
            shards, small, int(args[10].max()), jd, td, pmesh.MeshReduce())
        assert torch.equal(torch.cat(parts, 1), want_c), (mode, n)
        assert torch.equal(rem, want_r), (mode, n)
        parts, rem = chip_smoke.group_solve(
            waterfill.solve_waterfill_sharded, shards, small,
            int(args[10].max()), jd, td, s)
        assert torch.equal(torch.cat(parts, 1), want_c), (mode, n, "groups")
        assert torch.equal(rem, want_r), (mode, n, "groups")


def test_shard_rounds_are_bounded():
    """1 (max cap) + the level passes (8 bits of the largest count a pass,
    at least 1) + 4 (threshold) + 1 (boundary prefix): at most 10, and 9
    at the headline's 100,000 tasks."""
    assert waterfill.level_shifts(0) == [0]
    assert waterfill.level_shifts(255) == [0]
    assert waterfill.level_shifts(100_000) == [16, 8, 0]
    assert waterfill.level_shifts(2**31 - 1) == [24, 16, 8, 0]
    assert waterfill.shard_rounds(100_000) == 9
    assert waterfill.shard_rounds(2**31 - 1) == 10


CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("devices, n_s, whole, single, groups", [
    # A mesh of one card: one launch up to 8 blocks an eval.
    ([CUDA0] * 4, 2048, True, True, [(0, 4)]),
    ([CUDA0] * 8, 16384, True, True, [(0, 8)]),
    ([CUDA0] * 4, 32768, True, True, [(0, 4)]),     # 2 blocks a shard
    ([CUDA0], 262144, True, True, [(0, 1)]),        # 8 blocks, scratch
    # Past 8 blocks an eval: the passes, the card's shards in one group.
    ([CUDA0] * 4, 65536, True, False, [(0, 4)]),    # 4 blocks a shard
    ([CUDA0] * 16, 1024, True, False, [(0, 16)]),
    ([CUDA0] * 32, 1024, True, False, [(0, 16), (16, 32)]),
    # Distinct cards: a group each run of consecutive shards on one card.
    ([CUDA0, CUDA0, CUDA1, CUDA1], 2048, True, False, [(0, 2), (2, 4)]),
    ([CUDA0, CUDA1, CUDA0, CUDA1], 2048, True, False,
     [(0, 1), (1, 2), (2, 3), (3, 4)]),
    # One process's part of a larger (DCN) solve: the passes.
    ([CUDA0] * 2, 2048, False, False, [(0, 2)]),
    (["cpu"] * 8, 256, True, True, [(0, 8)]),
    (["cpu"], 64, False, False, [(0, 1)]),
])
def test_shard_route_groups_by_device(devices, n_s, whole, single, groups):
    """The route follows from the shards' devices and rows alone, before
    any launch (no card is needed to plan one)."""
    route = waterfill.shard_route(devices, n_s, whole)
    assert route.single == single
    assert route.groups == groups


def test_shard_blocks_is_the_water_fill_rule():
    """A shard's blocks: the next power of two of n_s / 16,384, at least 1,
    at most 8 (csrc/waterfill_cluster.cuh cluster_size)."""
    got = [waterfill.shard_blocks(n) for n in (
        1, 16384, 16385, 32768, 40000, 131072, 131073, 1 << 20)]
    assert got == [1, 1, 2, 2, 4, 8, 8, 8]


@pytest.mark.parametrize("mode", ["shaped", "tie", "tie_late", "over",
                                  "rem0"])
@pytest.mark.parametrize("s", [2, 4, 8])
def test_waterfill_two_groups_match_nomad_tpu(s, mode):
    """The per-pass route with two device groups, as two processes of a
    DCN solve run it: group g holds shards [g S/2, (g+1) S/2)
    (first_index, n_shards), combines its shards' partials locally, and
    the seam combines the two groups' rows through MeshReduce (two
    threads, chip_smoke.group_solve). Equal to nomad_tpu's
    node-sharded solve_waterfill and to the unsharded solve; tolerance 0
    ("tie": the boundary's fill ends in the first group; "tie_late":
    N / 4 more tasks, so it ends inside the second)."""
    case = list(shaped_case(40 + s, mode.replace("_late", "")))
    if mode == "tie_late":
        case[10] += N // 4
    row = port_row(case)
    shards, _small = chip_smoke.shard_wf_args(batch_args(case), s)
    half = s // 2
    for g in (0, 1):
        route = waterfill.shard_route(
            [x[0].device for x in shards[g * half:(g + 1) * half]],
            N // s, whole=False)
        assert not route.single and route.groups == [(0, half)]
    counts, rem = per_pass_waterfill(case, s, 2)
    jax_c, jax_r = jax_sharded_waterfill(case, s)
    plain_c, plain_r = waterfill.solve_waterfill(
        *row[:10], case[10], case[11], False, False)
    np.testing.assert_array_equal(counts, jax_c)
    np.testing.assert_array_equal(counts, plain_c.numpy())
    assert rem == jax_r == plain_r
    if mode.startswith("tie"):
        live = counts[: N - N // 8]
        cut = int((live == live.max()).sum())
        assert (live[:cut] == live.max()).all() and live.min() < live.max()
        assert (cut > N // 2) == (mode == "tie_late")


@pytest.mark.parametrize("mode", ["shaped", "tie", "tie_late", "over",
                                  "rem0", "count0", "ineligible"])
@pytest.mark.parametrize("groups", [4, 8])
def test_waterfill_many_groups_match_nomad_tpu(groups, mode):
    """The per-pass route over 8 shards as 4 or 8 device groups, as that
    many DCN ranks or cards run it: a thread a group (first_index,
    n_shards), each group's shards combined locally, the seam over every
    group's row through MeshReduce (chip_smoke.group_solve). The boundary
    round's columns then sit at 0, 8 / G, ...: the "tie" fill ends in
    the second group's column or later, "tie_late"'s past the middle.
    Equal to nomad_tpu's node-sharded solve_waterfill and to the
    unsharded solve; tolerance 0."""
    s = 8
    case = list(shaped_case(60 + groups, mode.replace("_late", "")))
    if mode == "tie_late":
        case[10] += N // 4
    row = port_row(case)
    counts, rem = per_pass_waterfill(case, s, groups)
    jax_c, jax_r = jax_sharded_waterfill(case, s)
    plain_c, plain_r = waterfill.solve_waterfill(
        *row[:10], case[10], case[11], False, False)
    np.testing.assert_array_equal(counts, jax_c)
    np.testing.assert_array_equal(counts, plain_c.numpy())
    assert rem == jax_r == plain_r
    if mode.startswith("tie"):
        live = counts[: N - N // 8]
        cut = int((live == live.max()).sum())
        assert (live[:cut] == live.max()).all() and live.min() < live.max()
        per_group = N // groups
        assert cut > per_group and cut % per_group  # inside a later group
        assert (cut > N // 2) == (mode == "tie_late")


def test_coalesced_batch_dispatch_on_mesh(node_mesh):
    """The batched water-fill runs sharded too: concurrent entries through
    the coalescer on the mesh match their individual solves."""
    node_mesh(8)
    engine = CoalescingSolver()
    cases = [shaped_case(200 + i) for i in range(4)]
    fetches = [engine.submit(*port_sharded_row(c)[:12]) for c in cases]
    for case, fetch in zip(cases, fetches):
        counts, unplaced = fetch()
        jax_c, jax_r = jax_sharded_waterfill(case, 8)
        np.testing.assert_array_equal(counts, jax_c)
        assert unplaced == jax_r
    assert engine.quiesce(5.0)


def test_eval_axis_splits_over_the_mesh_rows(node_mesh):
    """A (2 evals x 4 nodes) mesh: a stack of 4 splits 2 a row, a stack of
    1 solves on the first row; both equal the unsharded solves."""
    mesh = node_mesh(4, eval_parallel=2)
    assert mesh.shape == {pmesh.EVAL_AXIS: 2, pmesh.NODE_AXIS: 4}
    cases = [shaped_case(300 + i) for i in range(4)]
    for rows in ([port_sharded_row(c) for c in cases],
                 [port_sharded_row(cases[0])]):
        counts, remaining = coalesce._stack_and_solve(rows, False, False)
        for i, row in enumerate(rows):
            want_c, want_r = waterfill.solve_waterfill(
                *(pmesh.whole(x) for x in row[:10]), row[10], row[11],
                False, False)
            assert torch.equal(counts[i], want_c)
            assert int(remaining[i]) == want_r


def test_rows_born_sharded_solve_after_the_mesh_is_cleared(node_mesh):
    """A mirror built under a mesh keeps its ShardedTensors; once the mesh
    is cleared, its solves run single-device on the whole tensors."""
    node_mesh(4)
    case = shaped_case(600)
    row = port_sharded_row(case)
    exact_row = list(row)
    exact_row[10] = 24
    pmesh.clear_node_sharding()
    counts, remaining = coalesce._stack_and_solve([row], False, False)
    want_c, want_r = waterfill.solve_waterfill(
        *port_row(case)[:10], case[10], case[11], False, False)
    assert torch.equal(counts[0], want_c) and int(remaining[0]) == want_r
    idx, ok = coalesce._stack_and_solve_exact([tuple(exact_row)], 32,
                                              False, False)
    want = greedy.solve_greedy(*port_row(case)[:10],
                               torch.arange(32) < 24, case[11], 32, False,
                               False)
    assert torch.equal(idx[0], want[0]) and torch.equal(ok[0], want[1])


def test_mesh_dispatch_count_bounded_for_concurrent_evals(node_mesh):
    """Concurrent solves on the mesh stay correct and bounded: K submits
    cost at most K dispatches, each matching its single-device solve."""
    node_mesh(8)
    engine = CoalescingSolver()
    cases = [shaped_case(400 + i) for i in range(3)]
    expected = [waterfill.solve_waterfill(*port_row(c)[:10], c[10], c[11],
                                          False, False) for c in cases]
    d0 = engine.dispatches
    fetches = [engine.submit(*port_sharded_row(c)[:12]) for c in cases]
    for fetch, (want_c, want_r) in zip(fetches, expected):
        counts, unplaced = fetch()
        np.testing.assert_array_equal(counts, want_c.numpy())
        assert unplaced == want_r
    assert engine.dispatches - d0 <= len(cases)
    assert engine.quiesce(5.0)


# -- the exact scan -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["shaped", "tie", "padding", "ineligible"])
@pytest.mark.parametrize("s", SHARDS)
def test_greedy_sharded_matches_nomad_tpu(node_mesh, s, mode):
    """The exact scan on the mesh (each shard's scan, the merge) against
    nomad_tpu's sharded solve_greedy and the port's unsharded scan:
    "padding" leaves inactive steps after count, "ineligible" gives an
    all -inf step (index 0, ok false) at every step."""
    node_mesh(s)
    k = 32
    case = list(shaped_case(11, {"padding": "shaped"}.get(mode, mode)))
    case[10] = {"padding": 19}.get(mode, k)
    row = port_sharded_row(case)
    idx, ok = coalesce._stack_and_solve_exact([row], k, False, False)
    jax_idx, jax_ok = jax_sharded_greedy(case, k, s)
    np.testing.assert_array_equal(idx[0].numpy(), jax_idx)
    np.testing.assert_array_equal(ok[0].numpy(), jax_ok)
    plain = greedy.solve_greedy(
        *port_row(case)[:10], torch.arange(k) < case[10], case[11], k,
        False, False)
    np.testing.assert_array_equal(idx[0].numpy(), plain[0].numpy())
    if mode == "ineligible":
        assert not ok.any() and not idx.any()
    if mode == "padding":
        assert ok[0, :19].all() and not ok[0, 19:].any()


@pytest.mark.parametrize("s", SHARDS)
def test_greedy_sharded_equals_unsharded_on_random_instances(s):
    """chip_smoke.py's greedy modes (random nodes and usage, identical
    nodes, no eligible node; distinct-hosts scopes; some evals with
    padding steps) through each shard's scan and the merge, against the
    unsharded plain scan. Tolerance 0."""
    rng = np.random.default_rng(50 + s)
    for trial in range(6):
        mode = ["random", "ties", "infeasible"][trial % 3]
        jd, td = bool(rng.random() < 0.3), bool(rng.random() < 0.3)
        args = chip_smoke.greedy_case(rng, 128, int(rng.integers(1, 4)),
                                      16, "cpu", jd, td, mode)
        want = greedy.solve_greedy_batched_shared_plain(*args)
        got = greedy.solve_greedy_sharded(chip_smoke.shard_greedy_args(args, s), args[10],
                                          16, jd, td)
        for g, w in zip(got, want):
            assert torch.equal(g, w), mode


def test_stacked_exact_dispatch_on_mesh_matches_single_device(node_mesh):
    """The cross-eval batched exact scan runs sharded too: stacked entries
    through the coalescer on the mesh match their single-device solves
    bit for bit."""
    node_mesh(8)
    engine = CoalescingSolver()
    base = shaped_case(500)
    cases = []
    for i in range(4):
        c = list(base)
        c[8] = np.array([50 + 10 * i, 128, 0, 0], dtype=np.int32)
        c[10] = 20 + 7 * i
        cases.append(c)
    shared = port_sharded_row(base)
    token = engine.hint_burst(len(cases))
    fetches = []
    for c in cases:
        engine.burst_begin(token)
        row = list(port_sharded_row(c))
        for i in (0, 1, 5):  # one mirror: the shared node tensors
            row[i] = shared[i]
        fetches.append(engine.submit_exact(*row[:12]))
    for c, fetch in zip(cases, fetches):
        idxs, oks = fetch()
        jax_idx, jax_ok = jax_sharded_greedy(c, coalesce.bucket(c[10]), 8)
        np.testing.assert_array_equal(idxs, jax_idx[:c[10]])
        np.testing.assert_array_equal(oks, jax_ok[:c[10]])
    assert engine.quiesce(5.0)


def test_solve_batch_on_mesh_matches_nomad_tpu():
    """The multichip dry run's program: make_tiny_batch through
    solve_batch_on_mesh on both packages' meshes."""
    k = 8
    mesh = pmesh.make_mesh(8, eval_parallel=2, devices=["cpu"] * 8)
    got = pmesh.solve_batch_on_mesh(
        mesh, pmesh.make_tiny_batch(64, 4, k, device="cpu"), k)
    jm = jmesh.make_mesh(8, eval_parallel=2)
    want = jmesh.solve_batch_on_mesh(jm, jmesh.make_tiny_batch(64, 4, k), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the scheduler on a mesh --------------------------------------------------


def _run_big_service_eval(harness_cls, mock_mod, structs_mod, factory,
                          **kw):
    """A 32-node cluster and a count=300 service job: count > the exact
    threshold, so the device path runs the water-fill."""
    h = harness_cls()
    for _ in range(32):
        node = mock_mod.node()
        node.resources.cpu = 14000
        node.resources.memory_mb = 28000
        h.state.upsert_node(h.next_index(), node)
    job = mock_mod.job()
    job.task_groups[0].count = 300
    h.state.upsert_job(h.next_index(), job)
    ev = structs_mod.Evaluation(
        id=structs_mod.generate_uuid(), priority=job.priority,
        triggered_by=structs_mod.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
    )
    h.process(factory, ev, **kw)
    assert len(h.plans) == 1
    per_node = {}
    for node_id, allocs in h.plans[0].node_allocation.items():
        per_node[node_id] = per_node.get(node_id, 0) + len(allocs)
    for batch in h.plans[0].alloc_batches:
        for node_id, cnt in zip(batch.node_ids, batch.node_counts):
            per_node[node_id] = per_node.get(node_id, 0) + int(cnt)
    return h, per_node


def test_tpu_scheduler_end_to_end_sharded_matches_single_device(
        node_mesh, _jax_device_path):
    """The port's TPUGenericScheduler end to end over the mesh: the same
    multiset of per-node counts as its single-device dispatch and as
    nomad_tpu's scheduler on its 8-device mesh, and every task placed."""
    _h0, single = _run_big_service_eval(Harness, mock, structs,
                                        "tpu-service", device="cpu")
    node_mesh(8)
    _h1, sharded = _run_big_service_eval(Harness, mock, structs,
                                         "tpu-service", device="cpu")
    pmesh.clear_node_sharding()
    jmesh.configure_node_sharding(8)
    try:
        _h2, ref = _run_big_service_eval(JaxHarness, jax_mock, jst,
                                         "tpu-service")
    finally:
        jmesh.clear_node_sharding()
    assert sum(single.values()) == 300
    assert sorted(single.values()) == sorted(sharded.values())
    assert sorted(sharded.values()) == sorted(ref.values())


def test_tpu_system_scheduler_on_mesh(node_mesh):
    """The system scheduler's one-dispatch fit runs one fit a shard."""
    node_mesh(8)
    h = Harness()
    for _ in range(16):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.system_job()
    h.state.upsert_job(h.next_index(), job)
    ev = Evaluation(
        id=generate_uuid(), priority=job.priority,
        type=structs.JOB_TYPE_SYSTEM,
        triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
    )
    pmesh.reset_stats()
    h.process("tpu-system", ev, device="cpu")
    assert len(h.plans) == 1
    placed = sum(len(v) for v in h.plans[0].node_allocation.values()) + sum(
        b.n for b in h.plans[0].alloc_batches)
    assert placed == 16
    assert pmesh.STATS["node_puts"] > 0
    assert pmesh.STATS["node_reshards"] == 0


def test_mesh_dispatch_guardrails(node_mesh):
    """A warm eval on the mesh issues exactly one coalesced dispatch and
    reshards NO node-axis tensor at dispatch (mirror tensors and usage are
    born sharded); small-argument replication stays bounded."""
    from nomad_tpu_torch.ops.coalesce import GLOBAL_SOLVER

    node_mesh(8)
    h = Harness()
    for i in range(64):
        node = mock.node()
        node.id = f"guard-{i:03d}"
        node.resources.cpu = 14000
        node.resources.memory_mb = 28000
        h.state.upsert_node(h.next_index(), node)
    def run(job_id):
        job = mock.job()
        job.id = job_id
        job.task_groups[0].count = 200  # > threshold: the water-fill
        for t in job.task_groups[0].tasks:
            t.resources = structs.Resources(cpu=50, memory_mb=64)
        h.state.upsert_job(h.next_index(), job)
        ev = Evaluation(
            id=generate_uuid(), priority=job.priority, type=job.type,
            triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
        )
        h.process("tpu-batch", ev, device="cpu")

    run("guard-warm")  # warm: builds the mirror, fills the mask caches
    # Measured: the same mirror, existing allocs present (usage is built,
    # not the clean fast path), one solve.
    pmesh.reset_stats()
    d0 = GLOBAL_SOLVER.dispatches
    run("guard-job")
    assert GLOBAL_SOLVER.dispatches - d0 == 1
    assert pmesh.STATS["node_reshards"] == 0, pmesh.STATS
    assert 0 < pmesh.STATS["node_puts"] <= 8, pmesh.STATS
    assert pmesh.STATS["replications"] <= 6, pmesh.STATS
    placed = sum(b.n for b in h.plans[-1].alloc_batches) + sum(
        len(v) for v in h.plans[-1].node_allocation.values())
    assert placed == 200


def test_sharded_mirror_delta_roll_keeps_node_sharding(node_mesh):
    """Rolling a sharded mirror forward through a node write leaves its
    buffers sharded: the dirty row is restaged in its owning shard only,
    every other shard is shared as it is, and the ancestor mirror (evals
    in flight still read it) keeps the old row."""
    from nomad_tpu_torch.state import StateStore
    from nomad_tpu_torch.tpu.mirror import MirrorCache

    mesh = node_mesh(8)
    store = StateStore()
    nodes = []
    for i in range(12):
        n = mock.node()
        n.id = f"roll-{i:02d}"
        store.upsert_node(i + 1, n)
        nodes.append(n)
    cache = MirrorCache()
    _n0, m0 = cache.get(store.snapshot(), ["dc1"], device="cpu")
    for name in ("total", "sched_cap", "bw_avail"):
        t = getattr(m0, name)
        assert isinstance(t, pmesh.ShardedTensor) and t.mesh is mesh
        assert len(t.shards) == 8 and t.shape[0] == m0.padded

    n2 = copy.deepcopy(nodes[3])
    n2.resources.cpu += 111
    store.upsert_node(100, n2)
    rolls0 = cache.delta_rolls
    _n1, m1 = cache.get(store.snapshot(), ["dc1"], device="cpu")
    assert cache.delta_rolls == rolls0 + 1, "write did not take the roll"
    row = m1.index["roll-03"]
    owner = row // (m1.padded // 8)
    for name in ("total", "sched_cap", "bw_avail"):
        old, new = getattr(m0, name), getattr(m1, name)
        assert isinstance(new, pmesh.ShardedTensor) and new.mesh is mesh
        for i in range(8):
            assert (new.shards[i] is old.shards[i]) == (i != owner), name
    assert int(m1.total.cpu()[row, 0]) == n2.resources.cpu
    assert int(m0.total.cpu()[row, 0]) == nodes[3].resources.cpu


def test_byte_ledger_counts_every_shard(node_mesh):
    from nomad_tpu_torch.tpu.mirror import NodeMirror

    plain = NodeMirror([mock.node() for _ in range(12)], "cpu")
    node_mesh(8)
    sharded = NodeMirror([mock.node() for _ in range(12)], "cpu")
    assert isinstance(sharded.total, pmesh.ShardedTensor)
    assert sharded.byte_ledger()["buffers"] == plain.byte_ledger()["buffers"]


# -- the server-config face ---------------------------------------------------


def test_the_default_devices_are_the_cards(monkeypatch):
    """``None`` means the CUDA cards at every entry to the device list:
    local_devices, make_mesh, the NOMAD_TPU_NODE_SHARDS path and
    apply_solver_mesh. Without a card each raises as resolve_device does
    (no CPU stands in); the CPU list is asked for by name."""
    assert pmesh.local_devices("cpu") == [torch.device("cpu")] * 8
    if torch.cuda.is_available():
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        assert pmesh.local_devices() == pmesh.local_devices("cuda") == cards
        assert pmesh.make_mesh().node_devices == cards
        return
    for call in (pmesh.local_devices, lambda: pmesh.local_devices("cuda"),
                 pmesh.make_mesh, lambda: pmesh.make_mesh(2),
                 lambda: pmesh.apply_solver_mesh(
                     pmesh.SolverMeshConfig.parse({"node_shards": 2}))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    monkeypatch.setenv("NOMAD_TPU_NODE_SHARDS", "2")
    monkeypatch.setattr(pmesh, "_env_checked", False)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.node_sharding_mesh()
    finally:
        pmesh.clear_node_sharding()
    assert pmesh.node_sharding_mesh() is None  # the env is read once


def test_apply_solver_mesh_fallback_and_configure(caplog):
    """A mesh the local device set can't satisfy leaves solves
    single-device (None, nomad_tpu's warning); a satisfiable one
    configures and is the mesh every solve reads."""
    cfg = pmesh.SolverMeshConfig.parse({"node_shards": 1024})
    with caplog.at_level(logging.WARNING, logger="nomad_tpu_torch"):
        assert pmesh.apply_solver_mesh(cfg, device="cpu") is None
    assert pmesh.node_sharding_mesh() is None
    assert ("solver_mesh wants 1024 device(s) (node_shards=1024 x "
            "eval_parallel=1) but only 8 present; solves stay "
            "single-device") in caplog.text

    cfg = pmesh.SolverMeshConfig.parse({"node_shards": 4,
                                        "eval_parallel": 2})
    mesh = pmesh.apply_solver_mesh(cfg, device="cpu")
    try:
        assert mesh is not None
        assert mesh.shape[pmesh.NODE_AXIS] == 4
        assert mesh.shape[pmesh.EVAL_AXIS] == 2
        assert pmesh.node_sharding_mesh() is mesh
        assert pmesh.mesh_for_nodes(16) is mesh
        assert pmesh.mesh_for_nodes(2) is None  # the bucket doesn't divide
    finally:
        pmesh.clear_node_sharding()
    assert pmesh.apply_solver_mesh(
        pmesh.SolverMeshConfig.parse(None)) is None


MESH_SPECS = [
    None, {}, {"node_shards": 4}, {"node_shards": 4, "eval_parallel": 2},
    {"node_shards": 0}, {"node_shards": 1}, {"eval_parallel": 64},
    {"node_shards": 4096}, {"node_shards": 3}, {"node_shards": -1},
    {"bogus": 1}, {"eval_parallel": 0}, {"node_shards": 8192},
    {"node_shards": True}, {"node_shards": "4"}, {"eval_parallel": 6}, [],
]


@pytest.mark.parametrize("spec", MESH_SPECS, ids=str)
def test_solver_mesh_config_parse_equals_nomad_tpu(spec):
    """Same keys, ranges and error text as nomad_tpu's SolverMeshConfig
    (test_aux.py's cases and more)."""
    try:
        want = jmesh.SolverMeshConfig.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as info:
            pmesh.SolverMeshConfig.parse(spec)
        assert str(info.value) == str(e)
        return
    got = pmesh.SolverMeshConfig.parse(spec)
    assert got.as_dict() == want.as_dict()
    assert got.enabled == want.enabled


def test_solver_mesh_in_config_files_and_server_config():
    """``server { solver_mesh { } }`` parses, merges key by key and
    rejects as nomad_tpu's agent config does; ServerConfig parses it."""
    from nomad_tpu.agent_config import parse_config as jax_parse
    from nomad_tpu_torch.agent_config import parse_config
    from nomad_tpu_torch.server.server import ServerConfig

    text = ("server {\n  enabled = true\n  solver_mesh {\n"
            "    node_shards = 4\n    eval_parallel = 2\n  }\n}\n")
    cfg = parse_config(text)
    assert cfg.server.solver_mesh == jax_parse(text).server.solver_mesh
    merged = cfg.merge(parse_config("server { solver_mesh { node_shards = 8 } }"))
    assert merged.server.solver_mesh == {"node_shards": 8,
                                         "eval_parallel": 2}
    for bad in ("server { solver_mesh { node_shards = 3 } }",
                "server { solver_mesh { node_shards = -1 } }",
                "server { solver_mesh { bogus = 1 } }",
                "server { solver_mesh { eval_parallel = 0 } }"):
        with pytest.raises(ValueError) as info:
            parse_config(bad)
        with pytest.raises(ValueError) as ref:
            jax_parse(bad)
        assert str(info.value) == str(ref.value)
    sc = ServerConfig(device="cpu", solver_mesh={"node_shards": 2})
    assert sc.solver_mesh_config.enabled
    assert sc.solver_mesh_config.as_dict() == {"node_shards": 2,
                                               "eval_parallel": 1}
    assert not ServerConfig(device="cpu").solver_mesh_config.enabled
    with pytest.raises(ValueError):
        ServerConfig(device="cpu", solver_mesh={"node_shards": 6})


@pytest.mark.parametrize("shards, want_mesh", [(16, False), (4, True)])
def test_server_applies_its_solver_mesh(shards, want_mesh, caplog):
    """Server.start configures the mesh before any worker builds a mirror
    (its jobs then solve on born-sharded tensors), or, where the local
    devices can't satisfy it, logs nomad_tpu's warning and solves stay
    single-device on the server's own device."""
    from nomad_tpu_torch.server.server import Server, ServerConfig

    srv = Server(ServerConfig(device="cpu", num_schedulers=1,
                              min_heartbeat_ttl=3600.0,
                              solver_mesh={"node_shards": shards}))
    try:
        with caplog.at_level(logging.WARNING, logger="nomad_tpu_torch"):
            srv.start()
        mesh = pmesh.node_sharding_mesh()
        assert (mesh is not None) == want_mesh
        if not want_mesh:
            assert "but only 8 present" in caplog.text
        srv.node_batch_register([mock.node() for _ in range(32)])
        job = mock.job()
        job.task_groups[0].count = 150
        eid, _ = srv.job_register(job)
        assert srv.wait_for_eval(eid, 60.0).status == "complete"
        snap = srv.fsm.state.snapshot()
        assert len([a for a in snap.allocs_by_job(job.id)
                    if a.client_status != "failed"]) == 150
    finally:
        srv.shutdown()
        pmesh.clear_node_sharding()


def test_a_mesh_scenario_override_reaches_the_server_config():
    """``solver_mesh`` is a server override the scenario runner passes
    on to each member's ServerConfig, and a bad one fails config parsing,
    naming its key."""
    import dataclasses

    from nomad_tpu_torch.server.server import ServerConfig
    from nomad_tpu_torch.simcluster import scenario as psc

    spec = dataclasses.replace(
        psc.SCENARIOS["steady-1k"], name="mesh",
        server_overrides={"solver_mesh": {"node_shards": 2}})
    cfg = ServerConfig(device="cpu", **spec.server_overrides)
    assert cfg.solver_mesh_config.node_shards == 2
    with pytest.raises(ValueError, match="axis"):
        ServerConfig(device="cpu", solver_mesh={"axis": 1})


def test_chip_smoke_mesh_kernels_phase_at_a_small_size(monkeypatch, capsys):
    """chip_smoke.py's phase 15 (a) on the CPU at 256 rows: every row at
    every S equal, the per-pass rows (two or four groups, a thread each;
    16 shards in one group) and a wide merge too (the CPU route of both wrappers is
    the plain version, so this runs its shapes, routes, seams and checks,
    not the kernels), with the device timers and the merge's window (a
    query of the built kernel) stubbed."""
    monkeypatch.setattr(chip_smoke, "MESH_WF_SHAPES", [
        (256, 2, False, False, "random"), (256, 2, True, True, "random"),
        (256, 2, False, False, "ties"), (256, 2, False, False, "saturated"),
        (256, 2, False, False, "count0"),
        (256, 2, False, False, "ineligible")])
    monkeypatch.setattr(chip_smoke, "MESH_GREEDY_SHAPES", [
        (256, 2, 16, "random"), (256, 2, 16, "ties"),
        (256, 1, 16, "infeasible")])
    monkeypatch.setattr(chip_smoke, "MESH_PASS_ROWS", [
        (256, 2, False, False, "random", 4, 2),
        (256, 1, False, False, "saturated", 4, 2),
        (256, 2, True, True, "random", 16, 1),
        (256, 2, False, False, "random", 8, 4)])
    monkeypatch.setattr(chip_smoke, "MESH_MERGE_WIDE", [(2048, 1, 16, 128)])
    monkeypatch.setattr(chip_smoke, "MERGE_SMEM_BYTES", 8 * 1024)
    monkeypatch.setattr(greedy, "merge_window", lambda s, k: 8)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: 0.0)
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda bind, reps: 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    res = chip_smoke.phase_mesh_kernels(torch.device("cpu"),
                                        np.random.default_rng(3))
    assert res == {"wf_err": 0, "pass_err": 0, "merge_err": 0}
    out = capsys.readouterr().out
    assert out.count("equal at S=[1, 2, 4, 8]") == 9
    assert out.count("mesh waterfill per-pass") == 4
    assert "mesh greedy merge warp path N=2048 B=1 k=16 S=128" in out
