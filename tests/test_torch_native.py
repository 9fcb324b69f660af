"""The port's native control-plane library (nomad_tpu_torch.native) against
its plain numpy versions and nomad_tpu's, on the CPU.

- Every case of ``tests/test_native.py`` against the port: the built
  library against numpy, the bulk verifier against the scalar one on
  random plans, a large plan through ``evaluate_plan`` with the bulk path
  and without, and a columnar plan against a node table whose nodes all
  deregistered.
- ``scatter_add``, ``fit_check`` and ``bincount``, built and plain, equal
  nomad_tpu's on seeded arrays, exactly.
- ``evaluate_plan`` on a large plan calls the library (its call count)
  and decides as nomad_tpu's does on the same snapshot and plan.
- The loader builds at first use, keyed by the source, and raises where
  the compiler is missing or fails (in subprocesses with a fresh build
  directory) rather than degrading to numpy; processes that build at
  once into one directory all load one library.

Tolerance: exact (integer outputs)."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

from nomad_tpu import native as jax_native
from nomad_tpu.server import plan_apply as jax_plan_apply
from nomad_tpu_torch import mock, native, structs
from nomad_tpu_torch.server import plan_apply
from nomad_tpu_torch.server.plan_apply import (
    _prevaluate_nodes_bulk,
    evaluate_node_plan,
    evaluate_plan,
)
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import (
    Allocation,
    AllocBatch,
    NetworkResource,
    Plan,
    Resources,
    generate_uuid,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- tests/test_native.py, against the port ------------------------------------------


def test_native_kernels_match_numpy_fallback():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 50, size=1000).astype(np.int32)
    vals = rng.integers(0, 100, size=(1000, 4)).astype(np.int32)

    got = native.scatter_add(idx, vals, 50)
    want = np.zeros((50, 4), dtype=np.int64)
    np.add.at(want, idx, vals)
    np.testing.assert_array_equal(got, want.astype(np.int32))

    used = rng.integers(0, 100, size=(200, 4)).astype(np.int32)
    total = rng.integers(0, 100, size=(200, 4)).astype(np.int32)
    fit, exhausted = native.fit_check(used, total)
    over = used > total
    np.testing.assert_array_equal(fit, ~over.any(axis=1))
    for i in range(200):
        if fit[i]:
            assert exhausted[i] == -1
        else:
            assert exhausted[i] == over[i].argmax()

    np.testing.assert_array_equal(
        native.bincount(idx, 50), np.bincount(idx, minlength=50)[:50])


def _mk_alloc(node_id, cpu, mem, networks=None):
    res = Resources(cpu=cpu, memory_mb=mem)
    if networks:
        res.networks = networks
    return Allocation(
        id=generate_uuid(), node_id=node_id, job_id="j", task_group="tg",
        resources=res, desired_status=structs.ALLOC_DESIRED_STATUS_RUN)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_bulk_verifier_matches_scalar(seed):
    """Random plans over a mixed cluster: every node the bulk verifier
    answers for agrees with evaluate_node_plan."""
    rng = random.Random(seed)
    state = StateStore()
    nodes = []
    for i in range(20):
        node = mock.node()
        node.id = f"n-{i:02d}"
        if rng.random() < 0.15:
            node.status = structs.NODE_STATUS_DOWN
        if rng.random() < 0.1:
            node.drain = True
        nodes.append(node)
        state.upsert_node(i + 1, node)
    idx = 100
    for node in nodes:
        for _ in range(rng.randrange(0, 3)):
            nets = None
            if rng.random() < 0.2:
                nets = [NetworkResource(device="eth0", ip="10.0.0.1",
                                        mbits=10)]
            state.upsert_allocs(
                idx, [_mk_alloc(node.id, rng.choice([200, 800]), 256, nets)])
            idx += 1
    plan = Plan(eval_id=generate_uuid())
    shared = Resources(cpu=300, memory_mb=512)
    for node in nodes:
        for _ in range(rng.randrange(0, 12)):
            plan.append_alloc(Allocation(
                id=generate_uuid(), node_id=node.id, job_id="j2",
                task_group="tg2", resources=shared,
                desired_status=structs.ALLOC_DESIRED_STATUS_RUN))
    snap = state.snapshot()
    bulk = _prevaluate_nodes_bulk(snap, plan)
    assert bulk, "bulk verifier answered for no nodes"
    for node_id, fit in bulk.items():
        assert fit == evaluate_node_plan(snap, plan, node_id), node_id


def large_plan_state():
    state = StateStore()
    for i in range(10):
        node = mock.node()
        node.id = f"m-{i}"
        state.upsert_node(i + 1, node)
    plan = Plan(eval_id=generate_uuid())
    shared = Resources(cpu=100, memory_mb=128)
    for i in range(500):
        plan.append_alloc(Allocation(
            id=generate_uuid(), node_id=f"m-{i % 10}", job_id="big",
            task_group="tg", resources=shared,
            desired_status=structs.ALLOC_DESIRED_STATUS_RUN))
    return state, plan


def test_evaluate_plan_large_uses_bulk_and_matches(monkeypatch):
    """A 500-placement plan through evaluate_plan: the result equals the
    scalar-only path's (threshold forced high)."""
    state, plan = large_plan_state()
    fast = evaluate_plan(state.snapshot(), plan)
    monkeypatch.setattr(plan_apply, "FAST_VERIFY_THRESHOLD", 10**9)
    slow = evaluate_plan(state.snapshot(), plan)
    assert set(fast.node_allocation) == set(slow.node_allocation)
    for nid in fast.node_allocation:
        assert (len(fast.node_allocation[nid])
                == len(slow.node_allocation[nid]))
    assert fast.refresh_index == slow.refresh_index


def test_bulk_verify_columnar_against_empty_node_table():
    """A large columnar plan against a snapshot whose nodes all
    deregistered answers fit=False for every node (a refresh), without
    indexing the empty table."""
    state = StateStore()
    nodes = []
    for i in range(4):
        node = mock.node()
        node.id = f"gone-{i}"
        state.upsert_node(i + 1, node)
        nodes.append(node)
    job = mock.job()
    state.upsert_job(10, job)
    plan = Plan(eval_id=generate_uuid())
    plan.append_batch(AllocBatch(
        eval_id=plan.eval_id, job=job, tg_name="web",
        resources=Resources(cpu=10, memory_mb=16), task_resources={},
        node_ids=[n.id for n in nodes], node_counts=[32, 32, 32, 32],
        name_idx=np.arange(128), ids_hex="ab" * (16 * 128)))
    for i, n in enumerate(nodes):
        state.delete_node(20 + i, n.id)
    result = evaluate_plan(state.snapshot(), plan)
    assert not result.alloc_batches
    assert result.refresh_index > 0


# -- each function, against nomad_tpu's ------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_functions_equal_nomad_tpus(seed):
    rng = np.random.default_rng(seed)
    n, d, n_out = int(rng.integers(1, 3000)), 4, int(rng.integers(1, 400))
    idx = rng.integers(0, n_out, n).astype(np.int32)
    idx[rng.random(n) < 0.05] = n_out + 3  # out of range: dropped
    vals = rng.integers(0, 10_000, (n, d)).astype(np.int32)
    want = jax_native.scatter_add(idx, vals, n_out)
    for fn in (native.scatter_add, native.scatter_add_plain):
        got = fn(idx, vals, n_out)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    want = jax_native.bincount(idx, n_out)
    for fn in (native.bincount, native.bincount_plain):
        np.testing.assert_array_equal(fn(idx, n_out), want)
    used = rng.integers(-5, 2**31 - 1, (n, d), dtype=np.int64)
    total = rng.integers(0, 2**31 - 1, (n, d), dtype=np.int64)
    used[::3] = total[::3] - rng.integers(0, 2, (len(used[::3]), d))
    want = jax_native.fit_check(used, total)
    for fn in (native.fit_check, native.fit_check_plain):
        fit, exhausted = fn(used, total)
        assert fit.dtype == bool and exhausted.dtype == np.int32
        np.testing.assert_array_equal(fit, want[0])
        np.testing.assert_array_equal(exhausted, want[1])


def test_empty_inputs_equal_nomad_tpus():
    empty = np.zeros((0, 4), dtype=np.int32)
    idx = np.zeros(0, dtype=np.int32)
    np.testing.assert_array_equal(native.scatter_add(idx, empty, 3),
                                  jax_native.scatter_add(idx, empty, 3))
    np.testing.assert_array_equal(native.bincount(idx, 3),
                                  jax_native.bincount(idx, 3))
    for got, want in zip(native.fit_check(empty, empty),
                         jax_native.fit_check(empty, empty)):
        assert got.shape == want.shape == (0,)


def test_large_plan_takes_the_native_path_and_decides_as_nomad_tpu():
    """The same 10,000-placement columnar plan on the same 64 nodes (one
    of them too small) through both packages' evaluate_plan: the port
    calls the library and commits exactly what nomad_tpu commits."""
    from nomad_tpu import structs as jst
    from test_torch_server import (
        Twin, _carry_plan, _decisions, _reset_node_tables,
    )

    rng = np.random.default_rng(11)
    _reset_node_tables()
    twin = Twin()
    twin.nodes([jst.Node(
        id=f"big-{i:03d}", datacenter="dc1", name=f"big{i}", status="ready",
        resources=jst.Resources(cpu=4000 if i else 300, memory_mb=8192,
                                disk_mb=100_000, iops=150))
        for i in range(64)])
    ids = [f"big-{i:03d}" for i in range(64)]
    res = jst.Resources(cpu=25, memory_mb=32)
    counts = [int(c) for c in rng.multinomial(10_000, [1 / 64] * 64)]
    jplan = jst.Plan(eval_id="big-plan", priority=50)
    jplan.append_batch(jst.AllocBatch(
        eval_id="big-plan", job=None, tg_name="web", resources=res,
        task_resources={"t": res}, metrics=None, node_ids=ids,
        node_counts=counts, name_idx=np.arange(10_000),
        ids_seed=int(rng.integers(1, 2**62))))
    jplan, pplan = _carry_plan(jplan)
    calls = native.CALLS["fit_check"]
    want = jax_plan_apply.evaluate_plan(twin.jax.snapshot(), jplan)
    got = evaluate_plan(twin.port.snapshot(), pplan)
    assert native.CALLS["fit_check"] > calls
    assert _decisions(got) == _decisions(want)
    assert got.refresh_index > 0  # the small node refused its share


# -- the loader ------------------------------------------------------------------------


def run_loader(code: str, build_dir, **env):
    """Run ``code`` in a fresh interpreter whose native library builds
    into ``build_dir``; returns the completed process."""
    prelude = ("import sys, pathlib\n"
               f"sys.path.insert(0, {REPO!r})\n"
               "from nomad_tpu_torch import native\n"
               f"native.BUILD_DIR = pathlib.Path({str(build_dir)!r})\n")
    return subprocess.run([sys.executable, "-c", prelude + code],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **env))


@pytest.mark.parametrize("call", [
    lambda: native.fit_check(np.zeros((4, 4)), np.zeros((3, 4))),
    lambda: native.fit_check(np.zeros((4, 4)), np.zeros((4, 3))),
    lambda: native.scatter_add(np.zeros(3), np.zeros((4, 4)), 2),
], ids=["fit_rows", "fit_dims", "scatter_idx"])
def test_mismatched_shapes_are_refused_before_the_library(call):
    """The C loops index both buffers by the first one's shape: a shorter
    second buffer would be read past its end."""
    calls = dict(native.CALLS)
    with pytest.raises(ValueError, match="shape"):
        call()
    assert native.CALLS == calls


def test_library_is_keyed_by_its_source_and_flags():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libnomad_native-") and path.suffix == ".so"
    assert native.available() and path.exists()


def test_missing_compiler_raises_instead_of_degrading(tmp_path):
    out = run_loader(
        "assert not native.available()\n"
        "import numpy as np\n"
        "try:\n"
        "    native.fit_check(np.ones((2, 4)), np.ones((2, 4)))\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n",
        tmp_path / "build", PATH="")
    assert out.returncode == 0, out.stderr
    assert "raised: host C++ compiler 'c++' not found" in out.stdout
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_build_raises_with_the_compilers_output(tmp_path):
    fake = tmp_path / "badcc"
    fake.write_text("#!/bin/sh\necho 'badcc: no such luck' >&2\nexit 3\n")
    fake.chmod(0o755)
    out = run_loader(
        "try:\n"
        "    native.bincount(__import__('numpy').zeros(3, 'int32'), 2)\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n",
        tmp_path / "build", CXX=str(fake))
    assert out.returncode == 0, out.stderr
    assert "failed to build nomad_native.cpp (rc 3)" in out.stdout
    assert "badcc: no such luck" in out.stdout
    assert not list((tmp_path / "build").iterdir())


def test_concurrent_first_builds_load_one_library(tmp_path):
    code = ("import numpy as np\n"
            "print(native.bincount(np.array([0, 1, 1], 'int32'), 2)"
            ".tolist())\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys, pathlib\n"
         f"sys.path.insert(0, {REPO!r})\n"
         "from nomad_tpu_torch import native\n"
         f"native.BUILD_DIR = pathlib.Path({str(tmp_path)!r})\n" + code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.strip() == "[1, 2]"
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path().name]
