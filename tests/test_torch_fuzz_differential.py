"""The kernel half of ``tests/test_fuzz_differential.py`` against the port,
on the CPU: the fuzz oracle ``solve_rounds_fused`` (direct round
simulation, plain torch) against the water-fill (its wrapper, which takes
the plain version for CPU tensors) and the exact greedy scan.

- The three-way agreement of ``test_kernel_threeway_agreement``, over the
  same seeds and the same ``_random_solve_inputs``: water-fill and
  rounds equal per node, the greedy places the same total over its
  prefix, and every count is sound (eligible, within capacity, distinct
  hosts).
- Each of the three equals nomad_tpu's JAX function on identical inputs
  (JAX on the CPU, as its own tests run it). Counts and indices are
  integers, so equality is exact; an instance whose partial round cuts
  between two candidate scores within the pow contract's band would be
  allowed to differ, and the test asserts there is none at these seeds.
- ``tests/test_tpu_solver.py``'s four bench-shape cases
  (``test_waterfill_matches_round_solver``) against the port and
  nomad_tpu.
- chip_smoke's copy of ``_random_solve_inputs`` (its phase 16 runs the
  oracle on the card without jax) draws what the original draws.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nomad_tpu.ops import binpack as jbp
from nomad_tpu_torch.ops.binpack import bucket, solve_rounds_fused
from nomad_tpu_torch.ops.greedy import solve_greedy

from test_fuzz_differential import N_KERNEL_SEEDS, _random_solve_inputs

torch.set_num_threads(2)

CPU = torch.device("cpu")
GREEDY_CAP = 64  # test_fuzz_differential's capped k


def case(seed):
    s = _random_solve_inputs(np.random.default_rng(10_000 + seed))
    return s, cs.fuzz_tensors(s, CPU)


def jax_args(s):
    return (
        jnp.asarray(s["total"]),
        jnp.asarray(s["total"][:, :2].astype(np.float32)),
        jnp.asarray(s["used"]), jnp.asarray(s["job_count"]),
        jnp.asarray(s["tg_count"]), jnp.asarray(s["bw_avail"]),
        jnp.asarray(s["bw_used"]), jnp.asarray(s["eligible"]),
        jnp.asarray(s["ask"]), jnp.int32(s["bw_ask"]),
    )


def greedy_prefix(s, t):
    k_cap = min(s["count"], GREEDY_CAP)
    k = bucket(k_cap)
    return k_cap, k, torch.arange(k) < k_cap


@pytest.mark.parametrize("seed", range(N_KERNEL_SEEDS))
def test_kernel_threeway_agreement(seed):
    """water-fill == rounds exactly; the greedy places the same total
    over its prefix; every count sound."""
    s, t = case(seed)
    wf, wf_left = cs.kernel_counts(t, s["count"], s["penalty"], s["jd"],
                                   s["td"])
    rf, rf_left = solve_rounds_fused(*t, s["count"], s["penalty"], s["jd"],
                                     s["td"])
    np.testing.assert_array_equal(wf, rf.numpy(), err_msg=f"seed {seed}")
    assert wf_left == rf_left, seed
    assert rf.dtype == torch.int32 and isinstance(rf_left, int)
    k_cap, k, active = greedy_prefix(s, t)
    _idx, ok, _score = solve_greedy(*t, active, s["penalty"], k, s["jd"],
                                    s["td"])
    assert int(ok.sum()) == min(k_cap, int(wf.sum())), seed
    cs.check_sound(s, wf)


@pytest.mark.parametrize("seed", range(N_KERNEL_SEEDS))
def test_each_kernel_equals_nomad_tpus(seed):
    s, t = case(seed)
    args = jax_args(s)
    count, penalty = jnp.int32(s["count"]), jnp.float32(s["penalty"])
    band = 0
    for jax_fn, port_counts in (
            (jbp.solve_waterfill, cs.kernel_counts(
                t, s["count"], s["penalty"], s["jd"], s["td"])),
            (jbp.solve_rounds_fused, solve_rounds_fused(
                *t, s["count"], s["penalty"], s["jd"], s["td"]))):
        want, want_left = jax_fn(*args, count, penalty, s["jd"], s["td"])
        got, got_left = port_counts
        got = np.asarray(got)
        if not (np.array_equal(got, np.asarray(want))
                and got_left == int(want_left)):
            gap = cs.boundary_gap(s, t)
            assert gap is not None and gap <= cs.ULP_BAND, (seed, gap)
            band += 1
    k_cap, k, active = greedy_prefix(s, t)
    jidx, jok, _ = jbp.solve_greedy(*args, jnp.asarray(active.numpy()),
                                    penalty, k, s["jd"], s["td"])
    idx, ok, _ = solve_greedy(*t, active, s["penalty"], k, s["jd"], s["td"])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(idx.numpy()[ok.numpy()],
                                  np.asarray(jidx)[np.asarray(jok)])
    assert band == 0, f"seed {seed}: {band} pow-band instance(s)"


def test_chip_smoke_draws_the_fuzz_corpus():
    for seed in range(N_KERNEL_SEEDS):
        a = _random_solve_inputs(np.random.default_rng(10_000 + seed))
        b = cs.fuzz_solve_inputs(np.random.default_rng(10_000 + seed))
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]))


# -- tests/test_tpu_solver.py's bench-shape cases -----------------------------------


def bench_case(seed):
    """test_waterfill_matches_round_solver's instance, draw for draw."""
    rng = random.Random(seed)
    n = 64
    total = np.zeros((n, 4), dtype=np.int32)
    for i in range(n):
        total[i] = [rng.choice([500, 1000, 2000, 4000]),
                    rng.choice([512, 1024, 4096]), 50_000, 100]
    used0 = np.zeros((n, 4), dtype=np.int32)
    for i in range(n):
        if rng.random() < 0.3:
            used0[i, 0] = rng.randrange(0, total[i, 0])
            used0[i, 1] = rng.randrange(0, total[i, 1])
    job_count0 = np.array([rng.choice([0, 0, 0, 1, 2]) for _ in range(n)],
                          np.int32)
    eligible = np.array([rng.random() < 0.9 for _ in range(n)])
    count = rng.choice([5, 40, 300, 2000])
    return dict(total=total, used=used0, job_count=job_count0,
                tg_count=job_count0, bw_avail=np.full(n, 1000, np.int32),
                bw_used=np.zeros(n, np.int32), eligible=eligible,
                ask=np.array([100, 128, 0, 0], np.int32), bw_ask=0,
                count=count, penalty=5.0, jd=False, td=False)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_waterfill_matches_round_solver(seed):
    """The port's water-fill reproduces its rounds' per-node counts, and
    both nomad_tpu's, with and without job-level distinct hosts."""
    s = bench_case(seed)
    t = cs.fuzz_tensors(s, CPU)
    args = jax_args(s)
    for jd in (False, True):
        rf, rf_left = solve_rounds_fused(*t, s["count"], s["penalty"], jd,
                                         False)
        wf, wf_left = cs.kernel_counts(t, s["count"], s["penalty"], jd,
                                       False)
        jc, jleft = jbp.solve_rounds_fused(
            *args, jnp.int32(s["count"]), jnp.float32(s["penalty"]),
            job_distinct=jd, tg_distinct=False)
        np.testing.assert_array_equal(rf.numpy(), wf)
        np.testing.assert_array_equal(rf.numpy(), np.asarray(jc))
        assert rf_left == wf_left == int(jleft)
