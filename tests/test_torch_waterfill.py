"""The port's water-fill (nomad_tpu_torch.ops.waterfill) against nomad_tpu.

Same inputs, made from a seed with numpy, go through nomad_tpu's
``binpack.solve_waterfill`` (and its Pallas kernel in interpret mode, as
tests/test_pallas_solve.py runs it) and through the port's wrapper on CPU
tensors, which takes the plain PyTorch version.

Tolerance: counts and remaining are integers and must be equal, with one
stated exception. torch's float32 ``pow(10, x)`` differs from XLA's by one
ulp on about 1.8% of inputs, so the BestFit scores of the two packages can
differ by a few ulp. A fuzz instance may then disagree only where the JAX
reference's k-th and (k+1)-th candidate scores of the partial round (the
selection boundary) lie within 256 float32 ulp of each other; even then
the total placed must be equal and every port placement must fit. The
rate of such instances is printed.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nomad_tpu.ops.binpack import _greedy_step_state as jax_step_state
from nomad_tpu.ops.binpack import solve_waterfill as jax_solve_waterfill
from nomad_tpu.ops.coalesce import solve_waterfill_batched as jax_batched
from nomad_tpu.ops.pallas_solve import (
    solve_waterfill_pallas,
    solve_waterfill_pallas_batched,
)
from nomad_tpu_torch.convert import solve_inputs_from_numpy
from nomad_tpu_torch.ops import waterfill

from test_fuzz_differential import _random_solve_inputs
from test_pallas_solve import random_instance

torch.set_num_threads(2)

ULP_TOLERANCE = 256
# Seed count tunable (a larger sample measures the pow contract's rate).
N_FUZZ_SEEDS = int(os.environ.get("NOMAD_TPU_TORCH_FUZZ_SEEDS", 40))


def f32_ulp_gap(a: float, b: float) -> int:
    """Distance between two float32 values in units in the last place."""
    def key(x):
        bits = int(np.asarray(x, dtype=np.float32).view(np.uint32))
        return (~bits & 0xFFFFFFFF) if bits >> 31 else bits | 0x80000000
    return abs(key(a) - key(b))


def to_numpy_case(s):
    """A _random_solve_inputs dict as the 12 solve arrays/scalars."""
    return dict(
        total=s["total"], sched_cap=s["total"][:, :2].astype(np.float32),
        used=s["used"], job_count=s["job_count"], tg_count=s["tg_count"],
        bw_avail=s["bw_avail"], bw_used=s["bw_used"], eligible=s["eligible"],
        ask=s["ask"], bw_ask=np.int32(s["bw_ask"]), count=int(s["count"]),
        penalty=float(s["penalty"]), jd=bool(s["jd"]), td=bool(s["td"]),
    )


def case_from_jax_args(args, jd=False, td=False):
    """A test_pallas_solve.random_instance tuple as a numpy case."""
    a = [np.asarray(x) for x in args]
    return dict(total=a[0], sched_cap=a[1], used=a[2], job_count=a[3],
                tg_count=a[4], bw_avail=a[5], bw_used=a[6], eligible=a[7],
                ask=a[8], bw_ask=np.int32(a[9]), count=int(a[10]),
                penalty=float(a[11]), jd=jd, td=td)


def jax_args(c):
    return (
        jnp.asarray(c["total"]), jnp.asarray(c["sched_cap"]),
        jnp.asarray(c["used"]), jnp.asarray(c["job_count"]),
        jnp.asarray(c["tg_count"]), jnp.asarray(c["bw_avail"]),
        jnp.asarray(c["bw_used"]), jnp.asarray(c["eligible"]),
        jnp.asarray(c["ask"]), jnp.int32(c["bw_ask"]),
        jnp.int32(c["count"]), jnp.float32(c["penalty"]),
    )


def port_tensors(c):
    """The case's node and per-eval arrays as CPU tensors for the port."""
    t = solve_inputs_from_numpy(dict(
        total=c["total"], sched_cap=c["sched_cap"], used=c["used"],
        job_count=c["job_count"], tg_count=c["tg_count"],
        bw_avail=c["bw_avail"], bw_used=c["bw_used"], mask=c["eligible"],
        ask=c["ask"], bw_ask=c["bw_ask"],
    ), device="cpu")
    return (t["total"], t["sched_cap"], t["used"], t["job_count"],
            t["tg_count"], t["bw_avail"], t["bw_used"], t["mask"], t["ask"],
            t["bw_ask"])


def port_waterfill(c):
    """One eval through the port's batched wrapper (B = 1) on the CPU."""
    rows = [x.unsqueeze(0) for x in port_tensors(c)]
    counts, remaining = waterfill.solve_waterfill_batched(
        *rows, torch.tensor([c["count"]], dtype=torch.int32),
        torch.tensor([c["penalty"]], dtype=torch.float32), c["jd"], c["td"],
    )
    return counts[0].numpy(), int(remaining[0])


def jax_boundary_gap(c):
    """ulp gap between the JAX reference's k-th and (k+1)-th candidate
    scores in the partial round (k = remaining after the full rounds), or
    None when the round selects all of its candidates or none."""
    total, used, ask = c["total"], c["used"], c["ask"]
    count = c["count"]
    avail = total - used
    nonneg = np.all(avail >= 0, axis=1) & (c["bw_used"] <= c["bw_avail"])
    dim_cap = np.where(ask > 0, avail // np.maximum(ask, 1), 2**30)
    cap = dim_cap.min(axis=1)
    if c["bw_ask"] > 0:
        cap = np.minimum(cap, (c["bw_avail"] - c["bw_used"]) // c["bw_ask"])
    if c["jd"]:
        cap = np.minimum(cap, (c["job_count"] == 0).astype(cap.dtype))
    if c["td"]:
        cap = np.minimum(cap, (c["tg_count"] == 0).astype(cap.dtype))
    cap = np.where(c["eligible"] & nonneg, np.clip(cap, 0, count), 0)
    lo, hi = 0, min(count, int(cap.max()))
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if np.minimum(cap, mid).sum() <= count:
            lo = mid
        else:
            hi = mid - 1
    base = np.minimum(cap, lo)
    remaining = count - int(base.sum())
    bw_ask = np.int32(c["bw_ask"])
    score, fit = jax_step_state(
        jnp.asarray(total), jnp.asarray(c["sched_cap"]),
        jnp.asarray((used + base[:, None] * ask[None, :]).astype(np.int32)),
        jnp.asarray((c["job_count"] + base).astype(np.int32)),
        jnp.asarray((c["tg_count"] + base).astype(np.int32)),
        jnp.asarray(c["bw_avail"]),
        jnp.asarray((c["bw_used"] + base * bw_ask).astype(np.int32)),
        jnp.asarray(c["eligible"]), jnp.asarray(ask), jnp.int32(bw_ask),
        jnp.float32(c["penalty"]), c["jd"], c["td"],
    )
    cand = np.asarray(fit) & (cap > lo)
    scores = np.sort(np.asarray(score)[cand])[::-1]
    if remaining <= 0 or remaining >= len(scores):
        return None
    return f32_ulp_gap(scores[remaining - 1], scores[remaining])


def assert_sound(c, counts):
    """Every port placement fits its node under the case's constraints."""
    avail = c["total"] - c["used"]
    for i in np.flatnonzero(counts):
        n = int(counts[i])
        assert c["eligible"][i], i
        assert np.all(c["ask"] * n <= avail[i]), i
        if c["bw_ask"] > 0:
            assert c["bw_used"][i] + n * c["bw_ask"] <= c["bw_avail"][i], i
        if c["jd"]:
            assert n <= 1 and c["job_count"][i] == 0, i
        if c["td"]:
            assert n <= 1 and c["tg_count"][i] == 0, i


def compare_with_jax(c):
    """'equal' when the port matches nomad_tpu exactly, 'boundary' for an
    allowed disagreement at a near-tied selection boundary."""
    ref_counts, ref_left = jax_solve_waterfill(*jax_args(c), c["jd"], c["td"])
    ref_counts = np.asarray(ref_counts)
    counts, left = port_waterfill(c)
    if np.array_equal(counts, ref_counts) and left == int(ref_left):
        return "equal"
    gap = jax_boundary_gap(c)
    assert gap is not None and gap <= ULP_TOLERANCE, (
        f"port != nomad_tpu with boundary gap {gap} ulp")
    assert int(counts.sum()) == int(ref_counts.sum())
    assert left == int(ref_left)
    assert_sound(c, counts)
    return "boundary"


_FUZZ_OUTCOMES = {}


@pytest.mark.parametrize("seed", range(N_FUZZ_SEEDS))
def test_waterfill_fuzz_matches_jax(seed):
    # The corpus of test_fuzz_differential's three-way agreement.
    rng = np.random.default_rng(10_000 + seed)
    _FUZZ_OUTCOMES[seed] = compare_with_jax(
        to_numpy_case(_random_solve_inputs(rng)))


def test_waterfill_fuzz_disagreement_rate():
    """Counts the fuzz instances that took the boundary exception."""
    for seed in range(N_FUZZ_SEEDS):
        if seed not in _FUZZ_OUTCOMES:
            rng = np.random.default_rng(10_000 + seed)
            _FUZZ_OUTCOMES[seed] = compare_with_jax(
                to_numpy_case(_random_solve_inputs(rng)))
    n_boundary = sum(v == "boundary" for v in _FUZZ_OUTCOMES.values())
    rate = n_boundary / len(_FUZZ_OUTCOMES)
    print(f"waterfill: {n_boundary} of {len(_FUZZ_OUTCOMES)} fuzz instances "
          f"disagree within the {ULP_TOLERANCE}-ulp boundary exception "
          f"(rate {rate:.3f})")
    assert rate <= 0.25


def _pallas_cases():
    rng = np.random.default_rng(7)
    cases = {f"random{i}": (random_instance(rng, 64), False, False)
             for i in range(4)}
    rng = np.random.default_rng(8)
    cases["job_distinct"] = (random_instance(rng, 64), True, False)
    cases["tg_distinct"] = (random_instance(rng, 64), False, True)
    rng = np.random.default_rng(9)
    base = list(random_instance(rng, 64))
    zero = list(base)
    zero[10] = jnp.int32(0)
    cases["count_zero"] = (tuple(zero), False, False)
    over = list(base)
    over[10] = jnp.int32(10_000_000)
    cases["demand_over_capacity"] = (tuple(over), False, False)
    none = list(base)
    none[7] = jnp.zeros_like(none[7])
    none[10] = jnp.int32(50)
    cases["none_eligible"] = (tuple(none), False, False)
    return cases


PALLAS_CASES = _pallas_cases()


@pytest.mark.parametrize("name", sorted(PALLAS_CASES))
def test_waterfill_matches_pallas_interpret(name):
    """The corpus of tests/test_pallas_solve.py, through the Pallas kernel
    in interpret mode and through the port."""
    args, jd, td = PALLAS_CASES[name]
    c = case_from_jax_args(args, jd, td)
    ref, ref_left = solve_waterfill_pallas(*args, jd, td, interpret=True)
    counts, left = port_waterfill(c)
    if not (np.array_equal(counts, np.asarray(ref))
            and left == int(ref_left)):
        # Same exception as the fuzz corpus, against the same reference.
        assert compare_with_jax(c) == "boundary"


def test_waterfill_stable_tie_lowest_index():
    """Identical nodes tie exactly: the partial round takes the lowest
    indices, as nomad_tpu's stable selection does."""
    n = 64
    total = np.full((n, 4), 1000, dtype=np.int32)
    c = dict(total=total, sched_cap=total[:, :2].astype(np.float32),
             used=np.zeros((n, 4), np.int32),
             job_count=np.zeros(n, np.int32), tg_count=np.zeros(n, np.int32),
             bw_avail=np.full(n, 100, np.int32), bw_used=np.zeros(n, np.int32),
             eligible=np.ones(n, bool),
             ask=np.array([10, 10, 0, 0], np.int32), bw_ask=np.int32(0),
             count=7, penalty=0.0, jd=False, td=False)
    ref, _ = solve_waterfill_pallas(*jax_args(c), False, False,
                                    interpret=True)
    counts, left = port_waterfill(c)
    np.testing.assert_array_equal(counts, np.asarray(ref))
    assert left == 0 and counts[:7].sum() == 7


def test_waterfill_batched_equals_lone_solves():
    """A B=3 stacked batch equals three lone solves, and nomad_tpu's
    batched forms (vmapped jnp and Pallas interpret) on the same stack."""
    rng = np.random.default_rng(11)
    cases = [case_from_jax_args(random_instance(rng, 64)) for _ in range(3)]
    stacked = [torch.stack(col) for col in
               zip(*(port_tensors(c) for c in cases))]
    counts = torch.tensor([c["count"] for c in cases], dtype=torch.int32)
    pens = torch.tensor([c["penalty"] for c in cases], dtype=torch.float32)
    b_counts, b_left = waterfill.solve_waterfill_batched(
        *stacked, counts, pens, False, False)
    for i, c in enumerate(cases):
        lone, lone_left = port_waterfill(c)
        np.testing.assert_array_equal(b_counts[i].numpy(), lone)
        assert int(b_left[i]) == lone_left
    jstack = [jnp.stack(col) for col in
              zip(*(jax_args(c)[:10] for c in cases))]
    jc = jnp.asarray([c["count"] for c in cases], dtype=jnp.int32)
    jp = jnp.asarray([c["penalty"] for c in cases], dtype=jnp.float32)
    for ref, ref_left in (
        jax_batched(*jstack, jc, jp, False, False),
        solve_waterfill_pallas_batched(*jstack, jc, jp, False, False,
                                       interpret=True),
    ):
        np.testing.assert_array_equal(b_counts.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(b_left.numpy(), np.asarray(ref_left))


def test_waterfill_wrapper_checks_inputs():
    rng = np.random.default_rng(3)
    c = case_from_jax_args(random_instance(rng, 16))
    rows = [x.unsqueeze(0) for x in port_tensors(c)]
    count = torch.tensor([c["count"]], dtype=torch.int32)
    pen = torch.tensor([c["penalty"]], dtype=torch.float32)
    bad_dtype = list(rows)
    bad_dtype[0] = bad_dtype[0].to(torch.int64)
    with pytest.raises(TypeError):
        waterfill.solve_waterfill_batched(*bad_dtype, count, pen, False, False)
    bad_shape = list(rows)
    bad_shape[3] = bad_shape[3][:, :8]
    with pytest.raises(ValueError):
        waterfill.solve_waterfill_batched(*bad_shape, count, pen, False, False)
    strided = list(rows)
    strided[2] = torch.zeros((1, 4, 16), dtype=torch.int32).transpose(1, 2)
    with pytest.raises(ValueError):
        waterfill.solve_waterfill_batched(*strided, count, pen, False, False)
    # The CPU path never counts a kernel launch.
    before = waterfill.LAUNCHES
    waterfill.solve_waterfill_batched(*rows, count, pen, False, False)
    assert waterfill.LAUNCHES == before
