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


# -- the CUDA kernel's design, modelled in numpy ------------------------------
#
# csrc/waterfill.cu replaces the plain version's two bisections with digit
# histograms and spreads an eval over a cluster of CL blocks, each holding
# a contiguous shard of the rows. The model below follows the kernel's
# integer arithmetic: per-shard partial histograms added up before each
# decision, the level's bits 8 at a time from the top, the radix select of
# the remaining-th largest key, and the tie fill in (rank, iteration, warp,
# lane) order counted in chunks of TIE_ITERS iterations. It must give the
# plain version's level, threshold, fill, counts and unplaced count.

BINS = 256
TIE_ITERS = 32  # kTieIters in csrc/waterfill.cu


def kernel_divide(n, d):
    """floor(n / d) as the kernel's Divisor computes it, for 0 <= n < 2^31."""
    l = (d - 1).bit_length()
    mul = -(-(1 << (31 + l)) // d)
    assert mul < 1 << 32
    return (n * mul) >> (31 + l)


def case_caps(c):
    """Per-node capacity, as the cap pass computes it (the kernel's
    divisions only where the dividend is non-negative; others are zeroed)."""
    total, used, ask, count = c["total"], c["used"], c["ask"], c["count"]
    avail = total.astype(np.int64) - used
    nonneg = np.all(avail >= 0, axis=1) & (c["bw_used"] <= c["bw_avail"])
    cap = np.full(len(total), 2**30, dtype=np.int64)
    for d in range(4):
        if ask[d] > 0:
            q = [kernel_divide(int(v), int(ask[d])) if v >= 0 else 0
                 for v in avail[:, d]]
            cap = np.minimum(cap, q)
    if c["bw_ask"] > 0:
        free = c["bw_avail"].astype(np.int64) - c["bw_used"]
        cap = np.minimum(cap, [kernel_divide(int(v), int(c["bw_ask"]))
                               if v >= 0 else 0 for v in free])
    if c["jd"]:
        cap = np.minimum(cap, (c["job_count"] == 0).astype(np.int64))
    if c["td"]:
        cap = np.minimum(cap, (c["tg_count"] == 0).astype(np.int64))
    return np.where(c["eligible"] & nonneg, np.clip(cap, 0, count), 0)


def case_keys(c, level, cap):
    """Selection keys of the partial round (0 off the candidates), from the
    plain version's own score and fit, and the fit mask."""
    t = port_tensors(c)
    base = torch.as_tensor(np.minimum(cap, level).astype(np.int32))
    bw_ask = torch.as_tensor(int(c["bw_ask"]), dtype=torch.int32)
    score, fit = waterfill._greedy_step_state(
        t[0], t[1], t[2] + base.unsqueeze(-1) * t[8].unsqueeze(0),
        t[3] + base, t[4] + base, t[5], t[6] + base * bw_ask, t[7], t[8],
        bw_ask, c["penalty"], c["jd"], c["td"])
    cand = cap > level
    keys = np.where(cand, waterfill._monotone_u32(score).numpy(), 0)
    return keys, fit.numpy()


def bisection_reference(c, cap):
    """The plain version's level, remaining, threshold and fill."""
    count = c["count"]
    lo, hi = 0, min(count, int(cap.max()))
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if np.minimum(cap, mid).sum() <= count:
            lo = mid
        else:
            hi = mid - 1
    remaining = count - int(np.minimum(cap, lo).sum())
    keys, _ = case_keys(c, lo, cap)
    tlo, thi = 0, 0xFFFFFFFE
    for _ in range(32):
        if tlo >= thi:
            break
        mid = tlo + (thi - tlo + 1) // 2
        if int(((keys != 0) & (keys >= mid)).sum()) >= remaining:
            tlo = mid
        else:
            thi = mid - 1
    return lo, remaining, tlo, remaining - int((keys > tlo).sum())


def shard_hist(shard, lo, s, weights=False):
    """One block's partial: values in [lo, lo + 256 << s) by digit."""
    inr = (shard >= lo) & (((shard - lo) >> s) < BINS)
    d = ((shard[inr] - lo) >> s).astype(np.int64)
    cnt = np.bincount(d, minlength=BINS)
    return (cnt, np.bincount(d, weights=shard[inr], minlength=BINS)
            .astype(np.int64)) if weights else cnt


def model_level(shards, count):
    """Largest L <= H with sum(min(cap, L)) <= count, 8 bits a pass; also
    f(L), the base sum."""
    h = min(count, max(int(s.max(initial=0)) for s in shards))
    prefix, below_sum, above, f_at = 0, 0, 0, 0
    for s in range(8 * ((h.bit_length() + 7) // 8 - 1), -1, -8):
        parts = [shard_hist(sh, prefix, s, weights=s > 0) for sh in shards]
        if s > 0:
            cnt = sum(p[0] for p in parts)
            sums = sum(p[1] for p in parts)
        else:  # the last pass: every cap in bin d is prefix + d
            cnt = sum(parts)
            sums = cnt * (prefix + np.arange(BINS))
        tot = int(cnt.sum())
        best = None
        c_below = s_below = 0
        for d in range(BINS):
            lv = prefix + (d << s)
            ge = above + tot - c_below
            f = below_sum + s_below + lv * ge
            if lv <= h and f <= count:
                best = (d, f, below_sum + s_below, ge - int(cnt[d]))
            c_below += int(cnt[d])
            s_below += int(sums[d])
        d, f_at, below_sum, above = best  # edge 0 always holds
        prefix += d << s
    return prefix, f_at


def model_threshold(key_shards, remaining):
    """Radix select of the remaining-th largest key. Returns (mode, t_eff,
    fill, boundary rows in each lower rank, n_selected)."""
    k_above, tprefix = 0, 0
    for s in (24, 16, 8, 0):
        parts = []
        for ks in key_shards:
            ks = ks[ks != 0]
            if s < 24:
                ks = ks[(ks >> (s + 8)) == (tprefix >> (s + 8))]
            parts.append(np.bincount((ks >> s) & 0xFF, minlength=BINS))
        cnt = sum(parts)
        tot = int(cnt.sum())
        if s == 24 and remaining >= tot:
            return "all", 0, 0, [0] * len(key_shards), tot
        gt = k_above
        for d in range(BINS - 1, -1, -1):
            if gt < remaining <= gt + int(cnt[d]):
                break
            gt += int(cnt[d])
        k_above, n_at = gt, int(cnt[d])
        tprefix |= d << s
    fill = remaining - k_above
    offs = np.cumsum([0] + [int(p[d]) for p in parts])[:-1].tolist()
    if fill < n_at:
        return "tie", tprefix, fill, offs, remaining
    return "cut", tprefix - 1, fill, offs, remaining


def model_counts(cap, keys, level, remaining, mode, t_eff, fill, off,
                 threads):
    """One block's counts: base + selected, the tie fill walked in chunks
    of TIE_ITERS iterations of (warp, lane) as the kernel walks it."""
    m = len(cap)
    iters = -(-m // threads)
    pad = iters * threads - m
    k = np.concatenate([keys, np.zeros(pad, np.int64)]).reshape(
        iters, threads // 32, 32)
    sel = (remaining > 0) & (k > t_eff)
    if mode == "tie":
        at = k == t_eff
        order = off
        for j0 in range(0, iters, TIE_ITERS):
            tie_cnt = at[j0:j0 + TIE_ITERS].sum(axis=2)  # [iters, warps]
            for j in range(j0, min(iters, j0 + TIE_ITERS)):
                lower = np.concatenate([[0], np.cumsum(tie_cnt[j - j0])[:-1]])
                rank = order + lower[:, None] + np.cumsum(at[j], axis=1) - 1
                sel[j] = np.where(at[j], rank < fill, sel[j])
                order += int(tie_cnt[j - j0].sum())
    return np.minimum(cap, level) + sel.reshape(-1)[:m]


def kernel_model(c, cl, threads=1024):
    """The kernel's outputs for one eval over a cluster of cl blocks."""
    cap = case_caps(c)
    n = len(cap)
    m = -(-n // cl)
    shards = [cap[r * m:(r + 1) * m] for r in range(cl)]
    level, base_sum = model_level(shards, c["count"])
    remaining = c["count"] - base_sum
    keys, fit = case_keys(c, level, cap)
    # The key pass reads no fit mask: cap > level implies it.
    assert fit[cap > level].all()
    mode, t_eff, fill, offs, n_sel = "none", 0, 0, [0] * cl, 0
    if remaining > 0:
        mode, t_eff, fill, offs, n_sel = model_threshold(
            [keys[r * m:(r + 1) * m] for r in range(cl)], remaining)
    counts = np.concatenate([
        model_counts(shards[r], keys[r * m:(r + 1) * m], level, remaining,
                     mode, t_eff, fill, offs[r], threads)
        for r in range(cl)])
    return dict(level=level, remaining=remaining, mode=mode, t_eff=t_eff,
                fill=fill, counts=counts, left=remaining - n_sel)


def assert_model_matches_plain(c, cl, threads=1024):
    got = kernel_model(c, cl, threads)
    cap = case_caps(c)
    level, remaining, thresh, fill = bisection_reference(c, cap)
    assert got["level"] == level
    assert got["remaining"] == remaining
    if got["mode"] in ("tie", "cut"):  # 1 <= remaining < candidates
        t = got["t_eff"] + (got["mode"] == "cut")
        assert (t, got["fill"]) == (thresh, fill)
    counts, left = port_waterfill(c)
    np.testing.assert_array_equal(got["counts"], counts)
    assert got["left"] == left
    return got["mode"]


def test_kernel_divisor_is_floor_division():
    rng = np.random.default_rng(5)
    ds = [1, 2, 3, 7, 100, 128, 2**30, 2**31 - 1,
          *rng.integers(1, 2**31, 200).tolist()]
    for d in ds:
        ns = [0, 1, d - 1, d, 2**31 - 1, (2**31 - 1) // d * d - 1,
              *rng.integers(0, 2**31, 50).tolist()]
        for n in ns:
            if 0 <= n < 2**31:
                assert kernel_divide(int(n), int(d)) == n // d, (n, d)


@pytest.mark.parametrize("cl", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", range(10))
def test_kernel_model_fuzz(seed, cl):
    """The fuzz corpus, split into cl contiguous shards."""
    rng = np.random.default_rng(10_000 + seed)
    assert_model_matches_plain(to_numpy_case(_random_solve_inputs(rng)), cl)


def partial_round_case(seed):
    """A test_pallas_solve instance asked for less than its caps hold, so
    the radix select runs; odd seeds draw nodes from two shapes and three
    usage levels, so keys repeat and the boundary is a tie."""
    rng = np.random.default_rng(500 + seed)
    n = (64, 256, 1000)[seed % 3]
    c = case_from_jax_args(random_instance(rng, n), seed % 7 == 5,
                           seed % 7 == 6)
    if seed % 2:
        shapes = np.array([[4000, 8192, 100_000, 150],
                           [2000, 4096, 50_000, 100]], np.int32)
        c["total"] = shapes[rng.integers(0, 2, n)]
        c["sched_cap"] = c["total"][:, :2].astype(np.float32)
        c["used"] = (c["total"] * rng.choice([0.0, 0.25, 0.5], (n, 1))
                     ).astype(np.int32)
        c["job_count"] = rng.integers(0, 2, n).astype(np.int32)
        c["ask"] = np.array([100, 128, 0, 0], np.int32)
        c["bw_ask"] = np.int32(0)
    c["count"] = int(rng.integers(1, max(2, int(case_caps(c).sum()))))
    return c


@pytest.mark.parametrize("cl", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", range(10))
def test_kernel_model_partial_round(seed, cl):
    """1 <= remaining < #candidates: the radix select and the tie fill."""
    mode = assert_model_matches_plain(partial_round_case(seed), cl,
                                      threads=64)
    assert mode in ("cut", "tie", "none")


def headline_case(n, live, count, used_frac=0.0):
    """Identical headline nodes (4000 MHz, 8192 MB) in the first `live` of
    n rows, asked for 100 MHz / 128 MB copies."""
    total = np.zeros((n, 4), np.int32)
    total[:live] = [4000, 8192, 100 * 1024, 150]
    used = (total * used_frac).astype(np.int32)
    zeros = np.zeros(n, np.int32)
    return dict(total=total, sched_cap=total[:, :2].astype(np.float32),
                used=used, job_count=zeros, tg_count=zeros, bw_avail=zeros,
                bw_used=zeros, eligible=np.arange(n) < live,
                ask=np.array([100, 128, 0, 0], np.int32), bw_ask=np.int32(0),
                count=count, penalty=10.0, jd=False, td=False)


@pytest.mark.parametrize("cl", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", [
    (512, 300, 750),    # 2.5 copies a node: the boundary cut mid-shard
    (512, 512, 1280),   # every row live, the cut at a shard's edge
    (512, 512, 1283),   # just past it
    (512, 300, 600),    # remaining 0 after the level
    (512, 512, 40 * 512 - 5),  # level 39, boundary nearly whole
])
def test_kernel_model_ties(spec, cl):
    """Identical nodes tie exactly: the fill takes the lowest rows across
    shards, iterations and warps (threads=64: 2 warps, 8 iterations)."""
    n, live, count = spec
    c = headline_case(n, live, count)
    mode = assert_model_matches_plain(c, cl, threads=64)
    assert mode in ("tie", "none")


def test_kernel_model_tie_chunks():
    """More iterations than a tie-fill chunk counts at once (threads=32,
    2048 rows: 64 iterations, two chunks)."""
    c = headline_case(2048, 2048, 2 * 2048 + 1500)
    assert assert_model_matches_plain(c, 2, threads=32) == "tie"


@pytest.mark.parametrize("kind", ["saturated", "count0", "ineligible",
                                  "all_candidates", "big_caps"])
def test_kernel_model_edges(kind):
    rng = np.random.default_rng(21)
    c = to_numpy_case(_random_solve_inputs(rng))
    n = len(c["total"])
    if kind == "saturated":  # count > sum of caps: no candidate
        c["count"] = 10_000_000
    elif kind == "count0":
        c["count"] = 0
    elif kind == "ineligible":
        c["eligible"] = np.zeros(n, bool)
    elif kind == "all_candidates":  # remaining >= #candidates
        c = headline_case(64, 64, 40 * 64 - 1)
        c["used"][::3] = [3990, 8000, 0, 0]  # some nodes fit no copy
    elif kind == "big_caps":  # caps above 2^16: 3 level passes
        c["total"][:, :2] = rng.integers(1 << 17, 1 << 24, (n, 2))
        c["sched_cap"] = c["total"][:, :2].astype(np.float32)
        c["used"] = np.zeros_like(c["total"])
        c["ask"] = np.array([1, 1, 0, 0], np.int32)
        c["bw_ask"] = np.int32(0)
        c["eligible"] = np.ones(n, bool)
        c["jd"] = c["td"] = False
        c["count"] = 1 << 26
    for cl in (1, 4):
        mode = assert_model_matches_plain(c, cl)
    want = {"saturated": "all", "count0": "none", "ineligible": "all",
            "all_candidates": "all"}
    if kind in want:
        assert mode == want[kind]
    if kind == "big_caps":
        assert int(case_caps(c).max()) > 1 << 16
