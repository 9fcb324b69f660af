"""The port's exact greedy scan (nomad_tpu_torch.ops.greedy) against
nomad_tpu's ``binpack.solve_greedy`` / ``solve_greedy_batched_shared``.

Inputs come from the fuzz corpus of tests/test_fuzz_differential.py
(numpy, seeded). The port runs its wrapper on CPU tensors, which takes the
plain PyTorch version. idx, ok and score are compared; idx and ok must be
equal, with the stated exception of tests/test_torch_waterfill.py: an
instance may diverge only at a step where the JAX reference's best and
second-best scores lie within 256 float32 ulp of each other (torch's and
XLA's float32 ``pow(10, x)`` differ by one ulp on ~1.8% of inputs). Even
then the number placed must be equal and every port placement must fit.
The rate of such instances is printed.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nomad_tpu.ops.binpack import _greedy_step_state as jax_step_state
from nomad_tpu.ops.binpack import bucket
from nomad_tpu.ops.binpack import solve_greedy as jax_solve_greedy
from nomad_tpu.ops.binpack import (
    solve_greedy_batched_shared as jax_greedy_shared,
)
from nomad_tpu_torch.ops import greedy

from test_fuzz_differential import _random_solve_inputs
from test_torch_waterfill import (
    ULP_TOLERANCE,
    f32_ulp_gap,
    jax_args,
    port_tensors,
    to_numpy_case,
)

torch.set_num_threads(2)

# Seed count tunable (a larger sample measures the pow contract's rate).
N_FUZZ_SEEDS = int(os.environ.get("NOMAD_TPU_TORCH_FUZZ_SEEDS", 24))


def greedy_case(seed):
    """A fuzz instance with the scan length capped like the three-way
    agreement test (k = bucket(min(count, 64)))."""
    rng = np.random.default_rng(10_000 + seed)
    c = to_numpy_case(_random_solve_inputs(rng))
    c["k_live"] = min(c["count"], 64)
    c["k"] = bucket(c["k_live"])
    return c


def jax_greedy(c):
    a = jax_args(c)
    active = jnp.arange(c["k"]) < c["k_live"]
    idx, ok, score = jax_solve_greedy(*a[:10], active, a[11], c["k"],
                                      c["jd"], c["td"])
    return np.asarray(idx), np.asarray(ok), np.asarray(score)


def port_greedy(c):
    """One eval through the port's batched wrapper (B = 1) on the CPU."""
    (total, sched_cap, used, jc, tc, bw_avail, bw_used, elig, ask,
     bw_ask) = port_tensors(c)
    active = (torch.arange(c["k"]) < c["k_live"]).unsqueeze(0)
    idx, ok, score = greedy.solve_greedy_batched_shared(
        total, sched_cap, used.unsqueeze(0), jc.unsqueeze(0),
        tc.unsqueeze(0), bw_avail, bw_used.unsqueeze(0), elig.unsqueeze(0),
        ask.unsqueeze(0), bw_ask.reshape(1), active,
        torch.tensor([c["penalty"]], dtype=torch.float32), c["k"],
        c["jd"], c["td"],
    )
    return idx[0].numpy(), ok[0].numpy(), score[0].numpy()


def jax_top2_gap(c, idx, ok, step):
    """ulp gap between the JAX reference's best and second-best scores at
    ``step``, replaying its own placements before it."""
    used = c["used"].copy()
    jc = c["job_count"].copy()
    tc = c["tg_count"].copy()
    bw = c["bw_used"].copy()
    for s in range(step):
        if ok[s]:
            i = int(idx[s])
            used[i] += c["ask"]
            jc[i] += 1
            tc[i] += 1
            bw[i] += c["bw_ask"]
    score, _fit = jax_step_state(
        jnp.asarray(c["total"]), jnp.asarray(c["sched_cap"]),
        jnp.asarray(used), jnp.asarray(jc), jnp.asarray(tc),
        jnp.asarray(c["bw_avail"]), jnp.asarray(bw),
        jnp.asarray(c["eligible"]), jnp.asarray(c["ask"]),
        jnp.int32(c["bw_ask"]), jnp.float32(c["penalty"]), c["jd"], c["td"],
    )
    top = np.sort(np.asarray(score))[::-1][:2]
    if len(top) < 2 or not np.isfinite(top[1]):
        return None
    return f32_ulp_gap(top[0], top[1])


def assert_sound(c, idx, ok):
    placed = np.bincount(idx[ok], minlength=len(c["eligible"]))
    avail = c["total"] - c["used"]
    for i in np.flatnonzero(placed):
        n = int(placed[i])
        assert c["eligible"][i], i
        assert np.all(c["ask"] * n <= avail[i]), i
        if c["bw_ask"] > 0:
            assert c["bw_used"][i] + n * c["bw_ask"] <= c["bw_avail"][i], i
        if c["jd"]:
            assert n <= 1 and c["job_count"][i] == 0, i
        if c["td"]:
            assert n <= 1 and c["tg_count"][i] == 0, i


def compare_with_jax(c):
    r_idx, r_ok, r_score = jax_greedy(c)
    idx, ok, score = port_greedy(c)
    same = (r_ok == ok) & ((r_idx == idx) | ~ok)
    if same.all():
        # Equal decisions; the scores themselves may differ by the pow
        # contract's few ulp.
        fin = np.isfinite(r_score) & ok
        assert all(f32_ulp_gap(a, b) <= ULP_TOLERANCE
                   for a, b in zip(r_score[fin], score[fin]))
        return "equal"
    step = int(np.argmin(same))
    gap = jax_top2_gap(c, r_idx, r_ok, step)
    assert gap is not None and gap <= ULP_TOLERANCE, (
        f"port != nomad_tpu at step {step}, top-2 gap {gap} ulp")
    assert int(ok.sum()) == int(r_ok.sum())
    assert_sound(c, idx, ok)
    return "boundary"


_FUZZ_OUTCOMES = {}


@pytest.mark.parametrize("seed", range(N_FUZZ_SEEDS))
def test_greedy_fuzz_matches_jax(seed):
    _FUZZ_OUTCOMES[seed] = compare_with_jax(greedy_case(seed))


def test_greedy_fuzz_disagreement_rate():
    for seed in range(N_FUZZ_SEEDS):
        if seed not in _FUZZ_OUTCOMES:
            _FUZZ_OUTCOMES[seed] = compare_with_jax(greedy_case(seed))
    n_boundary = sum(v == "boundary" for v in _FUZZ_OUTCOMES.values())
    rate = n_boundary / len(_FUZZ_OUTCOMES)
    print(f"greedy: {n_boundary} of {len(_FUZZ_OUTCOMES)} fuzz instances "
          f"disagree within the {ULP_TOLERANCE}-ulp boundary exception "
          f"(rate {rate:.3f})")
    assert rate <= 0.25


def _shared_batch(seed, b=3):
    """B evals over one shared node set (the coalescer's exact stacking)."""
    c0 = greedy_case(seed)
    rng = np.random.default_rng(500 + seed)
    cases = []
    for i in range(b):
        c = dict(c0)
        if i:
            frac = rng.random((len(c0["eligible"]), 1)) * 0.5
            c["used"] = (c0["total"] * frac).astype(np.int32)
            c["eligible"] = rng.random(len(c0["eligible"])) < 0.8
            c["k_live"] = int(rng.integers(1, c0["k"] + 1))
            c["penalty"] = float(rng.choice([5.0, 10.0]))
        cases.append(c)
    return cases


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_greedy_batched_shared_equals_lone(seed):
    """A B=3 stacked exact dispatch equals three lone scans, and equals
    nomad_tpu's solve_greedy_batched_shared on the same stack."""
    cases = _shared_batch(seed)
    k = cases[0]["k"]
    per = [port_tensors(c) for c in cases]
    stack = lambda j: torch.stack([p[j] for p in per])
    active = torch.stack([torch.arange(k) < c["k_live"] for c in cases])
    pens = torch.tensor([c["penalty"] for c in cases], dtype=torch.float32)
    jd, td = cases[0]["jd"], cases[0]["td"]
    b_idx, b_ok, _ = greedy.solve_greedy_batched_shared(
        per[0][0], per[0][1], stack(2), stack(3), stack(4), per[0][5],
        stack(6), stack(7), stack(8), stack(9), active, pens, k, jd, td)
    for i, c in enumerate(cases):
        idx, ok, _ = port_greedy(c)
        np.testing.assert_array_equal(b_ok[i].numpy(), ok)
        np.testing.assert_array_equal(b_idx[i].numpy()[ok], idx[ok])
    ja = [jax_args(c) for c in cases]
    jstack = lambda j: jnp.stack([a[j] for a in ja])
    r_idx, r_ok, _ = jax_greedy_shared(
        ja[0][0], ja[0][1], jstack(2), jstack(3), jstack(4), ja[0][5],
        jstack(6), jstack(7), jstack(8), jstack(9), jnp.asarray(active.numpy()),
        jnp.asarray(pens.numpy()), k, jd, td)
    for i, c in enumerate(cases):
        r = (np.asarray(r_idx[i]), np.asarray(r_ok[i]))
        if not (np.array_equal(r[1], b_ok[i].numpy())
                and np.array_equal(r[0][r[1]], b_idx[i].numpy()[r[1]])):
            assert compare_with_jax(c) == "boundary"


def test_greedy_wrapper_checks_inputs():
    c = greedy_case(0)
    (total, sched_cap, used, jc, tc, bw_avail, bw_used, elig, ask,
     bw_ask) = port_tensors(c)
    k = c["k"]
    args = [total, sched_cap, used.unsqueeze(0), jc.unsqueeze(0),
            tc.unsqueeze(0), bw_avail, bw_used.unsqueeze(0),
            elig.unsqueeze(0), ask.unsqueeze(0), bw_ask.reshape(1),
            torch.ones((1, k), dtype=torch.bool),
            torch.tensor([5.0], dtype=torch.float32), k, False, False]
    bad = list(args)
    bad[0] = total.unsqueeze(0)  # node tensors are shared, not stacked
    with pytest.raises(ValueError):
        greedy.solve_greedy_batched_shared(*bad)
    bad = list(args)
    bad[10] = torch.ones((1, k + 1), dtype=torch.bool)
    with pytest.raises(ValueError):
        greedy.solve_greedy_batched_shared(*bad)
    bad = list(args)
    bad[11] = torch.tensor([5.0], dtype=torch.float64)
    with pytest.raises(TypeError):
        greedy.solve_greedy_batched_shared(*bad)
    before = greedy.LAUNCHES
    greedy.solve_greedy_batched_shared(*args)
    assert greedy.LAUNCHES == before


# -- the property the CUDA kernel's incremental design rests on -------------
#
# csrc/greedy.cu scores every node once, then per step rescores only the
# node it placed on and recomputes that node's slot best. That is exact if
# (1) a step changes the score vector at most at the placed node, and (2)
# the slot bookkeeping (S = ceil(N / W) contiguous slots of
# W = ceil(N / 1024) nodes, argmax over the slot bests) picks what the
# plain argmax over all N picks. The tests below hold the port's plain
# version to both, on the fuzz corpus and on tie-heavy identical nodes.

KERNEL_SLOTS = 1024


def tie_case(n, k, penalty, jd=False, td=False):
    """The headline's node (4000 MHz, 8192 MB, 100 GiB, 150 iops, no
    network) n times, each a quarter used, and a 100 MHz / 128 MB ask:
    every untouched node ties, so the lowest index decides."""
    total = np.tile(np.array([4000, 8192, 100 * 1024, 150], np.int32), (n, 1))
    zeros = np.zeros(n, dtype=np.int32)
    return dict(
        total=total, sched_cap=total[:, :2].astype(np.float32),
        used=np.tile(np.array([1000, 2048, 0, 0], np.int32), (n, 1)),
        job_count=zeros, tg_count=zeros, bw_avail=zeros, bw_used=zeros,
        eligible=np.ones(n, dtype=bool),
        ask=np.array([100, 128, 0, 0], np.int32), bw_ask=np.int32(0),
        count=k, penalty=float(penalty), jd=jd, td=td, k=k, k_live=k,
    )


def sized_case(n, k, seed, jd=False, td=False):
    """A fuzz-corpus instance (tests/test_fuzz_differential.py's draws)
    at n nodes, scanning k steps with all of them live."""
    rng = np.random.default_rng(20_000 + seed)
    c = to_numpy_case(_random_solve_inputs(rng))
    idx = rng.integers(0, len(c["eligible"]), n)  # resample the node axis
    for key in ("total", "used", "job_count", "tg_count", "bw_avail",
                "bw_used", "eligible"):
        c[key] = np.ascontiguousarray(c[key][idx])
    c["sched_cap"] = c["total"][:, :2].astype(np.float32)
    c.update(jd=jd, td=td, k=k, k_live=k, count=k)
    return c


def step_scores(c, placed):
    """The plain score vector after ``placed[i]`` copies on each node."""
    (total, sched_cap, used, jc, tc, bw_avail, bw_used, elig, ask,
     bw_ask) = port_tensors(c)
    p = torch.as_tensor(placed, dtype=torch.int32)
    score, _fit = greedy._greedy_step_state(
        total, sched_cap, used + p[:, None] * ask, jc + p, tc + p, bw_avail,
        bw_used + p * bw_ask, elig, ask, bw_ask, c["penalty"], c["jd"],
        c["td"])
    return score.numpy()


def bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def slot_model(c):
    """The kernel's bookkeeping in numpy: one full scoring pass, S slot
    bests, and per step one argmax over the slots, one rescore and one
    slot recompute. The rescore reads the placed node's row of a
    whole-vector evaluation: torch's CPU pow rounds a lone element
    differently from a vectorised run, where the card's powf is one call
    per element either way."""
    n, k = len(c["eligible"]), c["k"]
    w = -(-n // KERNEL_SLOTS)
    n_slots = -(-n // w)
    placed = np.zeros(n, dtype=np.int32)
    cache = step_scores(c, placed)

    def best(lo, hi):
        seg = cache[lo:hi]
        j = int(np.flatnonzero(seg == seg.max())[0])  # first maximal index
        return seg[j], lo + j

    slots = [best(s * w, min(s * w + w, n)) for s in range(n_slots)]
    out = []
    for step in range(k):
        s_best = max(s for s, _ in slots)
        i_best = next(i for s, i in slots if s == s_best)  # lowest slot
        ok = bool(s_best > -np.inf) and step < c["k_live"]
        out.append((i_best, ok, s_best))
        if ok:
            placed[i_best] += 1
            cache[i_best] = step_scores(c, placed)[i_best]
            slot = i_best // w
            slots[slot] = best(slot * w, min(slot * w + w, n))
    idx, ok, score = zip(*out)
    return (np.array(idx, np.int32), np.array(ok, bool),
            np.array(score, np.float32))


PROPERTY_CASES = (
    [("fuzz", seed) for seed in range(N_FUZZ_SEEDS)]
    + [("ties", pen, flags) for pen in (0.0, 10.0)
       for flags in ("", "jd", "td")])


def property_case(spec):
    if spec[0] == "fuzz":
        return greedy_case(spec[1])
    _, pen, flags = spec
    return tie_case(96, 64, pen, jd=flags == "jd", td=flags == "td")


@pytest.mark.parametrize("spec", PROPERTY_CASES, ids=str)
def test_greedy_scores_change_only_at_placed_node(spec):
    """Between consecutive steps of the plain version the score vector
    changes at most at idx[t], and only when ok[t]; each step's idx and
    score are that vector's first maximum."""
    c = property_case(spec)
    idx, ok, score = port_greedy(c)
    placed = np.zeros(len(c["eligible"]), dtype=np.int32)
    before = step_scores(c, placed)
    for t in range(c["k"]):
        j = int(np.argmax(before))
        assert (idx[t], bits(score[t])) == (j, bits(before[j])), t
        if ok[t]:
            placed[idx[t]] += 1
        after = step_scores(c, placed)
        changed = np.flatnonzero(bits(after) != bits(before))
        assert set(changed) <= ({int(idx[t])} if ok[t] else set()), t
        before = after


@pytest.mark.parametrize("flags", ["", "jd", "td"])
@pytest.mark.parametrize("kind", ["random", "ties0", "ties10"])
@pytest.mark.parametrize("k", [8, 128])
@pytest.mark.parametrize("n", [8, 64, 1024, 4096])
def test_greedy_slot_model_equals_plain(n, k, kind, flags):
    """The kernel's slot bookkeeping gives idx, ok and score bit-equal to
    the plain version, with fewer nodes than slots (N = 8, 64), one node
    a slot (1024) and four (4096). On tied nodes a penalty of 0 keeps
    choosing one node until it is full; 10 moves to the next each step."""
    jd, td = flags == "jd", flags == "td"
    if kind == "random":
        c = sized_case(n, k, n + k, jd, td)
    else:
        c = tie_case(n, k, float(kind[4:]), jd, td)
    m_idx, m_ok, m_score = slot_model(c)
    idx, ok, score = port_greedy(c)
    np.testing.assert_array_equal(m_ok, ok)
    np.testing.assert_array_equal(m_idx, idx)
    np.testing.assert_array_equal(bits(m_score), bits(score))


@pytest.mark.parametrize("flags", ["", "jd", "td"])
@pytest.mark.parametrize("penalty", [0.0, 10.0])
def test_greedy_ties_match_jax(penalty, flags):
    """On identical nodes nomad_tpu's solve_greedy and the port make the
    same decisions (the lowest index breaks every tie), and their scores
    agree within the pow contract's 256 ulp."""
    c = tie_case(64, 32, penalty, jd=flags == "jd", td=flags == "td")
    assert compare_with_jax(c) == "equal"


def _shaped_nodes(n, seed):
    """One eval's numpy inputs over n nodes of three fixed shapes (the
    last eighth padding), usage in whole asks and job counts 0 or 1: two
    nodes' scores tie exactly or differ by far more than 256 ulp."""
    rng = np.random.default_rng(seed)
    ask = np.array([100, 128, 0, 0], dtype=np.int32)
    live = n - n // 8
    total = np.zeros((n, 4), dtype=np.int32)
    total[:live, :2] = np.array([(2000, 4096), (4000, 8192),
                                 (8000, 16384)])[rng.integers(0, 3, live)]
    total[:live, 2:] = (100 * 1024, 150)
    used = np.zeros((n, 4), dtype=np.int32)
    used[:live] = ask * rng.integers(0, 4, (live, 1))
    zeros = np.zeros(n, dtype=np.int32)
    return (total, total[:, :2].astype(np.float32), used,
            rng.integers(0, 2, n).astype(np.int32), zeros, zeros, zeros,
            np.arange(n) < live, ask, np.int32(0))


@pytest.mark.parametrize("count", [128, 100])
def test_merge_plain_past_the_staging_window_matches_nomad_tpu(count):
    """The sharded scan's plain version at S x k past the merge kernel's
    staging window: 256 shards of 64 rows and k = 128 (S k = 32,768,
    above the ~29,000 entries a block's shared memory holds, where the
    kernel stages a window of each shard's sequence). Each shard's plain
    scan, then the plain merge, against nomad_tpu's unsharded solve_greedy
    on the same numpy inputs, with padding steps after ``count``: idx and
    ok equal, tolerance 0 (the shaped scores make the pow contract's band
    empty)."""
    s, n_s, k = 256, 64, 128
    n = s * n_s
    case = _shaped_nodes(n, 77)
    want_idx, want_ok, _ = jax_solve_greedy(
        *(jnp.asarray(a) for a in case), jnp.arange(k) < count,
        jnp.float32(10.0), k, False, False)
    total, sched, used, jc, tc, bwa, bwu, elig, ask, bw_ask = (
        torch.tensor(np.asarray(a)) for a in case)
    small = (ask[None], bw_ask.reshape(1),
             torch.tensor([10.0], dtype=torch.float32))
    shards = []
    for i in range(s):
        r = slice(i * n_s, (i + 1) * n_s)
        shards.append(((total[r], sched[r], bwa[r]),
                       tuple(x[None, r] for x in (used, jc, tc, bwu, elig)),
                       small))
    active = (torch.arange(k) < count)[None]
    idx, ok, _score = greedy.solve_greedy_sharded(shards, active, k, False,
                                                  False)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(want_ok))
    assert int(ok.sum()) == count
