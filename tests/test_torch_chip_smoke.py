"""chip_smoke.py's count of the bytes and operations that bound the
water-fill, on its own instances, made on the CPU."""

import numpy as np
import pytest
import torch

import chip_smoke as cs

# Per eval: ask (16 B), bandwidth ask, count, penalty (4 B each) read,
# remaining written; per row: eligible read (1 B), count written (4 B).
EVAL_BYTES = 16 + 4 + 4 + 4 + 4
ROW_BYTES = 1 + 4


def case(mode, n=8192, b=2):
    rng = np.random.default_rng(3)
    return cs.waterfill_case(rng, n, b, False, False, mode,
                             torch.device("cpu"))


@pytest.mark.parametrize("mode, b, live, cands", [
    # 5,000 empty nodes, 100,000 tasks: level 20, nothing left to select.
    ("headline", 1, 5000, 0),
    # 12,500 tasks on 5,000 nodes: level 2, every node a candidate.
    ("ties", 8, 5000, 5000),
])
def test_waterfill_work_headline_nodes(mode, b, live, cands):
    n_bytes, ops = cs.waterfill_work(*case(mode, b=b))
    per_eval = (8192 * ROW_BYTES + live * 40 + cands * (8 + 4)
                + EVAL_BYTES)
    assert n_bytes == b * per_eval
    assert ops == cs.SCORE_OPS * cands * b


@pytest.mark.parametrize("mode", ["saturated", "count0", "ineligible"])
def test_waterfill_work_no_candidates(mode):
    """No row is scored: every cap is taken whole, nothing is asked, or
    no row is eligible; only the eligible rows' inputs are read."""
    args = case(mode)
    live = int(args[7].sum())
    if mode == "ineligible":
        assert live == 0
    n_bytes, ops = cs.waterfill_work(*args)
    assert ops == 0
    assert n_bytes == 2 * (8192 * ROW_BYTES + EVAL_BYTES) + live * 40


def test_waterfill_work_counts_less_than_every_input():
    """On random rows the bound counts what the data needs: under every
    input tensor read whole, and at least the eligible rows' inputs."""
    args = case("random")
    every = sum(t.numel() * t.element_size() for t in args[:12])
    n_bytes, ops = cs.waterfill_work(*args)
    live = int(args[7].sum())
    assert live * 40 < n_bytes < every + 2 * 8192 * 4
    assert 0 < ops <= cs.SCORE_OPS * live
