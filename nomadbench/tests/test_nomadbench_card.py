"""On a card: one short run of the benchmark's cell through its
own command, correct, with its result line as the contract asks."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
def test_one_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell runs only on the card")
    out = subprocess.run(
        [sys.executable, "-m", "nomadbench.run", "--workload",
         "update50k-roll", "--seed", "2147483659", "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
