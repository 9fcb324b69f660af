"""The whole harness on the tiny cells, on the CPU (the port's plain
versions): a sound run is correct and reports its metrics; each fault
planted under the timed path, and the control, is judged not correct."""

import time

import pytest

from nomadbench import faults, harness

SEED = 2 ** 33 + 12345
SECONDS = 1.5


def run(tiny, cell, plant=None, traced=False):
    manifest, base = tiny
    return harness.run_cell(cell, SEED, SECONDS, traced, "cpu",
                            time.monotonic(), manifest, base, plant)


@pytest.mark.parametrize("cell", ["batch10k-waves", "service10k-open",
                                  "update50k-roll", "update50k-inplace"])
def test_sound_run_is_correct_and_reports_its_metrics(tiny, cell):
    res = run(tiny, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in harness.metrics_for(tiny[0], cell, False)}
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "checks"
    assert all(c["limit"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["batch10k-waves", "service10k-open",
                                  "update50k-roll", "update50k-inplace"])
def test_traced_run_reads_the_span_metrics(tiny, cell):
    res = run(tiny, cell, traced=True)
    assert res["correct"], res["checks"]
    spans = {m["name"] for m in harness.metrics_for(tiny[0], cell, True)
             if m["source"] == "program_span"}
    assert spans and spans <= set(res["metrics"])


@pytest.mark.parametrize("cell,fault", [
    (cell, fault)
    for cell in ("batch10k-waves", "service10k-open", "update50k-roll")
    for fault in faults.KERNEL_FAULTS
] + [("update50k-inplace", "inplace_unchanged"),
      ("update50k-roll", "destructive_inplace")])
def test_planted_fault_is_judged_not_correct(tiny, cell, fault):
    res = run(tiny, cell, faults.by_name(fault))
    assert not res["correct"], res["checks"]
