"""``stop_run_pct.update``, the share of a roll's stops that the plan
carried as block stop runs: 100 on a tiny traced roll of a job placed as
a block, 0 on one of a job small enough to be placed as object rows, and
None where the window's ``sched.reconcile`` spans carry no ``stop_run``
count (a program that does not count it) or there is nothing to read."""

import json
import time

import pytest

from nomadbench import harness

SEED = 2 ** 33 + 6161
NAME = "stop_run_pct.update"
# The tiny roll's 60 tasks are placed as object rows (a service group of
# fewer than 256 tasks); 300 are placed as a block.
BLOCKS = "tiny-roll-runs"


@pytest.fixture(scope="module")
def traced_rolls(tiny):
    manifest, base = tiny
    cfg = json.loads((base / "configs" / "tiny-update50k-roll.json")
                     .read_text())
    cfg["job"].update(count=300, max_parallel=100)
    (base / "configs" / f"{BLOCKS}.json").write_text(json.dumps(cfg))
    manifest = dict(
        manifest,
        workloads=manifest["workloads"] + [
            {"name": BLOCKS, "config": BLOCKS,
             "traffic": "tiny-update50k-roll", "chips": 1, "why": "tiny"}],
        per_layer=manifest["per_layer"] + [
            {"name": NAME, "unit": "%", "better": "higher",
             "source": "program_span",
             "workloads": ["update50k-roll", BLOCKS]}])
    return {cell: harness.run_cell(cell, SEED, 1.5, True, "cpu",
                                   time.monotonic(), manifest, base)
            for cell in ("update50k-roll", BLOCKS)}


@pytest.mark.parametrize("cell, share", [(BLOCKS, 100.0),
                                         ("update50k-roll", 0.0)])
def test_a_tiny_traced_roll_reads_its_run_share(traced_rolls, cell, share):
    assert traced_rolls[cell]["correct"], traced_rolls[cell]["checks"]
    assert traced_rolls[cell]["metrics"][NAME]["value"] == share


class Rounds:
    """One roll of two rounds whose spans are ``spans``."""

    def __init__(self, spans):
        self._spans = spans

    def window_records(self, kind):
        recs = {"register": [dict(group=0, eval_id="e1")],
                "round": [dict(group=0, eval_id="e2"),
                          dict(group=0, eval_id="")]}
        return recs.get(kind, [])

    def spans(self, eval_id):
        return self._spans


def _reconcile(**annotations):
    return {"name": "sched.reconcile", "duration_ms": 1.0,
            "annotations": dict(path="block", **annotations)}


@pytest.mark.parametrize("spans", [
    [], [_reconcile(stop=1000)],
    [_reconcile(stop=1000), {"name": "fsm.apply", "duration_ms": 2.0,
                             "annotations": {"stops_columnar": 1000}}],
    [_reconcile(stop=0, stop_run=0)]])
def test_reads_none_without_run_counts(spans):
    assert harness.load_reader(NAME)(Rounds(spans)) is None


def test_reads_the_share_of_stops_carried_as_runs():
    spans = [_reconcile(stop=40, stop_run=30), _reconcile(stop=1000)]
    assert harness.load_reader(NAME)(Rounds(spans)) == 75.0
