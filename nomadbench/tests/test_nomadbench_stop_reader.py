"""``block_stop_pct.update``, the share of a roll's stops committed as
stopped blocks: 100 on a tiny traced roll of a job placed as a block, 0
on one of a job small enough to be placed as object rows, and None where
the window's ``fsm.apply`` spans carry no stop counts (a program that
does not count them) or there is nothing to read."""

import json
import time

import pytest

from nomadbench import harness

SEED = 2 ** 33 + 5151
NAME = "block_stop_pct.update"
# The tiny roll's 60 tasks are placed as object rows (a service group of
# fewer than 256 tasks); 300 are placed as a block.
BLOCKS = "tiny-roll-blocks"


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
def test_a_tiny_traced_roll_reads_its_columnar_share(traced_rolls, cell,
                                                     share):
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


def _apply(**annotations):
    return {"name": "fsm.apply", "duration_ms": 1.0,
            "annotations": dict(msg_type="alloc_update", **annotations)}


@pytest.mark.parametrize("spans", [
    [], [_apply()], [_apply(), {"name": "plan.apply", "duration_ms": 2.0,
                                "annotations": {}}],
    [_apply(stops_columnar=0, stops_rows=0)]])
def test_reads_none_without_stop_counts(spans):
    assert harness.load_reader(NAME)(Rounds(spans)) is None


def test_reads_the_share_of_columnar_stops():
    spans = [_apply(stops_columnar=30, stops_rows=10), _apply()]
    assert harness.load_reader(NAME)(Rounds(spans)) == 75.0
