"""The roll's readers of the program's own accounting (the collection
ring, ``sched.reconcile``, ``raft.persist`` and what no span covers): on
a tiny traced roll each reads a number, and each reads None where there
is nothing to read."""

import collections
import time

import pytest

from nomadbench import harness, program

SEED = 2 ** 33 + 4242
ROLL = "update50k-roll"
READERS = ("gc_pause_ms.update", "reconcile_ms.update", "persist_ms.update",
           "unspanned_pct.update")


@pytest.fixture(scope="module")
def traced_roll(tiny):
    manifest, base = tiny
    manifest = dict(manifest, per_layer=manifest["per_layer"] + [
        {"name": name, "unit": "x", "better": "lower",
         "source": "program_span", "workloads": [ROLL]}
        for name in READERS])
    return harness.run_cell(ROLL, SEED, 1.5, True, "cpu", time.monotonic(),
                            manifest, base)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_a_tiny_traced_roll(traced_roll, name):
    assert traced_roll["correct"], traced_roll["checks"]
    value = traced_roll["metrics"][name]["value"]
    assert value >= 0.0
    if name == "unspanned_pct.update":
        assert value < 100.0


def test_the_ring_agrees_with_the_harness_hook(traced_roll):
    """The program's ring and the harness's own gc.callbacks hook time the
    same collections of the window (a roll's records are its rounds)."""
    ring_s = (traced_roll["metrics"]["gc_pause_ms.update"]["value"]
              * traced_roll["attempted"] / 1000.0)
    hook_s = traced_roll["window"]["gc_pause_s"]
    assert hook_s > 0.0
    assert abs(ring_s - hook_s) <= 0.05 * hook_s, (ring_s, hook_s)


class Empty:
    """A run of no records."""

    t0, t_close = 0.0, 0.0

    def window_records(self, kind):
        return []

    def spans(self, eval_id):
        return []


class NoSpans(Empty):
    """One roll of two rounds long before any collection the program
    saw, with no span at all."""

    t0, t_close = 0.5, 2.0

    def window_records(self, kind):
        recs = {"register": [dict(group=0, due=0.5, done=1.0,
                                  eval_id="e1")],
                "round": [dict(group=0, due=1.0, done=2.0, eval_id="e2")]}
        return recs.get(kind, [])


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_with_nothing_to_read(name):
    assert harness.load_reader(name)(Empty()) is None


def test_unspanned_reads_100_where_no_span_covers():
    assert harness.load_reader("unspanned_pct.update")(NoSpans()) == 100.0
    for name in ("reconcile_ms.update", "persist_ms.update"):
        assert harness.load_reader(name)(NoSpans()) is None


def test_a_program_without_the_ring_reads_none(monkeypatch):
    from nomad_tpu_torch import telemetry

    monkeypatch.delattr(telemetry, "GC_BOOKS")
    assert program.window_pauses(0.0, 1.0) is None
    assert harness.load_reader("gc_pause_ms.update")(NoSpans()) is None
    assert harness.load_reader("unspanned_pct.update")(NoSpans()) == 100.0


def test_a_ring_that_dropped_pauses_of_the_window_reads_none(monkeypatch):
    from nomad_tpu_torch import telemetry, trace

    books = telemetry.GCBooks()
    books.ring = collections.deque(maxlen=2)
    now = trace.now()
    for k in range(3):
        books.ring.append((now + k, now + k + 0.001, 0))
    books.dropped = 1
    monkeypatch.setattr(telemetry, "GC_BOOKS", books)
    t = time.perf_counter()
    assert program.window_pauses(t - 1.0, t + 5.0)[1] is False
    assert program.window_pauses(t + 1.5, t + 5.0)[1] is True
    run = NoSpans()
    run.t0, run.t_close = t - 1.0, t + 5.0
    assert harness.load_reader("gc_pause_ms.update")(run) is None
    assert harness.load_reader("unspanned_pct.update")(run) is None
