"""The port's own accounting of a rolling update: the ``broker.delay``,
``sched.reconcile``, ``raft.persist`` and ``runtime.gc`` spans, and the
interpreter's collections as runtime telemetry (``telemetry.GCBooks``).

- A delayed eval's trace holds one ``broker.delay``, a leaf under the
  root as long as its ``wait``; a flush finishes it ``cancelled``.
- A collection on a thread that carries a span becomes a ``runtime.gc``
  span under that trace's root; the current span stays a leaf.
- The books and the ring advance; the ring keeps its bound and counts
  what it drops; the hook returns while its thread holds
  ``Tracer._lock``; with the tracer disabled no span is made and the
  counters still advance; a stats tick publishes the totals and pauses,
  and a cluster member's tick publishes those alone.
- A small ``ClusterServer`` roll shows ``sched.reconcile`` under
  ``worker.invoke_scheduler`` and ``raft.persist`` under ``plan.apply``,
  each inside its parent on ``trace.now()``'s clock.
"""

import collections
import copy
import gc
import threading
import time

import pytest

from nomad_tpu_torch import mock, structs, telemetry, trace
from nomad_tpu_torch.server.cluster import (
    ClusterConfig,
    ClusterServer,
    wait_for_leader,
)
from nomad_tpu_torch.server.eval_broker import EvalBroker
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.trace import Tracer


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def _is_leaf(spans, span):
    return all(s["parent_id"] != span["span_id"] for s in spans)


@pytest.fixture
def books():
    """A GCBooks of the test's own, its hook installed for the test."""
    b = telemetry.GCBooks()
    b.acquire()
    try:
        yield b
    finally:
        b.release()


def _full_collection():
    """A full collection long enough to pass GC_SPAN_MIN_S: a few hundred
    thousand tracked containers stay live across it."""
    live = [[i] for i in range(300_000)]
    gc.collect()
    return len(live)


# -- broker.delay ---------------------------------------------------------------


def _delayed_eval(wait):
    ev = mock.evaluation()
    ev.wait = wait
    return ev


def test_delayed_eval_has_one_broker_delay_leaf_under_its_root():
    broker = EvalBroker(nack_timeout=30.0)
    broker.set_enabled(True)
    ev = _delayed_eval(0.2)
    broker.enqueue(ev)
    got, token = broker.dequeue([ev.type], timeout=5.0)
    assert got is not None and got.id == ev.id
    broker.ack(ev.id, token)
    spans = trace.get_tracer().get_trace(ev.id)
    root = _by_name(spans, "eval")[0]
    (delay,) = _by_name(spans, "broker.delay")
    assert delay["parent_id"] == root["span_id"]
    assert _is_leaf(spans, delay)
    assert delay["annotations"] == {"wait_s": 0.2}
    assert 200.0 <= delay["duration_ms"] < 2000.0
    # The ready wait starts where the stagger ends.
    (wait,) = _by_name(spans, "broker.wait")
    assert wait["start"] >= delay["end"]


def test_a_flush_finishes_a_pending_delay_as_cancelled():
    broker = EvalBroker(nack_timeout=30.0)
    broker.set_enabled(True)
    ev = _delayed_eval(30.0)
    broker.enqueue(ev)
    broker.set_enabled(False)
    spans = trace.get_tracer().get_trace(ev.id)
    (delay,) = _by_name(spans, "broker.delay")
    assert delay["end"] is not None
    assert delay["annotations"]["cancelled"] is True
    assert not _by_name(spans, "broker.wait")


def test_an_undelayed_eval_has_no_broker_delay():
    broker = EvalBroker(nack_timeout=30.0)
    broker.set_enabled(True)
    ev = mock.evaluation()
    broker.enqueue(ev)
    got, token = broker.dequeue([ev.type], timeout=5.0)
    broker.ack(got.id, token)
    assert not _by_name(trace.get_tracer().get_trace(ev.id), "broker.delay")


# -- runtime.gc and the books ---------------------------------------------------


def test_a_collection_on_a_traced_thread_is_a_span_under_the_root(books):
    tracer = Tracer()
    root = tracer.start_span("t-gc", "eval", root=True)
    stage = tracer.start_span("t-gc", "solver.staging", parent=root)
    with trace.use_span(stage):
        _full_collection()
    stage.finish()
    assert books.flush_spans() >= 1
    root.finish()
    spans = tracer.get_trace("t-gc")
    pauses = _by_name(spans, "runtime.gc")
    assert pauses and all(p["parent_id"] == root.span_id for p in pauses)
    assert any(p["annotations"]["generation"] == 2 for p in pauses)
    assert all(p["duration_ms"] >= 1000.0 * telemetry.GC_SPAN_MIN_S
               for p in pauses)
    assert all(p["thread"] == threading.current_thread().name
               for p in pauses)
    (staging,) = _by_name(spans, "solver.staging")
    assert _is_leaf(spans, staging)


def test_an_untraced_collection_makes_no_span(books):
    tracer = Tracer()
    root = tracer.start_span("t-none", "eval", root=True)
    _full_collection()
    books.flush_spans()
    root.finish()
    assert not _by_name(tracer.get_trace("t-none"), "runtime.gc")


def test_books_and_ring_advance_and_the_ring_keeps_its_bound():
    books = telemetry.GCBooks()
    books.ring = collections.deque(maxlen=4)
    books.acquire()
    try:
        for _ in range(10):
            gc.collect(0)
        gc.collect(1)
    finally:
        books.release()
    assert books.runs[0] >= 10 and books.runs[1] >= 1
    assert books.pause_ns[0] > 0
    assert len(books.ring) == 4
    assert books.dropped == sum(books.runs) - 4
    starts = [s for s, _e, _g in books.pauses()]
    assert starts == sorted(starts)
    assert all(s <= e for s, e, _g in books.pauses())
    assert any(g == 1 for _s, _e, g in books.pauses())
    # Removed at release: no more counting.
    runs = sum(books.runs)
    gc.collect(0)
    assert sum(books.runs) == runs


def test_one_hook_for_several_users():
    books = telemetry.GCBooks()
    books.acquire()
    books.acquire()
    try:
        assert gc.callbacks.count(books) == 1
        books.release()
        assert gc.callbacks.count(books) == 1
    finally:
        books.release()
    assert books not in gc.callbacks
    books.release()  # one too many is a no-op
    assert books not in gc.callbacks


def test_the_hook_returns_while_its_thread_holds_the_tracer_lock(books):
    tracer = Tracer()
    root = tracer.start_span("t-lock", "eval", root=True)
    stage = tracer.start_span("t-lock", "plan.apply", parent=root)
    done = threading.Event()

    def collect_under_the_lock():
        with tracer._lock, trace.use_span(stage):
            books("start", {"generation": 2})
            time.sleep(0.002)
            books("stop", {"generation": 2, "collected": 0,
                           "uncollectable": 0})
            _full_collection()
        done.set()

    runs = sum(books.runs)
    t = threading.Thread(target=collect_under_the_lock, daemon=True)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive() and done.is_set()
    assert sum(books.runs) >= runs + 2
    assert books.flush_spans() >= 2
    stage.finish()
    assert len(_by_name(tracer.get_trace("t-lock"), "runtime.gc")) >= 2


def test_disabled_tracer_makes_no_span_and_the_counters_run(books):
    tracer = Tracer(enabled=False)
    span = tracer.start_span("t-off", "eval", root=True)
    assert span is trace.NULL_SPAN
    runs = sum(books.runs)
    with trace.use_span(span):
        _full_collection()
    assert sum(books.runs) > runs
    assert books.flush_spans() == 0
    assert tracer.get_trace("t-off") is None
    # A tracer turned off between the pause and the flush records nothing.
    live = Tracer()
    root = live.start_span("t-late", "eval", root=True)
    with trace.use_span(root):
        _full_collection()
    live.enabled = False
    assert books.flush_spans() == 0
    assert not _by_name(live.get_trace("t-late"), "runtime.gc")


def test_a_stats_tick_publishes_the_runtime_stats(books):
    sink = telemetry.InmemSink()
    prev = telemetry.get_global()
    telemetry.set_global(telemetry.Metrics(sink))
    key = "nomad.runtime.gc_pause_ns"
    try:
        gc.collect(0)
        gc.collect(0)
        runs, pause = sum(books.runs), sum(books.pause_ns)
        ring = len(books.pauses())
        books.publish()
        got = telemetry.snapshot()["gauges"]
        runs_after, pause_after = sum(books.runs), sum(books.pause_ns)
        books.publish()  # no pause is sampled twice
        ring_last = len(books.pauses())
        _counters, samples = sink.cumulative()
        text = telemetry.prometheus_text(sink)
    finally:
        telemetry.set_global(prev)
    # A collection may land between two reads, never before the first.
    assert runs <= got["runtime.total_gc_runs"] <= runs_after
    assert pause <= got["runtime.total_gc_pause_ns"] <= pause_after
    # Every pause of the ring sampled once (the ring here drops none).
    assert 2 <= ring <= samples[key]["count"] <= ring_last
    assert samples[key]["sum"] > 0
    assert "nomad_runtime_total_gc_runs" in text
    assert "nomad_runtime_gc_pause_ns" in text


def test_a_cluster_member_tick_publishes_only_the_runtime_stats(
        tmp_path, monkeypatch):
    """A member leaves the broker, plan and worker gauges alone, so a
    follower sharing the process cannot overwrite the leader's; it
    publishes the runtime stats and its store's block re-packs. Only this
    thread's gauges count: other servers of the process tick too."""
    me = threading.current_thread()
    set_here = []

    def record(key, value):
        if threading.current_thread() is me:
            set_here.append(".".join(key))

    monkeypatch.setattr(telemetry, "set_gauge", record)
    config = ServerConfig(device="cpu", scheduler_backend="tpu",
                          scheduler_workers=1)
    ClusterServer(config, ClusterConfig(
        node_id="server-1", bootstrap_expect=1,
        raft_data_dir=str(tmp_path / "raft")))._stats_tick()
    of_member = set(set_here)
    set_here.clear()
    Server(config)._stats_tick()
    of_server = set(set_here)
    runtime = {"runtime.total_gc_runs", "runtime.total_gc_pause_ns",
               "state.block_repacks", "state.block_repack_members",
               "state.block_stops", "state.block_stop_members",
               "state.stop_rows"}
    assert of_member == runtime
    assert runtime | {"broker.total_ready", "plan.queue_depth",
                      "worker.concurrency"} <= of_server


# -- a small roll through a ClusterServer ---------------------------------------


def _roll_job(count, max_parallel):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = count
    for task in tg.tasks:
        task.resources.networks = []
    job.update = structs.UpdateStrategy(stagger=0.05,
                                        max_parallel=max_parallel)
    return job


def _follow(srv, eval_id, timeout=60.0):
    """The eval and its delayed follow-ups, each waited for."""
    chain = []
    while eval_id:
        ev = srv.wait_for_eval(eval_id, timeout=timeout)
        assert ev.status == "complete", ev.status
        chain.append(eval_id)
        eval_id = ev.next_eval
    return chain


def _inside(child, parent):
    return (parent["start"] <= child["start"] <= child["end"]
            <= parent["end"])


# 40 tasks stay object rows (the diff); 300 place as a columnar block,
# which every round of both rolls reconciles block-wise: the placement
# block re-packs once, at 100 live members of 300, and each later round
# evicts one whole 100-member replacement block.
@pytest.mark.parametrize("count,max_parallel,path", [
    (40, 10, "diff"), (300, 100, "block")])
def test_a_cluster_roll_traces_reconcile_and_persist(tmp_path, count,
                                                     max_parallel, path):
    srv = ClusterServer(
        ServerConfig(device="cpu", scheduler_backend="tpu",
                     scheduler_workers=2, min_heartbeat_ttl=3600.0),
        ClusterConfig(node_id="server-1", bootstrap_expect=1,
                      raft_data_dir=str(tmp_path / "raft")))
    srv.start()
    try:
        wait_for_leader([srv], timeout=30.0)
        deadline = time.monotonic() + 30.0
        while not srv.eval_broker.enabled:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        nodes = []
        for i in range(64):
            node = mock.node()
            node.id = f"roll-node-{i:03d}"
            nodes.append(node)
        srv.node_batch_register(nodes)
        job = _roll_job(count, max_parallel)
        eid, _ = srv.job_register(job)
        _follow(srv, eid)
        rounds = []
        for v in ("2", "3"):
            bumped = copy.deepcopy(job)
            bumped.task_groups[0].tasks[0].env = {"V": v}
            eid, _ = srv.job_register(bumped)
            rounds += _follow(srv, eid)
        books = srv.state_store.repack_books
        repacked = (books.repacks, books.members)
        stops = srv.state_store.stop_books
        stop_books = (stops.blocks, stops.members, stops.rows)
        terminal_rows = [a for a in srv.state_store.allocs_objects()
                         if a.terminal_status()]
    finally:
        srv.shutdown()
    per_roll = count // max_parallel
    assert len(rounds) == 2 * per_roll
    # The block roll's stops all commit as stopped blocks, one a round;
    # the object roll's all as terminal object rows.
    if path == "block":
        assert stop_books == (2 * per_roll, count * 2, 0)
        assert terminal_rows == []
    else:
        assert stop_books == (0, 0, 2 * count)
        assert len(terminal_rows) == 2 * count
    tracer = trace.get_tracer()
    order = []
    for i, eval_id in enumerate(rounds):
        spans = [s for s in tracer.get_trace(eval_id) if s["end"]]
        by_id = {s["span_id"]: s for s in spans}
        (rec,) = _by_name(spans, "sched.reconcile")
        parent = by_id[rec["parent_id"]]
        assert parent["name"] == "worker.invoke_scheduler"
        assert _inside(rec, parent) and _is_leaf(spans, rec)
        ann = rec["annotations"]
        order.append(ann["path"])
        assert ann["stop"] == ann["place"] == max_parallel, ann
        assert ann["update"] == 0
        persists = _by_name(spans, "raft.persist")
        under = [by_id[p["parent_id"]]["name"] for p in persists]
        assert under.count("plan.apply") == 1, under
        for persist in persists:
            parent = by_id[persist["parent_id"]]
            assert _inside(persist, parent) and _is_leaf(spans, persist)
            # Beside the fsm.apply of its entry, under the same span.
            assert any(f["parent_id"] == persist["parent_id"]
                       and f["start"] >= persist["end"]
                       for f in _by_name(spans, "fsm.apply"))
        # The entry's fsm.apply counts its stops by the path they took.
        (applied,) = [f for f in _by_name(spans, "fsm.apply")
                      if "stops_columnar" in f["annotations"]]
        ann = applied["annotations"]
        assert (ann["stops_columnar"], ann["stops_rows"]) == (
            (max_parallel, 0) if path == "block" else (0, max_parallel))
        delays = _by_name(spans, "broker.delay")
        assert len(delays) == (1 if i % per_roll else 0)
        for s in spans:
            assert s["name"] not in ("sched.reconcile", "raft.persist",
                                     "broker.delay", "runtime.gc") \
                or _is_leaf(spans, s)
    assert order == [path] * len(order), order
    assert repacked == ((1, max_parallel) if path == "block" else (0, 0))
