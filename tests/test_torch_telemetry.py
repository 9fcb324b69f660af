"""The port's metrics sinks and Prometheus exposition
(nomad_tpu_torch.telemetry) against nomad_tpu's.

The same seeded counters, gauges and samples (numpy draws) go into both
packages' ``InmemSink`` under one pinned wall clock, and the interval
data, the lifetime books, the histograms, the SIGUSR1 dump and
``prometheus_text`` must be equal byte for byte; so must ``PromText``
over the same appends, the name sanitizer and the label escaping. The
push sinks are held to nomad_tpu's on local sockets (the same statsd
datagrams, the same statsite lines), and ``FanoutSink``, ``build_sink``,
the ``Metrics`` front and the module-level registry keep nomad_tpu's
behaviour; the port's raw books beside the sink keep theirs.

Tolerance: exact. Every series holds at most RESERVOIR_SIZE samples where
quantiles are compared (the reservoir then holds every sample, so its
replacement draws, which differ by design, never run); past that, only
the draw-free aggregates are compared.
"""

import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from nomad_tpu import telemetry as jt
from nomad_tpu_torch import telemetry as pt

SEEDS = [0, 7, 42]


@pytest.fixture
def pinned_clock(monkeypatch):
    """One wall clock for both packages' interval books (an interval
    boundary between the two feeds would split one side only)."""
    now = 1_700_000_003.0
    for mod in (jt, pt):
        monkeypatch.setattr(mod.time, "time", lambda: now)
    return now


def script(seed, n_samples=200):
    """A seeded metric script: (kind, key, value) rows."""
    rng = np.random.default_rng(seed)
    keys = [("nomad", "worker", "invoke_scheduler", "tpu-batch"),
            ("nomad", "plan", "evaluate"), ("nomad", "rpc", "query"),
            ("nomad", "broker", "total_ready"), ("raft", "apply")]
    rows = []
    for _ in range(n_samples):
        kind = ("gauge", "counter", "sample")[int(rng.integers(3))]
        key = keys[int(rng.integers(len(keys)))]
        value = float(np.round(rng.exponential(40.0), 3))
        rows.append((kind, key, value))
    return rows


def feed(sink, rows):
    for kind, key, value in rows:
        {"gauge": sink.set_gauge, "counter": sink.incr_counter,
         "sample": sink.add_sample}[kind](key, value)


@pytest.mark.parametrize("seed", SEEDS)
def test_inmem_sink_books_equal_nomad_tpus(pinned_clock, seed):
    rows = script(seed)
    j, p = jt.InmemSink(), pt.InmemSink()
    feed(j, rows)
    feed(p, rows)
    assert p.data() == j.data()
    assert p.cumulative() == j.cumulative()
    assert p.histograms() == j.histograms()


def test_inmem_sink_past_the_reservoir_keeps_the_aggregates(pinned_clock):
    rows = [("sample", ("s",), float(v)) for v in
            np.random.default_rng(3).exponential(10.0, 2000).round(3)]
    j, p = jt.InmemSink(), pt.InmemSink()
    feed(j, rows)
    feed(p, rows)
    jd, pd = j.data()[0]["samples"]["s"], p.data()[0]["samples"]["s"]
    for key in ("count", "sum", "min", "max", "mean", "stddev", "last"):
        assert pd[key] == jd[key], key
    assert p.histograms() == j.histograms()
    assert len(p._cum_samples["s"].reservoir) == pt.RESERVOIR_SIZE


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("buckets", [None, [100.0, 1.0, 10.0]])
def test_prometheus_text_is_byte_equal(pinned_clock, seed, buckets):
    rows = script(seed)
    j = jt.InmemSink(histogram_buckets=buckets)
    p = pt.InmemSink(histogram_buckets=buckets)
    feed(j, rows)
    feed(p, rows)
    assert pt.prometheus_text(p) == jt.prometheus_text(j)


def test_histogram_golden_format():
    sink = pt.InmemSink(histogram_buckets=[1.0, 10.0, 100.0])
    for v in (0.5, 5.0, 50.0, 500.0):
        sink.add_sample(("plan", "evaluate"), v)
    assert (
        "# TYPE plan_evaluate_ms_hist histogram\n"
        'plan_evaluate_ms_hist_bucket{le="1"} 1\n'
        'plan_evaluate_ms_hist_bucket{le="10"} 2\n'
        'plan_evaluate_ms_hist_bucket{le="100"} 3\n'
        'plan_evaluate_ms_hist_bucket{le="+Inf"} 4\n'
        "plan_evaluate_ms_hist_sum 555.5\n"
        "plan_evaluate_ms_hist_count 4\n") in pt.prometheus_text(sink)


def test_counters_survive_interval_eviction():
    """Lifetime counters: the ring evicting old intervals never makes an
    exposed _total decrease."""
    sink = pt.InmemSink(interval=0.01, retain=0.02)
    sink.incr_counter(("c",), 5.0)
    sink.add_sample(("s",), 3.0)
    time.sleep(0.05)
    for _ in range(4):
        sink.incr_counter(("c",), 1.0)
        time.sleep(0.015)
    text = pt.prometheus_text(sink)
    assert "c_total 9" in text
    assert "s_ms_count 1" in text
    assert len(sink.intervals) <= sink.max_intervals


@pytest.mark.parametrize("seed", SEEDS)
def test_dump_is_equal(pinned_clock, seed):
    rows = script(seed, 60)
    j, p = jt.InmemSink(), pt.InmemSink()
    feed(j, rows)
    feed(p, rows)
    assert p.dump() == j.dump()
    assert "[G]" in p.dump() and "[C]" in p.dump() and "[S]" in p.dump()


def promtext_script(b):
    b.counter("nomad_mirror_cache_hits_total", 12)
    b.gauge("nomad_capacity_utilization", 0.125, labels={"dim": "cpu"})
    b.gauge("nomad_capacity_utilization", 0.5, labels={"dim": "mem"})
    b.counter("nomad read:weird-name", 1e7 + 1,
              labels={"route": '/v1/job/"x"\\y\nz', "0bad label": 3})
    b.gauge("9lives", float("inf"))
    b.counter("nomad_mirror_cache_hits_total", 13, labels={"k": "v"})


def test_promtext_is_byte_equal():
    j, p = jt.PromText(), pt.PromText()
    promtext_script(j)
    promtext_script(p)
    assert p.text() == j.text()
    assert pt.PromText().text() == "" == jt.PromText().text()


@pytest.mark.parametrize("mod", [jt, pt], ids=["nomad_tpu", "port"])
def test_promtext_refuses_a_family_of_two_types(mod):
    b = mod.PromText()
    b.counter("x_total", 1)
    with pytest.raises(ValueError, match="registered as counter and gauge"):
        b.gauge("x_total", 2)


@pytest.mark.parametrize("name", [
    "nomad.worker.invoke", "9lives", "a--b..c", "", "ünïcode_name",
    "ok_name:sub", "trailing.", "nomad.vm-1.rpc.query",
])
def test_sanitize_equals_nomad_tpus(name):
    assert pt._sanitize(name) == jt._sanitize(name)


@pytest.mark.parametrize("value", ['a"b', "back\\slash", "new\nline", 42,
                                   "plain"])
def test_label_escape_equals_nomad_tpus(value):
    assert pt._escape_label_value(value) == jt._escape_label_value(value)


def test_aggregate_sample_repr_equals_nomad_tpus():
    j, p = jt.AggregateSample(), pt.AggregateSample()
    for v in (3.0, 1.5, 9.25):
        j.ingest(v)
        p.ingest(v)
    assert repr(p) == repr(j)


def test_fanout_and_blackhole():
    a, b = pt.InmemSink(), pt.InmemSink()
    fan = pt.FanoutSink([a, b, pt.BlackholeSink()])
    fan.set_gauge(("x",), 1.0)
    fan.incr_counter(("c",), 2.0)
    fan.add_sample(("s",), 3.0)
    for sink in (a, b):
        cur = sink.intervals[-1]
        assert cur.gauges["x"] == 1.0
        assert cur.counters["c"].sum == 2.0
        assert cur.samples["s"].max == 3.0


def test_build_sink_wiring():
    inmem, sink = pt.build_sink()
    assert sink is inmem
    assert inmem.buckets == pt.DEFAULT_HISTOGRAM_BUCKETS_MS \
        == jt.DEFAULT_HISTOGRAM_BUCKETS_MS
    inmem, sink = pt.build_sink(statsite_addr="127.0.0.1:9",
                                statsd_addr="127.0.0.1:9",
                                histogram_buckets=[5.0, 1.0])
    assert [type(s).__name__ for s in sink.sinks] == [
        "StatsiteSink", "StatsdSink", "InmemSink"]
    assert sink.sinks[-1] is inmem
    assert inmem.buckets == (1.0, 5.0)
    # Fire and forget: nothing listens on port 9.
    sink.incr_counter(("nomad", "test"), 1.0)


def _udp():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.settimeout(5.0)
    return s


def test_statsd_sink_sends_nomad_tpus_datagrams():
    got = []
    for mod in (jt, pt):
        rx = _udp()
        sink = mod.StatsdSink("127.0.0.1:%d" % rx.getsockname()[1])
        sink.set_gauge(("nomad", "g"), 2.5)
        sink.incr_counter(("nomad", "c"), 1.0)
        sink.add_sample(("nomad", "s"), 12.125)
        got.append([rx.recv(1024) for _ in range(3)])
        rx.close()
    assert got[1] == got[0] == [b"nomad.g:2.500000|g", b"nomad.c:1.000000|c",
                                b"nomad.s:12.125000|ms"]


def test_statsite_sink_streams_nomad_tpus_lines():
    got = []
    for mod in (jt, pt):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        sink = mod.StatsiteSink("127.0.0.1:%d" % srv.getsockname()[1])
        sink.set_gauge(("nomad", "g"), 1.0)
        sink.add_sample(("nomad", "s"), 0.5)
        conn, _ = srv.accept()
        conn.settimeout(5.0)
        buf = b""
        while buf.count(b"\n") < 2:
            buf += conn.recv(1024)
        got.append(buf)
        conn.close()
        srv.close()
        sink._sock.close()
    assert got[1] == got[0] == b"nomad.g:1.000000|g\nnomad.s:0.500000|ms\n"


@pytest.mark.parametrize("enable_hostname", [False, True])
def test_metrics_front_keys_equal_nomad_tpus(pinned_clock, enable_hostname):
    sinks = []
    for mod in (jt, pt):
        sink = mod.InmemSink()
        m = mod.Metrics(sink, service="nomad", hostname="host-1",
                        enable_hostname=enable_hostname)
        m.set_gauge(("broker", "ready"), 4)
        m.incr_counter(("rpc", "query"))
        m.add_sample(("plan", "evaluate"), 7.0)
        sinks.append(sink)
    j, p = (s.data()[0] for s in sinks)
    assert p == j
    prefix = "nomad.host-1." if enable_hostname else "nomad."
    assert set(p["counters"]) == {prefix + "rpc.query"}


def test_module_functions_feed_the_global_and_the_raw_books():
    """incr_counter & co. route through the global Metrics (as
    nomad_tpu's do) and keep the port's unprefixed raw books beside it."""
    was = pt.get_global()
    sink = pt.InmemSink()
    try:
        pt.set_global(pt.Metrics(sink, enable_hostname=False))
        before = pt.snapshot()["counters"].get("tt.hit", 0.0)
        pt.incr_counter(("tt", "hit"))
        pt.set_gauge(("tt", "g"), 3.0)
        pt.measure_since(("tt", "s"), time.perf_counter())
        cur = sink.intervals[-1]
        assert cur.counters["nomad.tt.hit"].sum == 1.0
        assert cur.gauges["nomad.tt.g"] == 3.0
        assert "nomad.tt.s" in cur.samples
        raw = pt.snapshot()
        assert raw["counters"]["tt.hit"] == before + 1.0
        assert raw["gauges"]["tt.g"] == 3.0
        assert pt.samples(("tt", "s"))
    finally:
        pt.set_global(was)


def test_signal_dump_prints_the_intervals(capfd):
    """setup_signal_dump on the main thread: SIGUSR1 prints the sink's
    dump to stderr, as nomad_tpu's does."""
    assert threading.current_thread() is threading.main_thread()
    sink = pt.InmemSink()
    sink.incr_counter(("nomad", "dumped"), 1.0)
    old = signal.getsignal(signal.SIGUSR1)
    try:
        pt.setup_signal_dump(sink)
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
    finally:
        signal.signal(signal.SIGUSR1, old)
    err = capfd.readouterr().err
    assert "[C] 'nomad.dumped': Count: 1" in err
    assert err.strip() == sink.dump()
