"""Telemetry: metrics sinks, the Prometheus exposition and the lock
watchdog (port of nomad_tpu/telemetry.py).

The reference instruments every hot path with armon/go-metrics,
fanned out to an in-memory sink (SIGUSR1 dump) plus optional statsite and
statsd sinks configured at agent start (upstream
command/agent/command.go:486-520). This module reproduces that surface:
the ``Metrics`` front with set_gauge / incr_counter / add_sample /
measure_since, the interval-aggregated ``InmemSink`` with a signal dump,
UDP ``StatsdSink``, TCP ``StatsiteSink``, ``FanoutSink``, a module-level
global like go-metrics' default registry, the shared ``PromText`` line
builder, and ``LockWatchdog`` (runtime validation of the lock-order
analysis plus per-site contention books).

The module-level ``incr_counter``/``set_gauge``/``add_sample``/
``measure_since`` feed the global ``Metrics`` AND keep the port's raw
books beside it: every counter's sum, every gauge's last value and the
last 4096 values of each sample key, unprefixed (``snapshot()``,
``samples()``). ``Server.stats()["telemetry"]`` and the chip script's
stage reads use those books, so what they measure does not depend on the
sink's 256-sample reservoir or on the agent's key prefix.
"""

from __future__ import annotations

import bisect
import collections
import functools
import math
import os
import signal
import socket
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

from nomad_tpu_torch import prng

Key = Tuple[str, ...]

# Fixed histogram buckets (milliseconds) for latency timers. Summary
# quantiles cannot be aggregated across servers; PromQL's
# histogram_quantile() needs bucket counts with identical bounds on every
# server. Override per deployment with ``telemetry { histogram_buckets =
# [...] }``.
DEFAULT_HISTOGRAM_BUCKETS_MS: Tuple[float, ...] = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 15000.0, 60000.0,
)

_FLAT_CACHE: Dict[Key, str] = {}


def _flat(key: Key) -> str:
    # Memoized (a small fixed vocabulary), bounded against dynamic keys.
    s = _FLAT_CACHE.get(key)
    if s is None:
        s = ".".join(str(p) for p in key)
        if len(_FLAT_CACHE) > 4096:
            _FLAT_CACHE.clear()
        _FLAT_CACHE[key] = s
    return s


# -- the port's raw books -------------------------------------------------------

_lock = threading.Lock()
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
_samples: Dict[str, List[float]] = {}
_MAX_SAMPLES = 4096


def incr_counter(key: Key, value: float = 1.0) -> None:
    k = _flat(key)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + value
    get_global().incr_counter(key, value)


def set_gauge(key: Key, value: float) -> None:
    with _lock:
        _gauges[_flat(key)] = float(value)
    get_global().set_gauge(key, value)


def add_sample(key: Key, value: float) -> None:
    k = _flat(key)
    with _lock:
        ring = _samples.setdefault(k, [])
        ring.append(value)
        del ring[:-_MAX_SAMPLES]
    get_global().add_sample(key, value)


def measure_since(key: Key, start: float) -> None:
    """Record the ms elapsed since ``start`` (a time.perf_counter stamp)."""
    add_sample(key, (time.perf_counter() - start) * 1000.0)


def samples(key: Key) -> List[float]:
    """A copy of one sample key's retained ring, oldest first."""
    with _lock:
        return list(_samples.get(_flat(key), ()))


def _quantile(sorted_vals: List[float], q: float) -> float:
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def snapshot() -> Dict[str, Dict]:
    """Counters and gauges by flat key, and per sample key its count, mean,
    p50 and p95 over the retained ring (the last 4096 samples)."""
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        rings = {k: sorted(v) for k, v in _samples.items() if v}
    out = {
        k: {"count": len(v), "mean": sum(v) / len(v),
            "p50": _quantile(v, 0.50), "p95": _quantile(v, 0.95)}
        for k, v in rings.items()
    }
    return {"counters": counters, "gauges": gauges, "samples": out}


# Bounded reservoir per AggregateSample (Vitter's algorithm R).
RESERVOIR_SIZE = 256

QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))

# The reservoir's replacement draws: display-only (quantiles), never a
# decision, from one process-wide stream so no caller shares a cursor.
_reservoir_rng = prng.stream(0, "telemetry.reservoir")


class AggregateSample:
    """Streaming aggregate of one sample series (go-metrics inmem.go
    AggregateSample) with a bounded uniform reservoir for p50/p95/p99."""

    __slots__ = ("count", "sum", "sum_sq", "min", "max", "last", "last_time",
                 "reservoir")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.sum_sq = 0.0
        self.min = 0.0
        self.max = 0.0
        self.last = 0.0
        self.last_time = 0.0
        self.reservoir: List[float] = []

    def ingest(self, v: float) -> None:
        if self.count == 0 or v < self.min:
            self.min = v
        if self.count == 0 or v > self.max:
            self.max = v
        self.count += 1
        self.sum += v
        self.sum_sq += v * v
        self.last = v
        # nomadlint: allow(DET002) -- display-only last-sample wall
        # stamp (go-metrics AggregateSample parity); no arithmetic.
        self.last_time = time.time()
        # Algorithm R: after the reservoir fills, sample i survives with
        # probability RESERVOIR_SIZE/i.
        if len(self.reservoir) < RESERVOIR_SIZE:
            self.reservoir.append(v)
        else:
            j = _reservoir_rng.randrange(self.count)
            if j < RESERVOIR_SIZE:
                self.reservoir[j] = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def stddev(self) -> float:
        if self.count < 2:
            return 0.0
        var = (self.sum_sq - self.sum * self.sum / self.count) / (self.count - 1)
        return math.sqrt(var) if var > 0 else 0.0

    def quantiles(self) -> Dict[str, float]:
        """Nearest-rank p50/p95/p99 over the reservoir (0 when empty)."""
        if not self.reservoir:
            return {name: 0.0 for name, _ in QUANTILES}
        ordered = sorted(self.reservoir)
        n = len(ordered)
        return {
            name: ordered[max(0, min(n - 1, math.ceil(p * n) - 1))]
            for name, p in QUANTILES
        }

    def __repr__(self) -> str:
        return (
            f"Count: {self.count} Sum: {self.sum:.3f} "
            f"Min: {self.min:.3f} Mean: {self.mean:.3f} Max: {self.max:.3f} "
            f"Stddev: {self.stddev:.3f}"
        )


class IntervalMetrics:
    """One aggregation interval of the in-memory sink."""

    def __init__(self, interval_start: float):
        self.interval = interval_start
        self.gauges: Dict[str, float] = {}
        self.counters: Dict[str, AggregateSample] = {}
        self.samples: Dict[str, AggregateSample] = {}


class InmemSink:
    """Ring of aggregation intervals (go-metrics inmem.go), dumpable on
    SIGUSR1 via :func:`setup_signal_dump`."""

    def __init__(self, interval: float = 10.0, retain: float = 60.0,
                 histogram_buckets: Optional[Sequence[float]] = None):
        self.interval = interval
        self.max_intervals = max(1, int(retain / interval))
        self.intervals: List[IntervalMetrics] = []
        # Fixed bucket bounds for the histogram exposition: shared by
        # every sample series (cross-server aggregability is the point).
        self.buckets: Tuple[float, ...] = tuple(
            sorted(histogram_buckets)
        ) if histogram_buckets else DEFAULT_HISTOGRAM_BUCKETS_MS
        # name -> per-bucket observation counts, one extra slot for +Inf.
        # Process-lifetime cumulative, like _cum_counters: bucket counts
        # must be monotonic for rate()/histogram_quantile().
        self._cum_hist: Dict[str, List[int]] = {}
        # Process-lifetime cumulative totals, never evicted (the key
        # vocabulary is finite): the Prometheus exposition needs
        # monotonic counters — a rolling-window sum DECREASES as
        # intervals age out, which rate()/increase() reads as counter
        # resets and turns into spurious rate spikes. Samples keep a full
        # AggregateSample so the exposition serves lifetime quantiles
        # from its reservoir, not just sum/count/max.
        self._cum_counters: Dict[str, List[float]] = {}  # [sum, count]
        self._cum_samples: Dict[str, AggregateSample] = {}
        self._lock = threading.Lock()

    def _current(self) -> IntervalMetrics:
        # nomadlint: allow(DET002) -- interval buckets are wall-aligned
        # by design (go-metrics inmem.go): dump() strftime's them and
        # scrapers correlate them across hosts.
        now = time.time()
        start = now - (now % self.interval)
        if self.intervals and self.intervals[-1].interval == start:
            return self.intervals[-1]
        cur = IntervalMetrics(start)
        self.intervals.append(cur)
        if len(self.intervals) > self.max_intervals:
            self.intervals.pop(0)
        return cur

    def set_gauge(self, key: Key, value: float) -> None:
        with self._lock:
            self._current().gauges[_flat(key)] = value

    def incr_counter(self, key: Key, value: float) -> None:
        name = _flat(key)
        with self._lock:
            cur = self._current()
            agg = cur.counters.get(name)
            if agg is None:
                agg = cur.counters[name] = AggregateSample()
            agg.ingest(value)
            cum = self._cum_counters.get(name)
            if cum is None:
                self._cum_counters[name] = [value, 1]
            else:
                cum[0] += value
                cum[1] += 1

    def add_sample(self, key: Key, value: float) -> None:
        name = _flat(key)
        with self._lock:
            cur = self._current()
            agg = cur.samples.get(name)
            if agg is None:
                agg = cur.samples[name] = AggregateSample()
            agg.ingest(value)
            cum = self._cum_samples.get(name)
            if cum is None:
                cum = self._cum_samples[name] = AggregateSample()
            cum.ingest(value)
            hist = self._cum_hist.get(name)
            if hist is None:
                hist = self._cum_hist[name] = [0] * (len(self.buckets) + 1)
            hist[bisect.bisect_left(self.buckets, value)] += 1

    def cumulative(self) -> Tuple[Dict[str, List[float]],
                                  Dict[str, Dict[str, float]]]:
        """(counters {name: [sum, count]}, samples {name: {sum, count,
        max, p50, p95, p99}}) over the process lifetime — the monotonic
        series (plus reservoir quantiles) the Prometheus exposition
        serves."""
        with self._lock:
            return (
                {k: list(v) for k, v in self._cum_counters.items()},
                {
                    k: {"sum": a.sum, "count": a.count, "max": a.max,
                        **a.quantiles()}
                    for k, a in self._cum_samples.items()
                },
            )

    def histograms(self) -> Tuple[Tuple[float, ...], Dict[str, List[int]]]:
        """(bucket bounds, {name: per-bucket counts + overflow slot})
        over the process lifetime — the aggregatable companion to the
        summary quantiles."""
        with self._lock:
            return self.buckets, {k: list(v)
                                  for k, v in self._cum_hist.items()}

    def data(self) -> List[dict]:
        """Structured dump of all retained intervals — the JSON body of
        ``/v1/agent/metrics`` (api/http.py agent_metrics)."""

        def agg_dict(agg: AggregateSample) -> dict:
            return {
                "count": agg.count,
                "sum": agg.sum,
                "min": agg.min,
                "max": agg.max,
                "mean": agg.mean,
                "stddev": agg.stddev,
                "last": agg.last,
                **agg.quantiles(),
            }

        out: List[dict] = []
        with self._lock:
            for ivl in self.intervals:
                out.append({
                    "interval": ivl.interval,
                    "gauges": dict(ivl.gauges),
                    "counters": {
                        k: agg_dict(a) for k, a in ivl.counters.items()
                    },
                    "samples": {
                        k: agg_dict(a) for k, a in ivl.samples.items()
                    },
                })
        return out

    def dump(self, out=None) -> str:
        """Formatted dump of all retained intervals (inmem_signal.go)."""
        lines: List[str] = []
        with self._lock:
            for ivl in self.intervals:
                stamp = time.strftime(
                    "%Y-%m-%d %H:%M:%S", time.localtime(ivl.interval)
                )
                for name, value in sorted(ivl.gauges.items()):
                    lines.append(f"[{stamp}] [G] '{name}': {value:.3f}")
                for name, agg in sorted(ivl.counters.items()):
                    lines.append(f"[{stamp}] [C] '{name}': {agg!r}")
                for name, agg in sorted(ivl.samples.items()):
                    lines.append(f"[{stamp}] [S] '{name}': {agg!r}")
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text


class StatsdSink:
    """Push metrics to a statsd daemon over UDP (go-metrics statsd.go)."""

    def __init__(self, addr: str):
        host, _, port = addr.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def _emit(self, key: Key, value: float, kind: str) -> None:
        try:
            self._sock.sendto(
                f"{_flat(key)}:{value:f}|{kind}".encode(), self.addr
            )
        except OSError:  # pragma: no cover - fire and forget
            pass

    def set_gauge(self, key: Key, value: float) -> None:
        self._emit(key, value, "g")

    def incr_counter(self, key: Key, value: float) -> None:
        self._emit(key, value, "c")

    def add_sample(self, key: Key, value: float) -> None:
        self._emit(key, value, "ms")


class StatsiteSink:
    """Push metrics to statsite over TCP (go-metrics statsite.go). Connects
    lazily and drops metrics while unreachable."""

    def __init__(self, addr: str):
        host, _, port = addr.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _emit(self, key: Key, value: float, kind: str) -> None:
        line = f"{_flat(key)}:{value:f}|{kind}\n".encode()
        with self._lock:
            try:
                if self._sock is None:
                    self._sock = socket.create_connection(self.addr, timeout=1.0)
                self._sock.sendall(line)
            except OSError:
                self._sock = None

    def set_gauge(self, key: Key, value: float) -> None:
        self._emit(key, value, "g")

    def incr_counter(self, key: Key, value: float) -> None:
        self._emit(key, value, "c")

    def add_sample(self, key: Key, value: float) -> None:
        self._emit(key, value, "ms")


class FanoutSink:
    """Broadcast to several sinks (go-metrics sink.go FanoutSink)."""

    def __init__(self, sinks: List):
        self.sinks = list(sinks)

    def set_gauge(self, key: Key, value: float) -> None:
        for s in self.sinks:
            s.set_gauge(key, value)

    def incr_counter(self, key: Key, value: float) -> None:
        for s in self.sinks:
            s.incr_counter(key, value)

    def add_sample(self, key: Key, value: float) -> None:
        for s in self.sinks:
            s.add_sample(key, value)


class BlackholeSink:
    def set_gauge(self, key: Key, value: float) -> None:
        pass

    def incr_counter(self, key: Key, value: float) -> None:
        pass

    def add_sample(self, key: Key, value: float) -> None:
        pass


class Metrics:
    """Front-end adding service-name prefix and hostname tagging
    (go-metrics start.go Config + metrics.go)."""

    def __init__(self, sink, service: str = "nomad",
                 hostname: str = "", enable_hostname: bool = False):
        self.sink = sink
        self.service = service
        self.hostname = hostname or socket.gethostname()
        self.enable_hostname = enable_hostname

    def _key(self, key: Key) -> Key:
        parts: List[str] = [self.service]
        if self.enable_hostname:
            parts.append(self.hostname)
        return tuple(parts) + tuple(key)

    def set_gauge(self, key: Key, value: float) -> None:
        self.sink.set_gauge(self._key(key), value)

    def incr_counter(self, key: Key, value: float = 1.0) -> None:
        self.sink.incr_counter(self._key(key), value)

    def add_sample(self, key: Key, value: float) -> None:
        self.sink.add_sample(self._key(key), value)

    def measure_since(self, key: Key, start: float) -> None:
        """Record elapsed ms since ``start`` (a time.perf_counter stamp) —
        the `defer metrics.MeasureSince` idiom."""
        self.sink.add_sample(self._key(key), (time.perf_counter() - start) * 1000.0)


_global_lock = threading.Lock()
_global: Optional[Metrics] = None


def set_global(m: Metrics) -> Metrics:
    global _global
    with _global_lock:
        _global = m
    return m


def get_global() -> Metrics:
    """The process-wide registry; defaults to an in-memory sink."""
    global _global
    with _global_lock:
        if _global is None:
            _global = Metrics(InmemSink())
        return _global


def _sanitize(key: str) -> str:
    """THE one sanitizer for Prometheus metric and label NAMES
    ([a-zA-Z_:][a-zA-Z0-9_:]*): every run of invalid characters maps to a
    single underscore. Every name the agent exposes — the sink-derived
    series below and every subsystem appender riding :class:`PromText` —
    passes through here, so the data-model rules live in one place."""
    out = []
    prev_us = False
    for ch in key:
        ok = ch.isascii() and (ch.isalnum() or ch in "_:")
        if ok:
            out.append(ch)
            prev_us = False
        elif not prev_us:
            out.append("_")
            prev_us = True
    name = "".join(out)
    if name and name[0].isdigit():
        name = "_" + name
    return name or "_"


# Back-compat spelling used by the sink exposition below.
_prom_name = _sanitize


def _escape_label_value(value) -> str:
    """Label VALUES may be any UTF-8, but backslash, double-quote and
    newline must be escaped per the text-format grammar."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class PromText:
    """Shared Prometheus text-exposition line builder.

    One instance assembles one scrape: every subsystem appender (mirror,
    plan pipeline, tracer, admission, express, capacity, solver) emits
    through the same builder, so

    - every metric/label name passes :func:`_sanitize` in one place,
    - the ``# TYPE`` line for a family is emitted exactly once, BEFORE
      its first sample, across all appenders (the exposition-format
      invariant a hand-rolled per-appender emitter cannot enforce), and
    - two appenders registering one family under conflicting types fail
      loudly (ValueError) instead of serving a scrape Prometheus
      rejects.

    Values format shortest-exact (.17g), the sink exposition's rule: %g
    quantizes counters past ~1e6 into phantom rate() resets.
    """

    __slots__ = ("_lines", "_types")

    def __init__(self):
        self._lines: List[str] = []
        self._types: Dict[str, str] = {}

    @staticmethod
    def _fmt(value) -> str:
        return format(float(value), ".17g")

    def _sample(self, name: str, mtype: str, value,
                labels: Optional[Dict[str, object]] = None) -> None:
        name = _sanitize(name)
        seen = self._types.get(name)
        if seen is None:
            self._types[name] = mtype
            self._lines.append(f"# TYPE {name} {mtype}")
        elif seen != mtype:
            raise ValueError(
                f"metric family {name!r} registered as {seen} and {mtype}"
            )
        if labels:
            body = ",".join(
                f'{_sanitize(str(k))}="{_escape_label_value(v)}"'
                for k, v in labels.items()
            )
            self._lines.append(f"{name}{{{body}}} {self._fmt(value)}")
        else:
            self._lines.append(f"{name} {self._fmt(value)}")

    def counter(self, name: str, value,
                labels: Optional[Dict[str, object]] = None) -> None:
        self._sample(name, "counter", value, labels)

    def gauge(self, name: str, value,
              labels: Optional[Dict[str, object]] = None) -> None:
        self._sample(name, "gauge", value, labels)

    def text(self) -> str:
        return "\n".join(self._lines) + "\n" if self._lines else ""


def prometheus_text(inmem: InmemSink) -> str:
    """Prometheus text exposition (version 0.0.4): gauges take their
    latest retained value; counters and sample summaries serve the
    sink's PROCESS-LIFETIME cumulative totals — a rolling-window sum
    would decrease as ring intervals age out, which rate()/increase()
    reads as counter resets and turns into spurious rate spikes."""
    intervals = inmem.data()
    gauges: Dict[str, float] = {}
    for ivl in intervals:
        gauges.update(ivl["gauges"])  # later intervals win
    counters, samples = inmem.cumulative()
    bounds, hists = inmem.histograms()

    def _fmt(v: float) -> str:
        # Shortest-exact float (.17g), NOT %g: %g truncates to 6
        # significant digits, so a counter past ~1e6 quantizes and
        # Prometheus rate() reads phantom resets between scrapes.
        return format(float(v), ".17g")

    lines: List[str] = []
    for key in sorted(gauges):
        name = _prom_name(key)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(gauges[key])}")
    for key in sorted(counters):
        name = _prom_name(key) + "_total"
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_fmt(counters[key][0])}")
    for key in sorted(samples):
        name = _prom_name(key) + "_ms"
        s = samples[key]
        # Summary with quantile labels (the Prometheus summary type's
        # native shape): reservoir-backed, so a benchmark's p50 claims are
        # cross-checkable against the agent's own exposition.
        lines.append(f"# TYPE {name} summary")
        for qname, q in QUANTILES:
            lines.append(
                f'{name}{{quantile="{q}"}} {_fmt(s[qname])}'
            )
        lines.append(f"{name}_sum {_fmt(s['sum'])}")
        lines.append(f"{name}_count {int(s['count'])}")
        lines.append(f"# TYPE {name}_max gauge")
        lines.append(f"{name}_max {_fmt(s['max'])}")
        # Fixed-bucket histogram companion (``_hist`` family): summary
        # quantiles can't be aggregated across servers, but bucket
        # counts with identical bounds can —
        # histogram_quantile(0.95, sum by (le) (rate(..._hist_bucket[5m]))).
        hist = hists.get(key)
        if hist is not None:
            hname = name + "_hist"
            lines.append(f"# TYPE {hname} histogram")
            running = 0
            for bound, count in zip(bounds, hist):
                running += count
                lines.append(
                    f'{hname}_bucket{{le="{_fmt(bound)}"}} {running}'
                )
            running += hist[-1]
            lines.append(f'{hname}_bucket{{le="+Inf"}} {running}')
            lines.append(f"{hname}_sum {_fmt(s['sum'])}")
            lines.append(f"{hname}_count {running}")
    return "\n".join(lines) + "\n"


def setup_signal_dump(sink: InmemSink, signum: int = signal.SIGUSR1) -> None:
    """Dump all retained intervals to stderr on ``signum``
    (go-metrics inmem_signal.go wired at command/agent/command.go:492-497)."""

    def _dump(_sig, _frame):  # pragma: no cover - signal path
        sink.dump(out=sys.stderr)

    signal.signal(signum, _dump)


def build_sink(
    statsite_addr: str = "",
    statsd_addr: str = "",
    interval: float = 10.0,
    retain: float = 60.0,
    histogram_buckets: Optional[Sequence[float]] = None,
) -> Tuple[InmemSink, object]:
    """Agent telemetry wiring (command/agent/command.go:486-520): always an
    in-memory sink; fan out to statsite/statsd when configured. Returns
    (inmem, sink-to-use)."""
    inmem = InmemSink(interval=interval, retain=retain,
                      histogram_buckets=histogram_buckets)
    sinks: List = []
    if statsite_addr:
        sinks.append(StatsiteSink(statsite_addr))
    if statsd_addr:
        sinks.append(StatsdSink(statsd_addr))
    if sinks:
        sinks.append(inmem)
        return inmem, FanoutSink(sinks)
    return inmem, inmem


class BurnRateWindow:
    """Rolling-window error-budget accounting for one SLO objective (SRE
    workbook ch. 5). ``record(good)`` appends one sample; ``stats()``
    reports the bad fraction, the budget spent and the burn rate
    (bad_fraction / budget_fraction: 1.0 spends the budget exactly over
    the window). Monotonic timestamps; bounded at ``max_samples`` with
    oldest-first eviction, counted in ``evicted``."""

    __slots__ = ("window_s", "objective", "max_samples", "_lock",
                 "_samples", "evicted")

    def __init__(self, window_s: float = 3600.0, objective: float = 0.95,
                 max_samples: int = 8192):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.window_s = float(window_s)
        self.objective = float(objective)
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._samples: "collections.deque" = collections.deque()  # (t, good)
        self.evicted = 0

    def record(self, good: bool, t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else t
        with self._lock:
            self._samples.append((t, bool(good)))
            self._prune_locked(t)

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()
        while len(self._samples) > self.max_samples:
            self._samples.popleft()
            self.evicted += 1

    def stats(self, now: Optional[float] = None) -> Dict[str, float]:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prune_locked(now)
            total = len(self._samples)
            bad = sum(1 for _, good in self._samples if not good)
            evicted = self.evicted
        budget_fraction = 1.0 - self.objective
        bad_fraction = bad / total if total else 0.0
        burn = bad_fraction / budget_fraction
        return {
            "window_s": self.window_s,
            "objective": self.objective,
            "total": total,
            "bad": bad,
            "good_fraction": round(1.0 - bad_fraction, 6),
            "budget_spent_fraction": round(min(burn, 1.0), 6),
            "budget_remaining_fraction": round(max(0.0, 1.0 - burn), 6),
            "burn_rate": round(burn, 4),
            "evicted": evicted,
        }


# ---------------------------------------------------------------------------
# LockWatchdog: runtime validation of the lock-order analysis
# ---------------------------------------------------------------------------


class LockOrderViolation:
    """One observed acquisition that inverts the canonical order."""

    __slots__ = ("held", "acquired", "thread", "stack")

    def __init__(self, held: str, acquired: str, thread: str, stack: str):
        self.held = held
        self.acquired = acquired
        self.thread = thread
        self.stack = stack

    def __repr__(self) -> str:
        return (f"LockOrderViolation(held={self.held!r}, "
                f"acquired={self.acquired!r}, thread={self.thread!r})")


class _LockTiming:
    """Per-lock-id contention/hold books. Mutated lock-free from every
    acquiring thread (the watchdog deliberately owns no lock — it would
    join the very graph it checks): counter increments and reservoir
    ingests are CPython-atomic enough that a rare racing pair costs one
    sample, never a crash — approximate books, honestly so."""

    __slots__ = ("acquisitions", "contended", "wait_total_s", "wait",
                 "hold")

    def __init__(self):
        self.acquisitions = 0
        self.contended = 0
        self.wait_total_s = 0.0
        self.wait = AggregateSample()   # contended wait only, ms
        self.hold = AggregateSample()   # every timed hold, ms


class _WatchedLock:
    """Transparent wrapper around a threading lock that reports
    acquisitions/releases to a LockWatchdog under one canonical lock id.
    Reentrant acquires (RLocks, two instances of one lock class) only
    report the 0->1 transition, mirroring the static model where
    instances of a class share one graph node.

    Timing rides the same seam: a free lock takes the try-acquire fast
    path (no clock reads); only an actually-contended acquisition pays
    two monotonic stamps, so the books attribute WAIT precisely where
    it happens."""

    __slots__ = ("_nl_inner", "_nl_wd", "_nl_id")

    def __init__(self, wd: "LockWatchdog", inner, lock_id: str):
        self._nl_inner = inner
        self._nl_wd = wd
        self._nl_id = lock_id

    def acquire(self, *args, **kwargs):
        blocking = args[0] if args else kwargs.get("blocking", True)
        # Uncontended fast path (correct for RLock reentry too).
        if self._nl_inner.acquire(blocking=False):
            self._nl_wd._on_acquire(self._nl_id)
            return True
        if not blocking:
            return False
        t0 = time.monotonic()
        got = self._nl_inner.acquire(*args, **kwargs)
        if got:
            self._nl_wd._on_acquire(
                self._nl_id, wait_s=time.monotonic() - t0, contended=True)
        return got

    def release(self):
        self._nl_wd._on_release(self._nl_id)
        return self._nl_inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._nl_inner.locked()

    def __getattr__(self, name):
        # Condition(wrapped_rlock) binds _is_owned/_release_save/
        # _acquire_restore straight to the inner lock: ownership state
        # lives there, and a wait()'s temporary full-release must not
        # disturb the wrapper's held-stack (the waiting thread acquires
        # nothing while blocked, so its stack stays consistent).
        return getattr(self._nl_inner, name)


class LockWatchdog:
    """Runtime validation + contention attribution of the lock-order
    analysis (``tools/nomadlint/lockorder.py`` run over the port's own
    sources: :func:`port_lock_watchdog`).

    ``install()`` patches ``threading.Lock``/``threading.RLock`` so that
    every lock constructed at a KNOWN construction site (the ``sites``
    mapping of (repo-relative file, line) -> canonical lock id, produced
    by ``tools.nomadlint.lockorder.analyze().sites()``) is wrapped with
    acquisition tracking; locks built anywhere else — stdlib, tests,
    third-party — are returned raw and untouched. While installed, every
    tracked acquisition is checked against the canonical acquisition
    order: acquiring a lock ranked EARLIER than one already held by the
    same thread records a LockOrderViolation. Tests assert
    ``violations == []`` after driving a real workload, which validates
    the statically computed order against real interleavings.

    The same wrappers keep per-lock-site TIMING books: contended-
    acquisition counts, wait p50/p95/p99, and hold-time distributions —
    ``stats()`` surfaces them as a contention table ranked by total
    wait (the runtime observatory's lock ledger).

    Two ways in: tests use it as a context manager around server
    construction + workload; agents opt in at runtime via the
    ``telemetry { lock_watchdog = true }`` config knob (default off —
    wrapping costs a try-acquire + dict lookup per acquisition, and
    installation is process-global). The installed instance is
    published via :func:`active_lock_watchdog` so read-only observers
    can find the books without any plumbing through decision paths."""

    def __init__(self, order, sites, repo: Optional[str] = None,
                 closure=None):
        self._rank = {lock_id: i for i, lock_id in enumerate(order)}
        # With the static edge CLOSURE (analyze().closure()), a violation
        # is an observed inversion of a statically proven edge — a real
        # potential deadlock. Without it, fall back to comparing topo
        # ranks, which also flags pairs the analysis never constrained
        # (their relative order is a tie-break artifact): stricter, and
        # right for tests that drive one subsystem, but too noisy for the
        # whole-agent runtime knob.
        self._closure = ({tuple(e) for e in closure}
                         if closure is not None else None)
        self._sites = {tuple(k): v for k, v in dict(sites).items()}
        self._repo = os.path.abspath(
            repo
            or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        self._tls = threading.local()
        # Appends/adds below are CPython-atomic; the watchdog deliberately
        # owns NO lock of its own (it would join the very graph it checks).
        self.violations: List[LockOrderViolation] = []
        self._observed: set = set()
        self._orig = None
        # Timing books, pre-created for every statically known lock so
        # the hot path never mutates the dict; watch()-registered ids
        # outside the order join via atomic setdefault.
        self._books: Dict[str, _LockTiming] = {
            lock_id: _LockTiming() for lock_id in order
        }

    # -- wiring --------------------------------------------------------------

    def install(self) -> "LockWatchdog":
        global _ACTIVE_LOCK_WATCHDOG
        if self._orig is not None:
            raise RuntimeError("LockWatchdog already installed")
        self._orig = (threading.Lock, threading.RLock)
        threading.Lock = self._factory(self._orig[0])  # type: ignore
        threading.RLock = self._factory(self._orig[1])  # type: ignore
        _ACTIVE_LOCK_WATCHDOG = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE_LOCK_WATCHDOG
        if self._orig is None:
            return
        threading.Lock, threading.RLock = self._orig  # type: ignore
        self._orig = None
        if _ACTIVE_LOCK_WATCHDOG is self:
            _ACTIVE_LOCK_WATCHDOG = None

    def __enter__(self) -> "LockWatchdog":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _factory(self, real):
        def build(*args, **kwargs):
            inner = real(*args, **kwargs)
            frame = sys._getframe(1)
            fname = frame.f_code.co_filename
            if not fname.startswith(self._repo):
                return inner
            rel = os.path.relpath(fname, self._repo).replace(os.sep, "/")
            lock_id = self._sites.get((rel, frame.f_lineno))
            if lock_id is None:
                return inner
            return _WatchedLock(self, inner, lock_id)

        return build

    def watch(self, inner, lock_id: str):
        """Wrap one explicit lock under ``lock_id`` — the unit-testable
        path that skips construction-site frame mapping."""
        return _WatchedLock(self, inner, lock_id)

    # -- tracking ------------------------------------------------------------

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _on_acquire(self, lock_id: str, wait_s: float = 0.0,
                    contended: bool = False) -> None:
        held = self._held()
        rank = self._rank.get(lock_id)
        for h, _t0 in held:
            if h == lock_id:
                continue  # instance identity is invisible statically
            self._observed.add((h, lock_id))
            if self._closure is not None:
                bad = (lock_id, h) in self._closure
            else:
                hr = self._rank.get(h)
                bad = hr is not None and rank is not None and hr > rank
            if bad:
                self.violations.append(LockOrderViolation(
                    held=h, acquired=lock_id,
                    thread=threading.current_thread().name,
                    stack="".join(traceback.format_stack(limit=12)),
                ))
        held.append((lock_id, time.monotonic()))
        books = self._books.get(lock_id)
        if books is None:
            books = self._books.setdefault(lock_id, _LockTiming())
        books.acquisitions += 1
        if contended:
            books.contended += 1
            books.wait_total_s += wait_s
            books.wait.ingest(wait_s * 1000.0)

    def _on_release(self, lock_id: str) -> None:
        held = getattr(self._tls, "held", None)
        if held:
            # Remove the most recent entry for this id: releases are
            # typically LIFO, but out-of-order release is legal.
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] == lock_id:
                    hold_s = time.monotonic() - held[i][1]
                    del held[i]
                    books = self._books.get(lock_id)
                    if books is not None:
                        books.hold.ingest(hold_s * 1000.0)
                    break

    # -- results -------------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """The contention table, ranked by total wait: the runtime
        observatory's lock ledger and the ``nomad_lock_*`` prom
        families. Only ids that were actually acquired appear."""
        rows = []
        for lock_id, t in sorted(self._books.items()):
            if not t.acquisitions:
                continue
            rows.append({
                "lock": lock_id,
                "acquisitions": t.acquisitions,
                "contended": t.contended,
                "contention_rate": round(
                    t.contended / t.acquisitions, 6),
                "wait_total_ms": round(t.wait_total_s * 1000.0, 3),
                "wait_ms": {
                    "mean": round(t.wait.mean, 4),
                    "max": round(t.wait.max, 4),
                    **{k: round(v, 4)
                       for k, v in t.wait.quantiles().items()},
                },
                "hold_ms": {
                    "mean": round(t.hold.mean, 4),
                    "max": round(t.hold.max, 4),
                    **{k: round(v, 4)
                       for k, v in t.hold.quantiles().items()},
                },
            })
        rows.sort(key=lambda r: (-r["wait_total_ms"], r["lock"]))
        return {
            "installed": self._orig is not None,
            "locks_tracked": sum(
                1 for t in self._books.values() if t.acquisitions),
            "violations": len(self.violations),
            "contention": rows,
        }

    def observed_edges(self) -> set:
        """(held, acquired) pairs actually exercised while installed."""
        return set(self._observed)

    def assert_clean(self) -> None:
        if self.violations:
            lines = [f"  {v.held} -> {v.acquired} on {v.thread}"
                     for v in self.violations]
            raise AssertionError(
                "lock-order violations observed:\n" + "\n".join(lines)
            )


# The currently installed watchdog (None when off): read-only surfaces
# (the runtime observatory, /v1/agent/metrics) discover the books here
# instead of having an instance plumbed through decision-path
# constructors.
_ACTIVE_LOCK_WATCHDOG: Optional[LockWatchdog] = None


def active_lock_watchdog() -> Optional[LockWatchdog]:
    return _ACTIVE_LOCK_WATCHDOG


@functools.lru_cache(maxsize=1)
def _port_lock_analysis():
    from tools.nomadlint import lockorder
    from tools.nomadlint.project import Project

    an = lockorder.analyze(Project(roots=("nomad_tpu_torch",)))
    return tuple(an.order), dict(an.sites()), frozenset(an.closure())


def port_lock_watchdog() -> LockWatchdog:
    """A watchdog over the port's own lock graph: the order, construction
    sites and statically proven edge closure of
    ``tools.nomadlint.lockorder.analyze(Project(roots=("nomad_tpu_torch",)))``
    (about 2 s, once per process). With ``closure=`` a violation is an
    observed inversion of a proven edge. Raises where the repo's
    ``tools/`` tree is absent; callers degrade to a logged warning."""
    order, sites, closure = _port_lock_analysis()
    return LockWatchdog(order=order, sites=sites, closure=closure)
