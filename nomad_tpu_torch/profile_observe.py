"""Runtime self-observatory: the process watching itself (port of
nomad_tpu/profile_observe.py).

:class:`RuntimeObservatory` is a READ-ONLY observer composed only in
``server/server.py``; no decision path imports it. It keeps three
ledgers:

- **continuous sampling profiler**: a daemon thread walks
  ``sys._current_frames()`` at a seeded, jittered cadence
  (``prng.stream(seed, "profile.sampler")``: the schedule is a pure
  function of the seed) and aggregates collapsed stacks per THREAD ROLE
  (:data:`ROLES`: worker / pipeline-committer / raft / heartbeat-wheel /
  express-committer / observer / http / main / other). Exports:
  ``collapsed()`` (folded-stack lines), ``speedscope()`` (speedscope.app
  sampled-profile JSON, one profile per role), per-role wall shares.
- **lock-contention attribution**: read from the installed
  :class:`telemetry.LockWatchdog` (``telemetry { lock_watchdog = true }``):
  per-site contended counts, wait p50/p95/p99, hold books, ranked by
  total wait. The observatory only reads the watchdog's books.
- **byte-economy ledger**: the device mirrors' buffers by shape bucket x
  dtype (``MirrorCache.byte_ledger``: CUDA tensors and host numpy arrays
  alike, from metadata), every bounded ring, the state store's tables
  and RSS (``/proc/self/statm`` + ``getrusage``), with a **projected
  1M-row mirror footprint** from the MEASURED per-row cost.

It publishes only on the ``Runtime`` observer topic, which
``events.OBSERVER_TOPICS`` excludes from canonical digests, so the
steady-10k digest is equal with the profiler on and off.

Surfaces: ``/v1/agent/profile`` (JSON, ``?format=collapsed``,
``?format=speedscope``), ``/v1/agent/runtime`` (JSON,
``?format=prometheus``), the ``nomad_profile_*`` / ``nomad_runtime_*`` /
``nomad_lock_*`` families of the main scrape, the debug bundle's
``profile`` and ``runtime`` sections, and the scenario artifact's
``profile`` section.

The port counts the allocs table with ``alloc_count()`` where nomad_tpu
lists (and so materializes) every alloc each ledger poll: the same number,
without expanding a 100,000-task block into objects once a second.
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch import prng, telemetry

# Thread-role taxonomy: every thread in the process maps to exactly one
# role by FIRST-MATCH prefix rule (order matters: "raft-observatory"
# must classify observer, not raft). Pinned by the golden-format tests —
# extending the taxonomy is an artifact-schema change.
ROLES = ("worker", "pipeline-committer", "raft", "heartbeat-wheel",
         "express-committer", "observer", "http", "main", "other")

_ROLE_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("worker-", "worker"),
    ("plan-pipeline", "pipeline-committer"),
    ("raft-observatory", "observer"),
    ("read-observatory", "observer"),
    ("runtime-profiler", "observer"),
    ("capacity-accountant", "observer"),
    ("stats-emitter", "observer"),
    ("slo-monitor", "observer"),
    ("raft-", "raft"),
    ("heartbeat-wheel", "heartbeat-wheel"),
    ("express-commit", "express-committer"),
    ("http-server", "http"),
)


def classify_thread(name: str) -> str:
    """Thread name -> role, first matching prefix wins. HTTP request
    handlers ride ThreadingHTTPServer's default naming
    ("Thread-N (process_request_thread)")."""
    for prefix, role in _ROLE_PREFIXES:
        if name.startswith(prefix):
            return role
    if "process_request_thread" in name:
        return "http"
    if name == "MainThread":
        return "main"
    return "other"


@dataclass
class ProfileObserveConfig:
    """The ``server { profile { ... } }`` block, parse-time validated:
    typos and nonsense ranges fail config load, not first use."""

    enabled: bool = True
    # Base sampling cadence of the stack profiler. 20 Hz keeps the
    # walk's cost well under the <5% plan-p50 overhead budget while
    # still resolving 50ms-scale stalls.
    sample_interval: float = 0.05
    # Jitter fraction applied per tick: interval * (1 ± jitter), drawn
    # from the seeded stream so the schedule is reproducible AND never
    # phase-locks with a periodic workload (the classic profiler bias).
    jitter: float = 0.2
    # Seed of the prng.stream("profile.sampler") cadence stream.
    seed: int = 42
    # Frames kept per stack (leaf-preserving truncation).
    max_depth: int = 24
    # Distinct (role, stack) rows retained; overflow is counted, never
    # silent (the no-silent-caps posture).
    max_stacks: int = 4096
    # Cadence of the byte-economy ledger refresh (mirror walk + RSS
    # sample), riding the sampler thread.
    ledger_interval: float = 1.0
    # Cadence of Runtime-topic snapshot events (0 disables). Observer
    # topic: excluded from the canonical event digest by construction.
    events_interval: float = 10.0

    @classmethod
    def parse(cls, spec: Optional[Dict[str, Any]]) -> "ProfileObserveConfig":
        if spec is None:
            return cls()
        if not isinstance(spec, dict):
            raise ValueError("profile config must be a mapping")
        known = set(cls.__dataclass_fields__)
        unknown = [k for k in spec if k not in known]
        if unknown:
            raise ValueError(
                f"unknown profile config key(s): {sorted(unknown)} "
                f"(have: {sorted(known)})"
            )
        ints = ("seed", "max_depth", "max_stacks")
        out = cls(**{
            k: (bool(v) if k == "enabled"
                else int(v) if k in ints else float(v))
            for k, v in spec.items()
        })
        if out.sample_interval <= 0:
            raise ValueError("profile.sample_interval must be > 0")
        if not 0.0 <= out.jitter < 1.0:
            raise ValueError("profile.jitter must be in [0, 1)")
        if out.seed < 0:
            raise ValueError("profile.seed must be >= 0")
        if out.max_depth <= 0:
            raise ValueError("profile.max_depth must be > 0")
        if out.max_stacks <= 0:
            raise ValueError("profile.max_stacks must be > 0")
        if out.ledger_interval <= 0:
            raise ValueError("profile.ledger_interval must be > 0")
        if out.events_interval < 0:
            raise ValueError("profile.events_interval must be >= 0")
        return out


def sample_schedule(seed: int, interval: float, jitter: float,
                    n: int) -> List[float]:
    """The first ``n`` inter-sample gaps of the profiler's cadence — a
    PURE function of (seed, interval, jitter): the sampler consumes the
    identical stream, so same seed → same schedule (the determinism
    test's pin). Jitter is uniform in interval * [1-j, 1+j]."""
    rng = prng.stream(seed, "profile.sampler")
    return [interval * (1.0 + jitter * (2.0 * rng.random() - 1.0))
            for _ in range(n)]


def frame_label(frame) -> str:
    """Stable frame naming for the exports: ``<module-basename>:<func>``
    — machine-independent (no absolute paths, no line numbers: a
    comment-shift must not churn every banked flamegraph). Pinned by
    the golden-format test."""
    code = frame.f_code
    base = os.path.splitext(os.path.basename(code.co_filename))[0]
    return f"{base}:{code.co_name}"


def collapse_frames(frame, max_depth: int) -> Tuple[str, ...]:
    """One thread's stack as a root-first label tuple, leaf-preserving
    truncation (the leaf is where the time is; a too-deep root prefix
    folds into a literal ``…`` marker)."""
    labels: List[str] = []
    while frame is not None:
        labels.append(frame_label(frame))
        frame = frame.f_back
    labels.reverse()
    if len(labels) > max_depth:
        labels = ["…"] + labels[-(max_depth - 1):]
    return tuple(labels)


# -- byte-economy helpers ----------------------------------------------------


def rss_bytes() -> Dict[str, int]:
    """Current + peak resident set, stdlib only (no psutil in the
    image): current from /proc/self/statm (0 off-Linux), peak from
    getrusage (ru_maxrss is KiB on Linux)."""
    current = 0
    try:
        with open("/proc/self/statm") as f:
            current = int(f.read().split()[1]) * (
                os.sysconf("SC_PAGE_SIZE"))
    except (OSError, IndexError, ValueError):
        pass
    peak = 0
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        pass
    return {"current_bytes": current, "peak_bytes": peak}


def _deep_sizeof(obj: Any, depth: int = 2, _budget: List[int] = None) -> int:
    """Bounded-depth recursive sys.getsizeof: containers recurse into
    members, objects into their __dict__, everything capped at a node
    budget — an APPROXIMATION for the ledger (shared references double-
    count; deep payloads under-count), honest about being one."""
    if _budget is None:
        _budget = [256]
    if _budget[0] <= 0:
        return 0
    _budget[0] -= 1
    try:
        size = sys.getsizeof(obj)
    except TypeError:
        return 0
    if depth <= 0 or isinstance(obj, (str, bytes, int, float, bool,
                                      type(None))):
        return size
    if isinstance(obj, dict):
        for k, v in list(obj.items())[:64]:
            size += _deep_sizeof(k, depth - 1, _budget)
            size += _deep_sizeof(v, depth - 1, _budget)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for v in list(obj)[:64]:
            size += _deep_sizeof(v, depth - 1, _budget)
    else:
        d = getattr(obj, "__dict__", None)
        if d:
            size += _deep_sizeof(d, depth - 1, _budget)
    return size


def container_footprint(obj: Any, sample: int = 32) -> Dict[str, Any]:
    """One bounded ring's (deque / OrderedDict / list) byte estimate:
    shallow container size + per-entry cost extrapolated from the first
    ``sample`` entries."""
    try:
        n = len(obj)
    except TypeError:
        n = 0
    cap = getattr(obj, "maxlen", None)
    if cap is None:
        cap = getattr(obj, "capacity", None)
    per = 0
    if n:
        it = iter(obj.values()) if isinstance(obj, dict) else iter(obj)
        head = []
        for _ in range(min(sample, n)):
            try:
                head.append(next(it))
            except (StopIteration, RuntimeError):
                break  # a concurrent writer moved the ring under us
        if head:
            per = int(sum(_deep_sizeof(e) for e in head) / len(head))
    try:
        shallow = sys.getsizeof(obj)
    except TypeError:
        shallow = 0
    return {
        "entries": n,
        "capacity": cap,
        "per_entry_bytes": per,
        "approx_bytes": int(shallow + per * n),
    }


class RuntimeObservatory:
    """The process's self-observatory: sampling profiler + lock
    contention + byte economy. All getters re-read per refresh (snapshot
    installs rebind fsm.state; restarts rebind rings). All derived state
    lives under ``_lock``; no decision path ever takes it."""

    def __init__(self, config: Optional[ProfileObserveConfig] = None,
                 events=None,
                 store_getter: Optional[Callable[[], Any]] = None,
                 rings_getter: Optional[Callable[[], Dict[str, Any]]] = None,
                 tables_getter: Optional[Callable[[], Dict[str, Any]]] = None):
        self.config = config or ProfileObserveConfig()
        self._events = events
        self._store = store_getter or (lambda: None)
        self._rings = rings_getter or (lambda: {})
        self._tables = tables_getter or (lambda: {})
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Profiler books (under _lock).
        self.samples = 0            # sampling passes
        self.thread_samples = 0     # individual thread stacks ingested
        self._stacks: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        self._role_samples: Dict[str, int] = {}
        self.stack_overflow = 0     # stacks dropped past max_stacks
        # Byte-ledger books (replaced wholesale under _lock per refresh).
        self._ledger: Dict[str, Any] = {}
        self._rss_mb = telemetry.AggregateSample()
        self.polls = 0
        self.events_published = 0

    # -- profiler -------------------------------------------------------------

    def _ingest(self, role: str, stack: Tuple[str, ...]) -> None:
        """Fold one sampled thread stack into the books (caller holds
        no lock; this takes _lock). The seam the golden-format tests
        drive directly."""
        with self._lock:
            self.thread_samples += 1
            self._role_samples[role] = self._role_samples.get(role, 0) + 1
            key = (role, stack)
            count = self._stacks.get(key)
            if count is not None:
                self._stacks[key] = count + 1
            elif len(self._stacks) < self.config.max_stacks:
                self._stacks[key] = 1
            else:
                self.stack_overflow += 1

    def sample_once(self) -> int:
        """One profiler pass: snapshot every live thread's stack and
        fold it into the books. Returns threads sampled. Safe to call
        from tests without the thread; the sampler thread itself is
        excluded (it would only ever see itself in sample_once)."""
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        me = threading.get_ident()
        n = 0
        for ident, frame in frames.items():
            if ident == me:
                continue
            name = names.get(ident, f"thread-{ident}")
            self._ingest(classify_thread(name),
                         collapse_frames(frame, self.config.max_depth))
            n += 1
        with self._lock:
            self.samples += 1
        return n

    # -- byte-economy ledger --------------------------------------------------

    def refresh(self) -> None:
        """One ledger poll: mirror buffers, bounded rings, state-store
        tables, observatory tables, RSS. Safe to call from tests
        without the thread."""
        ledger: Dict[str, Any] = {}
        ledger["mirror"] = self._mirror_ledger()
        rings = {}
        for name, obj in sorted((self._rings() or {}).items()):
            if obj is None:
                continue
            rings[name] = container_footprint(obj)
        ledger["rings"] = rings
        ledger["store"] = self._store_ledger()
        tables = {}
        for name, obj in sorted((self._tables() or {}).items()):
            if obj is None:
                continue
            tables[name] = {"approx_bytes": _deep_sizeof(obj, depth=3)}
        ledger["tables"] = tables
        rss = rss_bytes()
        self._rss_mb.ingest(rss["current_bytes"] / 1e6)
        ledger["rss"] = {**rss, "sampled_mb": _q(self._rss_mb)}
        tracked = (
            (ledger["mirror"].get("total_bytes") or 0)
            + sum(r["approx_bytes"] for r in rings.values())
            + (ledger["store"].get("approx_bytes") or 0)
            + sum(t["approx_bytes"] for t in tables.values())
        )
        ledger["tracked_bytes"] = tracked
        with self._lock:
            self.polls += 1
            self._ledger = ledger

    @staticmethod
    def _mirror_ledger() -> Dict[str, Any]:
        """The mirror cache's bucket×dtype byte books + the measured-
        per-row 1M-node projection (tpu/mirror.py owns the math; this
        just reads it). Degrades to a disabled stub when the
        device stack is absent (client-only agents)."""
        try:
            from nomad_tpu_torch.tpu.mirror import GLOBAL_MIRROR_CACHE

            return GLOBAL_MIRROR_CACHE.byte_ledger()
        except Exception as e:
            return {"error": str(e), "total_bytes": 0}

    def _store_ledger(self) -> Dict[str, Any]:
        store = self._store()
        if store is None:
            return {"approx_bytes": 0}
        counts = {}
        for table in ("jobs", "nodes", "allocs", "evals"):
            try:
                counts[table] = (store.alloc_count() if table == "allocs"
                                 else len(getattr(store, table)()))
            except Exception:
                counts[table] = None
        return {
            "counts": counts,
            "approx_bytes": _deep_sizeof(store, depth=3),
        }

    # -- exposition -----------------------------------------------------------

    def _profiler_view(self) -> Dict[str, Any]:
        with self._lock:
            total = self.thread_samples
            roles = {
                role: {
                    "samples": n,
                    "wall_share": round(n / total, 4) if total else 0.0,
                }
                for role, n in sorted(self._role_samples.items())
            }
            return {
                "samples": self.samples,
                "thread_samples": total,
                "roles": roles,
                "distinct_stacks": len(self._stacks),
                "stack_overflow": self.stack_overflow,
                "schedule": {
                    "seed": self.config.seed,
                    "sample_interval_s": self.config.sample_interval,
                    "jitter": self.config.jitter,
                },
            }

    def _locks_view(self) -> Dict[str, Any]:
        wd = telemetry.active_lock_watchdog()
        if wd is None:
            return {"installed": False}
        return wd.stats()

    def profile_view(self) -> Dict[str, Any]:
        """The ``/v1/agent/profile`` JSON body."""
        return {
            "profiler": self._profiler_view(),
            "observer": self._observer_view(),
        }

    def runtime_view(self) -> Dict[str, Any]:
        """The ``/v1/agent/runtime`` JSON body."""
        with self._lock:
            ledger = dict(self._ledger)
        return {
            "locks": self._locks_view(),
            "bytes": ledger,
            "observer": self._observer_view(),
        }

    def _observer_view(self) -> Dict[str, Any]:
        return {"polls": self.polls,
                "events_published": self.events_published}

    def snapshot(self) -> Dict[str, Any]:
        """The full self-observatory report (the SIMLOAD ``profile``
        section + bundle body): wall shares, the ranked contention
        table, the byte economy with the 1M-row projection."""
        out = self.profile_view()
        rt = self.runtime_view()
        out["locks"] = rt["locks"]
        out["bytes"] = rt["bytes"]
        return out

    def summary(self) -> Dict[str, Any]:
        """Compact agent-info line: top role by wall share, RSS, mirror
        bytes, worst lock site."""
        prof = self._profiler_view()
        top_role, top_share = "", 0.0
        for role, row in prof["roles"].items():
            if row["wall_share"] >= top_share:
                top_role, top_share = role, row["wall_share"]
        with self._lock:
            ledger = self._ledger
        locks = self._locks_view()
        contention = locks.get("contention") or []
        return {
            "samples": prof["samples"],
            "top_role": top_role,
            "top_role_share": top_share,
            "rss_mb": round(
                (ledger.get("rss", {}).get("current_bytes", 0)) / 1e6, 1),
            "mirror_bytes": ledger.get("mirror", {}).get("total_bytes", 0),
            "contended_sites": sum(
                1 for row in contention if row["contended"]),
            "lock_wait_total_ms": round(
                sum(row["wait_total_ms"] for row in contention), 3),
        }

    def collapsed(self) -> str:
        """Folded-stack lines (flamegraph.pl / speedscope import
        format): ``role;frame;frame count``, sorted for byte-stable
        output."""
        with self._lock:
            rows = sorted(self._stacks.items())
        return "".join(
            f"{';'.join((role,) + stack)} {count}\n"
            for (role, stack), count in rows
        )

    def speedscope(self) -> Dict[str, Any]:
        """speedscope.app file-format JSON: one sampled profile per
        role over a shared frame table, weights = sample counts.
        Deterministic given the books (sorted frames, sorted stacks)."""
        with self._lock:
            rows = sorted(self._stacks.items())
        frame_names: List[str] = sorted(
            {f for (_role, stack), _n in rows for f in stack})
        index = {name: i for i, name in enumerate(frame_names)}
        profiles = []
        for role in sorted({role for (role, _stack), _n in rows}):
            samples, weights = [], []
            for (r, stack), count in rows:
                if r != role:
                    continue
                samples.append([index[f] for f in stack])
                weights.append(count)
            profiles.append({
                "type": "sampled",
                "name": role,
                "unit": "none",
                "startValue": 0,
                "endValue": sum(weights),
                "samples": samples,
                "weights": weights,
            })
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "name": "nomad_tpu_torch runtime profile",
            "exporter": "nomad_tpu_torch.profile_observe",
            "shared": {"frames": [{"name": n} for n in frame_names]},
            "profiles": profiles,
        }

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if not self.config.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="runtime-profiler"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        import time as _time

        cfg = self.config
        rng = prng.stream(cfg.seed, "profile.sampler")
        next_ledger = _time.monotonic()
        next_event = (
            _time.monotonic() + cfg.events_interval
            if cfg.events_interval else None
        )
        while True:
            gap = cfg.sample_interval * (
                1.0 + cfg.jitter * (2.0 * rng.random() - 1.0))
            if self._stop.wait(gap):
                return
            try:
                self.sample_once()
                now = _time.monotonic()
                if now >= next_ledger:
                    next_ledger = now + cfg.ledger_interval
                    self.refresh()
                if next_event is not None and now >= next_event:
                    next_event = now + cfg.events_interval
                    self.publish_event()
            except Exception:
                # The observer must never take the agent down; the
                # sampler retries next tick. Counted, not silent.
                telemetry.incr_counter(("profile_observe", "poll_errors"))

    def publish_event(self) -> None:
        """One Runtime-topic snapshot event (trimmed payload). Observer
        topic: excluded from canonical event digests by construction
        (events.OBSERVER_TOPICS), so publishing cadence can never
        perturb the determinism contract."""
        if self._events is None:
            return
        self._events.publish(
            "Runtime", "RuntimeSnapshot", key="runtime",
            payload=self.summary(),
        )
        self.events_published += 1


def _q(sample) -> Dict[str, float]:
    return {
        "mean": round(sample.mean, 4),
        "max": round(sample.max, 4),
        **{k: round(v, 4) for k, v in sample.quantiles().items()},
    }
