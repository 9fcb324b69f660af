"""Operator debug bundle: the one-shot flight recorder (port of
nomad_tpu/bundle.py).

Upstream analog: ``nomad operator debug``, which captures API state,
metrics and profiles from a live cluster so an operator attaches ONE
artifact to a bug report. This module builds the single-JSON version:
everything the observability stack retains at the moment of capture,
one key per entry of :data:`BUNDLE_SECTIONS`:

- ``metrics``     InmemSink intervals + lifetime cumulative counters and
                  sample summaries
- ``traces``      tracer summaries, span trees of the latest traces
- ``events``      the last K events of the agent's event stream (with no
                  agent: of every broker live in the process)
- ``config``      the effective agent config, secrets redacted
- ``faults``      the armed fault plan + per-rule fire counts
- ``breaker``     the device statement: the port has no circuit breaker
                  (a device fault fails the eval, which the worker nacks
                  for redelivery; there is no host route), so this
                  section names the server's device and says so, where
                  nomad_tpu reports its DEVICE_BREAKER
- ``mirror``      device-mirror cache stats (hits, delta rolls, rebuilds)
- ``plan_pipeline``  the optimistic plan pipeline's lifetime totals
- ``slo``, ``admission``, ``express``, ``capacity``, ``raft``, ``reads``
                  each subsystem's snapshot (None without a server or
                  with it disabled)
- ``profile``, ``runtime``  the runtime observatory: per-role wall
                  shares, the lock-contention table, the byte ledger
- ``solver``      the device-solve panel (tpu/solver.py SOLVER_PANEL)
- ``timelines``   the worst-K submit→placed lifecycle timelines
- ``nomadlint``   the last lint report left in the temp directory
                  (``NOMADLINT_REPORT_PATH``'s file name, read from
                  ``tempfile.gettempdir()``), or None
- ``threads``     Python stacks of every live thread

Served by ``/v1/agent/debug/bundle`` (behind ``enable_debug``).
Redaction: any config key whose name contains ``token``, ``secret`` or
``password`` (case-insensitive) is replaced with ``<redacted>`` when set.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional

BUNDLE_FORMAT = "nomad-tpu-debug-bundle/v1"

# Sections every bundle carries (tests assert this schema; a consumer can
# rely on the keys existing even when a subsystem was not running — the
# value is then None or an {"error": ...} stub, never absent).
BUNDLE_SECTIONS = (
    "format", "captured_at", "metrics", "traces", "events", "config",
    "faults", "breaker", "mirror", "plan_pipeline", "slo", "admission",
    "express", "capacity", "raft", "reads", "profile", "runtime",
    "solver", "timelines", "nomadlint", "threads",
)

# nomad_tpu's lint report path. The port reads that file name under
# tempfile.gettempdir(), so a capture reads no directory but the
# process's own temp directory.
NOMADLINT_REPORT_PATH = "/tmp/nomadlint_report.json"

_SECRET_MARKERS = ("token", "secret", "password")

# Full span trees for at most this many most-recent traces: summaries are
# cheap, span trees are the expensive part of the tracer dump.
MAX_FULL_TRACES = 8


def redact_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Redact credential-bearing values; coerce everything else to
    JSON-able primitives (non-primitive objects stringify)."""
    out: Dict[str, Any] = {}
    for key, value in config.items():
        lowered = key.lower()
        if any(m in lowered for m in _SECRET_MARKERS) and value:
            out[key] = "<redacted>"
        elif value is None or isinstance(value, (bool, int, float, str)):
            out[key] = value
        elif isinstance(value, dict):
            out[key] = redact_config(value)
        elif isinstance(value, (list, tuple)):
            out[key] = [v if isinstance(v, (bool, int, float, str))
                        else str(v) for v in value]
        else:
            out[key] = str(value)
    return out


def thread_stacks(depth: int = 12) -> Dict[str, List[str]]:
    """Formatted stacks of every live thread, keyed by thread name — the
    first thing needed when an agent wedges. Duplicate names (an
    in-process multi-server cluster runs several ``worker-0``s) get an
    ``#ident`` suffix instead of silently shadowing each other."""
    import threading

    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, str(ident))
        key = name if name not in out else f"{name}#{ident}"
        out[key] = traceback.format_stack(frame)[-depth:]
    return out


def _metrics_section() -> Optional[Dict[str, Any]]:
    from nomad_tpu_torch import telemetry

    sink = telemetry.get_global().sink
    if not isinstance(sink, telemetry.InmemSink):
        sink = next(
            (s for s in getattr(sink, "sinks", [])
             if isinstance(s, telemetry.InmemSink)),
            None,
        )
    if sink is None:
        return None
    counters, samples = sink.cumulative()
    return {
        "intervals": sink.data(),
        "cumulative": {"counters": counters, "samples": samples},
    }


def _traces_section() -> Dict[str, Any]:
    from nomad_tpu_torch import trace

    tracer = trace.get_tracer()
    summaries = tracer.traces()
    return {
        "summaries": summaries,
        "spans": {
            s["trace_id"]: tracer.get_trace(s["trace_id"])
            for s in summaries[:MAX_FULL_TRACES]
        },
    }


def _events_section(agent, last_events: int) -> List[Dict[str, Any]]:
    from nomad_tpu_torch import events as events_mod

    brokers = []
    server = getattr(agent, "server", None) if agent is not None else None
    if server is not None and getattr(server, "fsm", None) is not None:
        brokers = [server.fsm.events]
    else:
        # Process-local capture: whatever brokers are alive right now.
        with events_mod._brokers_lock:
            brokers = list(events_mod._BROKERS)
    out: List[Dict[str, Any]] = []
    for broker in brokers:
        out.extend(e.to_dict() for e in broker.all_events())
    out.sort(key=lambda e: (e["time"], e["index"]))
    return out[-last_events:] if last_events else out


BREAKER_STATEMENT = (
    "no circuit breaker: a device fault fails the eval's scheduler pass "
    "and the worker nacks it for redelivery; there is no host route")


def _breaker_section(agent) -> Dict[str, Any]:
    """The port has no DEVICE_BREAKER, by decision: the server's device
    and a plain statement of what a device fault does."""
    server = getattr(agent, "server", None) if agent is not None else None
    device = getattr(server, "device", None)
    return {"breaker": None,
            "device": str(device) if device is not None else None,
            "statement": BREAKER_STATEMENT}


def _mirror_section() -> Dict[str, Any]:
    from nomad_tpu_torch.tpu.mirror import GLOBAL_MIRROR_CACHE

    return GLOBAL_MIRROR_CACHE.stats()


def _plan_pipeline_section() -> Dict[str, Any]:
    from nomad_tpu_torch.server.plan_pipeline import PIPELINE_TOTALS

    return PIPELINE_TOTALS.stats()


def _slo_section(agent) -> Optional[Dict[str, Any]]:
    """Live SLO snapshot from the agent's server (None without one, or
    with the monitor disabled)."""
    server = getattr(agent, "server", None) if agent is not None else None
    monitor = getattr(server, "slo_monitor", None)
    return monitor.snapshot() if monitor is not None else None


def _admission_section(agent) -> Optional[Dict[str, Any]]:
    """Admission front-door snapshot (server/admission.py):
    decision counters, rate-lane table, recent typed rejections — where
    a 'clients are getting 429s' report starts. None without a server."""
    server = getattr(agent, "server", None) if agent is not None else None
    admission = getattr(server, "admission", None)
    return admission.snapshot() if admission is not None else None


def _express_section(agent) -> Optional[Dict[str, Any]]:
    """Express-lane snapshot (server/express.py): placement/
    commit/bounce books, the reservation ledger, place-latency
    quantiles, recent committer outcomes. None without a server."""
    server = getattr(agent, "server", None) if agent is not None else None
    express = getattr(server, "express_lane", None)
    return express.snapshot() if express is not None else None


def _capacity_section(agent) -> Optional[Dict[str, Any]]:
    """Capacity observatory snapshot (capacity.py): a
    postmortem bundle must carry the utilization picture — whether the
    cell was full, fragmented, or stranding capacity when things went
    sideways. None without a server or with the observatory disabled."""
    server = getattr(agent, "server", None) if agent is not None else None
    acct = getattr(server, "capacity_accountant", None)
    if acct is None or not acct.config.enabled:
        return None
    acct.refresh()
    return acct.snapshot()


def _raft_section(agent) -> Optional[Dict[str, Any]]:
    """Raft & recovery observatory snapshot (raft_observe.py):
    a postmortem bundle must carry the replicated write path's books —
    per-entry stage costs, follower lag, log/snapshot economy, and
    whether (and how fast) this process recovered from a cold restart.
    None without a server or with the observatory disabled."""
    server = getattr(agent, "server", None) if agent is not None else None
    obs = getattr(server, "raft_observatory", None)
    if obs is None or not obs.config.enabled:
        return None
    obs.refresh()
    return obs.snapshot()


def _reads_section(agent) -> Optional[Dict[str, Any]]:
    """Read-path observatory snapshot (read_observe.py): the
    serving books a read-pressure postmortem needs — which routes were
    hot, how long blocking queries held vs served, whether SSE tails
    were lagging or truncating, and how stale the answers were. None
    without a server or with the observatory disabled."""
    server = getattr(agent, "server", None) if agent is not None else None
    obs = getattr(server, "read_observatory", None)
    if obs is None or not obs.config.enabled:
        return None
    obs.refresh()
    return obs.snapshot()


def _runtime_observatory(agent):
    server = getattr(agent, "server", None) if agent is not None else None
    obs = getattr(server, "runtime_observatory", None)
    if obs is None or not obs.config.enabled:
        return None
    return obs


def _profile_section(agent) -> Optional[Dict[str, Any]]:
    """Sampling-profiler view (profile_observe.py): the
    collapsed-stack aggregates and per-role wall shares at capture time
    — a bundle attached to a "the agent was slow" report carries its own
    profile. None without a server or with the observatory disabled."""
    obs = _runtime_observatory(agent)
    return obs.profile_view() if obs is not None else None


def _runtime_section(agent) -> Optional[Dict[str, Any]]:
    """Runtime economy ledgers (profile_observe.py): lock
    contention + the byte-economy ledger, refreshed at capture so the
    footprint numbers describe the process NOW."""
    obs = _runtime_observatory(agent)
    if obs is None:
        return None
    obs.refresh()
    return obs.runtime_view()


def _solver_section() -> Dict[str, Any]:
    """Device-solve efficiency panel (tpu/solver.py SOLVER_PANEL):
    padding economy, bucket occupancy, compile attribution — next to the
    mirror's delta-roll wall costs already in the ``mirror`` section."""
    from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

    return SOLVER_PANEL.snapshot()


# Worst-K slowest timelines embedded per bundle: summaries of the tail,
# not the whole run — a bundle must stay one readable JSON.
TIMELINE_WORST_K = 8


def _timelines_section(agent, last_events: int) -> List[Dict[str, Any]]:
    """Worst-K slowest submit→placed lifecycle timelines stitched from
    the same events the ``events`` section carries plus the retained
    traces (lifecycle.py) — the flight recorder answers 'where
    did the slow placements spend their time' directly."""
    from nomad_tpu_torch import lifecycle

    events = _events_section(agent, last_events)
    timelines = lifecycle.stitch(events)
    return lifecycle.worst_k(timelines.values(), k=TIMELINE_WORST_K)


def nomadlint_report_path() -> str:
    return os.path.join(tempfile.gettempdir(),
                        os.path.basename(NOMADLINT_REPORT_PATH))


def _nomadlint_section() -> Optional[Dict[str, Any]]:
    """Most recent lint report, if a lint run left one in the temp
    directory. None (not an error) when there is none: the section is
    about provenance, and an absent report is a fact worth recording."""
    path = nomadlint_report_path()
    try:
        with open(path) as f:
            report = json.load(f)
        mtime = os.path.getmtime(path)
    except (OSError, ValueError):
        return None
    # mtime + the report's own repo/generated_at stamps let a reader
    # detect a stale or foreign report (the path is host-global).
    return {"path": path, "mtime": mtime, "report": report}


def collect(agent=None, last_events: int = 512) -> Dict[str, Any]:
    """Build the bundle. ``agent`` is a live nomad_tpu_torch.agent.Agent
    for the full capture; None collects the process-local subset
    (metrics, faults, the breaker statement, threads, any live event
    brokers)."""
    from nomad_tpu_torch import faults

    bundle: Dict[str, Any] = {
        "format": BUNDLE_FORMAT,
        # nomadlint: allow(DET002) -- user-facing capture timestamp on
        # an operator artifact; never used in interval arithmetic.
        "captured_at": time.time(),
        "metrics": None,
        "traces": None,
        "events": [],
        "config": None,
        "faults": None,
        "breaker": None,
        "mirror": None,
        "plan_pipeline": None,
        "slo": None,
        "admission": None,
        "express": None,
        "capacity": None,
        "raft": None,
        "reads": None,
        "profile": None,
        "runtime": None,
        "solver": None,
        "timelines": [],
        "nomadlint": None,
        "threads": None,
    }
    for section, build in (
        ("metrics", _metrics_section),
        ("traces", _traces_section),
        ("events", lambda: _events_section(agent, last_events)),
        ("faults", lambda: faults.get_registry().snapshot()),
        ("breaker", lambda: _breaker_section(agent)),
        ("mirror", _mirror_section),
        ("plan_pipeline", _plan_pipeline_section),
        ("slo", lambda: _slo_section(agent)),
        ("admission", lambda: _admission_section(agent)),
        ("express", lambda: _express_section(agent)),
        ("capacity", lambda: _capacity_section(agent)),
        ("raft", lambda: _raft_section(agent)),
        ("reads", lambda: _reads_section(agent)),
        ("profile", lambda: _profile_section(agent)),
        ("runtime", lambda: _runtime_section(agent)),
        ("solver", _solver_section),
        ("timelines", lambda: _timelines_section(agent, last_events)),
        ("nomadlint", _nomadlint_section),
        ("threads", thread_stacks),
    ):
        # One wedged subsystem must not cost the whole flight recording.
        try:
            bundle[section] = build()
        except Exception as e:
            bundle[section] = {"error": str(e)}
    if agent is not None:
        try:
            bundle["config"] = redact_config(vars(agent.config))
        except Exception as e:
            bundle["config"] = {"error": str(e)}
    return bundle
