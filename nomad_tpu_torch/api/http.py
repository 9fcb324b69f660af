"""HTTP API server (port of nomad_tpu/api/http.py).

Reference: upstream command/agent/http.go — route table at :93-120,
the ``wrap`` JSON/error envelope at :147-226, blocking-query parameter
parsing (``index``/``wait``) at :228-250, and the X-Nomad-Index /
X-Nomad-KnownLeader / X-Nomad-LastContact response headers. Endpoint
behaviors mirror command/agent/{job,node,eval,alloc,agent}_endpoint.go.

Every route of nomad_tpu's agent answers, the Prometheus exposition
(``?format=prometheus`` on /v1/agent/metrics, /runtime, /capacity,
/raft and /reads) included, with nomad_tpu's family names. Every GET
resolves its consistency lane through the server's follower read
plane (``server/read_path.py``) before its handler runs, and each
finished GET is folded into the read observatory's books
(``read_observe.py``), keyed by route template.
"""

from __future__ import annotations

import json
import logging
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from nomad_tpu_torch import events as events_mod
from nomad_tpu_torch import lifecycle, telemetry, trace
from nomad_tpu_torch.api.codec import from_dict, to_dict
from nomad_tpu_torch.jobspec import parse_duration
from nomad_tpu_torch.server.blocking import blocking_query
from nomad_tpu_torch.state.store import (
    item_table,
)
from nomad_tpu_torch.structs import (
    MAX_QUERY_TIME,
    REJECT_QUEUE_FULL,
    REJECT_WATCH_LIMIT,
    Job,
    RejectError,
    ValidationError,
)

from nomad_tpu_torch.server.read_path import (
    LANE_DEFAULT,
    LANE_LINEARIZABLE,
    LANE_STALE,
)

def _route_template(pattern: str) -> str:
    """Stable attribution key for a route regex: named groups become
    ``:name`` segments (``^/v1/job/(?P<job_id>[^/]+)$`` ->
    ``/v1/job/:job_id``), so the read books key on the route's shape,
    never on unbounded concrete ids."""
    return re.sub(
        r"\(\?P<([^>]+)>[^)]+\)", r":\1", pattern
    ).lstrip("^").rstrip("$")


def _prefix_filter(items, query):
    """Apply the list endpoints' ``?prefix=`` filter over item ids (the
    reference api's QueryOptions.Prefix: CLI short-id resolution lists
    with a prefix and disambiguates client-side)."""
    prefix = query.get("prefix", "")
    if not prefix:
        return items
    return [it for it in items if it.id.startswith(prefix)]


class HTTPCodedError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _mirror_cache_stats() -> Dict[str, Any]:
    """The process-wide device-mirror cache's stats — hits/misses plus
    the delta-roll economy (delta_rolls vs full_rebuilds, rows_restaged).
    Late import: the metrics endpoint must answer even if the solver
    stack never initialized."""
    try:
        from nomad_tpu_torch.tpu.mirror import GLOBAL_MIRROR_CACHE

        return GLOBAL_MIRROR_CACHE.stats()
    except Exception as e:  # pragma: no cover - import-time breakage only
        return {"error": str(e)}


def _mirror_prometheus(b: "telemetry.PromText") -> None:
    """Mirror-cache stats on the shared line-builder: monotonic counters
    for the roll economy (counts AND wall cost), a gauge for residency."""
    stats = _mirror_cache_stats()
    if "error" in stats:
        return
    for k in ("hits", "misses", "delta_rolls", "full_rebuilds",
              "rows_restaged"):
        b.counter(f"nomad_mirror_cache_{k}_total", stats[k])
    b.counter("nomad_mirror_cache_roll_ms_total", stats["roll_ms"])
    b.counter("nomad_mirror_cache_rebuild_ms_total", stats["rebuild_ms"])
    b.gauge("nomad_mirror_cache_entries", stats["entries"])


def _plan_pipeline_stats() -> Dict[str, Any]:
    """Process-wide optimistic plan-pipeline totals (plan_pipeline.py):
    batches/plans drained, commit vs conflict split, fused-vs-scalar
    verification economy. Late import like the mirror stats."""
    try:
        from nomad_tpu_torch.server.plan_pipeline import PIPELINE_TOTALS

        return PIPELINE_TOTALS.stats()
    except Exception as e:  # pragma: no cover - import-time breakage only
        return {"error": str(e)}


def _plan_pipeline_prometheus(b: "telemetry.PromText") -> None:
    """Pipeline totals: everything monotonic is a counter;
    max_batch_seen is a high-watermark gauge."""
    stats = _plan_pipeline_stats()
    if "error" in stats:
        return
    for k in ("batches", "plans", "committed", "noops", "rejected",
              "conflicts", "refreshes", "fused_plans", "scalar_plans"):
        b.counter(f"nomad_plan_pipeline_{k}_total", stats[k])
    b.gauge("nomad_plan_pipeline_max_batch", stats["max_batch_seen"])


def _trace_prometheus(b: "telemetry.PromText") -> None:
    """Tracer loss accounting: without the aggregate counters, silent
    span/trace loss under 10k-node load is invisible until someone opens
    the one clipped trace."""
    stats = trace.get_tracer().stats()
    for k in ("spans_dropped", "traces_evicted"):
        b.counter(f"nomad_trace_{k}_total", stats[k])
    b.gauge("nomad_trace_retained", stats["retained"])


def _solver_panel_stats() -> Dict[str, Any]:
    """Process-wide device-solve efficiency panel (tpu/solver.py
    SOLVER_PANEL). Late import: the metrics endpoint must answer even if
    the solver stack never initialized."""
    try:
        from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

        return SOLVER_PANEL.snapshot()
    except Exception as e:  # pragma: no cover - import-time breakage only
        return {"error": str(e)}


def _solver_prometheus(b: "telemetry.PromText") -> None:
    """Solver efficiency panel: padding-waste and per-placement device
    cost as gauges, solve/compile totals as counters with bucket/trigger
    labels."""
    stats = _solver_panel_stats()
    if "error" in stats:
        return
    b.counter("nomad_solver_solves_total", stats["solves"])
    b.counter("nomad_solver_requested_total", stats["requested"])
    b.counter("nomad_solver_placed_total", stats["placed"])
    b.counter("nomad_solver_device_ms_total", stats["device_ms"])
    b.gauge("nomad_solver_node_padding_waste",
            stats["node_padding_waste"])
    b.gauge("nomad_solver_count_padding_waste",
            stats["count_padding_waste"])
    b.gauge("nomad_solver_device_ms_per_placement",
            stats["device_ms_per_placement"])
    for row in stats["node_buckets"]:
        b.counter("nomad_solver_bucket_solves_total", row["solves"],
                  labels={"bucket": row["bucket"]})
        b.gauge("nomad_solver_bucket_occupancy", row["occupancy"],
                labels={"bucket": row["bucket"]})
    # Cross-eval batching economy: dispatch/eval totals per stack width
    # and the amortized per-eval device wall at that width.
    for width, row in stats.get("batch_widths", {}).items():
        b.counter("nomad_solver_batch_dispatches_total",
                  row["dispatches"], labels={"width": width})
        b.counter("nomad_solver_batch_evals_total",
                  row["evals"], labels={"width": width})
        b.gauge("nomad_solver_batch_device_ms_per_eval",
                row["device_ms_per_eval"], labels={"width": width})
    equiv = stats.get("equiv", {})
    for k in ("classes", "members", "copies", "rows_saved"):
        if k in equiv:
            b.counter(f"nomad_solver_equiv_{k}_total", equiv[k])
    for trigger, n in stats["compiles"]["by_trigger"].items():
        b.counter("nomad_solver_compiles_total", n,
                  labels={"trigger": trigger})


class RawResponse:
    """Non-JSON handler result (e.g. Prometheus text exposition): the
    dispatcher writes the body verbatim with the given content type."""

    __slots__ = ("body", "content_type")

    def __init__(self, body: bytes, content_type: str):
        self.body = body
        self.content_type = content_type


class _Streamed:
    """Sentinel handler result: the handler already wrote the response
    itself (SSE tailing) — the dispatcher must not write anything."""


class _Streamed:
    """Sentinel handler result: the handler already wrote the response
    itself (SSE tailing) — the dispatcher must not write anything."""


STREAMED = _Streamed()


class HTTPServer:
    """The agent's HTTP interface (http.go:25-120)."""

    def __init__(self, agent, host: str = "127.0.0.1", port: int = 4646,
                 logger: Optional[logging.Logger] = None):
        self.agent = agent
        self.logger = logger or logging.getLogger("nomad_tpu_torch.http")
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                api.logger.debug("http: " + fmt, *args)

            def _handle(self):
                api.dispatch(self)

            do_GET = do_PUT = do_POST = do_DELETE = _handle

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.addr = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="http-server"
        )

        # Route table (http.go:93-120)
        self.routes = [
            (r"^/v1/jobs$", self.jobs_request),
            (r"^/v1/job/(?P<job_id>[^/]+)$", self.job_request),
            (r"^/v1/job/(?P<job_id>[^/]+)/allocations$", self.job_allocations),
            (r"^/v1/job/(?P<job_id>[^/]+)/evaluations$", self.job_evaluations),
            (r"^/v1/job/(?P<job_id>[^/]+)/evaluate$", self.job_evaluate),
            (r"^/v1/nodes$", self.nodes_request),
            (r"^/v1/node/(?P<node_id>[^/]+)$", self.node_request),
            (r"^/v1/node/(?P<node_id>[^/]+)/allocations$", self.node_allocations),
            (r"^/v1/node/(?P<node_id>[^/]+)/evaluate$", self.node_evaluate),
            (r"^/v1/node/(?P<node_id>[^/]+)/drain$", self.node_drain),
            (r"^/v1/allocations$", self.allocs_request),
            (r"^/v1/allocation/(?P<alloc_id>[^/]+)$", self.alloc_request),
            (r"^/v1/evaluations$", self.evals_request),
            (r"^/v1/evaluation/(?P<eval_id>[^/]+)$", self.eval_request),
            (r"^/v1/evaluation/(?P<eval_id>[^/]+)/allocations$",
             self.eval_allocations),
            (r"^/v1/evaluation/(?P<eval_id>[^/]+)/trace$", self.eval_trace),
            (r"^/v1/evaluation/(?P<eval_id>[^/]+)/timeline$",
             self.eval_timeline),
            (r"^/v1/allocation/(?P<alloc_id>[^/]+)/timeline$",
             self.alloc_timeline),
            (r"^/v1/event/stream$", self.event_stream),
            (r"^/v1/agent/self$", self.agent_self),
            (r"^/v1/agent/slo$", self.agent_slo),
            (r"^/v1/agent/admission$", self.agent_admission),
            (r"^/v1/agent/express$", self.agent_express),
            (r"^/v1/agent/capacity$", self.agent_capacity),
            (r"^/v1/agent/raft$", self.agent_raft),
            (r"^/v1/agent/reads$", self.agent_reads),
            (r"^/v1/agent/profile$", self.agent_profile),
            (r"^/v1/agent/runtime$", self.agent_runtime),
            (r"^/v1/agent/solver$", self.agent_solver),
            (r"^/v1/agent/metrics$", self.agent_metrics),
            (r"^/v1/agent/traces$", self.agent_traces),
            (r"^/v1/agent/debug$", self.agent_debug),
            (r"^/v1/agent/debug/bundle$", self.agent_debug_bundle),
            (r"^/v1/agent/faults$", self.agent_faults),
            (r"^/v1/agent/logs$", self.agent_logs),
            (r"^/v1/agent/members$", self.agent_members),
            (r"^/v1/agent/servers$", self.agent_servers),
            (r"^/v1/agent/join$", self.agent_join),
            (r"^/v1/agent/force-leave$", self.agent_force_leave),
            (r"^/v1/status/leader$", self.status_leader),
            (r"^/v1/status/peers$", self.status_peers),
        ]
        # Each route's read-attribution key, by pattern.
        self._templates = {p: _route_template(p) for p, _h in self.routes}
        self.routes = [(re.compile(p), h) for p, h in self.routes]
        # Per-request read-attribution context (route template, lane,
        # hold/serve seam), threaded to the responders and _maybe_block
        # without touching every handler's signature: each request runs
        # on its own thread (ThreadingHTTPServer).
        self._local = threading.local()

    def start(self) -> None:
        self._thread.start()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- dispatch + envelope (http.go:147-226 wrap) --------------------------

    def dispatch(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(req.path)
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        for pattern, handler in self.routes:
            m = pattern.match(parsed.path)
            if m is None:
                continue
            ctx = {"template": self._templates[pattern.pattern],
                   "lane": "plain", "status": 200,
                   "bytes": 0, "hold_s": 0.0, "woke": None,
                   "consistency": LANE_DEFAULT, "role": None,
                   "read_meta": None}
            self._local.ctx = ctx
            t0 = time.monotonic()
            try:
                try:
                    if req.command == "GET":
                        # The consistency lane resolves BEFORE the
                        # handler: a refusal costs nothing, and a
                        # linearizable read touches no state until the
                        # local applied index reaches its read index.
                        self._enter_read_lane(req, query, ctx)
                    out, index = handler(req, query, **m.groupdict())
                except HTTPCodedError as e:
                    self._respond_error(req, e.code, str(e))
                except RejectError as e:
                    self._respond_reject(req, e)
                except KeyError as e:
                    # Endpoints raise KeyError for missing resources
                    self._respond_error(req, 404, str(e).strip("'\""))
                except (ValidationError, ValueError) as e:
                    self._respond_error(req, 400, str(e))
                except Exception as e:
                    self.logger.exception("http: request failed")
                    self._respond_error(req, 500, str(e))
                else:
                    if out is STREAMED:
                        pass  # SSE wrote its own body
                    elif isinstance(out, RawResponse):
                        self._respond_raw(req, out)
                    else:
                        self._respond_json(req, out, index)
            finally:
                self._local.ctx = None
                self._record_read(req, ctx, time.monotonic() - t0)
            return
        self._respond_error(req, 404, "not found")

    def _record_read(self, req, ctx: Dict[str, Any],
                     duration_s: float) -> None:
        """Fold one finished GET into the read observatory's recorder
        (no-op on writes, on a server-less agent, or with the observatory
        off: the knob gates recording, never headers)."""
        if req.command != "GET":
            return
        obs = self._observer("read_observatory")
        if obs is None:
            return
        rec = obs.recorder
        rec.record_request(ctx["template"], ctx["lane"], ctx["status"],
                           duration_s, ctx["bytes"])
        if ctx["lane"] == "blocking":
            rec.record_blocking(ctx["template"], ctx["hold_s"],
                                duration_s, bool(ctx["woke"]))

    def _observer(self, attr: str):
        """The server's observatory ``attr``, or None (no server, or that
        observatory disabled)."""
        server = getattr(self.agent, "server", None)
        obs = getattr(server, attr, None)
        if obs is None or not obs.config.enabled:
            return None
        return obs

    def _enter_read_lane(self, req, query: Dict[str, str],
                         ctx: Dict[str, Any]) -> None:
        """Resolve one GET's consistency lane (the reference QueryOptions
        AllowStale posture plus Consul's ``?consistent=``): ``?stale=`` /
        ``X-Nomad-Consistency: stale`` opts into bounded staleness
        (``?max_stale=`` ms tightens the server default), ``?consistent=``
        / ``X-Nomad-Consistency: linearizable`` asks for a read-index
        confirmed answer. ReadPath.enter may raise a typed retriable
        RejectError (stale bound exceeded, no confirmed read index),
        answered 429 with Retry-After. No-op on a client-only agent."""
        rp = getattr(getattr(self.agent, "server", None), "read_path", None)
        if rp is None:
            return
        hdr = (req.headers.get("X-Nomad-Consistency") or "").strip().lower()
        if hdr == LANE_LINEARIZABLE or "consistent" in query:
            lane = LANE_LINEARIZABLE
        elif hdr == LANE_STALE or "stale" in query:
            lane = LANE_STALE
        else:
            lane = LANE_DEFAULT
        max_stale_ms = None
        if query.get("max_stale"):
            try:
                max_stale_ms = float(query["max_stale"])
            except ValueError:
                raise HTTPCodedError(
                    400, f"invalid max_stale (ms): {query['max_stale']!r}")
        meta = rp.enter(lane, max_stale_ms)
        ctx["consistency"] = meta["lane"]
        ctx["role"] = meta["role"]
        ctx["read_meta"] = meta

    def _freshness_headers(self, req) -> None:
        """Stamp the response with read-freshness meta: the serving
        server's last-applied raft index, whether it currently knows a
        leader, and the response's staleness vs the leader commit index
        (in raft entries). Stamped on EVERY response — plain GETs,
        errors, and streams alike, not just blocking queries — so a
        consumer can always judge how fresh the state it read was (the
        follower-read contract). Headers stay the same with the read
        observatory off; only the recording below is knob-gated. Degrades
        to no headers on a server-less (client-only) agent."""
        server = getattr(self.agent, "server", None)
        raft = getattr(server, "raft", None)
        if raft is None:
            return
        applied = int(getattr(raft, "applied_index", 0) or 0)
        commit = int(getattr(raft, "commit_index", applied) or applied)
        age = max(commit - applied, 0)
        try:
            known_leader = bool(self.agent.leader_addr())
        except Exception:
            known_leader = False
        ctx = getattr(self._local, "ctx", None) or {}
        meta = ctx.get("read_meta") or {}
        req.send_header("X-Nomad-Applied-Index", str(applied))
        req.send_header("X-Nomad-LastIndex",
                        str(int(meta.get("applied_index", applied))))
        req.send_header("X-Nomad-Staleness", str(age))
        req.send_header("X-Nomad-KnownLeader",
                        "true" if known_leader else "false")
        # Measured leader-contact age in ms (0 on the leader): what a
        # stale-lane client compares with its bound. Omitted only when a
        # follower never heard from a leader.
        contact_ms = meta.get("last_contact_ms")
        if not meta:
            rp = getattr(server, "read_path", None)
            contact_ms = (rp.last_contact_ms() if rp is not None
                          else None)
        if contact_ms is not None:
            req.send_header("X-Nomad-LastContact",
                            str(int(round(contact_ms))))
        if meta.get("read_index") is not None:
            req.send_header("X-Nomad-Read-Index",
                            str(int(meta["read_index"])))
        if req.command == "GET":
            obs = self._observer("read_observatory")
            if obs is not None:
                obs.recorder.record_staleness(
                    age,
                    role=ctx.get("role") or "",
                    lane=ctx.get("consistency") or LANE_DEFAULT,
                )

    def _respond_json(self, req, out: Any, index: Optional[int]) -> None:
        body = json.dumps(to_dict(out)).encode()
        self._note_response(200, len(body))
        req.send_response(200)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(body)))
        if index is not None:
            # Query meta headers (http.go setMeta; known-leader and the
            # MEASURED last-contact age ride the uniform freshness stamp
            # below — the old hardcoded "0" here lied on followers)
            req.send_header("X-Nomad-Index", str(index))
        self._freshness_headers(req)
        req.end_headers()
        req.wfile.write(body)

    def _respond_raw(self, req, out: RawResponse) -> None:
        self._note_response(200, len(out.body))
        req.send_response(200)
        req.send_header("Content-Type", out.content_type)
        req.send_header("Content-Length", str(len(out.body)))
        self._freshness_headers(req)
        req.end_headers()
        req.wfile.write(out.body)

    def _note_response(self, status: int, nbytes: int) -> None:
        """Stamp the request's read context with what went out."""
        ctx = getattr(self._local, "ctx", None)
        if ctx is not None:
            ctx["status"] = status
            ctx["bytes"] = nbytes

    def _respond_error(self, req, code: int, message: str) -> None:
        body = message.encode()
        self._note_response(code, len(body))
        req.send_response(code)
        req.send_header("Content-Type", "text/plain")
        req.send_header("Content-Length", str(len(body)))
        self._freshness_headers(req)
        req.end_headers()
        req.wfile.write(body)

    def _respond_reject(self, req, e: RejectError) -> None:
        """Typed admission/backpressure rejection: 429 for client-paced
        reasons (rate lane empty, SLO shed — 'you, slow down'), 503 for
        server-capacity reasons (queue/watcher caps — 'everyone, later').
        The Retry-After header carries the hint in whole seconds (RFC
        7231 grammar); the JSON body keeps the float and the typed reason
        so the SDK retries with full precision."""
        code = 503 if e.reason in (REJECT_QUEUE_FULL,
                                   REJECT_WATCH_LIMIT) else 429
        body = json.dumps({
            "error": str(e),
            "reason": e.reason,
            "retry_after": e.retry_after,
        }).encode()
        self._note_response(code, len(body))
        req.send_response(code)
        req.send_header("Content-Type", "application/json")
        req.send_header("Retry-After",
                        str(max(1, math.ceil(e.retry_after))))
        req.send_header("Content-Length", str(len(body)))
        self._freshness_headers(req)
        req.end_headers()
        req.wfile.write(body)

    def _read_body(self, req) -> Dict:
        length = int(req.headers.get("Content-Length", 0))
        if length == 0:
            return {}
        try:
            return json.loads(req.rfile.read(length))
        except ValueError as e:
            raise HTTPCodedError(400, f"invalid JSON body: {e}")

    # -- blocking queries (http.go:228-250 parseWait + blockingRPC) ----------

    def _maybe_block(self, query: Dict[str, str], table: str) -> None:
        """Implements ?index=N&wait=D against the state watch: return when
        the table index passes N or the wait expires. The whole park is
        the request's ``hold`` stage in the read books; the rest of the
        handler is ``serve``."""
        min_index = int(query.get("index", 0))
        if min_index == 0:
            return
        # MaxQueryTime cap (rpc.go:283-291): client-supplied waits clamp
        # so a poll can never park unboundedly.
        wait = min(parse_duration(query.get("wait", "5m")), MAX_QUERY_TIME)
        ctx = getattr(self._local, "ctx", None)
        t0 = time.monotonic()
        woke = False
        end = t0 + wait
        try:
            while True:
                # Re-read per pass: a raft snapshot install rebinds
                # fsm.state, orphaning any watch parked on the previous
                # store.
                store = self.agent.server.state_store
                if store.get_index(table) > min_index:
                    woke = True
                    return
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return
                # register may raise a typed RejectError(WATCH_LIMIT) —
                # the dispatcher maps it to a 503 with Retry-After.
                ticket = store.watch.register([item_table(table)])
                try:
                    # Identity re-check closes the register-vs-rebind
                    # race; a rebind after registration fires notify_all
                    # on the old store, so a full-length wait is safe.
                    if (self.agent.server.state_store is store
                            and store.get_index(table) <= min_index):
                        fired = store.watch.wait(ticket, timeout=remaining)
                        if fired and store.get_index(table) <= min_index:
                            # Woken by a bucket-sharing neighbor, index
                            # unmoved: the spurious re-probe the
                            # coalesced registry trades for O(items)
                            # publishes.
                            store.watch.spurious_wakes += 1
                finally:
                    store.watch.unregister(ticket)
        finally:
            if ctx is not None:
                ctx["lane"] = "blocking"
                ctx["hold_s"] = time.monotonic() - t0
                ctx["woke"] = woke

    def _srv(self):
        if self.agent.server is None:
            raise HTTPCodedError(500, "no server running")
        return self.agent.server

    @staticmethod
    def _require_write(req) -> None:
        if req.command not in ("PUT", "POST"):
            raise HTTPCodedError(405, "method not allowed")

    @staticmethod
    def _client_id(req, query: Dict[str, str]) -> str:
        """Caller identity for per-client admission rate lanes: the
        ``X-Nomad-Client`` header (the SDK sets it) or ``?client_id=``.
        Empty = the shared anonymous lane."""
        return (req.headers.get("X-Nomad-Client")
                or query.get("client_id", "") or "")

    # -- job endpoints (command/agent/job_endpoint.go) -----------------------

    def jobs_request(self, req, query) -> Tuple[Any, int]:
        srv = self._srv()
        if req.command == "GET":
            self._maybe_block(query, "jobs")
            jobs = sorted(srv.state_store.jobs(), key=lambda j: j.id)
            jobs = _prefix_filter(jobs, query)
            return [j.stub() for j in jobs], srv.state_store.get_index("jobs")
        if req.command in ("PUT", "POST"):
            payload = self._read_body(req)
            job = from_dict(Job, payload.get("job", payload))
            eval_id, index = srv.job_register(
                job, client_id=self._client_id(req, query))
            return {"eval_id": eval_id, "eval_create_index": index,
                    "job_modify_index": index, "index": index}, index
        raise HTTPCodedError(405, "method not allowed")

    def job_request(self, req, query, job_id: str) -> Tuple[Any, int]:
        srv = self._srv()
        if req.command == "GET":
            self._maybe_block(query, "jobs")
            job = srv.state_store.job_by_id(job_id)
            if job is None:
                raise HTTPCodedError(404, "job not found")
            return job, srv.state_store.get_index("jobs")
        if req.command in ("PUT", "POST"):
            payload = self._read_body(req)
            job = from_dict(Job, payload.get("job", payload))
            if job.id != job_id:
                raise HTTPCodedError(400, "job ID does not match request path")
            eval_id, index = srv.job_register(
                job, client_id=self._client_id(req, query))
            return {"eval_id": eval_id, "index": index}, index
        if req.command == "DELETE":
            eval_id, index = srv.job_deregister(job_id)
            return {"eval_id": eval_id, "index": index}, index
        raise HTTPCodedError(405, "method not allowed")

    def job_allocations(self, req, query, job_id: str) -> Tuple[Any, int]:
        srv = self._srv()
        self._maybe_block(query, "allocs")
        allocs = srv.state_store.allocs_by_job(job_id)
        return [a.stub() for a in allocs], srv.state_store.get_index("allocs")

    def job_evaluations(self, req, query, job_id: str) -> Tuple[Any, int]:
        srv = self._srv()
        self._maybe_block(query, "evals")
        return (
            srv.state_store.evals_by_job(job_id),
            srv.state_store.get_index("evals"),
        )

    def job_evaluate(self, req, query, job_id: str) -> Tuple[Any, int]:
        self._require_write(req)
        srv = self._srv()
        eval_id, index = srv.job_evaluate(
            job_id, client_id=self._client_id(req, query))
        return {"eval_id": eval_id, "index": index}, index

    # -- node endpoints ------------------------------------------------------

    def nodes_request(self, req, query) -> Tuple[Any, int]:
        srv = self._srv()
        self._maybe_block(query, "nodes")
        nodes = sorted(srv.state_store.nodes(), key=lambda n: n.id)
        nodes = _prefix_filter(nodes, query)
        return [n.stub() for n in nodes], srv.state_store.get_index("nodes")

    def node_request(self, req, query, node_id: str) -> Tuple[Any, int]:
        srv = self._srv()
        self._maybe_block(query, "nodes")
        node = srv.state_store.node_by_id(node_id)
        if node is None:
            raise HTTPCodedError(404, "node not found")
        return node, srv.state_store.get_index("nodes")

    def node_allocations(self, req, query, node_id: str) -> Tuple[Any, int]:
        srv = self._srv()
        self._maybe_block(query, "allocs")
        allocs = srv.state_store.allocs_by_node(node_id)
        return allocs, srv.state_store.get_index("allocs")

    def node_evaluate(self, req, query, node_id: str) -> Tuple[Any, int]:
        self._require_write(req)
        srv = self._srv()
        reply = srv.node_evaluate(node_id)
        return reply, reply.get("index", 0)

    def node_drain(self, req, query, node_id: str) -> Tuple[Any, int]:
        self._require_write(req)
        srv = self._srv()
        enable = query.get("enable", "").lower() in ("1", "true")
        if "enable" not in query:
            raise HTTPCodedError(400, "missing drain mode")
        reply = srv.node_update_drain(node_id, enable)
        return reply, reply.get("index", 0)

    # -- alloc + eval endpoints ----------------------------------------------

    def allocs_request(self, req, query) -> Tuple[Any, int]:
        srv = self._srv()
        self._maybe_block(query, "allocs")
        allocs = sorted(srv.state_store.allocs(), key=lambda a: a.id)
        allocs = _prefix_filter(allocs, query)
        return [a.stub() for a in allocs], srv.state_store.get_index("allocs")

    def alloc_request(self, req, query, alloc_id: str) -> Tuple[Any, int]:
        srv = self._srv()
        self._maybe_block(query, "allocs")
        alloc = srv.state_store.alloc_by_id(alloc_id)
        if alloc is None:
            raise HTTPCodedError(404, "alloc not found")
        return alloc, srv.state_store.get_index("allocs")

    def evals_request(self, req, query) -> Tuple[Any, int]:
        srv = self._srv()
        self._maybe_block(query, "evals")
        evals = sorted(srv.state_store.evals(), key=lambda e: e.id)
        evals = _prefix_filter(evals, query)
        return evals, srv.state_store.get_index("evals")

    def eval_request(self, req, query, eval_id: str) -> Tuple[Any, int]:
        srv = self._srv()
        self._maybe_block(query, "evals")
        ev = srv.state_store.eval_by_id(eval_id)
        if ev is None:
            raise HTTPCodedError(404, "eval not found")
        return ev, srv.state_store.get_index("evals")

    def eval_allocations(self, req, query, eval_id: str) -> Tuple[Any, int]:
        srv = self._srv()
        self._maybe_block(query, "allocs")
        allocs = srv.state_store.allocs_by_eval(eval_id)
        return [a.stub() for a in allocs], srv.state_store.get_index("allocs")

    def eval_trace(self, req, query, eval_id: str) -> Tuple[Any, Optional[int]]:
        """Per-evaluation trace: the span tree recorded across broker →
        worker → solver → plan applier → FSM (nomad_tpu_torch.trace).
        ``?format=chrome`` returns Chrome trace-event JSON that loads
        straight into Perfetto."""
        tracer = trace.get_tracer()
        if query.get("format") == "chrome":
            doc = tracer.chrome_trace(eval_id)
            if doc is None:
                raise HTTPCodedError(404, "no trace for evaluation")
            return doc, None
        spans = tracer.get_trace(eval_id)
        if spans is None:
            raise HTTPCodedError(404, "no trace for evaluation")
        return {"eval_id": eval_id, "spans": spans}, None

    def eval_timeline(self, req, query, eval_id: str) -> Tuple[Any, Optional[int]]:
        """Per-evaluation lifecycle timeline (nomad_tpu_torch.lifecycle):
        the submit→placed(→running) stage decomposition stitched from the
        retained trace spans and the server's event ring. With tracing
        off (or the trace evicted) the stages are all ``unattributed``,
        but the end-to-end anchors still serve."""
        srv = self._srv()
        tl = lifecycle.stitch_from_server(srv, eval_id)
        if tl is None:
            raise HTTPCodedError(404, "no timeline for evaluation")
        return tl.to_dict(), None

    def alloc_timeline(self, req, query, alloc_id: str) -> Tuple[Any, Optional[int]]:
        """Per-allocation timeline: the alloc's evaluation timeline (the
        granularity plans, columnar blocks and traces share), stamped
        with the alloc id."""
        srv = self._srv()
        alloc = srv.state_store.alloc_by_id(alloc_id)
        if alloc is None:
            raise HTTPCodedError(404, "alloc not found")
        if not alloc.eval_id:
            raise HTTPCodedError(404, "alloc has no evaluation")
        tl = lifecycle.stitch_from_server(srv, alloc.eval_id)
        if tl is None:
            raise HTTPCodedError(404, "no timeline for allocation")
        out = tl.to_dict()
        out["alloc_id"] = alloc_id
        return out, None

    # -- event stream (reference: nomad/stream, /v1/event/stream) ------------

    def event_stream(self, req, query) -> Tuple[Any, Optional[int]]:
        """Cluster event stream (nomad_tpu_torch.events).

        Default: one JSON page of events with index > ``?index=N``
        (0 returns the whole retained buffer immediately), blocking-query
        semantics when N > 0 — the response long-polls until a newer
        event lands or ``?wait=`` lapses. ``?topic=T`` / ``?topic=T:key``
        filter (repeatable, OR-ed). Body carries ``index`` (the resume
        cursor) and ``truncated`` (the cursor fell off the bounded ring —
        re-list). ``?format=sse`` (or Accept: text/event-stream) switches
        to live Server-Sent-Events tailing instead."""
        srv = self._srv()
        broker = srv.fsm.events
        # Multi-valued params: the dispatch envelope collapses to first
        # value, and topic filters are legitimately repeatable.
        topics = parse_qs(urlparse(req.path).query).get("topic", [])
        tfilter = events_mod.TopicFilter(topics)
        try:
            min_index = int(query.get("index", 0))
        except ValueError:
            raise HTTPCodedError(400, "invalid index")
        accept = req.headers.get("Accept") or ""
        if query.get("format") == "sse" or "text/event-stream" in accept:
            self._stream_sse(req, broker, tfilter, min_index, query)
            return STREAMED, None
        wait = min(parse_duration(query.get("wait", "60s")), MAX_QUERY_TIME)

        def run(b):
            idx, evs, truncated = b.events_after(min_index, tfilter)
            return idx, {
                "index": idx,
                "events": [e.to_dict() for e in evs],
                "truncated": truncated,
            }

        if min_index <= 0:
            # Non-blocking list (the _maybe_block convention): ?index=0
            # returns the retained buffer immediately — on an empty
            # broker too, where the index probe (0 > 0) would otherwise
            # park the poll.
            index, out = run(broker)
            return out, index
        ctx = getattr(self._local, "ctx", None)
        t0 = time.monotonic()
        index, out = blocking_query(
            get_store=lambda: broker,
            items=lambda b: tfilter.watch_items(),
            run=run,
            min_index=min_index,
            timeout=wait,
            max_timeout=MAX_QUERY_TIME,
            # Filtered probe: wake/return only when a potentially
            # matching event landed, not on every unrelated publish.
            index_of=lambda b: b.index_for(tfilter),
        )
        if ctx is not None:
            # The blocking_query wall (park + index probes) is the hold
            # stage; serialization back in the dispatcher is serve.
            ctx["lane"] = "blocking"
            ctx["hold_s"] = time.monotonic() - t0
            ctx["woke"] = index > min_index
        return out, index

    def _stream_sse(self, req, broker, tfilter, min_index, query) -> None:
        """SSE framing for live tailing: one frame per event
        (``event:`` = type, ``id:`` = index, ``data:`` = the JSON body),
        a ``Truncated`` frame first when the resume cursor fell off the
        ring, and ``: heartbeat`` comments while idle so proxies don't
        reap the connection. Runs until the client disconnects or
        ``?wait=`` (0 = tail forever) lapses."""
        # Validate everything BEFORE the status line goes out: once the
        # 200 + headers are written, an exception would make the
        # dispatcher write a second response into the open SSE body.
        raw_wait = query.get("wait", "")
        try:
            # "0" and absent both mean tail-forever (parse_duration needs
            # a unit on non-empty strings, so map the bare zero itself).
            wait = 0.0 if raw_wait in ("", "0") else parse_duration(raw_wait)
        except Exception:
            raise HTTPCodedError(400, "invalid wait duration")
        ctx = getattr(self._local, "ctx", None)
        if ctx is not None:
            ctx["lane"] = "sse"
        obs = self._observer("read_observatory")
        rec = obs.recorder if obs is not None else None

        def _w(data: bytes) -> None:
            req.wfile.write(data)
            if ctx is not None:
                ctx["bytes"] += len(data)

        req.send_response(200)
        req.send_header("Content-Type", "text/event-stream")
        req.send_header("Cache-Control", "no-cache")
        req.send_header("Connection", "close")
        self._freshness_headers(req)
        req.end_headers()
        deadline = time.monotonic() + wait if wait > 0 else None
        cursor = min_index
        if rec is not None:
            rec.sse_session_start()
        try:
            while True:
                idx, evs, truncated = broker.events_after(cursor, tfilter)
                if truncated:
                    # Every time the cursor falls off the ring — not just
                    # on the first page: a tail that lags a burst larger
                    # than the ring mid-stream has lost events too.
                    if rec is not None:
                        rec.sse_truncated()
                    _w(
                        b"event: Truncated\ndata: "
                        + json.dumps({"resume_index": cursor,
                                      "horizon": broker.horizon()}).encode()
                        + b"\n\n"
                    )
                for e in evs:
                    frame = (
                        f"event: {e.type}\nid: {e.index}\n"
                        f"data: {json.dumps(e.to_dict())}\n\n"
                    )
                    _w(frame.encode())
                req.wfile.flush()
                cursor = idx
                if rec is not None and evs:
                    # Session lag behind the broker head for this filter,
                    # sampled as the batch goes out.
                    rec.sse_delivered(
                        len(evs),
                        max(broker.index_for(tfilter) - cursor, 0))
                remaining = (
                    deadline - time.monotonic() if deadline is not None
                    else 15.0
                )
                if deadline is not None and remaining <= 0:
                    return
                try:
                    ticket = broker.watch.register(tfilter.watch_items())
                except RejectError:
                    # Watcher cap mid-stream: the 200 already went out, so
                    # closing the tail is the only honest backpressure.
                    return
                try:
                    if broker.index_for(tfilter) <= cursor:
                        fired = broker.watch.wait(
                            ticket, timeout=min(15.0, remaining))
                    else:
                        fired = True
                finally:
                    broker.watch.unregister(ticket)
                if not fired:
                    # Keep-alive comment; also how a dead client is
                    # detected while the stream is idle.
                    _w(b": heartbeat\n\n")
                    req.wfile.flush()
                    if rec is not None:
                        rec.sse_heartbeat()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away — the normal end of a tail
        finally:
            if rec is not None:
                rec.sse_session_end()

    # -- agent + status endpoints --------------------------------------------

    def agent_self(self, req, query) -> Tuple[Any, Optional[int]]:
        return self.agent.self_info(), None

    def agent_slo(self, req, query) -> Tuple[Any, Optional[int]]:
        """Live SLO state (nomad_tpu_torch.slo): every objective's
        threshold against its observed percentiles, the rolling error
        budget and the burn rate."""
        srv = self._srv()
        monitor = getattr(srv, "slo_monitor", None)
        if monitor is None:
            raise HTTPCodedError(404, "SLO monitoring disabled "
                                      "(empty slo_objectives)")
        return monitor.snapshot(), None

    def agent_admission(self, req, query) -> Tuple[Any, Optional[int]]:
        """Admission front-door state (server/admission.py): decision
        counters by lane and reason, the rate-lane table, the recent
        rejections, the SLO burn coupling, and the queue and watcher caps
        (what an operator reads when clients report 429/503s)."""
        srv = self._srv()
        admission = getattr(srv, "admission", None)
        if admission is None:
            raise HTTPCodedError(404, "admission controller not running")
        out = admission.snapshot()
        out["queues"] = {
            "eval_pending": srv.eval_broker.pending_total(),
            "eval_pending_cap": srv.config.eval_pending_cap,
            "plan_queue_depth": srv.plan_queue.depth(),
            "plan_queue_cap": srv.config.plan_queue_cap,
            "watchers": srv.state_store.watch.stats(),
            "event_watchers": srv.fsm.events.watch.stats(),
        }
        return out, None

    def agent_express(self, req, query) -> Tuple[Any, Optional[int]]:
        """Express lane state (server/express.py): the lane's books
        (placed, committed, bounced, reconciled, fallbacks by reason), the
        reservation ledger, in-line place-latency quantiles and the
        recent committer outcomes. Answers lane-off too (enabled=false)."""
        srv = self._srv()
        express = getattr(srv, "express_lane", None)
        if express is None:
            raise HTTPCodedError(404, "express lane not available")
        return express.snapshot(), None

    def agent_capacity(self, req, query) -> Tuple[Any, Optional[int]]:
        """Capacity observatory state (capacity.py): per-dim utilization,
        bin-pack density, per-lane usage, fragmentation histograms and
        stranded-capacity % against the reference shapes. The accountant
        is rolled forward first, so the body reflects the store now.
        ``?format=prometheus`` serves just the capacity families."""
        acct = self._observer("capacity_accountant")
        if acct is None:
            raise HTTPCodedError(404, "capacity observatory not running "
                                      "(no server, or capacity "
                                      "{ enabled = false })")
        acct.refresh()
        if query.get("format") == "prometheus":
            return self._prometheus(self._capacity_prometheus), None
        return acct.snapshot(), None

    def agent_raft(self, req, query) -> Tuple[Any, Optional[int]]:
        """Raft & recovery observatory state (raft_observe.py): write-path
        stage attribution per msg_type, per-follower lag, commit-advance
        rate, the log/snapshot economy and the restart-replay recovery
        timeline. The node's books are drained first.
        ``?format=prometheus`` serves just the raft families."""
        obs = self._observer("raft_observatory")
        if obs is None:
            raise HTTPCodedError(404, "raft observatory not running "
                                      "(no server, or raft_observe "
                                      "{ enabled = false })")
        obs.refresh()
        if query.get("format") == "prometheus":
            return self._prometheus(self._raft_prometheus), None
        return obs.snapshot(), None

    @staticmethod
    def _prometheus(*appenders) -> "RawResponse":
        """One text exposition from the given family appenders, over one
        shared ``telemetry.PromText``."""
        b = telemetry.PromText()
        for append in appenders:
            append(b)
        return RawResponse(b.text().encode(), "text/plain; version=0.0.4")

    def _summary(self, attr: str) -> Optional[Dict[str, Any]]:
        obs = self._observer(attr)
        return obs.summary() if obs is not None else None

    def agent_reads(self, req, query) -> Tuple[Any, Optional[int]]:
        """Read-path books (read_observe.py): per-route-template serving
        attribution, the blocking hold/serve split, SSE sessions, the
        watch registries' wake economy and the response staleness, with
        the read plane's per-(role, lane) books under ``read_path``. The
        watch sample is refreshed before answering. ``?format=prometheus``
        serves just the read families."""
        obs = self._observer("read_observatory")
        if obs is None:
            raise HTTPCodedError(404, "read observatory not running "
                                      "(no server, or reads "
                                      "{ enabled = false })")
        obs.refresh()
        if query.get("format") == "prometheus":
            return self._prometheus(self._read_prometheus), None
        body = obs.snapshot()
        rp = getattr(getattr(self.agent, "server", None), "read_path", None)
        if rp is not None:
            body["read_path"] = rp.snapshot()
        return body, None

    def _raft_prometheus(self, b: "telemetry.PromText") -> None:
        """Raft observatory: replication-state and log-economy gauges,
        append/compaction counters, per-follower lag, and the write-path
        quantiles per msg_type (submit→applied total + per-stage p95)."""
        obs = self._observer("raft_observatory")
        if obs is None:
            return
        snap = obs.snapshot()
        core = snap["raft"]
        for k in ("commit_index", "applied_index", "last_log_index",
                  "inflight_writes"):
            if k in core:
                b.gauge(f"nomad_raft_{k}", core[k])
        for k in ("commit_advances",):
            if k in core:
                b.counter(f"nomad_raft_{k}_total", core[k])
        log = snap["log"]
        if log:
            b.gauge("nomad_raft_log_entries", log["entries"])
            b.gauge("nomad_raft_log_bytes", log["bytes"])
            b.counter("nomad_raft_entries_appended_total",
                      log["appended_entries"])
            b.counter("nomad_raft_bytes_appended_total",
                      log["appended_bytes"])
            b.counter("nomad_raft_entries_truncated_total",
                      log["truncated_entries"])
        snapshot = snap["snapshot"]
        if snapshot:
            b.gauge("nomad_raft_snapshot_index", snapshot["index"])
            b.gauge("nomad_raft_snapshot_bytes", snapshot["last_bytes"])
            b.gauge("nomad_raft_snapshot_disk_bytes",
                    snapshot["disk_bytes"])
            b.counter("nomad_raft_compactions_total",
                      snapshot["compactions"])
            b.counter("nomad_raft_compaction_wall_ms_total",
                      snapshot["compaction_wall_ms"])
            b.counter("nomad_raft_snapshot_installs_total",
                      snapshot["installs_received"])
        b.gauge("nomad_raft_commit_advance_entries_per_s",
                snap["replication"]["commit_advance"]["entries_per_s"])
        for pid, peer in snap["replication"]["peers"].items():
            b.gauge("nomad_raft_peer_lag_entries", peer["lag_entries"],
                    labels={"peer": pid})
            if peer.get("last_ack_age_s") is not None:
                b.gauge("nomad_raft_peer_ack_age_seconds",
                        peer["last_ack_age_s"], labels={"peer": pid})
        for msg_type, books in snap["write_path"].items():
            b.counter("nomad_raft_write_entries_total", books["count"],
                      labels={"msg_type": msg_type})
            b.counter("nomad_raft_write_bytes_total",
                      books["bytes_total"], labels={"msg_type": msg_type})
            for q in ("p50", "p95", "p99"):
                b.gauge("nomad_raft_write_ms", books["total_ms"][q],
                        labels={"msg_type": msg_type, "quantile": q})
            for stage, agg in books["stages_ms"].items():
                b.gauge("nomad_raft_write_stage_p95_ms", agg["p95"],
                        labels={"msg_type": msg_type, "stage": stage})
        recovery = snap["recovery"]
        if recovery.get("cold_start"):
            b.gauge("nomad_raft_recovery_entries_replayed",
                    recovery.get("entries_replayed", 0))
            for k in ("snapshot_restore_ms", "replay_wall_ms",
                      "time_to_leader_ms", "time_to_serving_ms"):
                if recovery.get(k) is not None:
                    b.gauge(f"nomad_raft_recovery_{k}", recovery[k])


    def _read_prometheus(self, b: "telemetry.PromText") -> None:
        """Read observatory: per-route request/byte counters + latency
        quantile gauges, the blocking hold/serve stage partition, SSE
        session books, the watch-registry wake economy, and the
        response-staleness distribution."""
        obs = self._observer("read_observatory")
        if obs is None:
            return
        snap = obs.snapshot()
        for route, books in snap["endpoints"].items():
            for lane, n in books["lanes"].items():
                if n:
                    b.counter("nomad_read_requests_total", n,
                              labels={"route": route, "lane": lane})
            b.counter("nomad_read_errors_total", books["errors"],
                      labels={"route": route})
            b.counter("nomad_read_bytes_total", books["bytes_total"],
                      labels={"route": route})
            for q in ("p50", "p95", "p99"):
                b.gauge("nomad_read_latency_ms", books["latency_ms"][q],
                        labels={"route": route, "quantile": q})
        for route, books in snap["blocking"].items():
            b.counter("nomad_read_blocking_wakes_total", books["wakes"],
                      labels={"route": route})
            b.counter("nomad_read_blocking_timeouts_total",
                      books["timeouts"], labels={"route": route})
            for stage in ("hold", "serve"):
                b.gauge("nomad_read_blocking_stage_p95_ms",
                        books[stage + "_ms"]["p95"],
                        labels={"route": route, "stage": stage})
        sse = snap["sse"]
        b.gauge("nomad_read_sse_active", sse["active"])
        b.counter("nomad_read_sse_sessions_total", sse["started"])
        b.counter("nomad_read_sse_frames_total", sse["frames"])
        b.counter("nomad_read_sse_truncations_total", sse["truncations"])
        b.counter("nomad_read_sse_heartbeats_total", sse["heartbeats"])
        for q in ("p50", "p95", "p99"):
            b.gauge("nomad_read_sse_lag_entries", sse["lag_entries"][q],
                    labels={"quantile": q})
        for registry, w in snap["watch"].items():
            labels = {"registry": registry}
            b.gauge("nomad_read_watchers", w["watchers"], labels=labels)
            b.gauge("nomad_read_watchers_peak", w["peak_watchers"],
                    labels=labels)
            b.gauge("nomad_read_watch_bucket_max",
                    w["bucket_max_watchers"], labels=labels)
            b.counter("nomad_read_watch_notifies_total", w["notifies"],
                      labels=labels)
            b.counter("nomad_read_watch_wakes_total",
                      w["wakes_delivered"], labels=labels)
            b.counter("nomad_read_watch_spurious_total",
                      w["spurious_wakes"], labels=labels)
            b.gauge("nomad_read_watch_park_depth", w["multi_waiters"],
                    labels=labels)
        fresh = snap["freshness"]
        b.gauge("nomad_read_applied_index", fresh["applied_index"])
        b.gauge("nomad_read_commit_index", fresh["commit_index"])
        b.counter("nomad_read_responses_stamped_total",
                  fresh["responses_stamped"])
        for q in ("p50", "p95", "p99"):
            b.gauge("nomad_read_staleness_entries",
                    fresh["staleness_entries"][q],
                    labels={"quantile": q})
        for role, lanes in fresh.get("by_role", {}).items():
            for lane, split in lanes.items():
                b.counter("nomad_read_lane_responses_total",
                          split["count"],
                          labels={"role": role, "lane": lane})
                for q in ("p50", "p95", "p99"):
                    b.gauge("nomad_read_lane_staleness_entries",
                            split["staleness_entries"][q],
                            labels={"role": role, "lane": lane,
                                    "quantile": q})
        rp = getattr(getattr(self.agent, "server", None),
                     "read_path", None)
        if rp is not None:
            rps = rp.snapshot()
            for role, lanes in rps["served"].items():
                for lane, n in lanes.items():
                    if n:
                        b.counter("nomad_read_path_served_total", n,
                                  labels={"role": role, "lane": lane})
            b.counter("nomad_read_path_stale_refused_total",
                      rps["stale"]["refused"])
            b.counter("nomad_read_path_linear_refused_total",
                      rps["linearizable"]["refused"])
            b.gauge("nomad_read_path_follower_serve_share",
                    rps["follower_serve_share"])
            for q in ("p50", "p95", "p99"):
                b.gauge("nomad_read_path_stale_age_ms",
                        rps["stale"]["age_ms"][q],
                        labels={"quantile": q})
            ri = rps["linearizable"]["read_index"]
            for k in ("calls", "lease_hits", "quorum_confirms",
                      "refused"):
                b.counter(f"nomad_read_index_{k}_total", ri[k])

    def agent_profile(self, req, query) -> Tuple[Any, Optional[int]]:
        """Continuous sampling profiler (profile_observe.py):
        collapsed-stack aggregates per thread role, per-subsystem wall
        shares, and the sampling schedule. Formats: default JSON
        (profiler view), ``?format=collapsed`` is flamegraph.pl /
        inferno collapsed-stack text, ``?format=speedscope`` is a
        https://speedscope.app sampled-profile document — both render
        the live agent's profile with zero external tooling in the
        loop."""
        obs = self._observer("runtime_observatory")
        if obs is None:
            raise HTTPCodedError(404, "runtime observatory not running "
                                      "(no server, or profile "
                                      "{ enabled = false })")
        fmt = query.get("format")
        if fmt == "collapsed":
            return RawResponse(
                obs.collapsed().encode(), "text/plain; charset=utf-8"
            ), None
        if fmt == "speedscope":
            return RawResponse(
                json.dumps(obs.speedscope(), indent=2).encode(),
                "application/json",
            ), None
        return obs.profile_view(), None

    def agent_runtime(self, req, query) -> Tuple[Any, Optional[int]]:
        """Runtime economy ledgers (profile_observe.py): the
        lock-contention table (when telemetry{lock_watchdog} is on),
        and the byte-economy ledger — mirror device buffers by
        bucket x dtype with the measured-per-row 1M-node projection,
        every bounded ring, state-store footprint, observatory tables,
        and RSS. The handler refreshes the ledger before answering so
        the body reflects the process NOW, not the last poll tick.
        ``?format=prometheus`` serves just the runtime + lock families
        as text exposition."""
        obs = self._observer("runtime_observatory")
        if obs is None:
            raise HTTPCodedError(404, "runtime observatory not running "
                                      "(no server, or profile "
                                      "{ enabled = false })")
        obs.refresh()
        if query.get("format") == "prometheus":
            return self._prometheus(self._profile_prometheus,
                                    self._lock_prometheus), None
        return obs.runtime_view(), None

    def _lock_stats(self) -> Optional[Dict[str, Any]]:
        """Live lock watchdog books, or None when the
        telemetry{lock_watchdog} knob is off — installation is
        process-global, so this reads the module registry rather than
        any agent field."""
        wd = telemetry.active_lock_watchdog()
        return wd.stats() if wd is not None else None

    def _profile_prometheus(self, b: "telemetry.PromText") -> None:
        """Profiler + byte-economy families: per-role wall shares and
        sample counts, RSS, tracked bytes, and the mirror ledger with
        its projected million-row footprint."""
        obs = self._observer("runtime_observatory")
        if obs is None:
            return
        view = obs.runtime_view()
        prof = obs.profile_view()["profiler"]
        b.counter("nomad_profile_samples_total", prof["samples"])
        b.counter("nomad_profile_stack_overflow_total",
                  prof["stack_overflow"])
        for role, books in prof["roles"].items():
            b.gauge("nomad_profile_role_share", books["wall_share"],
                    labels={"role": role})
            b.counter("nomad_profile_role_samples_total",
                      books["samples"], labels={"role": role})
        ledger = view["bytes"]
        rss = ledger.get("rss") or {}
        if rss.get("current_bytes") is not None:
            b.gauge("nomad_runtime_rss_bytes", rss["current_bytes"])
        if rss.get("peak_bytes") is not None:
            b.gauge("nomad_runtime_rss_peak_bytes", rss["peak_bytes"])
        b.gauge("nomad_runtime_tracked_bytes",
                ledger.get("tracked_bytes", 0))
        mirror = ledger.get("mirror") or {}
        if "total_bytes" in mirror:
            b.gauge("nomad_runtime_mirror_bytes", mirror["total_bytes"])
            b.gauge("nomad_runtime_mirror_rows", mirror.get("rows", 0))
        if mirror.get("per_row_bytes") is not None:
            b.gauge("nomad_runtime_mirror_per_row_bytes",
                    mirror["per_row_bytes"])
        if mirror.get("projected_1m_bytes") is not None:
            b.gauge("nomad_runtime_mirror_projected_1m_bytes",
                    mirror["projected_1m_bytes"])
        for ring, books in (ledger.get("rings") or {}).items():
            b.gauge("nomad_runtime_ring_bytes",
                    books.get("approx_bytes", 0), labels={"ring": ring})

    def _lock_prometheus(self, b: "telemetry.PromText") -> None:
        """Lock watchdog contention table: acquisition/contention
        counters, total + quantile wait, and hold p95 per lock id."""
        stats = self._lock_stats()
        if not stats:
            return
        b.gauge("nomad_lock_watchdog_installed",
                1 if stats["installed"] else 0)
        b.gauge("nomad_lock_order_violations", stats["violations"])
        for row in stats["contention"]:
            labels = {"lock": row["lock"]}
            b.counter("nomad_lock_acquisitions_total",
                      row["acquisitions"], labels=labels)
            b.counter("nomad_lock_contended_total", row["contended"],
                      labels=labels)
            b.counter("nomad_lock_wait_ms_total", row["wait_total_ms"],
                      labels=labels)
            for q in ("p50", "p95", "p99"):
                b.gauge("nomad_lock_wait_ms", row["wait_ms"][q],
                        labels={"lock": row["lock"], "quantile": q})
            b.gauge("nomad_lock_hold_ms", row["hold_ms"]["p95"],
                    labels={"lock": row["lock"], "quantile": "p95"})

    def agent_solver(self, req, query) -> Tuple[Any, Optional[int]]:
        """Device-solve efficiency panel (tpu/solver.py SOLVER_PANEL):
        per-solve padding economy, bucket-occupancy histograms,
        first-dispatch attribution (shape key + trigger + wall),
        device-time-per-placement — next to the mirror cache's
        delta-roll-vs-full-rebuild economy with wall costs, and the
        coalescer's dispatch stacking. The panel zeroes honestly when no
        solve ever dispatched. The port adds the mirror cache's byte
        ledger under ``mirror_cache.byte_ledger``; its ``jit_trace`` is
        empty (nothing is jit-traced)."""
        out: Dict[str, Any] = {
            "panel": _solver_panel_stats(),
            "mirror_cache": _mirror_cache_stats(),
        }
        if "error" not in out["mirror_cache"]:
            from nomad_tpu_torch.tpu.mirror import GLOBAL_MIRROR_CACHE

            out["mirror_cache"]["byte_ledger"] = \
                GLOBAL_MIRROR_CACHE.byte_ledger()
        try:
            from nomad_tpu_torch.ops.coalesce import GLOBAL_SOLVER

            out["coalescer"] = {
                "dispatches": GLOBAL_SOLVER.dispatches,
                "coalesced": GLOBAL_SOLVER.coalesced,
            }
        except Exception as e:  # pragma: no cover - import breakage only
            out["coalescer"] = {"error": str(e)}
        # nomad_tpu's jit retrace counters (its ops/fit.py emits
        # solver.jit_trace.*); the port traces nothing, so this is empty.
        sink = getattr(self.agent, "inmem_sink", None)
        if sink is not None:
            counters, _samples = sink.cumulative()
            out["jit_trace"] = {
                name: int(v[0]) for name, v in sorted(counters.items())
                if "jit_trace" in name
            }
        else:
            out["jit_trace"] = None
        return out, None

    def agent_metrics(self, req, query) -> Tuple[Any, Optional[int]]:
        """Live InmemSink aggregates. Default JSON (all retained
        intervals, plus the device-mirror cache's delta economy);
        ``?format=prometheus`` serves text exposition for a Prometheus
        scrape (pull model — the reference only had the SIGUSR1 dump and
        push sinks). Every subsystem appender rides ONE shared
        telemetry.PromText builder, so names/labels sanitize in one
        place and duplicate/conflicting TYPE lines are structurally
        impossible."""
        sink = getattr(self.agent, "inmem_sink", None)
        if sink is None:
            raise HTTPCodedError(404, "telemetry sink not initialized")
        if query.get("format") == "prometheus":
            subsystems = self._prometheus(
                _mirror_prometheus, _plan_pipeline_prometheus,
                _trace_prometheus, self._admission_prometheus,
                self._express_prometheus, self._capacity_prometheus,
                self._raft_prometheus, self._read_prometheus,
                self._profile_prometheus, self._lock_prometheus,
                _solver_prometheus)
            return RawResponse(
                telemetry.prometheus_text(sink).encode() + subsystems.body,
                subsystems.content_type), None
        return {"timestamp": trace.now(), "intervals": sink.data(),
                "mirror_cache": _mirror_cache_stats(),
                "plan_pipeline": _plan_pipeline_stats(),
                "admission": self._admission_stats(),
                "express": self._express_stats(),
                "capacity": self._summary("capacity_accountant"),
                "raft": self._summary("raft_observatory"),
                "reads": self._summary("read_observatory"),
                "runtime": self._summary("runtime_observatory"),
                "locks": self._lock_stats(),
                "solver_panel": _solver_panel_stats(),
                "trace": trace.get_tracer().stats()}, None

    def _admission_stats(self) -> Optional[Dict[str, Any]]:
        """Admission decision totals for the metrics JSON body (None when
        no server / controller runs — the metrics endpoint must answer on
        a client-only agent too)."""
        server = getattr(self.agent, "server", None)
        admission = getattr(server, "admission", None)
        return admission.summary() if admission is not None else None

    def _admission_prometheus(self, b: "telemetry.PromText") -> None:
        """Admission counters: admitted/rejected totals plus the
        typed-rejection split."""
        stats = self._admission_stats()
        if not stats:
            return
        for k in ("admitted", "rejected"):
            b.counter(f"nomad_admission_{k}_total", stats[k])
        for reason, n in sorted(stats.get("by_reason", {}).items()):
            b.counter("nomad_admission_rejected_reason_total", n,
                      labels={"reason": reason})

    def _express_stats(self) -> Optional[Dict[str, Any]]:
        """Express-lane totals for the metrics JSON body (None when no
        server runs — the endpoint must answer on a client-only agent)."""
        server = getattr(self.agent, "server", None)
        express = getattr(server, "express_lane", None)
        return express.summary() if express is not None else None

    def _express_prometheus(self, b: "telemetry.PromText") -> None:
        """Express-lane counters: placement/commit/bounce totals plus
        outstanding-lease and backlog gauges."""
        stats = self._express_stats()
        if not stats:
            return
        for k in ("placed", "tasks_placed", "committed", "bounces",
                  "conflicts", "reconciled"):
            b.counter(f"nomad_express_{k}_total", stats[k])
        for why, n in sorted(stats.get("fallbacks", {}).items()):
            b.counter("nomad_express_fallback_total", n,
                      labels={"reason": why})
        b.gauge("nomad_express_leases", stats["leases"])
        b.gauge("nomad_express_backlog", stats["backlog"])

    def _capacity_prometheus(self, b: "telemetry.PromText") -> None:
        """Capacity observatory: per-dim utilization/density gauges,
        per-lane usage, fragmentation deciles, per-shape stranded %.
        The accountant's own roll/rebuild counters ride the ordinary
        sink (nomad.capacity.*); the ``nomad_capacity_*`` families here
        are the labeled aggregates."""
        acct = self._observer("capacity_accountant")
        if acct is None:
            return
        snap = acct.snapshot()
        for state in ("total", "schedulable", "occupied"):
            b.gauge("nomad_capacity_nodes", snap["nodes"][state],
                    labels={"state": state})
        for dim in snap["dims"]:
            b.gauge("nomad_capacity_total", snap["total"][dim],
                    labels={"dim": dim})
            b.gauge("nomad_capacity_used", snap["used"][dim],
                    labels={"dim": dim})
            b.gauge("nomad_capacity_free", snap["free"][dim],
                    labels={"dim": dim})
            b.gauge("nomad_capacity_utilization",
                    snap["utilization"][dim], labels={"dim": dim})
            b.gauge("nomad_capacity_binpack_density",
                    snap["binpack_density"][dim], labels={"dim": dim})
            for i, n in enumerate(
                    snap["fragmentation"]["free_fraction"][dim]):
                b.gauge("nomad_capacity_frag_nodes", n,
                        labels={"dim": dim, "decile": i})
        for lane, row in snap["lanes"].items():
            b.gauge("nomad_capacity_lane_allocs", row["allocs"],
                    labels={"lane": lane})
            for dim, v in row["used"].items():
                b.gauge("nomad_capacity_lane_used", v,
                        labels={"lane": lane, "dim": dim})
        for s in snap["stranded"]:
            b.gauge("nomad_capacity_stranded_pct", s["stranded_pct"],
                    labels={"shape": s["shape"]})
            b.gauge("nomad_capacity_placeable", s["placeable_count"],
                    labels={"shape": s["shape"]})


    def agent_debug(self, req, query) -> Tuple[Any, Optional[int]]:
        """Runtime introspection, gated by enable_debug — the pprof-analog
        surface (upstream gates pprof handlers the same way,
        command/agent/http.go:115-119). Thread stacks, gc and allocation
        stats, the server's device, the coalescer and the mirror cache:
        the first things needed when an agent wedges."""
        if not getattr(self.agent, "debug_enabled", lambda: False)():
            raise HTTPCodedError(404, "debug endpoints disabled "
                                      "(set enable_debug)")
        return self.agent.debug_info(query), None

    def agent_debug_bundle(self, req, query) -> Tuple[Any, Optional[int]]:
        """One-shot flight recorder (bundle.py): metrics + traces +
        events + redacted config + fault plan + the device statement +
        thread stacks in a single JSON artifact — what an operator
        attaches when a run goes sideways. Debug-gated like the rest of
        the introspection surface."""
        if not getattr(self.agent, "debug_enabled", lambda: False)():
            raise HTTPCodedError(404, "debug endpoints disabled "
                                      "(set enable_debug)")
        return self.agent.debug_bundle(query), None

    def agent_traces(self, req, query) -> Tuple[Any, Optional[int]]:
        """Summaries of the tracer's retained traces, newest first
        (``?n=`` limits)."""
        out = trace.get_tracer().traces()
        try:
            n = int(query.get("n", "0"))
        except ValueError:
            n = 0
        if n > 0:
            out = out[:n]
        return out, None

    def agent_faults(self, req, query) -> Tuple[Any, Optional[int]]:
        """Deterministic fault injection (nomad_tpu_torch.faults), gated by
        enable_debug like /v1/agent/debug — an ungated fault surface on a
        production agent would be an outage button.

        GET returns the armed plan + per-rule fire counts; PUT/POST
        REPLACES the armed plan with a ``{"seed": .., "sites": {site:
        rule|[rules]}}`` spec (validated atomically — a typo'd site arms
        nothing, and sites absent from the new plan are disarmed); DELETE
        clears one site (``?site=``) or everything."""
        if not getattr(self.agent, "debug_enabled", lambda: False)():
            raise HTTPCodedError(404, "fault endpoints disabled "
                                      "(set enable_debug)")
        from nomad_tpu_torch import faults

        reg = faults.get_registry()
        if req.command == "GET":
            return reg.snapshot(), None
        if req.command in ("PUT", "POST"):
            reg.load(self._read_body(req))
            return reg.snapshot(), None
        if req.command == "DELETE":
            reg.clear(query.get("site") or None)
            return reg.snapshot(), None
        raise HTTPCodedError(405, "method not allowed")

    def agent_logs(self, req, query) -> Tuple[Any, Optional[int]]:
        """Tail of the agent's circular log buffer (the reference streams
        the same buffer to `nomad monitor`, command/agent/log_writer.go)."""
        writer = getattr(self.agent, "log_writer", None)
        lines = writer.tail() if writer is not None else []
        try:
            n = int(query.get("n", "0"))
        except ValueError:
            n = 0
        if n > 0:
            lines = lines[-n:]
        return {"lines": lines}, None

    def agent_members(self, req, query) -> Tuple[Any, Optional[int]]:
        return self.agent.members(), None

    def agent_servers(self, req, query) -> Tuple[Any, Optional[int]]:
        return self.agent.server_addrs(), None

    def agent_join(self, req, query) -> Tuple[Any, Optional[int]]:
        self._require_write(req)
        addr = query.get("address", "")
        return {"num_joined": self.agent.join(addr), "error": ""}, None

    def agent_force_leave(self, req, query) -> Tuple[Any, Optional[int]]:
        self._require_write(req)
        self.agent.force_leave(query.get("node", ""))
        return {}, None

    def status_leader(self, req, query) -> Tuple[Any, Optional[int]]:
        return self.agent.leader_addr(), None

    def status_peers(self, req, query) -> Tuple[Any, Optional[int]]:
        return self.agent.peer_addrs(), None
