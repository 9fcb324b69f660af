"""Python client SDK for the HTTP API.

Reference: upstream api/ — ``api.Client`` with query/write/delete
plus QueryOptions/QueryMeta mirroring server semantics including blocking
queries (api.go:243-334), and typed sub-clients Jobs/Nodes/Evaluations/
Allocations/Agent/Status (jobs.go, nodes.go, evals.go, allocations.go,
agent.go, status.go).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from nomad_tpu_torch.api.codec import from_dict, to_dict
from nomad_tpu_torch.structs import (
    MAX_QUERY_TIME,
    MAX_QUERY_TIME_PAD,
    REJECT_RATE_LIMITED,
    REJECT_STALE_BOUND,
    Allocation,
    Evaluation,
    Job,
    Node,
    RejectError,
    parse_reject,
)

DEFAULT_ADDRESS = "http://127.0.0.1:4646"


class ApiError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"unexpected response code {code}: {message}")
        self.code = code


def _rejection_from_http(code: int, body: str,
                         retry_after_header: str) -> Optional[RejectError]:
    """Recover the typed rejection from a 429/503 response. The JSON body
    carries reason + float retry_after; the Retry-After header (integer
    seconds) is the fallback when only it survived a proxy."""
    if code not in (429, 503):
        return None
    rejection = None
    try:
        payload = json.loads(body)
        # A proxy may rewrite the body to any JSON value; only an object
        # can carry our reject shape.
        reason = payload.get("reason") if isinstance(payload, dict) else None
        if reason:
            rejection = RejectError(
                reason, payload.get("error", ""),
                retry_after=float(payload.get("retry_after", 0.0)),
            )
    except (ValueError, TypeError):
        rejection = parse_reject(body)
    if rejection is None and retry_after_header:
        # Body lost in transit, header survived: infer the reason class
        # from the status code the server maps reasons onto (429 =
        # client-paced RATE_LIMITED/SHED, 503 = capacity QUEUE_FULL) so
        # the retry policy stays correct.
        try:
            return RejectError(
                REJECT_RATE_LIMITED if code == 429 else "QUEUE_FULL",
                body.strip(), retry_after=float(retry_after_header))
        except ValueError:
            return None
    return rejection


@dataclass
class QueryOptions:
    """api.go:105-137"""

    region: str = ""
    allow_stale: bool = False
    # Client-side staleness bound for the stale lane (ms of the serving
    # server's leader-contact age): past it the server refuses with a
    # typed retriable STALE_BOUND instead of answering stale. None =
    # the server's configured default bound.
    max_stale_ms: Optional[float] = None
    # Linearizable lane: a read as strong as a write, confirmed via the
    # leader's read index (no raft log write). Wins over allow_stale.
    consistent: bool = False
    wait_index: int = 0
    wait_time: str = ""
    prefix: str = ""


@dataclass
class QueryMeta:
    """api.go:139-155"""

    last_index: int = 0
    # Serving server's measured leader-contact age in ms at response
    # time (X-Nomad-LastContact; 0 when the leader itself answered).
    last_contact: float = 0.0
    known_leader: bool = False
    # Serving server's last-applied raft index (X-Nomad-LastIndex) —
    # how fresh the state this response was read from actually was.
    applied_index: int = 0
    # Confirmed read index on linearizable-lane responses
    # (X-Nomad-Read-Index); 0 on other lanes.
    read_index: int = 0


class ApiClient:
    """api.go:157-241

    ``client_id`` stamps every request's X-Nomad-Client header so the
    server's admission rate lanes can attribute load per caller.
    ``reject_retries`` bounds the SDK's automatic handling of typed
    RATE_LIMITED rejections: the retry sleeps max(server retry-after
    hint, jittered backoff) — honoring the hint instead of hot-looping —
    then surfaces a typed RejectError (never a bare HTTP error) once the
    budget is spent. Rejections are raised BEFORE any server-side effect
    (the admission contract), so replaying even writes is safe."""

    def __init__(self, address=DEFAULT_ADDRESS, region: str = "",
                 client_id: str = "", reject_retries: int = 2,
                 allow_stale: bool = False,
                 max_stale_ms: Optional[float] = None):
        # ``address`` is one base URL or a list of them (the server
        # fleet). With a list the client is follower-aware: stale-lane
        # GETs round-robin the whole fleet (any server may answer from
        # its own FSM within the bound), everything else sticks to a
        # preferred server and rotates only when it stops answering.
        if isinstance(address, str):
            addresses = [address]
        else:
            addresses = list(address) or [DEFAULT_ADDRESS]
        self.addresses = [a.rstrip("/") for a in addresses]
        self.address = self.addresses[0]
        self.region = region
        self.client_id = client_id
        self.reject_retries = max(0, int(reject_retries))
        # Client-level lane defaults: every plain GET issued without
        # explicit QueryOptions opts into the stale lane (with the
        # bound) when allow_stale is set — the read-fleet posture.
        self.allow_stale = bool(allow_stale)
        self.max_stale_ms = max_stale_ms
        import threading as _threading

        self._addr_lock = _threading.Lock()
        self._rr = 0
        self._preferred = 0

    # -- raw verbs (api.go:243-376) -----------------------------------------

    def _pick_address(self, stale: bool) -> str:
        with self._addr_lock:
            if stale and len(self.addresses) > 1:
                # Stale reads spread over the fleet — the whole point of
                # the lane is that followers absorb this load.
                i = self._rr % len(self.addresses)
                self._rr += 1
                return self.addresses[i]
            return self.addresses[self._preferred % len(self.addresses)]

    def _rotate_preferred(self, failed: str) -> None:
        with self._addr_lock:
            if self.addresses[self._preferred % len(self.addresses)] \
                    == failed:
                self._preferred = (self._preferred + 1) \
                    % len(self.addresses)

    def _url(self, path: str, q: Optional[QueryOptions], params: Dict,
             base: Optional[str] = None) -> str:
        query = dict(params)
        if q is not None:
            if q.wait_index:
                query["index"] = str(q.wait_index)
            if q.wait_time:
                query["wait"] = q.wait_time
            if q.consistent:
                query["consistent"] = "1"
            elif q.allow_stale:
                query["stale"] = "1"
                bound = (q.max_stale_ms if q.max_stale_ms is not None
                         else self.max_stale_ms)
                if bound is not None:
                    query["max_stale"] = str(bound)
            if q.region:
                query["region"] = q.region
            if q.prefix:
                query["prefix"] = q.prefix
        # doseq: list-valued params (repeatable ?topic= filters) expand to
        # repeated keys; scalars encode exactly as before.
        qs = urllib.parse.urlencode(query, doseq=True)
        return f"{base or self.address}{path}" + (f"?{qs}" if qs else "")

    def _do(self, method: str, path: str, body: Any = None,
            q: Optional[QueryOptions] = None,
            params: Optional[Dict] = None) -> Tuple[Any, QueryMeta]:
        from nomad_tpu_torch.backoff import MAX_RETRY_AFTER_SLEEP, Backoff

        stale = bool(method == "GET" and q is not None and q.allow_stale
                     and not q.consistent)
        data = json.dumps(to_dict(body)).encode() if body is not None else None
        bo = Backoff(base=0.05, max_delay=1.0)
        attempt = 0
        unreachable: set = set()
        while True:
            base = self._pick_address(stale)
            url = self._url(path, q, params or {}, base=base)
            req = urllib.request.Request(url, data=data, method=method)
            if data is not None:
                req.add_header("Content-Type", "application/json")
            if self.client_id:
                req.add_header("X-Nomad-Client", self.client_id)
            try:
                with urllib.request.urlopen(
                    req, timeout=MAX_QUERY_TIME + MAX_QUERY_TIME_PAD
                ) as resp:
                    meta = QueryMeta(
                        last_index=int(resp.headers.get("X-Nomad-Index", 0)),
                        last_contact=float(
                            resp.headers.get("X-Nomad-LastContact", 0)
                        ),
                        known_leader=resp.headers.get("X-Nomad-KnownLeader")
                        == "true",
                        applied_index=int(
                            resp.headers.get("X-Nomad-LastIndex", 0)),
                        read_index=int(
                            resp.headers.get("X-Nomad-Read-Index", 0)),
                    )
                    payload = resp.read()
                    return (json.loads(payload) if payload else None), meta
            except urllib.error.HTTPError as e:
                text = e.read().decode(errors="replace")
                rejection = _rejection_from_http(
                    e.code, text, e.headers.get("Retry-After", ""))
                if rejection is None:
                    raise ApiError(e.code, text) from e
                # Typed rejection: provably no server-side effect, so a
                # replay is always safe. Only RATE_LIMITED auto-retries
                # (pacing is the client's job); capacity rejections
                # (QUEUE_FULL/SHED/WATCH_LIMIT) surface typed at once —
                # retrying into an overload is the loop backpressure
                # exists to break. A hint past the sleep ceiling also
                # surfaces: sleeping a clamped slice of it guarantees
                # another rejection — the caller owns waits that long.
                # STALE_BOUND is the one read-lane exception: the refusal
                # is per-SERVER (this follower's contact age), so with a
                # fleet the retry goes straight to the next server in the
                # rotation instead of sleeping.
                if (rejection.reason == REJECT_STALE_BOUND and stale
                        and len(self.addresses) > 1
                        and attempt < self.reject_retries):
                    attempt += 1
                    continue
                if (rejection.reason != REJECT_RATE_LIMITED
                        or attempt >= self.reject_retries
                        or rejection.retry_after > MAX_RETRY_AFTER_SLEEP):
                    raise rejection from e
                attempt += 1
                import time as _time

                _time.sleep(max(rejection.retry_after, bo.next_delay()))
            except urllib.error.URLError as e:
                # A dead server is a routing event, not (yet) a failure:
                # rotate the preferred server and try the rest of the
                # fleet once each before surfacing.
                unreachable.add(base)
                self._rotate_preferred(base)
                if len(unreachable) >= len(self.addresses):
                    raise ApiError(
                        0,
                        f"failed to reach agent at {base}: {e.reason}"
                    ) from e

    def query(self, path: str, q: Optional[QueryOptions] = None,
              params: Optional[Dict] = None) -> Tuple[Any, QueryMeta]:
        if q is None and self.allow_stale:
            q = QueryOptions(allow_stale=True,
                             max_stale_ms=self.max_stale_ms)
        return self._do("GET", path, q=q, params=params)

    def write(self, path: str, body: Any = None,
              params: Optional[Dict] = None) -> Tuple[Any, QueryMeta]:
        return self._do("PUT", path, body=body, params=params)

    def delete(self, path: str) -> Tuple[Any, QueryMeta]:
        return self._do("DELETE", path)

    # -- typed sub-clients ---------------------------------------------------

    def jobs(self) -> "Jobs":
        return Jobs(self)

    def nodes(self) -> "Nodes":
        return Nodes(self)

    def evaluations(self) -> "Evaluations":
        return Evaluations(self)

    def allocations(self) -> "Allocations":
        return Allocations(self)

    def agent(self) -> "AgentApi":
        return AgentApi(self)

    def status(self) -> "Status":
        return Status(self)

    def events(self) -> "Events":
        return Events(self)


class Jobs:
    """api/jobs.go"""

    def __init__(self, client: ApiClient):
        self.client = client

    def register(self, job: Job) -> Tuple[str, QueryMeta]:
        out, meta = self.client.write("/v1/jobs", body={"job": job})
        return out["eval_id"], meta

    def list(self, q: Optional[QueryOptions] = None) -> Tuple[List[Dict], QueryMeta]:
        return self.client.query("/v1/jobs", q=q)

    def info(self, job_id: str,
             q: Optional[QueryOptions] = None) -> Tuple[Job, QueryMeta]:
        out, meta = self.client.query(f"/v1/job/{job_id}", q=q)
        return from_dict(Job, out), meta

    def allocations(self, job_id: str,
                    q: Optional[QueryOptions] = None) -> Tuple[List[Dict], QueryMeta]:
        return self.client.query(f"/v1/job/{job_id}/allocations", q=q)

    def evaluations(self, job_id: str,
                    q: Optional[QueryOptions] = None) -> Tuple[List[Evaluation], QueryMeta]:
        out, meta = self.client.query(f"/v1/job/{job_id}/evaluations", q=q)
        return [from_dict(Evaluation, e) for e in out], meta

    def evaluate(self, job_id: str) -> Tuple[str, QueryMeta]:
        out, meta = self.client.write(f"/v1/job/{job_id}/evaluate")
        return out["eval_id"], meta

    def deregister(self, job_id: str) -> Tuple[str, QueryMeta]:
        out, meta = self.client.delete(f"/v1/job/{job_id}")
        return out["eval_id"], meta


class Nodes:
    """api/nodes.go"""

    def __init__(self, client: ApiClient):
        self.client = client

    def list(self, q: Optional[QueryOptions] = None) -> Tuple[List[Dict], QueryMeta]:
        return self.client.query("/v1/nodes", q=q)

    def info(self, node_id: str,
             q: Optional[QueryOptions] = None) -> Tuple[Node, QueryMeta]:
        out, meta = self.client.query(f"/v1/node/{node_id}", q=q)
        return from_dict(Node, out), meta

    def allocations(self, node_id: str,
                    q: Optional[QueryOptions] = None) -> Tuple[List[Allocation], QueryMeta]:
        out, meta = self.client.query(f"/v1/node/{node_id}/allocations", q=q)
        return [from_dict(Allocation, a) for a in out], meta

    def toggle_drain(self, node_id: str, drain: bool) -> Tuple[Dict, QueryMeta]:
        return self.client.write(
            f"/v1/node/{node_id}/drain",
            params={"enable": "true" if drain else "false"},
        )

    def force_evaluate(self, node_id: str) -> Tuple[Dict, QueryMeta]:
        return self.client.write(f"/v1/node/{node_id}/evaluate")


class Evaluations:
    """api/evaluations.go"""

    def __init__(self, client: ApiClient):
        self.client = client

    def list(self, q: Optional[QueryOptions] = None) -> Tuple[List[Evaluation], QueryMeta]:
        out, meta = self.client.query("/v1/evaluations", q=q)
        return [from_dict(Evaluation, e) for e in out], meta

    def info(self, eval_id: str,
             q: Optional[QueryOptions] = None) -> Tuple[Evaluation, QueryMeta]:
        out, meta = self.client.query(f"/v1/evaluation/{eval_id}", q=q)
        return from_dict(Evaluation, out), meta

    def allocations(self, eval_id: str,
                    q: Optional[QueryOptions] = None) -> Tuple[List[Dict], QueryMeta]:
        return self.client.query(f"/v1/evaluation/{eval_id}/allocations", q=q)

    def timeline(self, eval_id: str) -> Dict:
        """Lifecycle timeline (/v1/evaluation/<id>/timeline): the
        submit→placed(→running) stage decomposition, per-attempt
        segments included (nomad_tpu_torch.lifecycle)."""
        out, _ = self.client.query(f"/v1/evaluation/{eval_id}/timeline")
        return out


class Allocations:
    """api/allocations.go"""

    def __init__(self, client: ApiClient):
        self.client = client

    def list(self, q: Optional[QueryOptions] = None) -> Tuple[List[Dict], QueryMeta]:
        return self.client.query("/v1/allocations", q=q)

    def info(self, alloc_id: str,
             q: Optional[QueryOptions] = None) -> Tuple[Allocation, QueryMeta]:
        out, meta = self.client.query(f"/v1/allocation/{alloc_id}", q=q)
        return from_dict(Allocation, out), meta

    def timeline(self, alloc_id: str) -> Dict:
        """Lifecycle timeline for one allocation
        (/v1/allocation/<id>/timeline): resolves through the alloc's
        evaluation and carries ``alloc_id`` in the body."""
        out, _ = self.client.query(f"/v1/allocation/{alloc_id}/timeline")
        return out


class Events:
    """Client for /v1/event/stream (reference: api/event.go — the Go
    SDK's EventStream consumer)."""

    def __init__(self, client: ApiClient):
        self.client = client

    def list(self, index: int = 0, topics: Optional[List[str]] = None,
             wait: str = "") -> Tuple[int, List[Dict], bool]:
        """One page of events with index > ``index`` (long-polls server-
        side when index > 0). Returns (resume_index, events, truncated)."""
        params: Dict[str, Any] = {"index": str(index)}
        if topics:
            params["topic"] = list(topics)
        if wait:
            params["wait"] = wait
        out, _ = self.client.query("/v1/event/stream", params=params)
        return out["index"], out["events"], out["truncated"]

    def stream(self, index: int = 0, topics: Optional[List[str]] = None,
               poll_wait: str = "60s"):
        """Iterator over the event stream honoring ``?index=`` resume:
        yields event dicts in order, long-polling between pages, forever
        (callers break out). Whenever the resume cursor has fallen off
        the server's bounded ring — at start OR mid-stream, when a burst
        larger than the ring lands between pages — a synthetic
        ``{"topic": "Truncated", ...}`` marker is yielded before that
        page's events: the consumer's signal to re-list its world."""
        cursor = index
        while True:
            cursor_out, events, truncated = self.list(
                index=cursor, topics=topics, wait=poll_wait
            )
            if truncated:
                yield {"topic": "Truncated", "type": "Truncated",
                       "index": cursor, "key": "", "payload": {}}
            for event in events:
                yield event
            # An empty page still advances the cursor (events of other
            # topics moved the index) — resume from wherever the server
            # got to, never re-read the same page.
            cursor = max(cursor, cursor_out)


class AgentApi:
    """api/agent.go"""

    def __init__(self, client: ApiClient):
        self.client = client

    def self_info(self) -> Dict:
        out, _ = self.client.query("/v1/agent/self")
        return out

    def metrics(self) -> Dict:
        """Live InmemSink aggregates (/v1/agent/metrics JSON body)."""
        out, _ = self.client.query("/v1/agent/metrics")
        return out

    def slo(self) -> Dict:
        """Live SLO state (/v1/agent/slo): objectives with observed
        percentiles, rolling error budgets, and burn rates
        (nomad_tpu_torch.slo)."""
        out, _ = self.client.query("/v1/agent/slo")
        return out

    def admission(self) -> Dict:
        """Admission front-door state (/v1/agent/admission): decision
        counters, per-client rate lanes, recent typed rejections, and
        the bounded-queue posture (nomad_tpu_torch/server/admission.py)."""
        out, _ = self.client.query("/v1/agent/admission")
        return out

    def express(self) -> Dict:
        """Express placement lane state (/v1/agent/express): placement/
        commit/bounce books, the reservation ledger, and in-line
        place-latency quantiles (nomad_tpu_torch/server/express.py)."""
        out, _ = self.client.query("/v1/agent/express")
        return out

    def capacity(self) -> Dict:
        """Capacity observatory state (/v1/agent/capacity): per-dim
        utilization, bin-pack density, per-lane usage, fragmentation
        histograms, and stranded-capacity % against the seeded
        reference shapes (nomad_tpu_torch/capacity.py)."""
        out, _ = self.client.query("/v1/agent/capacity")
        return out

    def solver(self) -> Dict:
        """Device-solve efficiency panel (/v1/agent/solver): padding
        economy, bucket occupancy, compile attribution, device time per
        placement, plus the mirror delta-roll economy and jit retrace
        counters (nomad_tpu_torch/tpu/solver.py SOLVER_PANEL)."""
        out, _ = self.client.query("/v1/agent/solver")
        return out

    def raft(self) -> Dict:
        """Raft & recovery observatory state (/v1/agent/raft):
        write-path stage attribution per msg_type, per-follower lag,
        log/snapshot economy, and the restart-replay recovery timeline
        (nomad_tpu_torch/raft_observe.py)."""
        out, _ = self.client.query("/v1/agent/raft")
        return out

    def reads(self) -> Dict:
        """Read-path observatory state (/v1/agent/reads): per-endpoint
        serving attribution (route/lane latency + bytes, blocking
        hold/serve partition, SSE session books), watch-registry economy
        (bucket occupancy, wake fan-out, spurious re-probes), and the
        freshness/staleness distribution every read response is stamped
        with (nomad_tpu_torch/read_observe.py)."""
        out, _ = self.client.query("/v1/agent/reads")
        return out

    def profile(self) -> Dict:
        """Sampling-profiler state (/v1/agent/profile): collapsed-stack
        aggregates and per-thread-role wall shares from the continuous
        stack sampler (nomad_tpu_torch/profile_observe.py). For renderable
        exports hit the endpoint directly with ``?format=collapsed``
        (flamegraph.pl text) or ``?format=speedscope``."""
        out, _ = self.client.query("/v1/agent/profile")
        return out

    def runtime(self) -> Dict:
        """Runtime economy ledgers (/v1/agent/runtime): the
        lock-contention table (telemetry{lock_watchdog}) and the
        byte-economy ledger — mirror buffers by bucket x dtype with the
        projected 1M-node footprint, bounded rings, state store, RSS
        (nomad_tpu_torch/profile_observe.py)."""
        out, _ = self.client.query("/v1/agent/runtime")
        return out

    def traces(self, n: int = 0) -> List[Dict]:
        """Retained trace summaries (/v1/agent/traces), newest first;
        ``n`` limits (0 = all retained)."""
        params = {"n": str(n)} if n else None
        out, _ = self.client.query("/v1/agent/traces", params=params)
        return out

    def debug(self) -> Dict:
        """Runtime introspection (/v1/agent/debug; requires the agent to
        run with enable_debug): thread stacks, gc stats, device probe /
        pallas / coalescer / mirror state."""
        out, _ = self.client.query("/v1/agent/debug")
        return out

    def faults(self) -> Dict:
        """The armed fault-injection plan + per-rule fire counts
        (/v1/agent/faults; debug-gated like /v1/agent/debug)."""
        out, _ = self.client.query("/v1/agent/faults")
        return out

    def logs(self, n: int = 0) -> Dict:
        """Tail of the agent's circular log buffer (/v1/agent/logs);
        ``n`` limits the line count (0 = the whole buffer)."""
        params = {"n": str(n)} if n else None
        out, _ = self.client.query("/v1/agent/logs", params=params)
        return out

    def servers(self) -> List[str]:
        """Known server RPC addresses (/v1/agent/servers)."""
        out, _ = self.client.query("/v1/agent/servers")
        return out

    def debug_bundle(self, events: int = 0) -> Dict:
        """One-shot flight recorder (/v1/agent/debug/bundle; requires the
        agent to run with enable_debug). ``events`` caps the included
        event tail (0 = the server default)."""
        params = {"events": str(events)} if events else None
        out, _ = self.client.query("/v1/agent/debug/bundle", params=params)
        return out

    def members(self) -> List[Dict]:
        out, _ = self.client.query("/v1/agent/members")
        return out

    def join(self, addr: str) -> int:
        out, _ = self.client.write("/v1/agent/join", params={"address": addr})
        return out["num_joined"]

    def force_leave(self, node: str) -> None:
        self.client.write("/v1/agent/force-leave", params={"node": node})


class Status:
    """api/status.go"""

    def __init__(self, client: ApiClient):
        self.client = client

    def leader(self) -> str:
        out, _ = self.client.query("/v1/status/leader")
        return out

    def peers(self) -> List[str]:
        out, _ = self.client.query("/v1/status/peers")
        return out
