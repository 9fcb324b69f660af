"""The port's HTTP API and SDK (nomad_tpu_torch.api) against nomad_tpu's.

A nomad_tpu agent and a port agent (server-only dev mode, one worker,
``device="cpu"`` for the port) get the same nodes and jobs, made once with
nomad_tpu's ``mock`` and carried across with ``to_dict``, through each
package's ``ApiClient``. Then every ported route is asked the same
question in both: the status codes are equal, and the bodies are equal
once server-made ids (eval and alloc uuids), raft indexes and timestamps
are masked; node and job ids are the seeded ones and are not masked, so
the alloc-to-node mapping is compared as it stands. A blocking query
wakes on a write, the event stream gives the same event types on the same
keys, the capacity and raft observatories answer ``/v1/agent/capacity`` and
``/v1/agent/raft`` with nomad_tpu's keys (the capacity books equal, as the
committed allocs are). The operator surface answers as nomad_tpu's:
``/v1/agent/metrics`` (JSON, and the main Prometheus scrape with
nomad_tpu's subsystem families, the lock families over a watched lock in
each), ``/solver``, ``/runtime``, ``/profile`` in each format, ``/debug``
and ``/debug/bundle``, with nomad_tpu's JSON key sets (the port adds
``mirror_cache.byte_ledger`` to ``/solver`` and reports its device in
``/debug`` where nomad_tpu reports its device probe and Pallas state);
``?format=prometheus`` on capacity, raft and reads gives nomad_tpu's
families; the SDK's accessors answer; the ``telemetry`` keys,
``server.profile`` and ``lock_watchdog`` parse as nomad_tpu's and take
effect. A subprocess with ``jax`` and ``nomad_tpu`` blocked drives every
route of the port's table and the CLI under the port's lock watchdog.

Tolerance: exact. The cluster is ``mock.node()`` copies (one shape), so
scores tie exactly and no decision falls in the pow contract's band
(ROADMAP, Queue 3).
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import Counter

import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu import structs as jst
from nomad_tpu.agent import Agent as JaxAgent
from nomad_tpu.agent import AgentConfig as JaxAgentConfig
from nomad_tpu.api import ApiClient as JaxApiClient
from nomad_tpu.api.codec import to_dict
from nomad_tpu.scheduler import wait_for_device
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import ApiClient
from nomad_tpu_torch.convert import structs_from_reference

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0
UUID = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")
# Keys whose values the servers make: raft indexes and wall times.
MASK_KEY = re.compile(r"(^|_)(index|time|timestamp|updated)$")
# Each agent's own listener address.
ADDR = re.compile(r"^(http://)?127\.0\.0\.1:\d+$")


def _quiet_server(agent):
    """No heartbeats reach these servers (nothing beats), no start-time
    warm: one worker schedules in submission order."""
    agent.server.config.min_heartbeat_ttl = 3600.0
    agent.server.config.prewarm_shapes = False


def _nodes():
    nodes = []
    for i in range(12):
        node = jmock.node()
        node.id = f"node-{i:02d}-0000-0000-0000-000000000000"
        node.datacenter = "dc1" if i % 3 else "dc2"
        nodes.append(node)
    return nodes


def _jobs():
    service = jmock.job()
    service.id = "svc-job"
    service.task_groups[0].count = 6
    service.task_groups[0].tasks[0].resources = jst.Resources(
        cpu=500, memory_mb=256)
    service.datacenters = ["dc1", "dc2"]
    batch = jmock.job()
    batch.id = "batch-job"
    batch.type = jst.JOB_TYPE_BATCH
    batch.task_groups[0].count = 300
    batch.task_groups[0].tasks[0].resources = jst.Resources(
        cpu=50, memory_mb=32)
    batch.datacenters = ["dc1"]
    system = jmock.system_job()
    system.id = "sys-job"
    system.datacenters = ["dc1", "dc2"]
    for t in system.task_groups[0].tasks:
        t.resources = jst.Resources(cpu=20, memory_mb=16)
    return [service, batch, system]


class Side:
    """One package's agent, its SDK client and what it was asked."""

    def __init__(self, name, agent, client, port_structs):
        self.name = name
        self.agent = agent
        self.client = client
        self.port_structs = port_structs
        self.addr = f"http://127.0.0.1:{agent.http.port}"
        self.eval_ids = {}

    def convert(self, obj, cls):
        if not self.port_structs:
            return obj
        return structs_from_reference(to_dict(obj), cls)

    def get(self, path, method="GET", body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.addr + path, data=data,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def wait(self, eval_id):
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            ev, _ = self.client.evaluations().info(eval_id)
            if ev.status in ("complete", "failed"):
                return ev
            time.sleep(0.01)
        raise AssertionError(f"{self.name}: eval {eval_id} never ended")


def _start(kind):
    if kind == "jax":
        agent = JaxAgent(JaxAgentConfig(
            server_enabled=True, dev_mode=True, http_port=0,
            num_schedulers=1, enable_debug=True))
        _quiet_server(agent)
        agent.server.config.eval_batch_size = 1
        agent.start()
        return Side("jax", agent, JaxApiClient(
            address=f"http://127.0.0.1:{agent.http.port}"), False)
    agent = Agent(AgentConfig(
        server_enabled=True, dev_mode=True, http_port=0, num_schedulers=1,
        enable_debug=True, device="cpu"))
    _quiet_server(agent)
    agent.server.config.eval_batch_size = 1
    agent.start()
    return Side("port", agent, ApiClient(
        address=f"http://127.0.0.1:{agent.http.port}"), True)


@pytest.fixture(scope="module")
def sides():
    assert wait_for_device(timeout=120.0) is not None
    pair = [_start("jax"), _start("port")]
    try:
        nodes = _nodes()
        for side in pair:
            side.agent.server.node_batch_register(
                [side.convert(n, "Node") for n in nodes])
        for job in _jobs():
            for side in pair:
                eid, _ = side.client.jobs().register(side.convert(job, "Job"))
                assert side.wait(eid).status == "complete"
                side.eval_ids[job.id] = eid
        # Drain one node: its allocs migrate through node-update evals.
        for side in pair:
            code, text = side.get(
                f"/v1/node/{nodes[0].id}/drain?enable=true", "PUT")
            assert code == 200
            for eid in json.loads(text)["eval_ids"]:
                assert side.wait(eid).status == "complete"
        yield pair
    finally:
        for side in pair:
            side.agent.shutdown()


def mask(obj, keep):
    """Server-made values masked: uuids not in ``keep`` (the seeded node
    and job ids), raft indexes, times and listener addresses."""
    if isinstance(obj, dict):
        return {k: ("<m>" if MASK_KEY.search(str(k)) else mask(v, keep))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [mask(v, keep) for v in obj]
    if isinstance(obj, str) and UUID.match(obj) and obj not in keep:
        return "<id>"
    if isinstance(obj, str) and ADDR.match(obj):
        return "<addr>"
    return obj


def _keep():
    return {n.id for n in _nodes()} | {j.id for j in _jobs()}


def _same(sides, path, method="GET", body=None, sort_key=None):
    got = []
    for side in sides:
        code, text = side.get(path, method, body)
        try:
            parsed = json.loads(text)
        except ValueError:
            parsed = text
        parsed = mask(parsed, _keep())
        if sort_key is not None and isinstance(parsed, list):
            parsed = sorted(parsed, key=sort_key)
        got.append((code, parsed))
    assert got[1] == got[0], path
    return got[0]


def _alloc_key(a):
    return (a.get("job_id", ""), a.get("name", ""), a.get("node_id", ""),
            a.get("desired_status", ""))


ROUTES = {
    "jobs": "/v1/jobs",
    "jobs_prefix": "/v1/jobs?prefix=svc",
    "job": "/v1/job/svc-job",
    "job_missing": "/v1/job/nope",
    "job_allocations_service": "/v1/job/svc-job/allocations",
    "job_allocations_batch": "/v1/job/batch-job/allocations",
    "job_allocations_system": "/v1/job/sys-job/allocations",
    "job_evaluations": "/v1/job/batch-job/evaluations",
    "nodes": "/v1/nodes",
    "node": "/v1/node/node-01-0000-0000-0000-000000000000",
    "node_missing": "/v1/node/nope",
    "node_allocations": "/v1/node/node-01-0000-0000-0000-000000000000"
                        "/allocations",
    "allocations": "/v1/allocations",
    "allocation_missing": "/v1/allocation/nope",
    "evaluations": "/v1/evaluations",
    "evaluation_missing": "/v1/evaluation/nope",
    "trace_missing": "/v1/evaluation/nope/trace",
    "members": "/v1/agent/members",
    "faults": "/v1/agent/faults",
    "unknown_route": "/v1/nope",
    "bad_max_stale": "/v1/jobs?stale=1&max_stale=abc",
    "bad_event_index": "/v1/event/stream?index=abc",
}

SORT = {"allocations": _alloc_key, "job_allocations_service": _alloc_key,
        "job_allocations_batch": _alloc_key,
        "job_allocations_system": _alloc_key, "node_allocations": _alloc_key,
        "evaluations": lambda e: (e.get("job_id", ""), e.get("type", ""),
                                  e.get("triggered_by", "")),
        "job_evaluations": lambda e: e.get("triggered_by", "")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_answers_as_nomad_tpu(sides, route):
    _same(sides, ROUTES[route], sort_key=SORT.get(route))


def test_committed_allocs_map_to_the_same_nodes(sides):
    maps = []
    for side in sides:
        allocs, _ = side.client.allocations().list()
        maps.append(Counter((a["job_id"], a["name"], a["node_id"])
                            for a in allocs
                            if a["desired_status"] == "run"))
    assert maps[1] == maps[0]
    per_job = Counter(j for j, _n, _node in maps[1].elements())
    assert per_job["batch-job"] == 300 and per_job["svc-job"] == 6


@pytest.mark.parametrize("job_id", [j.id for j in _jobs()])
def test_eval_routes_answer_as_nomad_tpu(sides, job_id):
    for suffix in ("", "/allocations"):
        got = []
        for side in sides:
            code, text = side.get(
                f"/v1/evaluation/{side.eval_ids[job_id]}{suffix}")
            body = mask(json.loads(text), _keep())
            if isinstance(body, list):
                body = sorted(body, key=_alloc_key)
            got.append((code, body))
        assert got[1] == got[0]
        assert got[0][0] == 200


def test_eval_trace_and_traces(sides):
    names = []
    for side in sides:
        eid = side.eval_ids["batch-job"]
        code, text = side.get(f"/v1/evaluation/{eid}/trace")
        assert code == 200
        spans = json.loads(text)["spans"]
        names.append({s["name"] for s in spans})
        code, text = side.get(f"/v1/evaluation/{eid}/trace?format=chrome")
        assert code == 200
        doc = json.loads(text)
        assert {e["ph"] for e in doc["traceEvents"]} == {"X", "M"}
        code, text = side.get("/v1/agent/traces?n=2")
        assert code == 200 and len(json.loads(text)) == 2
    assert names[1] == names[0]


def test_alloc_route_answers_as_nomad_tpu(sides):
    got = []
    for side in sides:
        allocs, _ = side.client.jobs().allocations("svc-job")
        first = sorted(allocs, key=_alloc_key)[0]
        code, text = side.get(f"/v1/allocation/{first['id']}")
        got.append((code, mask(json.loads(text), _keep())))
    assert got[1] == got[0]
    assert got[0][0] == 200


def test_writes_answer_as_nomad_tpu(sides):
    """job evaluate, node evaluate, node drain off, join and force-leave,
    then a deregister (each through both packages, in the same order)."""
    node = "node-02-0000-0000-0000-000000000000"
    for path, method in (("/v1/job/svc-job/evaluate", "PUT"),
                         (f"/v1/node/{node}/evaluate", "PUT"),
                         (f"/v1/node/{node}/drain?enable=false", "PUT"),
                         (f"/v1/node/{node}/drain", "PUT"),
                         ("/v1/job/svc-job/evaluate", "GET"),
                         ("/v1/agent/join?address=127.0.0.1:1", "PUT"),
                         ("/v1/agent/force-leave?node=x", "PUT")):
        got = []
        for side in sides:
            code, text = side.get(path, method)
            body = json.loads(text) if code == 200 else text
            got.append((code, mask(body, _keep())))
            if code != 200:
                continue
            # Let each write's evals finish before the next write.
            evals = body.get("eval_ids") or []
            if body.get("eval_id"):
                evals = [body["eval_id"]]
            for eid in evals:
                side.wait(eid)
        assert got[1] == got[0], path
    got = []
    for side in sides:
        code, text = side.get("/v1/job/batch-job", "DELETE")
        eid = json.loads(text)["eval_id"]
        assert side.wait(eid).status == "complete"
        allocs, _ = side.client.jobs().allocations("batch-job")
        got.append((code, Counter(a["desired_status"] for a in allocs)))
    assert got[1] == got[0] == (200, Counter({"stop": 300}))


def test_agent_self_keeps_nomad_tpus_keys(sides):
    bodies = [json.loads(side.get("/v1/agent/self")[1]) for side in sides]
    jax_cfg, port_cfg = bodies[0]["config"], bodies[1]["config"]
    assert set(jax_cfg) <= set(port_cfg)
    assert {k: port_cfg[k] for k in jax_cfg} == jax_cfg
    assert bodies[1]["stats"]["leader"] is True
    assert bodies[1]["stats"]["device"]["device"] == "cpu"
    assert bodies[1]["stats"]["server"]["applied_index"] > 0
    for path in ("/v1/status/leader", "/v1/status/peers",
                 "/v1/agent/servers", "/v1/agent/logs?n=1"):
        codes = [side.get(path)[0] for side in sides]
        assert codes == [200, 200], path


def test_event_stream_gives_the_same_types_on_the_same_keys(sides):
    keep = _keep()
    seen = []
    for side in sides:
        code, text = side.get("/v1/event/stream?index=0")
        assert code == 200
        events = json.loads(text)["events"]
        seen.append(Counter(
            (e["topic"], e["type"], "<id>" if UUID.match(e["key"] or "")
             and e["key"] not in keep else e["key"])
            for e in events if e["topic"] != "Fault"))
        code, text = side.get(
            "/v1/event/stream?index=1&wait=200ms&format=sse")
        assert code == 200 and "event: " in text
    assert seen[1] == seen[0]


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_blocking_query_wakes_on_a_write(sides, kind):
    side = sides[0] if kind == "jax" else sides[1]
    code, _ = side.get("/v1/jobs")
    index = int(side.agent.server.state_store.get_index("jobs"))
    out = {}

    def park():
        t0 = time.monotonic()
        out["code"], out["body"] = side.get(
            f"/v1/jobs?index={index}&wait=20s")
        out["s"] = time.monotonic() - t0

    t = threading.Thread(target=park)
    t.start()
    time.sleep(0.3)
    job = jmock.job()
    job.id = f"wake-{kind}"
    job.task_groups[0].count = 1
    side.client.jobs().register(side.convert(job, "Job"))
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert out["code"] == 200 and out["s"] < 10.0
    assert job.id in {j["id"] for j in json.loads(out["body"])}


def test_capacity_route_answers_as_nomad_tpu(sides):
    """Both accountants are rolled forward by the route. The books that
    depend only on the nodes are equal; the usage books are the sum of
    their lanes in each (earlier tests' writes may still be placing, so
    usage is not compared across the packages here:
    tests/test_torch_capacity.py holds it to nomad_tpu's on one script)."""
    bodies = []
    for side in sides:
        code, text = side.get("/v1/agent/capacity")
        assert code == 200, (side.name, text)
        bodies.append(json.loads(text))
    assert set(bodies[1]) == set(bodies[0])
    for key in ("dims", "total", "reserved"):
        assert bodies[1][key] == bodies[0][key], key
    for key in ("total", "schedulable"):
        assert bodies[1]["nodes"][key] == bodies[0]["nodes"][key], key
    assert bodies[1]["nodes"]["total"] == len(_nodes())
    assert ([(s["shape"], s["ask"]) for s in bodies[1]["stranded"]]
            == [(s["shape"], s["ask"]) for s in bodies[0]["stranded"]])
    for body in bodies:
        assert set(body["lanes"]) == {"service", "batch", "system",
                                      "express"}
        for dim in body["dims"]:
            assert body["used"][dim] == body["reserved"][dim] + sum(
                lane["used"][dim] for lane in body["lanes"].values())


def test_raft_route_keeps_nomad_tpus_keys(sides):
    bodies = []
    for side in sides:
        code, text = side.get("/v1/agent/raft")
        assert code == 200, (side.name, text)
        bodies.append(json.loads(text))
    assert set(bodies[1]) == set(bodies[0])
    assert set(bodies[1]["observer"]) == set(bodies[0]["observer"])
    assert bodies[1]["recovery"] == bodies[0]["recovery"] == {
        "cold_start": False}
    # A dev agent applies in-process: no replication layer to attribute.
    assert bodies[1]["raft"]["state"] == bodies[0]["raft"]["state"]


def prom(text):
    """(family -> type, the set of series name{labels}) of a text
    exposition; every line must be a TYPE line or a sample."""
    types, series = {}, set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _h, _t, name, mtype = line.split()
            assert name not in types, name
            types[name] = mtype
        else:
            key, value = line.rsplit(" ", 1)
            float(value)
            series.add(key)
    return types, series


@pytest.mark.parametrize("route", ["capacity", "raft", "reads"])
def test_observatory_prometheus_answers_as_nomad_tpu(sides, route):
    got = []
    for side in sides:
        code, text = side.get(f"/v1/agent/{route}?format=prometheus")
        assert code == 200, (side.name, text)
        got.append(prom(text)[0])
    assert got[1] == got[0] and got[1]


@pytest.mark.parametrize("route", ["capacity", "raft"])
def test_sdk_reads_the_observatory(sides, route):
    got = getattr(sides[1].client.agent(), route)()
    ref = getattr(sides[0].client.agent(), route)()
    assert isinstance(got, dict) and set(got) == set(ref)


def _sink_prefix():
    import socket

    from nomad_tpu_torch.telemetry import _sanitize

    return _sanitize(f"nomad.{socket.gethostname()}.")


def test_main_scrape_carries_nomad_tpus_families(sides):
    """The subsystem families of /v1/agent/metrics?format=prometheus
    (every family but the sink's own, whose names carry this host) are
    nomad_tpu's, types and all, with a watchdog installed in each package
    and one watched lock acquired; the sink's part parses too."""
    import chip_smoke
    from nomad_tpu import telemetry as jt
    from nomad_tpu_torch import telemetry as pt

    got = []
    wds = [jt.LockWatchdog(order=["x"], sites={}),
           pt.LockWatchdog(order=["x"], sites={})]
    for wd in wds:
        wd.install()
    try:
        for side, wd in zip(sides, wds):
            with wd.watch(threading.Lock(), "x"):
                pass
            # The observatories' JSON routes refresh their books, so the
            # scrape does not depend on where each poller's tick fell.
            for route in ("capacity", "raft", "reads", "runtime"):
                assert side.get(f"/v1/agent/{route}")[0] == 200
            code, text = side.get("/v1/agent/metrics?format=prometheus")
            assert code == 200
            types, _series = prom(text)
            got.append({f: t for f, t in types.items()
                        if not f.startswith(_sink_prefix())})
            assert len(types) > len(got[-1])
    finally:
        for wd in reversed(wds):
            wd.uninstall()
    assert got[1] == got[0]
    assert {"nomad_lock_wait_ms", "nomad_profile_role_share",
            "nomad_solver_solves_total"} <= set(got[1])
    # The chip script's list of families is nomad_tpu's (less the raft
    # commit index, which a dev agent's in-process raft does not report
    # and the chip script's one-member cluster agent does).
    missing = set(chip_smoke.OPERATOR_FAMILIES) - set(got[0])
    assert missing <= {"nomad_raft_commit_index"}, missing


def test_metrics_json_keeps_nomad_tpus_keys(sides):
    bodies = [json.loads(side.get("/v1/agent/metrics")[1])
              for side in sides]
    assert set(bodies[1]) == set(bodies[0])
    for key in ("mirror_cache", "plan_pipeline", "admission", "express",
                "capacity", "reads", "runtime", "solver_panel", "trace"):
        assert set(bodies[1][key]) == set(bodies[0][key]), key
    assert bodies[1]["locks"] is None and bodies[0]["locks"] is None
    assert bodies[1]["intervals"]


def test_solver_route_keeps_nomad_tpus_keys(sides):
    ref, got = (json.loads(side.get("/v1/agent/solver")[1])
                for side in sides)
    assert set(got) == set(ref)
    assert set(got["panel"]) == set(ref["panel"])
    assert set(got["mirror_cache"]) == set(ref["mirror_cache"]) | {
        "byte_ledger"}
    # The panels are process-wide: other tests' solves count too.
    assert got["panel"]["solves"] > 0 and ref["panel"]["solves"] > 0
    assert got["jit_trace"] == {}
    ledger = got["mirror_cache"]["byte_ledger"]
    assert ledger["projected_1m_rows"] == 1_048_576


@pytest.mark.parametrize("path", ["/v1/agent/runtime", "/v1/agent/profile"])
def test_observatory_route_keeps_nomad_tpus_keys(sides, path):
    ref, got = (json.loads(side.get(path)[1]) for side in sides)
    assert set(got) == set(ref)
    for key in got:
        if isinstance(got[key], dict) and key != "locks":
            assert set(got[key]) == set(ref[key]), key


@pytest.mark.parametrize("fmt, ctype", [
    ("collapsed", "text/plain; charset=utf-8"),
    ("speedscope", "application/json")])
def test_profile_formats_answer_as_nomad_tpu(sides, fmt, ctype):
    for side in sides:
        req = urllib.request.Request(
            side.addr + f"/v1/agent/profile?format={fmt}")
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == ctype


def test_debug_routes_keep_nomad_tpus_keys(sides):
    from nomad_tpu.bundle import BUNDLE_SECTIONS

    bundles = [json.loads(side.get("/v1/agent/debug/bundle")[1])
               for side in sides]
    assert set(bundles[1]) == set(bundles[0]) == set(BUNDLE_SECTIONS)
    debug = [json.loads(side.get("/v1/agent/debug")[1]) for side in sides]
    assert set(debug[1]) == set(debug[0]) - {"device_probe", "pallas"} | {
        "device"}


@pytest.mark.parametrize("accessor", ["metrics", "solver", "profile",
                                      "runtime", "debug", "debug_bundle"])
def test_sdk_operator_accessors_answer(sides, accessor):
    got = getattr(sides[1].client.agent(), accessor)()
    ref = getattr(sides[0].client.agent(), accessor)()
    assert isinstance(got, dict) and got
    if accessor != "debug":
        assert set(got) == set(ref)


TELEMETRY_HCL = """
server {
  enabled = true
  profile { sample_interval = 0.02  seed = 5 }
}
telemetry {
  statsd_address = "127.0.0.1:{port}"
  disable_hostname = true
  histogram_buckets = [50, 5, 0.5]
  lock_watchdog = true
}
"""


def test_telemetry_keys_parse_as_nomad_tpus_and_take_effect(tmp_path):
    """The four telemetry keys, server.profile and lock_watchdog parse to
    nomad_tpu's values, and a port agent built from them sends statsd
    lines without the hostname, exposes the configured buckets, runs the
    profiler at the configured seed and installs (then uninstalls) the
    lock watchdog."""
    import socket

    from nomad_tpu import agent_config as jac
    from nomad_tpu.agent import AgentConfig as JaxConfig
    from nomad_tpu_torch import agent_config as pac
    from nomad_tpu_torch import telemetry as pt

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(10.0)
    path = tmp_path / "agent.hcl"
    path.write_text(TELEMETRY_HCL.replace(
        "{port}", str(rx.getsockname()[1])))
    fc, jfc = pac.load_config_file(str(path)), jac.load_config_file(
        str(path))
    assert vars(fc.telemetry) == vars(jfc.telemetry)
    assert fc.server.profile == jfc.server.profile
    cfg = AgentConfig.from_file_config(fc)
    jcfg = JaxConfig.from_file_config(jfc)
    for key in ("statsd_addr", "statsite_addr", "disable_hostname_metrics",
                "histogram_buckets", "lock_watchdog", "profile"):
        assert getattr(cfg, key) == getattr(jcfg, key), key
    cfg.dev_mode, cfg.device, cfg.http_port = True, "cpu", 0
    cfg.data_dir = str(tmp_path / "data")
    was = pt.get_global()
    agent = Agent(cfg)
    try:
        assert pt.active_lock_watchdog() is agent.lock_watchdog is not None
        agent.server.config.min_heartbeat_ttl = 3600.0
        agent.start()
        assert agent.inmem_sink.buckets == (0.5, 5.0, 50.0)
        assert agent.server.config.profile_config.seed == 5
        pt.incr_counter(("operator", "probe"))
        pt.add_sample(("operator", "probe_ms"), 1.0)
        lines = rx.recv(4096).decode().splitlines()
        assert lines and all(ln.startswith("nomad.") for ln in lines)
        assert not any(socket.gethostname() in ln for ln in lines)
        text = urllib.request.urlopen(
            agent.http.addr + "/v1/agent/metrics?format=prometheus",
            timeout=WAIT_S).read().decode()
        assert 'le="0.5"' in text and 'le="2.5"' not in text
        assert "nomad_lock_watchdog_installed 1" in text
    finally:
        agent.shutdown()
        rx.close()
        pt.set_global(was)
    assert pt.active_lock_watchdog() is None


def test_every_route_answers_without_jax_or_nomad_tpu():
    """The port's agent, SDK and CLI in a subprocess that cannot import
    jax or nomad_tpu: every route of the HTTP table answers (no 500), on
    a server agent and on a client-only agent (where a route that reads
    the server answers nomad_tpu's 500 "no server running"), and no
    module of either package is loaded at the end."""
    code = r'''
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
import contextlib, io, json, re, time, urllib.error, urllib.request
from nomad_tpu_torch import cli, mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import ApiClient

agent = Agent(AgentConfig(server_enabled=True, dev_mode=True, http_port=0,
                          num_schedulers=1, enable_debug=True,
                          lock_watchdog=True,
                          device="cpu", express={"enabled": True},
                          admission={"client_rate": 0.001,
                                     "client_burst": 4}))
agent.server.config.min_heartbeat_ttl = 3600.0
agent.start()
addr = f"http://127.0.0.1:{agent.http.port}"
nodes = [mock.node() for _ in range(4)]
agent.server.node_batch_register(nodes)
c = ApiClient(address=addr)
job = mock.job()
job.task_groups[0].count = 2
eid, _ = c.jobs().register(job)
deadline = time.monotonic() + 60
while c.evaluations().info(eid)[0].status != "complete":
    assert time.monotonic() < deadline
    time.sleep(0.01)
alloc = c.jobs().allocations(job.id)[0][0]["id"]
# The express lane, the front door and the read lanes, in this process.
from nomad_tpu_torch.simcluster.workload import build_job
from nomad_tpu_torch.structs import RejectError
xeid, _ = c.jobs().register(build_job("x-job", "batch", 1, express=True))
lane = agent.server.express_lane
deadline = time.monotonic() + 60
while lane.committed + lane.reconciled < 1:
    assert time.monotonic() < deadline
    time.sleep(0.01)
for path in ("/v1/jobs?stale=1&max_stale=100", "/v1/jobs?consistent=1"):
    with urllib.request.urlopen(addr + path, timeout=30) as r:
        assert r.status == 200 and r.headers["X-Nomad-LastContact"] == "0"
try:
    strict = ApiClient(address=addr, client_id="tenant", reject_retries=0)
    for k in range(5):
        strict.jobs().register(build_job(f"r-{k}", "batch", 1))
    raise AssertionError("the door never refused")
except RejectError as e:
    assert e.reason == "RATE_LIMITED"
ids = {"job_id": job.id, "node_id": nodes[0].id, "eval_id": eid,
       "alloc_id": alloc}
codes = {}
for pattern, handler in agent.http.routes:
    path = re.sub(r"\(\?P<([^>]+)>[^)]+\)",
                  lambda m: ids[m.group(1)], pattern.pattern).strip("^$")
    for method in ("GET", "PUT"):
        req = urllib.request.Request(addr + path, method=method,
                                     data=b"{}" if method == "PUT" else None)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                code = r.status
                r.read()
        except urllib.error.HTTPError as e:
            code = e.code
        codes[(method, path)] = code
        assert code != 500, (method, path)
for argv in (["status"], ["status", job.id], ["node-status"],
             ["node-status", nodes[0].id], ["alloc-status", alloc],
             ["agent-info"], ["server-members"], ["eval-monitor", eid],
             ["version"]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--address", addr] + argv) == 0, argv
wd = agent.lock_watchdog
assert wd is not None and wd.stats()["locks_tracked"] > 0
agent.shutdown()
assert wd.violations == [], wd.violations
from nomad_tpu_torch import telemetry
assert telemetry.active_lock_watchdog() is None

# A client-only agent against a one-member cluster agent: the routes that
# read the server answer nomad_tpu's "no server running", the agent's own
# routes answer, and so do the CLI's agent commands.
import tempfile
tmp = tempfile.mkdtemp()
server = Agent(AgentConfig(server_enabled=True, http_port=0, rpc_port=0,
                           bootstrap_expect=1, num_schedulers=1,
                           data_dir=tmp + "/server", device="cpu"))
server.server.config.min_heartbeat_ttl = 3600.0
server.start()
rpc = server.server.rpc_addr
agent = Agent(AgentConfig(client_enabled=True, http_port=0,
                          data_dir=tmp + "/client", client_servers=[rpc]))
agent.start()
addr = f"http://127.0.0.1:{agent.http.port}"
ids["node_id"] = agent.client.node.id
for pattern, handler in agent.http.routes:
    path = re.sub(r"\(\?P<([^>]+)>[^)]+\)",
                  lambda m: ids[m.group(1)], pattern.pattern).strip("^$")
    for method in ("GET", "PUT"):
        req = urllib.request.Request(addr + path, method=method,
                                     data=b"{}" if method == "PUT" else None)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                code, body = r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            code, body = e.code, e.read().decode()
        codes[("client", method, path)] = code
        assert code != 500 or body == "no server running", (method, path,
                                                            body)
with urllib.request.urlopen(addr + "/v1/agent/self", timeout=30) as r:
    info = json.loads(r.read())
assert info["stats"]["client"]["node_id"] == agent.client.node.id
assert "server" not in info["stats"], info
for argv, want in ((["client-config", "-servers"], 0), (["agent-info"], 0),
                   (["server-members"], 0), (["status"], 1)):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--address", addr] + argv) == want, argv
    if argv[0] == "client-config":
        assert buf.getvalue() == rpc + "\n", buf.getvalue()
agent.shutdown()
server.shutdown()
import nomad_tpu_torch.simcluster.scenario
import nomad_tpu_torch.simcluster.chaos
for name in ("slo", "lifecycle", "read_observe", "server.admission",
             "server.express", "server.read_path", "simcluster.scenario",
             "capacity", "raft_observe", "simcluster.chaos", "telemetry",
             "profile_observe", "bundle"):
    assert "nomad_tpu_torch." + name in sys.modules, name
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "nomad_tpu")]
assert not loaded, loaded
print("ok", len(codes))
'''
    # No network for the client's cloud metadata fingerprints: urllib goes
    # through a closed loopback port, except for the loopback itself.
    env = dict(os.environ, PYTHONPATH=REPO, http_proxy="http://127.0.0.1:1",
               no_proxy="127.0.0.1,localhost")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[0] == "ok"
