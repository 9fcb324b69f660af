"""The port's follower read plane (server/read_path.py) and read books
(read_observe.py) against nomad_tpu's.

- ``ReadPathConfig`` / ``ReadObserveConfig`` parsing and the lane names.
- ``ReadPath.enter`` on servers of each package stubbed with the same
  role, contact age and applied index: the same lane resolution, the
  same stale-bound rejections (reason, message, retry-after) and the same
  serve books.
- ``ReadRecorder``: the same recorded requests, blocking queries, SSE
  sessions and stamps give the same snapshot.
- One-member cells: nomad_tpu's agent and the port's agent answer the
  same GETs on the default, stale and linearizable lanes (and blocking
  queries) with the same codes, lane headers and per-(role, lane) serve
  books, and the same per-route read books (counts, lanes, bytes).
- A three-member port cell: a follower's ``confirmed_read_index``
  forwards ``Raft.ReadIndex`` to the leader; a follower's HTTP front
  serves the stale lane with its measured contact age, refuses a bound it
  cannot meet (429 STALE_BOUND) and stamps linearizable reads with the
  confirmed read index.
- ``read-storm-800`` at seed 11 through the port's runner, with its
  leader-only contrast arm, gives nomad_tpu's committed digest; the lanes
  verdict holds (counts, never wall-clock).

Tolerance: exact, except read latencies (wall clock), which are masked.
"""

import json
import os
import random
import urllib.error
import urllib.request

import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu import read_observe as jro
from nomad_tpu.agent import Agent as JaxAgent
from nomad_tpu.agent import AgentConfig as JaxAgentConfig
from nomad_tpu.server import read_path as jrp
from nomad_tpu.structs import RejectError as JaxReject
from nomad_tpu_torch import mock, slo
from nomad_tpu_torch import read_observe as pro
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api.http import HTTPServer
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.api.codec import to_dict
from nomad_tpu_torch.server import read_path as prp
from nomad_tpu_torch.server.cluster import form_cluster, wait_for_leader
from nomad_tpu_torch.server.server import ServerConfig
from nomad_tpu_torch.simcluster import scenario as psc
from nomad_tpu_torch.structs import RejectError
from test_torch_cluster import relaxed_cluster, retry_write

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0


# -- config and lanes ---------------------------------------------------------


@pytest.mark.parametrize("spec", [
    None, {}, {"enabled": False}, {"default_max_stale_ms": 250},
    {"read_index_timeout": 0.5, "apply_wait_timeout": 1.5},
    {"read_lease_fraction": 0.5}, {"default_max_stale_ms": -1},
    {"read_index_timeout": 0}, {"nope": 1}, [],
])
def test_read_path_config_parse_equals_reference(spec):
    try:
        ref = jrp.ReadPathConfig.parse(spec)
    except (ValueError, TypeError) as e:
        with pytest.raises(type(e)) as got:
            prp.ReadPathConfig.parse(spec)
        assert str(got.value) == str(e)
        return
    assert vars(prp.ReadPathConfig.parse(spec)) == vars(ref)


@pytest.mark.parametrize("spec", [
    None, {}, {"enabled": False}, {"poll_interval": 0.2,
                                   "events_interval": 1.0},
    {"poll_interval": 0}, {"events_interval": -1}, {"bogus": 1}, "x",
])
def test_read_observe_config_parse_equals_reference(spec):
    try:
        ref = jro.ReadObserveConfig.parse(spec)
    except (ValueError, TypeError) as e:
        with pytest.raises(type(e)) as got:
            pro.ReadObserveConfig.parse(spec)
        assert str(got.value) == str(e)
        return
    assert vars(pro.ReadObserveConfig.parse(spec)) == vars(ref)


def test_lane_names_equal_reference():
    assert (prp.LANE_DEFAULT, prp.LANE_STALE, prp.LANE_LINEARIZABLE,
            prp.CONSISTENCY_LANES, prp.ROLE_LEADER, prp.ROLE_FOLLOWER) == \
        (jrp.LANE_DEFAULT, jrp.LANE_STALE, jrp.LANE_LINEARIZABLE,
         jrp.CONSISTENCY_LANES, jrp.ROLE_LEADER, jrp.ROLE_FOLLOWER)
    assert pro.LANES == jro.LANES


# -- ReadPath.enter on stubbed servers ------------------------------------------


class StubRaft:
    def __init__(self):
        self.is_leader = True
        self.contact = 0.0
        self.applied_index = 10
        self.read_index_calls = 0
        self.read_lease_hits = 0
        self.read_quorum_confirms = 0
        self.read_index_refused = 0

        class Cfg:
            heartbeat_interval = 0.1

        self.config = Cfg()

    def last_contact_s(self):
        return self.contact


class StubServer:
    def __init__(self, not_leader):
        self.raft = StubRaft()
        self.read_index = 0
        self.refuse = None
        self._not_leader = not_leader

    def confirmed_read_index(self, timeout=2.0):
        if self.refuse == "timeout":
            raise TimeoutError("no quorum")
        if self.refuse == "not_leader":
            raise self._not_leader("")
        return self.read_index


def lane_stream(seed, n=150):
    rng = random.Random(seed)
    for _ in range(n):
        yield {
            "leader": rng.random() < 0.4,
            "contact": rng.choice([None, 0.0, 0.02, 0.4, 3.0, 9.0]),
            "applied": rng.randrange(5, 40),
            "read_index": rng.randrange(0, 40),
            "refuse": rng.choice([None, None, None, "timeout",
                                  "not_leader"]),
            "lane": rng.choice(["default", "stale", "linearizable"]),
            "max_stale": rng.choice([None, 0.0, 50.0, 1000.0, 5000.0]),
        }


def run_lanes(mod, not_leader, seed, config):
    srv = StubServer(not_leader)
    rp = mod.ReadPath(srv, mod.ReadPathConfig.parse(config))
    rp.config.apply_wait_timeout = 0.002
    out = []
    for step in lane_stream(seed):
        srv.raft.is_leader = step["leader"]
        srv.raft.contact = 0.0 if step["leader"] else step["contact"]
        srv.raft.applied_index = step["applied"]
        srv.read_index = step["read_index"]
        srv.refuse = step["refuse"]
        try:
            meta = rp.enter(step["lane"], step["max_stale"])
            out.append(meta)
        except (RejectError, JaxReject) as e:
            out.append((e.reason, e.retry_after, str(e)))
    snap = rp.snapshot()
    snap["linearizable"].pop("wait_ms")  # wall-clock waits
    return out, snap, rp.summary()["requests"]


@pytest.mark.parametrize("config", [None, {"enabled": False},
                                    {"default_max_stale_ms": 100}])
@pytest.mark.parametrize("seed", [0, 5, 42])
def test_read_path_enter_equals_reference(seed, config):
    from nomad_tpu.raft.node import NotLeaderError as JaxNotLeader
    from nomad_tpu_torch.raft.node import NotLeaderError as PortNotLeader

    got = run_lanes(prp, PortNotLeader, seed, config)
    ref = run_lanes(jrp, JaxNotLeader, seed, config)
    assert got == ref
    assert any(isinstance(o, tuple) for o in got[0]) or config


# -- the read recorder ----------------------------------------------------------


def drive_recorder(rec, seed):
    rng = random.Random(seed)
    routes = ["/v1/jobs", "/v1/job/:job_id", "/v1/nodes", "/v1/event/stream"]
    for _ in range(300):
        r = rng.random()
        route = rng.choice(routes)
        if r < 0.5:
            rec.record_request(route, rng.choice(["plain", "blocking",
                                                  "sse"]),
                               rng.choice([200, 200, 404, 429]),
                               rng.random() / 50, rng.randrange(10, 5000))
        elif r < 0.65:
            hold = rng.random()
            rec.record_blocking(route, hold, hold + rng.random() / 100,
                                rng.random() < 0.6)
        elif r < 0.75:
            rec.sse_session_start()
            rec.sse_delivered(rng.randrange(1, 9), rng.randrange(0, 5))
            if rng.random() < 0.2:
                rec.sse_truncated()
            if rng.random() < 0.3:
                rec.sse_heartbeat()
            rec.sse_session_end()
        else:
            rec.record_staleness(rng.randrange(0, 4),
                                 role=rng.choice(["leader", "follower",
                                                  ""]),
                                 lane=rng.choice(["default", "stale",
                                                  "linearizable", ""]))
    return rec.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_read_recorder_equals_reference(seed):
    assert (drive_recorder(pro.ReadRecorder(), seed)
            == drive_recorder(jro.ReadRecorder(), seed))


# -- one-member cells, HTTP -------------------------------------------------------


class Side:
    def __init__(self, agent, convert):
        self.agent = agent
        self.convert = convert
        self.addr = f"http://127.0.0.1:{agent.http.port}"

    def get(self, path, headers=None):
        req = urllib.request.Request(self.addr + path,
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()


@pytest.fixture(scope="module")
def cells():
    ref = JaxAgent(JaxAgentConfig(server_enabled=True, dev_mode=True,
                                  http_port=0, num_schedulers=1))
    got = Agent(AgentConfig(server_enabled=True, dev_mode=True, http_port=0,
                            num_schedulers=1, device="cpu"))
    sides = []
    for agent, convert in ((ref, lambda o, c: o),
                           (got, lambda o, c: structs_from_reference(
                               to_dict(o), c))):
        agent.server.config.min_heartbeat_ttl = 3600.0
        agent.server.config.prewarm_shapes = False
        agent.start()
        sides.append(Side(agent, convert))
    try:
        nodes = []
        for i in range(4):
            node = jmock.node()
            node.id = f"read-node-{i}"
            nodes.append(node)
        job = jmock.job()
        job.id = "read-job"
        job.task_groups[0].count = 2
        for side in sides:
            srv = side.agent.server
            srv.node_batch_register([side.convert(n, "Node") for n in nodes])
            eid, _ = srv.job_register(side.convert(job, "Job"))
            srv.wait_for_eval(eid, timeout=WAIT_S)
        yield sides
    finally:
        for side in sides:
            side.agent.shutdown()


READS = [
    ("/v1/jobs", {}),
    ("/v1/jobs?stale=1", {}),
    ("/v1/jobs?stale=1&max_stale=5000", {}),
    ("/v1/nodes?consistent=1", {}),
    ("/v1/allocations", {"X-Nomad-Consistency": "stale"}),
    ("/v1/evaluations", {"X-Nomad-Consistency": "linearizable"}),
    ("/v1/job/read-job", {}),
    ("/v1/job/no-such-job?stale=1", {}),
    ("/v1/jobs?stale=1&max_stale=abc", {}),
    ("/v1/jobs?index=1&wait=50ms", {}),
]

LANE_HEADERS = ("X-Nomad-LastContact", "X-Nomad-KnownLeader")


@pytest.mark.parametrize("path, headers", READS)
def test_read_lanes_answer_like_reference(cells, path, headers):
    ref, got = (side.get(path, headers) for side in cells)
    assert got[0] == ref[0]
    for h in LANE_HEADERS:
        assert got[1].get(h) == ref[1].get(h), h
    assert ("X-Nomad-Read-Index" in got[1]) == ("X-Nomad-Read-Index"
                                                in ref[1])
    if "X-Nomad-Read-Index" in got[1]:
        assert int(got[1]["X-Nomad-LastIndex"]) >= \
            int(got[1]["X-Nomad-Read-Index"])


def test_read_books_equal_reference(cells):
    """After the same reads, both cells' read-plane books and per-route
    read books agree (latency quantiles masked)."""
    for side in cells:
        for path, headers in READS:
            side.get(path, headers)
    snaps = []
    for side in cells:
        status, _h, body = side.get("/v1/agent/reads")
        assert status == 200
        snaps.append(json.loads(body))
    ref, got = snaps
    assert got["read_path"]["served"] == ref["read_path"]["served"]
    assert got["read_path"]["stale"]["refused"] == \
        ref["read_path"]["stale"]["refused"]
    assert got["read_path"]["linearizable"]["read_index"] == \
        ref["read_path"]["linearizable"]["read_index"]

    def routes(snap):
        return {r: (b["count"], b["errors"], b["lanes"])
                for r, b in snap["endpoints"].items()
                if r != "/v1/agent/reads"}

    assert routes(got) == routes(ref)
    assert set(got) == set(ref)
    assert got["freshness"]["by_role"].keys() == \
        ref["freshness"]["by_role"].keys()
    for role, lanes in ref["freshness"]["by_role"].items():
        assert {k: v["count"] for k, v in got["freshness"]["by_role"][
            role].items()} == {k: v["count"] for k, v in lanes.items()}
    status, _h, _b = cells[1].get("/v1/agent/reads?format=prometheus")
    assert status == 501


def test_agent_routes_of_the_slice_answer(cells):
    """/v1/agent/slo, /admission, /express and the timelines answer on
    both cells with the same shape."""
    ref, got = cells
    eid = [e.id for e in got.agent.server.state_store.evals()][0]
    alloc = got.agent.server.state_store.allocs_by_job("read-job")[0].id
    for path in ("/v1/agent/slo", "/v1/agent/admission",
                 "/v1/agent/express"):
        r, g = ref.get(path), got.get(path)
        assert g[0] == r[0] == 200, path
        assert set(json.loads(g[2])) == set(json.loads(r[2])), path
    tl = json.loads(got.get(f"/v1/evaluation/{eid}/timeline")[2])
    assert tl["eval_id"] == eid and tl["submit_to_placed_ms"] is not None
    atl = json.loads(got.get(f"/v1/allocation/{alloc}/timeline")[2])
    assert atl["alloc_id"] == alloc and atl["eval_id"] == eid
    assert got.get("/v1/evaluation/nope/timeline")[0] == 404
    assert got.get("/v1/allocation/nope/timeline")[0] == 404


# -- the three-member port cell ---------------------------------------------------


@pytest.fixture(scope="module")
def cell():
    servers = form_cluster(3, ServerConfig(
        device="cpu", scheduler_backend="host", scheduler_workers=1,
        min_heartbeat_ttl=3600.0, prewarm_shapes=False),
        base_cluster=relaxed_cluster())
    fronts = []
    try:
        leader = wait_for_leader(servers, timeout=30.0)
        for i in range(3):
            node = mock.node()
            node.id = f"cell-node-{i}"
            retry_write(lambda n=node: leader.node_register(n))
        yield servers, fronts
    finally:
        for h in fronts:
            h.shutdown()
        for srv in servers:
            srv.shutdown(drain_timeout=2.0)


class MemberShim:
    def __init__(self, member):
        self.server = member

    def leader_addr(self):
        return self.server.raft.leader_addr or ""


def test_follower_confirmed_read_index_forwards(cell):
    servers, _ = cell
    leader = wait_for_leader(servers, timeout=30.0)
    follower = next(s for s in servers if s is not leader)
    before = leader.raft.read_index_calls
    idx = retry_write(lambda: follower.confirmed_read_index(timeout=5.0))
    assert idx >= 1
    assert idx <= leader.raft.commit_index
    assert leader.raft.read_index_calls > before
    # The follower's own raft refuses: only the leader confirms.
    with pytest.raises(Exception):
        follower.raft.read_index(timeout=0.2)
    assert follower.raft.last_contact_s() is not None
    assert leader.raft.last_contact_s() == 0.0


def test_follower_front_serves_the_lanes(cell):
    servers, fronts = cell
    leader = wait_for_leader(servers, timeout=30.0)
    follower = next(s for s in servers if s is not leader)
    h = HTTPServer(MemberShim(follower), port=0)
    h.start()
    fronts.append(h)
    base = h.addr

    def get(path):
        try:
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    code, headers, _ = get("/v1/nodes?stale=1&max_stale=60000")
    assert code == 200
    assert float(headers["X-Nomad-LastContact"]) >= 0
    code, headers, body = get("/v1/nodes?stale=1&max_stale=0")
    if code == 429:  # contact age > 0 ms on a follower: refused, typed
        assert json.loads(body)["reason"] == "STALE_BOUND"
        assert int(headers["Retry-After"]) >= 1
    code, headers, _ = retry_write(lambda: _ok(get("/v1/nodes?consistent=1")))
    assert code == 200
    assert int(headers["X-Nomad-LastIndex"]) >= \
        int(headers["X-Nomad-Read-Index"]) > 0
    snap = follower.read_path.snapshot()
    assert snap["served"]["follower"]["stale"] >= 1
    assert snap["served"]["follower"]["linearizable"] >= 1


def _ok(resp):
    """Retry a linearizable read the lane refused during a transition."""
    if resp[0] == 429:
        raise TimeoutError("read index refused")
    return resp


# -- read-storm-800 through the runner ----------------------------------------


@pytest.fixture(scope="module")
def read_storm_800():
    return psc.run_scenario("read-storm-800", seed=11, device="cpu")


def committed_seed_11():
    with open(os.path.join(REPO, "nomad_tpu_torch", "simcluster",
                           "reference_digests.json")) as f:
        entry = json.load(f)["scenarios"]["read-storm-800"]
    return entry["other_seeds"]["11"]


def test_read_storm_800_digest_equals_reference(read_storm_800):
    ref = committed_seed_11()
    assert ref["reproduced"] is True
    assert read_storm_800["events"]["digest"] == ref["digest"]
    assert read_storm_800["events"]["by_type"] == ref["by_type"]
    assert read_storm_800["placements"]["placed"] == ref["placed"] == 720
    assert read_storm_800["events"]["truncated"] is False


def test_read_storm_800_contrast_arm_digest_matches(read_storm_800):
    contrast = read_storm_800["contrast"]
    assert contrast["run"] is True and contrast["digest_matches"] is True
    assert contrast["events"]["digest"] == committed_seed_11()["digest"]
    assert contrast["reads"]["enabled"] is False
    assert contrast["reads"]["lanes"]["enabled"] is False
    assert contrast["reads"]["fleet"]["pollers"]["requests"] > 0
    assert slo.evaluate_read_lanes({"reads": contrast["reads"]}) == []


def test_read_storm_800_lanes_verdict(read_storm_800):
    reads = read_storm_800["reads"]
    assert reads["enabled"] is True and len(reads["by_member"]) == 2
    lanes = reads["lanes"]
    assert lanes["enabled"] is True and lanes["members"] == 3
    assert lanes["follower_serve_share"] >= 0.80
    assert lanes["linear_reads"] > 0
    assert lanes["linear_violations"] == 0
    assert lanes["stamp_missing"] == 0
    assert lanes["stale_age_ms"]["n"] > 0
    rows = slo.evaluate_read_lanes(read_storm_800)
    assert rows and all(r["met"] is not False for r in rows)
    fleet = reads["fleet"]
    assert fleet["pollers"]["readers"] == 2
    assert fleet["watchers"]["readers"] == 2
    assert fleet["sse_tails"]["readers"] == 1
    for b in reads["by_member"].values():
        assert b["sse"]["active"] == 0
        for books in (b.get("blocking") or {}).values():
            assert books["count"] == books["wakes"] + books["timeouts"]
