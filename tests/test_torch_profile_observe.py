"""The port's runtime self-observatory (nomad_tpu_torch.profile_observe)
against nomad_tpu's.

- Config: the same specs parse to the same configs, and the same
  nonsense is refused with the same message, in both packages (also at
  config-file load, with ``telemetry { lock_watchdog }`` typed).
- The role taxonomy: the same names classify alike, and every thread the
  port's server, cluster member, agent and express lane start falls into
  nomad_tpu's roles (no port thread is "other" where nomad_tpu's is not).
- The sampler's schedule is nomad_tpu's for the same seed.
- Golden exports: the same ingested stacks give byte-equal collapsed text
  and a speedscope document equal to nomad_tpu's but for its ``name`` and
  ``exporter``; the profiler view and overflow books are equal.
- The byte ledger of the same nodes in both packages' mirrors: the same
  buffer names, dtypes, ``padded`` and ``projected_1m_rows``, and equal
  bytes for every buffer the port keeps with the same shape (the port's
  device buffers are tensors, counted from metadata).
- The observatory's refresh, summary and locks view over an active
  watchdog, and a live port agent's /v1/agent/profile, /runtime and
  SDK accessors, Runtime events, and the 404s with the profiler off.

Tolerance: exact, except RSS and sizes of Python objects, which are held
to be positive.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque

import numpy as np
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu import profile_observe as jpo
from nomad_tpu import telemetry as jt
from nomad_tpu.api.codec import to_dict
from nomad_tpu_torch import profile_observe as ppo
from nomad_tpu_torch import telemetry as pt
from nomad_tpu_torch.api import ApiClient
from nomad_tpu_torch.convert import structs_from_reference

SPECS = [None, {"enabled": False, "sample_interval": 0.1, "seed": 7,
                "max_depth": 8, "events_interval": 0},
         {"jitter": 0.0, "max_stacks": 3, "ledger_interval": 2}]
BAD = [({"sample_intervall": 1.0}, "unknown profile config key"),
       ("fast", "must be a mapping"),
       ({"sample_interval": 0}, "sample_interval must be > 0"),
       ({"jitter": 1.0}, r"jitter must be in \[0, 1\)"),
       ({"seed": -1}, "seed must be >= 0"),
       ({"max_depth": 0}, "max_depth must be > 0"),
       ({"max_stacks": 0}, "max_stacks must be > 0"),
       ({"ledger_interval": 0}, "ledger_interval must be > 0"),
       ({"events_interval": -1}, "events_interval must be >= 0")]


@pytest.mark.parametrize("spec", SPECS)
def test_config_parses_as_nomad_tpus(spec):
    got = ppo.ProfileObserveConfig.parse(spec)
    ref = jpo.ProfileObserveConfig.parse(spec)
    assert vars(got) == vars(ref)


@pytest.mark.parametrize("spec, match", BAD)
def test_config_refuses_what_nomad_tpu_refuses(spec, match):
    for mod in (jpo, ppo):
        with pytest.raises(ValueError, match=match):
            mod.ProfileObserveConfig.parse(spec)


def test_file_config_validates_the_profile_block(tmp_path):
    from nomad_tpu_torch.agent import AgentConfig
    from nomad_tpu_torch.agent_config import load_config_file

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(
        {"server": {"enabled": True, "profile": {"sample_rate": 1}}}))
    with pytest.raises(ValueError, match="unknown profile config key"):
        load_config_file(str(bad))
    bad_wd = tmp_path / "bad_wd.json"
    bad_wd.write_text(json.dumps({"telemetry": {"lock_watchdog": "yes"}}))
    with pytest.raises(ValueError, match="lock_watchdog must be a bool"):
        load_config_file(str(bad_wd))
    good = tmp_path / "good.json"
    good.write_text(json.dumps(
        {"server": {"enabled": True,
                    "profile": {"sample_interval": 0.25, "seed": 9}},
         "telemetry": {"lock_watchdog": True}}))
    cfg = load_config_file(str(good))
    assert cfg.server.profile == {"sample_interval": 0.25, "seed": 9}
    ac = AgentConfig.from_file_config(cfg)
    assert ac.profile == {"sample_interval": 0.25, "seed": 9}
    assert ac.lock_watchdog is True


THREAD_NAMES = [
    "worker-0", "worker-13", "plan-pipeline", "plan-pipeline-wait",
    "raft-election", "raft-leader", "raft-compact-n1", "heartbeat-wheel",
    "express-commit", "raft-observatory", "read-observatory",
    "runtime-profiler", "capacity-accountant", "stats-emitter",
    "slo-monitor", "http-server", "Thread-4 (process_request_thread)",
    "MainThread", "membership-n1", "failed-eval-reaper", "solve-coalescer",
    "pytest-watcher",
]


@pytest.mark.parametrize("name", THREAD_NAMES)
def test_role_of_a_thread_name_is_nomad_tpus(name):
    assert ppo.classify_thread(name) == jpo.classify_thread(name)
    assert ppo.classify_thread(name) in ppo.ROLES


def test_roles_are_nomad_tpus():
    assert ppo.ROLES == jpo.ROLES
    assert ppo._ROLE_PREFIXES == jpo._ROLE_PREFIXES


def test_port_threads_fall_into_nomad_tpus_roles(tmp_path):
    """Every thread a started port server (express lane on) and a
    one-member cluster agent run classifies as nomad_tpu would, and the
    roles nomad_tpu gives its subsystems appear."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.agent import Agent, AgentConfig

    # Thread objects, not idents: a thread of an earlier test that ends
    # meanwhile frees its ident for one of this server's threads.
    before = set(threading.enumerate())
    agent = Agent(AgentConfig(server_enabled=True, http_port=0, rpc_port=0,
                              bootstrap_expect=1, num_schedulers=2,
                              data_dir=str(tmp_path), device="cpu",
                              express={"enabled": True}))
    agent.server.config.min_heartbeat_ttl = 3600.0
    agent.start()
    try:
        deadline = time.monotonic() + 30
        while not agent.server.raft.is_leader:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        agent.server.node_batch_register([mock.node() for _ in range(4)])
        client = ApiClient(address=f"http://127.0.0.1:{agent.http.port}")
        client.agent().self_info()
        want = {"worker", "pipeline-committer", "raft", "heartbeat-wheel",
                "express-committer", "observer", "http"}
        # A subsystem may start its thread a moment after the call that
        # asked for it returns (under load, the heartbeat wheel's):
        # wait for the roles, then hold every thread to nomad_tpu's.
        deadline = time.monotonic() + 30
        while True:
            names = [t.name for t in threading.enumerate()
                     if t not in before]
            roles = {ppo.classify_thread(n) for n in names}
            if (want <= roles and "runtime-profiler" in names
                    or time.monotonic() > deadline):
                break
            time.sleep(0.01)
        for n in names:
            assert ppo.classify_thread(n) == jpo.classify_thread(n), n
        assert want <= roles, names
        assert "runtime-profiler" in names
    finally:
        agent.shutdown()


@pytest.mark.parametrize("seed", [0, 42, 1234])
@pytest.mark.parametrize("interval, jitter", [(0.05, 0.2), (0.1, 0.0),
                                              (0.01, 0.9)])
def test_sample_schedule_is_nomad_tpus(seed, interval, jitter):
    got = ppo.sample_schedule(seed, interval, jitter, 200)
    assert got == jpo.sample_schedule(seed, interval, jitter, 200)
    assert all(interval * (1 - jitter) <= g <= interval * (1 + jitter)
               for g in got)


def _here():
    return sys._getframe(0)


def test_frame_naming_and_collapse_are_nomad_tpus():
    frame = _here()
    assert ppo.frame_label(frame) == jpo.frame_label(frame) \
        == "test_torch_profile_observe:_here"
    for depth in (64, 3, 1):
        assert ppo.collapse_frames(frame, depth) == \
            jpo.collapse_frames(frame, depth)
    assert ppo.collapse_frames(frame, 3)[0] == "…"


STACKS = [("worker", ("agent:main", "worker:run", "fit:solve")),
          ("worker", ("agent:main", "worker:run", "fit:solve")),
          ("worker", ("agent:main", "worker:run", "plan:submit")),
          ("raft", ("agent:main", "raft:apply")),
          ("http", ("http:serve", "api:handle", "json:dumps")),
          ("raft", ("agent:main", "raft:apply"))]


def _observatories(**cfg):
    out = []
    for mod in (jpo, ppo):
        obs = mod.RuntimeObservatory(mod.ProfileObserveConfig.parse(
            cfg or None))
        for role, stack in STACKS:
            obs._ingest(role, stack)
        out.append(obs)
    return out


def test_golden_collapsed_equals_nomad_tpus():
    j, p = _observatories()
    assert p.collapsed() == j.collapsed()
    assert p.collapsed().splitlines()[0] == \
        "http;http:serve;api:handle;json:dumps 1"


def test_golden_speedscope_equals_nomad_tpus_but_its_names():
    j, p = _observatories()
    got, ref = p.speedscope(), j.speedscope()
    assert (got.pop("name"), got.pop("exporter")) == (
        "nomad_tpu_torch runtime profile", "nomad_tpu_torch.profile_observe")
    ref.pop("name")
    ref.pop("exporter")
    assert got == ref
    json.loads(json.dumps(p.speedscope()))


@pytest.mark.parametrize("max_stacks", [2, 4096])
def test_profiler_view_and_overflow_equal_nomad_tpus(max_stacks):
    j, p = _observatories(max_stacks=max_stacks)
    assert p.profile_view() == j.profile_view()
    view = p.profile_view()["profiler"]
    assert view["stack_overflow"] == (3 if max_stacks == 2 else 0)
    assert view["roles"]["worker"]["wall_share"] == 0.5


def test_sample_once_sees_live_threads():
    obs = ppo.RuntimeObservatory(ppo.ProfileObserveConfig())
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="worker-99", daemon=True)
    t.start()
    try:
        assert obs.sample_once() >= 1
        view = obs.profile_view()["profiler"]
        assert view["samples"] == 1 and "worker" in view["roles"]
    finally:
        stop.set()
        t.join()


def test_rss_and_ring_footprint():
    rss = ppo.rss_bytes()
    assert rss["current_bytes"] > 0
    assert rss["peak_bytes"] >= rss["current_bytes"] // 2
    ring = deque(({"id": "x" * 32, "n": i} for i in range(100)), maxlen=64)
    got, ref = ppo.container_footprint(ring), jpo.container_footprint(ring)
    assert got == ref
    assert (got["entries"], got["capacity"]) == (64, 64)
    assert ppo._deep_sizeof({"k": list(range(50))}) == \
        jpo._deep_sizeof({"k": list(range(50))})


def _nodes(seed, n):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n):
        node = jmock.node()
        node.id = f"node-{seed}-{i:05d}"
        node.resources.cpu = int(rng.integers(1000, 8000))
        node.resources.memory_mb = int(rng.integers(1024, 16384))
        nodes.append(node)
    return nodes


@pytest.mark.parametrize("seed, n", [(0, 10), (3, 100), (42, 700)])
def test_byte_ledger_equals_nomad_tpus(seed, n):
    from nomad_tpu.tpu.mirror import NodeMirror as JaxMirror
    from nomad_tpu_torch.tpu.mirror import NodeMirror

    nodes = _nodes(seed, n)
    ref = JaxMirror(nodes).byte_ledger()
    got = NodeMirror([structs_from_reference(to_dict(x), "Node")
                      for x in nodes], device="cpu").byte_ledger()
    assert (got["rows"], got["padded"]) == (ref["rows"], ref["padded"])
    assert set(got["buffers"]) == set(ref["buffers"])
    for name, buf in ref["buffers"].items():
        assert got["buffers"][name] == buf, name
    assert got["buffer_bytes"] == ref["buffer_bytes"]


@pytest.mark.parametrize("n", [20, 300])
def test_cache_ledger_projects_as_nomad_tpus(n):
    from nomad_tpu.tpu.mirror import MirrorCache as JaxCache
    from nomad_tpu.tpu.mirror import NodeMirror as JaxMirror
    from nomad_tpu_torch.tpu.mirror import MirrorCache, NodeMirror

    nodes = _nodes(n, n)
    port_nodes = [structs_from_reference(to_dict(x), "Node") for x in nodes]
    jc, pc = JaxCache(), MirrorCache()
    assert pc.byte_ledger()["per_row_bytes"] is None
    assert pc.byte_ledger()["projected_1m_bytes"] is None
    jc._entries[("uid", 1, ("dc1",))] = (nodes, JaxMirror(nodes))
    pc._entries[("uid", 1, ("dc1",))] = (
        port_nodes, NodeMirror(port_nodes, device="cpu"))
    got, ref = pc.byte_ledger(), jc.byte_ledger()
    for key in ("mirrors", "rows", "padded_rows", "by_bucket_dtype",
                "buffer_bytes", "cache_bytes", "total_bytes",
                "per_row_bytes", "projected_1m_rows",
                "projected_1m_bytes"):
        assert got[key] == ref[key], key
    assert got["projected_1m_rows"] == 1_048_576
    assert got["projected_1m_bytes"] == int(got["per_row_bytes"] * 1_048_576)
    assert pc.device_bytes() == 0  # CPU tensors: nothing on a card


def test_observatory_refresh_builds_the_ledger():
    ring = deque(range(50), maxlen=64)
    table = {"k": list(range(100))}
    views = []
    for mod in (jpo, ppo):
        obs = mod.RuntimeObservatory(
            mod.ProfileObserveConfig(),
            rings_getter=lambda: {"my_ring": ring, "gone": None},
            tables_getter=lambda: {"my_table": table})
        obs.refresh()
        views.append(obs.runtime_view())
    got, ref = views
    assert set(got) == set(ref) and set(got["bytes"]) == set(ref["bytes"])
    assert got["bytes"]["rings"] == ref["bytes"]["rings"]
    assert got["bytes"]["tables"] == ref["bytes"]["tables"]
    assert got["bytes"]["rss"]["current_bytes"] > 0
    assert got["observer"] == {"polls": 1, "events_published": 0}


def test_store_ledger_counts_the_tables_without_listing_allocs():
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.state.store import StateStore

    store = StateStore()
    store.upsert_node(1, mock.node())
    job = mock.job()
    store.upsert_job(2, job)
    obs = ppo.RuntimeObservatory(store_getter=lambda: store)
    obs.refresh()
    ledger = obs.runtime_view()["bytes"]["store"]
    assert ledger["counts"] == {"jobs": 1, "nodes": 1, "allocs": 0,
                                "evals": 0}
    assert ledger["approx_bytes"] > 0


@pytest.mark.parametrize("mod, obs_mod", [(jt, jpo), (pt, ppo)],
                         ids=["nomad_tpu", "port"])
def test_locks_view_reads_the_active_watchdog(mod, obs_mod):
    obs = obs_mod.RuntimeObservatory(obs_mod.ProfileObserveConfig())
    assert obs.runtime_view()["locks"] == {"installed": False}
    wd = mod.LockWatchdog(order=["a"], sites={})
    with wd:
        lock = wd.watch(threading.Lock(), "a")
        with lock:
            pass
        view = obs.runtime_view()["locks"]
        assert view["installed"] is True
        assert view["contention"][0]["lock"] == "a"
        summary = obs.summary()
        assert summary["contended_sites"] == 0


# -- a live port agent ---------------------------------------------------------


@pytest.fixture(scope="module")
def agent(tmp_path_factory):
    from nomad_tpu_torch.agent import Agent, AgentConfig

    a = Agent(AgentConfig(
        server_enabled=True, dev_mode=True, http_port=0, num_schedulers=1,
        device="cpu", lock_watchdog=True,
        data_dir=str(tmp_path_factory.mktemp("agent")),
        profile={"sample_interval": 0.02, "ledger_interval": 0.2,
                 "events_interval": 0.3}))
    a.server.config.min_heartbeat_ttl = 3600.0
    a.server.config.prewarm_shapes = False
    a.start()
    yield a
    a.shutdown()
    assert pt.active_lock_watchdog() is None


def _get(agent, path):
    try:
        with urllib.request.urlopen(agent.http.addr + path,
                                    timeout=15) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_for_samples(agent, n=5, timeout=15):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        obs = agent.server.runtime_observatory
        if obs.samples >= n and obs.polls >= 1:
            return
        time.sleep(0.05)
    pytest.fail(f"profiler never reached {n} samples")


def test_profile_route(agent):
    _wait_for_samples(agent)
    status, body = _get(agent, "/v1/agent/profile")
    assert status == 200
    prof = json.loads(body)["profiler"]
    assert prof["samples"] >= 5 and prof["schedule"]["seed"] == 42
    assert set(prof["roles"]) <= set(ppo.ROLES) and "main" in prof["roles"]
    assert abs(sum(r["wall_share"] for r in prof["roles"].values())
               - 1.0) < 0.01


def test_profile_collapsed_and_speedscope(agent):
    _wait_for_samples(agent)
    status, body = _get(agent, "/v1/agent/profile?format=collapsed")
    assert status == 200
    for line in body.decode().splitlines():
        stack, _, count = line.rpartition(" ")
        assert int(count) >= 1 and stack.split(";")[0] in ppo.ROLES
    status, body = _get(agent, "/v1/agent/profile?format=speedscope")
    doc = json.loads(body)
    assert status == 200 and doc["profiles"]
    assert doc["exporter"] == "nomad_tpu_torch.profile_observe"


def test_runtime_route_and_its_prometheus(agent):
    _wait_for_samples(agent)
    status, body = _get(agent, "/v1/agent/runtime")
    view = json.loads(body)
    assert status == 200
    assert view["locks"]["installed"] is True
    assert view["locks"]["locks_tracked"] > 0
    assert view["locks"]["violations"] == 0
    assert "events" in view["bytes"]["rings"]
    status, body = _get(agent, "/v1/agent/runtime?format=prometheus")
    text = body.decode()
    assert status == 200
    assert "# TYPE nomad_profile_samples_total counter" in text
    assert 'nomad_profile_role_share{role="main"}' in text
    assert "nomad_lock_acquisitions_total{lock=" in text
    status, body = _get(agent, "/v1/agent/metrics?format=prometheus")
    assert "nomad_lock_wait_ms_total" in body.decode()
    doc = json.loads(_get(agent, "/v1/agent/metrics")[1])
    assert doc["runtime"]["samples"] >= 1
    assert doc["locks"]["installed"] is True


def test_sdk_profile_and_runtime(agent):
    _wait_for_samples(agent)
    api = ApiClient(address=agent.http.addr).agent()
    assert api.profile()["profiler"]["samples"] >= 1
    assert api.runtime()["bytes"]["tracked_bytes"] > 0


def test_runtime_events_ride_the_observer_topic(agent):
    from nomad_tpu_torch.events import OBSERVER_TOPICS

    assert "Runtime" in OBSERVER_TOPICS
    client = ApiClient(address=agent.http.addr)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        _idx, events, _trunc = client.events().list(topics=["Runtime"])
        if events:
            assert events[0]["type"] == "RuntimeSnapshot"
            assert "top_role" in events[0]["payload"]
            return
        time.sleep(0.2)
    pytest.fail("no Runtime snapshot event within 15s")


def test_profiler_off_answers_404(tmp_path):
    from nomad_tpu_torch.agent import Agent, AgentConfig

    a = Agent(AgentConfig(server_enabled=True, dev_mode=True, http_port=0,
                          num_schedulers=1, device="cpu",
                          data_dir=str(tmp_path), profile={"enabled": False}))
    a.server.config.min_heartbeat_ttl = 3600.0
    a.start()
    try:
        assert a.server.runtime_observatory._thread is None
        assert _get(a, "/v1/agent/profile")[0] == 404
        assert _get(a, "/v1/agent/runtime")[0] == 404
        status, body = _get(a, "/v1/agent/metrics")
        assert status == 200 and json.loads(body)["runtime"] is None
        assert a.server.stats()["runtime"] is None
    finally:
        a.shutdown()
