"""The port's debug bundle (nomad_tpu_torch.bundle) against nomad_tpu's.

The bundle's format string, section list, report path and size bounds
equal nomad_tpu's; ``redact_config`` gives nomad_tpu's output on the same
configs; ``collect()`` with no agent and with a live port agent carries
every section nomad_tpu's carries, the config redacted; the debug routes
are gated by ``enable_debug``. One section differs by decision: the port
has no device circuit breaker (a device fault fails the eval), so
``breaker`` names the server's device and says so where nomad_tpu reports
its DEVICE_BREAKER. The lint report is read from the process's temp
directory under nomad_tpu's file name.

Tolerance: exact for keys and redacted values; counts of live things
(threads, events) are held to be positive.
"""

import json
import threading
import time

import pytest

from nomad_tpu import bundle as jb
from nomad_tpu_torch import bundle as pb
from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import ApiClient
from nomad_tpu_torch.api.client import ApiError
from nomad_tpu_torch.events import EventBroker


def test_constants_are_nomad_tpus():
    assert pb.BUNDLE_FORMAT == jb.BUNDLE_FORMAT
    assert pb.BUNDLE_SECTIONS == jb.BUNDLE_SECTIONS
    assert pb.NOMADLINT_REPORT_PATH == jb.NOMADLINT_REPORT_PATH
    assert (pb.MAX_FULL_TRACES, pb.TIMELINE_WORST_K) == (
        jb.MAX_FULL_TRACES, jb.TIMELINE_WORST_K)


class Opaque:
    def __str__(self):
        return "opaque!"


@pytest.mark.parametrize("config", [
    {"atlas_token": "hunter2", "node_name": "n1", "port": 4646},
    {"Secret_Key": "s", "db_password": "", "api_TOKEN": None, "ok": True},
    {"nested": {"vault_token": "x", "depth": {"password": "p", "n": 1.5}}},
    {"servers": ["a:1", Opaque(), 3], "tls": Opaque(), "ratio": 0.25},
    {},
])
def test_redaction_equals_nomad_tpus(config):
    assert pb.redact_config(config) == jb.redact_config(config)


def test_redaction_hides_set_secrets_only():
    got = pb.redact_config({"atlas_token": "hunter2", "db_password": "",
                            "cert_file": "/etc/x.pem"})
    assert got == {"atlas_token": "<redacted>", "db_password": "",
                   "cert_file": "/etc/x.pem"}


def test_thread_stacks_name_every_thread():
    stop = threading.Event()
    twins = [threading.Thread(target=stop.wait, name="worker-0", daemon=True)
             for _ in range(2)]
    for t in twins:
        t.start()
    try:
        stacks = pb.thread_stacks(depth=4)
        assert "MainThread" in stacks
        twins_seen = [k for k in stacks if k.startswith("worker-0")]
        assert len(twins_seen) >= 2 and any("#" in k for k in twins_seen)
        assert all(len(v) <= 4 for v in stacks.values())
    finally:
        stop.set()
        for t in twins:
            t.join()


def test_process_local_bundle_has_nomad_tpus_sections():
    broker = EventBroker()
    broker.publish("Node", "NodeRegistered", key="n1")
    got = pb.collect(agent=None, last_events=10)
    ref = jb.collect(agent=None, last_events=10)
    assert set(got) == set(ref) == set(pb.BUNDLE_SECTIONS)
    assert got["format"] == pb.BUNDLE_FORMAT
    assert any(e["type"] == "NodeRegistered" for e in got["events"])
    assert len(got["events"]) <= 10
    assert got["config"] is None and got["slo"] is None
    assert "intervals" in got["metrics"] and "cumulative" in got["metrics"]
    assert "delta_rolls" in got["mirror"]
    assert "committed" in got["plan_pipeline"]
    assert "node_padding_waste" in got["solver"]
    json.dumps(got)


def test_breaker_section_states_the_deliberate_difference():
    got = pb.collect(agent=None)["breaker"]
    ref = jb.collect(agent=None)["breaker"]
    assert "state" in ref  # nomad_tpu's DEVICE_BREAKER
    assert got == {"breaker": None, "device": None,
                   "statement": pb.BREAKER_STATEMENT}
    assert "fails the eval" in pb.BREAKER_STATEMENT
    assert "no host route" in pb.BREAKER_STATEMENT


def test_lint_report_is_read_from_the_temp_dir(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert pb._nomadlint_section() is None
    path = tmp_path / "nomadlint_report.json"
    path.write_text(json.dumps({"findings": [], "repo": "x"}))
    section = pb._nomadlint_section()
    assert section["path"] == str(path) == pb.nomadlint_report_path()
    assert section["report"] == {"findings": [], "repo": "x"}
    path.write_text("{not json")
    assert pb._nomadlint_section() is None


@pytest.fixture(scope="module")
def agent(tmp_path_factory):
    a = Agent(AgentConfig(server_enabled=True, dev_mode=True, http_port=0,
                          num_schedulers=1, device="cpu", enable_debug=True,
                          node_name="bundle-dev",
                          data_dir=str(tmp_path_factory.mktemp("agent"))))
    a.server.config.min_heartbeat_ttl = 3600.0
    a.server.config.prewarm_shapes = False
    a.start()
    a.server.node_batch_register([mock.node() for _ in range(4)])
    job = mock.job()
    job.task_groups[0].count = 2
    eid, _ = a.server.job_register(job)
    assert a.server.wait_for_eval(eid, timeout=30.0).status == "complete"
    yield a
    a.shutdown()


def test_agent_bundle_carries_every_section(agent):
    client = ApiClient(address=agent.http.addr)
    agent.config.atlas_token = "hunter2"
    try:
        bundle = client.agent().debug_bundle()
    finally:
        del agent.config.atlas_token
    assert set(bundle) == set(pb.BUNDLE_SECTIONS)
    assert bundle["format"] == pb.BUNDLE_FORMAT
    assert bundle["config"]["atlas_token"] == "<redacted>"
    assert bundle["config"]["node_name"] == "bundle-dev"
    assert bundle["events"], "bundle carries no events"
    assert any("http" in n or n == "MainThread" for n in bundle["threads"])
    assert bundle["breaker"]["device"] == "cpu"
    assert "sites" in bundle["faults"]
    assert bundle["capacity"]["nodes"]["total"] == 4
    assert bundle["raft"] is not None and bundle["reads"] is not None
    assert bundle["admission"] is not None and bundle["express"] is not None
    assert bundle["solver"]["solves"] >= 1
    assert "profiler" in bundle["profile"]
    assert bundle["runtime"]["bytes"]["rss"]["current_bytes"] > 0
    assert isinstance(bundle["timelines"], list)
    assert bundle["traces"]["summaries"]


def test_agent_bundle_events_limit(agent):
    bundle = pb.collect(agent=agent, last_events=3)
    assert len(bundle["events"]) == 3
    times = [(e["time"], e["index"]) for e in bundle["events"]]
    assert times == sorted(times)


def test_debug_route_answers(agent):
    info = ApiClient(address=agent.http.addr).agent().debug()
    assert set(info) == {"threads", "gc", "tracemalloc_top", "device",
                         "coalescer", "mirror_cache"}
    assert info["device"]["device"] == "cpu"
    assert info["gc"]["objects"] is None


def test_debug_routes_are_gated(tmp_path):
    a = Agent(AgentConfig(server_enabled=True, dev_mode=True, http_port=0,
                          num_schedulers=1, device="cpu",
                          data_dir=str(tmp_path)))
    a.server.config.min_heartbeat_ttl = 3600.0
    a.start()
    try:
        api = ApiClient(address=a.http.addr).agent()
        for call in (api.debug_bundle, api.debug):
            with pytest.raises(ApiError) as err:
                call()
            assert err.value.code == 404
        t0 = time.monotonic()
        assert api.metrics()["intervals"] is not None
        assert time.monotonic() - t0 < 10.0
    finally:
        a.shutdown()
