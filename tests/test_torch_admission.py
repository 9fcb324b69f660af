"""The port's admission front door (server/admission.py) against nomad_tpu's.

- ``AdmissionConfig.parse`` accepts and refuses the same specs with the
  same messages; the lane mapping is the same.
- ``AdmissionController``: one seeded stream of submissions (clients,
  lanes, queue depths, burn rates, clock steps) through both packages'
  controllers, each on a fake clock that both read, gives the same
  admit/reject sequence, reasons, retry-after hints and messages, the
  same snapshot and the same ``Admission`` events.
- ``Server.job_register`` / ``job_evaluate`` consult the door before any
  raft apply, with the same decisions as nomad_tpu's ``Server``; a
  rejection has no side effect; HTTP answers 429 with Retry-After.
- ``overdrive-1k`` through the port's scenario runner gives nomad_tpu's
  committed canonical digest, and the door admits and rejects what
  nomad_tpu's admits and rejects.

Tolerance: exact (host decisions on identical inputs).
"""

import json
import os
import random
import urllib.error
import urllib.request

import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.api.codec import to_dict
from nomad_tpu.events import EventBroker as JaxBroker
from nomad_tpu.server import admission as jadm
from nomad_tpu.server.server import Server as JaxServer
from nomad_tpu.server.server import ServerConfig as JaxServerConfig
from nomad_tpu.structs import RejectError as JaxReject
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.events import EventBroker as PortBroker
from nomad_tpu_torch.server import admission as padm
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.simcluster import scenario as psc
from nomad_tpu_torch.structs import RejectError

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- config and lanes ---------------------------------------------------------


@pytest.mark.parametrize("spec", [
    None, {}, {"client_rate": 5, "client_burst": 10},
    {"enabled": False}, {"client_rate": 0.02, "client_burst": 1},
    {"shed_start_burn": 1.0, "shed_full_burn": 3.0, "max_clients": 9},
    {"client_rate": -1}, {"client_burst": -2}, {"max_clients": 0},
    {"shed_start_burn": -1}, {"shed_start_burn": 2, "shed_full_burn": 2},
    {"client_rte": 1}, "not a mapping",
])
def test_admission_config_parse_equals_reference(spec):
    try:
        ref = jadm.AdmissionConfig.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            padm.AdmissionConfig.parse(spec)
        assert str(got.value) == str(e)
        return
    got = padm.AdmissionConfig.parse(spec)
    assert vars(got) == vars(ref)
    assert got.burst == ref.burst


@pytest.mark.parametrize("jtype", ["batch", "service", "system"])
@pytest.mark.parametrize("express", [False, True])
def test_lane_mapping_equals_reference(jtype, express):
    job = jmock.job()
    job.type = jtype
    job.express = express
    pjob = structs_from_reference(to_dict(job), "Job")
    assert padm.lane_for(jtype) == jadm.lane_for(jtype)
    assert padm.lane_for_job(pjob) == jadm.lane_for_job(job)
    assert (padm.LANE_SERVICE, padm.LANE_BATCH, padm.LANE_EXPRESS,
            padm.SHED_LANES) == (jadm.LANE_SERVICE, jadm.LANE_BATCH,
                                 jadm.LANE_EXPRESS, jadm.SHED_LANES)


# -- the controller on a shared fake clock ------------------------------------


class FakeClock:
    """Stands in for each admission module's ``time``: monotonic() is the
    test's clock, time() a fixed wall stamp."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def time(self):
        return 1_700_000_000.0


CONTROLLER_CONFIGS = {
    "rate": dict(client_rate=0.5, client_burst=2),
    "rate-evicting": dict(client_rate=1.0, client_burst=1, max_clients=3),
    "queue": dict(),
    "shed": dict(shed_start_burn=1.0, shed_full_burn=3.0),
    "everything": dict(client_rate=2.0, client_burst=3,
                       shed_start_burn=0.5, shed_full_burn=2.5,
                       max_clients=5),
    "off": dict(enabled=False, client_rate=0.1),
}


def decision_stream(seed, n=200):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        out.append({
            "dt": rng.choice([0.0, 0.0, 0.01, 0.3, 1.7]),
            "client": f"c{rng.randrange(6)}",
            "lane": rng.choice(["batch", "service", "express"]),
            "depth": rng.randrange(12),
            "burn": rng.choice([0.0, 0.8, 1.5, 2.2, 4.0]),
        })
    return out


def run_controller(mod, broker_cls, name, seed, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", clock)
    state = {"depth": 0, "burn": 0.0}
    events = broker_cls(register=False)
    cap = 8 if name in ("queue", "everything") else 0
    ctl = mod.AdmissionController(
        mod.AdmissionConfig(**CONTROLLER_CONFIGS[name]), seed=seed,
        queue_depth=lambda: state["depth"], queue_cap=cap,
        burn_rate=lambda: state["burn"], events=events)
    decisions = []
    for step in decision_stream(seed):
        clock.now += step["dt"]
        state["depth"], state["burn"] = step["depth"], step["burn"]
        try:
            ctl.admit(step["client"], step["lane"], ref="job")
            decisions.append("admit")
        except (RejectError, JaxReject) as e:
            decisions.append((e.reason, e.retry_after, str(e)))
    _, evs, _ = events.events_after(0)
    published = [(e.topic, e.type, e.key, e.payload) for e in evs]
    return decisions, ctl.snapshot(), published


@pytest.mark.parametrize("name", sorted(CONTROLLER_CONFIGS))
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_decision_stream_equals_reference(name, seed, monkeypatch):
    got = run_controller(padm, PortBroker, name, seed, monkeypatch)
    ref = run_controller(jadm, JaxBroker, name, seed, monkeypatch)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2]
    if name not in ("off",):
        assert any(d != "admit" for d in got[0]) or name == "queue"


# -- the server's front door --------------------------------------------------


def servers(admission, seed=5, cap=0):
    ref = JaxServer(JaxServerConfig(
        scheduler_workers=0, scheduler_backend="host", prewarm_shapes=False,
        admission=admission, seed=seed, eval_pending_cap=cap))
    got = Server(ServerConfig(
        scheduler_workers=0, scheduler_backend="host", prewarm_shapes=False,
        admission=admission, seed=seed, eval_pending_cap=cap,
        device="cpu"))
    return ref, got


def register_stream(seed, n=40):
    rng = random.Random(seed)
    jobs = []
    for k in range(n):
        job = jmock.job()
        job.id = f"adm-{seed}-{k}"
        job.type = rng.choice(["batch", "service"])
        job.task_groups[0].count = 1
        jobs.append((job, f"client-{rng.randrange(4)}"))
    return jobs


def drive(srv, jobs, convert):
    out = []
    for job, client in jobs:
        try:
            srv.job_register(convert(job), client_id=client)
            out.append("admit")
        except (RejectError, JaxReject) as e:
            out.append(e.reason)
    return out


@pytest.mark.parametrize("admission, cap", [
    ({"client_rate": 0.001, "client_burst": 3}, 0),
    ({"client_rate": 0.001, "client_burst": 1}, 0),
    (None, 0),
    ({}, 6),
])
@pytest.mark.parametrize("seed", [1, 42])
def test_server_register_decisions_equal_reference(admission, cap, seed):
    ref, got = servers(admission, seed=seed, cap=cap)
    jobs = register_stream(seed)
    try:
        ref_out = drive(ref, jobs, lambda j: j)
        got_out = drive(got, jobs,
                        lambda j: structs_from_reference(to_dict(j), "Job"))
        assert got_out == ref_out
        # A rejection has no side effect: only admitted jobs exist.
        admitted = {job.id for (job, _), d in zip(jobs, got_out)
                    if d == "admit"}
        assert {j.id for j in got.state_store.jobs()} == admitted
        assert got.admission.summary() == ref.admission.summary()
        # Eval ingress is gated like registration.
        if admitted:
            jid = sorted(admitted)[0]
            client = dict((j.id, c) for j, c in jobs)[jid]
            outs = []
            for srv in (ref, got):
                try:
                    srv.job_evaluate(jid, client_id=client)
                    outs.append("admit")
                except (RejectError, JaxReject) as e:
                    outs.append(e.reason)
            assert outs[0] == outs[1]
    finally:
        ref.shutdown()
        got.shutdown()


def test_http_rejection_is_429_with_retry_after():
    agent = Agent(AgentConfig(
        server_enabled=True, dev_mode=True, http_port=0, num_schedulers=0,
        device="cpu", admission={"client_rate": 0.001, "client_burst": 1}))
    agent.server.config.prewarm_shapes = False
    agent.start()
    try:
        addr = f"http://127.0.0.1:{agent.http.port}"
        codes = []
        for k in range(2):
            job = jmock.job()
            job.id = f"http-{k}"
            req = urllib.request.Request(
                addr + "/v1/jobs", method="PUT",
                data=json.dumps({"job": to_dict(job)}).encode(),
                headers={"X-Nomad-Client": "tenant-a"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    codes.append((r.status, None, None))
            except urllib.error.HTTPError as e:
                body = json.loads(e.read())
                codes.append((e.code, e.headers.get("Retry-After"),
                              body["reason"]))
        assert codes[0][0] == 200
        assert codes[1][0] == 429 and codes[1][2] == "RATE_LIMITED"
        assert int(codes[1][1]) >= 1
        with urllib.request.urlopen(addr + "/v1/agent/admission",
                                    timeout=30) as r:
            snap = json.loads(r.read())
        assert snap["admitted"] == 1 and snap["rejected"] == 1
        assert snap["queues"]["eval_pending_cap"] == 0
        assert snap["recent_rejections"][0]["client_id"] == "tenant-a"
    finally:
        agent.shutdown()


# -- overdrive-1k through the runner ------------------------------------------


@pytest.fixture(scope="module")
def overdrive_1k():
    return psc.run_scenario("overdrive-1k", seed=42, device="cpu")


def committed(name):
    with open(os.path.join(REPO, "nomad_tpu_torch", "simcluster",
                           "reference_digests.json")) as f:
        return json.load(f)["scenarios"][name]


def test_overdrive_1k_digest_equals_reference(overdrive_1k):
    ref = committed("overdrive-1k")
    assert overdrive_1k["events"]["digest"] == ref["digest"]
    assert overdrive_1k["events"]["by_type"] == ref["by_type"]
    assert overdrive_1k["events"]["truncated"] is False


def test_overdrive_1k_door_equals_reference(overdrive_1k):
    ref = committed("overdrive-1k")
    adm = overdrive_1k["admission"]
    assert adm["injector"] == ref["admission_injector"]
    assert adm["injector"] == {"offered": 48, "admitted": 12,
                               "rejected": {"RATE_LIMITED": 36}}
    assert adm["controller"]["admitted"] >= 12  # + the warmup job
    assert adm["controller"]["by_reason"] == {"RATE_LIMITED": 36}
    assert adm["caps_respected"] is True
    assert overdrive_1k["placements"]["placed"] == ref["placed"] == 12 * 20


def test_overdrive_1k_attribution_and_slo(overdrive_1k):
    att = overdrive_1k["latency_attribution"]
    assert att["submit_to_placed_ms"]["n"] == 12
    assert {r["objective"] for r in att["slo_check"]} == set(
        psc.slo.DEFAULT_OBJECTIVES)
    assert overdrive_1k["slo"]["resets"] == 1
    names = {o["name"] for o in overdrive_1k["slo"]["objectives"]}
    assert names == set(psc.slo.DEFAULT_OBJECTIVES)
    assert "not_ported" not in overdrive_1k
    for section in ("admission", "slo", "latency_attribution"):
        assert overdrive_1k[section] is not None, section
