"""The port's SCADA-analog uplink (nomad_tpu_torch.scada) and its agent
wiring (``atlas`` and ``tls`` config blocks, the CLI banner) against
nomad_tpu's, on the CPU.

- Every case of ``tests/test_scada.py`` against the port's ``Agent``
  (dev mode, ``device="cpu"``): the handshake, HTTP and a blocking query
  through the tunnel, the provider's reconnect, a bad token, no endpoint.
- The uplink's TLS tunnel and HMAC cases of ``tests/test_tls.py``.
- ``_auth_proof`` and ``_split_endpoint`` give nomad_tpu's results on the
  same inputs; the port's provider is served by nomad_tpu's broker and
  nomad_tpu's provider by the port's (the frames are the same).
- The config surface: one agent config file with ``tls`` and ``atlas``
  blocks, HCL and JSON, parses in both packages to equal blocks, merges
  equally and raises equally on ``tls.uplink`` without ``tls.enabled``;
  the agent refuses a malformed endpoint at construction as nomad_tpu's
  does; the CLI prints nomad_tpu's Atlas banner lines.

Tolerance: exact."""

import dataclasses
import json
import socket
import struct
import threading
import time

import pytest
import torch

import chip_smoke as cs
from nomad_tpu import agent as jax_agent
from nomad_tpu import agent_config as jax_ac
from nomad_tpu import scada as jax_scada
from nomad_tpu_torch import agent_config as port_ac
from nomad_tpu_torch import scada as port_scada
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.scada import UplinkBroker, UplinkProvider

torch.set_num_threads(2)


def wait_for(fn, timeout=5.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture(autouse=True)
def no_metadata_network(monkeypatch):
    """The dev agent's client fingerprints the cloud metadata address:
    give it no network."""
    from nomad_tpu_torch.client import fingerprint

    monkeypatch.setattr(fingerprint._MetadataFingerprint, "_get",
                        lambda self, path: None)


@pytest.fixture()
def broker():
    b = UplinkBroker(token="sekrit")
    yield b
    b.shutdown()


def dev_config(tmp_path):
    config = AgentConfig.dev()
    config.data_dir = str(tmp_path)
    config.http_port = 0
    config.scheduler_backend = "host"
    config.device = "cpu"
    return config


@pytest.fixture()
def agent(tmp_path, broker):
    config = dev_config(tmp_path)
    config.atlas_infrastructure = "acme/prod"
    config.atlas_token = "sekrit"
    config.atlas_endpoint = broker.addr
    a = Agent(config)
    a.start()
    yield a
    a.shutdown()


# -- tests/test_scada.py, against the port's agent ----------------------------------


def test_handshake_registers_session(broker, agent):
    assert wait_for(lambda: "acme/prod" in broker.sessions())
    hs = broker.sessions()["acme/prod"]
    assert hs["service"] == "nomad-tpu"
    assert hs["capabilities"] == {"http": 1}
    assert hs["meta"]["datacenter"] == "dc1"
    assert broker.ping("acme/prod")


def test_http_through_tunnel(broker, agent):
    assert wait_for(lambda: "acme/prod" in broker.sessions())
    resp = broker.http("acme/prod", "GET", "/v1/agent/self")
    assert resp["status"] == 200
    info = json.loads(resp["body"])
    assert info["config"]["server_enabled"] is True
    resp = broker.http("acme/prod", "GET", "/v1/nodes")
    assert resp["status"] == 200
    assert "X-Nomad-Index" in resp["headers"]
    resp = broker.http("acme/prod", "GET", "/v1/job/nope")
    assert resp["status"] == 404


def test_blocking_query_through_tunnel(broker, agent):
    """A ?index&wait long-poll parks on the provider side and completes
    when the watch fires."""
    from nomad_tpu_torch import mock

    assert wait_for(lambda: "acme/prod" in broker.sessions())

    def nodes_index():
        r = broker.http("acme/prod", "GET", "/v1/nodes")
        return int(r["headers"]["X-Nomad-Index"])

    index = nodes_index()
    deadline = time.time() + 10
    while time.time() < deadline:
        time.sleep(0.6)
        nxt = nodes_index()
        if nxt == index:
            break
        index = nxt
    out = {}

    def poll():
        try:
            out["resp"] = broker.http(
                "acme/prod", "GET", f"/v1/nodes?index={index}&wait=50s",
                timeout=60)
        except BaseException as e:
            out["err"] = e

    t = threading.Thread(target=poll, daemon=True)
    t.start()
    time.sleep(0.3)
    assert "resp" not in out and "err" not in out  # parked on the watch
    agent.server.node_register(mock.node())
    t.join(timeout=15)
    assert "err" not in out, out.get("err")
    assert out["resp"]["status"] == 200
    assert int(out["resp"]["headers"]["X-Nomad-Index"]) > index


def test_provider_reconnects_after_drop(broker, agent):
    assert wait_for(lambda: "acme/prod" in broker.sessions())
    first_sessions = agent.uplink.sessions
    broker.drop("acme/prod")
    assert wait_for(lambda: agent.uplink.sessions > first_sessions,
                    timeout=10)
    assert wait_for(lambda: "acme/prod" in broker.sessions(), timeout=10)
    resp = broker.http("acme/prod", "GET", "/v1/status/leader")
    assert resp["status"] == 200


def test_bad_token_rejected():
    broker = UplinkBroker(token="right")
    provider = UplinkProvider(endpoint=broker.addr, infrastructure="x",
                              token="wrong", http_addr="127.0.0.1:1")
    provider.start()
    try:
        time.sleep(0.5)
        assert broker.sessions() == {}
        assert provider.sessions == 0
    finally:
        provider.shutdown()
        broker.shutdown()


def test_no_endpoint_means_no_uplink(tmp_path):
    config = dev_config(tmp_path)
    config.atlas_infrastructure = "acme/prod"  # but no endpoint
    a = Agent(config)
    a.start()
    try:
        assert a.uplink is None
    finally:
        a.shutdown()


# -- tests/test_tls.py's uplink cases ----------------------------------------------


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return cs.make_certs(str(tmp_path_factory.mktemp("scada-tls")))


def mini_http_server():
    """One-endpoint HTTP server standing in for the agent listener."""
    import http.server

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = b'{"ok": true}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.mark.parametrize("broker_mod, provider_mod", [
    (port_scada, port_scada), (jax_scada, port_scada),
    (port_scada, jax_scada)], ids=["port", "jax_broker", "jax_provider"])
def test_uplink_tls_tunnel_and_hmac_auth(certs, broker_mod, provider_mod):
    """The tunnel over TLS with the HMAC handshake, also with one side
    from nomad_tpu: the frames and the proof are the same."""
    cfg = cs.secure_tls(certs)
    httpd = mini_http_server()
    broker = broker_mod.UplinkBroker(token="sekrit",
                                     ssl_context=cfg.incoming_context())
    provider = provider_mod.UplinkProvider(
        endpoint=broker.addr, infrastructure="tls-infra", token="sekrit",
        http_addr="127.0.0.1:%d" % httpd.server_address[1],
        tls_context=cfg.outgoing_context())
    provider.start()
    try:
        assert wait_for(lambda: "tls-infra" in broker.sessions(), 15)
        resp = broker.http("tls-infra", "GET", "/anything")
        assert resp["status"] == 200 and "ok" in str(resp["body"])
        assert broker.ping("tls-infra")
        assert provider.stats()["connected"] is True
    finally:
        provider.shutdown()
        broker.shutdown()
        httpd.shutdown()


def test_uplink_refuses_raw_token_handshake():
    """Legacy raw-token hellos are refused: the shared secret never
    rides the wire."""
    broker = UplinkBroker(token="sekrit")
    try:
        host, port = broker.addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=5)
        payload = json.dumps({
            "seq": 0, "method": "handshake",
            "args": {"infrastructure": "x", "token": "sekrit"},
        }).encode()
        sock.sendall(struct.pack(">I", len(payload)) + payload)
        (length,) = struct.unpack(">I", sock.recv(4))
        resp = json.loads(sock.recv(length))
        assert "refused" in (resp.get("error") or "")
        sock.close()
    finally:
        broker.shutdown()


def test_uplink_wrong_token_fails_hmac():
    httpd = mini_http_server()
    broker = UplinkBroker(token="right")
    provider = UplinkProvider(
        endpoint=broker.addr, infrastructure="x", token="wrong",
        http_addr="127.0.0.1:%d" % httpd.server_address[1])
    provider.start()
    try:
        time.sleep(1.5)
        assert "x" not in broker.sessions()
        assert provider.sessions == 0
    finally:
        provider.shutdown()
        broker.shutdown()
        httpd.shutdown()


# -- the helpers, against nomad_tpu's -------------------------------------------------


@pytest.mark.parametrize("token, nonce, infra", [
    ("sekrit", "00ff" * 8, "acme/prod"), ("", "", ""),
    ("töken", "n", "infra:with:colons"), ("x" * 200, "abc", "y")])
def test_auth_proof_is_nomad_tpus(token, nonce, infra):
    assert (port_scada._auth_proof(token, nonce, infra)
            == jax_scada._auth_proof(token, nonce, infra))


@pytest.mark.parametrize("endpoint", [
    "127.0.0.1:7545", "[::1]:7545", "broker.example:80", "host:",
    ":80", "nohost", "::1:7545", "h:p0rt", "[::1]"])
def test_split_endpoint_is_nomad_tpus(endpoint):
    outs = []
    for mod in (jax_scada, port_scada):
        try:
            outs.append(("ok", mod._split_endpoint(endpoint)))
        except ValueError as e:
            outs.append(("error", str(e)))
    assert outs[1] == outs[0]


def test_agent_refuses_a_malformed_endpoint(tmp_path):
    config = dev_config(tmp_path)
    config.atlas_endpoint = "::1:7545"
    with pytest.raises(ValueError, match="bracketed"):
        Agent(config)


# -- the config surface ---------------------------------------------------------------


TLS_ATLAS_HCL = """
tls {
  enabled = true
  ca_file = "/etc/nomad/ca.pem"
  cert_file = "/etc/nomad/node.pem"
  key_file = "/etc/nomad/node.key"
  verify_incoming = false
  uplink = true
}
atlas {
  infrastructure = "acme/prod"
  token = "sekrit"
  endpoint = "[::1]:7545"
}
"""

OVERRIDE_HCL = """
tls {
  verify_hostname = true
  key_file = "/etc/nomad/other.key"
}
atlas {
  join = true
  endpoint = "10.0.0.1:7545"
}
"""


def load(mod, tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return mod.load_config_file(str(path))


def blocks(fc):
    return dataclasses.asdict(fc.tls), dataclasses.asdict(fc.atlas)


@pytest.mark.parametrize("fmt", ["hcl", "json"])
def test_tls_and_atlas_blocks_parse_and_merge_as_nomad_tpus(tmp_path, fmt):
    base, over = TLS_ATLAS_HCL, OVERRIDE_HCL
    if fmt == "json":
        base = json.dumps(jax_ac._body_to_mapping(
            jax_ac.parse_hcl(TLS_ATLAS_HCL)))
        over = json.dumps(jax_ac._body_to_mapping(
            jax_ac.parse_hcl(OVERRIDE_HCL)))
    got, want = [], []
    for mod, out in ((port_ac, got), (jax_ac, want)):
        fa = load(mod, tmp_path, f"{mod.__name__}-a.{fmt}", base)
        fb = load(mod, tmp_path, f"{mod.__name__}-b.{fmt}", over)
        merged = mod.default_config().merge(fa).merge(fb)
        out.extend([blocks(fa), blocks(merged)])
    assert got == want
    tls, atlas = got[1]
    assert tls["verify_incoming"] is False and tls["verify_hostname"] is True
    assert atlas["endpoint"] == "10.0.0.1:7545" and atlas["join"] is True


def test_agent_config_from_file_is_nomad_tpus(tmp_path):
    outs = []
    for mod, agent_mod in ((port_ac, None), (jax_ac, jax_agent)):
        fc = mod.default_config().merge(
            load(mod, tmp_path, f"{mod.__name__}.hcl", TLS_ATLAS_HCL))
        cls = AgentConfig if agent_mod is None else agent_mod.AgentConfig
        cfg = cls.from_file_config(fc)
        outs.append((cfg.atlas_infrastructure, cfg.atlas_token,
                     cfg.atlas_endpoint, cfg.tls_uplink,
                     dataclasses.asdict(cfg.tls)))
    assert outs[0] == outs[1]
    assert outs[0][3] is True and outs[0][4]["enabled"] is True


def test_uplink_without_tls_raises_as_nomad_tpu(tmp_path):
    text = 'tls {\n  uplink = true\n}\n'
    errors = []
    for mod, cls in ((port_ac, AgentConfig),
                     (jax_ac, jax_agent.AgentConfig)):
        fc = mod.default_config().merge(
            load(mod, tmp_path, f"{mod.__name__}.hcl", text))
        with pytest.raises(ValueError) as info:
            cls.from_file_config(fc)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "tls.uplink requires tls.enabled" in errors[0]


def test_unknown_tls_key_raises_as_nomad_tpu(tmp_path):
    errors = []
    for mod in (port_ac, jax_ac):
        with pytest.raises(ValueError) as info:
            load(mod, tmp_path, f"{mod.__name__}.hcl",
                 'tls {\n  bogus = 1\n}\n')
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("atlas", [
    'atlas {\n  endpoint = "127.0.0.1:7545"\n}\n',
    'atlas {\n  infrastructure = "acme/prod"\n}\n',
    'name = "n1"\natlas {\n  endpoint = "127.0.0.1:7545"\n}\n'])
def test_cli_prints_nomad_tpus_atlas_banner(tmp_path, capsys, atlas):
    from nomad_tpu import cli as jax_cli
    from nomad_tpu_torch import cli as port_cli

    path = tmp_path / "agent.hcl"
    path.write_text(atlas)
    outs = []
    for cli in (jax_cli, port_cli):
        args = cli.make_parser().parse_args(["agent", "-config", str(path)])
        cli._read_agent_config(args)
        outs.append(capsys.readouterr().out)
    # The disabled line names each package's own broker class.
    assert outs[1].replace("nomad_tpu_torch.", "nomad_tpu.") == outs[0]
    assert outs[0].startswith("==> Atlas/SCADA")
