"""TLS on the port's RPC tier (nomad_tpu_torch.tlsutil, rpc.py's TLS arms,
the cluster server's listener and pools, the client's endpoint, the
agent's config-file ``tls`` block) against nomad_tpu's, on the CPU.

- Every case of ``tests/test_tls.py`` on the RPC tier, the cluster and
  the network client, against the port (its uplink cases are in
  ``test_torch_scada.py``).
- The contexts the port's ``TLSConfig`` makes carry the same options as
  nomad_tpu's for the same config: TLS 1.2 pinned at both ends,
  renegotiation off, the verify mode and the hostname check.
- The wire is nomad_tpu's byte for byte: the port's pool over TLS calls
  nomad_tpu's TLS listener, and nomad_tpu's pool the port's.
- The three cases of ``tests/test_blackbox_tls.py`` against the port's
  CLI agent forked with a ``tls`` block (``device = "cpu"``), in a
  process that cannot import ``jax`` or ``nomad_tpu``.

Certificates (a CA, a loopback-SAN server pair, a client pair, and a
pair signed by an untrusted CA) come from ``chip_smoke.make_certs``, the
openssl CLI, once per module. Tolerance: exact (options, results)."""

import json
import os
import socket
import ssl
import subprocess
import sys
import threading
import time

import pytest
import torch

import chip_smoke as cs
from nomad_tpu import rpc as jax_rpc
from nomad_tpu.tlsutil import TLSConfig as JaxTLS
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.rpc import (
    ConnPool,
    RPCError,
    RPCServer,
    RPCUndeliveredError,
    _hard_close,
    _set_send_timeout,
)
from nomad_tpu_torch.tlsutil import TLSConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return cs.make_certs(str(tmp_path_factory.mktemp("tls")))


def tls_cfg(certs, verify_incoming=True, cls=TLSConfig, pair="server"):
    """One region-shared keypair on both ends: mutual TLS, the reference's
    VerifyIncoming deployment shape."""
    crt, key = certs[pair]
    return cls(enabled=True, ca_file=certs["ca"], cert_file=crt,
               key_file=key, verify_incoming=verify_incoming,
               verify_hostname=False)


def wait_until(pred, timeout=WAIT_S, every=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return False


# -- tests/test_tls.py's RPC-tier cases, against the port -------------------------


def test_rpc_roundtrip_and_mux_over_tls(certs):
    cfg = tls_cfg(certs)
    srv = RPCServer(ssl_context=cfg.incoming_context())
    gate = threading.Event()
    srv.register("Echo.Hello", lambda args: {"hi": args["name"]})
    srv.register("Slow.Wait", lambda args: gate.wait(10) and {"done": True})
    srv.start()
    try:
        pool = ConnPool(ssl_context=cfg.outgoing_context())
        # A parked long-poll must not head-of-line block control traffic
        # on the shared TLS connection.
        results = {}
        t = threading.Thread(target=lambda: results.update(
            slow=pool.call(srv.addr, "Slow.Wait", {}, timeout=10)))
        t.start()
        for i in range(20):
            assert pool.call(srv.addr, "Echo.Hello",
                             {"name": str(i)})["hi"] == str(i)
        gate.set()
        t.join(timeout=10)
        assert results.get("slow") == {"done": True}
        pool.shutdown()
    finally:
        srv.shutdown()


def test_plaintext_client_rejected_by_tls_server(certs):
    srv = RPCServer(ssl_context=tls_cfg(certs).incoming_context())
    srv.register("Echo.Hello", lambda args: args)
    srv.start()
    try:
        pool = ConnPool(timeout=3.0)
        with pytest.raises(RPCError):
            pool.call(srv.addr, "Echo.Hello", {"name": "x"})
    finally:
        srv.shutdown()


def test_certless_client_rejected_when_verify_incoming(certs):
    srv = RPCServer(ssl_context=tls_cfg(certs).incoming_context())
    srv.register("Echo.Hello", lambda args: args)
    srv.start()
    try:
        anon = TLSConfig(enabled=True, ca_file=certs["ca"])
        pool = ConnPool(timeout=3.0, ssl_context=anon.outgoing_context())
        with pytest.raises((RPCError, RPCUndeliveredError)):
            pool.call(srv.addr, "Echo.Hello", {"name": "x"})
    finally:
        srv.shutdown()


def test_untrusted_server_rejected_by_client(certs):
    srv = RPCServer(ssl_context=tls_cfg(
        certs, verify_incoming=False).incoming_context())
    srv.register("Echo.Hello", lambda args: args)
    srv.start()
    try:
        # The client trusts only the rogue CA, which signed nothing the
        # server presents.
        rogue_ca = os.path.join(os.path.dirname(certs["ca"]), "rogue-ca.crt")
        client = TLSConfig(enabled=True, ca_file=rogue_ca)
        pool = ConnPool(timeout=3.0, ssl_context=client.outgoing_context())
        with pytest.raises(RPCUndeliveredError):
            pool.call(srv.addr, "Echo.Hello", {"name": "x"})
    finally:
        srv.shutdown()


def test_untrusted_client_certificate_rejected(certs):
    """A client presenting a pair the server's CA did not sign."""
    srv = RPCServer(ssl_context=tls_cfg(certs).incoming_context())
    srv.register("Echo.Hello", lambda args: args)
    srv.start()
    try:
        pool = ConnPool(timeout=3.0, ssl_context=tls_cfg(
            certs, pair="rogue").outgoing_context())
        with pytest.raises(RPCError):
            pool.call(srv.addr, "Echo.Hello", {"name": "x"})
        good = ConnPool(timeout=3.0, ssl_context=tls_cfg(
            certs, pair="client").outgoing_context())
        assert good.call(srv.addr, "Echo.Hello", {"name": "y"}) == {
            "name": "y"}
        good.shutdown()
    finally:
        srv.shutdown()


def test_three_server_cluster_over_tls(certs):
    """Raft RPCs, leader forwarding and the eval pipeline over mutual
    TLS: register through a follower, the eval completes cluster-wide."""
    from nomad_tpu_torch.server.cluster import form_cluster, wait_for_leader
    from nomad_tpu_torch.server.server import ServerConfig
    from test_torch_cluster import relaxed_cluster, retry_write

    servers = form_cluster(3, ServerConfig(
        device="cpu", scheduler_backend="host", num_schedulers=1,
        min_heartbeat_ttl=300.0, tls=tls_cfg(certs),
    ), base_cluster=relaxed_cluster())
    try:
        leader = wait_for_leader(servers, timeout=20.0)
        follower = next(s for s in servers if s is not leader)
        assert isinstance(follower.pool._ssl_context, ssl.SSLContext)
        assert isinstance(leader.raft.pool._ssl_context, ssl.SSLContext)
        retry_write(lambda: follower.node_register(port_mock.node()))
        job = port_mock.job()
        job.task_groups[0].count = 2
        ev_id, _ = retry_write(lambda: follower.job_register(job))
        ev = leader.wait_for_eval(ev_id, timeout=30.0)
        assert ev.status == pst.EVAL_STATUS_COMPLETE
        assert len(leader.state_store.allocs_by_job(job.id)) == 2
    finally:
        for s in servers:
            s.shutdown(drain_timeout=5.0)


def test_network_client_over_tls(certs, tmp_path, monkeypatch):
    """A network client registers, runs a task and syncs its status back
    with the whole client->server RPC path in mutual TLS."""
    from nomad_tpu_torch.client import Client, ClientConfig, fingerprint
    from nomad_tpu_torch.server.cluster import form_cluster, wait_for_leader
    from nomad_tpu_torch.server.server import ServerConfig

    monkeypatch.setattr(fingerprint._MetadataFingerprint, "_get",
                        lambda self, path: None)
    cfg = tls_cfg(certs)
    (srv,) = form_cluster(1, ServerConfig(
        device="cpu", scheduler_backend="host", num_schedulers=1,
        min_heartbeat_ttl=300.0, tls=cfg,
    ))
    try:
        wait_for_leader([srv])
        client = Client(ClientConfig(
            state_dir=str(tmp_path / "state"),
            alloc_dir=str(tmp_path / "allocs"), node_name="tls-client",
            servers=[srv.rpc_addr],
            options={"driver.mock_driver.enable": "1"}, tls=cfg))
        client.start()
        try:
            assert wait_until(lambda: (
                (n := srv.state_store.node_by_id(client.node.id)) is not None
                and n.status == pst.NODE_STATUS_READY)), \
                "client never registered over TLS"
            job = cs.mock_job("tls-job", 1)
            ev_id, _ = srv.job_register(job)
            ev = srv.wait_for_eval(ev_id, timeout=15.0)
            assert ev.status == pst.EVAL_STATUS_COMPLETE
            assert wait_until(lambda: [
                a.client_status for a in srv.state_store.allocs_by_job(
                    job.id)] == [pst.ALLOC_CLIENT_STATUS_DEAD])
        finally:
            client.shutdown(destroy_allocs=True)
    finally:
        srv.shutdown(drain_timeout=5.0)


def test_tls_socket_keeps_send_timeout_and_hard_close(certs):
    """Under an SSLSocket, _set_send_timeout sets the raw socket's
    SO_SNDTIMEO and _hard_close wakes a reader blocked in recv."""
    import struct

    srv_ctx = tls_cfg(certs).incoming_context()
    listener = socket.create_server(("127.0.0.1", 0))
    accepted = {}

    def accept():
        conn, _ = listener.accept()
        accepted["sock"] = srv_ctx.wrap_socket(conn, server_side=True)
    t = threading.Thread(target=accept)
    t.start()
    raw = socket.create_connection(listener.getsockname())
    sock = tls_cfg(certs).outgoing_context().wrap_socket(
        raw, server_hostname="127.0.0.1")
    t.join(10)
    try:
        _set_send_timeout(sock, 2.5)
        sec, usec = struct.unpack("ll", sock.getsockopt(
            socket.SOL_SOCKET, socket.SO_SNDTIMEO, 16))
        assert (sec, usec) == (2, 500_000)
        woke = threading.Event()

        def read():
            try:
                accepted["sock"].recv(1)
            except OSError:
                pass
            woke.set()
        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        time.sleep(0.2)
        assert not woke.is_set()
        _hard_close(accepted["sock"])
        assert woke.wait(5.0)
    finally:
        _hard_close(sock)
        listener.close()


def test_shut_down_tls_sockets_leave_the_next_connection_alone(certs):
    """Pools and servers torn down from other threads than their TLS
    sockets' readers (rejected, served and shut down in turn), then a
    plaintext call on a fresh server, 25 times: each call gets its pong.
    Closing a TLS socket under its reader let the reader's next read land
    on the next socket given the same descriptor number."""
    for _ in range(25):
        tls = RPCServer(ssl_context=tls_cfg(certs).incoming_context())
        plain = RPCServer()
        for srv in (tls, plain):
            srv.register("Status.Ping", lambda args: "pong")
            srv.start()
        try:
            for pair in ("rogue", "client"):
                pool = ConnPool(timeout=5.0, ssl_context=tls_cfg(
                    certs, pair=pair).outgoing_context())
                try:
                    pool.call(tls.addr, "Status.Ping", {})
                except RPCError:
                    assert pair == "rogue"
                pool.shutdown()
            pool = ConnPool(timeout=5.0)
            assert pool.call(plain.addr, "Status.Ping", {}) == "pong"
            pool.shutdown()
        finally:
            tls.shutdown()
            plain.shutdown()


# -- the contexts, against nomad_tpu's ---------------------------------------------


def context_options(ctx):
    return (ctx.minimum_version, ctx.maximum_version, ctx.verify_mode,
            ctx.check_hostname, ctx.options,
            bool(ctx.options & ssl.OP_NO_RENEGOTIATION))


@pytest.mark.parametrize("verify_incoming, verify_hostname, pair", [
    (True, False, "server"), (False, False, "server"),
    (True, True, "server"), (True, False, "client"), (True, False, None),
])
def test_contexts_carry_nomad_tpus_options(certs, verify_incoming,
                                           verify_hostname, pair):
    def cfg(cls):
        crt, key = certs[pair] if pair else ("", "")
        return cls(enabled=True, ca_file=certs["ca"], cert_file=crt,
                   key_file=key, verify_incoming=verify_incoming,
                   verify_hostname=verify_hostname)

    port, ref = cfg(TLSConfig), cfg(JaxTLS)
    out = context_options(port.outgoing_context())
    assert out == context_options(ref.outgoing_context())
    assert out[:2] == (ssl.TLSVersion.TLSv1_2, ssl.TLSVersion.TLSv1_2)
    assert out[5]
    if pair:
        inc = context_options(port.incoming_context())
        assert inc == context_options(ref.incoming_context())
        assert inc[2] == (ssl.CERT_REQUIRED if verify_incoming
                          else ssl.CERT_NONE)


def test_disabled_config_makes_no_context():
    for cls in (TLSConfig, JaxTLS):
        assert cls().incoming_context() is None
        assert cls().outgoing_context() is None


def test_verify_incoming_without_a_ca_raises_as_nomad_tpu(certs):
    crt, key = certs["server"]
    errors = []
    for cls in (TLSConfig, JaxTLS):
        with pytest.raises(ValueError) as info:
            cls(enabled=True, cert_file=crt, key_file=key).incoming_context()
        errors.append(str(info.value))
    assert errors[0] == errors[1] == "tls.verify_incoming requires tls.ca_file"


# -- the wire, across the two packages -------------------------------------------


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_tls_wire_is_nomad_tpus(certs, direction):
    """One package's pool over TLS against the other's TLS listener: the
    same frames, a long-poll and control traffic on one connection."""
    server_mod, client_mod = ((jax_rpc, sys.modules["nomad_tpu_torch.rpc"])
                              if direction == "port_to_jax"
                              else (sys.modules["nomad_tpu_torch.rpc"],
                                    jax_rpc))
    srv_cls = JaxTLS if server_mod is jax_rpc else TLSConfig
    cli_cls = JaxTLS if client_mod is jax_rpc else TLSConfig
    srv = server_mod.RPCServer(ssl_context=tls_cfg(
        certs, cls=srv_cls).incoming_context())
    gate = threading.Event()
    srv.register("Echo.Hello", lambda args: {"hi": args["name"],
                                             "n": [1, 2.5, None]})
    srv.register("Slow.Wait", lambda args: gate.wait(10) and {"done": True})
    srv.register("Boom.Now", lambda args: 1 / 0)
    srv.start()
    pool = client_mod.ConnPool(ssl_context=tls_cfg(
        certs, cls=cli_cls, pair="client").outgoing_context())
    try:
        slow = {}
        t = threading.Thread(target=lambda: slow.update(
            out=pool.call(srv.addr, "Slow.Wait", {}, timeout=10)))
        t.start()
        for i in range(5):
            assert pool.call(srv.addr, "Echo.Hello", {"name": f"n{i}"}) == {
                "hi": f"n{i}", "n": [1, 2.5, None]}
        with pytest.raises(client_mod.RemoteError, match="division"):
            pool.call(srv.addr, "Boom.Now", {})
        gate.set()
        t.join(10)
        assert slow["out"] == {"done": True}
    finally:
        pool.shutdown()
        srv.shutdown()


# -- tests/test_blackbox_tls.py, against the port's CLI agent ----------------------


BLOCK = "import sys\n" + "".join(
    f"sys.modules[{m!r}] = None\n" for m in ("jax", "nomad_tpu"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def tls_agent(certs, tmp_path_factory):
    """A non-dev single-server port agent from a JSON config file with
    TLS on its RPC tier, forked with jax and nomad_tpu blocked."""
    d = tmp_path_factory.mktemp("bb-tls-agent")
    rpc_port = free_port()
    crt, key = certs["server"]
    cfg = {
        "data_dir": str(d / "data"), "name": "bb-tls-server",
        "ports": {"http": 0, "rpc": rpc_port},
        "server": {"enabled": True, "bootstrap_expect": 1},
        "scheduler_backend": "host", "device": "cpu", "log_level": "WARN",
        "tls": {"enabled": True, "ca_file": certs["ca"], "cert_file": crt,
                "key_file": key, "verify_incoming": True},
    }
    path = d / "agent.json"
    path.write_text(json.dumps(cfg))
    code = BLOCK + ("from nomad_tpu_torch.cli import main\n"
                    "sys.exit(main(sys.argv[1:]))\n")
    env = dict(os.environ, PYTHONPATH=REPO, http_proxy="http://127.0.0.1:1",
               no_proxy="127.0.0.1,localhost")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "agent", "-config", str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=env)
    addr = None
    for line in proc.stdout:
        if "HTTP at " in line:
            addr = line.split("HTTP at ")[1].strip()
            break
    assert addr, proc.stderr.read()[-3000:]
    proc.http_addr = addr
    proc.rpc_addr = f"127.0.0.1:{rpc_port}"
    yield proc
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def test_tls_rpc_roundtrip_against_forked_agent(certs, tls_agent):
    pool = ConnPool(ssl_context=tls_cfg(
        certs, pair="client").outgoing_context())
    try:
        assert pool.call(tls_agent.rpc_addr, "Status.Ping", {}) == "pong"
        leader = ""
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and not leader:
            leader = pool.call(tls_agent.rpc_addr, "Status.Leader", {})
            if not leader:
                time.sleep(0.2)
        assert leader == tls_agent.rpc_addr
    finally:
        pool.shutdown()


def test_plaintext_rejected_by_forked_tls_agent(tls_agent):
    pool = ConnPool(timeout=3.0)
    try:
        with pytest.raises(RPCError):
            pool.call(tls_agent.rpc_addr, "Status.Ping", {})
    finally:
        pool.shutdown()


def test_http_api_alive_alongside_tls_rpc(tls_agent):
    from nomad_tpu_torch.api import ApiClient

    info = ApiClient(address=tls_agent.http_addr).agent().self_info()
    assert info.get("stats", {}).get("server")
