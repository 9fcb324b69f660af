"""The port's RPC tier (nomad_tpu_torch.rpc) against nomad_tpu's.

- The wire: a port ``ConnPool`` calls a nomad_tpu ``RPCServer`` and a
  nomad_tpu ``ConnPool`` calls a port ``RPCServer``; results, remote
  errors and out-of-order responses come back the same in both
  directions (the frame format is shared byte for byte).
- The port's copies of nomad_tpu's stream-multiplexing cases
  (tests/test_rpc_mux.py).
- ``retry_undelivered`` replays only provably undelivered calls.

Tolerance: exact (results are compared for equality).
"""

import threading
import time

import pytest

from nomad_tpu import rpc as jax_rpc
from nomad_tpu_torch import rpc as port_rpc
from nomad_tpu_torch.backoff import Backoff, retry_undelivered

PAIRS = {
    "port-client->jax-server": (port_rpc, jax_rpc),
    "jax-client->port-server": (jax_rpc, port_rpc),
    "port-client->port-server": (port_rpc, port_rpc),
}


def _server(mod):
    srv = mod.RPCServer()
    gate = threading.Event()

    def slow(args):
        gate.wait(args.get("wait", 5.0))
        return "slow-done"

    srv.register("Test.Slow", slow)
    srv.register("Test.Echo", lambda a: a.get("x"))
    srv.register("Test.Boom", lambda a: 1 / 0)
    srv.start()
    return srv, gate


def _wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_wire_is_shared(pair):
    """Results of every JSON shape, a remote error's text and class, an
    unknown method, and a later request answered first all read the same
    across the packages."""
    client_mod, server_mod = PAIRS[pair]
    srv, gate = _server(server_mod)
    pool = client_mod.ConnPool(timeout=10.0)
    try:
        for x in (1, "s", [1, 2, {"a": None}], {"k": [True, 2.5]}, None):
            assert pool.call(srv.addr, "Test.Echo", {"x": x}) == x
        with pytest.raises(client_mod.RemoteError,
                           match="ZeroDivisionError: division by zero"):
            pool.call(srv.addr, "Test.Boom", {})
        with pytest.raises(client_mod.RemoteError, match="unknown method"):
            pool.call(srv.addr, "No.Such", {})

        results = {}

        def call(name, method, args):
            results[name] = pool.call(srv.addr, method, args)

        t_slow = threading.Thread(
            target=call, args=("slow", "Test.Slow", {"wait": 6.0}),
            daemon=True)
        t_slow.start()
        time.sleep(0.1)
        call("fast", "Test.Echo", {"x": "hi"})
        assert results == {"fast": "hi"}
        gate.set()
        t_slow.join(5.0)
        assert results["slow"] == "slow-done"
        assert len(pool._conns) == 1
    finally:
        gate.set()
        pool.shutdown()
        srv.shutdown()


# -- the port's copies of nomad_tpu's multiplexing cases -------------------------


def test_longpoll_and_control_share_one_connection():
    srv, gate = _server(port_rpc)
    pool = port_rpc.ConnPool(timeout=10.0)
    try:
        out = {}

        def longpoll():
            out["slow"] = pool.call(srv.addr, "Test.Slow", {"wait": 6.0})

        t = threading.Thread(target=longpoll, daemon=True)
        t.start()
        time.sleep(0.2)
        assert t.is_alive()
        t0 = time.perf_counter()
        for i in range(20):
            assert pool.call(srv.addr, "Test.Echo", {"x": i}) == i
        assert time.perf_counter() - t0 < 2.0
        assert len(pool._conns) == 1
        assert t.is_alive()
        gate.set()
        t.join(5.0)
        assert out["slow"] == "slow-done"
    finally:
        pool.shutdown()
        srv.shutdown()


def test_out_of_order_responses_correlate_by_seq():
    srv, gate = _server(port_rpc)
    pool = port_rpc.ConnPool(timeout=10.0)
    try:
        results = {}

        def call(name, method, args):
            results[name] = pool.call(srv.addr, method, args)

        t_slow = threading.Thread(
            target=call, args=("slow", "Test.Slow", {"wait": 6.0}),
            daemon=True)
        t_slow.start()
        time.sleep(0.1)
        t_fast = threading.Thread(
            target=call, args=("fast", "Test.Echo", {"x": "hi"}),
            daemon=True)
        t_fast.start()
        t_fast.join(3.0)
        assert results == {"fast": "hi"}
        gate.set()
        t_slow.join(5.0)
        assert results["slow"] == "slow-done"
    finally:
        pool.shutdown()
        srv.shutdown()


def test_per_call_timeout_keeps_connection_alive():
    srv, gate = _server(port_rpc)
    pool = port_rpc.ConnPool(timeout=10.0)
    try:
        with pytest.raises(port_rpc.RPCTimeoutError, match="timed out"):
            pool.call(srv.addr, "Test.Slow", {"wait": 30.0}, timeout=0.3)
        mux = pool._conns[srv.addr]
        assert pool.call(srv.addr, "Test.Echo", {"x": 1}) == 1
        assert pool._conns[srv.addr] is mux
    finally:
        gate.set()
        pool.shutdown()
        srv.shutdown()


def test_remote_error_propagates():
    srv, gate = _server(port_rpc)
    pool = port_rpc.ConnPool(timeout=5.0)
    try:
        with pytest.raises(port_rpc.RemoteError, match="ZeroDivisionError"):
            pool.call(srv.addr, "Test.Boom", {})
    finally:
        pool.shutdown()
        srv.shutdown()


def test_transport_failure_fails_all_parked_streams():
    srv, gate = _server(port_rpc)
    pool = port_rpc.ConnPool(timeout=10.0)
    try:
        errors = []

        def parked():
            try:
                pool.call(srv.addr, "Test.Slow", {"wait": 30.0})
            except port_rpc.RPCError as e:
                errors.append(e)

        threads = [threading.Thread(target=parked, daemon=True)
                   for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        srv.shutdown()
        for t in threads:
            t.join(5.0)
        assert len(errors) == 3
    finally:
        gate.set()
        pool.shutdown()


# -- retry policy and TLS arm ------------------------------------------------------


def test_connect_failure_is_undelivered_and_retried():
    """A refused connect never dispatched anything: retry_undelivered
    replays it ``retries`` times and then raises it; a remote error is
    never replayed."""
    pool = port_rpc.ConnPool(timeout=0.5)
    calls = []

    def refused():
        calls.append(1)
        return pool.call("127.0.0.1:1", "X.Y", {})

    with pytest.raises(port_rpc.RPCUndeliveredError):
        retry_undelivered(refused, retries=2,
                          backoff=Backoff(base=0.001, max_delay=0.002))
    assert len(calls) == 3

    srv, gate = _server(port_rpc)
    try:
        calls.clear()

        def boom():
            calls.append(1)
            return pool.call(srv.addr, "Test.Boom", {})

        with pytest.raises(port_rpc.RemoteError):
            retry_undelivered(boom, retries=2)
        assert len(calls) == 1
        assert pool.call_retry(srv.addr, "Test.Echo", {"x": 5}) == 5
    finally:
        pool.shutdown()
        srv.shutdown()


def test_tls_is_refused_until_ported():
    with pytest.raises(ValueError, match="tlsutil"):
        port_rpc.ConnPool(ssl_context=object())
    with pytest.raises(ValueError, match="tlsutil"):
        port_rpc.RPCServer(ssl_context=object())


@pytest.mark.parametrize("mode", ["drop", "partition", "error"])
def test_rpc_send_fault_modes(mode):
    """rpc.send on the client: drop and partition never send the frame
    (undelivered, retried), error raises a plain RPCError."""
    from nomad_tpu_torch import faults

    srv, gate = _server(port_rpc)
    pool = port_rpc.ConnPool(timeout=2.0)
    reg = faults.get_registry()
    try:
        rule = reg.configure("rpc.send", mode=mode, count=1)
        if mode == "error":
            with pytest.raises(port_rpc.RPCError) as info:
                pool.call(srv.addr, "Test.Echo", {"x": 1})
            assert not isinstance(info.value, port_rpc.RPCUndeliveredError)
        else:
            assert pool.call_retry(
                srv.addr, "Test.Echo", {"x": 7},
                backoff=Backoff(base=0.001, max_delay=0.002)) == 7
        assert rule.fired == 1
    finally:
        reg.clear()
        pool.shutdown()
        srv.shutdown()


def test_rpc_recv_drop_executes_but_loses_the_response():
    from nomad_tpu_torch import faults

    srv = port_rpc.RPCServer()
    ran = []
    srv.register("Test.Mark", lambda a: ran.append(1) or "ok")
    srv.start()
    pool = port_rpc.ConnPool(timeout=2.0)
    reg = faults.get_registry()
    try:
        reg.configure("rpc.recv", mode="drop", count=1)
        with pytest.raises(port_rpc.RPCTimeoutError):
            pool.call(srv.addr, "Test.Mark", {}, timeout=0.3)
        assert _wait_until(lambda: ran == [1])
        assert pool.call(srv.addr, "Test.Mark", {}) == "ok"
    finally:
        reg.clear()
        pool.shutdown()
        srv.shutdown()
