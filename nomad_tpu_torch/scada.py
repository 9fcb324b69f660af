"""SCADA-analog uplink: expose the agent HTTP API over a dialed tunnel.

Port of nomad_tpu/scada.py. The frames, the handshake and the HMAC proof
are byte for byte nomad_tpu's, so a provider of either package serves a
broker of the other.

Reference: upstream command/agent/scada.go — the agent dials a
broker (Atlas/SCADA at HashiCorp), authenticates with an infrastructure
name + token, and registers an "http" capability; the broker then opens
yamux streams back through the dialed connection and each stream is served
as an inbound HTTP request (scada.go:26-60 provider config/capability,
:76-195 the listener shim feeding streams to the HTTP server).

The tpu-native analog keeps the capability but not the defunct SaaS
endpoint: the uplink only activates when an explicit ``atlas.endpoint`` is
configured (there is no hardcoded third-party default). Transport is the
framework's own framed-JSON mux (nomad_tpu_torch.rpc) in the reverse
direction — the provider dials out, then answers broker-originated
request frames:

    broker -> provider: {"seq": n, "method": "http",
                         "args": {"verb", "path", "body"}}
    provider -> broker: {"seq": n, "error": null,
                         "result": {"status", "headers", "body"}}

Each request is proxied to the agent's real HTTP listener, so the uplink
serves exactly the /v1 surface with identical envelopes and index headers
(the same property the reference gets by handing yamux streams to the
shared HTTP server). ``UplinkBroker`` is the in-process broker used by
tests and by anyone standing up their own dashboard tier.
"""

from __future__ import annotations

import hmac
import http.client
import json
import logging
import socket
import threading
from typing import Any, Dict, Optional

from nomad_tpu_torch import __version__
from nomad_tpu_torch.rpc import (
    SEND_TIMEOUT,
    _hard_close,
    _recv_frame,
    _send_frame,
    _set_send_timeout,
    _shut_down,
    serve_frames,
)
from nomad_tpu_torch.structs import MAX_QUERY_TIME, MAX_QUERY_TIME_PAD


def _auth_proof(token: str, nonce: str, infrastructure: str) -> str:
    """HMAC-SHA256 over the broker's fresh nonce + the infrastructure
    name, keyed by the shared token. Binding the infrastructure stops a
    proof observed for one infra being spliced onto a handshake for
    another; the fresh nonce stops replay outright."""
    import hashlib

    return hmac.new(
        token.encode(), f"{nonce}:{infrastructure}".encode(), hashlib.sha256
    ).hexdigest()


def _split_endpoint(endpoint: str) -> tuple:
    """host:port split tolerating bracketed IPv6 ([::1]:7545).
    Raises ValueError on portless, non-numeric-port, or bare-IPv6
    endpoints so misconfiguration fails fast at agent construction, not
    silently in the dial loop."""
    host, sep, port = endpoint.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"uplink endpoint {endpoint!r} must be host:port")
    if ":" in host and not (host.startswith("[") and host.endswith("]")):
        raise ValueError(
            f"IPv6 uplink endpoint {endpoint!r} must be bracketed: [host]:port"
        )
    return host.strip("[]"), int(port)


def _enable_keepalive(sock: socket.socket) -> None:
    """Kernel TCP keepalives: detect a silently-dead peer (NAT mapping
    expiry, power loss — no FIN ever arrives) within ~75s so the recv
    loop unblocks and the provider redials. The reference gets this from
    yamux keepalives (scada.go transport)."""
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, val in (("TCP_KEEPIDLE", 30), ("TCP_KEEPINTVL", 15),
                     ("TCP_KEEPCNT", 3)):
        if hasattr(socket, opt):
            sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)

# Reconnect backoff (scada.go DefaultBackoff posture: bounded retry).
BACKOFF_BASE = 0.25
BACKOFF_MAX = 15.0
HANDSHAKE_TIMEOUT = 10.0


def scada_unavailable_reason() -> str:
    return (
        "no uplink endpoint configured: the reference dials a hardcoded "
        "third-party SaaS (scada.hashicorp.com); nomad-tpu only uplinks to "
        "an explicit atlas.endpoint (see nomad_tpu_torch.scada.UplinkBroker)"
    )


class UplinkProvider:
    """Agent-side uplink (scada.go ProviderService/ProviderConfig analog).

    Dials ``endpoint``, handshakes with infrastructure/token, then serves
    broker-originated "http" frames by proxying them to the local agent
    HTTP listener. Redials with capped exponential backoff on any failure.
    """

    def __init__(self, endpoint: str, infrastructure: str, token: str,
                 http_addr: str, meta: Optional[Dict[str, str]] = None,
                 logger: Optional[logging.Logger] = None,
                 tls_context=None):
        self.endpoint = endpoint
        _split_endpoint(endpoint)  # fail fast on a malformed endpoint
        self.infrastructure = infrastructure
        self.token = token
        # Optional ssl.SSLContext for the dialed tunnel (the reference
        # SCADA client dialed its broker over TLS). Auth never depends on
        # it: the token itself stays off the wire either way (see
        # _session's challenge-response).
        self.tls_context = tls_context
        # http_addr is "host:port" of the agent's own HTTP listener.
        self.http_addr = http_addr
        self.meta = dict(meta or {})
        self.logger = logger or logging.getLogger("nomad_tpu_torch.scada")
        self._shutdown = threading.Event()
        self._sock_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="scada-uplink"
        )
        self.sessions = 0  # completed handshakes, for Stats()/tests

    def start(self) -> None:
        self._thread.start()

    def shutdown(self) -> None:
        self._shutdown.set()
        with self._sock_lock:
            sock = self._sock
            self._sock = None
        if sock is not None:
            _shut_down(sock)  # _session's finally closes it

    # -- dial loop -----------------------------------------------------------

    def _run(self) -> None:
        backoff = BACKOFF_BASE
        failures = 0
        while not self._shutdown.is_set():
            served = self.sessions
            try:
                self._session()
            except _AuthError as e:
                # Bad token/infrastructure: retrying fast is pointless.
                self.logger.warning("uplink: broker rejected handshake: %s", e)
                backoff = BACKOFF_MAX
            except Exception as e:
                failures += 1
                # Persistent dial failures surface at warning so an
                # unreachable endpoint is visible in normal logs.
                log = (self.logger.warning if failures % 8 == 0
                       else self.logger.debug)
                log("uplink: session failed (%d consecutive): %s",
                    failures, e)
            if self.sessions > served:
                failures = 0
                # A completed handshake resets backoff even though the
                # session ultimately ended in a disconnect exception.
                backoff = BACKOFF_BASE
            if self._shutdown.wait(backoff):
                return
            backoff = min(backoff * 2, BACKOFF_MAX)

    def _session(self) -> None:
        host, port = _split_endpoint(self.endpoint)
        sock = socket.create_connection((host, port), timeout=HANDSHAKE_TIMEOUT)
        if self.tls_context is not None:
            sock = self.tls_context.wrap_socket(
                sock, server_hostname=host.strip("[]")
            )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Kernel send timeout: a broker that stops reading must not wedge
        # handler threads in sendall under the write lock (same discipline
        # as rpc.py conns).
        _set_send_timeout(sock, SEND_TIMEOUT)
        _enable_keepalive(sock)
        with self._sock_lock:
            if self._shutdown.is_set():
                _hard_close(sock)
                return
            self._sock = sock
        try:
            # Challenge-response handshake: the shared token NEVER crosses
            # the wire (an on-path observer of a plaintext tunnel learns
            # nothing replayable — the proof binds a fresh broker nonce +
            # the infrastructure name).
            _send_frame(sock, {
                "seq": 0, "method": "handshake", "args": {
                    "service": "nomad-tpu",
                    "version": __version__,
                    "infrastructure": self.infrastructure,
                    "auth": "hmac-v1",
                    "capabilities": {"http": 1},
                    "meta": self.meta,
                },
            })
            resp = _recv_frame(sock)
            if resp.get("error"):
                raise _AuthError(resp["error"])
            nonce = str((resp.get("result") or {}).get("nonce", ""))
            if not nonce:
                raise _AuthError("broker sent no auth challenge")
            _send_frame(sock, {
                "seq": 1, "method": "auth", "args": {
                    "proof": _auth_proof(self.token, nonce,
                                         self.infrastructure),
                },
            })
            resp = _recv_frame(sock)
            if resp.get("error"):
                raise _AuthError(resp["error"])
            sock.settimeout(None)
            self.sessions += 1
            self.logger.info("uplink: connected to %s as %r",
                             self.endpoint, self.infrastructure)
            self._serve(sock)
        finally:
            with self._sock_lock:
                if self._sock is sock:
                    self._sock = None
            _hard_close(sock)

    def _serve(self, sock: socket.socket) -> None:
        """Answer broker request frames until the connection drops —
        the shared rpc.py serve loop (per-request threads, write lock,
        bounded in-flight)."""
        serve_frames(sock, self._dispatch, self._shutdown, self.logger,
                     thread_name="scada-stream")

    def _dispatch(self, req: Any) -> dict:
        if not isinstance(req, dict):
            return {"seq": None, "error": "malformed frame", "result": None}
        seq = req.get("seq")
        method = req.get("method", "")
        if method == "ping":
            return {"seq": seq, "error": None, "result": "pong"}
        if method != "http":
            return {"seq": seq, "error": f"unknown method {method!r}",
                    "result": None}
        args = req.get("args", {})
        try:
            return {"seq": seq, "error": None,
                    "result": self._proxy_http(args)}
        except Exception as e:
            return {"seq": seq, "error": f"{type(e).__name__}: {e}",
                    "result": None}

    def _proxy_http(self, args: dict) -> dict:
        """One tunneled HTTP exchange against the agent's own listener —
        the mux-frame analog of scada.go's listener shim handing a yamux
        stream to the shared HTTP server."""
        verb = args.get("verb", "GET").upper()
        path = args.get("path", "/")
        body = args.get("body")
        data = None
        headers = {}
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        # The local hop lives as long as the CALLER's budget (timeout_s,
        # sent by UplinkBroker.http) so an abandoned long-poll frees its
        # in-flight slot when the broker side gives up — capped just past
        # the server's MaxQueryTime clamp.
        raw = args.get("timeout_s")
        try:
            budget = 30.0 if raw is None else float(raw)
        except (TypeError, ValueError):
            budget = 30.0
        cap = MAX_QUERY_TIME + MAX_QUERY_TIME_PAD
        conn = http.client.HTTPConnection(
            self.http_addr, timeout=max(1.0, min(budget, cap))
        )
        try:
            conn.request(verb, path, body=data, headers=headers)
            resp = conn.getresponse()
            payload = resp.read().decode("utf-8", "replace")
            return {
                "status": resp.status,
                "headers": {k: v for k, v in resp.getheaders()
                            if k.lower().startswith("x-nomad-")
                            or k.lower() == "content-type"},
                "body": payload,
            }
        finally:
            conn.close()

    def stats(self) -> Dict[str, Any]:
        with self._sock_lock:
            connected = self._sock is not None
        return {"endpoint": self.endpoint, "connected": connected,
                "sessions": self.sessions}


class _AuthError(Exception):
    pass


class _BrokerSession:
    """Broker-side view of one connected provider."""

    def __init__(self, sock: socket.socket, handshake: dict):
        self.sock = sock
        self.handshake = handshake
        self.infrastructure = handshake.get("infrastructure", "")
        self.write_lock = threading.Lock()
        self.lock = threading.Lock()
        self.pending: Dict[int, "_SessWaiter"] = {}
        self.seq = 0
        self.dead = False


class _SessWaiter:
    __slots__ = ("event", "resp")

    def __init__(self):
        self.event = threading.Event()
        self.resp: Optional[dict] = None


class UplinkBroker:
    """In-process uplink broker: the dashboard-tier counterparty a
    deployment (or a test) runs to reach agents behind NAT. Accepts
    provider dials, validates the token, and exposes ``http()`` to issue
    requests through any connected session."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token: str = "", logger: Optional[logging.Logger] = None,
                 ssl_context=None):
        self.token = token
        self.logger = logger or logging.getLogger(
            "nomad_tpu_torch.scada.broker")
        self._ssl_context = ssl_context
        self._listener = socket.create_server((host, port))
        self.addr = "{}:{}".format(*self._listener.getsockname())
        self._shutdown = threading.Event()
        self._lock = threading.Lock()
        self._sessions: Dict[str, _BrokerSession] = {}
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"scada-broker-{self.addr}").start()

    def shutdown(self) -> None:
        self._shutdown.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for sess in sessions:
            _shut_down(sess.sock)  # each session's reader closes it

    def sessions(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v.handshake) for k, v in self._sessions.items()}

    def drop(self, infrastructure: str) -> None:
        """Sever a session (test hook for provider reconnect)."""
        with self._lock:
            sess = self._sessions.pop(infrastructure, None)
        if sess is not None:
            sess.dead = True
            _shut_down(sess.sock)

    # -- accept + demux ------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        accepted = False
        try:
            conn.settimeout(HANDSHAKE_TIMEOUT)
            if self._ssl_context is not None:
                conn = self._ssl_context.wrap_socket(conn, server_side=True)
            _set_send_timeout(conn, SEND_TIMEOUT)
            _enable_keepalive(conn)
            hello = _recv_frame(conn)
            if not isinstance(hello, dict) or not isinstance(
                hello.get("args", {}), dict
            ):
                return
            args = hello.get("args", {})
            if hello.get("method") != "handshake":
                _send_frame(conn, {"seq": hello.get("seq"),
                                   "error": "handshake required",
                                   "result": None})
                return
            # Challenge-response: a fresh nonce per session; the provider
            # proves token possession without ever sending it. Legacy
            # raw-token handshakes are refused — the secret must not be
            # coaxed onto the wire by a spoofed broker.
            if "token" in args:
                _send_frame(conn, {"seq": hello.get("seq"),
                                   "error": "raw-token handshake refused; "
                                            "use hmac-v1 challenge auth",
                                   "result": None})
                return
            import secrets

            nonce = secrets.token_hex(16)
            _send_frame(conn, {"seq": hello.get("seq"), "error": None,
                               "result": {"nonce": nonce}})
            auth = _recv_frame(conn)
            if not isinstance(auth, dict):
                auth = {}
            proof = str((auth.get("args") or {}).get("proof", ""))
            want = _auth_proof(self.token,
                               nonce, str(args.get("infrastructure", "")))
            if auth.get("method") != "auth" or not hmac.compare_digest(
                proof, want
            ):
                _send_frame(conn, {"seq": auth.get("seq"),
                                   "error": "invalid token",
                                   "result": None})
                return
            _send_frame(conn, {"seq": auth.get("seq"), "error": None,
                               "result": {"ok": True}})
            conn.settimeout(None)
            accepted = True
        except Exception:
            # Non-protocol bytes (a TLS probe, a port scan) raise RPCError
            # or worse — never let a daemon thread die with a traceback.
            # Logged at debug with the stack so an internal handshake bug
            # is still distinguishable from scanner noise.
            self.logger.debug("broker: handshake failed", exc_info=True)
            return
        finally:
            if not accepted:
                conn.close()
        # args can't carry the secret: raw-token hellos were refused above
        # and the hmac proof lived in the separate auth frame.
        sess = _BrokerSession(conn, args)
        with self._lock:
            old = self._sessions.pop(sess.infrastructure, None)
            self._sessions[sess.infrastructure] = sess
        if old is not None:
            _shut_down(old.sock)
        self.logger.info("broker: provider %r connected",
                         sess.infrastructure)
        try:
            while not self._shutdown.is_set():
                resp = _recv_frame(conn)
                with sess.lock:
                    waiter = sess.pending.pop(resp.get("seq"), None)
                if waiter is not None:
                    waiter.resp = resp
                    waiter.event.set()
        except Exception:
            # Includes RPCError from an oversized frame: the session is
            # torn down below and the provider redials.
            pass
        finally:
            sess.dead = True
            with sess.lock:
                pending = list(sess.pending.values())
                sess.pending.clear()
            for waiter in pending:
                waiter.event.set()
            with self._lock:
                if self._sessions.get(sess.infrastructure) is sess:
                    self._sessions.pop(sess.infrastructure, None)
            conn.close()

    # -- request API ---------------------------------------------------------

    def _request(self, infrastructure: str, method: str, args: dict,
                 timeout: float) -> Any:
        """Shared request lifecycle: find the session, register a waiter,
        send, wait. Raises KeyError if no session, RuntimeError on tunnel
        errors or a remote error frame."""
        with self._lock:
            sess = self._sessions.get(infrastructure)
        if sess is None or sess.dead:
            raise KeyError(f"no uplink session for {infrastructure!r}")
        with sess.lock:
            if sess.dead:
                # The reader's cleanup may already have drained pending;
                # registering after that would never be signaled.
                raise RuntimeError("uplink session died")
            sess.seq += 1
            seq = sess.seq
            waiter = _SessWaiter()
            sess.pending[seq] = waiter
        try:
            with sess.write_lock:
                _send_frame(sess.sock, {"seq": seq, "method": method,
                                        "args": args})
        except Exception as e:
            # Catches serialization TypeErrors too — the waiter must not
            # leak. A transport failure may have left a partial frame on
            # the wire, so the session is invalidated (ConnPool.call's
            # posture on the same path); the provider will redial.
            with sess.lock:
                sess.pending.pop(seq, None)
            if isinstance(e, OSError):
                sess.dead = True
                _shut_down(sess.sock)
            raise RuntimeError(f"uplink send failed: {e}") from e
        if not waiter.event.wait(timeout):
            with sess.lock:
                sess.pending.pop(seq, None)
            raise RuntimeError("uplink request timed out")
        resp = waiter.resp
        if resp is None:
            raise RuntimeError("uplink session died")
        if resp.get("error"):
            raise RuntimeError(resp["error"])
        return resp["result"]

    def http(self, infrastructure: str, verb: str, path: str,
             body: Any = None, timeout: float = 30.0) -> dict:
        """Issue an HTTP request through a connected provider; returns
        {"status", "headers", "body"}. ``timeout`` is also shipped to the
        provider so its local hop (and in-flight slot) never outlives the
        caller — pass a larger value for blocking queries (?index&wait)."""
        return self._request(
            infrastructure, "http",
            {"verb": verb, "path": path, "body": body,
             "timeout_s": timeout}, timeout,
        )

    def ping(self, infrastructure: str, timeout: float = 10.0) -> bool:
        try:
            return self._request(infrastructure, "ping", {}, timeout) == "pong"
        except (KeyError, RuntimeError):
            return False
