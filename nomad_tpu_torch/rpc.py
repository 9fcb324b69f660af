"""Network RPC: framed JSON over TCP with stream-multiplexed pooling.

Port of nomad_tpu/rpc.py (upstream msgpack-RPC over yamux with a pooled
client, nomad/rpc.go:21-137 and nomad/pool.go). Capabilities carried
over: a single listener serving concurrent requests, client-side
connection reuse, request/response correlation, and clean propagation of
remote errors. Framing is length-prefixed JSON (pickle is avoided — peers
are semi-trusted), byte for byte the same as nomad_tpu's, so a client of
either package talks to a server of the other.

Multiplexing (yamux-lite): the seq field IS the stream id. One pooled
connection per address carries any number of in-flight requests — the
server dispatches each request on its own thread and writes responses
out of order under a per-connection write lock; the client parks each
caller on its seq and a per-connection reader demuxes responses. A
blocking long-poll (Eval.Dequeue, blocking queries) therefore shares the
connection with control traffic instead of requiring a second pool.

TLS: an optional ``ssl_context`` (``tlsutil.TLSConfig``'s incoming or
outgoing context) wraps each accepted or dialed TCP socket; the framing
above it is unchanged, so a TLS peer of either package talks to the other.

Wire format: 4-byte big-endian length + JSON object.
Request:  {"seq": n, "method": "Service.Method", "args": {...}}
Response: {"seq": n, "error": null | str, "result": ...}
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional

from nomad_tpu_torch import faults, telemetry

_LEN = struct.Struct(">I")

# Sentinel a dispatcher returns to swallow the response frame entirely —
# the injected-fault path for "request executed, response lost" (the
# caller then times out with RPCTimeoutError: possibly-executed, NOT
# auto-retried). Organic code never returns it.
SWALLOW_RESPONSE = object()
MAX_FRAME = 64 << 20
# Kernel-level send timeout (SO_SNDTIMEO): bounds sendall on a peer that
# stopped reading WITHOUT touching recv (the demux reader blocks forever by
# design). A send that trips this invalidates the connection.
SEND_TIMEOUT = 30.0
# Per-connection cap on in-flight server-side requests: reads from a
# flooding peer pause (TCP backpressure) instead of spawning unbounded
# threads.
MAX_INFLIGHT_PER_CONN = 64


def _set_send_timeout(sock: socket.socket, seconds: float) -> None:
    sec = int(seconds)
    usec = int((seconds - sec) * 1_000_000)
    sock.setsockopt(
        socket.SOL_SOCKET, socket.SO_SNDTIMEO, struct.pack("ll", sec, usec)
    )


def _shut_down(sock: socket.socket) -> None:
    """shutdown(SHUT_RDWR) from another thread than the socket's reader: a
    recv blocked on it returns, the peer sees FIN, and the reader closes
    the socket as it returns. Not closed here: OpenSSL keeps the
    descriptor's number, so a TLS socket closed under its reader lets the
    reader's next read land on whichever socket reuses that number (a
    fresh connection of the same process then loses bytes or is reset)."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


def _hard_close(sock: socket.socket) -> None:
    """shutdown(SHUT_RDWR) then close, by the thread that reads ``sock``
    (or where none does): plain close() does not interrupt a recv blocked
    in another thread, and the peer would never see FIN."""
    _shut_down(sock)
    try:
        sock.close()
    except OSError:
        pass


class RPCError(Exception):
    pass


class RemoteError(RPCError):
    """An error raised by the remote handler."""


class RPCUndeliveredError(RPCError):
    """Transport failed BEFORE the request reached the peer (connect
    failure, or sendall raised so the length-prefixed frame is incomplete
    and the peer's codec drops the connection without dispatching). Safe
    to retry even for non-idempotent RPCs — the handler never ran."""


class RPCTimeoutError(RPCError):
    """The per-call deadline expired with the request possibly executed
    remotely (response lost or late). NOT safe to blindly retry
    non-idempotent RPCs."""


def _send_frame(sock: socket.socket, obj: Any) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    # Into one preallocated buffer: appending chunk by chunk copies the
    # frame once a chunk, and a TLS socket hands out 16 KiB records, so a
    # 40 MB frame (100,000 alloc stubs through the uplink) took seconds.
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("connection closed")
        got += k
    return buf


def _recv_frame(sock: socket.socket) -> Any:
    (length,) = _LEN.unpack(_recv_exact(sock, 4))
    if length > MAX_FRAME:
        raise RPCError(f"frame too large: {length}")
    return json.loads(_recv_exact(sock, length))


def serve_frames(
    conn: socket.socket,
    dispatch: Callable[[Any], dict],
    shutdown: threading.Event,
    logger: logging.Logger,
    write_lock: Optional[threading.Lock] = None,
    thread_name: str = "rpc-stream",
) -> None:
    """Per-connection serve loop of RPCServer (nomad_tpu shares it with
    its SCADA-analog uplink): each inbound frame runs on its own thread; responses
    interleave on the shared connection under a write lock, correlated by
    seq — so a parked long-poll never head-of-line blocks control traffic.
    In-flight requests per connection are capped: acquiring the semaphore
    before reading the next frame applies TCP backpressure to a flooding
    peer instead of spawning unbounded threads.

    Runs until the connection drops or ``shutdown`` is set; transport
    errors propagate to the caller (which owns socket cleanup). A handler
    result that fails to serialize is answered with an error frame so the
    peer fails fast instead of timing out."""
    if write_lock is None:
        write_lock = threading.Lock()
    inflight = threading.Semaphore(MAX_INFLIGHT_PER_CONN)

    def handle(req: Any) -> None:
        try:
            resp = dispatch(req)
            if resp is SWALLOW_RESPONSE:
                return
            try:
                with write_lock:
                    _send_frame(conn, resp)
            except (ConnectionError, OSError):
                pass
            except Exception as e:
                logger.warning(
                    "rpc: response for %s not serializable: %s",
                    req.get("method") if isinstance(req, dict) else req, e,
                )
                err = {"seq": req.get("seq") if isinstance(req, dict) else None,
                       "error": f"response serialization failed: {e}",
                       "result": None}
                try:
                    with write_lock:
                        _send_frame(conn, err)
                except Exception:
                    _shut_down(conn)
        finally:
            inflight.release()

    while not shutdown.is_set():
        inflight.acquire()
        try:
            req = _recv_frame(conn)
        except BaseException:
            inflight.release()
            raise
        threading.Thread(
            target=handle, args=(req,), daemon=True, name=thread_name,
        ).start()


class RPCServer:
    """Serves registered handlers on a TCP listener (rpc.go:21-72 listen/
    handleConn, minus the protocol-byte demux — raft runs on its own RPC
    methods instead of a separate stream)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 logger: Optional[logging.Logger] = None,
                 ssl_context=None):
        self.logger = logger or logging.getLogger("nomad_tpu_torch.rpc")
        self._handlers: Dict[str, Callable[[dict], Any]] = {}
        # Optional TLS arm (reference nomad/rpc.go:104-110 rpcTLS): the
        # context wraps each accepted conn; the mux above is unchanged.
        self._ssl_context = ssl_context
        self._listener = socket.create_server((host, port))
        self.addr = "{}:{}".format(*self._listener.getsockname())
        self._shutdown = threading.Event()
        self._conns_lock = threading.Lock()
        self._conns: set = set()
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"rpc-{self.addr}"
        )

    def register(self, method: str, handler: Callable[[dict], Any]) -> None:
        self._handlers[method] = handler

    def start(self) -> None:
        self._thread.start()

    def shutdown(self) -> None:
        self._shutdown.set()
        # shutdown(SHUT_RDWR) BEFORE close: a bare close() does not wake
        # the thread blocked in accept() — the open file description
        # (and with it the LISTEN port binding) survives until that
        # syscall returns, so a server restarting on the SAME port gets
        # EADDRINUSE from its own ghost (the restart-under-load
        # scenario's kill/rebind found this).
        _hard_close(self._listener)
        # Close accepted connections too: parked long-poll streams on
        # peers must fail fast, not sleep out their timeouts.
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            _shut_down(conn)  # each conn's serve thread closes it
        # The accept thread must actually exit before the caller may
        # rebind the port.
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _set_send_timeout(conn, SEND_TIMEOUT)
            if self._ssl_context is not None:
                # Bound the handshake: a half-open probe must not pin
                # this thread forever.
                conn.settimeout(SEND_TIMEOUT)
                conn = self._ssl_context.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
        except (ConnectionError, OSError, ValueError) as e:
            self.logger.debug("rpc: connection setup failed: %s", e)
            _hard_close(conn)
            return
        with self._conns_lock:
            self._conns.add(conn)
        try:
            serve_frames(conn, self._dispatch, self._shutdown, self.logger)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def _dispatch(self, req: dict) -> dict:
        # Request counters/timers (reference: nomad/rpc.go:68 rpc.request
        # + per-method MeasureSince at the endpoint handlers).
        seq = req.get("seq")
        method = req.get("method", "")
        fault = faults.fire("rpc.recv", target=method)
        if fault is not None:
            if fault.mode == "drop":
                # Execute, then lose the response: the caller's deadline
                # expires with the request POSSIBLY EXECUTED — the
                # RPCTimeoutError half of the retry-safety distinction.
                handler = self._handlers.get(method)
                if handler is not None:
                    try:
                        handler(req.get("args", {}))
                    except Exception:
                        pass
                return SWALLOW_RESPONSE
            if fault.mode == "partition":
                # The request silently never arrives (handler NOT run):
                # like every other site's partition, loss — never a fast
                # explicit error. The caller still times out, and from
                # its side that is indistinguishable from a lost
                # response, exactly as with a real partition.
                return SWALLOW_RESPONSE
            if fault.mode == "error":
                return {"seq": seq, "error": "injected fault: rpc.recv",
                        "result": None}
        handler = self._handlers.get(method)
        telemetry.incr_counter(("rpc", "request"))
        if handler is None:
            telemetry.incr_counter(("rpc", "unknown_method"))
            return {"seq": seq, "error": f"unknown method {method!r}",
                    "result": None}
        start = time.perf_counter()
        try:
            out = {"seq": seq, "error": None,
                   "result": handler(req.get("args", {}))}
        except Exception as e:
            self.logger.debug("rpc: handler %s failed: %s", method, e)
            telemetry.incr_counter(("rpc", "request_error"))
            out = {"seq": seq, "error": f"{type(e).__name__}: {e}",
                   "result": None}
        telemetry.measure_since(("rpc", method), start)
        return out


class _Waiter:
    __slots__ = ("event", "resp")

    def __init__(self):
        self.event = threading.Event()
        self.resp: Optional[dict] = None


class _MuxConn:
    """One multiplexed client connection: a reader thread demuxes
    responses to parked callers by seq (the yamux-stream analog)."""

    def __init__(self, sock: socket.socket, addr: str):
        self.sock = sock
        self.addr = addr
        self.write_lock = threading.Lock()
        self.lock = threading.Lock()
        self.pending: Dict[int, _Waiter] = {}
        self.dead: Optional[Exception] = None
        threading.Thread(
            target=self._read_loop, daemon=True, name=f"rpc-mux-{addr}"
        ).start()

    def register(self, seq: int) -> _Waiter:
        waiter = _Waiter()
        with self.lock:
            if self.dead is not None:
                # Nothing was sent yet: undelivered, retryable.
                raise RPCUndeliveredError(
                    f"connection to {self.addr} is down: {self.dead}"
                )
            self.pending[seq] = waiter
        return waiter

    def forget(self, seq: int) -> None:
        with self.lock:
            self.pending.pop(seq, None)

    def _read_loop(self) -> None:
        try:
            while True:
                resp = _recv_frame(self.sock)
                with self.lock:
                    waiter = self.pending.pop(resp.get("seq"), None)
                if waiter is not None:
                    waiter.resp = resp
                    waiter.event.set()
                # Unknown seq: a response arriving after its caller timed
                # out — dropped; the stream stays healthy.
        except Exception as e:
            with self.lock:
                self.dead = e
                pending = list(self.pending.values())
                self.pending.clear()
            for waiter in pending:
                waiter.event.set()  # resp stays None -> transport error
            try:
                self.sock.close()
            except OSError:
                pass


class ConnPool:
    """Pooled, stream-multiplexed RPC client connections (reference:
    nomad/pool.go:138-371 + yamux). One connection per address carries all
    concurrent requests — long-polls and control traffic interleave."""

    def __init__(self, timeout: float = 10.0, ssl_context=None):
        self.timeout = timeout
        # Optional TLS: wraps each pooled conn at dial; with
        # check_hostname the context verifies the host part of the addr.
        self._ssl_context = ssl_context
        self._lock = threading.Lock()
        self._conns: Dict[str, _MuxConn] = {}
        self._seq = 0

    def call(self, addr: str, method: str, args: dict,
             timeout: Optional[float] = None) -> Any:
        """RPC to addr; raises RemoteError for handler errors, RPCError for
        transport failures (after invalidating the pooled conn). A per-call
        timeout does NOT kill the shared connection — the late response is
        simply dropped by the demuxer."""
        fault = faults.fire("rpc.send", target=f"{addr} {method}")
        if fault is not None:
            if fault.mode in ("drop", "partition"):
                # The frame never goes out: provably undelivered, so the
                # injected failure is retry-safe exactly like a connect
                # failure (the distinction callers' retry policies key on).
                raise RPCUndeliveredError(
                    f"injected fault: rpc.send to {addr} dropped"
                )
            if fault.mode == "error":
                raise RPCError(f"injected fault: rpc.send to {addr}")
        mux = self._acquire(addr)
        with self._lock:
            self._seq += 1
            seq = self._seq
        waiter = mux.register(seq)
        try:
            with mux.write_lock:
                _send_frame(mux.sock, {"seq": seq, "method": method,
                                       "args": args})
        except (ConnectionError, OSError, ValueError) as e:
            mux.forget(seq)
            self._invalidate(addr, mux)
            # sendall raised -> the frame is incomplete -> the peer never
            # dispatched it: undelivered, retryable.
            raise RPCUndeliveredError(f"rpc to {addr} failed: {e}") from e
        if not waiter.event.wait(timeout or self.timeout):
            mux.forget(seq)
            raise RPCTimeoutError(f"rpc to {addr} timed out: {method}")
        resp = waiter.resp
        if resp is None:  # reader died: transport failure
            self._invalidate(addr, mux)
            raise RPCError(f"rpc to {addr} failed: {mux.dead}")
        if resp.get("error"):
            raise RemoteError(resp["error"])
        return resp.get("result")

    def call_retry(self, addr: str, method: str, args: dict,
                   timeout: Optional[float] = None, retries: int = 2,
                   backoff=None):
        """``call`` with the transport tier's one safe auto-retry: only
        RPCUndeliveredError (the handler provably never ran)
        is replayed, under jittered backoff (or a caller-supplied
        ``backoff`` — a severed-conn single replay wants no sleep at all).
        RPCTimeoutError and lost responses surface immediately — the
        request may have executed, and redelivery belongs to the caller's
        idempotency machinery (broker nacks, raft-upsert semantics)."""
        from nomad_tpu_torch.backoff import retry_undelivered

        return retry_undelivered(
            lambda: self.call(addr, method, args, timeout=timeout),
            retries=retries, backoff=backoff,
        )

    def _acquire(self, addr: str) -> _MuxConn:
        with self._lock:
            mux = self._conns.get(addr)
            if mux is not None and mux.dead is None:
                return mux
        host, port = addr.rsplit(":", 1)
        try:
            sock = socket.create_connection((host, int(port)), timeout=self.timeout)
            if self._ssl_context is not None:
                sock = self._ssl_context.wrap_socket(
                    sock, server_hostname=host
                )
        except (OSError, ValueError) as e:
            # A failed TLS handshake never dispatched anything either.
            raise RPCUndeliveredError(
                f"failed to connect to {addr}: {e}"
            ) from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Kernel send timeout bounds sendall on a peer that stopped
        # reading (the write_lock holder must never block forever);
        # per-call deadlines are enforced by the waiter, and the demux
        # reader blocks on recv by design.
        sock.settimeout(None)
        _set_send_timeout(sock, SEND_TIMEOUT)
        mux = _MuxConn(sock, addr)
        with self._lock:
            existing = self._conns.get(addr)
            if existing is not None and existing.dead is None:
                # Lost the connect race: shut down so the loser's already-
                # running reader thread unblocks, closes it and exits.
                _shut_down(sock)
                return existing
            self._conns[addr] = mux
        return mux

    def _invalidate(self, addr: str, mux: Optional[_MuxConn] = None) -> None:
        with self._lock:
            current = self._conns.get(addr)
            if mux is None or current is mux:
                self._conns.pop(addr, None)
                mux = current
        if mux is not None:
            _shut_down(mux.sock)  # its reader closes it

    def shutdown(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for mux in conns:
            _shut_down(mux.sock)
