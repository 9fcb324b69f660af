"""Agent log plumbing: level filtering, circular buffering, syslog.

Reference: upstream command/agent/log_writer.go (circular buffer with
register/deregister handlers for live streaming), gated-writer (buffer all
output until the agent finishes booting, then flush), log_levels.go (the
``[LEVEL]`` prefix filter), and syslog.go (optional syslog sink).

Implemented as ``logging`` handlers so the rest of the codebase keeps using
stdlib loggers; the HTTP agent endpoint streams from :class:`LogWriter` and
the CLI renders it.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

LOG_LEVELS = ("TRACE", "DEBUG", "INFO", "WARN", "ERR")

_PY_LEVEL = {
    "TRACE": 5,
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARN": logging.WARNING,
    "ERR": logging.ERROR,
}


def validate_level(level: str) -> bool:
    """log_levels.go ValidateLevelFilter."""
    return level.upper() in LOG_LEVELS


def level_to_py(level: str) -> int:
    return _PY_LEVEL.get(level.upper(), logging.INFO)


class LogWriter(logging.Handler):
    """Circular buffer of the last ``buf_size`` formatted log lines with
    live-stream registration (log_writer.go:10-83).

    A registered sink first receives the retained backlog in order, then
    every new line as it is emitted. Deregister to stop.
    """

    def __init__(self, buf_size: int = 512, level: int = logging.NOTSET):
        super().__init__(level)
        self.buf_size = buf_size
        self._buf: List[str] = []
        self._next = 0  # insertion index once the ring is full
        self._sinks: List[Callable[[str], None]] = []
        self._reg_lock = threading.Lock()
        self.setFormatter(
            logging.Formatter(
                "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
            )
        )

    def register_sink(self, sink: Callable[[str], None]) -> None:
        with self._reg_lock:
            for line in self.tail():
                sink(line)
            self._sinks.append(sink)

    def deregister_sink(self, sink: Callable[[str], None]) -> None:
        with self._reg_lock:
            try:
                self._sinks.remove(sink)
            except ValueError:
                pass

    def tail(self) -> List[str]:
        """Retained lines, oldest first."""
        if len(self._buf) < self.buf_size:
            return list(self._buf)
        return self._buf[self._next:] + self._buf[: self._next]

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:  # pragma: no cover - formatter errors
            return
        with self._reg_lock:
            if len(self._buf) < self.buf_size:
                self._buf.append(line)
            else:
                self._buf[self._next] = line
                self._next = (self._next + 1) % self.buf_size
            for sink in self._sinks:
                try:
                    sink(line)
                except Exception:
                    pass


class GatedHandler(logging.Handler):
    """Buffer records until flushed, then pass through (gated-writer).

    The agent gates startup output so config errors print cleanly before the
    full log pipeline is live; ``flush_through`` drains the buffer into the
    real handler and flips to passthrough.
    """

    def __init__(self, target: logging.Handler):
        super().__init__()
        self.target = target
        self._gated = True
        self._buf: List[logging.LogRecord] = []
        self._lock2 = threading.Lock()

    def flush_through(self) -> None:
        with self._lock2:
            self._gated = False
            for record in self._buf:
                self.target.handle(record)
            self._buf = []

    def emit(self, record: logging.LogRecord) -> None:
        with self._lock2:
            if self._gated:
                self._buf.append(record)
            else:
                self.target.handle(record)


def make_syslog_handler(facility: str = "LOCAL0") -> Optional[logging.Handler]:
    """Syslog sink (syslog.go); returns None when no syslog socket exists."""
    import logging.handlers
    import os

    address = "/dev/log" if os.path.exists("/dev/log") else ("localhost", 514)
    try:
        fac = getattr(
            logging.handlers.SysLogHandler,
            f"LOG_{facility.upper()}",
            logging.handlers.SysLogHandler.LOG_LOCAL0,
        )
        return logging.handlers.SysLogHandler(address=address, facility=fac)
    except OSError:
        return None


def setup_agent_logging(
    log_level: str = "INFO",
    enable_syslog: bool = False,
    buf_size: int = 512,
    root: Optional[logging.Logger] = None,
) -> LogWriter:
    """Wire the agent logger tree: level gate + circular stream buffer
    (+ syslog when asked). Returns the LogWriter for HTTP/CLI streaming."""
    logger = root or logging.getLogger("nomad_tpu_torch")
    logger.setLevel(level_to_py(log_level))
    # Idempotent across agent restarts in one process (tests, dev reloads).
    for handler in [h for h in logger.handlers if isinstance(h, LogWriter)]:
        logger.removeHandler(handler)
    writer = LogWriter(buf_size=buf_size)
    logger.addHandler(writer)
    if enable_syslog:
        handler = make_syslog_handler()
        if handler is not None:
            logger.addHandler(handler)
    return writer
