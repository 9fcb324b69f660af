"""Jittered exponential backoff: the retry schedule of the server loop's
worker (dequeue retries, ``_wait_for_index``).

Port of nomad_tpu/backoff.py's ``Backoff``: with d = min(cap,
base*2^n), the sleep is drawn U(d*(1-jitter), d] ("equal jitter" at the
default jitter=0.5; 1.0 gives full jitter), so workers retrying the same
broker decorrelate while every retry still waits a floor that backs off.
``retry_undelivered`` is the RPC tier's one safe auto-retry. The port has
no circuit breaker: a device fault fails the eval.
"""

from __future__ import annotations

import random as _random
import threading
import time
from random import Random
from typing import Callable, Optional

from nomad_tpu_torch import telemetry


class Backoff:
    """Jittered exponential backoff with an optional deadline.

    next_delay() grows base * factor^n capped at max_delay, jittered by
    drawing uniformly from [delay*(1-jitter), delay] ("equal jitter" at
    the default jitter=0.5; jitter=1.0 is full jitter, 0 disables);
    sleep() applies it and returns False once the deadline has expired
    (callers use that as their give-up signal). reset() re-arms after a
    success. A seeded ``rng`` makes the schedule deterministic for tests.
    """

    __slots__ = ("base", "max_delay", "factor", "jitter", "deadline",
                 "attempts", "_rng")

    def __init__(self, base: float = 0.05, max_delay: float = 2.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 deadline: Optional[float] = None,
                 rng: Optional[Random] = None):
        self.base = base
        self.max_delay = max_delay
        self.factor = factor
        self.jitter = jitter
        # Absolute time.monotonic() stamp, or None for no deadline.
        self.deadline = (
            time.monotonic() + deadline if deadline is not None else None
        )
        self.attempts = 0
        # None = the module's shared PRNG: Backoff objects are built on
        # hot paths (one per wait_for_index call), and instantiating a
        # fresh os.urandom-seeded Random there is a syscall + MT init
        # that jitter=0 users never even draw from.
        self._rng = rng

    def reset(self) -> None:
        self.attempts = 0

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline

    def next_delay(self) -> float:
        # Exponent capped: a worker soaking a no-leader period for hours
        # keeps counting attempts, and float 2.0**1024 raises
        # OverflowError — the cap saturates the growth far past any real
        # max_delay without ever overflowing.
        exp = min(self.attempts, 64)
        delay = min(self.max_delay, self.base * (self.factor ** exp))
        self.attempts += 1
        if self.jitter > 0:
            draw = (self._rng or _random).random()
            delay *= 1.0 - self.jitter * draw
        return delay

    def sleep(self, stop: Optional[threading.Event] = None) -> bool:
        """Sleep the next delay (clamped to the deadline). Returns True to
        keep retrying, False when the deadline expired or ``stop`` was set
        mid-sleep."""
        if self.expired:
            return False
        delay = self.next_delay()
        if self.deadline is not None:
            delay = min(delay, max(self.deadline - time.monotonic(), 0.0))
        if stop is not None:
            if stop.wait(delay):
                return False
        else:
            time.sleep(delay)
        return not self.expired


# Ceiling on honoring a server's retry-after hint in one sleep: a hint of
# minutes is the server's honest schedule, but a synchronous caller
# blocked that long has usually out-lived its own deadline — surface the
# typed rejection instead and let the caller decide.
MAX_RETRY_AFTER_SLEEP = 30.0


def retry_undelivered(fn: Callable, retries: int = 2,
                      backoff: Optional[Backoff] = None,
                      rate_limit_retries: int = 2):
    """Run ``fn`` retrying only failures that are PROVABLY side-effect
    free to replay.

    Two such classes exist (rpc.py's RPCUndeliveredError and
    structs.RejectError):

    - RPCUndeliveredError: the frame never reached the peer — the handler
      never ran, so even non-idempotent RPCs replay safely.
    - A typed ``RATE_LIMITED`` rejection (nomad_tpu's admission front
      door; the port has none yet, but a port client talking to a
      nomad_tpu server may meet one): raised BEFORE any raft apply, so
      nothing executed; the retry sleeps max(the server's retry-after
      hint, the jittered backoff), bounded by ``rate_limit_retries``.

    Every other rejection reason surfaces immediately as a typed
    RejectError. Anything else (RemoteError, RPCTimeoutError, plain
    RPCError) may have executed remotely and surfaces unchanged.
    """
    from nomad_tpu_torch.rpc import RemoteError, RPCUndeliveredError
    from nomad_tpu_torch.structs import REJECT_RATE_LIMITED, parse_reject

    bo = backoff or Backoff(base=0.05, max_delay=0.5)
    attempt = 0
    rl_attempt = 0
    while True:
        try:
            return fn()
        except RPCUndeliveredError:
            attempt += 1
            if attempt > retries:
                raise
            telemetry.incr_counter(("rpc", "client", "retry_undelivered"))
            if not bo.sleep():
                raise
        except RemoteError as e:
            rejection = parse_reject(str(e))
            if rejection is None:
                raise
            if (rejection.reason != REJECT_RATE_LIMITED
                    or rl_attempt >= rate_limit_retries
                    or rejection.retry_after > MAX_RETRY_AFTER_SLEEP
                    or bo.expired):
                raise rejection from e
            delay = max(rejection.retry_after, bo.next_delay())
            if bo.deadline is not None:
                remaining = bo.deadline - time.monotonic()
                if delay > remaining:
                    raise rejection from e
            rl_attempt += 1
            telemetry.incr_counter(("rpc", "client", "retry_rate_limited"))
            time.sleep(delay)
