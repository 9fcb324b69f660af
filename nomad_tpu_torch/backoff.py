"""Jittered exponential backoff: the retry schedule of the server loop's
worker (dequeue retries, ``_wait_for_index``).

Port of nomad_tpu/backoff.py's ``Backoff``: with d = min(cap,
base*2^n), the sleep is drawn U(d*(1-jitter), d] ("equal jitter" at the
default jitter=0.5; 1.0 gives full jitter), so workers retrying the same
broker decorrelate while every retry still waits a floor that backs off.
The RPC retry rule (``retry_undelivered``) comes with the RPC tier, and
the port has no circuit breaker: a device fault fails the eval.
"""

from __future__ import annotations

import random as _random
import threading
import time
from random import Random
from typing import Optional


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
