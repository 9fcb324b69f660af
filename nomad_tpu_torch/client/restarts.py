"""Task restart trackers.

Reference: upstream client/restarts.go — a windowed tracker for
long-lived (service/system) tasks and a bounded-attempts tracker for batch.
"""

from __future__ import annotations

import time
from typing import Tuple

from nomad_tpu_torch.structs import (
    JOB_TYPE_BATCH,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSTEM,
    RestartPolicy,
)


class ServiceRestartTracker:
    """Windowed restarts: up to ``attempts`` restarts per ``interval``;
    exceeding the window waits out the remainder (restarts.go:28-57)."""

    def __init__(self, policy: RestartPolicy):
        self.policy = policy
        self.start_time = time.monotonic()
        self.count = 0

    def next_restart(self) -> Tuple[bool, float]:
        """Returns (should_restart, wait_seconds). Service tasks always
        restart; the wait throttles crash loops."""
        now = time.monotonic()
        window_end = self.start_time + self.policy.interval
        if now > window_end:
            self.count = 0
            self.start_time = now
        if self.count < self.policy.attempts:
            self.count += 1
            return True, self.policy.delay
        return True, max(window_end - now, 0.0) + self.policy.delay


class BatchRestartTracker:
    """Bounded attempts: restart at most ``attempts`` times
    (restarts.go:59-83)."""

    def __init__(self, policy: RestartPolicy):
        self.policy = policy
        self.count = 0

    def next_restart(self) -> Tuple[bool, float]:
        if self.count < self.policy.attempts:
            self.count += 1
            return True, self.policy.delay
        return False, 0.0


def new_restart_tracker(job_type: str, policy: RestartPolicy):
    """restarts.go:16-26"""
    if job_type in (JOB_TYPE_SERVICE, JOB_TYPE_SYSTEM):
        return ServiceRestartTracker(policy)
    if job_type == JOB_TYPE_BATCH:
        return BatchRestartTracker(policy)
    return BatchRestartTracker(policy)
