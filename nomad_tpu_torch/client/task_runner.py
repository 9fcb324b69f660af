"""TaskRunner: drives one task's lifecycle on the client.

Reference: upstream client/task_runner.go — create driver ->
Start/Open -> monitor exit -> restart policy loop -> persist handle state
keyed on the task (task_runner.go:73-128, 143-257).
"""

from __future__ import annotations

import hashlib
import logging
import threading
from typing import Callable, Dict, Optional

from nomad_tpu_torch.client.driver import ExecContext, new_driver
from nomad_tpu_torch.client.restarts import new_restart_tracker
from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_DEAD,
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_CLIENT_STATUS_RUNNING,
    RestartPolicy,
    Task,
)

WAIT_POLL = 0.1


class TaskRunner:
    def __init__(
        self,
        ctx: ExecContext,
        alloc_id: str,
        task: Task,
        job_type: str,
        restart_policy: Optional[RestartPolicy],
        status_cb: Callable[[str, str, str], None],
        logger: Optional[logging.Logger] = None,
    ):
        self.ctx = ctx
        self.alloc_id = alloc_id
        self.task = task
        self.job_type = job_type
        self.restart_policy = restart_policy or RestartPolicy()
        self.status_cb = status_cb  # (task_name, status, description)
        self.logger = logger or logging.getLogger("nomad_tpu_torch.task_runner")

        self.handle = None
        self.restart_tracker = new_restart_tracker(job_type, self.restart_policy)
        self._destroy = threading.Event()
        self._wait_done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.status = ALLOC_CLIENT_STATUS_PENDING

    # -- state persistence (task_runner.go:73-128) --------------------------

    def state_key(self) -> str:
        return hashlib.md5(self.task.name.encode()).hexdigest()

    def snapshot_state(self) -> Dict:
        return {
            "task_name": self.task.name,
            "handle_id": self.handle.id() if self.handle else None,
            "status": self.status,
        }

    def restore_state(self, state: Dict) -> None:
        """Re-open the driver handle after a client restart
        (task_runner.go:98-113)."""
        handle_id = state.get("handle_id")
        if handle_id:
            driver = new_driver(self.task.driver, self.ctx, self.logger)
            try:
                self.handle = driver.open(handle_id)
                self.status = state.get("status", ALLOC_CLIENT_STATUS_RUNNING)
            except Exception:
                self.logger.exception(
                    "failed to re-open handle %s for task %s",
                    handle_id, self.task.name,
                )

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, daemon=True,
            name=f"task-{self.alloc_id[:8]}-{self.task.name}",
        )
        self._thread.start()

    def run(self) -> None:
        """The run loop (task_runner.go:178-257)."""
        try:
            while not self._destroy.is_set():
                if self.handle is None:
                    try:
                        driver = new_driver(self.task.driver, self.ctx, self.logger)
                        self.handle = driver.start(self.task)
                    except Exception as e:
                        self.logger.error(
                            "failed to start task '%s': %s", self.task.name, e
                        )
                        self._set_status(
                            ALLOC_CLIENT_STATUS_FAILED, f"failed to start: {e}"
                        )
                        return
                self._set_status(ALLOC_CLIENT_STATUS_RUNNING, "task started")

                code = self._wait_for_exit()
                if self._destroy.is_set():
                    self._set_status(ALLOC_CLIENT_STATUS_DEAD, "task destroyed")
                    return

                if code == 0:
                    self._set_status(
                        ALLOC_CLIENT_STATUS_DEAD, "task completed"
                    )
                    return

                # Consult the restart policy (task_runner.go:198-228)
                should_restart, wait = self.restart_tracker.next_restart()
                if not should_restart:
                    self._set_status(
                        ALLOC_CLIENT_STATUS_FAILED,
                        f"task failed with exit code {code}, restarts exhausted",
                    )
                    return
                self.logger.info(
                    "task '%s' exited %s; restarting in %.1fs",
                    self.task.name, code, wait,
                )
                if self._destroy.wait(wait):
                    self._set_status(ALLOC_CLIENT_STATUS_DEAD, "task destroyed")
                    return
                self.handle = None
        finally:
            self._wait_done.set()

    def _wait_for_exit(self) -> Optional[int]:
        while not self._destroy.is_set():
            code = self.handle.wait(timeout=WAIT_POLL)
            if code is not None:
                return code
        return None

    def _set_status(self, status: str, desc: str) -> None:
        self.status = status
        self.status_cb(self.task.name, status, desc)

    def update(self, task: Task) -> None:
        self.task = task
        if self.handle is not None:
            self.handle.update(task)

    def destroy(self) -> None:
        """Kill the task (task_runner.go Destroy)."""
        self._destroy.set()
        if self.handle is not None:
            try:
                self.handle.kill()
            except Exception:
                self.logger.exception("failed to kill task %s", self.task.name)

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        return self._wait_done.wait(timeout)
