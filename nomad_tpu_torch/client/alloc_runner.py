"""AllocRunner: per-allocation execution state machine.

Reference: upstream client/alloc_runner.go — build the AllocDir,
spin a TaskRunner per task, aggregate task statuses into the alloc's client
status, and sync status changes to the server via the updater callback
(client.go:614-626 -> Node.UpdateAlloc).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Dict, Optional

from nomad_tpu_torch.client.allocdir import AllocDir
from nomad_tpu_torch.client.driver import ExecContext
from nomad_tpu_torch.client.task_runner import TaskRunner
from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_DEAD,
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_CLIENT_STATUS_RUNNING,
    Allocation,
)


class AllocRunner:
    def __init__(
        self,
        alloc: Allocation,
        alloc_dir_root: str,
        updater: Callable[[Allocation], None],
        logger: Optional[logging.Logger] = None,
        options=None,
    ):
        # Own copy: the in-process store hands out shared objects; client
        # status must flow through the replicated log, never in-place.
        self.alloc = alloc.copy()
        self.updater = updater
        self.logger = logger or logging.getLogger("nomad_tpu_torch.alloc_runner")
        self.alloc_dir = AllocDir(os.path.join(alloc_dir_root, alloc.id))
        self.ctx = ExecContext(self.alloc_dir, alloc.id, options=options)
        self.task_runners: Dict[str, TaskRunner] = {}
        self.task_status: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._destroyed = False

    def _task_group(self):
        if self.alloc.job is None:
            return None
        return self.alloc.job.lookup_task_group(self.alloc.task_group)

    def _merged_task(self, task):
        """The runnable task: the job's spec with resources replaced by the
        allocation's offered TaskResources (assigned IPs/ports) — reference
        alloc_runner.go merges alloc.TaskResources into the task before
        handing it to the TaskRunner."""
        offered = self.alloc.task_resources.get(task.name)
        if offered is None:
            return task
        import copy as _copy

        merged = _copy.copy(task)
        merged.resources = offered
        return merged

    # -- lifecycle (alloc_runner.go Run) ------------------------------------

    def run(self) -> None:
        tg = self._task_group()
        if tg is None:
            self.logger.error(
                "alloc %s references unknown task group %s",
                self.alloc.id, self.alloc.task_group,
            )
            self._sync_status(ALLOC_CLIENT_STATUS_FAILED, "unknown task group")
            return

        self.alloc_dir.build([t.name for t in tg.tasks])

        for task in tg.tasks:
            runner = TaskRunner(
                self.ctx,
                self.alloc.id,
                self._merged_task(task),
                self.alloc.job.type,
                tg.restart_policy,
                self._on_task_status,
                self.logger,
            )
            self.task_runners[task.name] = runner
            self.task_status[task.name] = ALLOC_CLIENT_STATUS_PENDING
            runner.start()

    def restore(self, state: Dict) -> None:
        """Recreate task runners from persisted state and re-open driver
        handles (alloc_runner.go:60-147, client restart path)."""
        tg = self._task_group()
        if tg is None:
            return
        self.alloc_dir.build([t.name for t in tg.tasks])
        for task in tg.tasks:
            runner = TaskRunner(
                self.ctx, self.alloc.id, self._merged_task(task),
                self.alloc.job.type,
                tg.restart_policy, self._on_task_status, self.logger,
            )
            task_state = state.get("tasks", {}).get(task.name)
            if task_state:
                runner.restore_state(task_state)
            self.task_runners[task.name] = runner
            self.task_status[task.name] = (
                task_state.get("status", ALLOC_CLIENT_STATUS_PENDING)
                if task_state else ALLOC_CLIENT_STATUS_PENDING
            )
            if runner.handle is not None:
                runner.start()

    def snapshot_state(self) -> Dict:
        with self._lock:
            return {
                "alloc_id": self.alloc.id,
                "tasks": {
                    name: tr.snapshot_state()
                    for name, tr in self.task_runners.items()
                },
            }

    # -- status aggregation (alloc_runner.go syncStatus) ---------------------

    def _on_task_status(self, task_name: str, status: str, desc: str) -> None:
        with self._lock:
            self.task_status[task_name] = status
            client_status, client_desc = self._aggregate(desc)
        self._sync_status(client_status, client_desc)

    def _aggregate(self, last_desc: str):
        statuses = set(self.task_status.values())
        if ALLOC_CLIENT_STATUS_FAILED in statuses:
            return ALLOC_CLIENT_STATUS_FAILED, last_desc
        if ALLOC_CLIENT_STATUS_RUNNING in statuses:
            return ALLOC_CLIENT_STATUS_RUNNING, ""
        if statuses == {ALLOC_CLIENT_STATUS_DEAD}:
            return ALLOC_CLIENT_STATUS_DEAD, "all tasks complete"
        return ALLOC_CLIENT_STATUS_PENDING, ""

    def _sync_status(self, status: str, desc: str) -> None:
        update = self.alloc.copy()
        update.client_status = status
        update.client_description = desc
        self.alloc.client_status = status
        self.alloc.client_description = desc
        try:
            self.updater(update)
        except Exception:
            self.logger.exception(
                "failed to sync status for alloc %s", self.alloc.id
            )

    # -- updates / teardown --------------------------------------------------

    def update(self, alloc: Allocation) -> None:
        """Server pushed a new version of the alloc (alloc_runner.go Update).
        A terminal desired status tears the tasks down, once: the stop
        report bumps the alloc's modify index, so the watch hands the
        stopped alloc back, and reporting it again would loop through raft
        for as long as the client runs (nomad_tpu does; upstream's Run
        loop ends at the first terminal update)."""
        stopped = self.alloc.terminal_status()
        self.alloc = alloc.copy()
        if alloc.terminal_status():
            if stopped:
                return
            self.destroy_tasks()
            self._sync_status(ALLOC_CLIENT_STATUS_DEAD, "alloc stopped")
        else:
            tg = self._task_group()
            if tg is None:
                return
            for task in tg.tasks:
                runner = self.task_runners.get(task.name)
                if runner is not None:
                    runner.update(self._merged_task(task))

    def destroy_tasks(self) -> None:
        for runner in self.task_runners.values():
            runner.destroy()

    def destroy(self) -> None:
        """Full teardown incl. the alloc dir (alloc_runner.go Destroy)."""
        self._destroyed = True
        self.destroy_tasks()
        for runner in self.task_runners.values():
            runner.wait_done(timeout=5.0)
        self.alloc_dir.destroy()

    def alive(self) -> bool:
        return any(tr.handle is not None and tr.handle.is_running()
                   for tr in self.task_runners.values())

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else timeout
        for runner in self.task_runners.values():
            if not runner.wait_done(deadline):
                return False
        return True
