"""raw_exec driver: no-isolation command execution.

Reference: upstream client/driver/raw_exec.go — gated behind
``driver.raw_exec.enable`` since it runs unsandboxed (raw_exec.go:37-57).
"""

from __future__ import annotations

import shlex

from nomad_tpu_torch.client.driver import executor
from nomad_tpu_torch.client.driver.driver import (
    Driver,
    DriverError,
    DriverHandle,
    task_environment,
)
from nomad_tpu_torch.structs import Node, Task


class RawExecDriver(Driver):
    name = "raw_exec"

    @classmethod
    def fingerprint(cls, config, node: Node) -> bool:
        if not config.read_bool_default("driver.raw_exec.enable", False):
            return False
        node.attributes["driver.raw_exec"] = "1"
        return True

    def start(self, task: Task) -> DriverHandle:
        command = task.config.get("command")
        if not command:
            raise DriverError("missing command for raw_exec driver")
        args = _parse_args(task.config.get("args"))
        env = task_environment(self.ctx, task)
        return executor.start_command(
            self.ctx, task, command, args, env, isolate=False
        )

    def open(self, handle_id: str) -> DriverHandle:
        return executor.open_handle(handle_id)


def _parse_args(raw) -> list:
    if raw is None:
        return []
    if isinstance(raw, list):
        return [str(a) for a in raw]
    return shlex.split(str(raw))
