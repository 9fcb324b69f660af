"""exec driver: isolated command execution.

Reference: upstream client/driver/exec.go — cgroup/chroot isolation
via the shared executor, artifact fetch via client/getter. Isolation
degrades gracefully when the agent lacks cgroup privileges (the handle
records whether limits were applied).
"""

from __future__ import annotations

import platform

from nomad_tpu_torch.client.driver import executor
from nomad_tpu_torch.client.driver.driver import (
    Driver,
    DriverError,
    DriverHandle,
    task_environment,
)
from nomad_tpu_torch.client.driver.raw_exec import _parse_args
from nomad_tpu_torch.client.getter import get_artifact
from nomad_tpu_torch.structs import Node, Task


class ExecDriver(Driver):
    name = "exec"

    @classmethod
    def fingerprint(cls, config, node: Node) -> bool:
        # Reference gates on Linux + root for cgroups (exec.go:34-49); we
        # advertise on Linux and record the isolation level as an attribute.
        if platform.system() != "Linux":
            return False
        node.attributes["driver.exec"] = "1"
        levels = []
        if cls._chroot_enabled(config) and executor.chroot_available():
            levels.append("chroot")
        if executor.cgroups_available():
            levels.append("cgroups")
        node.attributes["driver.exec.isolation"] = (
            "+".join(levels) or "none"
        )
        return True

    @staticmethod
    def _chroot_enabled(config) -> bool:
        """chroot + setuid-nobody isolation, on by default as root (the
        reference Linux executor posture, exec_linux.go:154-156, 240-290);
        opt out with client option exec.chroot=0."""
        if config is None:
            return True
        read = getattr(config, "read_bool_default", None)
        if read is not None:
            return read("exec.chroot", True)
        return str(config.get("exec.chroot", "1")) not in ("0", "false")

    def start(self, task: Task) -> DriverHandle:
        command = task.config.get("command")
        artifact = task.config.get("artifact_source")
        task_dir = self.ctx.alloc_dir.task_dirs.get(
            task.name, self.ctx.alloc_dir.alloc_dir
        )
        if artifact:
            fetched = get_artifact(
                artifact, task_dir, task.config.get("checksum", "")
            )
            if not command:
                command = fetched
        if not command:
            raise DriverError("missing command for exec driver")
        args = _parse_args(task.config.get("args"))
        env = task_environment(self.ctx, task)
        use_chroot = (
            self._chroot_enabled(self.ctx.options)
            and executor.chroot_available()
        )
        if use_chroot:
            # Populate the chroot with the host tool set (overridable:
            # exec.chroot_env = "src:dest,src:dest"), then translate the
            # command to its in-root path (artifacts are already inside
            # the task dir).
            env_opt = str(self.ctx.options.get("exec.chroot_env", ""))
            if env_opt:
                chroot_env = dict(
                    (pair.split(":", 1) + [pair])[:2]
                    for pair in env_opt.split(",") if pair
                )
            else:
                chroot_env = executor.CHROOT_ENV
            self.ctx.alloc_dir.embed(task.name, chroot_env)
            if command.startswith(task_dir):
                command = command[len(task_dir):] or "/"
        return executor.start_command(
            self.ctx, task, command, args, env, isolate=True,
            chroot=use_chroot, run_as_nobody=use_chroot,
        )

    def open(self, handle_id: str) -> DriverHandle:
        return executor.open_handle(handle_id)
