"""java driver: fetch a jar and run it under the JVM.

Reference: upstream client/driver/java.go.
"""

from __future__ import annotations

import shutil
import subprocess

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


class JavaDriver(Driver):
    name = "java"

    @classmethod
    def fingerprint(cls, config, node: Node) -> bool:
        java = shutil.which("java")
        if java is None:
            return False
        try:
            out = subprocess.run(
                ["java", "-version"], capture_output=True, text=True, timeout=10
            )
            version_line = (out.stderr or out.stdout).splitlines()[0]
        except (OSError, subprocess.TimeoutExpired, IndexError):
            return False
        node.attributes["driver.java"] = "1"
        node.attributes["driver.java.version"] = version_line
        return True

    def start(self, task: Task) -> DriverHandle:
        source = task.config.get("artifact_source") or task.config.get("jar_path")
        if not source:
            raise DriverError("missing artifact_source for java driver")
        task_dir = self.ctx.alloc_dir.task_dirs.get(
            task.name, self.ctx.alloc_dir.alloc_dir
        )
        jar = (
            get_artifact(source, task_dir, task.config.get("checksum", ""))
            if "://" in source
            else source
        )
        jvm_args = _parse_args(task.config.get("jvm_options"))
        args = [*jvm_args, "-jar", jar, *_parse_args(task.config.get("args"))]
        env = task_environment(self.ctx, task)
        return executor.start_command(self.ctx, task, "java", args, env)

    def open(self, handle_id: str) -> DriverHandle:
        return executor.open_handle(handle_id)
