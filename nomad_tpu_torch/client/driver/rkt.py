"""rkt driver: run App Container images via ``rkt run``.

Reference: upstream client/driver/rkt.go — fingerprint the rkt
binary + version (rkt.go:53-76), trust the image prefix when asked, and
``rkt run`` with ``--insecure-skip-verify`` (rkt.go:82-173); the reference
notes resource isolation is not applied yet (rkt.go:30-35), so the process
runs through the basic executor like raw_exec.
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
from nomad_tpu_torch.structs import Node, Task

RKT_BIN = "rkt"


class RktDriver(Driver):
    name = "rkt"

    @classmethod
    def fingerprint(cls, config, node: Node) -> bool:
        path = shutil.which(RKT_BIN)
        if path is None:
            return False
        try:
            out = subprocess.run(
                [RKT_BIN, "version"], capture_output=True, text=True, timeout=10
            )
            version = ""
            for line in out.stdout.splitlines():
                if line.lower().startswith("rkt version"):
                    version = line.split()[-1]
                    break
        except (OSError, subprocess.TimeoutExpired):
            return False
        node.attributes["driver.rkt"] = "1"
        node.attributes["driver.rkt.version"] = version
        return True

    def start(self, task: Task) -> DriverHandle:
        image = task.config.get("image")
        if not image:
            raise DriverError("missing image for rkt driver")

        args = ["run", "--insecure-skip-verify", "--mds-register=false", image]
        if task.config.get("command"):
            args += ["--exec", task.config["command"]]
        if task.config.get("args"):
            extra = task.config["args"]
            if isinstance(extra, str):
                extra = extra.split()
            args += ["--"] + list(extra)

        env = task_environment(self.ctx, task)
        return executor.start_command(self.ctx, task, RKT_BIN, args, env)

    def open(self, handle_id: str) -> DriverHandle:
        return executor.open_handle(handle_id)
