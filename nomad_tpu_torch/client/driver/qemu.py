"""qemu driver: run VM images under qemu-system-x86_64.

Reference: upstream client/driver/qemu.go — download the image
(checksum-verified), build the qemu command line with memory + port
forwards, run via the executor.
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
from nomad_tpu_torch.client.getter import get_artifact
from nomad_tpu_torch.structs import Node, Task

QEMU_BIN = "qemu-system-x86_64"


class QemuDriver(Driver):
    name = "qemu"

    @classmethod
    def fingerprint(cls, config, node: Node) -> bool:
        path = shutil.which(QEMU_BIN)
        if path is None:
            return False
        try:
            out = subprocess.run(
                [QEMU_BIN, "--version"], capture_output=True, text=True, timeout=10
            )
            version = out.stdout.split("version", 1)[-1].strip().split()[0]
        except (OSError, subprocess.TimeoutExpired, IndexError):
            return False
        node.attributes["driver.qemu"] = "1"
        node.attributes["driver.qemu.version"] = version
        return True

    def start(self, task: Task) -> DriverHandle:
        source = task.config.get("artifact_source") or task.config.get("image_path")
        if not source:
            raise DriverError("missing artifact_source for qemu driver")
        task_dir = self.ctx.alloc_dir.task_dirs.get(
            task.name, self.ctx.alloc_dir.alloc_dir
        )
        image = (
            get_artifact(source, task_dir, task.config.get("checksum", ""))
            if "://" in source
            else source
        )

        mem_mb = task.resources.memory_mb if task.resources else 512
        args = [
            "-machine", "type=pc,accel=tcg",
            "-name", task.name,
            "-m", f"{mem_mb}M",
            "-drive", f"file={image}",
            "-nodefaults",
            "-nographic",
        ]
        # Port forwards from reserved/dynamic ports (qemu.go guest_ports)
        if task.resources and task.resources.networks:
            net = task.resources.networks[0]
            fwds = ",".join(
                f"hostfwd=tcp::{port}-:{port}" for port in net.reserved_ports
            )
            if fwds:
                args += ["-netdev", f"user,id=user.0,{fwds}",
                         "-device", "virtio-net,netdev=user.0"]

        env = task_environment(self.ctx, task)
        return executor.start_command(self.ctx, task, QEMU_BIN, args, env)

    def open(self, handle_id: str) -> DriverHandle:
        return executor.open_handle(handle_id)
