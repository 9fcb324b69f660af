"""docker driver: containerized execution via the docker CLI.

Reference: upstream client/driver/docker.go (go-dockerclient). The
capability set carries over — fingerprint the daemon (docker.go:63-103),
create with binds/port maps/resource limits, start, cleanup flags — driven
through the CLI instead of the HTTP client.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import List

from nomad_tpu_torch.client.driver.driver import (
    Driver,
    DriverError,
    DriverHandle,
    task_environment,
)
from nomad_tpu_torch.structs import Node, Task


class DockerHandle(DriverHandle):
    def __init__(self, container_id: str, cleanup_container: bool = True):
        self.container_id = container_id
        self.cleanup_container = cleanup_container

    def id(self) -> str:
        return f"docker:{self.container_id}"

    def wait(self, timeout=None):
        try:
            out = subprocess.run(
                ["docker", "wait", self.container_id],
                capture_output=True, text=True, timeout=timeout,
            )
            return int(out.stdout.strip())
        except subprocess.TimeoutExpired:
            return None
        except (OSError, ValueError):
            return -1

    def is_running(self) -> bool:
        out = subprocess.run(
            ["docker", "inspect", "-f", "{{.State.Running}}", self.container_id],
            capture_output=True, text=True,
        )
        return out.stdout.strip() == "true"

    def update(self, task: Task) -> None:
        pass

    def kill(self) -> None:
        subprocess.run(
            ["docker", "stop", "-t", "5", self.container_id],
            capture_output=True,
        )
        if self.cleanup_container:
            subprocess.run(
                ["docker", "rm", "-f", self.container_id], capture_output=True
            )


class DockerDriver(Driver):
    name = "docker"

    @classmethod
    def fingerprint(cls, config, node: Node) -> bool:
        """docker.go:63-103: detect the daemon + version."""
        if shutil.which("docker") is None:
            return False
        try:
            out = subprocess.run(
                ["docker", "version", "--format", "{{.Server.Version}}"],
                capture_output=True, text=True, timeout=10,
            )
        except (OSError, subprocess.TimeoutExpired):
            return False
        if out.returncode != 0:
            return False
        node.attributes["driver.docker"] = "1"
        node.attributes["driver.docker.version"] = out.stdout.strip()
        return True

    def start(self, task: Task) -> DriverHandle:
        image = task.config.get("image")
        if not image:
            raise DriverError("missing image for docker driver")

        cmd: List[str] = ["docker", "run", "-d"]
        # Bind the shared alloc dir + task local dir (docker.go containerBinds)
        task_dir = self.ctx.alloc_dir.task_dirs.get(
            task.name, self.ctx.alloc_dir.alloc_dir
        )
        cmd += ["-v", f"{self.ctx.alloc_dir.shared_dir}:/alloc"]
        cmd += ["-v", f"{task_dir}/local:/local"]

        if task.resources is not None:
            if task.resources.memory_mb > 0:
                cmd += ["--memory", f"{task.resources.memory_mb}m"]
            if task.resources.cpu > 0:
                cmd += ["--cpu-shares", str(task.resources.cpu)]
            for net in task.resources.networks[:1]:
                for label, port in net.map_dynamic_ports().items():
                    cmd += ["-p", f"{port}:{port}"]
                for port in net.list_static_ports():
                    cmd += ["-p", f"{port}:{port}"]

        for key, value in task_environment(self.ctx, task).items():
            cmd += ["-e", f"{key}={value}"]

        cmd.append(image)
        if task.config.get("command"):
            cmd.append(task.config["command"])
            from nomad_tpu_torch.client.driver.raw_exec import _parse_args

            cmd.extend(_parse_args(task.config.get("args")))

        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise DriverError(f"docker run failed: {out.stderr.strip()}")
        return DockerHandle(out.stdout.strip())

    def open(self, handle_id: str) -> DriverHandle:
        if not handle_id.startswith("docker:"):
            raise DriverError(f"invalid docker handle {handle_id!r}")
        return DockerHandle(handle_id[len("docker:"):])
