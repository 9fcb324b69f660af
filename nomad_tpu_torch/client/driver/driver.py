"""Driver interface, registry, and task environment assembly.

Reference: upstream client/driver/driver.go:18-145.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

from nomad_tpu_torch.structs import Node, Task


class DriverError(Exception):
    pass


class ExecContext:
    """Context passed to driver start (reference: driver.go:97-116)."""

    def __init__(self, alloc_dir, alloc_id: str, options=None):
        self.alloc_dir = alloc_dir  # allocdir.AllocDir
        self.alloc_id = alloc_id
        # Client config options (config.Options namespaced map, consumed by
        # drivers like the reference's DriverContext config,
        # client/config/config.go:51-75). Plain dict, may be empty.
        self.options = options or {}


class DriverHandle:
    """Handle on a running task (reference: driver.go:83-95)."""

    def id(self) -> str:
        """Opaque handle ID, usable to re-open after agent restart."""
        raise NotImplementedError

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        """Block for task exit; returns exit code or None on timeout.
        (The reference exposes WaitCh; a blocking wait is the Python shape.)
        """
        raise NotImplementedError

    def is_running(self) -> bool:
        raise NotImplementedError

    def update(self, task: Task) -> None:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError


class Driver:
    """Driver interface (reference: driver.go:47-81)."""

    name = "base"

    def __init__(self, ctx: ExecContext, logger: Optional[logging.Logger] = None):
        self.ctx = ctx
        self.logger = logger or logging.getLogger(f"nomad_tpu_torch.driver.{self.name}")

    @classmethod
    def fingerprint(cls, config, node: Node) -> bool:
        """Detect availability; set node.attributes['driver.<name>']."""
        raise NotImplementedError

    def start(self, task: Task) -> DriverHandle:
        raise NotImplementedError

    def open(self, handle_id: str) -> DriverHandle:
        """Re-open a handle after client restart (driver.go:54-55)."""
        raise NotImplementedError


def task_environment(ctx: ExecContext, task: Task) -> Dict[str, str]:
    """Assemble the task's environment variables
    (reference: driver.go:118-145 TaskEnvironmentVariables)."""
    env: Dict[str, str] = {}
    task_dir = ctx.alloc_dir.task_dirs.get(task.name, ctx.alloc_dir.alloc_dir)
    env["NOMAD_ALLOC_DIR"] = ctx.alloc_dir.shared_dir
    env["NOMAD_TASK_DIR"] = task_dir
    env["NOMAD_ALLOC_ID"] = ctx.alloc_id
    if task.resources is not None:
        env["NOMAD_CPU_LIMIT"] = str(task.resources.cpu)
        env["NOMAD_MEMORY_LIMIT"] = str(task.resources.memory_mb)
        if task.resources.networks:
            net = task.resources.networks[0]
            if net.ip:
                env["NOMAD_IP"] = net.ip
            # map_dynamic_ports returns {} on a raw (unoffered) ask.
            for label, port in net.map_dynamic_ports().items():
                env[f"NOMAD_PORT_{label}"] = str(port)
    for key, value in task.meta.items():
        env[f"NOMAD_META_{key.upper().replace('-', '_')}"] = value
    env.update(task.env)
    return env


_REGISTRY: Dict[str, Callable] = {}


def register_driver(name: str, factory: Callable) -> None:
    _REGISTRY[name] = factory


def new_driver(name: str, ctx: ExecContext, logger=None) -> Driver:
    """driver.go:28-39"""
    factory = _REGISTRY.get(name)
    if factory is None:
        raise DriverError(f"unknown driver '{name}'")
    return factory(ctx, logger)


def _register_builtins() -> None:
    from nomad_tpu_torch.client.driver.docker import DockerDriver
    from nomad_tpu_torch.client.driver.exec_driver import ExecDriver
    from nomad_tpu_torch.client.driver.java import JavaDriver
    from nomad_tpu_torch.client.driver.mock_driver import MockDriver
    from nomad_tpu_torch.client.driver.qemu import QemuDriver
    from nomad_tpu_torch.client.driver.raw_exec import RawExecDriver
    from nomad_tpu_torch.client.driver.rkt import RktDriver

    register_driver("docker", DockerDriver)
    register_driver("exec", ExecDriver)
    register_driver("raw_exec", RawExecDriver)
    register_driver("java", JavaDriver)
    register_driver("qemu", QemuDriver)
    register_driver("rkt", RktDriver)
    register_driver("mock_driver", MockDriver)


_register_builtins()

BUILTIN_DRIVERS = dict(_REGISTRY)


def builtin_driver_classes():
    from nomad_tpu_torch.client.driver.docker import DockerDriver
    from nomad_tpu_torch.client.driver.exec_driver import ExecDriver
    from nomad_tpu_torch.client.driver.java import JavaDriver
    from nomad_tpu_torch.client.driver.mock_driver import MockDriver
    from nomad_tpu_torch.client.driver.qemu import QemuDriver
    from nomad_tpu_torch.client.driver.raw_exec import RawExecDriver
    from nomad_tpu_torch.client.driver.rkt import RktDriver

    return {
        "docker": DockerDriver,
        "exec": ExecDriver,
        "raw_exec": RawExecDriver,
        "java": JavaDriver,
        "qemu": QemuDriver,
        "rkt": RktDriver,
        "mock_driver": MockDriver,
    }
