"""mock driver: configurable in-process task for tests.

Plays the role the reference's environment-gated driver tests fill with real
binaries (SURVEY.md §4.3): deterministic run time + exit code without OS
dependencies.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from nomad_tpu_torch.client.driver.driver import Driver, DriverHandle
from nomad_tpu_torch.structs import Node, Task

_HANDLES: Dict[str, "MockHandle"] = {}


class MockHandle(DriverHandle):
    def __init__(self, handle_id: str, run_for: float, exit_code: int):
        self.handle_id = handle_id
        self.exit_code = exit_code
        self._done = threading.Event()
        self._killed = False
        self._timer = threading.Timer(run_for, self._done.set)
        self._timer.daemon = True
        self._timer.start()
        _HANDLES[handle_id] = self

    def id(self) -> str:
        return self.handle_id

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        if not self._done.wait(timeout):
            return None
        return 137 if self._killed else self.exit_code

    def is_running(self) -> bool:
        return not self._done.is_set()

    def update(self, task: Task) -> None:
        pass

    def kill(self) -> None:
        self._killed = True
        self._timer.cancel()
        self._done.set()


class MockDriver(Driver):
    name = "mock_driver"

    @classmethod
    def fingerprint(cls, config, node: Node) -> bool:
        if not config.read_bool_default("driver.mock_driver.enable", False):
            return False
        node.attributes["driver.mock_driver"] = "1"
        return True

    def start(self, task: Task) -> DriverHandle:
        run_for = float(task.config.get("run_for", 1.0))
        exit_code = int(task.config.get("exit_code", 0))
        handle_id = f"mock:{self.ctx.alloc_id}:{task.name}:{time.monotonic()}"
        return MockHandle(handle_id, run_for, exit_code)

    def open(self, handle_id: str) -> DriverHandle:
        handle = _HANDLES.get(handle_id)
        if handle is None:
            # After restart the in-process timer is gone; report finished.
            handle = MockHandle(handle_id, 0.0, 0)
        return handle
