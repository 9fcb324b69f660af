"""Task drivers: pluggable execution backends.

Reference: upstream client/driver/driver.go. ``BUILTIN_DRIVERS``
mirrors driver.go:18-25 (docker, exec, raw_exec, java, qemu) plus a mock
driver for tests; each driver fingerprints its own availability.
"""

from nomad_tpu_torch.client.driver.driver import (
    BUILTIN_DRIVERS,
    Driver,
    DriverHandle,
    ExecContext,
    new_driver,
)

__all__ = [
    "BUILTIN_DRIVERS",
    "Driver",
    "DriverHandle",
    "ExecContext",
    "new_driver",
]
