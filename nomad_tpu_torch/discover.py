"""Locate the runnable nomad_tpu_torch entrypoint for re-exec (port of
nomad_tpu/discover.py).

Reference: upstream helper/discover/discover.go — finds the nomad
binary so the spawn daemon can re-exec it. Here the "binary" is this
interpreter running the package as a module: drivers use it to build the
``spawn-daemon`` command line however the agent was started. Unlike
nomad_tpu, no console script is looked up: ``nomad-tpu`` on PATH is
nomad_tpu's CLI.
"""

from __future__ import annotations

import sys
from typing import List


def nomad_command() -> List[str]:
    """Command prefix that reaches the port's CLI from a fresh process."""
    return [sys.executable, "-m", "nomad_tpu_torch"]


def spawn_daemon_command(spec_json: str) -> List[str]:
    """Command line for the spawn-daemon plumbing command
    (command/spawn_daemon.go re-exec via helper/discover)."""
    return nomad_command() + ["spawn-daemon", spec_json]
