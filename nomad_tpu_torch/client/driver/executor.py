"""Shared executor: spawn-daemon-backed task execution with optional
resource limits.

Reference: upstream client/driver/executor/ — the Linux executor
applies cgroups (cpu.shares/memory) + chroot + setuid (exec_linux.go:426);
the basic executor is a plain process (exec_basic.go). Here cgroup-v2
limits are applied when the agent has write access to the cgroup fs
(unprivileged containers usually don't); otherwise execution degrades to
the basic posture, recorded on the handle.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional

from nomad_tpu_torch.client.driver import spawn
from nomad_tpu_torch.client.driver.driver import DriverHandle
from nomad_tpu_torch.structs import Resources, Task

CGROUP_ROOT = "/sys/fs/cgroup"

_start_counter = itertools.count()


def cgroups_available() -> bool:
    return os.access(os.path.join(CGROUP_ROOT, "cgroup.subtree_control"), os.W_OK)


def apply_cgroup_limits(pid: int, name: str, resources: Optional[Resources]) -> bool:
    """Best-effort cgroup-v2 limits (cpu.weight + memory.max), mirroring the
    reference's Limit() (exec_linux.go). Returns True if applied."""
    if resources is None or not cgroups_available():
        return False
    cg_dir = os.path.join(CGROUP_ROOT, f"nomad-{name}-{pid}")
    try:
        os.makedirs(cg_dir, exist_ok=True)
        if resources.memory_mb > 0:
            with open(os.path.join(cg_dir, "memory.max"), "w") as f:
                f.write(str(resources.memory_mb * 1024 * 1024))
        if resources.cpu > 0:
            # Map cpu shares (MHz) onto cgroup-v2 weight [1, 10000]
            weight = max(1, min(10000, resources.cpu // 10))
            with open(os.path.join(cg_dir, "cpu.weight"), "w") as f:
                f.write(str(weight))
        with open(os.path.join(cg_dir, "cgroup.procs"), "w") as f:
            f.write(str(pid))
        return True
    except OSError:
        return False


class ExecutorHandle(DriverHandle):
    """Handle over a spawn-daemon-managed process."""

    def __init__(self, state_prefix: str, isolated: bool = False):
        self.state_prefix = state_prefix
        self.isolated = isolated

    def id(self) -> str:
        return self.state_prefix

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        return spawn.wait(self.state_prefix, timeout)

    def is_running(self) -> bool:
        if spawn.read_status(self.state_prefix) is not None:
            return False
        pid = spawn.read_pid(self.state_prefix)
        return pid is not None and spawn.pid_alive(pid)

    def update(self, task: Task) -> None:
        pass  # nothing dynamic yet, like the reference handles

    def kill(self) -> None:
        spawn.kill(self.state_prefix)


# Host directories embedded into each exec-driver chroot
# (exec_linux.go:29-41 chrootEnv).
CHROOT_ENV = {
    "/bin": "/bin",
    "/etc": "/etc",
    "/lib": "/lib",
    "/lib32": "/lib32",
    "/lib64": "/lib64",
    "/usr/bin": "/usr/bin",
    "/usr/lib": "/usr/lib",
}


def chroot_available() -> bool:
    """chroot + setuid require root (exec_linux.go gates the Linux
    executor the same way)."""
    return os.name == "posix" and os.geteuid() == 0


def nobody_ids() -> tuple:
    """(uid, gid) of the unprivileged user tasks run as
    (exec_linux.go:154-156 runAs("nobody"))."""
    import pwd

    try:
        rec = pwd.getpwnam("nobody")
        return rec.pw_uid, rec.pw_gid
    except KeyError:
        return 65534, 65534


def start_command(
    ctx,
    task: Task,
    command: str,
    args: List[str],
    env: Dict[str, str],
    isolate: bool = True,
    chroot: bool = False,
    run_as_nobody: bool = False,
) -> ExecutorHandle:
    """Start a command through the spawn daemon in the task's directory.

    With ``chroot`` the child roots into the task dir before exec, so
    ``command`` must be a path inside it (artifacts land there; host
    binaries ride the embedded CHROOT_ENV). ``run_as_nobody`` drops
    privileges after the chroot. Both require root and silently degrade
    otherwise, recorded on the handle."""
    task_dir = ctx.alloc_dir.task_dirs.get(task.name, ctx.alloc_dir.alloc_dir)
    log_dir = ctx.alloc_dir.log_dir()
    # Unique per start: a restart must not read the previous attempt's
    # pid/status files.
    nonce = next(_start_counter)
    state_prefix = os.path.join(
        task_dir, f".{task.name}-{ctx.alloc_id[:8]}-{nonce}"
    )
    for stale in (state_prefix + ".pid", state_prefix + ".status"):
        if os.path.exists(stale):
            os.unlink(stale)
    stdout = os.path.join(log_dir, f"{task.name}.stdout")
    stderr = os.path.join(log_dir, f"{task.name}.stderr")

    full_env = dict(os.environ) if not isolate else {}
    full_env.update(env)
    full_env.setdefault("PATH", os.environ.get("PATH", "/usr/bin:/bin"))

    can_isolate = chroot_available()
    uid = gid = -1
    if run_as_nobody and can_isolate:
        uid, gid = nobody_ids()
    chroot_dir = task_dir if (chroot and can_isolate) else ""

    pid = spawn.spawn_detached(
        command, args, full_env, task_dir, stdout, stderr, state_prefix,
        chroot=chroot_dir, uid=uid, gid=gid,
    )
    isolated = isolate and apply_cgroup_limits(pid, task.name, task.resources)
    return ExecutorHandle(state_prefix, isolated or bool(chroot_dir))


def open_handle(handle_id: str) -> ExecutorHandle:
    """Reattach to a running task by handle ID (driver.go:54-55 Open)."""
    return ExecutorHandle(handle_id)
