"""Spawn daemon: run a user command detached from the agent.

Reference: upstream client/driver/spawn/spawn.go +
command/spawn_daemon*.go. The reference double-forks via ``nomad
spawn-daemon`` so the task survives agent restarts and writes the exit
status to a state file the agent can reattach to (spawn.go:18-80,
Valid()/Wait() at :150-250). Here the daemon is ``python -m
nomad_tpu_torch spawn-daemon`` (discover.py) with a JSON spec on argv,
and its imports stop short of ``torch``: a task start pays for no CUDA
context.

State files inside the task dir:
- ``<prefix>.pid``    — daemon-written pid of the user process
- ``<prefix>.status`` — JSON {"exit_code": N} once the process exits
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional


def spawn_detached(
    command: str,
    args: List[str],
    env: Dict[str, str],
    cwd: str,
    stdout_path: str,
    stderr_path: str,
    state_prefix: str,
    chroot: str = "",
    uid: int = -1,
    gid: int = -1,
) -> int:
    """Launch the spawn daemon; returns the daemon pid. The daemon execs the
    user command in a new session and records pid + exit status.

    ``chroot``/``uid``/``gid`` apply least-privilege isolation in the child
    just before exec (the reference Linux executor chroots into the task
    dir and runs as nobody, exec_linux.go:154-156, 240-290); they require
    the agent to run as root."""
    spec = {
        "command": command,
        "args": args,
        "env": env,
        "cwd": cwd,
        "stdout": stdout_path,
        "stderr": stderr_path,
        "state_prefix": state_prefix,
        "chroot": chroot,
        "uid": uid,
        "gid": gid,
    }
    from nomad_tpu_torch.discover import spawn_daemon_command

    proc = subprocess.Popen(
        spawn_daemon_command(json.dumps(spec)),
        start_new_session=True,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        cwd="/",
        env={**os.environ, "PYTHONPATH": _repo_root()},
    )
    # Wait for the daemon to write the pid file (spawn.go:82-114 uses a
    # pipe handshake; a bounded poll is equivalent here).
    pid_path = state_prefix + ".pid"
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if os.path.exists(pid_path):
            with open(pid_path) as f:
                content = f.read().strip()
            if content:
                return int(content)
        if proc.poll() is not None and not os.path.exists(pid_path):
            raise RuntimeError(
                f"spawn daemon exited ({proc.returncode}) before writing pid"
            )
        time.sleep(0.01)
    raise TimeoutError("spawn daemon did not report a pid")


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def read_status(state_prefix: str) -> Optional[int]:
    """Exit code if the task has exited, else None."""
    try:
        with open(state_prefix + ".status") as f:
            return int(json.load(f)["exit_code"])
    except (OSError, ValueError, KeyError):
        return None


def read_pid(state_prefix: str) -> Optional[int]:
    try:
        with open(state_prefix + ".pid") as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def wait(state_prefix: str, timeout: Optional[float] = None,
         poll: float = 0.05) -> Optional[int]:
    """Block until the status file appears; returns exit code, or None on
    timeout. Survives daemon death (kill -9 leaves no status file): if both
    daemon and task are gone without a status, report -1."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        status = read_status(state_prefix)
        if status is not None:
            return status
        pid = read_pid(state_prefix)
        if pid is not None and not pid_alive(pid):
            # Grace period for the daemon to flush the status file
            time.sleep(0.2)
            status = read_status(state_prefix)
            return status if status is not None else -1
        if deadline is not None and time.monotonic() > deadline:
            return None
        time.sleep(poll)


def kill(state_prefix: str) -> None:
    pid = read_pid(state_prefix)
    if pid is not None and pid_alive(pid):
        try:
            # The task runs in its own session; nuke the process group.
            os.killpg(os.getpgid(pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _daemon_main(spec_json: str) -> int:
    """The daemon body: start the user process in a new session, record its
    pid, wait, record its exit status (command/spawn_daemon.go)."""
    spec = json.loads(spec_json)
    prefix = spec["state_prefix"]

    stdout = open(spec["stdout"], "ab")
    stderr = open(spec["stderr"], "ab")

    chroot = spec.get("chroot") or ""
    uid = int(spec.get("uid", -1))
    gid = int(spec.get("gid", -1))
    cwd = spec["cwd"]
    preexec = None
    if chroot or uid >= 0:
        # Least-privilege order matters: chroot while still root, then drop
        # groups/gid/uid (exec_linux.go:145-156). Runs in the forked child
        # (single-threaded daemon) right before exec; the command path
        # resolves inside the new root.
        cwd = None

        def preexec():
            if chroot:
                os.chroot(chroot)
                os.chdir("/")
            if gid >= 0:
                os.setgroups([])
                os.setgid(gid)
            if uid >= 0:
                os.setuid(uid)

    try:
        proc = subprocess.Popen(
            [spec["command"], *spec["args"]],
            env=spec["env"],
            cwd=cwd,
            stdout=stdout,
            stderr=stderr,
            start_new_session=True,
            preexec_fn=preexec,
        )
    except OSError as e:
        with open(prefix + ".status", "w") as f:
            json.dump({"exit_code": 127, "error": str(e)}, f)
        with open(prefix + ".pid", "w") as f:
            f.write("0")
        return 0

    with open(prefix + ".pid.tmp", "w") as f:
        f.write(str(proc.pid))
    os.replace(prefix + ".pid.tmp", prefix + ".pid")

    code = proc.wait()
    with open(prefix + ".status.tmp", "w") as f:
        json.dump({"exit_code": code}, f)
    os.replace(prefix + ".status.tmp", prefix + ".status")
    return 0


if __name__ == "__main__":
    sys.exit(_daemon_main(sys.argv[1]))
