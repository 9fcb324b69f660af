"""Allocation directory management.

Reference: upstream client/allocdir/alloc_dir.go. Tree layout:
``<alloc>/alloc/{logs,tmp,data}`` shared across tasks, plus a private
``<alloc>/<task>/local`` per task. The reference bind-mounts the shared dir
into task dirs on Linux (alloc_dir_linux.go); without mount privileges we
expose it via the SHARED_ALLOC_DIR env var instead.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List

SHARED_ALLOC_NAME = "alloc"
TMP_DIR_NAME = "tmp"
LOG_DIR_NAME = "logs"
DATA_DIR_NAME = "data"
TASK_LOCAL = "local"


class AllocDir:
    def __init__(self, alloc_dir: str):
        self.alloc_dir = alloc_dir
        self.shared_dir = os.path.join(alloc_dir, SHARED_ALLOC_NAME)
        self.task_dirs: Dict[str, str] = {}

    def build(self, tasks: List[str]) -> None:
        """Create the shared tree + per-task dirs (alloc_dir.go Build)."""
        os.makedirs(self.alloc_dir, exist_ok=True)
        os.makedirs(self.shared_dir, exist_ok=True)
        for sub in (TMP_DIR_NAME, LOG_DIR_NAME, DATA_DIR_NAME):
            os.makedirs(os.path.join(self.shared_dir, sub), exist_ok=True)
        for task in tasks:
            task_dir = os.path.join(self.alloc_dir, task)
            os.makedirs(os.path.join(task_dir, TASK_LOCAL), exist_ok=True)
            self.task_dirs[task] = task_dir

    def log_dir(self) -> str:
        return os.path.join(self.shared_dir, LOG_DIR_NAME)

    def embed(self, task: str, dirs: Dict[str, str]) -> None:
        """Populate a task's chroot with host directories
        (alloc_dir.go:115-170 Embed): each ``{host_src: chroot_dest}``
        entry is mirrored into the task dir, hardlinking files where the
        filesystem allows and copying otherwise. Missing sources are
        skipped (the reference's chrootEnv is a best-effort host set)."""
        task_dir = self.task_dirs[task]
        for src, dest in dirs.items():
            if not os.path.isdir(src):
                continue
            dest_dir = os.path.join(task_dir, dest.lstrip("/"))
            for dirpath, _subdirs, files in os.walk(src):
                rel = os.path.relpath(dirpath, src)
                target = (dest_dir if rel == "." else
                          os.path.join(dest_dir, rel))
                os.makedirs(target, exist_ok=True)
                for name in files:
                    s = os.path.join(dirpath, name)
                    t = os.path.join(target, name)
                    if os.path.lexists(t):
                        continue
                    try:
                        if os.path.islink(s):
                            os.symlink(os.readlink(s), t)
                        else:
                            os.link(s, t)
                    except OSError:
                        try:
                            shutil.copy2(s, t, follow_symlinks=False)
                        except OSError:
                            pass  # best-effort, like the reference

    def destroy(self) -> None:
        shutil.rmtree(self.alloc_dir, ignore_errors=True)
