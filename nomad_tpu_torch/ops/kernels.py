"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. All
sources build at first use, one ``nvcc`` process each, started together,
into ``nomad_tpu_torch/_build/`` under a name keyed by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one is
loaded as it is. Nothing here runs at import time: the CPU tests import
every module of the port and have no ``nvcc``.

No fast math: the BestFit score's ``powf`` must be the accurate one, and
``--fmad=false`` keeps multiply-adds as the separate roundings the plain
PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], object] = {}
# Filled by the first build: wall seconds and each source's ptxas report
# (registers, shared memory, spills per kernel).
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> Dict[str, Path]:
    sources = sorted(CSRC.glob("*.cu"))
    digest = _digest(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {src.stem: BUILD_DIR / f"lib{src.stem}-{digest}.so"
            for src in sources}
    t0 = time.perf_counter()
    procs = []
    nvcc = None
    for src in sources:
        out = outs[src.stem]
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append((src, tmp, out, proc))
    reports = {}
    failed = []
    for src, tmp, out, proc in procs:
        log, _ = proc.communicate()
        reports[src.name] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["built"] = sorted(reports)
    BUILD_INFO["ptxas"] = reports
    return outs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<name>.cu`` (builds
    every source on first call)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _libs:
                for stem, path in _build_all().items():
                    _libs[stem] = ctypes.CDLL(str(path))
            lib = _libs[name]
        return lib


def entry(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, declared as
    ``int symbol(void* x n_ptrs, int x n_ints, void* stream)``: pointers
    first, then ints, then the CUDA stream; returns the cudaError_t.
    Declared once, at the first call for that symbol."""
    fn = _entries.get((name, symbol))
    if fn is not None:
        return fn
    lib = library(name)
    with _lock:
        fn = _entries.get((name, symbol))
        if fn is None:
            fn = getattr(lib, symbol)
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _entries[(name, symbol)] = fn
        return fn


def check_launch(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel '{kernel}' failed to launch "
                           f"(cudaError {err})")
