"""ctypes loader for the native control-plane kernels.

Port of nomad_tpu/native: the same three C functions
(``src/nomad_native.cpp``) behind the same API. The library is built at
first use with the host C++ compiler (``$CXX``, else ``c++``) into
``nomad_tpu_torch/_build/`` under a name keyed by a hash of the source
and flags, through a temporary file and ``os.replace`` so processes that
build at once never load a half-written library. Nothing is built at
import time.

Unlike nomad_tpu's loader there is no silent fallback: a missing compiler,
a failed build or a failed load raises ``RuntimeError`` naming the
compiler's output. The numpy versions stay as the plain references
(``*_plain``), which the tests hold the library to; nothing on the server
path calls them.

API surface (all take/return numpy arrays):
  scatter_add(idx, vals, n_out)  -> [n_out, D] int32 row sums
  fit_check(used, total)         -> (fit bool[N], exhausted_dim int32[N])
  bincount(idx, n_out)           -> int32[n_out]
  available()                    -> bool (the library builds and loads)

``CALLS`` counts the calls of each function that reached the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "nomad_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

CALLS: Dict[str, int] = {"scatter_add": 0, "fit_check": 0, "bincount": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _compiler() -> str:
    name = os.environ.get("CXX") or "c++"
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"host C++ compiler {name!r} not found: the native "
            "control-plane library cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnomad_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = _compiler()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, timeout=300,
        )
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} timed out building {SOURCE.name}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed to build {SOURCE.name} (rc {proc.returncode}):\n"
            f"{proc.stderr}")
    os.replace(tmp, out)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        lib.nt_scatter_add_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        lib.nt_fit_check_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.nt_bincount_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        for fn in (lib.nt_scatter_add_i32, lib.nt_fit_check_i32,
                   lib.nt_bincount_i32):
            fn.restype = None
        _lib = lib
        return _lib


def _library(name: str) -> ctypes.CDLL:
    """The loaded library, counting one call of ``name`` in CALLS."""
    lib = _load()
    with _lock:
        CALLS[name] += 1
    return lib


def available() -> bool:
    """Whether the library builds and loads here (the functions below
    raise the reason where it does not)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def scatter_add(idx: np.ndarray, vals: np.ndarray, n_out: int) -> np.ndarray:
    """Row-sum ``vals`` grouped by ``idx`` into an [n_out, D] matrix."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.int32)
    n, d = vals.shape
    if idx.shape != (n,):
        raise ValueError(f"idx has shape {idx.shape}, want ({n},)")
    out = np.zeros((n_out, d), dtype=np.int32)
    if n:
        lib = _library("scatter_add")
        lib.nt_scatter_add_i32(
            _i32p(idx), _i32p(vals), n, d, _i32p(out), n_out
        )
    return out


def scatter_add_plain(idx: np.ndarray, vals: np.ndarray,
                      n_out: int) -> np.ndarray:
    """numpy ``scatter_add``: bincount per dimension."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.int32)
    out = np.zeros((n_out, vals.shape[1]), dtype=np.int32)
    for j in range(vals.shape[1]):
        out[:, j] = np.bincount(idx, weights=vals[:, j], minlength=n_out)[
            :n_out
        ].astype(np.int32)
    return out


def fit_check(used: np.ndarray,
              total: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row superset check (funcs.go:56-71): (fit, first exhausted dim,
    -1 where the row fits). Both inputs are cast to int32 first."""
    used = np.ascontiguousarray(used, dtype=np.int32)
    total = np.ascontiguousarray(total, dtype=np.int32)
    n, d = used.shape
    if total.shape != used.shape:
        raise ValueError(f"total has shape {total.shape}, used {used.shape}")
    fit = np.empty(n, dtype=np.uint8)
    exhausted = np.empty(n, dtype=np.int32)
    if n:
        lib = _library("fit_check")
        lib.nt_fit_check_i32(
            _i32p(used), _i32p(total), n, d, _u8p(fit), _i32p(exhausted)
        )
    return fit.astype(bool), exhausted


def fit_check_plain(used: np.ndarray,
                    total: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """numpy ``fit_check``."""
    used = np.ascontiguousarray(used, dtype=np.int32)
    total = np.ascontiguousarray(total, dtype=np.int32)
    over = used > total
    fit = ~over.any(axis=1)
    exhausted = np.where(fit, -1, over.argmax(axis=1)).astype(np.int32)
    return fit, exhausted


def bincount(idx: np.ndarray, n_out: int) -> np.ndarray:
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    out = np.zeros(n_out, dtype=np.int32)
    if idx.size:
        lib = _library("bincount")
        lib.nt_bincount_i32(_i32p(idx), idx.size, _i32p(out), n_out)
    return out


def bincount_plain(idx: np.ndarray, n_out: int) -> np.ndarray:
    """numpy ``bincount``."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    return np.bincount(idx, minlength=n_out)[:n_out].astype(np.int32)
