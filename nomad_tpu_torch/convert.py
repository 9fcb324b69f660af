"""Carry state across from nomad_tpu to the port.

Both packages model the same cluster; these helpers let one cluster be
solved by both. They take plain Python and numpy values — the dict form of
nomad_tpu's ``api.codec.to_dict`` and arrays read with ``np.asarray`` — so
this module imports neither jax nor nomad_tpu.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from nomad_tpu_torch import structs
from nomad_tpu_torch.api.codec import from_dict
from nomad_tpu_torch.device import resolve_device


def structs_from_reference(obj_dict: Mapping, cls: Union[type, str]):
    """A port struct (Node, Job, Allocation, ...) of class ``cls`` — a class
    of ``nomad_tpu_torch.structs`` or its name — built from the dict that
    nomad_tpu's ``api.codec.to_dict`` gives for the same object."""
    if isinstance(cls, str):
        cls = getattr(structs, cls)
    return from_dict(cls, dict(obj_dict))


# The solve inputs of one task group: a NodeMirror's node tensors plus a
# _SolveInputs' per-eval tensors, under their attribute names in both
# packages, with the dtype the port's kernels take.
SOLVE_INPUT_DTYPES: Dict[str, torch.dtype] = {
    "total": torch.int32,
    "sched_cap": torch.float32,
    "bw_avail": torch.int32,
    "used": torch.int32,
    "job_count": torch.int32,
    "tg_count": torch.int32,
    "bw_used": torch.int32,
    "mask": torch.bool,
    "ask": torch.int32,
    "bw_ask": torch.int32,
}


def solve_inputs_from_numpy(arrays: Mapping[str, np.ndarray],
                            device=None) -> Dict[str, torch.Tensor]:
    """Tensors on ``device`` (default: the CUDA card) for the solve-input
    arrays given by name (any subset of ``SOLVE_INPUT_DTYPES``), each cast
    to the dtype the port's kernels take."""
    dev = resolve_device(device)
    out = {}
    for name, arr in arrays.items():
        dtype = SOLVE_INPUT_DTYPES.get(name)
        if dtype is None:
            raise KeyError(f"unknown solve input {name!r}")
        out[name] = torch.tensor(np.asarray(arr), dtype=dtype, device=dev)
    return out
