"""Device selection for the port's entry points.

Every entry point takes ``device``; the default is the CUDA card. Asking
for CUDA where there is none raises: the port never falls back to the CPU
on its own. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path explicitly"
        )
    return dev
