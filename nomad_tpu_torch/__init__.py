"""nomad_tpu_torch: the PyTorch/CUDA port of nomad_tpu.

Same layout and names as the JAX package (``structs``, ``state/``,
``scheduler/``, ``ops/``, ``tpu/mirror.py``, ``tpu/solver.py``), with the
device programs written against torch tensors and the Pallas water-fill
plus the exact greedy scan as hand-written CUDA kernels (``csrc/``).
Imports torch, never jax, and nothing of ``nomad_tpu``.
"""

__version__ = "0.1.0"

