"""The benchmark of nomad_tpu_torch, the PyTorch and CUDA port.

``python3 -m nomadbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one thing sits in files of its own,
found by name: a configuration in ``configs/<config>.json``, a traffic mix
in ``traffic/<mix>.json`` (which names a driver kind,
``drivers/<kind>.py``), a metric in ``metrics/<metric>.py``. The plain
reference that decides ``correct`` is ``reference/``; the yardstick for
the kernels' rooflines is ``yardstick.py``. Nothing here imports ``jax``
or the JAX package.
"""
