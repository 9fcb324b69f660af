"""Device-mesh parallelism for the placement solver (port of
nomad_tpu.parallel).

The scale axis of the reference is cluster size: nodes x task groups.
Here that axis becomes tensor shape, split over a grid of torch devices:

- the **node axis** splits into contiguous shards, each its own tensor on
  its device (``mesh.py``); a solve runs one pass per shard and combines
  the shards' small partials between passes;
- the **eval-batch axis** splits coalesced evaluations over the mesh's
  eval rows;
- across processes (``dcn.py``), each rank holds one node shard and the
  partials combine through ``torch.distributed.all_reduce``.

nomad_tpu leaves the collectives to XLA's SPMD partitioner; here the one
place they happen is the reduction between a solve's passes.
"""
