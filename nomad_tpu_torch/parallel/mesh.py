"""Mesh construction, node-sharded tensors and the sharded batched solve
(port of nomad_tpu/parallel/mesh.py).

The batched eval solve is the device analog of Nomad's optimistic
concurrency (plan verification still serializes at plan-apply): B
coalesced evaluations solve independently against the same state
snapshot, while the node axis is split over the mesh's devices.

nomad_tpu places ``jax.Array``s with ``NamedSharding``s and lets XLA's
SPMD partitioner insert the collectives. Here a node-sharded tensor is a
``ShardedTensor``: shard ``i`` is its own tensor on mesh device ``i``,
holding the contiguous rows ``[i N/S, (i+1) N/S)``. A water-fill whose
shards all lie on one card is one launch (``ops/waterfill.py``
``shard_route``); across cards each card's shards run one launch a pass
and ``MeshReduce`` combines the cards' small partials between passes:
copy them to the first card, sum or max them there. The exact scan runs
each shard's scan and one merge (``ops/greedy.py``).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.ops.greedy import solve_greedy_sharded
from nomad_tpu_torch.ops.waterfill import solve_waterfill_sharded

EVAL_AXIS = "evals"
NODE_AXIS = "nodes"

# The host's stand-in for a device count: nomad_tpu's tests run on 8
# virtual CPU devices (tests/conftest.py); the port's CPU device list has
# as many entries of the one CPU.
CPU_DEVICES = 8

logger = logging.getLogger("nomad_tpu_torch.parallel")


def local_devices(device_type: Optional[str] = None) -> List[torch.device]:
    """The local device list: every card ``torch.cuda`` sees (the default,
    ``None`` or ``"cuda"``; raises where there is no card, as
    ``device.resolve_device`` does), or, for ``device_type="cpu"``,
    ``CPU_DEVICES`` entries of ``cpu``."""
    device_type = resolve_device(device_type).type
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")] * CPU_DEVICES
    raise ValueError(f"unsupported device type {device_type!r}")


class Mesh:
    """A 2D (evals x nodes) grid of torch devices. ``shape`` maps each
    axis name to its extent, as ``jax.sharding.Mesh.shape`` does."""

    __slots__ = ("devices", "shape", "device_type")

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.devices = [[torch.device(d) for d in row] for row in grid]
        self.shape = {EVAL_AXIS: len(self.devices),
                      NODE_AXIS: len(self.devices[0])}
        types = {d.type for row in self.devices for d in row}
        if len(types) != 1:
            raise ValueError(f"a mesh spans one device type, got {types}")
        self.device_type = types.pop()

    @property
    def node_devices(self) -> List[torch.device]:
        """The devices of the first eval row: where born-sharded node
        tensors live."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def make_mesh(n_devices: Optional[int] = None, eval_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a 2D (evals, nodes) mesh over the local devices, or over
    ``devices``. An explicit list may repeat a device: it plays the part
    that XLA's virtual device count plays for nomad_tpu, so the tests
    shard over 8 entries of ``cpu`` and a one-card run over
    ``[cuda:0] * S`` (each shard still its own tensor)."""
    devs = list(devices) if devices is not None else local_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0 or n % eval_parallel != 0:
        raise ValueError(
            f"{n} devices not divisible by eval_parallel={eval_parallel}")
    per = n // eval_parallel
    return Mesh([devs[e * per:(e + 1) * per] for e in range(eval_parallel)])


class ShardedTensor:
    """One logical tensor split along ``axis`` (the node axis: 0 for
    ``[N, ...]`` mirror tensors, 1 for eval-stacked ``[B, N, ...]``) into
    contiguous shards, shard ``i`` its own tensor on
    ``mesh.node_devices[i]``. Readers that need the whole tensor call
    ``cpu()``, which concatenates on the host."""

    __slots__ = ("shards", "axis", "mesh")

    def __init__(self, shards: Sequence[torch.Tensor], axis: int,
                 mesh: Mesh):
        self.shards = list(shards)
        self.axis = axis
        self.mesh = mesh

    @property
    def shape(self) -> torch.Size:
        shape = list(self.shards[0].shape)
        shape[self.axis] = sum(s.shape[self.axis] for s in self.shards)
        return torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def is_cuda(self) -> bool:
        return self.shards[0].is_cuda

    def numel(self) -> int:
        return sum(s.numel() for s in self.shards)

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def cpu(self) -> torch.Tensor:
        return torch.cat([s.cpu() for s in self.shards], dim=self.axis)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, shards={len(self.shards)})")


class Replicated:
    """A small tensor (an ask, a count, a penalty) with one copy on each
    distinct device of a mesh."""

    __slots__ = ("copies", "mesh")

    def __init__(self, x, mesh: Mesh):
        self.mesh = mesh
        self.copies: Dict[torch.device, torch.Tensor] = {}
        for row in mesh.devices:
            for d in row:
                if d not in self.copies:
                    self.copies[d] = torch.as_tensor(x).to(d)

    def on(self, device: torch.device) -> torch.Tensor:
        return self.copies[torch.device(device)]


# ---------------------------------------------------------------------------
# Production node-axis sharding.
#
# When a mesh is configured (explicitly or via NOMAD_TPU_NODE_SHARDS), the
# node-axis tensors of every production solve -- the mirror tensors and
# the per-eval usage and masks -- are born as ShardedTensors, and the
# coalescer dispatches the sharded water-fill and exact scan over them.

_mesh_lock = threading.Lock()
_configured_mesh: Optional[Mesh] = None
_env_checked = False

# Sharding-path observability, the same three counters as nomad_tpu's:
# node_puts: tensors placed sharded at birth; node_reshards: node-axis
# tensors that arrived at dispatch not sharded on the mesh and were split
# there (should stay 0 on the warm path); replications: small per-eval
# tensors copied to every device (bounded per dispatch).
STATS = {"node_puts": 0, "node_reshards": 0, "replications": 0}


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0


def configure_node_sharding(n_devices: Optional[int] = None,
                            eval_parallel: int = 1,
                            devices: Optional[Sequence] = None) -> Mesh:
    """Shard all subsequent production solves over a device mesh. The node
    axis extent must be a power of two (node tensors are padded to
    power-of-two buckets, ops/binpack.py bucket())."""
    global _configured_mesh
    mesh = make_mesh(n_devices, eval_parallel=eval_parallel, devices=devices)
    node_extent = mesh.shape[NODE_AXIS]
    if node_extent & (node_extent - 1):
        raise ValueError(
            f"node axis extent {node_extent} is not a power of two; node "
            "tensors are padded to power-of-two buckets and must divide"
        )
    with _mesh_lock:
        _configured_mesh = mesh
    return mesh


def clear_node_sharding() -> None:
    global _configured_mesh
    with _mesh_lock:
        _configured_mesh = None


def node_sharding_mesh() -> Optional[Mesh]:
    """The configured solve mesh, or None (single-device dispatch).

    First call honors NOMAD_TPU_NODE_SHARDS=<k>: shard over the first k
    local devices (k a power of two)."""
    global _env_checked
    with _mesh_lock:
        if _configured_mesh is not None:
            return _configured_mesh
        if _env_checked:
            return None
        _env_checked = True
    k = int(os.environ.get("NOMAD_TPU_NODE_SHARDS", "0") or 0)
    if k > 1:
        try:
            return configure_node_sharding(k)
        except ValueError as e:
            logger.warning(
                "NOMAD_TPU_NODE_SHARDS=%d not usable (%s); solves stay "
                "single-device", k, e,
            )
    return None


def mesh_for_nodes(n: int, device=None) -> Optional[Mesh]:
    """The configured mesh if the padded node-axis length ``n`` divides
    evenly over it (and, where ``device`` is given, the mesh is of that
    device's type), else None (single-device dispatch). Small clusters on
    big meshes -- a padded bucket shorter than the node-axis extent --
    stay single-device rather than crash every solve."""
    mesh = node_sharding_mesh()
    if mesh is None or n % mesh.shape[NODE_AXIS] != 0:
        return None
    if device is not None and torch.device(device).type != mesh.device_type:
        return None
    return mesh


def _split(mesh: Mesh, x: torch.Tensor, axis: int) -> ShardedTensor:
    """Cut ``x`` into the mesh's node shards, each copied into a tensor of
    its own on its device."""
    s = mesh.shape[NODE_AXIS]
    parts = torch.chunk(x, s, dim=axis)
    return ShardedTensor(
        [p.to(d, copy=True).contiguous()
         for p, d in zip(parts, mesh.node_devices)], axis, mesh)


def whole(x) -> torch.Tensor:
    """``x`` as one tensor: a ShardedTensor's shards concatenated on its
    first shard's device (a mirror born sharded, read by a single-device
    solve after the mesh was cleared), any other tensor as it is."""
    if not isinstance(x, ShardedTensor):
        return x
    home = x.device
    return torch.cat([s.to(home) for s in x.shards], dim=x.axis)


def put_node_sharded(x, device) -> "torch.Tensor | ShardedTensor":
    """Place one node-axis array (``[N, ...]``, numpy or tensor) on the
    configured mesh, or, when no mesh is configured (or it does not divide
    the padded length), as one tensor on ``device``. Always a copy:
    mirror-owned numpy buffers must never alias a tensor. The mirror uses
    this so node tensors are born sharded and dispatches pay no reshard."""
    t = torch.as_tensor(x)
    mesh = mesh_for_nodes(t.shape[0], device)
    if mesh is None:
        return t.to(device, copy=True)
    STATS["node_puts"] += 1
    return _split(mesh, t, 0)


def _on_mesh(mesh: Mesh, x, axis: int) -> ShardedTensor:
    """``x`` as a ShardedTensor of ``mesh`` along ``axis``: as it is when
    it already is one, else split here (a reshard, counted)."""
    if (isinstance(x, ShardedTensor) and x.mesh is mesh
            and x.axis == axis):
        return x
    STATS["node_reshards"] += 1
    if isinstance(x, ShardedTensor):
        x = x.cpu()
    return _split(mesh, x, axis)


def replicate_on_mesh(mesh: Mesh, *xs) -> tuple:
    """Replicate small tensors (asks, penalties, active masks, counts)
    across the mesh so they can join sharded node tensors in one solve."""
    out = []
    for x in xs:
        if isinstance(x, Replicated) and x.mesh is mesh:
            out.append(x)
        else:
            STATS["replications"] += 1
            out.append(Replicated(x, mesh))
    return tuple(out)


def shard_waterfill_args(mesh: Mesh, args10) -> tuple:
    """The 10 water-fill tensor args of one eval (solve_waterfill's
    positional order: total, sched_cap, used0, job_count0, tg_count0,
    bw_avail, bw_used0, eligible, ask, bw_ask) on the mesh: the 8
    node-axis args as ShardedTensors, ask and bw_ask replicated.

    Mirror tensors and per-eval usage are born sharded (put_node_sharded),
    so the node-axis args pass as they are; anything arriving otherwise is
    counted in STATS["node_reshards"] -- the guardrail tests hold that at
    zero on the warm path."""
    nodes = tuple(_on_mesh(mesh, x, 0) for x in args10[:8])
    return nodes + replicate_on_mesh(mesh, *args10[8:10])


def stack_sharded(mesh: Mesh, xs) -> ShardedTensor:
    """Stack B node-sharded ``[N, ...]`` tensors on a new eval axis, shard
    by shard: a ``[B, N, ...]`` ShardedTensor along axis 1, with no
    movement between shards."""
    xs = [_on_mesh(mesh, x, 0) for x in xs]
    if len(xs) == 1:
        return ShardedTensor([s.unsqueeze(0) for s in xs[0].shards], 1, mesh)
    return ShardedTensor(
        [torch.stack(col) for col in zip(*(x.shards for x in xs))], 1, mesh)


def shard_waterfill_batch_args(mesh: Mesh, stacked10, counts, penalties):
    """Batched (eval-stacked) variant: the 8 ``[B, N, ...]`` node-axis args
    sharded along axis 1, the ``[B, 4]`` asks and the ``[B]`` bandwidth
    asks, counts and penalties replicated. The eval axis splits over the
    mesh's eval rows at solve time when B divides by their count
    (solve_waterfill_on_mesh)."""
    placed = tuple(_on_mesh(mesh, x, 1) for x in stacked10[:8])
    small = replicate_on_mesh(mesh, *stacked10[8:10], counts, penalties)
    return placed + small[:2], small[2], small[3]


def shard_greedy_batch_args(mesh: Mesh, shared3, stacked7, active, penalties):
    """Batched EXACT-scan variant: the shared node tensors (total,
    sched_cap, bw_avail: ``[N, ...]``) sharded along axis 0, the per-eval
    node tensors (used0, job_count0, tg_count0, bw_used0, eligible:
    ``[B, N, ...]``) along axis 1, and the ``[B, 4]`` asks, ``[B]``
    bandwidth asks, ``[B, k]`` active masks and ``[B]`` penalties
    replicated."""
    shared = tuple(_on_mesh(mesh, x, 0) for x in shared3)
    per_eval = tuple(_on_mesh(mesh, x, 1) for x in stacked7[:5])
    small = replicate_on_mesh(mesh, *stacked7[5:7], active, penalties)
    return shared, per_eval + small[:2], small[2], small[3]


def restage_rows(t, rows: np.ndarray, vals: np.ndarray):
    """A copy of ``t`` ([N, ...]) with ``rows`` replaced by ``vals``
    (nomad_tpu's ``node_sharded_jit`` of the mirror's ``.at[rows].set``).
    A ShardedTensor is restaged shard by shard: each row goes to its owning
    shard, a shard with no dirty row is shared as it is, and the node axis
    is never gathered. The input is left unchanged either way: evals still
    scheduled against the ancestor mirror read the old rows."""
    if not isinstance(t, ShardedTensor):
        out = t.clone()
        out.index_copy_(0, torch.as_tensor(rows, dtype=torch.int64,
                                            device=t.device),
                        torch.as_tensor(vals).to(t.device))
        return out
    n_s = t.shards[0].shape[0]
    owner = rows // n_s
    shards = list(t.shards)
    for i in np.unique(owner):
        sel = owner == i
        shard = shards[i].clone()
        shard.index_copy_(
            0, torch.as_tensor(rows[sel] - i * n_s, dtype=torch.int64,
                               device=shard.device),
            torch.as_tensor(vals[sel]).to(shard.device))
        shards[i] = shard
    return ShardedTensor(shards, 0, t.mesh)


class MeshReduce:
    """The reduction seam between the passes of a solve whose shards live
    in this process: each device group's partial (one a group, its
    shards' already combined on its device) is copied to the first
    group's device, summed or maxed there, and the result handed back to
    each group's device (no copy where it shares the first's device)."""

    def __call__(self, parts: List[torch.Tensor],
                 op: str) -> List[torch.Tensor]:
        if len(parts) == 1:
            return parts
        home = parts[0].device
        stacked = torch.stack([p.to(home) for p in parts])
        comb = stacked.sum(0) if op == "sum" else stacked.amax(0)
        return [comb if p.device == home else comb.to(p.device)
                for p in parts]


def _row_slices(mesh: Mesh, b: int):
    """(eval row, slice of the B evals) for each eval row of the mesh that
    takes part: all of them when B divides over the eval extent, else the
    first alone."""
    e = mesh.shape[EVAL_AXIS]
    if e == 1 or b % e != 0:
        return [(0, slice(0, b))]
    per = b // e
    return [(r, slice(r * per, (r + 1) * per)) for r in range(e)]


def _part(x: ShardedTensor, i: int, rows: slice, dev) -> torch.Tensor:
    return x.shards[i][rows].to(dev)


def solve_waterfill_on_mesh(mesh: Mesh, stacked10, counts, penalties,
                            max_count: int, job_distinct: bool,
                            tg_distinct: bool):
    """The batched water-fill over node shards (args from
    shard_waterfill_batch_args). Each eval row of the mesh solves its
    slice of the evals over its S shards; ``max_count`` is the largest
    count of the batch (it bounds the level rounds). Returns (counts
    [B, N] int32, remaining [B] int32) on the mesh's first device."""
    from nomad_tpu_torch.ops.waterfill import solve_waterfill_sharded

    b = stacked10[0].shape[0]
    home = mesh.devices[0][0]
    out_counts, out_rem = [], []
    for r, rows in _row_slices(mesh, b):
        shards, small = [], []
        for i, dev in enumerate(mesh.devices[r]):
            shards.append(tuple(_part(x, i, rows, dev)
                                for x in stacked10[:8]))
            small.append(tuple(x.on(dev)[rows]
                               for x in (*stacked10[8:10], counts,
                                         penalties)))
        parts, remaining = solve_waterfill_sharded(
            shards, small, max_count, job_distinct, tg_distinct,
            MeshReduce())
        out_counts.append(torch.cat([p.to(home) for p in parts], dim=1))
        out_rem.append(remaining.to(home))
    return torch.cat(out_counts), torch.cat(out_rem)


def solve_greedy_on_mesh(mesh: Mesh, shared3, per_eval7, active, penalties,
                         k: int, job_distinct: bool, tg_distinct: bool):
    """The batched exact scan over node shards (args from
    shard_greedy_batch_args): each shard scans its rows for all k steps,
    the [S, B, k] sequences gather on the row's first device and one merge
    picks the global order there. Returns (idx, ok, score), each [B, k],
    on the mesh's first device."""
    b = per_eval7[0].shape[0]
    home = mesh.devices[0][0]
    outs = []
    for r, rows in _row_slices(mesh, b):
        shards = []
        for i, dev in enumerate(mesh.devices[r]):
            shared = tuple(x.shards[i].to(dev) for x in shared3)
            per = tuple(_part(x, i, rows, dev) for x in per_eval7[:5])
            small = tuple(x.on(dev)[rows] for x in (*per_eval7[5:7],
                                                    penalties))
            shards.append((shared, per, small))
        out = solve_greedy_sharded(
            shards, active.on(mesh.devices[r][0])[rows], k, job_distinct,
            tg_distinct)
        outs.append([t.to(home) for t in out])
    return tuple(torch.cat(col) for col in zip(*outs))


# ---------------------------------------------------------------------------
# The server-config face of the mesh: `server { solver_mesh { } }`.


class SolverMeshConfig:
    """Parsed ``server { solver_mesh { } }`` block: how many devices the
    node axis of every production solve shards over, and the eval-axis
    extent of the 2D mesh. Parse-time validated like admission/express --
    a typo'd knob fails config load, not leader-establish. The default
    (node_shards 0) keeps solves single-device; a mesh the local device
    set can't satisfy falls back at apply time to single-device solves on
    the same device (scale-down of the same binary onto a smaller box
    must not crash the server)."""

    __slots__ = ("node_shards", "eval_parallel")

    _KEYS = ("node_shards", "eval_parallel")

    def __init__(self, node_shards: int = 0, eval_parallel: int = 1):
        self.node_shards = node_shards
        self.eval_parallel = eval_parallel

    @property
    def enabled(self) -> bool:
        return self.node_shards > 1 or self.eval_parallel > 1

    @classmethod
    def parse(cls, data) -> "SolverMeshConfig":
        if data is None:
            return cls()
        if not isinstance(data, dict):
            raise ValueError("server.solver_mesh must be a mapping")
        unknown = sorted(set(data) - set(cls._KEYS))
        if unknown:
            raise ValueError(
                f"unknown server.solver_mesh key(s) {unknown} "
                f"(have: {list(cls._KEYS)})"
            )
        out = {}
        for key, lo, hi in (("node_shards", 0, 4096),
                            ("eval_parallel", 1, 64)):
            v = data.get(key)
            if v is None:
                continue
            if (not isinstance(v, int) or isinstance(v, bool)
                    or not lo <= v <= hi):
                raise ValueError(
                    f"server.solver_mesh.{key} must be an integer in "
                    f"[{lo}, {hi}], got {v!r}"
                )
            if v > 1 and v & (v - 1):
                # Node tensors pad to power-of-two buckets; a non-power-
                # of-two extent could never divide them evenly.
                raise ValueError(
                    f"server.solver_mesh.{key} must be a power of two, "
                    f"got {v}"
                )
            out[key] = v
        return cls(out.get("node_shards", 0), out.get("eval_parallel", 1))

    def as_dict(self) -> dict:
        return {"node_shards": self.node_shards,
                "eval_parallel": self.eval_parallel}


def apply_solver_mesh(cfg: SolverMeshConfig, log=None,
                      device=None) -> Optional[Mesh]:
    """Configure the process solve mesh from a parsed solver_mesh block,
    over the local devices of ``device``'s type (the CUDA cards by
    default). When the local device set can't satisfy the requested
    extents (a one-card box running a mesh-configured config), this logs
    a warning, returns None and solves stay single-device on the same
    device -- the knob describes a capability, not a hard requirement."""
    log = log or logger
    if not cfg.enabled:
        return None
    needed = max(cfg.node_shards, 1) * cfg.eval_parallel
    dev_type = None if device is None else torch.device(device).type
    devices = local_devices(dev_type)
    n_local = len(devices)
    if n_local < needed:
        log.warning(
            "solver_mesh wants %d device(s) (node_shards=%d x "
            "eval_parallel=%d) but only %d present; solves stay "
            "single-device", needed, cfg.node_shards, cfg.eval_parallel,
            n_local,
        )
        return None
    try:
        mesh = configure_node_sharding(
            needed, eval_parallel=cfg.eval_parallel, devices=devices
        )
    except ValueError as e:
        log.warning("solver_mesh not usable (%s); solves stay "
                    "single-device", e)
        return None
    log.info("solver mesh configured: %s", dict(mesh.shape))
    return mesh


# ---------------------------------------------------------------------------
# The batched greedy solve over a mesh (the multichip dry run's program).
# nomad_tpu's _batched_solve (a vmap of solve_greedy under shardings) has
# no separate counterpart: solve_batch_on_mesh calls solve_greedy_on_mesh,
# the sharded scan the coalescer's mesh arm runs.


_BATCH_SHARED = ("total", "sched_cap", "bw_avail")
_BATCH_PER_EVAL = ("used0", "job_count0", "tg_count0", "bw_used0",
                   "eligible", "ask", "bw_ask")


def shard_batched_inputs(mesh: Mesh, batch: dict) -> dict:
    """Place batched-solve inputs on the mesh: node tensors ([N, D]) and
    per-eval tensors ([B, N(, D)]) sharded along the node axis, the small
    per-eval tensors (ask, bw_ask, active, penalty) replicated."""
    shared, per_eval, active, penalty = shard_greedy_batch_args(
        mesh, [batch[k] for k in _BATCH_SHARED],
        [batch[k] for k in _BATCH_PER_EVAL], batch["active"],
        batch["penalty"])
    out = dict(zip(_BATCH_SHARED, shared))
    out.update(zip(_BATCH_PER_EVAL, per_eval))
    out["active"] = active
    out["penalty"] = penalty
    return out


def solve_batch_on_mesh(mesh: Mesh, batch: dict, k: int,
                        job_distinct: bool = False,
                        tg_distinct: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the batched greedy solve with the node axis sharded over the
    mesh. ``batch`` keys match shard_batched_inputs. Returns (idxs[B,k],
    oks[B,k], scores[B,k])."""
    placed = shard_batched_inputs(mesh, batch)
    return solve_greedy_on_mesh(
        mesh, [placed[k_] for k_ in _BATCH_SHARED],
        [placed[k_] for k_ in _BATCH_PER_EVAL], placed["active"],
        placed["penalty"], k, job_distinct, tg_distinct)


def make_tiny_batch(n_nodes: int, n_evals: int, k: int,
                    device=None) -> dict:
    """Tiny well-formed inputs for compile checks and the multichip dry
    run, on ``device`` (the CUDA card by default)."""
    total = np.zeros((n_nodes, 4), dtype=np.int32)
    total[:, 0] = 4000
    total[:, 1] = 8192
    total[:, 2] = 100 * 1024
    total[:, 3] = 150
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "total": torch.tensor(total, device=dev),
        "sched_cap": torch.tensor(total[:, :2].astype(np.float32),
                                  device=dev),
        "bw_avail": torch.full((n_nodes,), 1000, **i32),
        "used0": torch.zeros((n_evals, n_nodes, 4), **i32),
        "job_count0": torch.zeros((n_evals, n_nodes), **i32),
        "tg_count0": torch.zeros((n_evals, n_nodes), **i32),
        "bw_used0": torch.zeros((n_evals, n_nodes), **i32),
        "eligible": torch.ones((n_evals, n_nodes), dtype=torch.bool,
                               device=dev),
        "ask": torch.tensor([[500, 256, 0, 0]] * n_evals, **i32),
        "bw_ask": torch.zeros((n_evals,), **i32),
        "active": torch.ones((n_evals, k), dtype=torch.bool, device=dev),
        "penalty": torch.full((n_evals,), 10.0, dtype=torch.float32,
                              device=dev),
    }
