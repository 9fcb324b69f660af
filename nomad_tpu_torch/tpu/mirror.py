"""Node state mirror: dense tensors for the solver (port of
nomad_tpu/tpu/mirror.py on torch tensors).

The device analog of the reference's per-node iterator inputs: node resources
become an ``[N, 4]`` matrix (RESOURCE_DIMS order), bandwidth a vector, and
feasibility predicates become boolean masks (SURVEY.md §7 "State mirror" /
"Feasibility = boolean mask tensors").

Masks for the common constraint operands are evaluated host-side over the
node table (they are string ops; regex/version stay host-side by design,
reference feasible.go:405-479) and shipped to the device as the ``eligible``
input of the solve. The node axis is padded to power-of-two buckets, the
same ``[padded, D]`` int32 layout as nomad_tpu, so both packages hand the
solve identical shapes. Each mirror lives on one torch device.

``capacity_view`` (the express lane's pick) reads only the host arrays:
the lane's in-line placement never touches the device.

Not ported yet: the byte ledgers (their reader, the runtime observatory,
is a later slice) and mesh sharding (one device).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from nomad_tpu_torch import telemetry
from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.ops.binpack import bucket
from nomad_tpu_torch.scheduler.feasible import (
    _parse_bool,
    check_constraint,
    resolve_constraint_target,
)
from nomad_tpu_torch.structs import NODE_STATUS_READY, Constraint, Node, Resources

# Sentinel distinguishing "target didn't resolve" (fails the node, any
# operand) from a present-but-None value (a real value; '!=' may pass).
_MISSING = object()


def _res_vec(r: Optional[Resources]) -> np.ndarray:
    if r is None:
        return np.zeros(4, dtype=np.int32)
    return np.array(r.as_vector(), dtype=np.int32)


def _task_bw(task_resources: Dict[str, Resources]) -> int:
    total = 0
    for res in task_resources.values():
        if res.networks:
            total += res.networks[0].mbits
    return total


def _node_row_vals(node: Node) -> Tuple[Tuple, Tuple, int, int]:
    """(total4, reserved4, bw_avail, bw_reserved) row values — the exact
    per-row arithmetic of the bulk build in ``NodeMirror.__init__``,
    shared by ``apply_delta`` so a patched row can never drift from a
    freshly built one (the fuzz differential's bit-identity contract)."""
    total = (tuple(node.resources.as_vector())
             if node.resources is not None else (0, 0, 0, 0))
    reserved = (tuple(node.reserved.as_vector())
                if node.reserved is not None else (0, 0, 0, 0))
    bw_avail = 0
    if node.resources is not None and node.resources.networks:
        bw_avail = sum(
            net.mbits for net in node.resources.networks if net.device
        )
    bw_reserved = 0
    if node.reserved is not None and node.reserved.networks:
        bw_reserved = sum(net.mbits for net in node.reserved.networks)
    return total, reserved, bw_avail, bw_reserved


def _put(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` (always a copy: mirror-owned
    numpy buffers must never alias a tensor). nomad_tpu's
    put_node_sharded, without a mesh."""
    return torch.tensor(arr, device=device)


def _restage_rows(t: torch.Tensor, rows: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Row-sliced device restage (nomad_tpu's jitted ``.at[rows].set``):
    a copy of ``t`` with ``rows`` replaced by ``index_copy_``. The ancestor
    mirror keeps its tensor unchanged — evals still scheduled against it
    read the old rows."""
    out = t.clone()
    out.index_copy_(0, rows, vals)
    return out


def _surface_targets(old: Node, new: Node, out: Set[str]) -> None:
    """Constraint-target strings whose cached columns a node rewrite
    invalidates. The target grammar reads only id/name/datacenter/
    attributes/meta (feasible.resolve_constraint_target:209-230), so
    those fields ARE the whole mask surface; a resource-only rewrite
    (the heartbeat/re-registration steady state) adds nothing and every
    mask cache survives the roll."""
    if old.name != new.name:
        out.add("$node.name")
    if old.datacenter != new.datacenter:
        out.add("$node.datacenter")
    if old.attributes != new.attributes:
        for k in set(old.attributes) | set(new.attributes):
            if old.attributes.get(k) != new.attributes.get(k):
                out.add(f"$attr.{k}")
    if old.meta != new.meta:
        for k in set(old.meta) | set(new.meta):
            if old.meta.get(k) != new.meta.get(k):
                out.add(f"$meta.{k}")


class NodeMirror:
    """Dense mirror of a node set, padded to a shape bucket."""

    def __init__(self, nodes: List[Node], device=None):
        self.device = resolve_device(device)
        self.nodes = nodes
        self.n = len(nodes)
        self.padded = bucket(max(self.n, 1))
        self.index = {node.id: i for i, node in enumerate(nodes)}

        # Row building is one bulk conversion, not 2N np.array calls —
        # mirror construction is the cold-path cost of a fresh state
        # generation (a 10k-node build was ~23ms, half of it tiny-array
        # allocation).
        total = np.zeros((self.padded, 4), dtype=np.int32)
        reserved = np.zeros((self.padded, 4), dtype=np.int32)
        bw_avail = np.zeros(self.padded, dtype=np.int32)
        bw_reserved = np.zeros(self.padded, dtype=np.int32)
        if nodes:
            zero4 = (0, 0, 0, 0)

            def row(r):
                return zero4 if r is None else r.as_vector()

            total[: self.n] = np.array(
                [row(n.resources) for n in nodes], dtype=np.int32)
            reserved[: self.n] = np.array(
                [row(n.reserved) for n in nodes], dtype=np.int32)
            for i, node in enumerate(nodes):
                if node.resources is not None and node.resources.networks:
                    # Coarse bandwidth feasibility models the first NIC,
                    # the common shape; exact port assignment is a host
                    # post-pass.
                    bw_avail[i] = sum(
                        net.mbits for net in node.resources.networks
                        if net.device
                    )
                if node.reserved is not None and node.reserved.networks:
                    bw_reserved[i] = sum(
                        net.mbits for net in node.reserved.networks)

        self.total = _put(total, self.device)
        # Host-side copy of the totals, maintained through apply_delta
        # like reserved_np.
        self.totals_np = total
        self.reserved_np = reserved
        sched = (total - reserved)[:, :2].astype(np.float32)
        self.sched_cap = _put(sched, self.device)
        self.bw_avail = _put(bw_avail, self.device)
        self.bw_reserved = bw_reserved
        self.base_mask = np.zeros(self.padded, dtype=bool)
        self.base_mask[: self.n] = True

        self._id_array: Optional[np.ndarray] = None
        self._driver_mask_cache: Dict[frozenset, np.ndarray] = {}
        self._constraint_mask_cache: Dict[Tuple, np.ndarray] = {}
        # target string -> (values, ok) columns for constraint targets,
        # resolved over all nodes once and shared by every constraint
        # (and eval) touching that target.
        self._target_col_cache: Dict[str, Tuple] = {}
        # target string -> (codes int32[n], uniques) factorization of the
        # column above: one python pass per (mirror, target), after which
        # every mask over that target is a per-DISTINCT-value evaluation
        # plus a numpy gather instead of a 10k-iteration python loop.
        self._target_code_cache: Dict[str, Tuple] = {}
        # Device-resident combined eligibility masks and clean-state usage
        # tensors: per-eval uploads are pure tunnel latency on remote
        # devices, so anything reusable across evals of one state
        # generation stays on device.
        self._device_mask_cache: Dict[Tuple, "torch.Tensor"] = {}
        self._clean_usage_dev = None
        # Job-independent base usage (reserved + every existing alloc),
        # cached per (store_uid, allocs index) and rolled forward through
        # the store's alloc change log — per-eval usage is a copy of this
        # plus the plan's in-flight rows, never a cluster walk.
        self._usage_lock = threading.Lock()
        self._base_usage: Optional[Tuple[str, int, np.ndarray, np.ndarray]] = None
        # id(block) -> (block, rows, counts, vec, bw) of a block's live
        # runs resolved against THIS mirror's row index: the base-usage
        # roll folds each block into dirty rows with one scatter instead
        # of a per-row all-blocks scan. Blocks are COW (exclusions
        # replace the object) and the entry pins the ref, so identity
        # keys can never serve stale runs. The dict (and its lock — NOT
        # _usage_lock, which is per-mirror) is shared across delta-rolled
        # mirrors and mutated by concurrent scheduler workers.
        self._block_rows: Dict[int, Tuple] = {}
        self._block_rows_lock = threading.Lock()
        # The express lane's capacity view (capacity_view): base usage
        # rolled IN PLACE through the alloc change log, owned by the view
        # (a 10k-row copy per submission would be the whole sub-ms
        # budget). (uid, allocs index, used, bw), under its own lock (not
        # _usage_lock, which the rebuild fallback takes).
        self._express_usage: Optional[Tuple] = None
        self._express_roll_lock = threading.Lock()

    # -- byte economy ------------------------------------------------------

    def byte_ledger(self) -> dict:
        """Per-buffer byte accounting of this mirror (the runtime
        observatory's mirror ledger): the named device and host buffers
        with dtype and bytes, plus the mask and usage caches summed.
        Reads metadata only (``numel() * element_size()`` for a tensor):
        no device sync, no copy."""
        buffers = {}
        for name in ("total", "totals_np", "reserved_np", "sched_cap",
                     "bw_avail", "bw_reserved", "base_mask"):
            arr = getattr(self, name, None)
            if arr is None:
                continue
            buffers[name] = {"dtype": _dtype_name(arr),
                             "nbytes": _arr_bytes(arr)}
        cache_bytes = 0
        for cache_name in ("_driver_mask_cache", "_constraint_mask_cache",
                           "_target_col_cache", "_target_code_cache",
                           "_device_mask_cache"):
            cache = getattr(self, cache_name, None) or {}
            cache_bytes += sum(_arr_bytes(v) for v in list(cache.values()))
        for extra in ("_clean_usage_dev", "_base_usage", "_express_usage",
                      "_id_array"):
            cache_bytes += _arr_bytes(getattr(self, extra, None))
        buffer_bytes = sum(b["nbytes"] for b in buffers.values())
        return {
            "rows": self.n,
            "padded": self.padded,
            "buffers": buffers,
            "buffer_bytes": buffer_bytes,
            "cache_bytes": cache_bytes,
            "total_bytes": buffer_bytes + cache_bytes,
        }

    # -- delta maintenance -------------------------------------------------

    def apply_delta(self, changes, state, datacenters: List[str]):
        """Roll this mirror forward through node-table ``changes``
        (``(index, node_id, kind)`` from ``state.node_changes_since``).

        Returns ``(mirror, rows_restaged)`` — a new mirror sharing every
        unchanged buffer/cache with this one, with only the dirty rows
        patched host-side and re-staged to device via row-sliced updates
        of the padded sharded buffers — or None when the change set
        forces a full rebuild: a node LEFT the ready set (its row shifts
        every later row), a pre-existing node re-entered it mid-order, or
        appends cross the power-of-two padding bucket. In-place rewrites
        of resident nodes (heartbeat flips, re-registrations, resource
        drift) and tail appends of brand-new nodes stay on the delta
        path; writes to nodes outside this mirror's datacenter/ready set
        are free no-ops."""
        from nomad_tpu_torch.state.store import partition_node_changes

        dc_set = set(datacenters)

        def resolve(node_id):
            # This mirror's set: the ready, non-draining nodes of its
            # datacenters (ready_nodes_in_dcs). Writes outside it are
            # free no-ops for the roll.
            node = state.node_by_id(node_id)
            if (node is None or node.status != NODE_STATUS_READY
                    or node.drain or node.datacenter not in dc_set):
                return None
            return node

        parts = partition_node_changes(changes, self.index.get, resolve)
        if parts is None:
            return None
        patches, appends = parts
        if not patches and not appends:
            return self, 0
        new_n = self.n + len(appends)
        if bucket(max(new_n, 1)) != self.padded:
            return None  # repadding boundary

        nodes = list(self.nodes)
        rows: List[int] = []
        tot_rows: List[Tuple] = []
        res_rows: List[Tuple] = []
        bwa_rows: List[int] = []
        bwr_rows: List[int] = []
        affected: Set[str] = set()
        reserved_changed = False
        for row, node in patches:
            old = nodes[row]
            nodes[row] = node
            o_vals = _node_row_vals(old)
            n_vals = _node_row_vals(node)
            if n_vals != o_vals:
                rows.append(row)
                tot_rows.append(n_vals[0])
                res_rows.append(n_vals[1])
                bwa_rows.append(n_vals[2])
                bwr_rows.append(n_vals[3])
                if n_vals[1] != o_vals[1] or n_vals[3] != o_vals[3]:
                    reserved_changed = True
            _surface_targets(old, node, affected)
        for (_pos, node), row in zip(appends, range(self.n, new_n)):
            nodes.append(node)
            n_vals = _node_row_vals(node)
            rows.append(row)
            tot_rows.append(n_vals[0])
            res_rows.append(n_vals[1])
            bwa_rows.append(n_vals[2])
            bwr_rows.append(n_vals[3])
            if any(n_vals[1]) or n_vals[3]:
                reserved_changed = True

        new = NodeMirror.__new__(NodeMirror)
        new.device = self.device
        new.nodes = nodes
        new.n = new_n
        new.padded = self.padded
        new._usage_lock = threading.Lock()
        # Node writes are the rare axis: the express view rebuilds lazily
        # from the rolled base on its next read.
        new._express_usage = None
        new._express_roll_lock = threading.Lock()
        # Row numbering of resident nodes never moves on the delta path
        # (a departure forces the full rebuild above) and appends are
        # brand-new nodes no existing block can reference: cached block
        # row resolutions stay valid across the roll. The lock travels
        # with the dict — sharing the dict under per-mirror locks would
        # leave concurrent evictions unserialized.
        new._block_rows = self._block_rows
        new._block_rows_lock = self._block_rows_lock
        if appends:
            idx = dict(self.index)
            for (_pos, node), row in zip(appends, range(self.n, new_n)):
                idx[node.id] = row
            new.index = idx
            mask = self.base_mask.copy()
            mask[self.n:new_n] = True
            new.base_mask = mask
            new._id_array = None
        else:
            new.index = self.index
            new.base_mask = self.base_mask
            new._id_array = self._id_array

        if rows:
            rows_arr = np.asarray(rows, dtype=np.int32)
            tot_arr = np.asarray(tot_rows, dtype=np.int32)
            res_arr = np.asarray(res_rows, dtype=np.int32)
            sched_arr = (tot_arr - res_arr)[:, :2].astype(np.float32)
            bwa_arr = np.asarray(bwa_rows, dtype=np.int32)
            bwr_arr = np.asarray(bwr_rows, dtype=np.int32)
            totals_np = self.totals_np.copy()
            totals_np[rows_arr] = tot_arr
            new.totals_np = totals_np
            reserved_np = self.reserved_np.copy()
            reserved_np[rows_arr] = res_arr
            new.reserved_np = reserved_np
            bw_reserved = self.bw_reserved.copy()
            bw_reserved[rows_arr] = bwr_arr
            new.bw_reserved = bw_reserved
            # Row-sliced device update: only the dirty rows travel to the
            # device. nomad_tpu pads the row batch to a bucket for its jit
            # cache; eager index_copy_ has none to keep warm.
            dev = self.device
            rows_dev = torch.tensor(rows_arr.astype(np.int64), device=dev)
            new.total = _restage_rows(self.total, rows_dev,
                                      _put(tot_arr, dev))
            new.sched_cap = _restage_rows(self.sched_cap, rows_dev,
                                          _put(sched_arr, dev))
            new.bw_avail = _restage_rows(self.bw_avail, rows_dev,
                                         _put(bwa_arr, dev))
        else:
            new.totals_np = self.totals_np
            new.reserved_np = self.reserved_np
            new.bw_reserved = self.bw_reserved
            new.total = self.total
            new.sched_cap = self.sched_cap
            new.bw_avail = self.bw_avail

        if appends:
            # Cached masks/columns are length-n views of the old node
            # axis; appends rebuild them lazily.
            new._driver_mask_cache = {}
            new._constraint_mask_cache = {}
            new._target_col_cache = {}
            new._target_code_cache = {}
            new._device_mask_cache = {}
        elif affected:
            # Targeted invalidation: only columns/masks reading a changed
            # target drop; everything else survives the roll.
            def _ctuple_clean(cs) -> bool:
                return not any(
                    c[0] in affected or c[2] in affected for c in cs
                )

            new._target_col_cache = {
                t: v for t, v in self._target_col_cache.items()
                if t not in affected
            }
            new._target_code_cache = {
                t: v for t, v in self._target_code_cache.items()
                if t not in affected
            }
            new._driver_mask_cache = {
                k: v for k, v in self._driver_mask_cache.items()
                if not any(f"$attr.driver.{d}" in affected for d in k)
            }
            new._constraint_mask_cache = {
                k: v for k, v in self._constraint_mask_cache.items()
                if _ctuple_clean(k)
            }
            new._device_mask_cache = {
                k: v for k, v in self._device_mask_cache.items()
                if not any(f"$attr.driver.{d}" in affected for d in k[0])
                and _ctuple_clean(k[1]) and _ctuple_clean(k[2])
            }
        else:
            # Surface untouched: SHARE the cache dicts — both mirrors
            # describe the same mask world and lazy additions are valid
            # for either.
            new._driver_mask_cache = self._driver_mask_cache
            new._constraint_mask_cache = self._constraint_mask_cache
            new._target_col_cache = self._target_col_cache
            new._target_code_cache = self._target_code_cache
            new._device_mask_cache = self._device_mask_cache

        if self._clean_usage_dev is None:
            new._clean_usage_dev = None
        elif reserved_changed:
            used_dev, z1, z2, bw_dev = self._clean_usage_dev
            new._clean_usage_dev = (
                _restage_rows(used_dev, rows_dev, _put(res_arr, dev)), z1, z2,
                _restage_rows(bw_dev, rows_dev, _put(bwr_arr, dev)),
            )
        else:
            new._clean_usage_dev = self._clean_usage_dev

        # Node writes never move the allocs index, so the cached base
        # usage survives modulo the reserved deltas of the patched rows.
        base = self._base_usage
        if base is None or appends:
            new._base_usage = None
        elif reserved_changed:
            uid, aidx, b_used, b_bw = base
            b_used = b_used.copy()
            b_bw = b_bw.copy()
            b_used[rows_arr] += res_arr - self.reserved_np[rows_arr]
            b_bw[rows_arr] += bwr_arr - self.bw_reserved[rows_arr]
            new._base_usage = (uid, aidx, b_used, b_bw)
        else:
            new._base_usage = base
        return new, len(rows)

    def id_array(self) -> np.ndarray:
        """Node ids as a numpy string array (lazy, cached): fancy-indexed
        id extraction for placements beats a python attribute walk."""
        if self._id_array is None:
            self._id_array = np.array([n.id for n in self.nodes])
        return self._id_array

    # -- eligibility masks -------------------------------------------------

    def driver_mask(self, drivers: Set[str]) -> np.ndarray:
        """Vectorized DriverIterator (reference: feasible.go:127-151).

        One factorized attribute column per driver (shared with constraint
        targets via the per-target code cache), bool-parsed once per
        DISTINCT attribute value and broadcast by gather — no per-node
        python loop."""
        key = frozenset(drivers)
        cached = self._driver_mask_cache.get(key)
        if cached is not None:
            return cached
        mask = self.base_mask.copy()
        n = self.n
        for driver in drivers:
            # $attr. targets always factorize to a column (never a scalar
            # literal), so codes is never None here.
            codes, uniques = self._target_codes(f"$attr.driver.{driver}")
            ok = np.fromiter(
                (u is not _MISSING and u is not None and bool(_parse_bool(u))
                 for u in uniques),
                dtype=bool, count=len(uniques),
            )
            mask[:n] &= ok[codes]
        self._driver_mask_cache[key] = mask
        return mask

    def _target_codes(self, target: str) -> Tuple:
        """Factorization of a target column: ``(codes, uniques)`` where
        ``codes`` is an int32[n] index into ``uniques`` (the distinct
        values in first-seen order), or ``(None, literal)`` for scalar
        targets. Built once per (mirror, target); cluster attributes have
        a handful of distinct values, so every downstream mask evaluates
        its predicate len(uniques) times and gathers."""
        cached = self._target_code_cache.get(target)
        if cached is not None:
            return cached
        vals, _ = self._target_column(target)
        if isinstance(vals, str):
            entry = (None, vals)
        else:
            # Two C-speed passes beat a python enumerate loop with
            # per-element numpy stores: dict.fromkeys dedups in first-seen
            # order (run-to-run deterministic), then fromiter maps.
            uniques = list(dict.fromkeys(vals))
            code_map = {v: i for i, v in enumerate(uniques)}
            codes = np.fromiter(
                (code_map[v] for v in vals), dtype=np.int32, count=self.n
            )
            entry = (codes, uniques)
        self._target_code_cache[target] = entry
        return entry

    def _target_column(self, target: str) -> Tuple:
        """Resolve one constraint target over ALL nodes, once.

        Returns ``(values, ok)``: for a literal, ``(str, None)``; for a
        node-derived target, a python list of per-node values (None where
        the target doesn't resolve — the reference's "missing attribute
        fails the node", feasible.go:320-351). Parsing the target string
        happens once here instead of once per node per constraint; the
        column is cached for the mirror's lifetime so repeat constraints
        and repeat evals share it."""
        col = self._target_col_cache.get(target)
        if col is not None:
            return col
        nodes = self.nodes
        if not target.startswith("$"):
            col = (target, None)
        elif target == "$node.id":
            col = ([n.id for n in nodes], None)
        elif target == "$node.datacenter":
            col = ([n.datacenter for n in nodes], None)
        elif target == "$node.name":
            col = ([n.name for n in nodes], None)
        elif target.startswith("$attr."):
            attr = target[len("$attr."):]
            # _MISSING (not None) marks an absent key: a present-but-None
            # value resolves ok and flows to check_constraint, exactly
            # like resolve_constraint_target's (value, True) — negative
            # operands ('!=') must accept such nodes.
            col = ([n.attributes.get(attr, _MISSING) for n in nodes], None)
        elif target.startswith("$meta."):
            meta = target[len("$meta."):]
            col = ([n.meta.get(meta, _MISSING) for n in nodes], None)
        else:
            # Unknown target form: defer to the scalar resolver per node
            # so this column can never silently diverge from the grammar
            # in feasible.resolve_constraint_target — a form added there
            # stays correct here (just unvectorized).
            col = (
                [
                    v if ok else _MISSING
                    for v, ok in (
                        resolve_constraint_target(target, n) for n in nodes
                    )
                ],
                None,
            )
        self._target_col_cache[target] = col
        return col

    def constraint_mask(self, ctx, constraints: List[Constraint]) -> np.ndarray:
        """Vectorized ConstraintIterator (reference: feasible.go:295-317).

        Evaluated host-side over the node table; results are cached per
        constraint tuple for the lifetime of the mirror. Each side of a
        constraint resolves to a cached per-target column, and the
        operand is evaluated once per distinct (l, r) value pair — at
        cluster scale an attribute has a handful of distinct values, so
        the per-node work is a memo-dict hit, not a parse+compare."""
        key = tuple((c.l_target, c.operand, c.r_target) for c in constraints)
        cached = self._constraint_mask_cache.get(key)
        if cached is not None:
            return cached
        mask = self.base_mask.copy()
        n = self.n
        for c in constraints:
            op = c.operand
            l_vals, _ = self._target_column(c.l_target)
            r_vals, _ = self._target_column(c.r_target)
            l_scalar = isinstance(l_vals, str)
            r_scalar = isinstance(r_vals, str)
            if l_scalar and r_scalar:
                if not check_constraint(ctx, op, l_vals, r_vals):
                    mask[:n] = False
                continue
            if l_scalar or r_scalar:
                # Column vs literal — the dominant shape. Evaluate the
                # predicate once per distinct column value and gather.
                col_target = c.r_target if l_scalar else c.l_target
                codes, uniques = self._target_codes(col_target)
                if l_scalar:
                    pred = lambda u: check_constraint(ctx, op, l_vals, u)
                else:
                    pred = lambda u: check_constraint(ctx, op, u, r_vals)
                ok = np.fromiter(
                    (u is not _MISSING and pred(u) for u in uniques),
                    dtype=bool, count=len(uniques),
                )
                mask[:n] &= ok[codes]
                continue
            # Column vs column (rare): per-(l, r) pair memo walk.
            memo: Dict[Tuple, bool] = {}
            for i in range(n):
                if not mask[i]:
                    continue
                l = l_vals[i]
                r = r_vals[i]
                ok = memo.get((l, r))
                if ok is None:
                    ok = (l is not _MISSING and r is not _MISSING
                          and check_constraint(ctx, op, l, r))
                    memo[(l, r)] = ok
                if not ok:
                    mask[i] = False
        self._constraint_mask_cache[key] = mask
        return mask

    def device_mask(self, ctx, drivers: Set[str], job_constraints,
                    tg_constraints) -> Tuple["torch.Tensor", int]:
        """Combined eligibility mask, resident on device, plus the filtered
        node count for AllocMetric. Cached per (drivers, job constraints,
        tg constraints) for the mirror's lifetime — repeat evals against
        one state generation upload nothing. Returns (device_mask,
        n_filtered)."""
        key = (
            frozenset(drivers),
            tuple((c.l_target, c.operand, c.r_target)
                  for c in (job_constraints or ())),
            tuple((c.l_target, c.operand, c.r_target)
                  for c in (tg_constraints or ())),
        )
        cached = self._device_mask_cache.get(key)
        if cached is not None:
            return cached
        mask = self.driver_mask(drivers)
        if job_constraints:
            mask = mask & self.constraint_mask(ctx, job_constraints)
        if tg_constraints:
            mask = mask & self.constraint_mask(ctx, tg_constraints)
        entry = (_put(mask, self.device),
                 int(self.n - mask[: self.n].sum()))
        self._device_mask_cache[key] = entry
        return entry

    # -- utilization tensors ----------------------------------------------

    def clean_usage(self):
        """Device-resident (used, job_count, tg_count, bw_used) for a state
        with no allocations and a plan with no placements yet — just the
        reserved base. The fresh-registration fast path."""
        if self._clean_usage_dev is None:
            dev = self.device
            zeros = torch.zeros(self.padded, dtype=torch.int32, device=dev)
            self._clean_usage_dev = (
                _put(self.reserved_np, dev), zeros, zeros,
                _put(self.bw_reserved, dev),
            )
        return self._clean_usage_dev

    def build_usage(self, ctx, job_id: str, tg_name: str):
        """Build (used, job_count, tg_count, bw_used) from the eval context's
        optimistic proposed-alloc view (reference: context.go:103-126 feeding
        rank.go:170-221).

        Delta-maintained: the job-independent base (reserved + every
        existing allocation, object rows and columnar blocks alike) is
        cached per mirror and rolled forward through the store's alloc
        change log; each eval then copies the base and touches ONLY the
        plan's in-flight rows plus the job's own allocations — never the
        whole cluster. States without the split columnar/change-log
        surface take the original full walk (``_build_usage_walk``)."""
        plan = ctx.plan
        state = ctx.state
        if (state.alloc_count() == 0 and not plan.alloc_batches
                and not plan.node_allocation and not plan.node_update):
            return self.clean_usage()
        if not (hasattr(state, "allocs_objects")
                and hasattr(state, "alloc_blocks")
                and hasattr(state, "allocs_by_job_objects")
                and hasattr(state, "alloc_object_by_id")
                and hasattr(state, "job_alloc_blocks")):
            return self._build_usage_walk(ctx, job_id, tg_name)
        base_used, base_bw = self._base_usage_for(state)
        used = base_used.copy()
        bw_used = base_bw.copy()
        job_count = np.zeros(self.padded, dtype=np.int32)
        tg_count = np.zeros(self.padded, dtype=np.int32)
        index_get = self.index.get
        # Job/tg occupancy from the job's OWN allocations (by-job
        # indexes: O(job size), not O(cluster)).
        for a in state.allocs_by_job_objects(job_id):
            if a.terminal_status():
                continue
            i = index_get(a.node_id)
            if i is None:
                continue
            job_count[i] += 1
            if a.task_group == tg_name:
                tg_count[i] += 1
        for blk in state.job_alloc_blocks(job_id):
            tg_match = blk.tg_name == tg_name
            for nid, cnt in blk.live_node_counts():
                i = index_get(nid)
                if i is None:
                    continue
                job_count[i] += cnt
                if tg_match:
                    tg_count[i] += cnt
        # Plan deltas: only the in-flight rows. Members this plan evicts
        # were counted in the base, so subtract them; stale eviction ids
        # (member already gone) subtract nothing.
        blocks = None
        obj_by_id = state.alloc_object_by_id
        for nid, evs in plan.node_update.items():
            i = index_get(nid)
            if i is None:
                continue
            for a in evs:
                row = obj_by_id(a.id)
                if row is not None:
                    if row.terminal_status() or row.node_id != nid:
                        continue  # never counted in the base at this row
                    used[i] -= _res_vec(row.resources)
                    bw_used[i] -= _task_bw(row.task_resources)
                    if row.job_id == job_id:
                        job_count[i] -= 1
                        if row.task_group == tg_name:
                            tg_count[i] -= 1
                    continue
                if blocks is None:
                    blocks = state.alloc_blocks()
                for blk in blocks:
                    if blk.find(a.id) is not None:
                        used[i] -= _res_vec(a.resources)
                        bw_used[i] -= _task_bw(a.task_resources)
                        if a.job_id == job_id:
                            job_count[i] -= 1
                            if a.task_group == tg_name:
                                tg_count[i] -= 1
                        break
        for nid, adds in plan.node_allocation.items():
            i = index_get(nid)
            if i is None:
                continue
            for a in adds:
                used[i] += _res_vec(a.resources)
                bw_used[i] += _task_bw(a.task_resources)
                if a.job_id == job_id:
                    job_count[i] += 1
                    if a.task_group == tg_name:
                        tg_count[i] += 1
        self._plan_batch_usage(plan, job_id, tg_name, used, job_count,
                               tg_count)
        dev = self.device
        return (_put(used, dev), _put(job_count, dev), _put(tg_count, dev),
                _put(bw_used, dev))

    def capacity_view(self, state) -> Tuple[np.ndarray, np.ndarray]:
        """(totals[padded,4] int32, used[padded,4] int32) on the host: the
        express lane's capacity view, per-row totals beside the
        job-independent base usage (reserved + every existing allocation)
        for ``state``'s alloc generation, by the same row accounting the
        solver's build_usage starts from. Unlike ``_base_usage_for`` the
        view rolls IN PLACE; the arrays are shared with the view, so
        callers must not mutate them, and submissions serialize on the
        lane's own lock."""
        uid = getattr(state, "store_uid", "")
        aidx = state.get_index("allocs")
        if not uid or getattr(state, "optimistic", False):
            used, _bw = self._base_usage_for(state)
            return self.totals_np, used
        with self._express_roll_lock:
            cached = self._express_usage
            if (cached is not None and cached[0] == uid
                    and cached[1] == aidx):
                return self.totals_np, cached[2]
            used = bw = None
            if (cached is not None and cached[0] == uid
                    and aidx > cached[1]
                    and hasattr(state, "alloc_node_changes_since")):
                dirty = state.alloc_node_changes_since(cached[1])
                if dirty is not None and len(dirty) <= max(1024,
                                                           self.n // 2):
                    used, bw = cached[2], cached[3]
                    if dirty:
                        self._usage_rows_bulk(state, dirty, used, bw)
            if used is None:
                base_used, base_bw = self._base_usage_for(state)
                used, bw = base_used.copy(), base_bw.copy()
            self._express_usage = (uid, aidx, used, bw)
        return self.totals_np, used

    def _base_usage_for(self, state) -> Tuple[np.ndarray, np.ndarray]:
        """The cached job-independent (used, bw_used) base for ``state``'s
        alloc generation: reserved + every existing allocation. On a
        generation mismatch the base rolls forward through the store's
        alloc change log (recomputing only the dirty rows); a dirty set
        past the log horizon — or large enough that per-row python beats
        nothing — falls back to one full recompute. Returned arrays are
        shared and must be copied before mutation."""
        uid = getattr(state, "store_uid", "")
        aidx = state.get_index("allocs")
        if not uid or getattr(state, "optimistic", False):
            # Anonymous states and optimistically-mutated snapshots name
            # content the shared change logs don't describe: never roll
            # from them, never cache them.
            return self._compute_base_usage(state)
        with self._usage_lock:
            cached = self._base_usage
        if cached is not None and cached[0] == uid and cached[1] == aidx:
            return cached[2], cached[3]
        used = bw = None
        if (cached is not None and cached[0] == uid and aidx > cached[1]
                and hasattr(state, "alloc_node_changes_since")):
            dirty = state.alloc_node_changes_since(cached[1])
            # The bulk roll is O(dirty + touched block runs), so it beats
            # the full recompute for much larger dirty sets than the old
            # per-row scan did (a 12.5k-placement burst commit dirties
            # thousands of rows at once).
            if dirty is not None and len(dirty) <= max(1024, self.n // 2):
                if dirty:
                    used = cached[2].copy()
                    bw = cached[3].copy()
                    self._usage_rows_bulk(state, dirty, used, bw)
                    telemetry.incr_counter(("mirror", "usage_rolls"))
                else:
                    used, bw = cached[2], cached[3]
        if used is None:
            used, bw = self._compute_base_usage(state)
            telemetry.incr_counter(("mirror", "usage_rebuilds"))
        with self._usage_lock:
            prev = self._base_usage
            if prev is None or prev[0] != uid or prev[1] <= aidx:
                self._base_usage = (uid, aidx, used, bw)
        return used, bw

    def _block_rows_for(self, blk):
        """(rows, counts, vec4, bw) of a block's live runs resolved
        against this mirror's rows, identity-cached (see _block_rows).
        Off-mirror nodes drop out."""
        cache = self._block_rows
        entry = cache.get(id(blk))
        if entry is not None and entry[0] is blk:
            return entry[1], entry[2], entry[3], entry[4]
        index_get = self.index.get
        rows_l: List[int] = []
        counts_l: List[int] = []
        for nid, cnt in blk.live_counts_map().items():
            i = index_get(nid)
            if i is not None:
                rows_l.append(i)
                counts_l.append(cnt)
        rows = np.asarray(rows_l, dtype=np.int64)
        counts = np.asarray(counts_l, dtype=np.int64)
        vec = _res_vec(blk.resources)
        bw = _task_bw(blk.task_resources)
        with self._block_rows_lock:
            cache[id(blk)] = (blk, rows, counts, vec, bw)
            while len(cache) > 4096:
                # FIFO-evict the oldest resolution (dict preserves
                # insertion order) — a full clear() here would wipe the
                # entry just added and collapse the hit rate to zero the
                # moment the live-block count exceeds the cap, which is
                # exactly the large-cluster regime the bulk roll exists
                # for. Under the lock: concurrent workers both evicting
                # would otherwise race next(iter())/pop into KeyError.
                cache.pop(next(iter(cache)))
        return rows, counts, vec, bw

    def _usage_rows_bulk(self, state, dirty, used, bw) -> None:
        """Recompute the ``dirty`` nodes' rows of the base-usage arrays
        in place: reserved base, their object rows, then ONE masked
        scatter per block restricted to dirty rows. Replaces the old
        per-dirty-row walk whose cost was O(dirty x blocks) python — the
        dominant per-eval term once a run had committed a few dozen
        columnar blocks."""
        index_get = self.index.get
        rows_l: List[int] = []
        nids_l: List[str] = []
        for nid in dirty:
            i = index_get(nid)
            if i is not None:
                rows_l.append(i)
                nids_l.append(nid)
        if not rows_l:
            return
        rows_arr = np.asarray(rows_l, dtype=np.int64)
        used[rows_arr] = self.reserved_np[rows_arr]
        bw[rows_arr] = self.bw_reserved[rows_arr]
        for nid, i in zip(nids_l, rows_l):
            for a in state.allocs_by_node_objects(nid):
                if a.terminal_status():
                    continue
                used[i] += _res_vec(a.resources)
                bw[i] += _task_bw(a.task_resources)
        in_dirty = np.zeros(self.padded, dtype=bool)
        in_dirty[rows_arr] = True
        for blk in state.alloc_blocks():
            b_rows, b_counts, vec, b_bw = self._block_rows_for(blk)
            if not b_rows.size:
                continue
            m = in_dirty[b_rows]
            if not m.any():
                continue
            hit_rows = b_rows[m]
            hit_counts = b_counts[m]
            # live_counts_map already summed duplicate runs per node, so
            # hit rows are unique within a block: plain fancy-index adds.
            used[hit_rows] += vec[None, :] * hit_counts[:, None]
            if b_bw:
                bw[hit_rows] += b_bw * hit_counts

    def _compute_base_usage(self, state) -> Tuple[np.ndarray, np.ndarray]:
        """Full base recompute: reserved + all object rows + all block
        runs. The delta path's fallback (and first fill)."""
        used = self.reserved_np.copy()
        bw = self.bw_reserved.copy()
        index_get = self.index.get
        for a in state.allocs_objects():
            if a.terminal_status():
                continue
            i = index_get(a.node_id)
            if i is None:
                continue
            used[i] += _res_vec(a.resources)
            bw[i] += _task_bw(a.task_resources)
        for blk in state.alloc_blocks():
            vec = _res_vec(blk.resources)
            tbw = _task_bw(blk.task_resources)
            for nid, cnt in blk.live_node_counts():
                i = index_get(nid)
                if i is None:
                    continue
                used[i] += vec * cnt
                if tbw:
                    bw[i] += tbw * cnt
        return used, bw

    def _build_usage_walk(self, ctx, job_id: str, tg_name: str):
        """The original full proposed-alloc walk, kept for states without
        the columnar/change-log surface (and as the fuzz differential's
        reference implementation for the delta path above)."""
        plan = ctx.plan
        used = self.reserved_np.copy()
        bw_used = self.bw_reserved.copy()
        job_count = np.zeros(self.padded, dtype=np.int32)
        tg_count = np.zeros(self.padded, dtype=np.int32)
        # The object walk only has anything to say for nodes with object-
        # row allocs or plan-touched nodes — at 50k nodes with columnar
        # state that's a handful, and the full-cluster python loop was
        # ~100ms/eval of nothing. States without the index fall back to
        # the full walk.
        obj_nodes_fn = getattr(ctx.state, "nodes_with_object_allocs", None)
        if obj_nodes_fn is not None:
            touched = set(obj_nodes_fn())
            touched.update(plan.node_allocation)
            touched.update(plan.node_update)
            index_get = self.index.get
            node_iter = []
            # sorted: the walk order must be a pure function of the
            # touched set, not its hash order (nomadlint DET003) — the
            # accumulation is commutative ints, but the fuzz families
            # compare intermediate row dirtiness too.
            for nid in sorted(touched):
                i = index_get(nid)
                if i is not None:
                    node_iter.append((i, self.nodes[i]))
        else:
            node_iter = enumerate(self.nodes)
        for i, node in node_iter:
            for alloc in ctx.proposed_allocs_objects(node.id):
                used[i] += _res_vec(alloc.resources)
                bw_used[i] += _task_bw(alloc.task_resources)
                if alloc.job_id == job_id:
                    job_count[i] += 1
                    if alloc.task_group == tg_name:
                        tg_count[i] += 1
        # Existing allocations held in stored columnar blocks: accounted
        # per run (count × vec), never materialized. Members this plan
        # evicts are invisible to the object walk above, so subtract them
        # here; stale eviction ids (member already gone) subtract nothing.
        blocks_getter = getattr(ctx.state, "alloc_blocks", None)
        blocks = blocks_getter() if blocks_getter is not None else []
        if blocks:
            evicted: Dict[int, List] = {}
            for nid, evs in plan.node_update.items():
                i = self.index.get(nid)
                if i is None:
                    continue
                for a in evs:
                    for blk in blocks:
                        if blk.find(a.id) is not None:
                            evicted.setdefault(i, []).append((a, blk))
                            break
            for blk in blocks:
                vec = _res_vec(blk.resources)
                bw = _task_bw(blk.task_resources)
                b_job = blk.job_id
                b_tg = blk.tg_name
                for nid, cnt in blk.live_node_counts():
                    i = self.index.get(nid)
                    if i is None:
                        continue
                    used[i] += vec * cnt
                    bw_used[i] += bw * cnt
                    if b_job == job_id:
                        job_count[i] += cnt
                        if b_tg == tg_name:
                            tg_count[i] += cnt
            for i, pairs in evicted.items():
                for a, blk in pairs:
                    used[i] -= _res_vec(a.resources)
                    bw_used[i] -= _task_bw(a.task_resources)
                    if a.job_id == job_id:
                        job_count[i] -= 1
                        if a.task_group == tg_name:
                            tg_count[i] -= 1
        self._plan_batch_usage(ctx.plan, job_id, tg_name, used, job_count,
                               tg_count)
        dev = self.device
        return (_put(used, dev), _put(job_count, dev), _put(tg_count, dev),
                _put(bw_used, dev))

    def _plan_batch_usage(self, plan, job_id: str, tg_name: str,
                          used, job_count, tg_count) -> None:
        """Columnar plan contributions, shared by the delta path and the
        full walk so the two can never drift.

        Placements from earlier task groups of this plan (AllocBatch
        bypasses proposed_allocs' per-object view) add whole runs; in-place
        update batches contribute their (new - old) resource delta — the
        existing allocs were already counted at their old size.
        Identity-counted per (node, old resources)."""
        for b in plan.alloc_batches:
            vec = np.asarray(b.resource_vector(), dtype=np.int32)
            b_job = b.job.id if b.job is not None else ""
            for nid, cnt in zip(b.node_ids, b.node_counts):
                i = self.index.get(nid)
                if i is None:
                    continue
                used[i] += vec * cnt
                if b_job == job_id:
                    job_count[i] += cnt
                    if b.tg_name == tg_name:
                        tg_count[i] += cnt
        for b in plan.update_batches:
            new_vec = np.asarray(b.resource_vector(), dtype=np.int64)
            if b.src_node_ids:
                # Block-columnar form: one shared old vector, node runs as
                # columns (mirrors plan_apply.evaluate_plan's handling).
                old_vec = (
                    np.asarray(b.src_resources.as_vector(), dtype=np.int64)
                    if b.src_resources is not None
                    else np.zeros(4, dtype=np.int64)
                )
                delta = new_vec - old_vec
                if delta.any():
                    for nid, cnt in zip(b.src_node_ids, b.src_node_counts):
                        i = self.index.get(nid)
                        if i is not None:
                            used[i] += (delta * cnt).astype(np.int32)
                continue
            counts: Dict[Tuple[str, int], int] = {}
            vecs: Dict[int, np.ndarray] = {}
            for a in b.allocs:
                key = (a.node_id, id(a.resources))
                n = counts.get(key)
                if n is None:
                    counts[key] = 1
                    vecs[id(a.resources)] = (
                        np.asarray(a.resources.as_vector(), dtype=np.int64)
                        if a.resources is not None
                        else np.zeros(4, dtype=np.int64)
                    )
                else:
                    counts[key] = n + 1
            for (nid, rid), cnt in counts.items():
                i = self.index.get(nid)
                if i is None:
                    continue
                delta = (new_vec - vecs[rid]) * cnt
                if delta.any():
                    used[i] += delta.astype(np.int32)


class MirrorCache:
    """Device-mirror registry keyed by state generation.

    SURVEY.md §7: "maintain on-device arrays keyed by a state-store
    generation". A snapshot's (store_uid, nodes-table index) names one
    immutable node set; all evals scheduled against it (across workers and
    retries) share a single NodeMirror — node tensors stay resident on the
    device and host-side driver/constraint masks stay warm.

    Node writes bump the table index; instead of rebuilding, a key miss
    ROLLS the newest resident mirror of the same (store, dc-set) lineage
    forward through the store's node change log (NodeMirror.apply_delta):
    only the dirty rows re-stage to device and only the affected mask
    columns invalidate. Full rebuild remains for the cases a delta cannot
    express — log horizon exceeded, a node leaving the ready set (row
    shift), or appends crossing the padding bucket — and is counted so
    the steady state ("delta rolls dominate") is observable."""

    def __init__(self, capacity: int = 8):
        import collections

        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.delta_rolls = 0
        self.full_rebuilds = 0
        self.rows_restaged = 0
        # Wall-time economy of the two miss paths (the solver panel's
        # delta-roll-vs-full-rebuild story needs the COST next to the
        # counts: a roll that were as expensive as a rebuild would make
        # the whole delta machinery pointless).
        self.roll_ms = 0.0
        self.rebuild_ms = 0.0

    def get(self, state, datacenters: List[str], device=None):
        """Return (nodes, mirror) for the ready nodes of ``state`` in
        ``datacenters``; rolls a resident ancestor forward on a key miss,
        builds fresh only when no delta path exists.

        ``misses`` counts every key miss; a miss is then served by either
        a delta roll or a full rebuild (misses == delta_rolls +
        full_rebuilds), so hits/(hits+misses) stays an honest hit ratio.
        ``device`` (default: the CUDA card) is part of the key: one mirror per
        (state generation, datacenters, device)."""
        from nomad_tpu_torch.scheduler.util import ready_nodes_in_dcs

        uid = getattr(state, "store_uid", "")
        device = resolve_device(device)
        key = (uid, state.get_index("nodes"), tuple(sorted(datacenters)),
               str(device))
        if uid:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return entry
                ancestor = self._newest_ancestor(key)
            entry = self._roll_forward(key, ancestor, state, datacenters)
            if entry is not None:
                return entry
        t0 = time.perf_counter()
        nodes = ready_nodes_in_dcs(state, datacenters)
        mirror = NodeMirror(nodes, device)
        build_ms = (time.perf_counter() - t0) * 1000.0
        if uid:
            with self._lock:
                self.misses += 1
                self.full_rebuilds += 1
                self.rebuild_ms += build_ms
                self._entries[key] = (nodes, mirror)
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
            telemetry.incr_counter(("mirror", "full_rebuilds"))
        return nodes, mirror

    def _newest_ancestor(self, key):
        """Lock held: the resident (key, mirror) of this (store, dc-set)
        lineage with the highest node generation below ``key``'s."""
        uid, nodes_index, dcs_key, dev_key = key
        best = None
        for k in self._entries:
            if (k[0] == uid and k[2] == dcs_key and k[3] == dev_key
                    and k[1] < nodes_index
                    and (best is None or k[1] > best[1])):
                best = k
        if best is None:
            return None
        return best, self._entries[best][1]

    def _roll_forward(self, key, ancestor, state, datacenters: List[str]):
        """Delta-roll ``ancestor`` up to ``state``'s node generation and
        register it under ``key``; None means the caller must fully
        rebuild. Runs OUTSIDE the cache lock — the roll dispatches device
        work (and a first roll per bucket compiles), which must not stall
        unrelated cache hits; a racing duplicate roll is just wasted work,
        resolved by the insert-time re-check."""
        if ancestor is None:
            return None
        changes_fn = getattr(state, "node_changes_since", None)
        if changes_fn is None:
            return None
        best, mirror = ancestor
        changes = changes_fn(best[1])
        if changes is None:
            return None  # log horizon exceeded
        t0 = time.perf_counter()
        out = mirror.apply_delta(changes, state, datacenters)
        roll_ms = (time.perf_counter() - t0) * 1000.0
        if out is None:
            return None  # membership forces repadding/reordering
        new_mirror, restaged = out
        entry = (new_mirror.nodes, new_mirror)
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                # Another thread served this key while we rolled: keep
                # the resident entry (its mask caches may already be
                # warmer) and drop ours.
                self._entries.move_to_end(key)
                self.hits += 1
                return existing
            # The ancestor stays resident at its current LRU position:
            # batched workers hold snapshots at interleaved node
            # generations, and evicting it here would force a full
            # rebuild for any eval still scheduled against the older
            # one. It ages out once nothing hits it.
            self.misses += 1
            self.delta_rolls += 1
            self.rows_restaged += restaged
            self.roll_ms += roll_ms
            self._entries[key] = entry
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        telemetry.incr_counter(("mirror", "delta_rolls"))
        if restaged:
            telemetry.incr_counter(("mirror", "rows_restaged"), restaged)
        return entry

    def stats(self) -> dict:
        """Debug-surface snapshot: residency, hit ratio, and the delta
        economy (rolls vs full rebuilds, rows re-staged)."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "delta_rolls": self.delta_rolls,
                "full_rebuilds": self.full_rebuilds,
                "rows_restaged": self.rows_restaged,
                "roll_ms": round(self.roll_ms, 3),
                "rebuild_ms": round(self.rebuild_ms, 3),
                "node_buckets": sorted({
                    m.padded for _n, m in self._entries.values()
                }),
            }


    def byte_ledger(self) -> dict:
        """The cache-wide byte economy: the resident mirrors' buffers
        grouped by padding bucket x dtype, the MEASURED per-padded-row
        cost, and the projected 1M-node footprint, per_row_bytes x
        bucket(1_000_000) rows. The projection is None until a mirror is
        resident (no rows, no measurement)."""
        with self._lock:
            mirrors = [m for _n, m in self._entries.values()]
        by_bucket: dict = {}
        buffer_bytes = 0
        cache_bytes = 0
        padded_rows = 0
        live_rows = 0
        for m in mirrors:
            ledger = m.byte_ledger()
            buffer_bytes += ledger["buffer_bytes"]
            cache_bytes += ledger["cache_bytes"]
            padded_rows += ledger["padded"]
            live_rows += ledger["rows"]
            row = by_bucket.setdefault(ledger["padded"], {})
            for buf in ledger["buffers"].values():
                row[buf["dtype"]] = row.get(buf["dtype"], 0) + buf["nbytes"]
        total = buffer_bytes + cache_bytes
        per_row = (total / padded_rows) if padded_rows else None
        return {
            "mirrors": len(mirrors),
            "rows": live_rows,
            "padded_rows": padded_rows,
            "by_bucket_dtype": {
                str(b): dict(sorted(row.items()))
                for b, row in sorted(by_bucket.items())
            },
            "buffer_bytes": buffer_bytes,
            "cache_bytes": cache_bytes,
            "total_bytes": total,
            "per_row_bytes": round(per_row, 2) if per_row else None,
            "projected_1m_rows": bucket(1_000_000) if per_row else None,
            "projected_1m_bytes": (
                int(per_row * bucket(1_000_000)) if per_row else None
            ),
        }

    def device_bytes(self) -> int:
        """Bytes of the resident mirrors' tensors that live on a CUDA
        device (metadata only)."""
        with self._lock:
            mirrors = [m for _n, m in self._entries.values()]
        return sum(_arr_bytes(v, cuda_only=True) for m in mirrors
                   for v in _mirror_arrays(m))


def _dtype_name(arr) -> str:
    """numpy's spelling of an array's or tensor's dtype ("int32", never
    "torch.int32"), so the ledger's keys equal nomad_tpu's."""
    if isinstance(arr, torch.Tensor):
        return str(arr.dtype).replace("torch.", "")
    return str(arr.dtype)


def _arr_bytes(v, cuda_only: bool = False) -> int:
    """Bytes of a tensor or array, or of the ones inside a tuple or list,
    from metadata alone."""
    if isinstance(v, torch.Tensor):
        if cuda_only and v.device.type != "cuda":
            return 0
        return v.numel() * v.element_size()
    if isinstance(v, np.ndarray):
        return 0 if cuda_only else int(v.nbytes)
    if isinstance(v, (tuple, list)):
        return sum(_arr_bytes(x, cuda_only) for x in v)
    return 0


def _mirror_arrays(m):
    """Every buffer and cache entry a mirror holds (for device_bytes)."""
    for name in ("total", "sched_cap", "bw_avail", "_clean_usage_dev"):
        yield getattr(m, name, None)
    yield from list((getattr(m, "_device_mask_cache", None) or {}).values())


# Process-wide cache shared by every device scheduler instance (the workers
# all schedule against snapshots of the same FSM store).
GLOBAL_MIRROR_CACHE = MirrorCache()
