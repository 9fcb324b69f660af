"""The node table and block-usage helpers the device scheduler's
reconcile paths call (a slice of nomad_tpu/server/plan_apply.py).

``_node_table`` is the cached columnar view of the node set (id -> row,
totals, reserved, liveness), delta-rolled through the store's node change
log; ``_existing_block_usage_rows`` folds stored columnar alloc blocks into
per-row usage. Plan verification itself (``evaluate_plan``) belongs to the
server-loop slice and is not here yet.
"""

from __future__ import annotations

import threading

from nomad_tpu_torch import telemetry

_ZERO4 = (0, 0, 0, 0)


def _table_row_vals(node):
    """(totals4, reserved4, dead, scalar_only) for one node row — the ONE
    definition of _NodeTable's per-row column semantics, shared by the
    bulk build and the delta roll so a rolled table can never drift from
    a fresh one."""
    return (
        _ZERO4 if node.resources is None
        else tuple(node.resources.as_vector()),
        _ZERO4 if node.reserved is None
        else tuple(node.reserved.as_vector()),
        node.status != "ready" or bool(node.drain),
        node.reserved is not None and bool(node.reserved.networks),
    )


class _NodeTable:
    """Columnar view of the node set for vectorized plan verification:
    id -> row, plus per-row totals/reserved/liveness. Cached per
    (store_uid, nodes index) — node rows are immutable between node-table
    writes, while usage is re-read from the snapshot every call."""

    __slots__ = ("rows", "totals", "reserved", "dead", "scalar_only", "n",
                 "block_rows_cache", "_mirror_maps", "block_usage_cache")

    def __init__(self, snap):
        import numpy as np

        nodes = snap.nodes()
        self.n = len(nodes)
        # id(block) -> (block, rows, counts): per-block node-run row
        # resolution, valid for this table's lifetime (blocks are COW).
        self.block_rows_cache = {}
        # (id-set, block refs, usage[N,4], net_rows) of the last
        # _existing_block_usage_rows accumulation — extended
        # incrementally while the block set only grows (the applier's
        # monotonic verify sequence), recomputed on any removal.
        self.block_usage_cache = None
        # id(mirror id array) -> (array, table rows aligned with it):
        # one string resolve per (table, mirror) pair; every plan built
        # from that mirror then resolves node runs by pure gathers.
        # Capped: mirrors churn with datacenter-set keys while a table
        # generation can live long, and the strong ref here is what keeps
        # each id() key valid — unbounded it would pin every mirror ever
        # seen (an id array is ~7MB at 50k nodes).
        import collections
        self._mirror_maps = collections.OrderedDict()
        self.rows = {node.id: i for i, node in enumerate(nodes)}
        # Bulk conversions, not 50k scalar-row assignments: one python
        # pass computing row tuples (_table_row_vals, shared with the
        # delta roll) feeds one np.array per column.
        if nodes:
            vals = [_table_row_vals(n) for n in nodes]
            self.totals = np.array([v[0] for v in vals], dtype=np.int32)
            self.reserved = np.array([v[1] for v in vals], dtype=np.int64)
            self.dead = np.fromiter(
                (v[2] for v in vals), dtype=bool, count=self.n)
            # reserved networks need the sequential port index: scalar path.
            self.scalar_only = np.fromiter(
                (v[3] for v in vals), dtype=bool, count=self.n)
        else:
            self.totals = np.zeros((0, 4), dtype=np.int32)
            self.reserved = np.zeros((0, 4), dtype=np.int64)
            self.dead = np.zeros(0, dtype=bool)
            self.scalar_only = np.zeros(0, dtype=bool)

    def apply_delta(self, changes, snap) -> "Optional[_NodeTable]":
        """Roll this table forward through node-table ``changes`` (the
        store's change log, same feed as NodeMirror.apply_delta): dirty
        rows patch on column copies, brand-new nodes append at the dict
        tail. Returns None when a delta can't express the change — a
        node deleted (row shift) or a removed key re-inserted (dict
        order moved) — and the caller rebuilds. Node writes no longer
        cost the plan applier an O(N) table rebuild per verify."""
        import numpy as np

        from nomad_tpu_torch.state.store import partition_node_changes

        # This table's set is ALL nodes (liveness is the dead column,
        # not membership): resolve is a plain row lookup.
        parts = partition_node_changes(changes, self.rows.get,
                                       snap.node_by_id)
        if parts is None:
            return None
        patches, appends = parts
        if not patches and not appends:
            return self

        new = _NodeTable.__new__(_NodeTable)
        new.n = self.n + len(appends)
        row_vals = _table_row_vals
        totals = self.totals
        reserved = self.reserved
        dead = self.dead
        scalar_only = self.scalar_only
        if patches:
            totals = totals.copy()
            reserved = reserved.copy()
            dead = dead.copy()
            scalar_only = scalar_only.copy()
            for row, node in patches:
                t, r, d, s = row_vals(node)
                totals[row] = t
                reserved[row] = r
                dead[row] = d
                scalar_only[row] = s
        if appends:
            app_vals = [row_vals(node) for _pos, node in appends]
            totals = np.concatenate([totals, np.array(
                [v[0] for v in app_vals], dtype=np.int32)])
            reserved = np.concatenate([reserved, np.array(
                [v[1] for v in app_vals], dtype=np.int64)])
            dead = np.concatenate([dead, np.array(
                [v[2] for v in app_vals], dtype=bool)])
            scalar_only = np.concatenate([scalar_only, np.array(
                [v[3] for v in app_vals], dtype=bool)])
            rows = dict(self.rows)
            for i, (_pos, node) in enumerate(appends):
                rows[node.id] = self.n + i
            new.rows = rows
            # Row numbering of existing nodes didn't move, but cached
            # resolutions may hold -1 for the appended ids and the usage
            # accumulator is row-aligned: rebuild those lazily.
            new.block_rows_cache = {}
            import collections
            new._mirror_maps = collections.OrderedDict()
            new.block_usage_cache = None
        else:
            new.rows = self.rows
            # Pure row patches leave row numbering AND block usage
            # (a function of blocks, not node fields) intact: share the
            # warm caches with the ancestor.
            new.block_rows_cache = self.block_rows_cache
            new._mirror_maps = self._mirror_maps
            new.block_usage_cache = self.block_usage_cache
        new.totals = totals
        new.reserved = reserved
        new.dead = dead
        new.scalar_only = scalar_only
        return new

    def mirror_rows(self, ids_ref) -> "np.ndarray":
        """Table rows aligned with a solver mirror's id array (-1 for ids
        this table doesn't know). The id array is identity-stable across
        evals of one state generation (MirrorCache), so the per-id dict
        walk happens once per (table, mirror) pair and every subsequent
        plan resolves its node runs with a single fancy-index."""
        import numpy as np

        cached = self._mirror_maps.get(id(ids_ref))
        if cached is not None and cached[0] is ids_ref:
            self._mirror_maps.move_to_end(id(ids_ref))
            return cached[1]
        get = self.rows.get
        mapped = np.fromiter(
            (get(nid, -1) for nid in ids_ref), dtype=np.int64,
            count=len(ids_ref),
        )
        self._mirror_maps[id(ids_ref)] = (ids_ref, mapped)
        while len(self._mirror_maps) > 8:
            self._mirror_maps.popitem(last=False)
        return mapped


_NODE_TABLE_LOCK = threading.Lock()
_NODE_TABLE_CACHE: "OrderedDict" = None  # type: ignore[assignment]


def _node_table(snap):
    """Cached _NodeTable for a snapshot, or None for states without the
    store internals (protocol-only fakes). A key miss delta-rolls the
    newest cached table of the same store through the node change log
    (NodeTable.apply_delta) before falling back to a full build — the
    MirrorCache posture, applied to the plan applier's staging."""
    import collections

    global _NODE_TABLE_CACHE
    uid = getattr(snap, "store_uid", "")
    if not uid or not hasattr(snap, "alloc_blocks"):
        return None
    nodes_index = snap.get_index("nodes")
    key = (uid, nodes_index)
    ancestor = None
    with _NODE_TABLE_LOCK:
        if _NODE_TABLE_CACHE is None:
            _NODE_TABLE_CACHE = collections.OrderedDict()
        table = _NODE_TABLE_CACHE.get(key)
        if table is not None:
            _NODE_TABLE_CACHE.move_to_end(key)
            return table
        best = None
        for k in _NODE_TABLE_CACHE:
            if (k[0] == uid and k[1] < nodes_index
                    and (best is None or k[1] > best[1])):
                best = k
        if best is not None:
            ancestor = (best, _NODE_TABLE_CACHE[best])
    table = None
    if ancestor is not None and hasattr(snap, "node_changes_since"):
        changes = snap.node_changes_since(ancestor[0][1])
        if changes is not None:
            table = ancestor[1].apply_delta(changes, snap)
            if table is not None:
                telemetry.incr_counter(("plan", "node_table_rolls"))
    if table is None:
        table = _NodeTable(snap)
        telemetry.incr_counter(("plan", "node_table_rebuilds"))
    with _NODE_TABLE_LOCK:
        existing = _NODE_TABLE_CACHE.get(key)
        if existing is not None:
            _NODE_TABLE_CACHE.move_to_end(key)
            return existing
        _NODE_TABLE_CACHE[key] = table
        while len(_NODE_TABLE_CACHE) > 4:
            _NODE_TABLE_CACHE.popitem(last=False)
    return table

def _block_has_net(blk) -> bool:
    has_net = bool(blk.resources is not None and blk.resources.networks)
    if not has_net and blk.task_resources:
        has_net = any(
            tr is not None and tr.networks
            for tr in blk.task_resources.values()
        )
    return has_net


def _block_rows_cached(table, blk):
    """(rows int64[k], counts int64[k]) for a block's live node runs,
    resolved against ``table`` once per (table, block) pair. Blocks are
    copy-on-write (any exclusion/update commits a NEW object,
    state/blocks.py), so the identity key can never serve stale runs;
    holding the block in the cache entry pins its id. Without this, every
    plan verify re-resolved every existing block's ~10k node ids through
    the row dict — the dominant cost of the coalesced pipeline's later
    verifies."""
    import numpy as np

    cache = table.block_rows_cache
    entry = cache.get(id(blk))
    if entry is not None and entry[0] is blk:
        return entry[1], entry[2]
    get = table.rows.get
    if blk.excluded:
        pairs = list(blk.live_node_counts())
        nids = [p[0] for p in pairs]
        counts = np.asarray([p[1] for p in pairs], dtype=np.int64)
    else:
        nids = blk.node_ids
        counts = np.asarray(blk.node_counts, dtype=np.int64)
    rows = np.fromiter(
        (get(nid, -1) for nid in nids), dtype=np.int64, count=len(nids)
    )
    cache[id(blk)] = (blk, rows, counts)
    if len(cache) > 256:
        cache.clear()
    return rows, counts


def _accumulate_block_usage(table, blocks, usage, net_rows):
    """Fold ``blocks`` into (usage[N,4], net_rows) — one np.add.at per
    block, per-block row resolution cached on the table. Mutates and
    returns the passed arrays (callers own them)."""
    import numpy as np

    for blk in blocks:
        rows, counts = _block_rows_cached(table, blk)
        valid = rows >= 0
        if _block_has_net(blk):
            if net_rows is None:
                net_rows = np.zeros(table.n, dtype=bool)
            net_rows[rows[valid]] = True
            continue
        vec = np.asarray(blk.resource_vector(), dtype=np.int64)
        if usage is None:
            usage = np.zeros((table.n, 4), dtype=np.int64)
        np.add.at(usage, rows[valid], vec[None, :] * counts[valid, None])
    return usage, net_rows


def _existing_block_usage_rows(snap, table):
    """Vectorized block usage over node-table rows: (usage[N,4] int64 or
    None, net_rows bool[N] or None, blocks).

    Incremental across the applier's verify sequence: blocks are COW
    (any exclusion/update/removal commits NEW objects), so while the
    snapshot's block identity-set only GROWS relative to the cached
    accumulation, only the new blocks fold in — a burst of K commits
    costs O(total runs) across its K verifies instead of O(K x total).
    Any removal (shrunk or replaced block) recomputes from scratch. The
    cache holds the block refs, pinning their ids against reuse; arrays
    are copied before extension so results already handed to concurrent
    readers never mutate underneath them."""
    blocks = snap.alloc_blocks()
    cache = table.block_usage_cache
    cur_ids = {id(b) for b in blocks}
    if cache is not None:
        cached_ids, _cached_refs, usage, net_rows = cache
        if cached_ids <= cur_ids:
            new = [b for b in blocks if id(b) not in cached_ids]
            if not new:
                return usage, net_rows, blocks
            usage = None if usage is None else usage.copy()
            net_rows = None if net_rows is None else net_rows.copy()
            usage, net_rows = _accumulate_block_usage(
                table, new, usage, net_rows
            )
            table.block_usage_cache = (cur_ids, list(blocks), usage,
                                       net_rows)
            return usage, net_rows, blocks
    usage, net_rows = _accumulate_block_usage(table, blocks, None, None)
    table.block_usage_cache = (cur_ids, list(blocks), usage, net_rows)
    return usage, net_rows, blocks
