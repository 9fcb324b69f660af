"""Plan verification: per-node feasibility of a submitted plan.

Port of nomad_tpu/server/plan_apply.py (upstream nomad/plan_apply.go, the
verification half).
``evaluate_plan`` determines the committable subset of one plan against a
state snapshot — scalar per-node checks for small plans, the vectorized
columnar ``_NodeTable`` path for large ones. The applier loop itself lives
in plan_pipeline.py (the optimistic batch applier): it drains K plans at
once and generalizes this module's verification to one fused K x nodes
tensor pass, so the single-plan semantics here are the decision contract
the batched verifier is fuzz-pinned against.

The bulk superset check runs through the ctypes C++ helper
(``nomad_tpu_torch.native.fit_check``), built with the host compiler at
first use, as nomad_tpu's does. This is host control-plane code: the
device kernels are in ``ops/``.
"""

from __future__ import annotations

import threading

from nomad_tpu_torch import native, telemetry
from nomad_tpu_torch.structs import (
    Allocation,
    Plan,
    PlanResult,
    allocs_fit,
    filter_terminal_allocs,
    remove_allocs,
)


def evaluate_node_plan(snap, plan: Plan, node_id: str,
                       batch_res=None) -> bool:
    """Check one node's placements against the snapshot
    (plan_apply.go:229-277). ``batch_res`` carries the summed Resources of
    any columnar (AllocBatch) placements on this node."""
    if not plan.node_allocation.get(node_id) and batch_res is None:
        # Evict-only plans always fit.
        return True

    node = snap.node_by_id(node_id)
    if node is None or node.status != "ready" or node.drain:
        return False

    existing = filter_terminal_allocs(snap.allocs_by_node(node_id))

    remove = list(plan.node_update.get(node_id, []))
    remove.extend(plan.node_allocation.get(node_id, []))
    proposed = remove_allocs(existing, remove)
    if plan.block_stops:
        stopped = plan.block_stop_ids().get(node_id)
        if stopped:
            proposed = [a for a in proposed if a.id not in stopped]
    proposed = proposed + plan.node_allocation.get(node_id, [])
    if batch_res is not None:
        pseudo = Allocation(resources=batch_res)
        proposed = proposed + [pseudo]

    fit, _, _ = allocs_fit(node, proposed)
    return fit


# Plans below this many placements verify with the per-node scalar loop;
# larger ones go through the bulk verifier first.
FAST_VERIFY_THRESHOLD = 64


def _node_live(snap, node_id: str) -> bool:
    node = snap.node_by_id(node_id)
    return node is not None and node.status == "ready" and not node.drain


def _res_vec(res) -> "np.ndarray":
    import numpy as np

    if res is None:
        return np.zeros(4, dtype=np.int64)
    return np.array(res.as_vector(), dtype=np.int64)


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


class _FitMap(dict):
    """{node_id: fit} answer map of the bulk verifier. ``all_fit=True``
    is the whole-commit hint: every node the plan's ask touches is live,
    port-free, and fits, so a caller whose plan has no other node sources
    can commit whole without unioning id sets or scanning values.
    When all_fit is set and the plan carries no update batches the
    per-node entries are OMITTED (the whole-commit consumer never reads
    them); otherwise entries are populated."""

    __slots__ = ("all_fit",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.all_fit = False


class _AskAccum:
    """Per-node resource ask of a plan's columnar batches and update
    deltas. Holds batch references; materializes either a dense row array
    (``to_rows``, one np.add.at per batch — the bulk verifier's form) or a
    lazy per-node dict (``get`` — the scalar fallback's form, built only
    when a small plan actually reads it). Unknown node ids keep their
    vectors in the dict form, so a plan targeting a deregistered node
    still fails its fit check instead of riding the evict-only shortcut."""

    def __init__(self):
        self.batches = []  # (node_ids, node_counts, vec, src)
        self.deltas = {}   # nid -> int64[4]
        self._node_ids = None
        self._dict = None

    @property
    def node_ids(self):
        """Union of all touched node ids, built on first read: the
        whole-commit fast path (all_fit) never consults it, so a fresh
        large placement skips the ~5k-string set build entirely."""
        ids = self._node_ids
        if ids is None:
            ids = set()
            for node_ids, _counts, _vec, _src in self.batches:
                ids.update(node_ids)
            ids.update(self.deltas)
            self._node_ids = ids
        return ids

    def add_batch(self, node_ids, node_counts, vec, src=None) -> None:
        """``src`` is the optional solver-mirror row hint carried by a
        columnar batch: (mirror id array, row indices into it) — lets the
        bulk verifier resolve table rows by gather instead of per-id dict
        walks."""
        self.batches.append((node_ids, node_counts, vec, src))
        self._node_ids = None
        self._dict = None

    def add_delta(self, nid: str, delta) -> None:
        prev = self.deltas.get(nid)
        self.deltas[nid] = delta if prev is None else prev + delta
        self._node_ids = None
        self._dict = None

    def get(self, nid: str):
        """Summed ask vector for one node, or None when untouched."""
        if nid not in self.node_ids:
            return None
        if self._dict is None:
            acc = {}
            for node_ids, node_counts, vec, _src in self.batches:
                for run_nid, cnt in zip(node_ids, node_counts):
                    prev = acc.get(run_nid)
                    acc[run_nid] = (
                        vec * cnt if prev is None else prev + vec * cnt
                    )
            for d_nid, delta in self.deltas.items():
                prev = acc.get(d_nid)
                acc[d_nid] = delta if prev is None else prev + delta
            self._dict = acc
        return self._dict.get(nid)

    def to_rows(self, table):
        """Dense [N, 4] int64 ask over node-table rows (or None if no
        contributions); unknown node ids drop out — the bulk verifier
        already answers False for them."""
        return self.accumulate_rows(table)[0]

    def accumulate_rows(self, table):
        """(ask_arr, flat_ids, rows): the dense [N, 4] ask PLUS the
        per-contribution row resolution it computed on the way — node ids
        in contribution order and their table rows (-1 for unknown),
        aligned. The single id→row resolve serves both the accumulation
        and any caller that needs per-node answers (the pure-columnar
        fast path); keeping them in one method keeps the ask rules from
        forking."""
        import numpy as np

        if not self.batches and not self.deltas:
            return None, [], np.empty(0, dtype=np.int64)
        arr = np.zeros((table.n, 4), dtype=np.int64)
        get = table.rows.get
        flat_ids = []
        row_parts = []
        for node_ids, node_counts, vec, src in self.batches:
            if src is not None:
                # Solver-mirror hint: resolve by gather through the
                # cached (table, mirror) row map — no per-id dict walk.
                ids_ref, src_rows = src
                rows = table.mirror_rows(ids_ref)[src_rows]
            else:
                rows = np.fromiter(
                    (get(nid, -1) for nid in node_ids), dtype=np.int64,
                    count=len(node_ids),
                )
            counts = np.asarray(node_counts, dtype=np.int64)
            valid = rows >= 0
            np.add.at(arr, rows[valid], vec[None, :] * counts[valid, None])
            flat_ids.extend(node_ids)
            row_parts.append(rows)
        for nid, delta in self.deltas.items():
            row = get(nid, -1)
            if row >= 0:
                arr[row] += delta
            flat_ids.append(nid)
            row_parts.append(np.asarray([row], dtype=np.int64))
        rows = (
            np.concatenate(row_parts) if len(row_parts) > 1
            else row_parts[0]
        )
        return arr, flat_ids, rows


class _AllocVecCache:
    """Identity-keyed (resources, task_resources) -> (vec, has_networks)
    cache shared by both bulk verifiers: the TPU scheduler's lean path
    aliases one Resources object across a task group's allocs, collapsing
    per-alloc attribute walks into dict hits."""

    def __init__(self):
        self.vec = {}
        self.net = {}

    def row(self, alloc):
        key = id(alloc.resources)
        vec = self.vec.get(key)
        if vec is None:
            vec = _res_vec(alloc.resources)
            self.vec[key] = vec
        nkey = (key, id(alloc.task_resources))
        has_net = self.net.get(nkey)
        if has_net is None:
            has_net = bool(
                alloc.resources is not None and alloc.resources.networks
            )
            if not has_net and alloc.task_resources:
                has_net = any(
                    tr is not None and tr.networks
                    for tr in alloc.task_resources.values()
                )
            self.net[nkey] = has_net
        return vec, has_net

    def sum_counted(self, allocs, removed=None):
        """Identity-counted resource sum of ``allocs`` (minus ``removed``
        ids). Returns (vec or None, bail) — bail True when any alloc
        carries network asks (sequential port semantics)."""
        counts = {}
        for alloc in allocs:
            if removed is not None and alloc.id in removed:
                continue
            key = (id(alloc.resources), id(alloc.task_resources))
            n = counts.get(key)
            if n is None:
                _vec, has_net = self.row(alloc)
                if has_net:
                    return None, True
                counts[key] = 1
            else:
                counts[key] = n + 1
        total = None
        for key, n in counts.items():
            add = self.vec[key[0]] * n
            total = add if total is None else total + add
        return total, False


def _block_has_net(blk) -> bool:
    has_net = bool(blk.resources is not None and blk.resources.networks)
    if not has_net and blk.task_resources:
        has_net = any(
            tr is not None and tr.networks
            for tr in blk.task_resources.values()
        )
    return has_net


def _existing_block_usage(snap):
    """Per-node usage of stored columnar blocks: {node_id: int64[4]}, plus
    the set of nodes whose blocks carry network asks (those fall back to
    the scalar path). O(runs), no materialization. Dict form — the
    table-less fallback; the vectorized verifier uses
    _existing_block_usage_rows."""
    import numpy as np

    usage = {}
    net_nodes = set()
    getter = getattr(snap, "alloc_blocks", None)
    blocks = getter() if getter is not None else []
    for blk in blocks:
        if _block_has_net(blk):
            net_nodes.update(nid for nid, _ in blk.live_node_counts())
            continue
        vec = np.asarray(blk.resource_vector(), dtype=np.int64)
        for nid, cnt in blk.live_node_counts():
            prev = usage.get(nid)
            usage[nid] = vec * cnt if prev is None else prev + vec * cnt
    return usage, net_nodes, blocks


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
    nids, counts = blk.live_runs()
    counts = np.asarray(counts, dtype=np.int64)
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


def block_stop_credit(snap, block_stops, n: int, row_of):
    """The usage the block stop runs give back, as int64[n,4] over the
    rows ``row_of(node id, -1)`` names (BlockStopRun.live_rows): the
    members still live in ``snap``'s blocks; one gone or promoted since
    gives nothing."""
    import numpy as np

    credit = np.zeros((n, 4), dtype=np.int64)
    for run in block_stops:
        rows, counts = run.live_rows(snap, row_of)
        np.add.at(credit, rows, counts[:, None] * _res_vec(run.resources))
    return credit


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


def _prevaluate_nodes_bulk(snap, plan: Plan, ask: _AskAccum = None,
                           table=None):
    """Bulk-verify the network-free nodes of a large plan: vectorized
    accumulation over the cached node table (one scatter-add per batch,
    per-node python only where object rows exist) + one bulk superset
    check. Nodes with any network asks (port collisions need the
    sequential NetworkIndex, funcs.go:73-86) stay out of the returned map
    and fall through to evaluate_node_plan. Returns {node_id: fit} — but
    a map with all_fit=True and no update batches in the plan may carry
    no entries at all (see _FitMap)."""
    if table is None:
        table = _node_table(snap)
    if ask is None:
        import numpy as np

        ask = _AskAccum()
        for b in plan.alloc_batches:
            ask.add_batch(
                b.node_ids, b.node_counts,
                np.asarray(b.resource_vector(), dtype=np.int64),
                src=b.src_hint,
            )
    if table is None:
        batch_dict = {}
        for nid in ask.node_ids:
            vec = ask.get(nid)
            if vec is not None:
                batch_dict[nid] = vec
        return _prevaluate_nodes_bulk_dict(snap, plan, batch_dict)
    return _prevaluate_nodes_bulk_rows(snap, plan, ask, table)


def _prevaluate_nodes_bulk_rows(snap, plan: Plan, ask: _AskAccum, table):
    import numpy as np


    out = _FitMap()

    block_usage, net_rows, blocks = _existing_block_usage_rows(snap, table)
    obj_nodes = snap.nodes_with_object_allocs()
    # Block stop runs give their live members' usage back on the rows
    # they touch, as columns: the fast path below holds with them.
    stop_credit = (block_stop_credit(snap, plan.block_stops, table.n,
                                     table.rows.get)
                   if plan.block_stops else None)

    if not plan.node_allocation and not plan.node_update and not obj_nodes:
        # Pure-columnar fast path (the fresh-registration headline): no
        # per-node object rows anywhere, so the entire verify is array
        # indexing — the python walk below costs ~0.5us/node x 10k nodes
        # per eval, all of it avoidable here. Row resolution happens ONCE
        # per ask batch and serves both the ask accumulation and the fit
        # answer (ask.to_rows would re-resolve the same ids a second
        # time — the duplicate was ~2.5ms/eval at headline scale).
        if table.n == 0:
            # Every node deregistered since the solve: nothing fits.
            for nid in ask.node_ids:
                out[nid] = False
            return out
        ask_arr, flat_ids, rows = ask.accumulate_rows(table)
        # Duplicate ids across batches resolve to the same row and get
        # the same (idempotent) answer — no dedup pass needed.
        valid = rows >= 0
        keep = valid.copy()
        safe_rows = np.where(valid, rows, 0)
        keep &= ~table.dead[safe_rows]
        # Unknown or dead nodes fail their fit outright.
        for i in np.flatnonzero(~keep):
            out[flat_ids[i]] = False
        # Nodes with port semantics take the sequential path: drop them
        # from the answer map (the caller falls through per node).
        sc = table.scalar_only[safe_rows]
        if net_rows is not None:
            sc = sc | net_rows[safe_rows]
        keep &= ~sc
        rows_arr = rows[keep]
        if rows_arr.size:
            used = table.reserved[rows_arr].copy()
            if block_usage is not None:
                used += block_usage[rows_arr]
            if ask_arr is not None:
                used += ask_arr[rows_arr]
            if stop_credit is not None:
                used -= stop_credit[rows_arr]
            fit, _exhausted = native.fit_check(
                np.minimum(used, 2**31 - 1).astype(np.int32),
                table.totals[rows_arr],
            )
            if bool(keep.all()) and bool(fit.all()):
                # Every asked node is live, port-free, and fits. The
                # caller can commit the plan whole without the id-set
                # union or the all() scan.
                out.all_fit = True
                if not plan.update_batches:
                    # evaluate_plan's whole-commit return never reads the
                    # per-node entries when the plan carries no update
                    # batches either — skip the ~5k dict stores. Plans
                    # WITH delta-free update nodes still get populated
                    # answers for the per-node merge.
                    return out
            kept_idx = np.flatnonzero(keep)
            for i, ok in zip(kept_idx.tolist(), fit.tolist()):
                out[flat_ids[i]] = ok
        return out

    ids = [nid for nid, placed in plan.node_allocation.items() if placed]
    in_alloc = plan.node_allocation
    ids.extend(nid for nid in ask.node_ids if nid not in in_alloc)
    ask_arr = ask.to_rows(table)

    # Per-node python only where object rows force it (placement lists or
    # existing object allocs); pure columnar nodes ride the arrays.
    cache = _AllocVecCache()
    rows_get = table.rows.get
    dead = table.dead
    scalar_only = table.scalar_only
    kept_ids = []
    kept_rows = []
    adjust = {}  # position in kept -> extra int64[4]

    for nid in ids:
        row = rows_get(nid)
        if row is None or dead[row]:
            out[nid] = False
            continue
        if scalar_only[row] or (net_rows is not None and net_rows[row]):
            continue  # sequential port semantics: scalar path
        placements = plan.node_allocation.get(nid, ())
        extra = None
        if placements:
            extra, bail = cache.sum_counted(placements)
            if bail:
                continue
        if nid in obj_nodes:
            existing = filter_terminal_allocs(
                snap.allocs_by_node_objects(nid)
            )
            removed = {a.id for a in plan.node_update.get(nid, ())}
            removed.update(a.id for a in placements)
            if plan.block_stops:
                # Run members promoted to object rows since the solve.
                removed.update(plan.block_stop_ids().get(nid, ()))
            ex_vec, bail = cache.sum_counted(existing, removed)
            if bail:
                continue
            if ex_vec is not None:
                extra = ex_vec if extra is None else extra + ex_vec
        if block_usage is not None and plan.node_update.get(nid):
            # Evictions of block members are invisible to the object walk:
            # subtract them here (stale ids subtract nothing).
            for a in plan.node_update[nid]:
                if any(blk.find(a.id) is not None for blk in blocks):
                    sub = -_res_vec(a.resources)
                    extra = sub if extra is None else extra + sub
        if extra is not None:
            adjust[len(kept_ids)] = extra
        kept_ids.append(nid)
        kept_rows.append(row)

    if not kept_ids:
        return out

    rows_arr = np.asarray(kept_rows, dtype=np.int64)
    used = table.reserved[rows_arr].copy()
    if block_usage is not None:
        used += block_usage[rows_arr]
    if ask_arr is not None:
        used += ask_arr[rows_arr]
    if stop_credit is not None:
        used -= stop_credit[rows_arr]
    for pos, extra in adjust.items():
        used[pos] += extra
    fit, _exhausted = native.fit_check(
        np.minimum(used, 2**31 - 1).astype(np.int32),
        table.totals[rows_arr],
    )
    for nid, ok in zip(kept_ids, fit.tolist()):
        out[nid] = ok
    return out


def _prevaluate_nodes_bulk_dict(snap, plan: Plan, batch_ask=None):
    """Table-less fallback of the bulk verifier (states without the store
    internals): the per-node python walk. ``batch_ask`` maps node_id to
    the summed int64 resource vector of columnar placements."""
    import numpy as np


    batch_ask = batch_ask or {}
    out = {}
    ids = [nid for nid, placed in plan.node_allocation.items() if placed]
    ids.extend(nid for nid in batch_ask if nid not in plan.node_allocation)

    # Existing usage held in columnar blocks, accounted without
    # materialization; reads below then only walk the object table.
    block_usage, block_net_nodes, blocks = _existing_block_usage(snap)
    read_objects = getattr(snap, "allocs_by_node_objects", None)
    if read_objects is None:
        read_objects = snap.allocs_by_node
        block_usage, block_net_nodes, blocks = {}, set(), []

    stop_credit = {}
    if blocks and plan.block_stops:
        # Node id -> the int64[4] the runs give back there.
        row = {nid: i for i, nid in enumerate(
            {nid for run in plan.block_stops for nid in run.node_ids})}
        credit = block_stop_credit(snap, plan.block_stops, len(row), row.get)
        stop_credit = {nid: credit[i] for nid, i in row.items()
                       if credit[i].any()}

    def evicted_block_vec(nid):
        """Resource sum of this plan's evictions that live in blocks (the
        object walk below can't see them); stale eviction ids subtract
        nothing."""
        total = stop_credit.get(nid)
        for a in plan.node_update.get(nid, ()):
            if any(blk.find(a.id) is not None for blk in blocks):
                vec = _res_vec(a.resources)
                total = vec if total is None else total + vec
        return total

    totals_rows = []
    base_rows = []
    kept = []  # node ids eligible for the bulk check, in row order
    cache = _AllocVecCache()

    for nid in ids:
        node = snap.node_by_id(nid)
        if node is None or node.status != "ready" or node.drain:
            out[nid] = False
            continue
        if node.reserved is not None and node.reserved.networks:
            continue  # reserved-port semantics: scalar path
        if nid in block_net_nodes:
            continue  # network-carrying block members: scalar path
        placements = plan.node_allocation.get(nid, ())

        base = _res_vec(node.reserved)
        extra = batch_ask.get(nid)
        if extra is not None:
            base = base + extra
        blk_used = block_usage.get(nid)
        if blk_used is not None:
            base = base + blk_used
            if plan.node_update.get(nid) or nid in stop_credit:
                evicted = evicted_block_vec(nid)
                if evicted is not None:
                    base = base - evicted
        existing = filter_terminal_allocs(read_objects(nid))
        if existing:
            removed = {a.id for a in plan.node_update.get(nid, [])}
            removed.update(a.id for a in placements)
            if plan.block_stops:
                removed.update(plan.block_stop_ids().get(nid, ()))
            ex_vec, bail = cache.sum_counted(existing, removed)
            if bail:
                continue
            if ex_vec is not None:
                base = base + ex_vec

        pl_vec, bail = cache.sum_counted(placements)
        if bail:
            continue
        ask = base if pl_vec is None else base + pl_vec

        kept.append(nid)
        totals_rows.append(_res_vec(node.resources))
        base_rows.append(ask)

    if not kept:
        return out

    used = np.asarray(base_rows, dtype=np.int64)
    fit, _exhausted = native.fit_check(
        np.minimum(used, 2**31 - 1).astype(np.int32),
        np.asarray(totals_rows, dtype=np.int32),
    )
    for nid, ok in zip(kept, fit.tolist()):
        out[nid] = ok
    return out


def evaluate_plan(snap, plan: Plan, reservations=None) -> PlanResult:
    """Determine the committable subset of a plan (plan_apply.go:164-227).

    Columnar batches verify without expansion: each batch contributes
    ``count x resource-vector`` per node run, folded into the same per-node
    fit checks as the object placements; committed batches are the runs on
    fitting nodes.

    ``reservations`` (optional) maps node id -> summed int64[4] debit of
    ACTIVE express capacity leases (server/express.py ReservationLedger;
    the caller excludes this plan's own lease). Debits fold into the ask
    on every touched node, so a slow-path plan cannot verify into
    capacity an uncommitted express placement holds — the
    reservation-aware half of the express lane's capacity-safety
    invariant. None/empty is decision-identical to the pre-express
    verifier."""
    import numpy as np

    result = PlanResult(
        node_update={},
        node_allocation={},
        failed_allocs=plan.failed_allocs,
    )

    # Per-node resource ask of the columnar placements, held by reference
    # and materialized per consumer (dense rows for the bulk verifier, a
    # lazy dict for the scalar fallback).
    batch_ask = _AskAccum()
    for b in plan.alloc_batches:
        vec = np.asarray(b.resource_vector(), dtype=np.int64)
        batch_ask.add_batch(b.node_ids, b.node_counts, vec,
                            src=b.src_hint)

    # In-place update batches contribute their per-node (new - old)
    # resource delta; delta-free nodes only need a liveness check. Wire-
    # received batches resolve ids against this snapshot first (stale ids
    # drop out -> partial commit). Old vectors are identity-counted: a
    # batch's allocs share a handful of Resources objects, so per-alloc
    # work is dict hits, not numpy.
    upd_nodes = set()
    for b in plan.update_batches:
        b.resolve(snap)
        new_vec = np.asarray(b.resource_vector(), dtype=np.int64)
        if b.src_node_ids:
            # Block-columnar form: one shared old vector, node runs as
            # columns — the whole batch is a single accumulator entry.
            upd_nodes.update(b.src_node_ids)
            old_vec = (
                np.asarray(b.src_resources.as_vector(), dtype=np.int64)
                if b.src_resources is not None
                else np.zeros(4, dtype=np.int64)
            )
            delta = new_vec - old_vec
            if np.any(delta):
                batch_ask.add_batch(
                    b.src_node_ids, b.src_node_counts, delta
                )
            continue
        # One old-vector per Resources identity (a batch's allocs share a
        # handful), node multiplicities per identity — then the whole
        # delta lands as ONE accumulator batch, expanded vectorized by
        # to_rows; no per-alloc numpy at all.
        res_vecs = {}
        per_res_counts: Dict[int, Dict[str, int]] = {}
        for a in b.allocs:
            upd_nodes.add(a.node_id)
            rid = id(a.resources)
            if rid not in res_vecs:
                res_vecs[rid] = (
                    np.asarray(a.resources.as_vector(), dtype=np.int64)
                    if a.resources is not None
                    else np.zeros(4, dtype=np.int64)
                )
            cnts = per_res_counts.setdefault(rid, {})
            cnts[a.node_id] = cnts.get(a.node_id, 0) + 1
        for rid, cnts in per_res_counts.items():
            delta = new_vec - res_vecs[rid]
            if np.any(delta):
                batch_ask.add_batch(
                    list(cnts.keys()), list(cnts.values()), delta
                )

    if reservations:
        # Restricted to nodes this plan touches: a lease elsewhere in
        # the cell must not drag untouched nodes into this plan's
        # verification (or flip an untouched node's fit to False and
        # bounce a plan that asked nothing of it).
        touched = (set(plan.node_allocation) | set(plan.node_update)
                   | set(batch_ask.node_ids) | upd_nodes)
        for run in plan.block_stops:
            touched.update(run.node_ids)
        for nid, vec in reservations.items():
            if nid in touched:
                batch_ask.add_delta(nid, vec)

    bulk_fit = {}
    n_placements = sum(len(v) for v in plan.node_allocation.values())
    n_placements += sum(b.n for b in plan.alloc_batches)
    n_placements += sum(b.n for b in plan.update_batches)
    if n_placements >= FAST_VERIFY_THRESHOLD:
        # The node table is only worth building (or cache-fetching) for
        # plans large enough to ride the bulk verifier.
        bulk_fit = _prevaluate_nodes_bulk(
            snap, plan, batch_ask, _node_table(snap)
        )

    def batch_res(node_id):
        vec = batch_ask.get(node_id)
        if vec is None:
            return None
        from nomad_tpu_torch.structs import Resources

        return Resources(
            cpu=int(vec[0]), memory_mb=int(vec[1]),
            disk_mb=int(vec[2]), iops=int(vec[3]),
        )

    fits = {}
    if (getattr(bulk_fit, "all_fit", False) and not upd_nodes
            and not plan.node_update and not plan.node_allocation):
        # The verifier already proved every asked node live and fitting
        # (and the plan has no delta-free update nodes needing their own
        # liveness check): commit whole without materializing the
        # per-node answer map or the id-set union at all.
        result.alloc_batches = [b for b in plan.alloc_batches if b.n]
        result.update_batches = [b for b in plan.update_batches if b.n]
        result.block_stops = list(plan.block_stops)
        return result
    # A node only a block stop run touches has nothing to check: stops
    # alone always fit (the evict-only rule of evaluate_node_plan).
    node_ids = (set(plan.node_update) | set(plan.node_allocation)
                | batch_ask.node_ids | upd_nodes)
    if (bulk_fit and len(bulk_fit) == len(node_ids)
            and all(bulk_fit.values())):
        # Bulk answered every node and every node fits — the common case
        # of a fresh large placement. Skip the 10k-iteration merge loop
        # and per-batch filter entirely: the plan commits whole.
        result.node_update = {k: v for k, v in plan.node_update.items() if v}
        result.node_allocation = {
            k: v for k, v in plan.node_allocation.items() if v
        }
        result.alloc_batches = [b for b in plan.alloc_batches if b.n]
        result.update_batches = [b for b in plan.update_batches if b.n]
        result.block_stops = list(plan.block_stops)
        return result
    for node_id in node_ids:
        fit = bulk_fit.get(node_id)
        if fit is None:
            if (node_id in upd_nodes
                    and not plan.node_allocation.get(node_id)
                    and node_id not in batch_ask.node_ids
                    and not plan.node_update.get(node_id)):
                fit = _node_live(snap, node_id)
            else:
                fit = evaluate_node_plan(snap, plan, node_id,
                                         batch_res(node_id))
                if fit and node_id in upd_nodes:
                    # evaluate_node_plan's evict-only shortcut skips the
                    # liveness check; re-stamped allocs need a live node.
                    fit = _node_live(snap, node_id)
        fits[node_id] = fit
        if not fit:
            # Stale scheduler data: force a refresh to the latest view.
            result.refresh_index = max(
                snap.get_index("nodes"), snap.get_index("allocs")
            )
            if plan.all_at_once:
                result.node_update = {}
                result.node_allocation = {}
                return result
            continue
        if plan.node_update.get(node_id):
            result.node_update[node_id] = plan.node_update[node_id]
        if plan.node_allocation.get(node_id):
            result.node_allocation[node_id] = plan.node_allocation[node_id]
    for b in plan.alloc_batches:
        kept = b.filter_nodes(fits)
        if kept.n:
            result.alloc_batches.append(kept)
    for b in plan.update_batches:
        kept = b.filter_nodes(fits)
        if kept.n:
            result.update_batches.append(kept)
    # A node that does not fit loses its stops with its placements.
    failed = {nid for nid, fit in fits.items() if not fit}
    for run in plan.block_stops:
        kept = run.without_nodes(failed)
        if kept.n:
            result.block_stops.append(kept)
    return result


def _object_allocs(result: PlanResult) -> list:
    """The object-row part of a committed plan. Columnar placement AND
    update batches stay columnar all the way into the state store
    (state/blocks.py; FSM applies update batches as block field swaps)."""
    allocs: list = []
    for update_list in result.node_update.values():
        allocs.extend(update_list)
    for alloc_list in result.node_allocation.values():
        allocs.extend(alloc_list)
    allocs.extend(result.failed_allocs)
    return allocs
