"""Columnar allocation blocks stored natively in the state store.

The reference stores every placement as an individual Allocation row
(upstream nomad/state/state_store.go:91-760). At TPU solve scale a
single evaluation places 100k tasks; exploding the solver's columnar output
(AllocBatch) into objects at the FSM boundary made commit, snapshot copy,
and every subsequent read O(placements). A StoredAllocBlock keeps the
columnar form *inside* the store: one table row per (eval, task group)
block, Allocation objects materialized lazily — per node for client
fetches, per id for individual addressing.

Invariants:
- Live blocks hold only non-terminal, desired=run allocations. Any write
  that individually addresses a block member (client status update,
  re-placement, an object-row eviction) *promotes* it: the member is
  excluded from the block and the superseding Allocation object lands in
  the object table.
- Terminal members live in stopped blocks (``StoppedAllocBlock``), a
  table of their own: a committed stop run of live members of one block
  moves them there as one block with the run's desired status, never
  through per-member object rows. Live reads (the block list, the mirror,
  plan verify) never see a stopped block; reads by id, job, node and eval
  materialize its members as the stop copies they stand for. A later
  write addressing a stopped member promotes it to an object row, as for
  a live member.
- Stored blocks are immutable; exclusion produces a copy sharing the column
  arrays (copy-on-write), so snapshots that captured the old table keep a
  consistent view.
- ``excluded`` is the one fact kept (pickled, sent) about which members
  are live. Every live read derives from it and two structures: the run
  layout (``_RunLayout``), built once per set of columns and shared by
  every copy over them, and the live members per run (None while nothing
  is excluded), which ``with_excluded`` derives from its parent's by
  binning the newly excluded positions. ``_derive`` decides what a copy
  shares.
- Once half a block's members are excluded, the store replaces it with a
  re-packed block of its live members (``repacked``): same block id, no
  exclusions, fresh columns. Live members never leave the columnar form
  for object rows that way, so a rolling job stays block-wise.

Semantically a block is exactly its ``materialize()`` expansion; the
differential tests in tests/test_torch_state_blocks.py and
tests/test_torch_state_stops.py hold the two forms equal.
"""

from __future__ import annotations

import bisect
from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

import numpy as np

from nomad_tpu_torch.structs import AllocBatch, Allocation, generate_uuid


class _RunLayout:
    """Each run's start and end, each node's total count (read-only) and
    every run of each node, of one set of columns: shared by every block
    over them, so by every snapshot and thread that reads one. The lazy
    per-node map is built whole, then published by one assignment."""

    __slots__ = ("node_ids", "counts", "ends", "start_of", "end_of",
                 "totals", "_by_node")

    def __init__(self, node_ids: List[str], node_counts: List[int]):
        self.node_ids = node_ids
        self.counts = np.asarray(node_counts, dtype=np.int64).reshape(-1)
        self.ends = np.cumsum(self.counts)
        # Python lists for the scalar reads (a bisection, a node's runs).
        self.end_of: List[int] = self.ends.tolist()
        self.start_of: List[int] = (self.ends - self.counts).tolist()
        self.totals = _summed(zip(node_ids, self.counts.tolist()))
        self._by_node: Optional[Dict[str, List[int]]] = None

    def runs_of(self, node_id: str) -> Optional[List[int]]:
        """Every run index of ``node_id``, ascending, or None. The map
        builds on the first per-node read: the placement and stop paths,
        which run every round of a roll, never ask."""
        by_node = self._by_node
        if by_node is None:
            by_node = {}
            for r, nid in enumerate(self.node_ids):
                by_node.setdefault(nid, []).append(r)
            self._by_node = by_node
        return by_node.get(node_id)

    def less(self, live: np.ndarray, positions) -> np.ndarray:
        """``live`` (members per run) less ``positions``, binned by run:
        O(positions × log runs) besides the subtraction."""
        pos = np.fromiter(positions, dtype=np.int64, count=len(positions))
        runs = np.searchsorted(self.ends, pos, side="right")
        return live - np.bincount(runs, minlength=len(live))


def _fields(batch: AllocBatch) -> dict:
    """The constructor fields of ``batch``, its columns shared."""
    return dict(
        eval_id=batch.eval_id, job=batch.job, tg_name=batch.tg_name,
        resources=batch.resources, task_resources=batch.task_resources,
        metrics=batch.metrics, node_ids=batch.node_ids,
        node_counts=batch.node_counts, name_idx=batch.name_idx,
        ids_hex=batch._ids_hex or "", ids_seed=batch.ids_seed,
    )


def _summed(pairs) -> Dict[str, int]:
    """(node id, count) pairs summed per node."""
    out: Dict[str, int] = {}
    for nid, cnt in pairs:
        out[nid] = out.get(nid, 0) + cnt
    return out


class StoredAllocBlock(AllocBatch):
    """An AllocBatch as committed state: indexes stamped, exclusions
    tracked, lazy lookup structures."""

    __slots__ = (
        "block_id", "job_id", "create_index", "modify_index", "excluded",
        "_id_pos", "_layout", "_live", "_materialized",
    )

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.block_id = ""
        self.job_id = self.job.id if self.job is not None else ""
        self.create_index = 0
        self.modify_index = 0
        self.excluded: FrozenSet[int] = frozenset()
        self._no_caches()

    def _no_caches(self) -> None:
        # Derived from the fields above, each built on first use.
        self._id_pos: Optional[Dict[str, int]] = None
        self._layout: Optional[_RunLayout] = None
        self._live: Optional[np.ndarray] = None
        self._materialized: Optional[List[Allocation]] = None

    @classmethod
    def from_batch(cls, batch: AllocBatch, index: int) -> "StoredAllocBlock":
        blk = cls(**_fields(batch))
        # Deterministic across replicas: every FSM applying this log entry
        # derives the same block id (the first member's alloc id —
        # alloc_id(0) expands only the seed's 16-byte prefix, so a
        # seed-form batch stays lazy through commit).
        blk.block_id = batch.alloc_id(0) if batch.n else generate_uuid()
        blk.create_index = index
        blk.modify_index = index
        return blk

    # -- the live view ----------------------------------------------------

    @property
    def n_live(self) -> int:
        return self.n - len(self.excluded)

    def _runs(self) -> _RunLayout:
        if self._layout is None:
            self._layout = _RunLayout(self.node_ids, self.node_counts)
        return self._layout

    def _live_per_run(self) -> np.ndarray:
        """Live members per run: the layout's counts less ``excluded``."""
        if not self.excluded:
            return self._runs().counts
        live = self._live
        if live is None:
            layout = self._runs()
            live = self._live = layout.less(layout.counts, self.excluded)
        return live

    def _live_mask(self) -> np.ndarray:
        live = np.ones(self.n, dtype=bool)
        if self.excluded:
            live[np.fromiter(self.excluded, dtype=np.int64,
                             count=len(self.excluded))] = False
        return live

    def _spans(self, runs=None) -> Iterator[Tuple[str, int, int]]:
        """(node id, start, end) of each run holding a live member, in run
        order: of every run, or of the run indices ``runs``. Lazy: a
        reader that stops early walks only the runs it takes."""
        layout = self._runs()
        live = self._live_per_run()
        node_ids, start_of, end_of = self.node_ids, layout.start_of, \
            layout.end_of
        for r in range(len(end_of)) if runs is None else runs:
            if live[r]:
                yield node_ids[r], start_of[r], end_of[r]

    def live_runs(self) -> Tuple[List[str], List[int]]:
        """(node ids, live counts) of the runs holding a live member, in
        run order, as two columns — the form the vectorised readers (plan
        verification's row cache, in-place admission) take. A block with
        no exclusion hands back its columns themselves (empty runs
        included), not copies."""
        if not self.excluded:
            return self.node_ids, self.node_counts
        live = self._live_per_run()
        keep = np.flatnonzero(live)
        return ([self.node_ids[r] for r in keep.tolist()],
                live[keep].tolist())

    def live_node_counts(self) -> Iterator[Tuple[str, int]]:
        """``live_runs`` as (node_id, live count) pairs — the form the
        per-run folds and the benchmark's observers read."""
        return zip(*self.live_runs())

    def live_counts_map(self) -> Dict[str, int]:
        """node_id → total live member count, a node's runs summed.
        Read-only: a block with no exclusion hands back its layout's map,
        built once and shared by the copies over its columns."""
        if not self.excluded:
            return self._runs().totals
        return _summed(self.live_node_counts())

    def live_positions(self) -> List[int]:
        """Run-ordered positions of live (non-excluded) members."""
        return np.flatnonzero(self._live_mask()).tolist()

    def live_name_idx(self) -> np.ndarray:
        """Name indices of the live members, run-ordered: the column
        itself for a block with no exclusion."""
        if not self.excluded:
            return self.name_idx
        return self.name_idx[self._live_mask()]

    def live_members(self) -> Iterator[Tuple[str, str]]:
        """(alloc id, node id) of each live member, in run order."""
        excluded = self.excluded
        for nid, start, end in self._spans():
            for i in range(start, end):
                if i not in excluded:
                    yield self.alloc_id(i), nid

    def node_of_pos(self, pos: int) -> str:
        """Node id owning position ``pos``: a bisection over the layout's
        run ends, so promoting every member of a block to an object row
        (a job's stop) costs O(n log runs), not O(n runs)."""
        end_of = self._runs().end_of
        if pos < 0 or not end_of or pos >= end_of[-1]:
            return ""
        return self.node_ids[bisect.bisect_right(end_of, pos)]

    # -- lookup -----------------------------------------------------------

    def find(self, alloc_id: str) -> Optional[int]:
        """Position of a member id, or None (excluded members don't count).
        The id→pos dict builds lazily on first individual addressing."""
        idx = self._id_pos
        if idx is None:
            idx = dict(zip(self.alloc_ids(), range(self.n)))
            self._id_pos = idx
        pos = idx.get(alloc_id)
        if pos is None or pos in self.excluded:
            return None
        return pos

    # -- materialization (template/span logic inherited from AllocBatch) --

    def materialize_node(self, node_id: str) -> List[Allocation]:
        """The live members on ``node_id``, from every run of the node."""
        runs = self._runs().runs_of(node_id)
        if runs is None:
            return []
        out: List[Allocation] = []
        template = self._template()
        for nid, start, end in self._spans(runs):
            self._materialize_span(template, nid, start, end, out)
        return out

    def materialize_prefix(self, k: int) -> List[Allocation]:
        """Materialize the first ``k`` LIVE members (run-ordered, excluded
        positions skipped) — the rolling-update eviction slice. Span ends
        are bounded by remaining need so a dense single-node run never
        materializes past k: O(k + excluded-in-prefix + runs touched)."""
        out: List[Allocation] = []
        template = self._template()
        for nid, start, end_run in self._spans():
            if len(out) >= k:
                break
            while start < end_run and len(out) < k:
                # Each chunk asks for exactly the remaining need; excluded
                # positions inside it yield fewer, and the loop advances.
                end = min(end_run, start + (k - len(out)))
                self._materialize_span(template, nid, start, end, out)
                start = end
        return out

    def stop_prefix(self, k: int, status: str,
                    description: str) -> "BlockStopRun":
        """The first ``k`` live members (``materialize_prefix(k)``'s, in
        its order) as one stop run of this block: positions and their
        node runs from the run layout, no Allocation built."""
        if self.excluded:
            positions = np.flatnonzero(self._live_mask())[:k]
        else:
            positions = np.arange(min(k, self.n), dtype=np.int64)
        return self.stop_run(positions, status, description)

    def stop_run(self, positions, status: str,
                 description: str) -> "BlockStopRun":
        """The live members at ``positions`` (in the order given) as one
        stop run of this block."""
        positions = np.asarray(positions, dtype=np.int64)
        runs = np.searchsorted(self._runs().ends, positions, side="right")
        # One entry a run touched: its node and the members it gives.
        starts = np.flatnonzero(np.diff(runs, prepend=-1))
        counts = np.diff(starts, append=positions.size)
        node_ids = self.node_ids
        return BlockStopRun(self, positions,
                            [node_ids[r] for r in runs[starts].tolist()],
                            counts.tolist(), status, description)

    def same_columns(self, other: "StoredAllocBlock") -> bool:
        """Whether ``other`` is over this block's columns (a copy that
        excluded members or swapped fields), so positions name the same
        members in both; a re-packed or rebuilt block is not."""
        return (self.name_idx is other.name_idx
                and self.node_ids is other.node_ids)

    def materialize_pos(self, pos: int) -> Allocation:
        out: List[Allocation] = []
        self._materialize_span(
            self._template(), self.node_of_pos(pos), pos, pos + 1, out
        )
        return out[0]

    def materialize(self) -> List[Allocation]:
        # Cached per block: the columns are immutable, and scheduler reads
        # of a committed job (diff against existing allocs) repeat — reads
        # must not pay the expansion more than once. COW exclusion copies
        # don't share the cache (their member set differs).
        cached = self._materialized
        if cached is None:
            cached = []
            template = self._template()
            for nid, start, end in self._spans():
                self._materialize_span(template, nid, start, end, cached)
            self._materialized = cached
        return cached

    def with_update(self, job, resources, task_resources, metrics,
                    eval_id: str, index: int) -> "StoredAllocBlock":
        """A copy with the shared fields swapped — the whole-block in-place
        update (reference semantics: every member re-stamps with the new
        job version, util.go:316-398, but as ONE O(1) field swap instead
        of n row rewrites). Columns, ids, names, and placement stay;
        None/empty update fields preserve the old values, exactly like the
        per-row re-stamp (AllocUpdateBatch.materialize)."""
        blk = self._derive(
            eval_id=eval_id, job=job if job is not None else self.job,
            resources=resources if resources is not None else self.resources,
            task_resources=task_resources or self.task_resources,
            metrics=metrics,
        )
        blk.job_id = job.id if job is not None else self.job_id
        blk.modify_index = index
        return blk

    # -- copy-on-write exclusion ------------------------------------------

    def with_excluded(self, positions) -> "StoredAllocBlock":
        """A copy of this block with ``positions`` additionally excluded,
        over the same columns."""
        return self._derive(exclude=frozenset(positions) - self.excluded)

    def repacked(self) -> "StoredAllocBlock":
        """A fresh block of the live members alone, with no exclusions:
        the same block id, job, group, resources, metrics, eval and
        indexes, the columns of ``_gathered``. A pure function of the
        block, so every replica applying the same entries re-packs alike."""
        return self._derive(columns=self._gathered(self._live_mask()))

    def stopped(self, positions, status: str, description: str,
                index: int) -> "StoppedAllocBlock":
        """The live members at ``positions`` as one stopped block, the
        stop copies of a run committed at ``index``: this block's job,
        eval, group, resources, metrics, create index, names and ids, the
        run's desired status and description, ``modify_index`` = index.
        All the live members keep these columns and exclusions as they
        are; a part of them is gathered (``_gathered``).
        Its id is its first member's alloc id: a member is stopped
        columnar once, so the id is unique and every replica derives it."""
        if len(positions) == self.n_live:
            blk = self._derive(StoppedAllocBlock)
            first = next(i for i in range(self.n) if i not in self.excluded)
        else:
            keep = np.zeros(self.n, dtype=bool)
            keep[np.fromiter(positions, dtype=np.int64,
                             count=len(positions))] = True
            blk = self._derive(StoppedAllocBlock,
                               columns=self._gathered(keep))
            first = 0
        blk.block_id = blk.alloc_id(first)
        blk.modify_index = index
        blk.desired_status = status
        blk.desired_description = description
        return blk

    def _gathered(self, keep) -> dict:
        """The columns of the positions where ``keep`` (a bool mask over
        the block) is set, in run order: node runs recomputed (adjacent
        runs on one node merged, emptied runs dropped), name indices and
        ids gathered. The ids are no longer a prefix of one seed, so the
        column is explicit hex."""
        kept_before = np.concatenate(([0], np.cumsum(keep)))
        per_run = np.diff(kept_before[self._runs().ends], prepend=0)
        node_ids: List[str] = []
        node_counts: List[int] = []
        for nid, cnt in zip(self.node_ids, per_run.tolist()):
            if not cnt:
                continue
            if node_ids and node_ids[-1] == nid:
                node_counts[-1] += cnt
            else:
                node_ids.append(nid)
                node_counts.append(cnt)
        pos = np.flatnonzero(keep)
        ids = np.frombuffer(self.ids_hex.encode("ascii"), dtype="S32")[pos]
        return {"node_ids": node_ids, "node_counts": node_counts,
                "name_idx": self.name_idx[pos],
                "ids_hex": ids.tobytes().decode("ascii"), "ids_seed": None}

    def _derive(self, cls=None, columns=None, exclude=frozenset(),
                **fields) -> "StoredAllocBlock":
        """A block of class ``cls`` (this one's by default) with this
        block's id, job, indexes and kind's fields, ``fields`` (AllocBatch
        fields) swapped in: the one place that decides what a copy shares.
        Over new ``columns`` (``_gathered``), nothing; over these, the
        layout (built first, so every copy holds the one) and the id
        index, with ``exclude`` (live positions) excluded besides."""
        kw = _fields(self)
        kw.update(columns or {})
        kw.update(fields)
        blk = (cls or type(self))(**kw)
        blk.block_id = self.block_id
        blk.job_id = self.job_id
        blk.create_index = self.create_index
        blk.modify_index = self.modify_index
        self._carry(blk)
        if columns is None:
            blk._layout = self._runs()
            blk._id_pos = self._id_pos
            blk.excluded, blk._live = self.excluded, self._live
            if exclude:
                blk.excluded = self.excluded | exclude
                live = self._live_per_run()
                # A block left with no live member is deleted unread.
                blk._live = (blk._layout.less(live, exclude) if blk.n_live
                             else np.zeros_like(live))
        return blk

    def _carry(self, blk: "StoredAllocBlock") -> None:
        """Copy this kind's own fields onto ``blk`` (none for a live
        block)."""

    # -- persistence (FSM snapshot stream) --------------------------------

    _PICKLE_SLOTS = (
        "eval_id", "job", "tg_name", "resources", "task_resources",
        "metrics", "node_ids", "node_counts", "name_idx", "ids_seed",
        "block_id", "job_id", "create_index", "modify_index", "excluded",
    )

    def __getstate__(self):
        """Pickle the columns only: a block that has served one
        materialize() read carries an O(placements) object cache that must
        never re-inflate a raft snapshot. The id column follows the same
        rule — a seed-form block pickles its 16-byte seed and the restore
        re-derives; only a block built from explicit hex (wire compat)
        carries the expansion."""
        state = {k: getattr(self, k) for k in self._PICKLE_SLOTS}
        state["_ids_hex"] = None if self.ids_seed is not None \
            else self._ids_hex
        return state

    def __setstate__(self, state):
        for k in self._PICKLE_SLOTS:
            setattr(self, k, state.get(k))
        # Legacy pickles carried the expanded column under "ids_hex".
        self._ids_hex = state.get("_ids_hex", state.get("ids_hex"))
        if self._ids_hex is None and self.ids_seed is None:
            self._ids_hex = ""
        self._no_caches()

    def to_wire(self) -> dict:
        d = super().to_wire()
        d["block_id"] = self.block_id
        d["create_index"] = self.create_index
        d["modify_index"] = self.modify_index
        d["excluded"] = sorted(self.excluded)
        return d

    @staticmethod
    def from_wire(d: dict) -> "StoredAllocBlock":
        blk = StoredAllocBlock.from_batch(AllocBatch.from_wire(d), 0)
        blk.block_id = d.get("block_id") or generate_uuid()
        blk.create_index = int(d.get("create_index", 0))
        blk.modify_index = int(d.get("modify_index", 0))
        blk.excluded = frozenset(d.get("excluded") or ())
        return blk


class StoppedAllocBlock(StoredAllocBlock):
    """Terminal members of one stored block, stopped by one run of one
    committed entry: every member reads as the stop copy the object path
    would have written (the run's desired status and description, the
    entry's index as ``modify_index``). Kept in the store's table of
    stopped blocks, apart from the live ones; ``excluded`` and ``n_live``
    speak of its members as for a live block."""

    __slots__ = ("desired_status", "desired_description")

    _PICKLE_SLOTS = StoredAllocBlock._PICKLE_SLOTS + (
        "desired_status", "desired_description",
    )

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.desired_status = ""
        self.desired_description = ""

    def _carry(self, blk: "StoredAllocBlock") -> None:
        blk.desired_status = self.desired_status
        blk.desired_description = self.desired_description

    def _template(self) -> dict:
        template = super()._template()
        template["desired_status"] = self.desired_status
        template["desired_description"] = self.desired_description
        return template


class BlockStopRun:
    """A plan's stops of live members of one stored block, carried as one
    run from the reconcile to the FSM: the source block, the members'
    positions in it (run order) and, an entry a node run they fall in,
    the node and the members it gives; the desired status and
    description of every member's stop copy. Semantically the run is its
    ``materialize()`` expansion, the stop copies ``Plan.append_update``
    would have made. Readers account it as columns; the wire and the
    journal carry it as an id run (``id_run``), which the FSM resolves
    against its own store as it does any stop ids."""

    __slots__ = ("block", "positions", "node_ids", "node_counts",
                 "desired_status", "desired_description")

    def __init__(self, block: StoredAllocBlock, positions: np.ndarray,
                 node_ids: List[str], node_counts: List[int],
                 desired_status: str, desired_description: str):
        self.block = block
        self.positions = positions
        self.node_ids = node_ids
        self.node_counts = node_counts
        self.desired_status = desired_status
        self.desired_description = desired_description

    @property
    def n(self) -> int:
        return int(self.positions.size)

    @property
    def block_id(self) -> str:
        return self.block.block_id

    @property
    def job_id(self) -> str:
        return self.block.job_id

    @property
    def tg_name(self) -> str:
        return self.block.tg_name

    @property
    def resources(self):
        return self.block.resources

    @property
    def task_resources(self):
        return self.block.task_resources

    def members(self) -> Iterator[Tuple[int, str]]:
        """(position, node id) of each member, in run order."""
        pos = self.positions.tolist()
        i = 0
        for nid, cnt in zip(self.node_ids, self.node_counts):
            for p in pos[i:i + cnt]:
                yield p, nid
            i += cnt

    def alloc_ids(self) -> List[str]:
        """The members' alloc ids, from the block's id column."""
        return self.block.alloc_ids(self.positions)

    def id_run(self) -> dict:
        """The run as ``structs.stop_runs`` writes stop copies' ids: the
        form of the raft entry and the RPC tier."""
        return {"desired_status": self.desired_status,
                "desired_description": self.desired_description,
                "ids": self.alloc_ids()}

    def materialize(self) -> List[Allocation]:
        """The stop copies the run stands for, for the readers that take
        objects (the scheduler's per-node view, test harnesses)."""
        blk = self.block
        template = blk._template()
        template["desired_status"] = self.desired_status
        template["desired_description"] = self.desired_description
        out: List[Allocation] = []
        for p, nid in self.members():
            blk._materialize_span(template, nid, p, p + 1, out)
        return out

    def without_nodes(self, nodes) -> "BlockStopRun":
        """The run less its members on ``nodes`` (a partial commit's
        failed nodes): self where none is there."""
        keep = [nid not in nodes for nid in self.node_ids]
        if all(keep):
            return self
        mask = np.repeat(np.asarray(keep, dtype=bool),
                         np.asarray(self.node_counts, dtype=np.int64))
        return BlockStopRun(
            self.block, self.positions[mask],
            [nid for nid, k in zip(self.node_ids, keep) if k],
            [cnt for cnt, k in zip(self.node_counts, keep) if k],
            self.desired_status, self.desired_description)

    def live_counts(self, state) -> np.ndarray:
        """Members per entry still live in ``state``'s blocks: all of them
        while the state holds the source block itself; members a later
        write excluded (promoted, stopped) count nothing, and in a
        re-packed block each member is found by its id."""
        counts = np.asarray(self.node_counts, dtype=np.int64)
        blk = state.alloc_block_by_id(self.block_id)
        if blk is self.block:
            return counts
        if blk is None:
            return np.zeros_like(counts)
        if blk.same_columns(self.block):
            excluded = blk.excluded
            live = [p not in excluded for p in self.positions.tolist()]
        else:
            alloc_id = self.block.alloc_id
            live = [blk.find(alloc_id(p)) is not None
                    for p in self.positions.tolist()]
        if not counts.size:
            return counts
        starts = np.cumsum(counts) - counts
        return np.add.reduceat(np.asarray(live, dtype=np.int64), starts)


    def live_rows(self, state, row_of) -> Tuple[np.ndarray, np.ndarray]:
        """Where the run gives usage back: (rows, members) of each entry
        with a member still live in ``state``'s blocks (``live_counts``)
        and a row, ``row_of(node id, -1)``; both int64. Staging and every
        verify path scatter the run's usage from this one reader."""
        rows = np.fromiter((row_of(nid, -1) for nid in self.node_ids),
                           dtype=np.int64, count=len(self.node_ids))
        counts = self.live_counts(state)
        keep = (rows >= 0) & (counts > 0)
        return rows[keep], counts[keep]
