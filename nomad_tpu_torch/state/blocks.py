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
- Blocks hold only non-terminal, desired=run allocations. Any write that
  individually addresses a block member (client status update, eviction,
  re-placement) *promotes* it: the member is excluded from the block and
  the superseding Allocation object lands in the object table.
- Stored blocks are immutable; exclusion produces a copy sharing the column
  arrays (copy-on-write), so snapshots that captured the old table keep a
  consistent view. Lazy caches (id→position, node→run) are shared across
  copies — the columns they index never change.

Semantically a block is exactly its ``materialize()`` expansion; the
differential tests in tests/test_alloc_batch.py and tests/test_state.py
hold the two forms equal.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

from nomad_tpu_torch.structs import AllocBatch, Allocation, generate_uuid


class StoredAllocBlock(AllocBatch):
    """An AllocBatch as committed state: indexes stamped, exclusions
    tracked, lazy lookup structures."""

    __slots__ = (
        "block_id", "job_id", "create_index", "modify_index", "excluded",
        "_id_pos", "_node_run", "_live_counts", "_materialized",
    )

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.block_id = ""
        self.job_id = self.job.id if self.job is not None else ""
        self.create_index = 0
        self.modify_index = 0
        self.excluded: FrozenSet[int] = frozenset()
        self._id_pos: Optional[Dict[str, int]] = None
        self._node_run: Optional[Dict[str, Tuple[int, int]]] = None
        self._live_counts: Optional[Dict[str, int]] = None
        self._materialized: Optional[List[Allocation]] = None

    @classmethod
    def from_batch(cls, batch: AllocBatch, index: int) -> "StoredAllocBlock":
        blk = cls(
            eval_id=batch.eval_id, job=batch.job, tg_name=batch.tg_name,
            resources=batch.resources, task_resources=batch.task_resources,
            metrics=batch.metrics, node_ids=batch.node_ids,
            node_counts=batch.node_counts, name_idx=batch.name_idx,
            ids_hex=batch._ids_hex or "", ids_seed=batch.ids_seed,
        )
        # Deterministic across replicas: every FSM applying this log entry
        # derives the same block id (the first member's alloc id —
        # alloc_id(0) expands only the seed's 16-byte prefix, so a
        # seed-form batch stays lazy through commit).
        blk.block_id = batch.alloc_id(0) if batch.n else generate_uuid()
        blk.create_index = index
        blk.modify_index = index
        return blk

    # -- liveness ---------------------------------------------------------

    @property
    def n_live(self) -> int:
        return self.n - len(self.excluded)

    def node_runs(self) -> Dict[str, Tuple[int, int]]:
        """node_id → (start, count) over the run-length encoding."""
        runs = self._node_run
        if runs is None:
            runs = {}
            pos = 0
            for nid, cnt in zip(self.node_ids, self.node_counts):
                runs[nid] = (pos, cnt)
                pos += cnt
            self._node_run = runs
        return runs

    def node_of_pos(self, pos: int) -> str:
        """Node id owning position ``pos`` of the run-length encoding."""
        scan = 0
        for nid, cnt in zip(self.node_ids, self.node_counts):
            if scan <= pos < scan + cnt:
                return nid
            scan += cnt
        return ""

    def live_counts_map(self) -> Dict[str, int]:
        """node_id → total live member count, duplicate runs summed
        (``node_runs`` keeps only a node's LAST run). Cached — blocks are
        immutable, exclusion replaces the object — so per-node usage
        recomputes (the mirror's base-usage roll forward) pay one O(runs)
        build per block, then dict hits."""
        counts = self._live_counts
        if counts is None:
            counts = {}
            for nid, cnt in self.live_node_counts():
                counts[nid] = counts.get(nid, 0) + cnt
            self._live_counts = counts
        return counts

    def live_node_counts(self) -> Iterator[Tuple[str, int]]:
        """(node_id, live placement count) per run — the columnar usage
        feed for plan verification and the device mirror."""
        if not self.excluded:
            yield from zip(self.node_ids, self.node_counts)
            return
        pos = 0
        for nid, cnt in zip(self.node_ids, self.node_counts):
            # nomadlint: allow(DET003) -- commutative membership count
            # (sum of 1s): the iteration order of the set cannot change
            # the result.
            live = cnt - sum(1 for p in self.excluded if pos <= p < pos + cnt)
            if live:
                yield nid, live
            pos += cnt

    # -- lookup -----------------------------------------------------------

    def find(self, alloc_id: str) -> Optional[int]:
        """Position of a member id, or None (excluded members don't count).
        The id→pos dict builds lazily on first individual addressing."""
        idx = self._id_pos
        if idx is None:
            idx = {self.alloc_id(i): i for i in range(self.n)}
            self._id_pos = idx
        pos = idx.get(alloc_id)
        if pos is None or pos in self.excluded:
            return None
        return pos

    # -- materialization (template/span logic inherited from AllocBatch) --

    def materialize_node(self, node_id: str) -> List[Allocation]:
        run = self.node_runs().get(node_id)
        if run is None:
            return []
        out: List[Allocation] = []
        start, cnt = run
        self._materialize_span(self._template(), node_id, start, start + cnt, out)
        return out

    def materialize_prefix(self, k: int) -> List[Allocation]:
        """Materialize the first ``k`` LIVE members (run-ordered, excluded
        positions skipped) — the rolling-update eviction slice. Span ends
        are bounded by remaining need so a dense single-node run never
        materializes past k: O(k + excluded-in-prefix + runs touched)."""
        out: List[Allocation] = []
        template = self._template()
        pos = 0
        for nid, cnt in zip(self.node_ids, self.node_counts):
            if len(out) >= k:
                break
            start, end_run = pos, pos + cnt
            while start < end_run and len(out) < k:
                # Each chunk asks for exactly the remaining need; excluded
                # positions inside it yield fewer, and the loop advances.
                end = min(end_run, start + (k - len(out)))
                self._materialize_span(template, nid, start, end, out)
                start = end
            pos = end_run
        return out

    def live_positions(self) -> List[int]:
        """Run-ordered positions of live (non-excluded) members."""
        if not self.excluded:
            return list(range(self.n))
        excluded = self.excluded
        return [i for i in range(self.n) if i not in excluded]

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
            pos = 0
            for nid, cnt in zip(self.node_ids, self.node_counts):
                self._materialize_span(template, nid, pos, pos + cnt, cached)
                pos += cnt
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
        blk = StoredAllocBlock(
            eval_id=eval_id, job=job if job is not None else self.job,
            tg_name=self.tg_name,
            resources=resources if resources is not None else self.resources,
            task_resources=task_resources or self.task_resources,
            metrics=metrics, node_ids=self.node_ids,
            node_counts=self.node_counts, name_idx=self.name_idx,
            ids_hex=self._ids_hex or "", ids_seed=self.ids_seed,
        )
        blk.block_id = self.block_id
        blk.job_id = job.id if job is not None else self.job_id
        blk.create_index = self.create_index
        blk.modify_index = index
        blk.excluded = self.excluded
        blk._id_pos = self._id_pos
        blk._node_run = self._node_run
        blk._live_counts = self._live_counts  # same members, same counts
        return blk

    # -- copy-on-write exclusion ------------------------------------------

    def with_excluded(self, positions) -> "StoredAllocBlock":
        """A copy of this block with ``positions`` additionally excluded.
        Columns and lazy caches are shared — they never change."""
        blk = StoredAllocBlock(
            eval_id=self.eval_id, job=self.job, tg_name=self.tg_name,
            resources=self.resources, task_resources=self.task_resources,
            metrics=self.metrics, node_ids=self.node_ids,
            node_counts=self.node_counts, name_idx=self.name_idx,
            ids_hex=self._ids_hex or "", ids_seed=self.ids_seed,
        )
        blk.block_id = self.block_id
        blk.job_id = self.job_id
        blk.create_index = self.create_index
        blk.modify_index = self.modify_index
        blk.excluded = self.excluded | frozenset(positions)
        blk._id_pos = self._id_pos
        blk._node_run = self._node_run
        return blk

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
        self._id_pos = None
        self._node_run = None
        self._live_counts = None
        self._materialized = None

    def to_wire(self) -> dict:
        d = super().to_wire()
        d["block_id"] = self.block_id
        d["create_index"] = self.create_index
        d["modify_index"] = self.modify_index
        d["excluded"] = sorted(self.excluded)
        return d

    @staticmethod
    def from_wire(d: dict) -> "StoredAllocBlock":
        base = AllocBatch.from_wire(d)
        blk = StoredAllocBlock(
            eval_id=base.eval_id, job=base.job, tg_name=base.tg_name,
            resources=base.resources, task_resources=base.task_resources,
            metrics=base.metrics, node_ids=base.node_ids,
            node_counts=base.node_counts, name_idx=base.name_idx,
            ids_hex=base._ids_hex or "", ids_seed=base.ids_seed,
        )
        blk.block_id = d.get("block_id") or generate_uuid()
        blk.create_index = int(d.get("create_index", 0))
        blk.modify_index = int(d.get("modify_index", 0))
        blk.excluded = frozenset(d.get("excluded") or ())
        return blk
