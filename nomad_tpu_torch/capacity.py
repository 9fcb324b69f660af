"""Capacity observatory: fragmentation accounting and stranded capacity.

Port of nomad_tpu/capacity.py, host numpy as there: an observer that
holds no tensor of the solver's and that no decision path imports.

Borg's utilization story (PAPERS.md) is cell compaction: the metric that
matters is not "how busy are the nodes" but "how much of the cell could
still host real work" — free capacity that exists in aggregate yet sits
on nodes too fragmented to fit an actual task shape is *stranded*, and
stranded-capacity % is the number the defragmentation arc (ROADMAP item
on continuous rescheduling) will be judged by. Until now nothing in the
agent measured it: the artifacts counted placements and latencies, and
``/v1/agent/*`` answered "how fast", never "how full, and how usable is
what's left".

:class:`CapacityAccountant` is the read-only observer that answers it.
Omega's shared-state posture (PAPERS.md): observers read cluster state
without perturbing decisions. The accountant is fed **incrementally from
the same state-store change streams the device mirror consumes**
(``state/store.py`` ``node_changes_since`` / ``alloc_node_changes_since``)
— on each poll only the dirty nodes' usage recomputes; a change set past
the bounded log horizon falls back to one full rebuild, counted, exactly
the mirror's roll-vs-rebuild economy. It holds NO hot-path hook, NO lock
any decision path takes, and the decision paths are statically barred
from importing it (nomadlint OBS001's rule): the observatory can see the
schedulers, the schedulers cannot see the observatory.

What it keeps, per poll generation:

- per-node totals / reserved / used vectors (RESOURCE_DIMS order) plus a
  schedulable flag (ready, not draining) — the same per-row accounting
  the mirror's base usage starts from;
- per-lane usage: ``service`` / ``batch`` / ``system`` by job type, with
  express-flagged jobs split into their own ``express`` lane (the
  admission front door's lane taxonomy, carried through to capacity);
- **fragmentation histograms**: per dimension, how many schedulable
  nodes sit in each free-fraction decile — the shape of the cell's
  leftover capacity;
- **stranded-capacity %** against seeded reference task shapes: for a
  shape ``s``, free capacity on nodes that cannot host even ONE copy of
  ``s`` is stranded with respect to it. Headline per shape =
  stranded/free on the cpu dimension; per-dim detail attached. Also
  ``placeable_count``: how many copies of ``s`` the cell could still
  host (Σ over nodes of min_d(free_d // s_d)) — the defrag arc's
  "placeable capacity reclaimed per migration" numerator.
- **bin-pack density**: used / capacity-of-occupied-nodes per dimension
  — how tightly the placed work is packed (1.0 = every occupied node
  full; churn shreds this long before aggregate utilization moves).

Surfaces: ``/v1/agent/capacity`` (JSON; ``?format=prometheus`` answers
501 until the telemetry sinks are ported), SDK
``client.agent().capacity()``, periodic ``Capacity``-topic event
snapshots (observer topic — excluded from the canonical determinism
digest by construction, ``events.OBSERVER_TOPICS``), and the scenario
artifact's ``capacity`` section.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from nomad_tpu_torch import telemetry
from nomad_tpu_torch.structs import NODE_STATUS_READY, RESOURCE_DIMS

# Lane taxonomy: the admission front door's batch/service distinction
# plus the express lane (an express-flagged batch job rides its own
# books there too) and system jobs.
LANES = ("service", "batch", "system", "express")

# Free-fraction deciles for the fragmentation histograms: bin i counts
# schedulable nodes with free/total in [i/10, (i+1)/10) (last bin closed).
FRAG_BINS = 10

# Seeded reference task shapes the stranded-capacity accounting measures
# against. Deliberately pinned (not sampled from live jobs): stranded %
# must be comparable across runs and against the banked defrag baseline,
# so the yardstick cannot drift with the workload. Override per
# deployment via the ``capacity { reference_shapes = [...] }`` block.
DEFAULT_REFERENCE_SHAPES: Tuple[Dict[str, int], ...] = (
    {"name": "small", "cpu": 100, "memory_mb": 128},
    {"name": "medium", "cpu": 500, "memory_mb": 512},
    {"name": "large", "cpu": 2000, "memory_mb": 2048},
)


def _shape_vec(shape: Dict[str, Any]) -> np.ndarray:
    return np.array(
        [int(shape.get(d, 0)) for d in RESOURCE_DIMS], dtype=np.int64
    )


@dataclass
class CapacityConfig:
    """The ``server { capacity { ... } }`` block, parse-time validated
    (the AdmissionConfig/ExpressConfig posture: typos and nonsense
    ranges fail config load, not first use)."""

    enabled: bool = True
    # Change-stream poll cadence. The observer tolerates any cadence —
    # a slow poll just rolls a bigger delta (or rebuilds past the log
    # horizon, counted).
    poll_interval: float = 1.0
    # Cadence of Capacity-topic event snapshots (0 disables). Observer
    # topic: excluded from the canonical event digest by construction.
    events_interval: float = 10.0
    reference_shapes: List[Dict[str, Any]] = field(
        default_factory=lambda: [dict(s) for s in DEFAULT_REFERENCE_SHAPES]
    )

    @classmethod
    def parse(cls, spec: Optional[Dict[str, Any]]) -> "CapacityConfig":
        if spec is None:
            return cls()
        if not isinstance(spec, dict):
            raise ValueError("capacity config must be a mapping")
        known = set(cls.__dataclass_fields__)
        unknown = [k for k in spec if k not in known]
        if unknown:
            raise ValueError(
                f"unknown capacity config key(s): {sorted(unknown)} "
                f"(have: {sorted(known)})"
            )
        out = cls(**{
            k: (bool(v) if k == "enabled"
                else list(v) if k == "reference_shapes"
                else float(v))
            for k, v in spec.items()
        })
        if out.poll_interval <= 0:
            raise ValueError("capacity.poll_interval must be > 0")
        if out.events_interval < 0:
            raise ValueError("capacity.events_interval must be >= 0")
        if not out.reference_shapes:
            raise ValueError("capacity.reference_shapes must be non-empty")
        for shape in out.reference_shapes:
            if not isinstance(shape, dict) or not shape.get("name"):
                raise ValueError(
                    "each reference shape needs at least a name, got "
                    f"{shape!r}"
                )
            vec = _shape_vec(shape)
            if not (vec > 0).any():
                raise ValueError(
                    f"reference shape {shape.get('name')!r} asks for "
                    "nothing (all dims 0)"
                )
        return out


def _lane_of(job) -> str:
    """The lane an allocation's usage books under: express-flagged jobs
    own their lane; otherwise the job type (service/batch/system)."""
    if job is None:
        return "batch"
    if getattr(job, "express", False):
        return "express"
    jtype = getattr(job, "type", "") or "batch"
    return jtype if jtype in LANES else "batch"


class CapacityAccountant:
    """Incremental per-node capacity books over a state store.

    Parallel numpy tables keyed by a node→row index (the mirror's
    layout): a node-change-log roll patches only the touched rows, an
    alloc-change-log roll recomputes usage only for the dirty nodes.
    All tables live under ``_lock``; readers (``snapshot()``) take the
    same lock — no decision path ever does.
    """

    def __init__(self, store_getter: Callable[[], Any],
                 config: Optional[CapacityConfig] = None,
                 events=None):
        self._store = store_getter
        self.config = config or CapacityConfig()
        self._events = events
        self._shapes = [
            (str(s["name"]), _shape_vec(s))
            for s in self.config.reference_shapes
        ]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Table state (under _lock). Rows are append-only within a
        # generation; removals free rows for reuse.
        self._reset_tables()
        # Roll-vs-rebuild economy (honest observability about the
        # observer itself).
        self.rolls = 0
        self.rebuilds = 0
        self.polls = 0
        self.events_published = 0

    # -- tables --------------------------------------------------------------

    def _reset_tables(self, cap: int = 64) -> None:
        self._uid = ""
        self._nodes_index = 0
        self._allocs_index = 0
        self._index: Dict[str, int] = {}
        self._free_rows: List[int] = []
        self._totals = np.zeros((cap, 4), dtype=np.int64)
        self._reserved = np.zeros((cap, 4), dtype=np.int64)
        self._sched = np.zeros(cap, dtype=bool)
        self._alive = np.zeros(cap, dtype=bool)
        # Per-lane usage + alloc counts (reserved is NOT a lane: it is
        # node-operator holdback, accounted separately).
        self._lane_used = {
            lane: np.zeros((cap, 4), dtype=np.int64) for lane in LANES
        }
        self._lane_count = {
            lane: np.zeros(cap, dtype=np.int64) for lane in LANES
        }

    def _grow(self) -> None:
        cap = self._totals.shape[0]
        new_cap = cap * 2

        def wide(a):
            out = np.zeros((new_cap,) + a.shape[1:], dtype=a.dtype)
            out[:cap] = a
            return out

        self._totals = wide(self._totals)
        self._reserved = wide(self._reserved)
        self._sched = wide(self._sched)
        self._alive = wide(self._alive)
        self._lane_used = {k: wide(v) for k, v in self._lane_used.items()}
        self._lane_count = {k: wide(v) for k, v in self._lane_count.items()}

    def _row_for(self, node_id: str) -> int:
        row = self._index.get(node_id)
        if row is not None:
            return row
        if self._free_rows:
            row = self._free_rows.pop()
        else:
            row = len(self._index) + len(self._free_rows)
            while row >= self._totals.shape[0]:
                self._grow()
        self._index[node_id] = row
        self._alive[row] = True
        return row

    def _set_node_row(self, node) -> None:
        row = self._row_for(node.id)
        self._totals[row] = (
            np.asarray(node.resources.as_vector(), dtype=np.int64)
            if node.resources is not None else 0
        )
        self._reserved[row] = (
            np.asarray(node.reserved.as_vector(), dtype=np.int64)
            if node.reserved is not None else 0
        )
        self._sched[row] = (
            node.status == NODE_STATUS_READY and not node.drain
        )

    def _drop_node_row(self, node_id: str) -> None:
        row = self._index.pop(node_id, None)
        if row is None:
            return
        self._alive[row] = False
        self._sched[row] = False
        self._totals[row] = 0
        self._reserved[row] = 0
        for lane in LANES:
            self._lane_used[lane][row] = 0
            self._lane_count[lane][row] = 0
        self._free_rows.append(row)

    # -- incremental refresh -------------------------------------------------

    def refresh(self) -> None:
        """One poll: roll the books forward through the store's change
        logs, or rebuild when the delta cannot be expressed (store
        replaced, log horizon passed). Safe to call from tests without
        the thread."""
        store = self._store()
        if store is None:
            return
        # Sample indexes BEFORE reading the logs: a concurrent write
        # after the sample lands in the next poll's delta, never lost.
        uid = getattr(store, "store_uid", "")
        nidx = store.get_index("nodes")
        aidx = store.get_index("allocs")
        with self._lock:
            self.polls += 1
            if not uid or uid != self._uid:
                self._rebuild_locked(store, uid, nidx, aidx)
                return
            if nidx == self._nodes_index and aidx == self._allocs_index:
                return
            node_changes = store.node_changes_since(self._nodes_index)
            dirty = store.alloc_node_changes_since(self._allocs_index)
            if node_changes is None or dirty is None:
                self._rebuild_locked(store, uid, nidx, aidx)
                return
            self.rolls += 1
            telemetry.incr_counter(("capacity", "rolls"))
            for _idx, node_id, kind in node_changes:
                if kind == "remove":
                    self._drop_node_row(node_id)
                    continue
                node = store.node_by_id(node_id)
                if node is None:
                    # Re-registered then removed inside the slice: the
                    # remove entry follows and drops the row.
                    continue
                self._set_node_row(node)
            if dirty:
                self._recompute_usage_locked(store, set(dirty))
            self._nodes_index = max(nidx, self._nodes_index)
            self._allocs_index = max(aidx, self._allocs_index)

    def _rebuild_locked(self, store, uid: str, nidx: int, aidx: int) -> None:
        self.rebuilds += 1
        telemetry.incr_counter(("capacity", "rebuilds"))
        self._reset_tables()
        self._uid = uid
        self._nodes_index = nidx
        self._allocs_index = aidx
        for node in store.nodes():
            self._set_node_row(node)
        self._recompute_usage_locked(store, None)

    def _recompute_usage_locked(self, store, dirty) -> None:
        """Recompute lane usage for ``dirty`` node ids (None = every
        resident node): zero the rows, then one pass over the object
        rows and one over the columnar blocks — O(dirty allocs + total
        block runs), the mirror's _usage_rows_bulk shape."""
        index_get = self._index.get
        if dirty is None:
            rows = [r for r in self._index.values()]
            dirty_ids = list(self._index)
        else:
            rows = []
            dirty_ids = []
            for nid in dirty:
                row = index_get(nid)
                if row is not None:
                    rows.append(row)
                    dirty_ids.append(nid)
        if not rows:
            return
        rows_arr = np.asarray(rows, dtype=np.int64)
        for lane in LANES:
            self._lane_used[lane][rows_arr] = 0
            self._lane_count[lane][rows_arr] = 0
        for nid, row in zip(dirty_ids, rows):
            for a in store.allocs_by_node_objects(nid):
                if a.terminal_status():
                    continue
                lane = _lane_of(a.job)
                if a.resources is not None:
                    self._lane_used[lane][row] += np.asarray(
                        a.resources.as_vector(), dtype=np.int64
                    )
                self._lane_count[lane][row] += 1
        in_dirty = np.zeros(self._totals.shape[0], dtype=bool)
        in_dirty[rows_arr] = True
        for blk in store.alloc_blocks():
            lane = _lane_of(blk.job)
            vec = (
                np.asarray(blk.resources.as_vector(), dtype=np.int64)
                if blk.resources is not None
                else np.zeros(4, dtype=np.int64)
            )
            for nid, cnt in blk.live_node_counts():
                row = index_get(nid)
                if row is None or not in_dirty[row]:
                    continue
                self._lane_used[lane][row] += vec * cnt
                self._lane_count[lane][row] += cnt

    # -- aggregates ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``/v1/agent/capacity`` body: per-dimension utilization,
        bin-pack density, per-lane usage, fragmentation histograms, and
        per-reference-shape stranded-capacity accounting — all computed
        over the SCHEDULABLE node set (ready, not draining)."""
        with self._lock:
            alive = self._alive
            sched = self._sched & alive
            n_alive = int(alive.sum())
            n_sched = int(sched.sum())
            totals = self._totals[sched]
            reserved = self._reserved[sched]
            used = reserved.copy()
            lanes_out: Dict[str, Any] = {}
            occupied_mask = np.zeros(totals.shape[0], dtype=bool)
            for lane in LANES:
                lu = self._lane_used[lane][sched]
                lc = self._lane_count[lane][sched]
                used += lu
                occupied_mask |= lc > 0
                lanes_out[lane] = {
                    "allocs": int(lc.sum()),
                    "used": {d: int(v) for d, v in
                             zip(RESOURCE_DIMS, lu.sum(axis=0))},
                }
            total_sum = totals.sum(axis=0)
            used_sum = used.sum(axis=0)
            free = np.maximum(totals - used, 0)
            free_sum = free.sum(axis=0)

            util = {
                d: round(float(u) / float(t), 6) if t else 0.0
                for d, u, t in zip(RESOURCE_DIMS, used_sum, total_sum)
            }
            # Bin-pack density: how full are the nodes that host work at
            # all. Churn strands capacity by spreading remnants across
            # many half-empty nodes — density drops while aggregate
            # utilization barely moves.
            occ_totals = totals[occupied_mask].sum(axis=0)
            occ_used = used[occupied_mask].sum(axis=0)
            density = {
                d: round(float(u) / float(t), 6) if t else 0.0
                for d, u, t in zip(RESOURCE_DIMS, occ_used, occ_totals)
            }

            # Fragmentation histograms: free-fraction deciles per dim
            # over schedulable nodes with capacity in that dim.
            frag: Dict[str, List[int]] = {}
            for di, dim in enumerate(RESOURCE_DIMS):
                has = totals[:, di] > 0
                if not has.any():
                    frag[dim] = [0] * FRAG_BINS
                    continue
                frac = free[has, di] / totals[has, di]
                bins = np.minimum(
                    (frac * FRAG_BINS).astype(np.int64), FRAG_BINS - 1
                )
                frag[dim] = np.bincount(
                    bins, minlength=FRAG_BINS
                ).tolist()

            # Stranded capacity per reference shape: free capacity on
            # nodes that cannot host even one copy of the shape.
            stranded_out = []
            for name, svec in self._shapes:
                ask_dims = svec > 0
                fits = np.all(
                    free[:, ask_dims] >= svec[ask_dims], axis=1
                ) if totals.shape[0] else np.zeros(0, dtype=bool)
                stranded_free = free[~fits].sum(axis=0)
                per_dim = {
                    d: round(float(s) / float(f), 6) if f else 0.0
                    for d, s, f in zip(RESOURCE_DIMS, stranded_free,
                                       free_sum)
                }
                # Copies of the shape the cell could still host.
                if totals.shape[0] and fits.any():
                    per_node = np.min(
                        free[fits][:, ask_dims] // svec[ask_dims], axis=1
                    )
                    placeable = int(per_node.sum())
                else:
                    placeable = 0
                stranded_out.append({
                    "shape": name,
                    "ask": {d: int(v) for d, v in zip(RESOURCE_DIMS, svec)
                            if v},
                    # Headline: the cpu dimension (first RESOURCE_DIM,
                    # the scarce currency of the sim workloads); per-dim
                    # detail alongside.
                    "stranded_pct": per_dim[RESOURCE_DIMS[0]],
                    "stranded_pct_by_dim": per_dim,
                    "placeable_count": placeable,
                    "nodes_fitting": int(fits.sum()),
                })

            return {
                "generation": {
                    "store_uid": self._uid,
                    "nodes_index": self._nodes_index,
                    "allocs_index": self._allocs_index,
                },
                "nodes": {
                    "total": n_alive,
                    "schedulable": n_sched,
                    "occupied": int(occupied_mask.sum()),
                },
                "dims": list(RESOURCE_DIMS),
                "total": {d: int(v) for d, v in
                          zip(RESOURCE_DIMS, total_sum)},
                "used": {d: int(v) for d, v in zip(RESOURCE_DIMS, used_sum)},
                "free": {d: int(v) for d, v in zip(RESOURCE_DIMS, free_sum)},
                "reserved": {d: int(v) for d, v in
                             zip(RESOURCE_DIMS, reserved.sum(axis=0))},
                "utilization": util,
                "binpack_density": density,
                "lanes": lanes_out,
                "fragmentation": {"bins": FRAG_BINS, "free_fraction": frag},
                "stranded": stranded_out,
                "accountant": {
                    "polls": self.polls,
                    "rolls": self.rolls,
                    "rebuilds": self.rebuilds,
                    "events_published": self.events_published,
                },
            }

    def summary(self) -> Dict[str, Any]:
        """Compact agent-info line: headline utilization + worst shape's
        stranded %."""
        snap = self.snapshot()
        worst = max(
            (s["stranded_pct"] for s in snap["stranded"]), default=0.0
        )
        return {
            "utilization": snap["utilization"],
            "stranded_pct_worst": worst,
            "nodes": snap["nodes"],
        }

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if not self.config.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="capacity-accountant"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        import time as _time

        next_event = (
            _time.monotonic() + self.config.events_interval
            if self.config.events_interval else None
        )
        while not self._stop.wait(self.config.poll_interval):
            try:
                self.refresh()
                if (next_event is not None
                        and _time.monotonic() >= next_event):
                    next_event = (
                        _time.monotonic() + self.config.events_interval
                    )
                    self.publish_event()
            except Exception:
                # The observer must never take the agent down; the poll
                # loop retries next tick. Counted, not silent.
                telemetry.incr_counter(("capacity", "poll_errors"))

    def publish_event(self) -> None:
        """One Capacity-topic snapshot event (trimmed payload). Observer
        topic: excluded from canonical event digests by construction
        (events.OBSERVER_TOPICS), so publishing cadence can never perturb
        the determinism contract."""
        if self._events is None:
            return
        snap = self.snapshot()
        self._events.publish(
            "Capacity", "CapacitySnapshot", key="capacity",
            payload={
                "utilization": snap["utilization"],
                "binpack_density": snap["binpack_density"],
                "stranded": [
                    {"shape": s["shape"],
                     "stranded_pct": s["stranded_pct"],
                     "placeable_count": s["placeable_count"]}
                    for s in snap["stranded"]
                ],
                "nodes": snap["nodes"],
            },
        )
        self.events_published += 1
