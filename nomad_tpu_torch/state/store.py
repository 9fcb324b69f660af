"""In-memory MVCC state store with snapshots and watch/notify.

Fresh design with the capabilities of the reference's go-memdb-backed
StateStore (upstream nomad/state/state_store.go:28-815, schema at
nomad/state/schema.go:10-188, notify at nomad/state/notify.go):

- tables: ``index``, ``nodes``, ``jobs``, ``evals``, ``allocs``
- secondary indexes: allocs by (job, node, eval), evals by job
  (jobs-by-scheduler-type is a scan; the jobs table stays small)
- copy-on-write ``snapshot()`` giving an immutable point-in-time view
- per-item watch registration powering blocking queries
- ``restore()`` bulk loader used by snapshot/FSM restore

Instead of radix trees we keep plain dicts whose *container* is copied on
snapshot; stored objects are immutable by convention (callers pass ownership
on upsert and must not mutate afterwards — the same contract go-memdb
enforces, state_store.go:25-27).
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from nomad_tpu_torch.state.blocks import StoppedAllocBlock, StoredAllocBlock
from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    AllocBatch,
    Allocation,
    Evaluation,
    Job,
    Node,
    expand_stop_runs,
    generate_uuid,
)

# A watch item is a (kind, key) tuple, e.g. ("table", "nodes"),
# ("alloc_node", node_id). Mirrors nomad/watch/watch.go:11-37.
WatchItem = Tuple[str, str]

# Bounded change-log horizons (entries retained after a trim; trims fire at
# twice this length). Consumers holding tensors built at index N ask "what
# changed since N" and delta-patch instead of rebuilding (the device mirror,
# nomad_tpu/tpu/mirror.py); a log that no longer reaches back to N returns
# None and the consumer falls back to a full rebuild. The node horizon is
# sized for steady heartbeat/registration churn at 10k nodes; the alloc log
# holds one entry PER WRITE (a plan commit is one entry carrying its touched
# node ids), so a smaller entry count covers many plans.
NODE_LOG_HORIZON = 4096
ALLOC_LOG_HORIZON = 1024


def _log_node_change(t: "_Tables", index: int, node_id: str,
                     kind: str) -> None:
    """Append one node-table delta (lock held by the caller). ``kind`` is
    "insert" (new key), "update" (existing key re-written in place, dict
    order preserved) or "remove" — the distinction the mirror's roll
    forward needs to prove dict-iteration order didn't move. Trims rebind
    the list so snapshots sharing the old reference stay consistent."""
    log = t.node_log
    log.append((index, node_id, kind))
    if len(log) > 2 * NODE_LOG_HORIZON:
        t.node_log_floor = log[-NODE_LOG_HORIZON - 1][0]
        t.node_log = log[-NODE_LOG_HORIZON:]


def _log_alloc_nodes(t: "_Tables", index: int, node_ids) -> None:
    """Append one allocs-table delta: the node ids whose usage this write
    may have changed (lock held by the caller). One entry per write — a
    100k-placement plan commit is a single entry sharing the batch's id
    list, not 10k appends."""
    if not node_ids:
        return
    log = t.alloc_log
    log.append((index, tuple(node_ids)))
    if len(log) > 2 * ALLOC_LOG_HORIZON:
        t.alloc_log_floor = log[-ALLOC_LOG_HORIZON - 1][0]
        t.alloc_log = log[-ALLOC_LOG_HORIZON:]


def partition_node_changes(changes, rows_get, resolve):
    """Interpret a node change-log slice for a delta consumer holding
    rows keyed by ``rows_get`` (node_id → row or None). ``resolve``
    returns a node's current form, or None when it left the consumer's
    set. THE one interpreter of the log's (index, node_id, kind)
    semantics, shared by the device mirror and the plan applier's node
    table so the two can never diverge on the same feed.

    Returns ``(patches, appends)`` — in-place row rewrites and dict-tail
    appends (sorted in re-insertion order, which IS the store's
    iteration order for new keys) — or None when the slice can't be
    expressed as a delta: a resident node left the set or had its dict
    key re-inserted (its row, or iteration order, moves), or a
    pre-existing key entered the set mid-order."""
    last_insert: Dict[str, int] = {}
    removed: Set[str] = set()
    order: List[str] = []
    seen: Set[str] = set()
    for pos, (_idx, node_id, kind) in enumerate(changes):
        if node_id not in seen:
            seen.add(node_id)
            order.append(node_id)
        if kind == "remove":
            removed.add(node_id)
        elif kind == "insert":
            last_insert[node_id] = pos
    patches: List[Tuple[int, Node]] = []
    appends: List[Tuple[int, Node]] = []
    for node_id in order:
        node = resolve(node_id)
        row = rows_get(node_id)
        if row is not None:
            if node is None or node_id in removed:
                return None
            patches.append((row, node))
        elif node is not None:
            pos = last_insert.get(node_id)
            if pos is None:
                return None
            appends.append((pos, node))
        # else: irrelevant to this consumer's set.
    appends.sort()
    return patches, appends


def item_table(name: str) -> WatchItem:
    return ("table", name)


def item_node(node_id: str) -> WatchItem:
    return ("node", node_id)


def item_job(job_id: str) -> WatchItem:
    return ("job", job_id)


def item_eval(eval_id: str) -> WatchItem:
    return ("eval", eval_id)


def item_alloc(alloc_id: str) -> WatchItem:
    """Single-alloc watch item. Granularity contract: individual
    operations (object-row writes, per-member promotion/deletion) fire
    this; BULK columnar transitions (block commit, whole-block in-place
    swap, whole-eval reap) fire only container items (job/eval/node) —
    per-member fan-out would cost O(placements) per commit. Endpoints that
    long-poll one alloc must watch its node or job item."""
    return ("alloc", alloc_id)


def item_alloc_node(node_id: str) -> WatchItem:
    return ("alloc_node", node_id)


def item_alloc_job(job_id: str) -> WatchItem:
    return ("alloc_job", job_id)


def item_alloc_eval(eval_id: str) -> WatchItem:
    return ("alloc_eval", eval_id)


class _WatchTicket:
    """One registration's receipt: the items watched and the bucket
    generations sampled at registration time. ``_Watch.wait`` returns once
    any of the buckets moves past its sampled generation (or on timeout).
    Opaque to callers; built by ``_Watch.register``."""

    __slots__ = ("items", "buckets", "gens", "multi", "multi_gen")

    def __init__(self, items, buckets, gens, multi, multi_gen):
        self.items = items
        self.buckets = buckets
        self.gens = gens
        self.multi = multi
        self.multi_gen = multi_gen


class _Watch:
    """Coalesced index-bucketed watch registry (reference analog:
    nomad/state/notify.go — but redesigned for 50k-watcher fan-out).

    The original design kept one ``threading.Event`` per watcher per item;
    a publish then iterated and ``set()`` every parked event under one
    registry lock — O(watchers) Python work on the WRITER (often the FSM
    apply thread). At 50k blocking watchers of a hot item that is a
    multi-millisecond wake storm per write, paid by the control plane's
    hottest path (measured in tests/test_wake_storm.py).

    Here every WatchItem hashes into one of ``NUM_BUCKETS`` buckets, each
    a (generation counter, Condition) pair. A publish bumps the touched
    buckets' generations and ``notify_all``s their conditions — O(touched
    items), independent of watcher count. Watchers sample their buckets'
    generations at registration and park on the bucket condition; a
    generation moving past the sample is the wake. Items sharing a bucket
    cause spurious wakes (the waiter re-probes its index and re-parks —
    the blocking_query loop already does exactly that), never missed
    ones.

    No-lost-wakeup protocol (the same register-then-recheck discipline
    blocking.py always carried): a waiter must ``register`` (sampling
    generations) BEFORE its final index probe. A writer mutates state
    BEFORE notifying. Then either the writer's notify lands after the
    sample (generation moves, waiter wakes) or it landed before (so the
    mutation is visible to the post-sample probe and the waiter never
    parks).

    Multi-item registrations spanning several buckets (rare: multi-topic
    event filters) cannot park on several conditions at once; they park
    on one shared side channel (``_multi_cond``) which every notify also
    bumps while such waiters exist.

    Registrations are BOUNDED: ``max_watchers`` > 0 makes ``register``
    raise a typed ``RejectError(WATCH_LIMIT)`` past the cap — the same
    cheap-rejection machinery the admission front door uses
    (nomad_tpu/server/admission.py), so a watcher flood degrades into
    fast 503s instead of unbounded registry growth.
    """

    NUM_BUCKETS = 64

    def __init__(self, max_watchers: int = 0) -> None:
        self._conds = tuple(
            threading.Condition() for _ in range(self.NUM_BUCKETS)
        )
        self._gens = [0] * self.NUM_BUCKETS
        self._multi_cond = threading.Condition()
        self._multi_gen = 0
        self._multi_waiters = 0
        # Registration metadata (watcher count, kind counts, cap).
        self._meta_lock = threading.Lock()
        self._kind_counts: Dict[str, int] = {}
        self._watchers = 0
        self.max_watchers = int(max_watchers)
        # Loss-free counters (ints under the GIL; read for stats/gauges).
        self.rejected = 0
        self.notifies = 0
        self.peak_watchers = 0
        # Wake-economy books (read_observe.py drains them; plain data —
        # this module must never import the observatory, OBS001):
        # per-bucket occupancy, total waiters woken by notifies, and
        # spurious wakes (callers bump after a woke-but-index-unmoved
        # re-probe — the bucket-sharing cost this registry trades for
        # O(touched-items) publishes).
        self.bucket_watchers = [0] * self.NUM_BUCKETS
        self.wakes_delivered = 0
        self.spurious_wakes = 0

    @staticmethod
    def _bucket(item: WatchItem) -> int:
        # crc32, not hash(): per-process salted str hashing would make
        # bucket spread (and thus spurious-wake behavior) vary run to run.
        return zlib.crc32(
            ("%s\x00%s" % item).encode()
        ) % _Watch.NUM_BUCKETS

    # -- registration ------------------------------------------------------

    def register(self, items: Iterable[WatchItem]) -> _WatchTicket:
        """Register a watcher on ``items``; returns the ticket ``wait``
        consumes. Must be called BEFORE the caller's final index probe
        (see the class protocol note). Raises RejectError(WATCH_LIMIT)
        when the registration cap is reached."""
        items = list(items)
        buckets = sorted({self._bucket(item) for item in items})
        with self._meta_lock:
            if self.max_watchers and self._watchers >= self.max_watchers:
                self.rejected += 1
                from nomad_tpu_torch.structs import REJECT_WATCH_LIMIT, RejectError

                raise RejectError(
                    REJECT_WATCH_LIMIT,
                    f"blocking-watcher cap reached "
                    f"({self._watchers}/{self.max_watchers})",
                    retry_after=0.5,
                )
            self._watchers += 1
            if self._watchers > self.peak_watchers:
                self.peak_watchers = self._watchers
            for item in items:
                self._kind_counts[item[0]] = (
                    self._kind_counts.get(item[0], 0) + 1
                )
            for b in buckets:
                self.bucket_watchers[b] += 1
        multi = len(buckets) > 1
        multi_gen = 0
        if multi:
            # Count BEFORE sampling generations: a writer reads the count
            # after bumping bucket gens, so it either sees us (and bumps
            # the side channel) or bumped before our sample (and the
            # mutation is visible to our post-sample probe).
            with self._multi_cond:
                self._multi_waiters += 1
                multi_gen = self._multi_gen
        gens = []
        for b in buckets:
            with self._conds[b]:
                gens.append(self._gens[b])
        return _WatchTicket(items, buckets, gens, multi, multi_gen)

    def unregister(self, ticket: _WatchTicket) -> None:
        with self._meta_lock:
            self._watchers -= 1
            for item in ticket.items:
                n = self._kind_counts.get(item[0], 0) - 1
                if n <= 0:
                    self._kind_counts.pop(item[0], None)
                else:
                    self._kind_counts[item[0]] = n
            for b in ticket.buckets:
                self.bucket_watchers[b] -= 1
        if ticket.multi:
            with self._multi_cond:
                self._multi_waiters -= 1

    def wait(self, ticket: _WatchTicket,
             timeout: Optional[float] = None) -> bool:
        """Park until any of the ticket's buckets is notified past its
        sampled generation, or ``timeout`` lapses. Returns True when a
        (possibly spurious, bucket-shared) notification woke us, False on
        timeout. Callers re-probe their index either way."""
        import time as _time

        deadline = (
            _time.monotonic() + timeout if timeout is not None else None
        )
        if not ticket.multi:
            b = ticket.buckets[0]
            gen0 = ticket.gens[0]
            cond = self._conds[b]
            with cond:
                while self._gens[b] == gen0:
                    if deadline is None:
                        cond.wait()
                        continue
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        return False
                    cond.wait(remaining)
            return True
        with self._multi_cond:
            while True:
                if self._multi_gen != ticket.multi_gen:
                    return True
                # Bucket generations read without their locks: plain int
                # reads under the GIL; the registration protocol covers
                # the race (see class docstring).
                if any(
                    self._gens[b] != g
                    for b, g in zip(ticket.buckets, ticket.gens)
                ):
                    return True
                if deadline is None:
                    self._multi_cond.wait()
                    continue
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._multi_cond.wait(remaining)

    # -- introspection ------------------------------------------------------

    def has_waiters_for(self, kind: str) -> bool:
        """True when any waiter is registered on an item of ``kind``.

        ORDERING CONTRACT for writers using this to skip item building:
        sample it AFTER the table mutation is visible. Then a waiter that
        registered too late for the (skipped) notify runs its first query
        against post-write state and doesn't need the wakeup; sampling
        BEFORE the write would lose the wakeup of a waiter registering
        during it."""
        return self._kind_counts.get(kind, 0) > 0

    def stats(self) -> Dict[str, object]:
        with self._meta_lock:
            bucket_watchers = list(self.bucket_watchers)
            watchers = self._watchers
        return {
            "watchers": watchers,
            "peak_watchers": self.peak_watchers,
            "max_watchers": self.max_watchers,
            "rejected": self.rejected,
            "notifies": self.notifies,
            "buckets": self.NUM_BUCKETS,
            "bucket_watchers": bucket_watchers,
            "wakes_delivered": self.wakes_delivered,
            "spurious_wakes": self.spurious_wakes,
            "multi_waiters": self._multi_waiters,
        }

    # -- notification -------------------------------------------------------

    def notify(self, items: Iterable[WatchItem]) -> None:
        # Unlocked emptiness probe: safe ONLY because blocking queries
        # re-check the index after registering (register-then-recheck in
        # blocking.py), so a waiter that races this read never depends on
        # the missed wakeup. A free-threaded build keeping that protocol
        # keeps the safety; move the check under the meta lock if the
        # protocol ever changes.
        if not self._watchers:
            return
        self.notifies += 1
        seen = 0
        for item in items:
            b = self._bucket(item)
            bit = 1 << b
            if seen & bit:
                continue
            seen |= bit
            # Fan-out accounting: every waiter parked on this bucket is
            # about to wake (plain int read under the GIL, the loss-free
            # counter posture above).
            self.wakes_delivered += self.bucket_watchers[b]
            cond = self._conds[b]
            with cond:
                self._gens[b] += 1
                cond.notify_all()
        if self._multi_waiters:
            self.wakes_delivered += self._multi_waiters
            with self._multi_cond:
                self._multi_gen += 1
                self._multi_cond.notify_all()

    def notify_all(self) -> None:
        """Wake every parked watcher. Fired when this store is replaced
        wholesale (raft snapshot install rebinds fsm.state) so blocking
        queries re-check against the live store instead of sleeping out
        their timeout on an orphaned one."""
        for b in range(self.NUM_BUCKETS):
            cond = self._conds[b]
            with cond:
                self._gens[b] += 1
                cond.notify_all()
        with self._multi_cond:
            self._multi_gen += 1
            self._multi_cond.notify_all()


class _Tables:
    """The raw table containers. Snapshots shallow-copy these dicts."""

    def __init__(self) -> None:
        self.indexes: Dict[str, int] = {}
        self.nodes: Dict[str, Node] = {}
        self.jobs: Dict[str, Job] = {}
        self.evals: Dict[str, Evaluation] = {}
        self.allocs: Dict[str, Allocation] = {}
        # Columnar allocation blocks (state/blocks.py): one row per
        # (eval, task group) block instead of one per placement. ``live``
        # holds the live blocks; ``stopped`` the terminal members a
        # committed stop run took out of a live block, one row per (source
        # block, run), never read as live (StoppedAllocBlock).
        self.live = _BlockTable()
        self.stopped = _BlockTable()
        # Secondary indexes: id sets keyed by foreign key.
        self.evals_by_job: Dict[str, Set[str]] = {}
        self.allocs_by_job: Dict[str, Set[str]] = {}
        self.allocs_by_node: Dict[str, Set[str]] = {}
        self.allocs_by_eval: Dict[str, Set[str]] = {}
        # Non-terminal OBJECT rows per job — the O(1) gate for block-level
        # reconciles (a rolling update accumulates terminal stop rows that
        # a scan-based gate would re-walk on every eval). Maintained by
        # _insert_alloc_row/_replace_alloc_row/the GC pop.
        self.live_objs_by_job: Dict[str, int] = {}
        # Bounded change logs (index-ascending). ``*_floor`` is the highest
        # index whose entries may have been trimmed away: a consumer
        # rolling forward from N has complete coverage iff N >= floor.
        self.node_log: List[Tuple[int, str, str]] = []
        self.node_log_floor: int = 0
        self.alloc_log: List[Tuple[int, Tuple[str, ...]]] = []
        self.alloc_log_floor: int = 0

    def copy(self) -> "_Tables":
        new = _Tables()
        new.indexes = dict(self.indexes)
        new.nodes = dict(self.nodes)
        new.jobs = dict(self.jobs)
        new.evals = dict(self.evals)
        new.allocs = dict(self.allocs)
        new.live = self.live.copy()
        new.stopped = self.stopped.copy()
        new.evals_by_job = {k: set(v) for k, v in self.evals_by_job.items()}
        new.allocs_by_job = {k: set(v) for k, v in self.allocs_by_job.items()}
        new.allocs_by_node = {k: set(v) for k, v in self.allocs_by_node.items()}
        new.allocs_by_eval = {k: set(v) for k, v in self.allocs_by_eval.items()}
        new.live_objs_by_job = dict(self.live_objs_by_job)
        # Logs are SHARED by reference: between trims they're append-only
        # (list.append is atomic under the GIL, and readers filter by
        # index, so post-snapshot appends are invisible to them); a trim
        # rebinds the LIVE tables' attribute, leaving this copy's
        # reference — and its matching floor — intact.
        new.node_log = self.node_log
        new.node_log_floor = self.node_log_floor
        new.alloc_log = self.alloc_log
        new.alloc_log_floor = self.alloc_log_floor
        return new


class _StateView:
    """Read methods shared by the live store and snapshots. Implements the
    scheduler State interface (reference: scheduler/scheduler.go:55-71)."""

    _t: _Tables

    # -- nodes ------------------------------------------------------------

    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._t.nodes.get(node_id)

    def nodes(self) -> List[Node]:
        return list(self._t.nodes.values())

    # -- jobs -------------------------------------------------------------

    def job_by_id(self, job_id: str) -> Optional[Job]:
        return self._t.jobs.get(job_id)

    def jobs(self) -> List[Job]:
        return list(self._t.jobs.values())

    def jobs_by_scheduler(self, scheduler_type: str) -> List[Job]:
        """Jobs by type, backing system-job fan-out on node updates
        (state_store.go schema "type" index; node_endpoint.go:459)."""
        return [j for j in self._t.jobs.values() if j.type == scheduler_type]

    # -- evals ------------------------------------------------------------

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._t.evals.get(eval_id)

    def evals(self) -> List[Evaluation]:
        return list(self._t.evals.values())

    def evals_by_job(self, job_id: str) -> List[Evaluation]:
        ids = self._t.evals_by_job.get(job_id, set())
        return [self._t.evals[i] for i in ids]

    # -- allocs -----------------------------------------------------------

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        t = self._t
        alloc = t.allocs.get(alloc_id)
        if alloc is not None:
            return alloc
        for table in (t.live, t.stopped):
            found = table.find(alloc_id)
            if found is not None:
                bid, pos = found
                return table.by_id[bid].materialize_pos(pos)
        return None

    def allocs(self) -> List[Allocation]:
        out = list(self._t.allocs.values())
        for blk in self._all_blocks():
            out.extend(blk.materialize())
        return out

    def alloc_count(self) -> int:
        """Cheap table cardinality (used by the solver's clean-state fast
        path to skip usage tensorization entirely): object rows and the
        members of live and stopped blocks, as an object table holding
        every stop copy would count them."""
        return len(self._t.allocs) + sum(
            blk.n_live for blk in self._all_blocks()
        )

    def _all_blocks(self) -> List[StoredAllocBlock]:
        return [*self._t.live.by_id.values(), *self._t.stopped.by_id.values()]

    def alloc_blocks(self) -> List[StoredAllocBlock]:
        """Live columnar blocks — the no-materialization read for plan
        verification and the device mirror."""
        return list(self._t.live.by_id.values())

    def alloc_block_by_id(self, block_id: str
                          ) -> Optional[StoredAllocBlock]:
        """The live block of ``block_id``, or None."""
        return self._t.live.by_id.get(block_id)

    def stopped_alloc_blocks(self) -> List[StoppedAllocBlock]:
        """Stopped blocks: terminal members held columnar, which no live
        read (alloc_blocks, job_alloc_blocks) returns."""
        return list(self._t.stopped.by_id.values())

    def allocs_objects(self) -> List[Allocation]:
        """Object-table rows only (the complement of alloc_blocks() and
        stopped_alloc_blocks())."""
        return list(self._t.allocs.values())

    def nodes_with_object_allocs(self) -> Set[str]:
        """Node ids holding at least one object-table alloc row — lets the
        vectorized plan verifier walk objects only where objects exist."""
        return {nid for nid, ids in self._t.allocs_by_node.items() if ids}

    def allocs_by_job(self, job_id: str) -> List[Allocation]:
        t = self._t
        out = [t.allocs[i] for i in t.allocs_by_job.get(job_id, ())]
        for table in (t.live, t.stopped):
            for bid in table.by_job.get(job_id, ()):
                out.extend(table.by_id[bid].materialize())
        return out

    def has_allocs_for_job(self, job_id: str) -> bool:
        """Existence check WITHOUT materializing columnar blocks — the
        guard fast paths (fresh-registration detection) need only the
        answer, not 100k Allocation objects."""
        t = self._t
        return bool(t.allocs_by_job.get(job_id) or t.live.by_job.get(job_id)
                    or t.stopped.by_job.get(job_id))

    def job_has_object_allocs(self, job_id: str) -> bool:
        """Whether any NON-TERMINAL allocations of the job live as object
        rows (vs columnar blocks) — the O(1) gate for fully block-level
        reconciles (counter maintained at every row write). Terminal rows
        (stopped/evicted/failed) are invisible to the five-way diff, so a
        mid-rolling-update job whose stops accumulated as objects still
        reconciles block-wise."""
        return self._t.live_objs_by_job.get(job_id, 0) > 0

    def job_alloc_blocks(self, job_id: str) -> List["StoredAllocBlock"]:
        """The job's stored columnar blocks, un-materialized."""
        live = self._t.live
        return [live.by_id[bid] for bid in live.by_job.get(job_id, ())]

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        out = self.allocs_by_node_objects(node_id)
        for blk in self._all_blocks():
            out.extend(blk.materialize_node(node_id))
        return out

    def allocs_by_node_objects(self, node_id: str) -> List[Allocation]:
        """Object-table rows only: callers that account block usage
        columnar (plan verification, mirror) read this plus alloc_blocks()
        instead of paying per-node materialization."""
        ids = self._t.allocs_by_node.get(node_id, set())
        return [self._t.allocs[i] for i in ids]

    def allocs_by_eval(self, eval_id: str) -> List[Allocation]:
        t = self._t
        out = [t.allocs[i] for i in t.allocs_by_eval.get(eval_id, ())]
        for table in (t.live, t.stopped):
            for bid in table.by_eval.get(eval_id, ()):
                out.extend(table.by_id[bid].materialize())
        return out

    # -- change logs (delta consumers: the device mirror) -----------------

    def node_changes_since(self, index: int) -> Optional[
            List[Tuple[int, str, str]]]:
        """Node-table deltas ``(index, node_id, kind)`` with index in
        ``(index, this view's nodes index]``, oldest first — the feed for
        NodeMirror.apply_delta. Returns None when the bounded log no
        longer reaches back to ``index`` (the consumer must rebuild)."""
        t = self._t
        # Read the list BEFORE the floor: the trim writes floor first,
        # then rebinds the list, so this order can pessimize (old list,
        # new floor → spurious None) but never read a trimmed list
        # against a stale floor.
        log = t.node_log
        if index < t.node_log_floor:
            return None
        my = self.get_index("nodes")
        out: List[Tuple[int, str, str]] = []
        for i in range(len(log) - 1, -1, -1):
            e = log[i]
            if e[0] <= index:
                break
            if e[0] <= my:
                out.append(e)
        out.reverse()
        return out

    def alloc_node_changes_since(self, index: int) -> Optional[Set[str]]:
        """Node ids whose allocation usage may have changed after
        ``index`` (up to this view's allocs index), or None past the log
        horizon. Feeds the mirror's base-usage roll forward."""
        t = self._t
        # List-before-floor read order: see node_changes_since.
        log = t.alloc_log
        if index < t.alloc_log_floor:
            return None
        my = self.get_index("allocs")
        out: Set[str] = set()
        for i in range(len(log) - 1, -1, -1):
            e = log[i]
            if e[0] <= index:
                break
            if e[0] <= my:
                out.update(e[1])
        return out

    def alloc_object_by_id(self, alloc_id: str) -> Optional[Allocation]:
        """Object-table row only (no block materialization) — the cheap
        'was this id counted as an object row' probe the mirror's usage
        plan-delta needs."""
        return self._t.allocs.get(alloc_id)

    def allocs_by_job_objects(self, job_id: str) -> List[Allocation]:
        """Object-table rows of one job (complement of
        job_alloc_blocks()) — lets per-eval job/tg counting walk the
        job's own allocs instead of the whole cluster."""
        ids = self._t.allocs_by_job.get(job_id, ())
        return [self._t.allocs[i] for i in ids]

    # -- indexes ----------------------------------------------------------

    def get_index(self, table: str) -> int:
        """Latest commit index that modified ``table``
        (state_store.go Index table)."""
        return self._t.indexes.get(table, 0)

    def latest_index(self) -> int:
        return max(self._t.indexes.values(), default=0)


class StateSnapshot(_StateView):
    """Immutable point-in-time view (reference: state_store.go:54-66).

    Also supports *optimistic* local mutation (upsert_allocs) so the plan
    applier can pipeline verification of plan N+1 against the effects of
    plan N before Raft applies it (plan_apply.go:100-117); snapshots are
    private to their creator so this never races.
    """

    def __init__(self, tables: _Tables, store_uid: str = ""):
        self._t = tables
        # Identity of the originating live store: device-mirror caches key
        # on (store_uid, table index) so snapshots of one store share warm
        # tensors while distinct stores never collide (SURVEY.md §7
        # "state mirror keyed by a state-store generation").
        self.store_uid = store_uid
        # Set once this snapshot diverges from its store via optimistic
        # writes: its index-stamps then name content the shared change
        # logs don't describe, so generation-keyed caches (the mirror's
        # base usage) must neither trust deltas from it nor cache it.
        self.optimistic = False

    # The plan applier attaches allocs optimistically; reuse the same
    # write-side helpers against the snapshot's private tables.
    def upsert_allocs(self, index: int, allocs: List[Allocation]) -> None:
        self.optimistic = True
        _upsert_allocs(self._t, index, allocs)

    def upsert_alloc_blocks(self, index: int, batches) -> None:
        # Optimistic snapshot writes never notify: skip item building.
        self.optimistic = True
        _upsert_alloc_blocks(self._t, index, batches)

    def apply_update_batches(self, index: int, batches) -> None:
        self.optimistic = True
        _apply_update_batches(self._t, index, batches)

    def stop_block_members(self, index: int, runs):
        """The live store's ``stop_block_members`` on these private
        tables: (the stopped blocks, the stop copies for upsert_allocs)."""
        self.optimistic = True
        stopped, rest = _stop_block_members(self._t, index, runs)
        return stopped, expand_stop_runs(rest, self.alloc_by_id)


class StateRestore:
    """Bulk loader used by FSM snapshot restore
    (reference: state_store.go:767-815)."""

    def __init__(self, store: "StateStore"):
        self._store = store
        self._tables = _Tables()

    def node_restore(self, node: Node) -> None:
        self._tables.nodes[node.id] = node
        self._tables.indexes["nodes"] = max(
            self._tables.indexes.get("nodes", 0), node.modify_index
        )

    def job_restore(self, job: Job) -> None:
        self._tables.jobs[job.id] = job
        self._tables.indexes["jobs"] = max(
            self._tables.indexes.get("jobs", 0), job.modify_index
        )

    def eval_restore(self, ev: Evaluation) -> None:
        self._tables.evals[ev.id] = ev
        self._tables.evals_by_job.setdefault(ev.job_id, set()).add(ev.id)
        self._tables.indexes["evals"] = max(
            self._tables.indexes.get("evals", 0), ev.modify_index
        )

    def alloc_restore(self, alloc: Allocation) -> None:
        t = self._tables
        _insert_alloc_row(t, alloc)
        t.indexes["allocs"] = max(
            t.indexes.get("allocs", 0), alloc.modify_index
        )

    def block_restore(self, block: StoredAllocBlock) -> None:
        self._block_restore(self._tables.live, block)

    def stopped_block_restore(self, block: StoppedAllocBlock) -> None:
        self._block_restore(self._tables.stopped, block)

    def _block_restore(self, table: "_BlockTable",
                       block: StoredAllocBlock) -> None:
        table.add(block)
        t = self._tables
        t.indexes["allocs"] = max(
            t.indexes.get("allocs", 0), block.modify_index
        )

    def index_restore(self, table: str, index: int) -> None:
        self._tables.indexes[table] = index

    def commit(self) -> None:
        self._store._install(self._tables)


def _promote_stopped_members(t: _Tables, alloc_ids,
                             touched: Optional[Set[str]] = None) -> None:
    """Move the stopped-block members among ``alloc_ids`` (ids that are
    neither object rows nor live block members) to object rows, each as
    the stop copy it reads as, ahead of a write that addresses them: a
    client update, a second stop, an in-place re-stamp."""
    stopped = t.stopped
    if not stopped.by_id:
        return
    members: Dict[str, Set[int]] = {}
    for alloc_id in alloc_ids:
        found = stopped.find(alloc_id)
        if found is None:
            continue
        bid, pos = found
        if pos in members.get(bid, ()):
            continue
        members.setdefault(bid, set()).add(pos)
        alloc = stopped.by_id[bid].materialize_pos(pos)
        _insert_alloc_row(t, alloc)
        if touched is not None:
            touched.add(alloc.node_id)
    if members:
        stopped.exclude(members)


def _decr_live_objs(t: _Tables, job_id: str) -> None:
    n = t.live_objs_by_job.get(job_id, 0) - 1
    if n > 0:
        t.live_objs_by_job[job_id] = n
    else:
        t.live_objs_by_job.pop(job_id, None)


def _insert_alloc_row(t: _Tables, alloc: Allocation) -> None:
    prev = t.allocs.get(alloc.id)
    if prev is not None and not prev.terminal_status():
        _decr_live_objs(t, prev.job_id)
    if not alloc.terminal_status():
        t.live_objs_by_job[alloc.job_id] = (
            t.live_objs_by_job.get(alloc.job_id, 0) + 1
        )
    t.allocs[alloc.id] = alloc
    t.allocs_by_job.setdefault(alloc.job_id, set()).add(alloc.id)
    t.allocs_by_node.setdefault(alloc.node_id, set()).add(alloc.id)
    t.allocs_by_eval.setdefault(alloc.eval_id, set()).add(alloc.id)


def _status_of(run) -> Tuple[str, str]:
    """(desired status, description) of an id run or a block stop run."""
    if isinstance(run, dict):
        return run["desired_status"], run["desired_description"]
    return run.desired_status, run.desired_description


def _find_live_members(t: _Tables, ids, taken: Dict[str, Set[int]]
                       ) -> Tuple[Dict[str, List[int]], List[str]]:
    """The ids that name live block members not yet ``taken`` (which
    they join), as positions a block in the ids' order; and every other
    id (an object row, no live member, one named twice)."""
    groups: Dict[str, List[int]] = {}
    left: List[str] = []
    for alloc_id in ids:
        found = None if alloc_id in t.allocs else t.live.find(alloc_id)
        if found is None or found[1] in taken.get(found[0], ()):
            left.append(alloc_id)
            continue
        taken.setdefault(found[0], set()).add(found[1])
        groups.setdefault(found[0], []).append(found[1])
    return groups, left


def _stop_block_members(t: _Tables, index: int, runs,
                        books: Optional[RepackBooks] = None
                        ) -> Tuple[List[StoppedAllocBlock], List[dict]]:
    """Stop the live block members among ``runs`` columnar: each source
    block and run becomes one stopped block, and its members leave the
    block under the exclusion rules (``_BlockTable.exclude``). A block
    stop run over the columns of its block as it is now names its members
    by position; every other member (one excluded since, a block re-packed
    or gone) is named by its id, as an id run's are. An id that is an
    object row or no live member, or a member named twice, is left for
    the caller: returns (the stopped blocks, the id runs left)."""
    groups: Dict[Tuple[str, int], List[int]] = {}
    taken: Dict[str, Set[int]] = {}
    rest: List[dict] = []
    for k, run in enumerate(runs):
        if isinstance(run, dict):
            ids = run["ids"]
        else:
            blk = t.live.by_id.get(run.block_id)
            if blk is not None and blk.same_columns(run.block):
                excluded = blk.excluded
                seen = taken.setdefault(blk.block_id, set())
                live, dead = [], []
                for p in run.positions.tolist():
                    (dead if p in excluded or p in seen else live).append(p)
                seen.update(live)
                if live:
                    groups[(blk.block_id, k)] = live
                ids = [run.block.alloc_id(p) for p in dead]
            else:
                ids = run.alloc_ids()
        found, left = _find_live_members(t, ids, taken)
        for bid, positions in found.items():
            groups.setdefault((bid, k), []).extend(positions)
        if left:
            status, desc = _status_of(run)
            rest.append({"desired_status": status,
                         "desired_description": desc, "ids": left})
    stopped: List[StoppedAllocBlock] = []
    if groups:
        members: Dict[str, Set[int]] = {}
        for (bid, k), positions in groups.items():
            blk = t.live.by_id[bid].stopped(positions, *_status_of(runs[k]),
                                            index)
            t.stopped.add(blk)
            stopped.append(blk)
            members.setdefault(bid, set()).update(positions)
        t.live.exclude(members, books)
        t.indexes["allocs"] = index
    return stopped, rest


class RepackBooks:
    """The live store's re-packs of half-excluded blocks and the live
    members they carried (plain integers; read for the stats gauges)."""

    __slots__ = ("repacks", "members")

    def __init__(self) -> None:
        self.repacks = 0
        self.members = 0


class StopBooks:
    """The live store's committed stops (plain integers; read for the
    stats gauges): the stopped blocks written, the members they carried,
    and the stop copies of ``stop_block_members`` that took the object
    path instead."""

    __slots__ = ("blocks", "members", "rows")

    def __init__(self) -> None:
        self.blocks = 0
        self.members = 0
        self.rows = 0


class _BlockTable:
    """Stored blocks by id, indexed by job and by eval. The store keeps
    two under the same rules: its live blocks and its stopped ones.
    Blocks are immutable — a write replaces the entry — so a snapshot's
    copy is one dict copy and two dicts of set copies."""

    __slots__ = ("by_id", "by_job", "by_eval")

    def __init__(self) -> None:
        self.by_id: Dict[str, StoredAllocBlock] = {}
        self.by_job: Dict[str, Set[str]] = {}
        self.by_eval: Dict[str, Set[str]] = {}

    def copy(self) -> "_BlockTable":
        new = _BlockTable()
        new.by_id = dict(self.by_id)
        new.by_job = {k: set(v) for k, v in self.by_job.items()}
        new.by_eval = {k: set(v) for k, v in self.by_eval.items()}
        return new

    def find(self, alloc_id: str) -> Optional[Tuple[str, int]]:
        """(block_id, pos) of a member not excluded, or None."""
        for bid, blk in self.by_id.items():
            pos = blk.find(alloc_id)
            if pos is not None:
                return bid, pos
        return None

    def add(self, blk: StoredAllocBlock,
            old: Optional[StoredAllocBlock] = None) -> None:
        """Store ``blk`` under its id, in the place of ``old`` (the block
        it updates) where given, re-keyed where its job or eval moved."""
        bid = blk.block_id
        if old is not None:
            if old.job_id != blk.job_id:
                _discard(self.by_job, old.job_id, bid)
            if old.eval_id != blk.eval_id:
                _discard(self.by_eval, old.eval_id, bid)
        self.by_id[bid] = blk
        self.by_job.setdefault(blk.job_id, set()).add(bid)
        self.by_eval.setdefault(blk.eval_id, set()).add(bid)

    def remove(self, blk: StoredAllocBlock) -> None:
        del self.by_id[blk.block_id]
        _discard(self.by_job, blk.job_id, blk.block_id)
        _discard(self.by_eval, blk.eval_id, blk.block_id)

    def exclude(self, members: Dict[str, Set[int]],
                books: Optional[RepackBooks] = None) -> None:
        """Replace blocks with COW copies excluding ``members``
        ({block_id: positions}). A block whose exclusion set reaches half
        its size is re-packed into a fresh block of its live members, so
        per-member promotion cost stays O(n) over a block's whole life
        instead of the frozenset-union O(n^2) (each re-pack at least
        halves the block), and the job stays columnar: no live member
        becomes an object row. A block left with no live member is
        deleted. ``books`` (the live store's) counts the re-packs of live
        blocks; optimistic snapshot writes and the stopped table pass
        None."""
        for bid, positions in members.items():
            blk = self.by_id[bid].with_excluded(positions)
            if blk.n_live and len(blk.excluded) * 2 >= blk.n:
                blk = blk.repacked()
                if books is not None:
                    books.repacks += 1
                    books.members += blk.n
            if not blk.n_live:
                self.remove(blk)
            else:
                self.by_id[bid] = blk


def _discard(index: Dict[str, Set[str]], key: str, id_: str) -> None:
    """Take ``id_`` out of a secondary index's set under ``key``, and the
    set with it once empty."""
    ids = index.get(key)
    if ids is not None:
        ids.discard(id_)
        if not ids:
            del index[key]


def _upsert_allocs(t: _Tables, index: int, allocs: List[Allocation],
                   touched: Optional[Set[str]] = None,
                   books: Optional[RepackBooks] = None) -> None:
    # ``touched`` (when given) collects the node ids whose usage this
    # write may change — the live store's alloc change-log feed. Optimistic
    # snapshot writes pass None and stay out of the shared log.
    if touched is not None:
        for alloc in allocs:
            touched.add(alloc.node_id)
            existing = t.allocs.get(alloc.id)
            if existing is not None and existing.node_id != alloc.node_id:
                touched.add(existing.node_id)
    # An object row superseding a block member (eviction, re-placement,
    # client-side restamp) promotes it out of the block; a stopped member
    # becomes the object row it reads as first.
    if t.live.by_id or t.stopped.by_id:
        members: Dict[str, Set[int]] = {}
        unfound: List[str] = []
        for alloc in allocs:
            if alloc.id in t.allocs:
                continue
            found = t.live.find(alloc.id)
            if found is None:
                unfound.append(alloc.id)
            else:
                bid, pos = found
                members.setdefault(bid, set()).add(pos)
                if touched is not None:
                    # A superseded member's OLD node loses its block
                    # usage — a cross-node restamp must dirty both ends.
                    touched.add(t.live.by_id[bid].node_of_pos(pos))
                if alloc.create_index == 0:
                    alloc.create_index = t.live.by_id[bid].create_index
        if members:
            t.live.exclude(members, books)
        _promote_stopped_members(t, unfound, touched)
    for alloc in allocs:
        existing = t.allocs.get(alloc.id)
        if existing is None:
            if alloc.create_index == 0:
                alloc.create_index = index
        else:
            alloc.create_index = existing.create_index
            # De-index under stale foreign keys if they changed.
            if existing.node_id != alloc.node_id:
                t.allocs_by_node.get(existing.node_id, set()).discard(alloc.id)
            if existing.job_id != alloc.job_id:
                t.allocs_by_job.get(existing.job_id, set()).discard(alloc.id)
            if existing.eval_id != alloc.eval_id:
                t.allocs_by_eval.get(existing.eval_id, set()).discard(alloc.id)
        alloc.modify_index = index
        _insert_alloc_row(t, alloc)
    t.indexes["allocs"] = index


def _apply_update_batches(t: _Tables, index: int, batches,
                          watch: "_Watch" = None,
                          touched: Optional[Set[str]] = None,
                          books: Optional[RepackBooks] = None
                          ) -> List[WatchItem]:
    """Columnar in-place updates: whole-block field swap when a batch
    covers all live members of a stored block; promotion for partial
    coverage; row re-stamp for object allocs. Returns watch items.
    Job/eval container items always fire; per-member node/alloc items
    (thousands per bulk update) build only when ``watch`` has waiters of
    that kind — sampled AFTER the mutation lands (Watch.has_waiters_for
    ordering contract)."""
    items: List[WatchItem] = [item_table("allocs")]
    swapped_blks = []
    stamped_rows = []
    for b in batches:
        members: Dict[str, Set[int]] = {}
        object_rows: List[Allocation] = []
        for alloc_or_id in (b.allocs or b.alloc_ids):
            aid = (alloc_or_id if isinstance(alloc_or_id, str)
                   else alloc_or_id.id)
            row = t.allocs.get(aid)
            if row is not None:
                object_rows.append(row)
                continue
            found = t.live.find(aid)
            if found is not None:
                members.setdefault(found[0], set()).add(found[1])
                continue
            _promote_stopped_members(t, [aid], touched)
            row = t.allocs.get(aid)
            if row is not None:
                object_rows.append(row)
            # Unknown ids: removed while the plan was in flight — exactly
            # the staleness plan evaluation tolerates.
        for bid, positions in members.items():
            blk = t.live.by_id[bid]
            if len(positions) == blk.n_live:
                # Whole block: O(1) field swap, re-keyed by eval/job.
                new_blk = blk.with_update(
                    b.job, b.resources, b.task_resources,
                    b.metrics, b.eval_id, index,
                )
                t.live.add(new_blk, old=blk)
                items.append(item_alloc_job(new_blk.job_id))
                items.append(item_alloc_eval(blk.eval_id))
                items.append(item_alloc_eval(new_blk.eval_id))
                swapped_blks.append(new_blk)
            else:
                for pos in positions:
                    object_rows.append(blk.materialize_pos(pos))
                t.live.exclude({bid: positions}, books)
        for existing in object_rows:
            new = existing.copy()
            new.eval_id = b.eval_id
            new.job = b.job
            new.job_id = b.job.id if b.job is not None else new.job_id
            if b.resources is not None:
                new.resources = b.resources
            if b.task_resources:
                new.task_resources = b.task_resources
            new.metrics = b.metrics
            new.desired_status = ALLOC_DESIRED_STATUS_RUN
            new.desired_description = ""
            new.client_status = ALLOC_CLIENT_STATUS_PENDING
            new.modify_index = index
            if existing.id not in t.allocs:
                new.create_index = existing.create_index or index
            if existing.eval_id != new.eval_id:
                ids = t.allocs_by_eval.get(existing.eval_id)
                if ids is not None:
                    ids.discard(existing.id)
            _insert_alloc_row(t, new)
            stamped_rows.append(new)
    t.indexes["allocs"] = index
    if touched is not None:
        for blk in swapped_blks:
            touched.update(blk.node_ids)
        touched.update(r.node_id for r in stamped_rows)
    if stamped_rows:
        # Container (job/eval) items fire unconditionally, deduped
        # batch-wide: every row of a batch shares its eval id, and job
        # ids collapse to one unless b.job was None.
        items.extend(
            item_alloc_job(j) for j in sorted({r.job_id for r in stamped_rows})
        )
        items.extend(
            item_alloc_eval(e)
            for e in sorted({r.eval_id for r in stamped_rows})
        )
    if watch is not None:
        if watch.has_waiters_for("alloc_node"):
            for blk in swapped_blks:
                items.extend(item_alloc_node(n) for n in blk.node_ids)
            items.extend(item_alloc_node(r.node_id) for r in stamped_rows)
        if watch.has_waiters_for("alloc"):
            items.extend(item_alloc(r.id) for r in stamped_rows)
    return items


def _upsert_alloc_blocks(t: _Tables, index: int, batches,
                         watch: "_Watch" = None,
                         touched: Optional[Set[str]] = None) -> List[WatchItem]:
    """Commit columnar batches as stored blocks — O(runs), no object
    expansion. Returns the watch items to notify. Per-node items (a block
    touches thousands of nodes) are built only when ``watch`` has
    alloc_node waiters — sampled AFTER the mutation lands, so a waiter
    registering mid-commit either gets the notify or reads post-write
    state on its first query pass (Watch.has_waiters_for)."""
    items: List[WatchItem] = [item_table("allocs")]
    committed = []
    for batch in batches:
        if batch.n == 0:
            continue
        blk = StoredAllocBlock.from_batch(batch, index)
        t.live.add(blk)
        items.append(item_alloc_job(blk.job_id))
        items.append(item_alloc_eval(blk.eval_id))
        committed.append(blk)
        if touched is not None:
            touched.update(blk.node_ids)
    t.indexes["allocs"] = index
    if watch is not None and watch.has_waiters_for("alloc_node"):
        for blk in committed:
            items.extend(item_alloc_node(nid) for nid in blk.node_ids)
    return items


class StateStore(_StateView):
    """The live, mutable state store. All writes stamp create/modify
    indexes and fire watch notifications (reference: state_store.go:91-760)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._t = _Tables()
        self.watch = _Watch()
        self.store_uid = generate_uuid()
        self.repack_books = RepackBooks()
        self.stop_books = StopBooks()

    # -- snapshot/restore -------------------------------------------------

    def snapshot(self) -> StateSnapshot:
        with self._lock:
            return StateSnapshot(self._t.copy(), store_uid=self.store_uid)

    def restore(self) -> StateRestore:
        return StateRestore(self)

    def _install(self, tables: _Tables) -> None:
        with self._lock:
            # A wholesale install (restore) carries no change history:
            # floors at the installed indexes force every delta consumer
            # through one full rebuild instead of a bogus empty delta.
            tables.node_log_floor = tables.indexes.get("nodes", 0)
            tables.alloc_log_floor = tables.indexes.get("allocs", 0)
            self._t = tables
        self.watch.notify(
            [
                item_table("nodes"),
                item_table("jobs"),
                item_table("evals"),
                item_table("allocs"),
            ]
        )

    # -- nodes ------------------------------------------------------------

    def _upsert_node_locked(self, index: int, node: Node) -> str:
        """Index-stamp + insert (lock held) — the ONE definition of node
        upsert semantics, shared by the single and batch paths. Returns
        the change-log kind ("insert" for a new key, "update" for an
        in-place rewrite)."""
        existing = self._t.nodes.get(node.id)
        if existing is None:
            node.create_index = index
        else:
            node.create_index = existing.create_index
        node.modify_index = index
        self._t.nodes[node.id] = node
        return "insert" if existing is None else "update"

    def upsert_node(self, index: int, node: Node) -> None:
        """reference: state_store.go UpsertNode"""
        with self._lock:
            kind = self._upsert_node_locked(index, node)
            _log_node_change(self._t, index, node.id, kind)
            self._t.indexes["nodes"] = index
        self.watch.notify([item_table("nodes"), item_node(node.id)])

    def upsert_nodes(self, index: int, nodes: List[Node]) -> None:
        """Bulk node upsert: one lock hold and one table notification for a
        whole registration batch (the Node.BatchRegister path — simcluster
        registers 10k nodes in a few dozen raft entries). Per-node watch
        items are built only when someone is parked on one, the same
        granularity economy as the columnar alloc commits."""
        with self._lock:
            for node in nodes:
                kind = self._upsert_node_locked(index, node)
                _log_node_change(self._t, index, node.id, kind)
            self._t.indexes["nodes"] = index
        items = [item_table("nodes")]
        if self.watch.has_waiters_for("node"):
            items.extend(item_node(n.id) for n in nodes)
        self.watch.notify(items)

    def delete_node(self, index: int, node_id: str) -> None:
        with self._lock:
            if node_id not in self._t.nodes:
                raise KeyError(f"node not found: {node_id}")
            del self._t.nodes[node_id]
            _log_node_change(self._t, index, node_id, "remove")
            self._t.indexes["nodes"] = index
        self.watch.notify([item_table("nodes"), item_node(node_id)])

    def update_node_status(self, index: int, node_id: str, status: str) -> None:
        with self._lock:
            existing = self._t.nodes.get(node_id)
            if existing is None:
                raise KeyError(f"node not found: {node_id}")
            node = existing.copy()
            node.status = status
            node.modify_index = index
            self._t.nodes[node_id] = node
            _log_node_change(self._t, index, node_id, "update")
            self._t.indexes["nodes"] = index
        self.watch.notify([item_table("nodes"), item_node(node_id)])

    def update_node_drain(self, index: int, node_id: str, drain: bool) -> None:
        with self._lock:
            existing = self._t.nodes.get(node_id)
            if existing is None:
                raise KeyError(f"node not found: {node_id}")
            node = existing.copy()
            node.drain = drain
            node.modify_index = index
            self._t.nodes[node_id] = node
            _log_node_change(self._t, index, node_id, "update")
            self._t.indexes["nodes"] = index
        self.watch.notify([item_table("nodes"), item_node(node_id)])

    # -- jobs -------------------------------------------------------------

    def upsert_job(self, index: int, job: Job) -> None:
        with self._lock:
            existing = self._t.jobs.get(job.id)
            if existing is None:
                job.create_index = index
            else:
                job.create_index = existing.create_index
            job.modify_index = index
            self._t.jobs[job.id] = job
            self._t.indexes["jobs"] = index
        self.watch.notify([item_table("jobs"), item_job(job.id)])

    def delete_job(self, index: int, job_id: str) -> None:
        with self._lock:
            if job_id not in self._t.jobs:
                raise KeyError(f"job not found: {job_id}")
            del self._t.jobs[job_id]
            self._t.indexes["jobs"] = index
        self.watch.notify([item_table("jobs"), item_job(job_id)])

    # -- evals ------------------------------------------------------------

    def upsert_evals(self, index: int, evals: List[Evaluation]) -> None:
        items: List[WatchItem] = [item_table("evals")]
        with self._lock:
            for ev in evals:
                existing = self._t.evals.get(ev.id)
                if existing is None:
                    ev.create_index = index
                else:
                    ev.create_index = existing.create_index
                ev.modify_index = index
                self._t.evals[ev.id] = ev
                self._t.evals_by_job.setdefault(ev.job_id, set()).add(ev.id)
                items.append(item_eval(ev.id))
            self._t.indexes["evals"] = index
        self.watch.notify(items)

    def delete_eval(self, index: int, eval_ids: List[str], alloc_ids: List[str]) -> None:
        """Delete evals + allocs together, used by GC
        (reference: state_store.go DeleteEval)."""
        items: List[WatchItem] = [item_table("evals"), item_table("allocs")]
        reaped_blocks: List[StoredAllocBlock] = []
        touched: Set[str] = set()
        with self._lock:
            t = self._t
            tables = (t.live, t.stopped)
            for eval_id in eval_ids:
                ev = t.evals.pop(eval_id, None)
                if ev is not None:
                    _discard(t.evals_by_job, ev.job_id, eval_id)
                    items.append(item_eval(eval_id))
                # A reaped eval takes its columnar blocks, live and
                # stopped, with it wholesale.
                for table in tables:
                    for bid in sorted(table.by_eval.get(eval_id, ())):
                        blk = table.by_id[bid]
                        table.remove(blk)
                        items.append(item_alloc_job(blk.job_id))
                        items.append(item_alloc_eval(blk.eval_id))
                        reaped_blocks.append(blk)
            # Per table: block id -> the positions of deleted members.
            block_members: Tuple[Dict[str, Set[int]], ...] = ({}, {})
            for alloc_id in alloc_ids:
                alloc = t.allocs.pop(alloc_id, None)
                if alloc is not None and not alloc.terminal_status():
                    _decr_live_objs(t, alloc.job_id)
                if alloc is None:
                    for table, members in zip(tables, block_members):
                        found = table.find(alloc_id)
                        if found is not None:
                            break
                    if found is not None:
                        bid, pos = found
                        blk = table.by_id[bid]
                        members.setdefault(bid, set()).add(pos)
                        # Watchers see block-member deletions exactly
                        # like object-row deletions.
                        touched.add(blk.node_of_pos(pos))
                        items.extend(
                            [
                                item_alloc(alloc_id),
                                item_alloc_job(blk.job_id),
                                item_alloc_node(blk.node_of_pos(pos)),
                                item_alloc_eval(blk.eval_id),
                            ]
                        )
                    continue
                for idx_map, key in (
                    (t.allocs_by_job, alloc.job_id),
                    (t.allocs_by_node, alloc.node_id),
                    (t.allocs_by_eval, alloc.eval_id),
                ):
                    _discard(idx_map, key, alloc_id)
                touched.add(alloc.node_id)
                items.extend(
                    [
                        item_alloc(alloc_id),
                        item_alloc_job(alloc.job_id),
                        item_alloc_node(alloc.node_id),
                        item_alloc_eval(alloc.eval_id),
                    ]
                )
            t.live.exclude(block_members[0], self.repack_books)
            t.stopped.exclude(block_members[1])
            for blk in reaped_blocks:
                touched.update(blk.node_ids)
            _log_alloc_nodes(t, index, touched)
            t.indexes["evals"] = index
            t.indexes["allocs"] = index
            # Gated member items, sampled AFTER the index stamps (the
            # has_waiters_for ordering contract): a late-registering
            # blocking query re-checks against the stamped index.
            if reaped_blocks and self.watch.has_waiters_for("alloc_node"):
                for blk in reaped_blocks:
                    items.extend(item_alloc_node(n) for n in blk.node_ids)
        self.watch.notify(items)

    # -- allocs -----------------------------------------------------------

    def upsert_allocs(self, index: int, allocs: List[Allocation]) -> None:
        items: List[WatchItem] = [item_table("allocs")]
        touched: Set[str] = set()
        with self._lock:
            _upsert_allocs(self._t, index, allocs, touched=touched,
                           books=self.repack_books)
            _log_alloc_nodes(self._t, index, touched)
            for alloc in allocs:
                items.extend(
                    [
                        item_alloc(alloc.id),
                        item_alloc_job(alloc.job_id),
                        item_alloc_node(alloc.node_id),
                        item_alloc_eval(alloc.eval_id),
                    ]
                )
        self.watch.notify(items)

    def stop_block_members(self, index: int, runs
                           ) -> Tuple[List[StoppedAllocBlock],
                                      List[Allocation]]:
        """Commit the stop runs of an ``alloc_update`` entry: id runs
        (``structs.stop_runs``: desired status, description, ids) or block
        stop runs (``BlockStopRun``), as ``_stop_block_members`` resolves
        them. The ids that are not live block members are rebuilt, after
        that, into stop copies from this store (``structs.expand_stop_runs``:
        an object row, a stopped member, an id named twice; one the store
        no longer holds is skipped). Returns (the stopped blocks, the stop
        copies): the copies are for the caller's ``upsert_allocs``. The
        watch items and the alloc log name what the copies' upsert would:
        the members' nodes, jobs and evals."""
        with self._lock:
            t = self._t
            stopped, rest = _stop_block_members(t, index, runs,
                                                self.repack_books)
            if stopped:
                touched: Set[str] = set()
                for blk in stopped:
                    touched.update(blk.live_counts_map())
                _log_alloc_nodes(t, index, touched)
                books = self.stop_books
                books.blocks += len(stopped)
                books.members += sum(b.n_live for b in stopped)
                items: List[WatchItem] = [item_table("allocs")]
                items.extend(item_alloc_job(j)
                             for j in sorted({b.job_id for b in stopped}))
                items.extend(item_alloc_eval(e)
                             for e in sorted({b.eval_id for b in stopped}))
                # Per-member items only where someone waits on one, sampled
                # after the write (Watch.has_waiters_for).
                if self.watch.has_waiters_for("alloc_node"):
                    items.extend(item_alloc_node(n) for n in sorted(touched))
                if self.watch.has_waiters_for("alloc"):
                    items.extend(item_alloc(i) for b in stopped
                                 for i, _nid in b.live_members())
        if stopped:
            self.watch.notify(items)
        copies = expand_stop_runs(rest, self.alloc_by_id)
        self.stop_books.rows += len(copies)
        return stopped, copies

    def block_stop_runs(self, runs) -> Tuple[list, List[dict]]:
        """Id runs (``structs.stop_runs``) as a plan carries them: the ids
        of live block members as block stop runs, one a block and run, in
        the order of their first member; every other id (an object row,
        no live member, one named twice) left in id runs. Returns (the
        block stop runs, the id runs left)."""
        out = []
        rest: List[dict] = []
        taken: Dict[str, Set[int]] = {}
        with self._lock:
            t = self._t
            for run in runs:
                found, left = _find_live_members(t, run["ids"], taken)
                out.extend(t.live.by_id[bid].stop_run(positions,
                                                      *_status_of(run))
                           for bid, positions in found.items())
                if left:
                    rest.append({**run, "ids": left})
        return out, rest

    def upsert_alloc_blocks(self, index: int, batches: List[AllocBatch]) -> None:
        """Commit columnar placement batches natively (no per-Allocation
        expansion); blocking queries on the touched nodes/job/eval fire."""
        touched: Set[str] = set()
        with self._lock:
            items = _upsert_alloc_blocks(
                self._t, index, batches, watch=self.watch, touched=touched,
            )
            _log_alloc_nodes(self._t, index, touched)
        self.watch.notify(items)

    def apply_update_batches(self, index: int, batches) -> None:
        """Commit columnar in-place updates (AllocUpdateBatch). A batch
        covering ALL live members of a stored block applies as one block
        field swap (state/blocks.py with_update); partial coverage
        promotes the touched members; object rows re-stamp in place. The
        observable result is exactly the batch's materialize() expansion
        upserted row-wise."""
        touched: Set[str] = set()
        with self._lock:
            items = _apply_update_batches(
                self._t, index, batches, watch=self.watch, touched=touched,
                books=self.repack_books,
            )
            _log_alloc_nodes(self._t, index, touched)
        self.watch.notify(items)

    def update_alloc_from_client(self, index: int, alloc: Allocation) -> None:
        self.update_allocs_from_client(index, [alloc])

    def update_allocs_from_client(self, index: int,
                                  allocs: List[Allocation]) -> None:
        """Client status updates: only client-side fields are trusted
        (reference: state_store.go UpdateAllocFromClient). Block members
        are promoted to object rows — their status now diverges from their
        block — with one COW exclusion per block per batch, not per
        member."""
        items: List[WatchItem] = [item_table("allocs")]
        with self._lock:
            t = self._t
            if t.live.by_id or t.stopped.by_id:
                members: Dict[str, Set[int]] = {}
                unfound: List[str] = []
                for alloc in allocs:
                    if alloc.id in t.allocs:
                        continue
                    found = t.live.find(alloc.id)
                    if found is None:
                        unfound.append(alloc.id)
                        continue
                    bid, pos = found
                    members.setdefault(bid, set()).add(pos)
                    _insert_alloc_row(
                        t, t.live.by_id[bid].materialize_pos(pos))
                if members:
                    t.live.exclude(members, self.repack_books)
                _promote_stopped_members(t, unfound)
            missing: List[str] = []
            for alloc in allocs:
                existing = t.allocs.get(alloc.id)
                if existing is None:
                    # A GC'd alloc must not abort the batch: the updates
                    # already applied need their index bump and watch
                    # notifications regardless (raise after both).
                    missing.append(alloc.id)
                    continue
                new = existing.copy()
                new.client_status = alloc.client_status
                new.client_description = alloc.client_description
                new.modify_index = index
                # terminal_status() is desired-status-only (structs.go:
                # 1179-1188 parity), so a client-field update can never
                # move the live-object counter.
                t.allocs[alloc.id] = new
                items.extend(
                    [
                        item_alloc(new.id),
                        item_alloc_job(new.job_id),
                        item_alloc_node(new.node_id),
                        item_alloc_eval(new.eval_id),
                    ]
                )
            t.indexes["allocs"] = index
        self.watch.notify(items)
        if missing:
            raise KeyError(f"alloc not found: {', '.join(missing)}")
