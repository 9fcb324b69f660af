"""Coalescing solve engine: many concurrent evals, one device dispatch.

Port of nomad_tpu/ops/coalesce.py. Concurrent workers' solves are stacked
on an eval axis and dispatched as ONE kernel launch, so K in-flight
evaluations cost one device round trip instead of K (the reference's
optimistic concurrency, upstream nomad/worker.go:45-125).

No unconditional batching window: the dispatcher drains whatever is
pending the moment it wakes. The one exception is an ANNOUNCED burst: a
batch worker that just dequeued K compatible evals calls hint_burst(K),
and the dispatcher holds its next dispatch until those K solves have all
arrived or a short deadline passes.

Differences from nomad_tpu, on purpose:
- no Pallas enablement or fallback: a kernel fault fails the entries of
  its dispatch and reaches each caller's fetch(); there is no per-entry
  retry on another code path;
- a single entry is a stack of one: with a solve mesh configured
  (parallel/mesh.py), ``_stack_and_solve`` and ``_stack_and_solve_exact``
  take nomad_tpu's mesh arms (its ``_solve_one`` and both stacks) for
  every width -- the node shards' passes and the seam between them, the
  eval axis split over the mesh's eval rows when the width divides;
- kernels launch on the default CUDA stream; a recorded CUDA event marks
  each dispatch's completion for the fetchers;
- the warm-ups (``warm_batch_shapes``, ``warm_exact_batch_shapes``) have
  no compile to key on: what they warm is what a width's first dispatch
  allocates (the stacked [B, N] inputs, the water-fill's scratch above
  131,072 rows) and the kernels' first load.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nomad_tpu_torch import telemetry, trace
from nomad_tpu_torch.ops.binpack import bucket
from nomad_tpu_torch.ops.greedy import solve_greedy_batched_shared
from nomad_tpu_torch.ops.waterfill import solve_waterfill_batched
from nomad_tpu_torch.parallel import mesh as mesh_lib

# Cap on the eval-axis batch: dispatch in chunks of at most this many
# entries, padded to the power-of-two widths {1, 2, 4, 8}.
MAX_BATCH_BUCKET = 8

# Burst-hold tuning (see nomad_tpu): GAP is the give-up threshold between
# consecutive arrivals, WINDOW the hard cap on the total hold.
BURST_GAP_S = float(os.environ.get("NOMAD_TPU_COALESCE_GAP", "0.05"))
BURST_WINDOW_S = float(os.environ.get("NOMAD_TPU_COALESCE_WINDOW", "0.25"))

# Per-thread burst membership: False = an announced burst member that has
# not yet accounted against the expectation.
_BURST_TLS = threading.local()


def _record_dispatch_width(width: int, wall_ms: float) -> None:
    """Feed the solver panel's batch-width axis (late import: the engine
    stays usable without the solver stack)."""
    from nomad_tpu_torch.tpu.solver import SOLVER_PANEL

    SOLVER_PANEL.record_dispatch(width, wall_ms)


class _Entry:
    __slots__ = ("args", "event", "group", "index", "error", "kind", "k")

    def __init__(self, args, kind: str = "wf", k: int = 0):
        self.args = args
        self.event = threading.Event()
        self.group: Optional["_Group"] = None
        self.index = 0
        self.error: Optional[BaseException] = None
        # "wf" (water-fill counts) or "exact" (the greedy scan, k = padded
        # count bucket). Only same-kind, same-k entries share a dispatch.
        self.kind = kind
        self.k = k

    def result(self):
        """Block for the dispatch, then return (counts[N], n_unplaced) —
        (idxs[k], oks[k]) for exact entries — or raise the dispatch
        failure."""
        with trace.stage("execute"):
            self.event.wait()
        if self.group is None:
            raise RuntimeError("coalesced solve failed") from self.error
        return self.group.fetch(self.index)


class _Group:
    """One dispatched batch: device outputs + lazily fetched host copies."""

    __slots__ = ("a_dev", "b_dev", "done", "_fetch_lock", "_host", "width",
                 "t0")

    def __init__(self, a_dev, b_dev, width: int = 1,
                 t0: Optional[float] = None):
        self.a_dev = a_dev
        self.b_dev = b_dev
        # Completion marker on the launch stream (None on the CPU, where
        # the plain version has already run synchronously).
        self.done = None
        if a_dev.is_cuda:
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(a_dev.device))
        self._fetch_lock = threading.Lock()
        self._host = None
        self.width = width
        self.t0 = t0

    def _materialize(self) -> None:
        """First fetch waits for the device and copies the whole batch
        down; later fetches index the cached host arrays. A device fault
        raises here, to the caller."""
        with self._fetch_lock:
            if self._host is None:
                with trace.stage("execute"):
                    if self.done is not None:
                        self.done.synchronize()
                with trace.stage("readback"):
                    self._host = (self.a_dev.cpu().numpy(),
                                  self.b_dev.cpu().numpy())
                if self.t0 is not None:
                    _record_dispatch_width(
                        self.width, (time.perf_counter() - self.t0) * 1000.0)

    def fetch(self, index: int):
        self._materialize()
        counts, remaining = self._host
        return counts[index], int(remaining[index])


class _ExactGroup(_Group):
    """A stacked exact-scan dispatch: (idxs[B, k], oks[B, k])."""

    __slots__ = ()

    def fetch(self, index: int):
        self._materialize()
        idxs, oks = self._host
        return idxs[index], oks[index]


class CoalescingSolver:
    """Process-wide dispatcher stacking concurrent solves.

    submit(...) returns a fetch() closure: () -> (counts[N] np.int32,
    n_unplaced); submit_exact(...) one returning (idx[count], ok[count]).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[_Entry] = []
        self._thread: Optional[threading.Thread] = None
        self._active = 0
        self._burst_outstanding = 0
        self._burst_deadline = 0.0
        self._burst_last = 0.0
        self._burst_gap = BURST_GAP_S
        self._burst_gen = 0
        self.dispatches = 0
        self.coalesced = 0

    def hint_burst(self, n: int, window_s: float = BURST_WINDOW_S,
                   gap_s: float = BURST_GAP_S) -> int:
        """Announce ``n`` concurrent evals about to be processed: the
        dispatcher holds its next dispatch until every announced eval
        resolves (first submit or burst_done), progress stalls for
        ``gap_s``, or ``window_s`` passes. Returns the generation token
        for burst_begin (-1 for a lone eval, which is no burst member)."""
        if n <= 1:
            return -1
        with self._cond:
            now = time.monotonic()
            self._burst_gen += 1
            self._burst_outstanding = n
            self._burst_deadline = now + window_s
            self._burst_last = now
            self._burst_gap = gap_s
            self._cond.notify()
            return self._burst_gen

    def burst_begin(self, token: Optional[int] = None) -> None:
        """Mark the calling thread as a member of burst ``token`` (None =
        the current generation) that has not yet accounted."""
        if token is None:
            with self._lock:
                token = self._burst_gen
        _BURST_TLS.gen = token
        _BURST_TLS.counted = False

    def burst_done(self) -> None:
        """The calling eval thread finished; resolve its slot if none of
        its submits did."""
        if getattr(_BURST_TLS, "counted", True):
            return
        _BURST_TLS.counted = True
        with self._cond:
            if (self._burst_outstanding > 0
                    and getattr(_BURST_TLS, "gen", -1) == self._burst_gen):
                self._burst_outstanding -= 1
                self._burst_last = time.monotonic()
                self._cond.notify()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="solve-coalescer"
            )
            self._thread.start()

    def submit(
        self, total, sched_cap, used0, job_count0, tg_count0, bw_avail,
        bw_used0, eligible, ask, bw_ask, count: int, penalty: float,
        job_distinct: bool = False, tg_distinct: bool = False,
    ):
        entry = _Entry((
            total, sched_cap, used0, job_count0, tg_count0, bw_avail,
            bw_used0, eligible, ask, bw_ask, count, penalty,
            bool(job_distinct), bool(tg_distinct),
        ))
        self._enqueue(entry)
        return entry.result

    def submit_exact(
        self, total, sched_cap, used0, job_count0, tg_count0, bw_avail,
        bw_used0, eligible, ask, bw_ask, count: int, penalty: float,
        job_distinct: bool = False, tg_distinct: bool = False,
    ):
        """Queue one exact greedy scan (count <= EXACT_THRESHOLD), padded
        to its power-of-two count bucket. Returns fetch() ->
        (node_indices[count], ok[count])."""
        entry = _Entry((
            total, sched_cap, used0, job_count0, tg_count0, bw_avail,
            bw_used0, eligible, ask, bw_ask, count, penalty,
            bool(job_distinct), bool(tg_distinct),
        ), kind="exact", k=bucket(count))
        self._enqueue(entry)

        def fetch_exact():
            idxs, oks = entry.result()
            return idxs[:count], oks[:count]

        return fetch_exact

    def _enqueue(self, entry: _Entry) -> None:
        with self._cond:
            self._ensure_thread()
            self._pending.append(entry)
            if (self._burst_outstanding > 0
                    and getattr(_BURST_TLS, "counted", True) is False
                    and getattr(_BURST_TLS, "gen", -1) == self._burst_gen):
                _BURST_TLS.counted = True
                self._burst_outstanding -= 1
                self._burst_last = time.monotonic()
            self._cond.notify()

    # -- dispatcher ---------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending:
                    self._cond.wait()
                now = time.monotonic()
                while (self._burst_outstanding > 0
                       and len(self._pending) < MAX_BATCH_BUCKET):
                    deadline = min(self._burst_last + self._burst_gap,
                                   self._burst_deadline)
                    if now >= deadline:
                        self._burst_outstanding = 0
                        break
                    self._cond.wait(deadline - now)
                    now = time.monotonic()
                batch = self._pending
                self._pending = []
                self._active += 1
            try:
                self._dispatch(batch)
            finally:
                with self._cond:
                    self._active -= 1

    def quiesce(self, timeout: float = 5.0) -> bool:
        """Wait for the dispatcher to go idle. Returns False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending and self._active == 0:
                    return True
            time.sleep(0.01)
        return False

    def _dispatch(self, batch: List[_Entry]) -> None:
        # Group by (device, padded node count, kind, count bucket, flags);
        # exact entries also by mirror identity (id of the total tensor),
        # since a stacked exact dispatch shares the node tensors.
        groups: Dict[Tuple, List[_Entry]] = {}
        for e in batch:
            total = e.args[0]
            key = (str(total.device), total.shape[0], e.kind, e.k,
                   e.args[12], e.args[13],
                   id(total) if e.kind == "exact" else None)
            groups.setdefault(key, []).append(e)

        for (_dev, _n, _kind, _k, jd, td, _mid), entries in groups.items():
            for start in range(0, len(entries), MAX_BATCH_BUCKET):
                chunk = entries[start:start + MAX_BATCH_BUCKET]
                try:
                    self._dispatch_group(chunk, jd, td)
                except Exception as exc:  # noqa: BLE001
                    # No fallback: the fault reaches every waiter of this
                    # chunk through fetch().
                    for e in chunk:
                        if e.group is None:
                            e.error = exc
                            e.event.set()

    def _dispatch_group(self, entries: List[_Entry], jd: bool,
                        td: bool) -> None:
        self.dispatches += 1
        telemetry.incr_counter(("scheduler", "coalesce", "dispatch"))
        telemetry.add_sample(
            ("scheduler", "coalesce", "batch_size"), float(len(entries))
        )
        t0 = time.perf_counter()
        if len(entries) > 1:
            self.coalesced += len(entries)
        rows = [e.args for e in entries]
        if entries[0].kind == "exact":
            idxs, oks = _stack_and_solve_exact(rows, entries[0].k, jd, td)
            group: _Group = _ExactGroup(idxs, oks, width=len(entries), t0=t0)
        else:
            counts, remaining = _stack_and_solve(rows, jd, td)
            group = _Group(counts, remaining, width=len(entries), t0=t0)
        for i, e in enumerate(entries):
            e.group = group
            e.index = i
            e.event.set()


def _width(n_rows: int) -> int:
    """Eval-axis width of a dispatch: 1 alone, else the power-of-two
    bucket {2, 4, 8}."""
    return 1 if n_rows == 1 else bucket(n_rows, floor=2)


def _pad_rows(rows, jd: bool, td: bool):
    """Pad the eval axis to its width; padding rows repeat row 0 with
    count 0 (a no-op solve)."""
    rows = list(rows)
    rows.extend([rows[0][:10] + (0, 0.0, jd, td)]
                * (_width(len(rows)) - len(rows)))
    return rows


def _stack_and_solve(rows, jd: bool, td: bool):
    """Stack the eval axis and launch the batched water-fill, node-axis
    sharded over the configured mesh when one divides the bucket. Returns
    (counts [B, N], remaining [B]) on the rows' device (the mesh's first
    device)."""
    rows = _pad_rows(rows, jd, td)
    first = rows[0][0]
    mesh = mesh_lib.mesh_for_nodes(first.shape[0], first.device)
    if mesh is not None:
        return _stack_and_solve_mesh(mesh, rows, jd, td)
    rows = [tuple(mesh_lib.whole(x) for x in r[:10]) + r[10:] for r in rows]
    dev = first.device
    if len(rows) == 1:
        stacked = [t.unsqueeze(0) for t in rows[0][:10]]
    else:
        stacked = [torch.stack(col) for col in zip(*(r[:10] for r in rows))]
    counts = torch.tensor([r[10] for r in rows], dtype=torch.int32,
                          device=dev)
    penalties = torch.tensor([r[11] for r in rows], dtype=torch.float32,
                             device=dev)
    return solve_waterfill_batched(*stacked, counts, penalties, jd, td)


def _small_cols(rows, dev):
    """The stacked asks [B, 4] and bandwidth asks [B] of padded rows."""
    return (torch.stack([r[8] for r in rows]).to(dev),
            torch.stack([r[9] for r in rows]).to(dev))


def _stack_and_solve_mesh(mesh, rows, jd: bool, td: bool):
    """The water-fill's mesh arm: each node-axis column stacked shard by
    shard (rows born sharded pass as they are; any other is split and
    counted in mesh.STATS["node_reshards"]), the small columns replicated,
    then the sharded solve."""
    dev = mesh.devices[0][0]
    stacked = [mesh_lib.stack_sharded(mesh, col)
               for col in zip(*(r[:8] for r in rows))]
    counts = torch.tensor([r[10] for r in rows], dtype=torch.int32)
    penalties = torch.tensor([r[11] for r in rows], dtype=torch.float32)
    placed, counts, penalties = mesh_lib.shard_waterfill_batch_args(
        mesh, (*stacked, *_small_cols(rows, dev)), counts, penalties)
    return mesh_lib.solve_waterfill_on_mesh(
        mesh, placed, counts, penalties, max(r[10] for r in rows), jd, td)


def _stack_and_solve_exact(rows, k: int, jd: bool, td: bool):
    """Stack the per-eval tensors and launch ONE batched exact scan; the
    node tensors (total, sched_cap, bw_avail) ride once, shared — the
    dispatcher's identity grouping guarantees every row reads the same
    mirror. Returns (idxs [B, k], oks [B, k])."""
    rows = _pad_rows(rows, jd, td)
    first = rows[0][0]
    mesh = mesh_lib.mesh_for_nodes(first.shape[0], first.device)
    dev = mesh.devices[0][0] if mesh is not None else first.device
    counts = np.asarray([r[10] for r in rows], dtype=np.int32)
    active = torch.tensor(np.arange(k, dtype=np.int32)[None, :]
                          < counts[:, None], device=dev)
    penalties = torch.tensor([r[11] for r in rows], dtype=torch.float32,
                             device=dev)
    if mesh is not None:
        # The mesh arm: the shared node tensors and the stacked per-eval
        # ones node-sharded, the small ones replicated, then each shard's
        # scan and the merge.
        per_eval = [mesh_lib.stack_sharded(mesh, [r[i] for r in rows])
                    for i in (2, 3, 4, 6, 7)]
        shared, per_eval, active, penalties = (
            mesh_lib.shard_greedy_batch_args(
                mesh, (first, rows[0][1], rows[0][5]),
                (*per_eval, *_small_cols(rows, dev)), active, penalties))
        idxs, oks, _scores = mesh_lib.solve_greedy_on_mesh(
            mesh, shared, per_eval, active, penalties, k, jd, td)
        return idxs, oks
    rows = [tuple(mesh_lib.whole(x) for x in r[:10]) + r[10:] for r in rows]
    if len(rows) == 1:
        per_eval = {i: rows[0][i].unsqueeze(0) for i in (2, 3, 4, 6, 7, 8, 9)}
    else:
        per_eval = {i: torch.stack([r[i] for r in rows])
                    for i in (2, 3, 4, 6, 7, 8, 9)}
    total, sched_cap, bw_avail = rows[0][0], rows[0][1], rows[0][5]
    idxs, oks, _scores = solve_greedy_batched_shared(
        total, sched_cap, per_eval[2], per_eval[3], per_eval[4],
        bw_avail, per_eval[6], per_eval[7], per_eval[8], per_eval[9],
        active, penalties, k, jd, td,
    )
    return idxs, oks


def _noop_row(n_padded: int, device):
    """One no-op solve row at a node bucket: zero capacity, nothing
    eligible, count 0; its node tensors born sharded where a mesh divides
    the bucket, as the mirror's are, so a warm-up takes the same arm as
    the dispatches it warms."""
    put = mesh_lib.put_node_sharded
    zero4 = put(np.zeros((n_padded, 4), dtype=np.int32), device)
    zcap = put(np.zeros((n_padded, 2), dtype=np.float32), device)
    zvec = put(np.zeros(n_padded, dtype=np.int32), device)
    elig = put(np.zeros(n_padded, dtype=bool), device)
    return (zero4, zcap, zero4, zvec, zvec, zvec, zvec, elig,
            torch.zeros((4,), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            0, 0.0, False, False)


def warm_batch_shapes(n_padded: int, buckets=(1, 2, 4, 8), stop=None,
                      device=None) -> int:
    """Warm the water-fill for each eval-axis width at one node bucket,
    through the coalescer's own stacking (_stack_and_solve), so warm
    shapes can't drift from real dispatch shapes. Dispatch chunking caps
    real batches at MAX_BATCH_BUCKET, so the default widths are all of
    them. Values are no-op solves (count 0). ``device`` defaults to the
    CUDA card. Returns the number of dispatches issued."""
    from nomad_tpu_torch.device import resolve_device

    row = _noop_row(n_padded, resolve_device(device))
    done = 0
    with device_activity():
        for b in buckets:
            if stop is not None and stop():
                return done
            counts, _rem = _stack_and_solve([row] * b, False, False)
            counts.cpu()  # wait for the launch
            done += 1
    return done


def warm_exact_batch_shapes(n_padded: int, counts=(8, 16, 32, 64, 128),
                            buckets=(2, 4, 8), stop=None,
                            device=None) -> int:
    """Warm the STACKED exact greedy scan for each (count bucket ×
    eval-axis width) at one node bucket. Width 1 is warmed by
    warm_shapes' real solve_group dispatches; the widths here are the
    coalesced ones a burst's first drain would otherwise meet cold. Runs
    through _stack_and_solve_exact — the SAME stacking real dispatches
    use. Returns the number of dispatches issued."""
    from nomad_tpu_torch.device import resolve_device

    row = _noop_row(n_padded, resolve_device(device))
    done = 0
    with device_activity():
        for k in sorted({bucket(c) for c in counts}):
            for b in buckets:
                if stop is not None and stop():
                    return done
                idxs, _oks = _stack_and_solve_exact([row] * b, k, False,
                                                    False)
                idxs.cpu()  # wait for the launch
                done += 1
    return done


# Process-wide engine shared by all workers (like GLOBAL_MIRROR_CACHE).
GLOBAL_SOLVER = CoalescingSolver()

# Direct device work outside the queue: a worker's scheduler pass stages
# mirror tensors and reads results back on its own thread, which the
# dispatcher's idle flag cannot see.
_activity_lock = threading.Lock()
_active_direct = 0


class device_activity:
    """Context manager marking a thread as inside direct device work
    (staging, exact-path fetches, readbacks outside the coalescer queue),
    so quiesce_all can drain it before interpreter teardown."""

    def __enter__(self):
        global _active_direct
        with _activity_lock:
            _active_direct += 1
        return self

    def __exit__(self, *exc):
        global _active_direct
        with _activity_lock:
            _active_direct -= 1
        return False


def device_work() -> Dict[str, int]:
    """Device work in flight right now: solves queued in the coalescer,
    dispatches running, and threads inside device_activity."""
    with GLOBAL_SOLVER._lock:
        queued = len(GLOBAL_SOLVER._pending)
        dispatching = GLOBAL_SOLVER._active
    with _activity_lock:
        direct = _active_direct
    return {"queued": queued, "dispatching": dispatching, "direct": direct}


def quiesce_all(timeout: float = 10.0) -> bool:
    """Wait until no device work is in flight anywhere: queued or
    dispatching coalescer solves AND threads inside device_activity.
    Returns False on timeout."""
    deadline = time.monotonic() + timeout
    if not GLOBAL_SOLVER.quiesce(max(deadline - time.monotonic(), 0.01)):
        return False
    while time.monotonic() < deadline:
        with _activity_lock:
            if _active_direct == 0:
                return True
        time.sleep(0.02)
    return False


# Drain device work before interpreter teardown, so no daemon thread is
# inside a kernel launch or a copy when CPython finalizes. An embedder
# exiting under load stops its Server first (Server.shutdown drains).
import atexit  # noqa: E402

atexit.register(quiesce_all, 2.0)
