"""Faults planted under the timed path, and the control, each of which
the reference must judge not correct. Used by the tests and by
``control.py``; the benchmark's own runs plant nothing.

Each is a factory ``plant(run)`` of a context manager that the harness
enters around the window. The kernel faults wrap the coalescer's two
kernel entries (``ops/coalesce.py`` calls them by these module names)
and alter what the kernel answered, where it is produced:

- ``unchanged``: a step that returns its state unchanged: nothing placed;
- ``half_batch``: half of a coalesced batch left out (every other solve
  where the batch is one eval wide);
- ``altered``: one answer altered: a task moved from one chosen node onto
  another already chosen;
- ``control``: the plain placer put in the kernel's place, breaking the
  capacity guarantee: every task of an eval on its first eligible node.

The update path's in-place step runs no kernel, so ``inplace_unchanged``
drops the plan's in-place updates where the worker submits it; and
``destructive_inplace`` makes a destructive update an in-place one: the
scheduler's diff no longer sees a change of the task env, so a roll
re-stamps every allocation with the new job instead of replacing it. No cell
here spans chips, so there is no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import copy

KERNEL_FAULTS = ("unchanged", "half_batch", "altered", "control")


def _alter_waterfill(kind: str, calls: list, args, out):
    counts, remaining = out
    count, eligible = args[10], args[7]
    b = counts.shape[0]
    calls.append(1)
    if kind == "unchanged":
        return counts.zero_(), count.clone()
    if kind == "half_batch":
        keep = b // 2 if b > 1 else (0 if len(calls) % 2 else 1)
        counts[keep:] = 0
        remaining = remaining.clone()
        remaining[keep:] = count[keep:]
        return counts, remaining
    if kind == "altered":
        for e in range(b):
            rows = (counts[e] > 0).nonzero().flatten()
            if len(rows) >= 2:
                counts[e, rows[0]] -= 1
                counts[e, rows[1]] += 1
        return counts, remaining
    # control: every task on the eval's first eligible row
    counts.zero_()
    for e in range(b):
        if int(count[e]) > 0:
            counts[e, int(eligible[e].int().argmax())] = count[e]
    return counts, remaining.zero_()


def _alter_greedy(kind: str, calls: list, args, out):
    idx, ok, score = out
    active, eligible = args[10], args[7]
    b = idx.shape[0]
    calls.append(1)
    if kind == "unchanged":
        return idx, ok.zero_(), score
    if kind == "half_batch":
        keep = b // 2 if b > 1 else (0 if len(calls) % 2 else 1)
        ok[keep:] = False
        return idx, ok, score
    if kind == "altered":
        for e in range(b):
            if idx.shape[1] > 1 and bool(ok[e, 1]):
                idx[e, 1] = idx[e, 0]
        return idx, ok, score
    for e in range(b):
        idx[e] = int(eligible[e].int().argmax())
    ok.copy_(active)
    return idx, ok, score


def kernel_fault(kind: str):
    if kind not in KERNEL_FAULTS:
        raise ValueError(f"unknown fault {kind!r}")

    @contextlib.contextmanager
    def plant(run):
        from nomad_tpu_torch.ops import coalesce

        wf, gr = coalesce.solve_waterfill_batched, \
            coalesce.solve_greedy_batched_shared
        calls_wf, calls_gr = [], []
        coalesce.solve_waterfill_batched = lambda *a: _alter_waterfill(
            kind, calls_wf, a, wf(*a))
        coalesce.solve_greedy_batched_shared = lambda *a: _alter_greedy(
            kind, calls_gr, a, gr(*a))
        try:
            yield
        finally:
            coalesce.solve_waterfill_batched = wf
            coalesce.solve_greedy_batched_shared = gr

    return plant


@contextlib.contextmanager
def inplace_unchanged(run):
    """The in-place step returns its state unchanged: every plan goes in
    without its in-place updates."""
    srv = run.srv
    submit = srv.plan_submit

    def without_updates(plan):
        plan.update_batches = []
        return submit(plan)

    srv.plan_submit = without_updates
    try:
        yield
    finally:
        srv.plan_submit = submit


@contextlib.contextmanager
def destructive_inplace(run):
    """A change of the task env no longer defeats the in-place update
    (``scheduler.util.tasks_updated``, which the solver's diff reads at
    each call, compares the new tasks with the old env)."""
    from nomad_tpu_torch.scheduler import util

    tasks_updated = util.tasks_updated

    def env_blind(a, b):
        a = copy.copy(a)
        a.tasks = [copy.copy(t) for t in a.tasks]
        for t in a.tasks:
            old = b.lookup_task(t.name)
            if old is not None:
                t.env = old.env
        return tasks_updated(a, b)

    util.tasks_updated = env_blind
    try:
        yield
    finally:
        util.tasks_updated = tasks_updated


UPDATE_FAULTS = {"inplace_unchanged": inplace_unchanged,
                 "destructive_inplace": destructive_inplace}


def by_name(name: str):
    return UPDATE_FAULTS.get(name) or kernel_fault(name)
