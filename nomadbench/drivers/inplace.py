"""Closed-loop in-place updates: the job's task cpu bumped by
``cpu_bump`` and back, each bump waited for before the next. Resources
alone changed update every allocation in place, so neither kernel runs:
the window's kernel launches are compared with 0, and one bump drawn
from the seed is judged by its diff: every allocation kept."""

from __future__ import annotations

import time

from nomadbench.drivers import _update


def _bump(run, i: int, in_window: bool):
    base = run.cfg["job"]["cpu"]
    cpu = base + run.traffic["cpu_bump"] if i % 2 == 0 else base
    new = _update.spec(run, cpu=cpu)
    recs = _update.update(run, new, i, in_window)
    run.state["spec"] = new
    return [x["eval_id"] for x in recs if x.get("eval_id")]


def setup(run) -> None:
    first = _update.place(run)
    run.state["spec"] = first
    for i in range(run.traffic["warmup_bumps"]):
        _bump(run, i, in_window=False)


def window(run, t0: float, seconds: float) -> float:
    # One state judged in the window, after a bump drawn from the seed.
    judged = int(run.rng.integers(0, 3))
    i = 0
    while time.perf_counter() < t0 + seconds:
        before = run.srv.state_store.snapshot() if i == judged else None
        evals = _bump(run, i, in_window=True)
        if i == judged:
            spec = run.state["spec"]
            after = run.srv.state_store.snapshot()
            run.samples.append((after, {spec["id"]: spec}, []))
            run.diffs.append((before, after, spec["id"], evals, False))
        i += 1
    return time.perf_counter()


def finish(run) -> None:
    spec = run.state["spec"]
    statuses = [r["status"] for r in run.window_records("register")]
    run.samples.append((run.srv.state_store.snapshot(), {spec["id"]: spec},
                        statuses))
    launches = (run.counters["waterfill_launches"]
                + run.counters["greedy_launches"])
    run.extra_checks["kernel_launches"] = (launches, 0)
