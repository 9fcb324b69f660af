"""Closed-loop destructive updates rolled to the end: a bump of the
job's task env (every allocation replaced, ``max_parallel`` a round, the
rounds ``stagger`` apart as delayed evals), and when the roll ends the
next bump. Set-up rolls ``warmup_rolls`` times after the placement: the
first roll of a freshly placed job is its own kind of step (it dissolves
the placement's block), so the window holds steady rolls alone.

The window closes at the end of the roll in flight at ``seconds``: a
roll's middle rounds are its slowest, so a rate over whole rolls keeps
all their work and all their time. Every roll is judged by its end state
and by its diff: each allocation live before it replaced, each live one
after it placed by its evals. Its placements are the allocations its
evals created that are live at its end.
"""

from __future__ import annotations

import time

from nomadbench.drivers import _update


def _roll(run, tag: str, group: int, in_window: bool) -> None:
    key = run.traffic["env_key"]
    before = run.state["snap"]
    new = _update.spec(run, env={key: f"{run.seed}-{tag}"})
    recs = _update.update(run, new, group, in_window)
    after = run.srv.state_store.snapshot()
    evals = [x["eval_id"] for x in recs if x.get("eval_id")]
    run.samples.append((after, {new["id"]: new},
                        [x["status"] for x in recs]))
    run.diffs.append((before, after, new["id"], evals, True))
    if in_window:
        run.state["rolls"].append((recs[0], before, after, set(evals)))
    run.state["spec"], run.state["snap"] = new, after


def setup(run) -> None:
    first = _update.place(run)
    run.state["spec"] = first
    run.state["snap"] = run.srv.state_store.snapshot()
    run.state["rolls"] = []
    run.samples.append((run.state["snap"], {first["id"]: first}, []))
    for w in range(run.traffic["warmup_rolls"]):
        _roll(run, f"w{w}", -1 - w, in_window=False)


def window(run, t0: float, seconds: float) -> float:
    r = 0
    while time.perf_counter() < t0 + seconds:
        _roll(run, str(r), r, in_window=True)
        r += 1
    return time.perf_counter()


def finish(run) -> None:
    job_id = run.state["spec"]["id"]
    for rec, before, after, evals in run.state["rolls"]:
        old = {aid for aid, _e in run.live_allocs(before, job_id)}
        rec["placed"] = sum(1 for aid, eid in run.live_allocs(after, job_id)
                            if eid in evals and aid not in old)
