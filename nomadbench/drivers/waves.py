"""Closed-loop batch waves: a pipeline submits a wave of batch jobs,
waits until every eval is complete, deregisters them, waits for those
evals, reaps the wave through the raft log, and starts the next.

The window closes at the end of the wave in flight at ``seconds``, so a
rate over it counts whole waves: all their work and all their time.
"""

from __future__ import annotations

import time

from nomadbench import cluster


def _specs(run, w: int):
    t = run.traffic
    return [dict(id=run.job_id(f"wave{w}-{j}"), name=f"wave-{j}",
                 type="batch", datacenters=list(t["datacenters"]),
                 constraints=[t["constraint"]], count=t["tasks_per_job"],
                 cpu=t["cpu"], memory_mb=t["memory_mb"], env={},
                 spread="waterfill")
            for j in range(t["jobs_per_wave"])]


def _submit(run, recs, kind, w, due, call, job_id, in_window):
    sent = time.perf_counter()
    rec = dict(kind=kind, group=w, due=due, sent=sent, job_id=job_id,
               in_window=in_window)
    try:
        rec["eval_id"], _ = call()
    except Exception as e:  # a refused request counts as failed
        rec["eval_id"], rec["error"] = "", repr(e)
    recs.append(run.record(**rec) if in_window else rec)


def _wait(run, recs, deadline):
    got = cluster.wait_evals(run.srv, [r["eval_id"] for r in recs
                                       if r["eval_id"]], deadline)
    for r in recs:
        r["done"], r["status"] = got.get(r["eval_id"], (None, ""))


def wave(run, w: int, in_window: bool, sample: bool) -> None:
    srv = run.srv
    specs = _specs(run, w)
    due = time.perf_counter()
    regs = []
    for s in specs:
        job = cluster.job_from_spec(s)
        _submit(run, regs, "register", w, due,
                lambda job=job: srv.job_register(job), s["id"], in_window)
    _wait(run, regs, due + cluster.EVAL_WAIT_S)
    snap = srv.state_store.snapshot()
    for r in regs:
        r["placed"] = cluster.live_count(snap, r["job_id"])
    if sample:
        run.samples.append((snap, {s["id"]: s for s in specs},
                            [r["status"] for r in regs]))
    due = time.perf_counter()
    stops = []
    for s in specs:
        _submit(run, stops, "deregister", w, due,
                lambda jid=s["id"]: srv.job_deregister(jid), s["id"],
                in_window)
    _wait(run, stops, due + cluster.EVAL_WAIT_S)
    snap = srv.state_store.snapshot()
    if sample:
        run.samples.append((snap, {s["id"]: dict(s, count=0)
                                   for s in specs},
                            [r["status"] for r in stops]))
    cluster.reap(srv, [r["eval_id"] for r in regs + stops if r["eval_id"]],
                 [s["id"] for s in specs], snap)


def setup(run) -> None:
    for w in range(run.traffic["warmup_waves"]):
        wave(run, -1 - w, in_window=False, sample=False)


def window(run, t0: float, seconds: float) -> float:
    # The wave judged in full (its placed and its stopped state), drawn
    # from the seed among the first two, which every window holds.
    judged = int(run.rng.integers(0, 2))
    w = 0
    while time.perf_counter() < t0 + seconds:
        wave(run, w, in_window=True, sample=w == judged)
        w += 1
    return time.perf_counter()


def finish(run) -> None:
    # Every wave was reaped: no task of any job may be live.
    run.samples.append((run.srv.state_store.snapshot(), {}, []))
