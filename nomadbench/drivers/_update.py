"""What the two update kinds share: the configuration's one service job,
placed in set-up, as a plain spec."""

from __future__ import annotations

import time

from nomadbench import cluster


def spec(run, **task) -> dict:
    job = run.cfg["job"]
    out = dict(id=run.state["job_id"], name=job["name"], type=job["type"],
               datacenters=list(job["datacenters"]), constraints=[],
               count=job["count"], cpu=job["cpu"],
               memory_mb=job["memory_mb"], env={},
               max_parallel=job["max_parallel"],
               stagger_s=run.cfg["stagger_s"],
               restart_attempts=job["restart_attempts"],
               # 10,000 tasks over far more nodes: the anti-affinity
               # penalty (10) outweighs every BestFit gap (at most 18
               # between an empty node and a full one, under 1 here).
               one_per_node=True)
    out.update(task)
    return out


def place(run) -> dict:
    """Register the job and wait for its placement; returns its spec."""
    run.state["job_id"] = run.job_id("svc")
    first = spec(run)
    t = time.perf_counter()
    eid, _ = run.srv.job_register(cluster.job_from_spec(first))
    done, status = cluster.wait_eval(run.srv, eid, t + cluster.EVAL_WAIT_S)
    if done is None or status != "complete":
        raise RuntimeError(f"the job's placement ended {status or 'never'}")
    return first


def update(run, new: dict, group: int, in_window: bool) -> list:
    """Register ``new`` (an update of the job) and follow its eval and
    any delayed follow-ups to the end; returns the records, one an eval
    (kind "register" for the submission, "round" for each follow-up)."""
    due = time.perf_counter()
    sent = time.perf_counter()
    try:
        eid, _ = run.srv.job_register(cluster.job_from_spec(new))
    except Exception as e:  # a refused update counts as failed
        rec = dict(kind="register", group=group, due=due,
                   sent=sent, job_id=new["id"], error=repr(e),
                   in_window=in_window)
        return [run.record(**rec) if in_window else rec]
    chain = cluster.follow_chain(run.srv, eid, due,
                                 max_len=new["count"] + 2)
    recs, prev = [], due
    for eid, done, status in chain:
        # The submission itself, then the delayed rounds it leads to.
        rec = dict(kind="round" if recs else "register", group=group,
                   due=prev,
                   sent=sent if not recs else prev, done=done,
                   status=status, eval_id=eid, job_id=new["id"],
                   in_window=in_window)
        recs.append(run.record(**rec) if in_window else rec)
        prev = done
    return recs
