"""Scheduler reconcile: ``sched.reconcile`` ms of a roll round (the job
read to the first solve: the block reconcile, the diff, the evictions),
the mean over every round of the window's rolls."""

from nomadbench import stats


def read(run):
    evals = run.window_records("register") + run.window_records("round")
    xs = [stats.span_ms(run.spans(r["eval_id"]), "sched.reconcile")
          for r in evals if r["eval_id"]]
    return sum(xs) / len(xs) if xs and sum(xs) > 0 else None
