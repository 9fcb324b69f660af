"""Apply and raft commit: p50 over the window's job submissions of their
``plan.apply`` span (the raft apply with its journal write and the FSM
apply)."""

from nomadbench import stats


def read(run):
    xs = [stats.span_ms(run.spans(r["eval_id"]), "plan.apply")
          for r in run.window_records("register") if r["eval_id"]]
    return stats.median([x for x in xs if x > 0])
