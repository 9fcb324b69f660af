"""Raft journal: ``raft.persist`` ms of a roll round (the entry's encode,
its JSON line and the journal append, under ``plan.apply``), the mean
over every round of the window's rolls."""

from nomadbench import stats


def read(run):
    evals = run.window_records("register") + run.window_records("round")
    xs = [stats.span_ms(run.spans(r["eval_id"]), "raft.persist")
          for r in evals if r["eval_id"]]
    return sum(xs) / len(xs) if xs and sum(xs) > 0 else None
