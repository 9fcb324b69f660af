"""The FSM: ``fsm.apply`` ms of an in-place update's plan (the
``AllocUpdateBatch``), p50 over the window's updates."""

from nomadbench import stats


def read(run):
    xs = [stats.span_ms(run.spans(r["eval_id"]), "fsm.apply")
          for r in run.window_records("register") if r["eval_id"]]
    return stats.median([x for x in xs if x > 0])
