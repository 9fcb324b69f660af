"""The eval broker: p50 over the window's job submissions of their
``broker.wait`` span (enqueue → dequeue)."""

from nomadbench import stats


def read(run):
    xs = [stats.span_ms(run.spans(r["eval_id"]), "broker.wait")
          for r in run.window_records("register") if r["eval_id"]]
    return stats.median([x for x in xs if x > 0])
