"""The hand-offs between a worker and the plan pipeline: p50 over the
window's job submissions of ``worker.submit_plan`` less the three
``plan.*`` spans inside it (the time no span covers)."""

from nomadbench import stats

INSIDE = ("plan.queue_wait", "plan.evaluate", "plan.apply")


def read(run):
    xs = []
    for r in run.window_records("register"):
        spans = run.spans(r["eval_id"]) if r["eval_id"] else []
        submit = stats.span_ms(spans, "worker.submit_plan")
        if submit > 0:
            xs.append(submit - sum(stats.span_ms(spans, n) for n in INSIDE))
    return stats.median(xs)
