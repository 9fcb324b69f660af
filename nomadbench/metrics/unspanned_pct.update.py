"""Host, no span: the share of the window's roll time that no leaf span
of the roll's evals (a span no other span of its trace has for parent)
and no collection pause of the program's ring covers. A roll runs from
its first record's ``due`` to its last record's ``done``. A program
without the ring counts no pause; None where its ring dropped pauses of
the window, or where no roll ended."""

from nomadbench import program
from nomadbench.devtrace import _union


def read(run):
    rolls = {}
    for r in run.window_records("register") + run.window_records("round"):
        if r["done"] is None:
            continue
        lo, hi, evals = rolls.get(r["group"], (r["due"], r["done"], []))
        evals.append(r["eval_id"])
        rolls[r["group"]] = (min(lo, r["due"]), max(hi, r["done"]), evals)
    total = sum(hi - lo for lo, hi, _e in rolls.values())
    if total <= 0:
        return None
    got = program.window_pauses(run.t0, run.t_close)
    if got is not None and not got[1]:
        return None
    covers = list(got[0]) if got is not None else []
    shift = program.span_shift()
    for _lo, _hi, evals in rolls.values():
        for eid in evals:
            spans = run.spans(eid) if eid else []
            parents = {s["parent_id"] for s in spans}
            covers += [(s["start"] + shift, s["end"] + shift) for s in spans
                       if s["end"] is not None
                       and s["span_id"] not in parents]
    merged = _union(covers)
    covered = sum(max(0.0, min(e, hi) - max(s, lo))
                  for lo, hi, _e in rolls.values() for s, e in merged)
    return 100.0 * (1.0 - covered / total)
