"""Stop path: the share of a roll's stops that the plan carried as block
stop runs, Σ ``stop_run`` ÷ Σ ``stop`` × 100 over the ``sched.reconcile``
spans of the window's rounds (the reconcile annotates the plan's stops,
and of them those carried as runs). None where no span carries the
``stop_run`` annotation or the annotated spans count no stop."""


def read(run):
    runs = stops = 0
    for r in run.window_records("register") + run.window_records("round"):
        if not r["eval_id"]:
            continue
        for s in run.spans(r["eval_id"]):
            ann = s.get("annotations") or {}
            if s["name"] == "sched.reconcile" and "stop_run" in ann:
                runs += ann["stop_run"]
                stops += ann.get("stop", 0)
    return 100.0 * runs / stops if stops else None
