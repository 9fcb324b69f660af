"""Stop path: the share of a roll's stops that committed as stopped
blocks, Σ ``stops_columnar`` ÷ Σ (``stops_columnar`` + ``stops_rows``)
× 100 over the ``fsm.apply`` spans of the window's rounds (the FSM
annotates an entry that carries stop runs). None where no span carries
the annotation or the annotated spans count no stop."""


def read(run):
    columnar = rows = 0
    for r in run.window_records("register") + run.window_records("round"):
        if not r["eval_id"]:
            continue
        for s in run.spans(r["eval_id"]):
            ann = s.get("annotations") or {}
            if s["name"] == "fsm.apply" and "stops_columnar" in ann:
                columnar += ann["stops_columnar"]
                rows += ann.get("stops_rows", 0)
    total = columnar + rows
    return 100.0 * columnar / total if total else None
