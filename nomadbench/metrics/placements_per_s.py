"""Allocations the window's evals committed in the store, over the
window's seconds (a wave's placements, a roll's replacements)."""


def read(run):
    recs = [r for r in run.records if r["in_window"]]
    placed = sum(r["placed"] for r in recs)
    if not placed or run.window_s <= 0:
        return None
    return placed / run.window_s
