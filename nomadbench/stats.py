"""Percentiles over all requests of a window, and the spans of the
window's evals. Plain Python."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

# The latency a request that failed, was refused or never completed
# counts with: it misses every limit.
FAILED_MS = 600_000.0


def pct(values: Iterable[float], q: float) -> Optional[float]:
    """The q-th percentile by nearest rank (the value at rank
    ceil(q/100 * n)) over all the values; None for none."""
    xs = sorted(values)
    if not xs:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[rank - 1])


def latencies_ms(records: List[dict], kind: str) -> List[float]:
    """Due→complete ms of every request of ``kind`` due in the window; a
    request that did not complete counts FAILED_MS."""
    out = []
    for r in records:
        if r["kind"] != kind or not r["in_window"]:
            continue
        if r["done"] is None or r["status"] != "complete":
            out.append(FAILED_MS)
        else:
            out.append((r["done"] - r["due"]) * 1000.0)
    return out


def span_ms(spans: List[dict], name: str) -> float:
    """Summed ms of the finished spans named ``name``."""
    return sum(s["duration_ms"] for s in spans
               if s["name"] == name and s["duration_ms"] is not None)


def median(xs: List[float]) -> Optional[float]:
    return pct(xs, 50.0)


def per_group_sums(run, kind: str, name: str) -> Dict[object, float]:
    """Span ms summed over each group (a wave, a roll) of the window's
    ``kind`` evals."""
    out: Dict[object, float] = {}
    for r in run.window_records(kind):
        out[r["group"]] = out.get(r["group"], 0.0) + span_ms(
            run.spans(r["eval_id"]), name)
    return out
