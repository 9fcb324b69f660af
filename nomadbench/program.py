"""What the metric readers read of the program besides its spans: its
ring of the interpreter's collection pauses (``telemetry.GC_BOOKS``) and
the shift from its span clock (``trace.now()``) to the run's
(``time.perf_counter``). A program without the ring reads as None."""

from __future__ import annotations

import time
from typing import List, Optional, Tuple


def span_shift() -> float:
    """Add to a ``trace.now()`` stamp to put it on the run's clock."""
    from nomad_tpu_torch import trace

    return time.perf_counter() - trace.now()


def window_pauses(t0: float, t1: float
                  ) -> Optional[Tuple[List[Tuple[float, float]], bool]]:
    """(pauses, whole): the ring's pauses that overlap [t0, t1] of the
    run's clock, each clipped to it, and whether the ring still holds
    every pause of [t0, t1] (once full it drops its oldest). None where
    the program keeps no such ring."""
    from nomad_tpu_torch import telemetry

    books = getattr(telemetry, "GC_BOOKS", None)
    if books is None:
        return None
    shift = span_shift()
    ring = [(s + shift, e + shift) for s, e, _gen in books.pauses()]
    whole = books.dropped == 0 or bool(ring and ring[0][0] <= t0)
    return ([(max(s, t0), min(e, t1)) for s, e in ring if e > t0 and s < t1],
            whole)
