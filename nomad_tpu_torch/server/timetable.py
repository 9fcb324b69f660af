"""TimeTable: Raft index <-> wall clock mapping for GC cutoffs.

Port of nomad_tpu/server/timetable.py (upstream nomad/timetable.go:
5-minute granularity, 72h retention, fsm.go:24-28).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import List, Tuple

DEFAULT_GRANULARITY = 5 * 60.0
DEFAULT_LIMIT = 72 * 3600.0


class TimeTable:
    def __init__(
        self,
        granularity: float = DEFAULT_GRANULARITY,
        limit: float = DEFAULT_LIMIT,
    ):
        self.granularity = granularity
        self.limit = limit
        self._lock = threading.Lock()
        # Sorted list of (timestamp, index)
        self._table: List[Tuple[float, int]] = []

    def witness(self, index: int, when: float = None) -> None:
        """Record (index, time), coalescing within granularity
        (timetable.go Witness)."""
        if when is None:
            # nomadlint: allow(DET002) -- the table IS the raft-index ->
            # wall-clock mapping and serializes across restarts; a
            # monotonic stamp would be meaningless in the next process.
            when = time.time()
        with self._lock:
            if self._table and when - self._table[-1][0] < self.granularity:
                return
            self._table.append((when, index))
            # Prune beyond the retention limit
            cutoff = when - self.limit
            while self._table and self._table[0][0] < cutoff:
                self._table.pop(0)

    def nearest_index(self, when: float) -> int:
        """Largest index witnessed at or before ``when``
        (timetable.go NearestIndex)."""
        with self._lock:
            pos = bisect.bisect_right([t for t, _ in self._table], when)
            if pos == 0:
                return 0
            return self._table[pos - 1][1]

    def serialize(self) -> List[Tuple[float, int]]:
        with self._lock:
            return list(self._table)

    def deserialize(self, table: List[Tuple[float, int]]) -> None:
        with self._lock:
            self._table = list(table)
