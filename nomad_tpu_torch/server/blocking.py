"""Generic RPC-tier blocking-query machinery.

Port of nomad_tpu/server/blocking.py. Upstream's ``blockingRPC``
(nomad/rpc.go:270-335) is a reusable mechanism any endpoint opts into:
register watch items, run the query, retry until the result index passes
the caller's MinQueryIndex or the timeout lapses. This is that mechanism
for the port's RPC tier, over the port's state-store watch registry.

Fan-out posture (the ~50k-watcher hardening): the watch registry behind
this loop is the coalesced index-bucketed ``state.store._Watch`` —
registration samples bucket generation counters and the writer's notify is
O(touched items) regardless of how many watchers are parked (the old
per-watcher ``Event.set()`` fan-out cost the FSM apply thread O(watchers)
per write; nomad_tpu's tests/test_wake_storm.py pins the difference). A watcher woken
by a bucket-sharing neighbor simply re-probes its index and re-parks —
the loop below has always tolerated spurious wakes. Registrations are
bounded (``_Watch.max_watchers``, the ``max_blocking_watchers`` server
knob): past the cap ``register`` raises a typed
``RejectError(WATCH_LIMIT)`` which propagates to the RPC/HTTP caller as a
cheap 503-with-retry-after instead of unbounded registry growth.

One subtlety upstream doesn't have: a raft snapshot install rebinds
``fsm.state`` to a fresh StateStore, so the live store must be re-read
every pass and the watch registration raced against the rebind (the old
store fires ``notify_all`` on replacement, and an identity re-check after
registration closes the remaining window).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Tuple

# Server-side clamp on client-requested waits (rpc.go maxQueryTime analog).
MAX_QUERY_TIME = 10.0


def blocking_query(
    get_store: Callable[[], object],
    items: Callable[[object], Iterable[Tuple[str, str]]],
    run: Callable[[object], Tuple[int, object]],
    min_index: int,
    timeout: float,
    max_timeout: float = MAX_QUERY_TIME,
    index_of: Callable[[object], int] = None,
) -> Tuple[int, object]:
    """Run ``run(store)`` until its index passes ``min_index`` or the
    timeout lapses (rpc.go:270-335 semantics).

    - ``get_store``: returns the CURRENT live store (re-read each pass —
      a snapshot restore rebinds it).
    - ``items``: watch items to park on, given the store.
    - ``run``: executes the query; returns (index, result). The index is
      the query's table/item index (QueryMeta.Index analog).
    - ``min_index`` <= 0 or a fresh-enough index returns immediately.
    - ``index_of``: cheap index-only probe used for the post-registration
      re-check (defaults to running the full query and dropping the
      result).

    Returns the final (index, result) — on timeout, the last read.
    Raises ``structs.RejectError(WATCH_LIMIT)`` when the store's watcher
    cap refuses the registration (typed, retry-after-hinted — never a
    silent park).
    """
    if index_of is None:
        index_of = lambda store: run(store)[0]  # noqa: E731
    timeout = min(timeout, max_timeout)
    end = time.monotonic() + timeout
    while True:
        store = get_store()
        # Index probe first: the full query (which may materialize a large
        # result) runs only when it will actually be returned.
        remaining = end - time.monotonic()
        if index_of(store) > min_index or remaining <= 0:
            return run(store)
        ticket = store.watch.register(list(items(store)))
        try:
            # Identity re-check closes the register-vs-rebind race; a
            # rebind after registration fires notify_all on the old store,
            # so a full-length wait is safe. The index re-check closes the
            # write-between-run-and-register race the same way (the
            # register-then-recheck protocol _Watch's coalesced buckets
            # rely on for their no-lost-wakeup argument).
            if (get_store() is store
                    and index_of(store) <= min_index):
                fired = store.watch.wait(ticket, timeout=remaining)
                if fired and index_of(store) <= min_index:
                    # Bucket-sharing neighbor's publish woke us but our
                    # index never moved: the re-probe-and-re-park cost
                    # the coalesced registry trades for O(items)
                    # publishes. Plain counter; read_observe drains it.
                    store.watch.spurious_wakes += 1
        finally:
            store.watch.unregister(ticket)
