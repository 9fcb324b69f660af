"""Deterministic fault injection: named sites threaded through the hot paths.

FoundationDB-style simulation and Jepsen-style nemeses both rest on the same
observation: failure paths that are never driven deliberately are the ones
that break in production. The reference survives partial failure by design —
nack/delivery-limit reaping (upstream nomad/eval_broker.go), missed
heartbeats marking nodes down (nomad/heartbeat.go:84-104), Raft failover —
and this module makes those paths drivable on demand, deterministically.

Port of nomad_tpu/faults.py. The port fires the sites of the paths it
has: the RPC tier, raft replication and the server loop. The
``solver.execute`` site arrives with the slice that ports it, and until
then arming it is rejected (an inert rule would read as a chaos run that
injected nothing).

Sites (the contract between this registry and the hot paths):

==================  =========================================================
``rpc.send``        ConnPool.call, before the frame is written. ``drop`` /
                    ``partition`` raise RPCUndeliveredError (the frame never
                    left: provably-undelivered, retry-safe); ``error`` raises
                    RPCError; ``delay`` sleeps. Target: ``"<addr> <method>"``.
``rpc.recv``        RPCServer dispatch. ``drop`` runs the handler but
                    swallows the response — the caller times out with the
                    request POSSIBLY EXECUTED (RPCTimeoutError), the half of
                    the undelivered-vs-executed distinction a client-side
                    drop cannot produce; ``error`` fails the request WITHOUT
                    running the handler; ``delay`` sleeps before dispatch.
                    Target: the method name.
``raft.append``     Leader replication fan-out (message loss). ``drop``
                    skips one AppendEntries/InstallSnapshot to one peer.
                    Target: ``"<self>-><peer>"`` so one-way partitions can
                    match a single direction of a single edge.
``raft.vote``       Candidate RequestVote fan-out; same semantics/target.
``fsm.apply``       State-machine apply. Only ``delay`` is honored (other
                    modes are REJECTED at arm time, see SITE_MODES): an
                    injected per-replica error would make a deterministic
                    FSM non-deterministic across the cluster, which is a
                    different bug class than anything production exhibits.
``broker.dequeue``  EvalBroker.dequeue entry. ``error`` raises BrokerError
                    at the caller; ``delay`` stalls the dequeue.
``heartbeat.tick``  Heartbeat TTL renewal. ``drop`` discards the renewal so
                    the TTL runs out and the node goes down — the missed-
                    beat path. Target: node id.
==================  =========================================================

Determinism: every rule owns a ``random.Random`` seeded from the registry
seed and the site name, and decisions consume exactly one draw per check —
so for a fixed seed the n-th check at a site always decides the same way,
run after run, regardless of what other sites do. The decision trace per
site is therefore replayable (NOMAD_TPU_CHAOS_SEED posture).

Flap windows (the chaos compiler's partition-flap vocabulary): a rule may
carry ``windows=[(start, end), ...]`` — offsets in seconds from arm time
during which the rule is live; outside every window it is disarmed and
consumes NO draw, so the in-window decision trace stays a pure function of
(seed, site, in-window check ordinal). ``flap={period, duty, count,
jitter}`` is generator sugar: ``count`` windows of ``period*duty`` seconds,
one per period, each start jittered by a draw from a SEPARATELY salted
stream (``seed ^ crc32(site + ".flap")``) so window layout never shifts the
decide() draws. Armed/disarmed transitions are counted per rule
(``transitions``) and in telemetry (``faults.<site>.window_armed`` /
``window_disarmed``); a rule past its last window's end is spent.

The disabled path costs one module-global read and a falsy check — cheap
enough for rpc/fsm hot paths. Every injected fault is counted in telemetry
(``faults.<site>.<mode>``) and annotated on the active trace span.

Configured through ``get_registry().configure`` or ``.load``; the agent
config block and the HTTP endpoint come with the agent slice.
"""

from __future__ import annotations

import threading
import time
import zlib
from random import Random
from typing import Dict, List, Optional

from nomad_tpu_torch import telemetry, trace

# Modes each site actually honors (the hot-path hooks' contract above).
# Validated at arm time: a site/mode combination the hook would ignore
# must be rejected, not armed — an inert rule still counts "fired" in
# telemetry/annotations, so a typo'd plan would read as a passing chaos
# run that injected nothing.
SITE_MODES = {
    "rpc.send": ("drop", "delay", "error", "partition"),
    "rpc.recv": ("drop", "delay", "error", "partition"),
    "raft.append": ("drop", "delay", "partition"),
    "raft.vote": ("drop", "delay", "partition"),
    "fsm.apply": ("delay",),
    "broker.dequeue": ("drop", "delay", "error"),
    "heartbeat.tick": ("drop", "delay", "partition"),
}

SITES = tuple(SITE_MODES)

MODES = ("drop", "delay", "error", "partition")


class FaultError(Exception):
    """An injected (not organic) failure."""


class FaultAction:
    """One decided injection: the caller applies site-appropriate semantics
    (raise, skip, swallow); ``fire`` has already slept ``delay`` modes,
    counted telemetry, and annotated the active span."""

    __slots__ = ("site", "mode", "delay", "rule")

    def __init__(self, site: str, mode: str, delay: float, rule: "FaultRule"):
        self.site = site
        self.mode = mode
        self.delay = delay
        self.rule = rule


class FaultRule:
    """One configured fault at one site.

    probability  chance each check fires (decided by the rule's own seeded
                 PRNG — one draw per check, so the decision sequence is a
                 pure function of (seed, site, check ordinal)).
    count        max fires; 0 = unlimited.
    duration     seconds the rule stays armed after configuration; 0 = until
                 cleared.
    delay        sleep seconds for mode='delay' (ignored otherwise).
    match        substring the call's target must contain ('' matches all) —
                 how a one-way partition names its edge.
    windows      [(start, end), ...] offsets from arm time (seconds) during
                 which the rule is live; disarmed outside all of them.
    flap         {period, duty, count, jitter} generator sugar for windows
                 (mutually exclusive with an explicit windows list).
    """

    __slots__ = ("site", "mode", "probability", "count", "duration",
                 "delay", "match", "fired", "checked", "armed_at", "_rng",
                 "windows", "flap", "transitions", "_window_armed",
                 "_window_edges", "_window_prev")

    def __init__(self, site: str, mode: str = "error",
                 probability: float = 1.0, count: int = 0,
                 duration: float = 0.0, delay: float = 0.0,
                 match: str = "", seed: int = 0,
                 windows: Optional[List] = None,
                 flap: Optional[Dict] = None):
        honored = SITE_MODES.get(site)
        if honored is None:
            raise ValueError(f"unknown fault site {site!r} (sites: {SITES})")
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r} (modes: {MODES})")
        if mode not in honored:
            raise ValueError(
                f"site {site!r} does not honor mode {mode!r} "
                f"(honored: {honored})"
            )
        if not 0.0 <= probability <= 1.0:
            raise ValueError("probability must be within [0, 1]")
        self.site = site
        self.mode = mode
        self.probability = float(probability)
        self.count = int(count)
        self.duration = float(duration)
        self.delay = float(delay)
        self.match = str(match)
        self.fired = 0
        self.checked = 0
        self.transitions = 0
        self.armed_at = time.monotonic()
        # Site-salted seed: rules at different sites draw from independent
        # deterministic streams, so adding a rule at one site never shifts
        # another site's decision sequence.
        self._rng = Random(seed ^ zlib.crc32(site.encode()))
        if windows is not None and flap is not None:
            raise ValueError("windows and flap are mutually exclusive")
        self.flap = dict(flap) if flap else None
        if flap is not None:
            windows = self._flap_windows(self.flap, site, seed)
        if windows is not None:
            windows = self._validate_windows(windows)
        self.windows = windows
        # The transition books are TIMELINE-derived, not observation-
        # derived: every window boundary is an edge on the seeded
        # timeline, and each observation (a decide() or a snapshot read)
        # books every edge crossed since the previous observation. A
        # sparse check cadence (a dropped RPC stalling its caller past a
        # whole disarmed gap) therefore books the missed disarm+arm PAIR
        # instead of silently skipping it, and a rule read after its
        # last window always reports exactly 2*len(windows) transitions.
        # The cursor starts BELOW t=0 so a first window opening exactly
        # at arm time still books its arm edge — every window always
        # contributes its full edge pair.
        self._window_edges: List = []
        self._window_armed = False
        self._window_prev = -1.0
        for start, end in windows or ():
            self._window_edges.append((start, True))
            self._window_edges.append((end, False))

    @staticmethod
    def _flap_windows(flap: Dict, site: str, seed: int) -> List:
        """Expand {period, duty, count, jitter} into an explicit window
        list: ``count`` cycles of ``period`` seconds, armed for
        ``period*duty`` at the (jittered) head of each. Start jitter draws
        from a SEPARATELY salted stream so the flap layout never consumes
        decide()'s draws, and each window is clamped inside its own cycle
        so windows cannot overlap or reorder."""
        unknown = set(flap) - {"period", "duty", "count", "jitter"}
        if unknown:
            raise ValueError(f"unknown flap keys {sorted(unknown)}")
        period = float(flap.get("period", 1.0))
        duty = float(flap.get("duty", 0.5))
        count = int(flap.get("count", 0))
        jitter = float(flap.get("jitter", 0.0))
        if period <= 0.0:
            raise ValueError("flap.period must be > 0")
        if not 0.0 < duty <= 1.0:
            raise ValueError("flap.duty must be within (0, 1]")
        if count < 1:
            raise ValueError("flap.count must be >= 1")
        if jitter < 0.0 or jitter + period * duty > period:
            raise ValueError(
                "flap.jitter must satisfy 0 <= jitter <= period*(1-duty)"
            )
        rng = Random(seed ^ zlib.crc32((site + ".flap").encode()))
        windows = []
        for i in range(count):
            base = i * period
            start = base + (rng.uniform(0.0, jitter) if jitter else 0.0)
            end = min(start + period * duty, base + period)
            windows.append((round(start, 6), round(end, 6)))
        return windows

    @staticmethod
    def _validate_windows(windows) -> List:
        if not isinstance(windows, (list, tuple)) or not windows:
            raise ValueError("windows must be a non-empty list of"
                             " [start, end] pairs")
        out = []
        prev_end = None
        for w in windows:
            if (not isinstance(w, (list, tuple)) or len(w) != 2):
                raise ValueError(f"window {w!r} must be a [start, end] pair")
            start, end = float(w[0]), float(w[1])
            if start < 0.0 or end <= start:
                raise ValueError(
                    f"window {w!r} must satisfy 0 <= start < end")
            if prev_end is not None and start < prev_end:
                raise ValueError(
                    "windows must be sorted and non-overlapping")
            prev_end = end
            out.append((start, end))
        return out

    @property
    def spent(self) -> bool:
        """Permanently inert: count budget used up or duration expired.
        The registry retires spent rules to its forensics table so the
        hot path stops paying for them."""
        return bool(
            (self.count and self.fired >= self.count)
            or (self.duration
                and time.monotonic() - self.armed_at > self.duration)
            or (self.windows is not None
                and time.monotonic() - self.armed_at >= self.windows[-1][1])
        )

    def _observe_windows(self) -> None:
        """Advance the window edge books to now: book every timeline edge
        in (last observation, now], flipping the armed state through each
        so the armed/disarmed telemetry stays per-edge accurate even when
        several edges are crossed in one gap."""
        if self.windows is None:
            return
        now = time.monotonic() - self.armed_at
        for t, armed in self._window_edges:
            if self._window_prev < t <= now:
                self._window_armed = armed
                self.transitions += 1
                telemetry.incr_counter((
                    "faults", self.site,
                    "window_armed" if armed else "window_disarmed"))
        self._window_prev = max(self._window_prev, now)

    def decide(self, target: str) -> bool:
        """One check (lock held by the registry). Consumes exactly one draw
        whenever the rule is live, even on a target mismatch — the decision
        ordinal stays aligned with the site's check ordinal. A windowed
        rule checked outside every window is disarmed: it consumes NO draw
        (the in-window decision trace stays seed-pure), and every timeline
        edge crossed since the previous check bumps the transition
        books."""
        self._observe_windows()
        if self.spent:
            return False
        if self.windows is not None and not self._window_armed:
            return False
        self.checked += 1
        hit = self.probability >= 1.0 or self._rng.random() < self.probability
        if not hit:
            return False
        if self.match and self.match not in target:
            return False
        self.fired += 1
        return True

    def to_dict(self) -> Dict:
        # Snapshot reads settle the books: a rule read after its last
        # window closed reports the full 2*count transition timeline.
        self._observe_windows()
        d = {
            "site": self.site, "mode": self.mode,
            "probability": self.probability, "count": self.count,
            "duration": self.duration, "delay": self.delay,
            "match": self.match, "fired": self.fired,
            "checked": self.checked,
        }
        if self.windows is not None:
            d["windows"] = [list(w) for w in self.windows]
            d["transitions"] = self.transitions
            if self.flap is not None:
                d["flap"] = dict(self.flap)
        return d


class FaultRegistry:
    """Thread-safe rule set, one list per site. Process-global by default
    (like the telemetry registry): in-process test clusters share it, which
    is what the ``match`` targeting exists for."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._rules: Dict[str, List[FaultRule]] = {}
        # Spent rules (count exhausted / duration expired) retire here:
        # their fired counts stay visible in snapshot() forensics, but
        # they no longer cost the hot path a lock — once everything is
        # spent, ``active`` drops and fire() is one global read again.
        self._spent: Dict[str, List[FaultRule]] = {}
        self.seed = int(seed)
        # Read lock-free on the hot path: False short-circuits fire().
        self.active = False

    def configure(self, site: str, mode: str = "error",
                  probability: float = 1.0, count: int = 0,
                  duration: float = 0.0, delay: float = 0.0,
                  match: str = "", seed: Optional[int] = None,
                  windows: Optional[List] = None,
                  flap: Optional[Dict] = None) -> FaultRule:
        rule = FaultRule(
            site, mode, probability, count, duration, delay, match,
            seed=self.seed if seed is None else int(seed),
            windows=windows, flap=flap,
        )
        with self._lock:
            self._rules.setdefault(site, []).append(rule)
            self.active = True
        return rule

    def load(self, spec: Dict) -> None:
        """Bulk-configure from a config mapping::

            {"seed": 42,
             "sites": {"broker.dequeue": {"mode": "error", "count": 2},
                       "heartbeat.tick": [{"mode": "drop", "match": "n1"},
                                          {"mode": "delay", "delay": 0.05}]}}

        REPLACES the entire armed plan (REST PUT semantics — two
        sequential plans must not merge into a contaminated experiment);
        validates everything before arming anything (a typo'd site must
        not leave a half-applied fault plan)."""
        if not isinstance(spec, dict):
            raise ValueError("faults spec must be a mapping")
        seed = int(spec.get("seed", self.seed))
        sites = spec.get("sites") or {}
        if not isinstance(sites, dict):
            raise ValueError("faults.sites must be a mapping of site -> rule")
        staged: Dict[str, List[FaultRule]] = {}
        for site, rules in sites.items():
            if isinstance(rules, dict):
                rules = [rules]
            if not isinstance(rules, list) or not all(
                isinstance(r, dict) for r in rules
            ):
                raise ValueError(
                    f"faults.sites[{site!r}] must be a rule mapping or a "
                    "list of rule mappings"
                )
            staged[site] = [
                FaultRule(
                    site,
                    mode=str(r.get("mode", "error")),
                    probability=float(r.get("probability", 1.0)),
                    count=int(r.get("count", 0)),
                    duration=float(r.get("duration", 0.0)),
                    delay=float(r.get("delay", 0.0)),
                    match=str(r.get("match", "")),
                    seed=int(r.get("seed", seed)),
                    windows=r.get("windows"),
                    flap=r.get("flap"),
                )
                for r in rules
            ]
        with self._lock:
            self.seed = seed
            self._rules = staged
            self._spent.clear()
            self.active = any(self._rules.values())

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._rules.clear()
                self._spent.clear()
            else:
                self._rules.pop(site, None)
                self._spent.pop(site, None)
            self.active = any(self._rules.values())

    def snapshot(self) -> Dict:
        """Config + fire counts. Spent
        rules stay visible (their fired counts are the chaos run's
        forensics) until cleared or overwritten by a load."""
        with self._lock:
            sites: Dict[str, List[Dict]] = {}
            for table in (self._rules, self._spent):
                for site, rules in table.items():
                    if rules:
                        sites.setdefault(site, []).extend(
                            r.to_dict() for r in rules
                        )
            return {"seed": self.seed, "active": self.active, "sites": sites}

    def check(self, site: str, target: str = "") -> Optional[FaultAction]:
        """Decide whether a fault fires at this site for this call. The
        first matching live rule wins; spent rules retire to the
        forensics table (and ``active`` drops when nothing live remains,
        making fire() lock-free again)."""
        with self._lock:
            rules = self._rules.get(site)
            if not rules:
                return None
            hit: Optional[FaultAction] = None
            for rule in rules:
                if rule.decide(target):
                    hit = FaultAction(site, rule.mode, rule.delay, rule)
                    break
            spent = [r for r in rules if r.spent]
            if spent:
                live = [r for r in rules if not r.spent]
                if live:
                    self._rules[site] = live
                else:
                    del self._rules[site]
                self._spent.setdefault(site, []).extend(spent)
                self.active = any(self._rules.values())
            return hit


_REGISTRY = FaultRegistry()


def get_registry() -> FaultRegistry:
    return _REGISTRY


def fire(site: str, target: str = "") -> Optional[FaultAction]:
    """Hot-path hook: returns the injection to apply, or None (the
    overwhelmingly common case — one global read when nothing is armed).

    For a returned action, ``delay`` sleeping, the telemetry counter
    (``faults.<site>.<mode>``) and the trace-span annotation have already
    happened; the caller applies the drop/error semantics its site defines.
    """
    reg = _REGISTRY
    if not reg.active:
        return None
    action = reg.check(site, target)
    if action is None:
        return None
    telemetry.incr_counter(("faults", site, action.mode))
    # Every injection lands in the cluster event stream too
    # (nomad_tpu_torch.events): a chaos replay from a seeded registry then
    # produces an identical per-site event sequence, and the debug bundle
    # of a failed run shows WHICH faults actually fired, interleaved with
    # the state transitions they caused. Broadcast: the registry is
    # process-global, not owned by any one server.
    from nomad_tpu_torch import events

    events.broadcast("Fault", "FaultInjected", key=site,
                     payload={"mode": action.mode, "target": target})
    span = trace.current_span()
    if span is not None:
        span.annotate(f"fault.{site}", action.mode)
    if action.mode == "delay" and action.delay > 0:
        time.sleep(action.delay)
    return action
