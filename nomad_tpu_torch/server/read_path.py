"""Follower read plane: consistency-tiered read serving.

Port of nomad_tpu/server/read_path.py (host code).

Without this plane every ``/v1`` read is answered by whichever server the
client happened to dial — correct only when clients dial the leader. This module makes the consistency contract
explicit and promotes followers to first-class read servers. Three
lanes (the reference repo's HTTP layer carries exactly this allow-stale
posture; Consul/Nomad semantics):

- **default** — serve from the local FSM, no freshness promise beyond
  the stamped books. Any server answers; the response carries its
  last-applied raft index (``X-Nomad-LastIndex``) and measured leader-
  contact age (``X-Nomad-LastContact``, ms) so the client can judge.
- **stale** — the client OPTS IN to bounded staleness (``?stale=`` /
  ``X-Nomad-Consistency: stale``, SDK ``allow_stale=`` with a
  ``max_stale_ms`` bound). Any server answers from its own FSM iff its
  last leader contact is within the bound; past it the request is
  refused with a typed retriable ``RejectError(STALE_BOUND)`` — the
  next heartbeat (or the next server in the client's rotation) can
  satisfy the bound, and a read provably had no side effects.
- **linearizable** — a read as strong as a write, WITHOUT a raft log
  write: the leader confirms leadership via the heartbeat-riding read
  lease (one quorum wait when the lease is cold — ``RaftNode
  .read_index``, the ReadIndex protocol), and the serving server waits
  until its applied index passes the confirmed read index. A follower
  obtains the index over the ``Raft.ReadIndex`` RPC; DevMode's
  InProcRaft confirms trivially (quorum of one) with honest books.

The class is a SERVING-PATH component (it admits/refuses requests), not
an observatory: it keeps its own plain books under one lock and never
imports the read observatory (the freshness ledger split lives there;
the HTTP layer stamps role+lane into it at record time).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

from nomad_tpu_torch import telemetry
from nomad_tpu_torch.raft.node import NotLeaderError
from nomad_tpu_torch.structs import REJECT_STALE_BOUND, RejectError

# Consistency lanes (distinct from read_observe's transport lanes
# plain/blocking/sse: a blocking query can ride any consistency lane).
LANE_DEFAULT = "default"
LANE_STALE = "stale"
LANE_LINEARIZABLE = "linearizable"
CONSISTENCY_LANES = (LANE_DEFAULT, LANE_STALE, LANE_LINEARIZABLE)

ROLE_LEADER = "leader"
ROLE_FOLLOWER = "follower"


@dataclass
class ReadPathConfig:
    """The ``server { read_path { ... } }`` block, parse-time validated
    (the CapacityConfig posture: typos and nonsense ranges fail config
    load, not first use)."""

    # Gates the lane machinery: staleness-bound enforcement on the stale
    # lane and read-index confirmation on the linearizable lane. OFF
    # keeps local serving byte-identical to the pre-lane posture (every
    # lane degrades to default) — the read-storm contrast arm's leader-
    # only posture.
    enabled: bool = True
    # Staleness bound applied when a stale-lane client opts in without
    # naming one (ms of leader-contact age).
    default_max_stale_ms: float = 5000.0
    # How long the leader may spend confirming leadership for one
    # linearizable read (lease hit: ~0; cold lease: one quorum wait).
    read_index_timeout: float = 2.0
    # How long a server waits for its applied index to reach a confirmed
    # read index before refusing the linearizable read (typed,
    # retriable) — a follower further behind than this is not a useful
    # linearizable server right now.
    apply_wait_timeout: float = 2.0

    @classmethod
    def parse(cls, spec: Optional[Dict[str, Any]]) -> "ReadPathConfig":
        if spec is None:
            return cls()
        if not isinstance(spec, dict):
            raise ValueError("read_path config must be a mapping")
        known = set(cls.__dataclass_fields__)
        unknown = [k for k in spec if k not in known]
        if unknown:
            raise ValueError(
                f"unknown read_path config key(s): {sorted(unknown)} "
                f"(have: {sorted(known)})"
            )
        out = cls(**{
            k: (bool(v) if k == "enabled" else float(v))
            for k, v in spec.items()
        })
        if out.default_max_stale_ms <= 0:
            raise ValueError("read_path.default_max_stale_ms must be > 0")
        if out.read_index_timeout <= 0:
            raise ValueError("read_path.read_index_timeout must be > 0")
        if out.apply_wait_timeout <= 0:
            raise ValueError("read_path.apply_wait_timeout must be > 0")
        return out


def _q(sample) -> Dict[str, float]:
    return {
        "mean": round(sample.mean, 4),
        "max": round(sample.max, 4),
        **{k: round(v, 4) for k, v in sample.quantiles().items()},
    }


class ReadPath:
    """One server's consistency-lane front: resolves each read's lane
    BEFORE the handler runs, enforces the stale bound, obtains/awaits
    the linearizable read index, and keeps per-(role, lane) serve books.
    ``server`` is the owning Server/ClusterServer — ``server.raft`` is
    re-read per request (ClusterServer swaps InProcRaft for a RaftNode
    after construction) and ``server.confirmed_read_index`` is the seam
    followers forward through."""

    def __init__(self, server, config: Optional[ReadPathConfig] = None):
        self.server = server
        self.config = config or ReadPathConfig()
        self._lock = threading.Lock()
        self.served: Dict[str, Dict[str, int]] = {
            ROLE_LEADER: {lane: 0 for lane in CONSISTENCY_LANES},
            ROLE_FOLLOWER: {lane: 0 for lane in CONSISTENCY_LANES},
        }
        self.stale_refused = 0
        self.linear_refused = 0
        self._stale_age_ms = telemetry.AggregateSample()
        self._linear_wait_ms = telemetry.AggregateSample()

    # -- per-request lane state ---------------------------------------------

    def role(self) -> str:
        return (ROLE_LEADER if self.server.raft.is_leader
                else ROLE_FOLLOWER)

    def last_contact_ms(self) -> Optional[float]:
        """Measured leader-contact age of THIS server in ms (0.0 on the
        leader; None when a follower has never heard from a leader)."""
        age_s = self.server.raft.last_contact_s()
        return None if age_s is None else age_s * 1000.0

    def _retry_hint_s(self) -> float:
        """Retry-after for a refused read: one heartbeat interval — the
        cadence at which a follower's contact age resets."""
        cfg = getattr(self.server.raft, "config", None)
        return float(getattr(cfg, "heartbeat_interval", 0.05) or 0.05)

    def enter(self, lane: str,
              max_stale_ms: Optional[float] = None) -> Dict[str, Any]:
        """Resolve one read's consistency lane before its handler runs.
        Returns the header material: ``applied_index``,
        ``last_contact_ms`` (None = never contacted), ``role``, ``lane``
        as served, and ``read_index`` on the linearizable lane. Raises
        ``RejectError(STALE_BOUND)`` — typed, retriable, zero side
        effects — when this server cannot satisfy the asked lane."""
        if not self.config.enabled:
            lane = LANE_DEFAULT
        role = self.role()
        age_ms = self.last_contact_ms()
        out: Dict[str, Any] = {
            "role": role,
            "lane": lane,
            "applied_index": int(self.server.raft.applied_index),
            "last_contact_ms": age_ms,
        }
        if lane == LANE_STALE:
            bound = (self.config.default_max_stale_ms
                     if max_stale_ms is None else float(max_stale_ms))
            measured = float("inf") if age_ms is None else age_ms
            if measured > bound:
                with self._lock:
                    self.stale_refused += 1
                raise RejectError(
                    REJECT_STALE_BOUND,
                    f"staleness {measured:.1f}ms exceeds bound "
                    f"{bound:.1f}ms",
                    retry_after=self._retry_hint_s(),
                )
            with self._lock:
                self._stale_age_ms.ingest(measured)
        elif lane == LANE_LINEARIZABLE:
            out["read_index"] = self._await_read_index()
            out["applied_index"] = int(self.server.raft.applied_index)
        with self._lock:
            self.served[role][lane] += 1
        return out

    def _await_read_index(self) -> int:
        """Confirmed read index, then wait until the LOCAL applied index
        passes it — the serving half of the ReadIndex protocol. The
        leader's wait is a no-op (commit implies local apply here);
        a follower's wait rides the ordinary replication stream."""
        t0 = time.monotonic()
        try:
            idx = int(self.server.confirmed_read_index(
                timeout=self.config.read_index_timeout))
        except (NotLeaderError, TimeoutError) as e:
            with self._lock:
                self.linear_refused += 1
            raise RejectError(
                REJECT_STALE_BOUND,
                f"no confirmed read index: {e}",
                retry_after=self._retry_hint_s(),
            ) from e
        deadline = time.monotonic() + self.config.apply_wait_timeout
        while int(self.server.raft.applied_index) < idx:
            if time.monotonic() >= deadline:
                with self._lock:
                    self.linear_refused += 1
                raise RejectError(
                    REJECT_STALE_BOUND,
                    f"applied index {self.server.raft.applied_index} "
                    f"behind read index {idx}",
                    retry_after=self._retry_hint_s(),
                )
            time.sleep(0.001)
        with self._lock:
            self._linear_wait_ms.ingest(
                (time.monotonic() - t0) * 1000.0)
        return idx

    # -- exposition -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        raft = self.server.raft
        with self._lock:
            served = {role: dict(lanes)
                      for role, lanes in self.served.items()}
            total = sum(sum(lanes.values()) for lanes in served.values())
            follower = sum(served[ROLE_FOLLOWER].values())
            return {
                "enabled": self.config.enabled,
                "served": served,
                "requests": total,
                "follower_serve_share": (
                    round(follower / total, 4) if total else 0.0
                ),
                "stale": {
                    "refused": self.stale_refused,
                    "age_ms": _q(self._stale_age_ms),
                    "default_max_stale_ms":
                        self.config.default_max_stale_ms,
                },
                "linearizable": {
                    "refused": self.linear_refused,
                    "wait_ms": _q(self._linear_wait_ms),
                    "read_index": {
                        "calls": getattr(raft, "read_index_calls", 0),
                        "lease_hits": getattr(raft, "read_lease_hits", 0),
                        "quorum_confirms": getattr(
                            raft, "read_quorum_confirms", 0),
                        "refused": getattr(raft, "read_index_refused", 0),
                    },
                },
            }

    def summary(self) -> Dict[str, Any]:
        snap = self.snapshot()
        return {
            "enabled": snap["enabled"],
            "requests": snap["requests"],
            "follower_serve_share": snap["follower_serve_share"],
            "stale_refused": snap["stale"]["refused"],
            "stale_age_p95_ms": snap["stale"]["age_ms"].get("p95", 0.0),
            "linear_refused": snap["linearizable"]["refused"],
        }
