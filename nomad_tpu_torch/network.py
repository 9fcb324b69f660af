"""Per-node network (port + bandwidth) accounting.

Fresh implementation with the semantics of the reference NetworkIndex
(upstream nomad/structs/network.go:21-204). Port assignment is
inherently sequential and sparse, so it stays host-side; the TPU solver only
folds in dense bandwidth feasibility (SURVEY.md §7 "Hard parts").
"""

from __future__ import annotations

import ipaddress
from random import Random
from typing import Callable, Dict, List, Optional, Set, Tuple

from nomad_tpu_torch import prng
from nomad_tpu_torch.structs import Allocation, NetworkResource, Node

MIN_DYNAMIC_PORT = 20000
MAX_DYNAMIC_PORT = 60000
MAX_RAND_PORT_ATTEMPTS = 20


class NetworkIndex:
    """Indexes available vs used network resources on one node
    (reference: network.go:21-37)."""

    def __init__(self, rng: Optional[Random] = None) -> None:
        self.avail_networks: List[NetworkResource] = []
        self.avail_bandwidth: Dict[str, int] = {}
        self.used_ports: Dict[str, Set[int]] = {}
        self.used_bandwidth: Dict[str, int] = {}
        # Dynamic-port draw stream (port choices land in allocs — a
        # decision path, nomadlint DET001). Callers that draw ports MUST
        # pass their per-eval stream (EvalContext.prng): two evals whose
        # snapshots cannot see each other must not pick the same ports on
        # a shared node, or every optimistic/stale-snapshot placement
        # collides at plan verification and bounces. Without ``rng`` the
        # fallback is a node-salted stream built lazily at the first draw
        # — deterministic, and safe only for draw-free consumers
        # (allocs_fit collision checks, which never pay for seeding).
        self._rng: Optional[Random] = rng
        self._rng_external = rng is not None
        self._node_salt = 0

    def overcommitted(self) -> bool:
        """Bandwidth overcommit check (network.go:39-48)."""
        for device, used in self.used_bandwidth.items():
            if used > self.avail_bandwidth.get(device, 0):
                return True
        return False

    def set_node(self, node: Node) -> bool:
        """Set up available networks from the node; returns True on
        collision (network.go:50-70)."""
        collide = False
        if not self._rng_external:
            self._rng = None
            self._node_salt = prng.salt(node.id)
        if node.resources is not None:
            for n in node.resources.networks:
                if n.device:
                    self.avail_networks.append(n)
                    self.avail_bandwidth[n.device] = n.mbits
        if node.reserved is not None:
            for n in node.reserved.networks:
                if self.add_reserved(n):
                    collide = True
        return collide

    def add_allocs(self, allocs: List[Allocation]) -> bool:
        """Add used network resources from allocations; returns True on
        collision (network.go:72-87)."""
        collide = False
        for alloc in allocs:
            for task in alloc.task_resources.values():
                if not task.networks:
                    continue
                if self.add_reserved(task.networks[0]):
                    collide = True
        return collide

    def add_reserved(self, n: NetworkResource) -> bool:
        """Reserve ports + bandwidth; returns True on port collision
        (network.go:89-109)."""
        collide = False
        used = self.used_ports.setdefault(n.ip, set())
        for port in n.reserved_ports:
            if port in used:
                collide = True
            else:
                used.add(port)
        self.used_bandwidth[n.device] = self.used_bandwidth.get(n.device, 0) + n.mbits
        return collide

    def _yield_ips(self, cb: Callable[[NetworkResource, str], bool]) -> None:
        """Invoke cb for each candidate IP (network.go:111-134)."""
        for n in self.avail_networks:
            try:
                net = ipaddress.ip_network(n.cidr, strict=False)
            except ValueError:
                continue
            for ip in net:
                if cb(n, str(ip)):
                    return

    def assign_network(
        self, ask: NetworkResource
    ) -> Tuple[Optional[NetworkResource], str]:
        """Assign an IP + ports for a network ask; returns (offer, err)
        (network.go:136-194)."""
        result: List[NetworkResource] = []
        err = "no networks available"

        def attempt(n: NetworkResource, ip_str: str) -> bool:
            nonlocal err
            avail = self.avail_bandwidth.get(n.device, 0)
            used = self.used_bandwidth.get(n.device, 0)
            if used + ask.mbits > avail:
                err = "bandwidth exceeded"
                return False

            used_ports = self.used_ports.get(ip_str, set())
            for port in ask.reserved_ports:
                if port in used_ports:
                    err = "reserved port collision"
                    return False

            offer = NetworkResource(
                device=n.device,
                ip=ip_str,
                mbits=ask.mbits,
                reserved_ports=list(ask.reserved_ports),
                dynamic_ports=list(ask.dynamic_ports),
                offered=True,
            )

            if ask.dynamic_ports and self._rng is None:
                self._rng = prng.stream(
                    self._node_salt, "network.dynamic_ports"
                )
            for _ in range(len(ask.dynamic_ports)):
                for attempt_num in range(MAX_RAND_PORT_ATTEMPTS + 1):
                    if attempt_num == MAX_RAND_PORT_ATTEMPTS:
                        err = "dynamic port selection failed"
                        return False
                    rand_port = MIN_DYNAMIC_PORT + self._rng.randrange(
                        MAX_DYNAMIC_PORT - MIN_DYNAMIC_PORT
                    )
                    if rand_port in used_ports:
                        continue
                    if rand_port in offer.reserved_ports:
                        continue
                    offer.reserved_ports.append(rand_port)
                    break

            result.append(offer)
            err = ""
            return True

        self._yield_ips(attempt)
        if result:
            return result[0], ""
        return None, err
