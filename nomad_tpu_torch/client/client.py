"""Client: the node agent.

Reference: upstream client/client.go — node setup with a persistent
ID, fingerprinting, driver discovery, register + heartbeat loops, the
blocking alloc watch (client.go:629-675), the alloc diff/runner plumbing
(client.go:678-756), and periodic state persistence.

RPC: in single-process mode the client short-circuits to a Server object
(the reference's config.RPCHandler testing posture, client/config.go:44-46);
the network RPC layer slots in behind the same `` _rpc_* `` seams.
Port of nomad_tpu/client/client.py: a fatal fingerprint (the GPU one)
fails the client's construction, and a TLS config raises until
tlsutil.py is ported.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch import structs
from nomad_tpu_torch.client.alloc_runner import AllocRunner
from nomad_tpu_torch.client.config import ClientConfig
from nomad_tpu_torch.client.driver.driver import builtin_driver_classes
from nomad_tpu_torch.client.fingerprint import BUILTIN_FINGERPRINTS
from nomad_tpu_torch.structs import Allocation, Node, Resources, generate_uuid

REGISTER_RETRY_INTERVAL = 1.0
STATE_SNAPSHOT_INTERVAL = 60.0


def diff_allocs(
    existing: Dict[str, int], updated: List[Allocation]
) -> Tuple[List[Allocation], List[str], List[Allocation], List[str]]:
    """Client-side alloc diff by modify index
    (reference: client/util.go:33-80).

    existing: alloc_id -> modify_index known to the client.
    Returns (added, removed_ids, updated_allocs, ignored_ids).
    """
    added, removed, updates, ignore = [], [], [], []
    updated_ids = {}
    for alloc in updated:
        updated_ids[alloc.id] = alloc
        if alloc.id not in existing:
            added.append(alloc)
        elif alloc.modify_index != existing[alloc.id]:
            updates.append(alloc)
        else:
            ignore.append(alloc.id)
    for alloc_id in existing:
        if alloc_id not in updated_ids:
            removed.append(alloc_id)
    return added, removed, updates, ignore


class Client:
    def __init__(self, config: ClientConfig,
                 logger: Optional[logging.Logger] = None):
        self.config = config
        self.logger = logger or logging.getLogger("nomad_tpu_torch.client")
        from nomad_tpu_torch.client.servers import InProcessEndpoint, RemoteEndpoint

        if config.rpc_handler is not None:
            # In-process short-circuit (config.go:44-46 RPCHandler)
            self.endpoint = InProcessEndpoint(config.rpc_handler)
        elif config.servers:
            tls = config.tls
            self.endpoint = RemoteEndpoint(
                config.servers,
                ssl_context=(tls.outgoing_context()
                             if tls is not None else None),
            )
        else:
            raise ValueError(
                "client requires an rpc_handler (in-process server) or a "
                "non-empty servers list"
            )

        self.node: Optional[Node] = None
        self.alloc_runners: Dict[str, AllocRunner] = {}
        self._alloc_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        self._heartbeat_ttl = 1.0

        self._init_dirs()
        self._setup_node()
        self._fingerprint()
        self._setup_drivers()

    # -- setup (client.go:144-177, 369-498) ---------------------------------

    def _init_dirs(self) -> None:
        if not self.config.state_dir:
            self.config.state_dir = os.path.join(tempfile.gettempdir(),
                                                 "nomad-client-state")
        if not self.config.alloc_dir:
            self.config.alloc_dir = os.path.join(tempfile.gettempdir(),
                                                 "nomad-client-allocs")
        os.makedirs(self.config.state_dir, exist_ok=True)
        os.makedirs(self.config.alloc_dir, exist_ok=True)

    def _setup_node(self) -> None:
        """Persistent node ID (client.go:369-435)."""
        node_id_path = os.path.join(self.config.state_dir, "client-id")
        if os.path.exists(node_id_path):
            with open(node_id_path) as f:
                node_id = f.read().strip()
        else:
            node_id = generate_uuid()
            with open(node_id_path, "w") as f:
                f.write(node_id)

        self.node = Node(
            id=node_id,
            datacenter=self.config.datacenter,
            name=self.config.node_name,
            node_class=self.config.node_class,
            meta=dict(self.config.node_meta),
            resources=Resources(),
            status=structs.NODE_STATUS_INIT,
        )

    def _fingerprint(self) -> None:
        """client.go:438-477; periodic fingerprints re-run on their own
        interval once the client starts (fingerprintPeriodic :461-477)."""
        applied = []
        self._periodic_fingerprints = []
        for fp_cls in BUILTIN_FINGERPRINTS:
            fp = fp_cls(self.logger)
            try:
                if fp.fingerprint(self.config, self.node):
                    applied.append(fp.name)
            except Exception:
                if fp.fatal:
                    raise
                self.logger.exception("fingerprint %s failed", fp.name)
            enabled, interval = fp.periodic()
            if enabled:
                self._periodic_fingerprints.append((fp, interval))
        self.logger.debug("applied fingerprints: %s", applied)

    def _periodic_fingerprint_loop(self, fp, interval: float) -> None:
        while not self._shutdown.wait(interval):
            try:
                fp.fingerprint(self.config, self.node)
            except Exception:
                self.logger.exception("periodic fingerprint %s failed", fp.name)

    def _setup_drivers(self) -> None:
        """client.go:480-498"""
        available = []
        for name, cls in builtin_driver_classes().items():
            try:
                if cls.fingerprint(self.config, self.node):
                    available.append(name)
            except Exception:
                self.logger.exception("driver fingerprint %s failed", name)
        self.logger.debug("available drivers: %s", available)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._restore_state()
        self._register_node()
        for fp, interval in getattr(self, "_periodic_fingerprints", []):
            t = threading.Thread(
                target=self._periodic_fingerprint_loop, args=(fp, interval),
                daemon=True, name=f"fingerprint-{fp.name}",
            )
            t.start()
            self._threads.append(t)
        for target in (self._heartbeat_loop, self._watch_allocations,
                       self._periodic_snapshot):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"client-{target.__name__}")
            t.start()
            self._threads.append(t)

    def shutdown(self, destroy_allocs: bool = False) -> None:
        self._shutdown.set()
        self._save_state()
        if destroy_allocs:
            with self._alloc_lock:
                runners = list(self.alloc_runners.values())
            for runner in runners:
                runner.destroy()
        if hasattr(self.endpoint, "shutdown"):
            self.endpoint.shutdown()

    # -- registration + heartbeats (client.go:509-611) -----------------------

    def _register_node(self) -> None:
        while not self._shutdown.is_set():
            try:
                reply = self.endpoint.node_register(self.node)
                self._heartbeat_ttl = reply.get("heartbeat_ttl", 1.0) or 1.0
                self.logger.info("node registration complete")
                # Transition to ready
                self.endpoint.node_update_status(
                    self.node.id, structs.NODE_STATUS_READY
                )
                return
            except Exception:
                self.logger.exception("registration failure, retrying")
                if self._shutdown.wait(REGISTER_RETRY_INTERVAL):
                    return

    def _heartbeat_loop(self) -> None:
        while not self._shutdown.is_set():
            wait = max(self._heartbeat_ttl / 2.0, 0.05)
            if self._shutdown.wait(wait):
                return
            try:
                ttl = self.endpoint.node_heartbeat(self.node.id)
                if ttl:
                    self._heartbeat_ttl = ttl
            except Exception:
                self.logger.exception("heartbeat failed")

    # -- alloc watch + runner plumbing (client.go:629-756) -------------------

    def _watch_allocations(self) -> None:
        """Long-poll the server for this node's allocations via the endpoint
        (client.go:629-675; server side node_endpoint.go:328 Node.GetAllocs).
        The cursor is endpoint-specific: an (id, modify_index) view for the
        in-process watch, a MinQueryIndex for the network path."""
        cursor = None
        while not self._shutdown.is_set():
            try:
                allocs, cursor = self.endpoint.get_allocs_blocking(
                    self.node.id, cursor, timeout=0.5
                )
            except Exception:
                self.logger.exception("alloc watch failed; retrying")
                if self._shutdown.wait(1.0):
                    return
                continue
            if allocs is None:
                continue
            self._run_allocs(allocs)

    def _run_allocs(self, updated: List[Allocation]) -> None:
        """Diff and apply alloc changes (client.go:678-756)."""
        with self._alloc_lock:
            existing = {
                alloc_id: runner.alloc.modify_index
                for alloc_id, runner in self.alloc_runners.items()
            }
        # Filter allocs the server wants terminal out of 'added'
        added, removed, updates, _ignored = diff_allocs(existing, updated)

        for alloc_id in removed:
            self._remove_alloc(alloc_id)
        for alloc in updates:
            self._update_alloc(alloc)
        for alloc in added:
            if alloc.terminal_status():
                continue
            self._add_alloc(alloc)

    def _add_alloc(self, alloc: Allocation) -> None:
        runner = AllocRunner(
            alloc, self.config.alloc_dir, self._update_alloc_status,
            self.logger, options=self.config.options,
        )
        with self._alloc_lock:
            self.alloc_runners[alloc.id] = runner
        runner.run()

    def _update_alloc(self, alloc: Allocation) -> None:
        with self._alloc_lock:
            runner = self.alloc_runners.get(alloc.id)
        if runner is not None:
            runner.update(alloc)

    def _remove_alloc(self, alloc_id: str) -> None:
        with self._alloc_lock:
            runner = self.alloc_runners.pop(alloc_id, None)
        if runner is not None:
            runner.destroy()

    def _update_alloc_status(self, alloc: Allocation) -> None:
        """client.go:614-626 -> Node.UpdateAlloc"""
        try:
            self.endpoint.update_allocs([alloc])
        except Exception:
            self.logger.exception("failed to update alloc status")

    # -- state persistence (client.go:319-367) -------------------------------

    def _state_path(self) -> str:
        return os.path.join(self.config.state_dir, "client-state.json")

    def _save_state(self) -> None:
        with self._alloc_lock:
            state = {
                alloc_id: runner.snapshot_state()
                for alloc_id, runner in self.alloc_runners.items()
            }
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self._state_path())

    def _restore_state(self) -> None:
        """Recreate alloc runners and re-open driver handles
        (client.go:319-348)."""
        try:
            with open(self._state_path()) as f:
                state = json.load(f)
        except (OSError, ValueError):
            return
        for alloc_id, alloc_state in state.items():
            try:
                alloc = self.endpoint.alloc_by_id(alloc_id)
            except Exception:
                self.logger.exception("restore: alloc %s fetch failed", alloc_id)
                continue
            if alloc is None or alloc.terminal_status():
                continue
            runner = AllocRunner(
                alloc, self.config.alloc_dir, self._update_alloc_status,
                self.logger, options=self.config.options,
            )
            runner.restore(alloc_state)
            with self._alloc_lock:
                self.alloc_runners[alloc_id] = runner

    def _periodic_snapshot(self) -> None:
        while not self._shutdown.wait(STATE_SNAPSHOT_INTERVAL):
            try:
                self._save_state()
            except Exception:
                self.logger.exception("failed to save state")

    # -- introspection -------------------------------------------------------

    def num_allocs(self) -> int:
        with self._alloc_lock:
            return len(self.alloc_runners)

    def stats(self) -> Dict:
        with self._alloc_lock:
            return {
                "node_id": self.node.id,
                "num_allocations": len(self.alloc_runners),
                "heartbeat_ttl": self._heartbeat_ttl,
            }
