"""Agent: runs a server and/or client in one process, fronted by HTTP.

Port of nomad_tpu/agent.py (reference: upstream command/agent/agent.go,
which builds server/client configs from the agent config and embeds
both, agent.go:37-151, 273-279). ``dev_mode`` gives an in-process
``Server``, otherwise a ``ClusterServer`` with an RPC bind and raft; the
client (``nomad_tpu_torch.client``) talks to the in-process server, or
to ``client_servers`` over RPC on a client-only agent; then the
``HTTPServer``. The server solves on ``device`` (default: the CUDA card;
raises without one unless the caller asks for the CPU).

``lock_watchdog`` installs :func:`telemetry.port_lock_watchdog` (the
lock-order analysis of the port's own sources) before any server lock is
built. ``setup_telemetry`` builds the metrics sinks (in-memory, plus
statsd/statsite when configured), sets the global ``Metrics`` and arms
the SIGUSR1 dump when called on the main thread. The debug surface
(``debug_info``, ``debug_bundle``) is served behind ``enable_debug``.

What needs a module the port does not have yet raises
:class:`nomad_tpu_torch.NotPortedError` naming it (``NOT_PORTED``): the
Atlas/SCADA uplink.
"""

from __future__ import annotations

import logging
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from nomad_tpu_torch import NotPortedError
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.server.server import Server, ServerConfig

# AgentConfig fields of nomad_tpu whose modules the port does not have
# yet, with the module each needs. Setting one raises at Agent
# construction: it is never ignored.
NOT_PORTED = {
    "atlas_endpoint": "the Atlas/SCADA uplink (scada.py)",
}


@dataclass
class AgentConfig:
    """Agent-level configuration (reference: command/agent/config.go).

    nomad_tpu's keys for the solver mesh and TLS have no field here:
    their modules are not ported (``agent_config`` raises on them in a
    config file)."""

    region: str = "global"
    datacenter: str = "dc1"
    node_name: str = ""
    data_dir: str = ""
    log_level: str = "INFO"
    http_host: str = "127.0.0.1"
    http_port: int = 4646
    server_enabled: bool = False
    client_enabled: bool = False
    dev_mode: bool = False
    scheduler_backend: str = "tpu"
    # Where the server's tpu-* schedulers solve: "cuda" (the card) or
    # "cpu" (the plain PyTorch versions, asked for explicitly).
    device: str = "cuda"
    client_options: Dict[str, str] = field(default_factory=dict)
    node_class: str = ""
    node_meta: Dict[str, str] = field(default_factory=dict)
    client_servers: List[str] = field(default_factory=list)
    client_state_dir: str = ""
    client_alloc_dir: str = ""
    num_schedulers: int = 0
    enabled_schedulers: List[str] = field(default_factory=list)
    bootstrap_expect: int = 0
    eval_pending_cap: int = 0
    plan_queue_cap: int = 0
    max_blocking_watchers: int = 0
    # Admission front-door spec (server/admission.py): None = permissive.
    admission: Optional[Dict] = None
    # Express placement lane spec (server/express.py): None = lane off.
    express: Optional[Dict] = None
    # Capacity observatory spec (capacity.py): None = defaults (enabled).
    capacity: Optional[Dict] = None
    # Raft & recovery observatory spec (raft_observe.py): None = defaults.
    raft_observe: Optional[Dict] = None
    # Read-path observatory spec (read_observe.py): None = defaults.
    reads: Optional[Dict] = None
    # Follower read plane spec (server/read_path.py): None = defaults
    # (enabled); {"enabled": False} serves every read locally.
    read_path: Optional[Dict] = None
    # Runtime self-observatory spec (profile_observe.py): sampling
    # profiler + byte ledger. None = defaults (enabled).
    profile: Optional[Dict] = None
    # Declarative latency SLOs (slo.py): objective name -> threshold ms.
    # None = the default objectives; {} disables the monitor.
    slo_objectives: Optional[Dict[str, float]] = None
    enable_debug: bool = False
    statsite_addr: str = ""
    statsd_addr: str = ""
    disable_hostname_metrics: bool = False
    # Prometheus histogram bucket bounds in ms (empty = the
    # telemetry.DEFAULT_HISTOGRAM_BUCKETS_MS set).
    histogram_buckets: List[float] = field(default_factory=list)
    # Eval-lifecycle tracing (nomad_tpu_torch.trace): ring size of
    # retained traces (0 = default 256) and the master enable.
    trace_buffer_size: int = 0
    disable_tracing: bool = False
    # Lock-order and contention watchdog (telemetry.LockWatchdog over
    # the port's own lock analysis), installed at agent CONSTRUCTION:
    # locks are wrapped as they are built. Default off.
    lock_watchdog: bool = False
    # Cluster event stream ring (0 = default 2048): the
    # /v1/event/stream resume window.
    event_buffer_size: int = 0
    enable_syslog: bool = False
    syslog_facility: str = "LOCAL0"
    leave_on_interrupt: bool = False
    leave_on_terminate: bool = False
    rpc_host: str = ""
    rpc_port: int = 4647
    start_join: List[str] = field(default_factory=list)
    atlas_endpoint: str = ""
    # Deterministic fault-injection plan (nomad_tpu_torch.faults): the
    # ``faults{}`` config block as a {"seed": int, "sites": {...}} spec,
    # armed at agent start; live reconfiguration rides the debug-gated
    # /v1/agent/faults endpoint.
    faults: Optional[Dict] = None

    @classmethod
    def dev(cls) -> "AgentConfig":
        """Dev mode: server + client in one process (command.go
        DevConfig)."""
        return cls(
            server_enabled=True,
            client_enabled=True,
            dev_mode=True,
            node_name="dev-node",
            client_options={
                "driver.raw_exec.enable": "1",
                "driver.mock_driver.enable": "1",
            },
        )

    @classmethod
    def from_file_config(cls, fc) -> "AgentConfig":
        """Convert a merged agent_config.FileConfig (agent.go:47-150 builds
        nomad.Config/client.Config from the file config the same way)."""
        return cls(
            region=fc.region or "global",
            datacenter=fc.datacenter or "dc1",
            node_name=fc.name,
            data_dir=fc.data_dir,
            log_level=fc.log_level or "INFO",
            http_host=fc.addresses.http or fc.bind_addr or "127.0.0.1",
            http_port=fc.ports.http,
            server_enabled=fc.server.enabled,
            client_enabled=fc.client.enabled,
            scheduler_backend=fc.scheduler_backend or "tpu",
            device=fc.device or "cuda",
            client_options=dict(fc.client.options),
            node_class=fc.client.node_class,
            node_meta=dict(fc.client.meta),
            client_servers=list(fc.client.servers),
            client_state_dir=fc.client.state_dir,
            client_alloc_dir=fc.client.alloc_dir,
            # The first-class knob wins over the legacy alias when both
            # are set in the config files.
            num_schedulers=(fc.server.scheduler_workers
                            or fc.server.num_schedulers),
            enabled_schedulers=list(fc.server.enabled_schedulers),
            bootstrap_expect=fc.server.bootstrap_expect,
            eval_pending_cap=fc.server.eval_pending_cap,
            plan_queue_cap=fc.server.plan_queue_cap,
            max_blocking_watchers=fc.server.max_blocking_watchers,
            admission=fc.server.admission,
            express=fc.server.express,
            capacity=fc.server.capacity,
            raft_observe=fc.server.raft_observe,
            reads=fc.server.reads,
            read_path=fc.server.read_path,
            profile=(dict(fc.server.profile)
                     if fc.server.profile is not None else None),
            slo_objectives=fc.telemetry.slo,
            enable_debug=fc.enable_debug,
            statsite_addr=fc.telemetry.statsite_address,
            statsd_addr=fc.telemetry.statsd_address,
            disable_hostname_metrics=fc.telemetry.disable_hostname,
            histogram_buckets=list(fc.telemetry.histogram_buckets),
            trace_buffer_size=fc.telemetry.trace_buffer_size,
            disable_tracing=fc.telemetry.disable_tracing,
            lock_watchdog=fc.telemetry.lock_watchdog,
            event_buffer_size=fc.telemetry.event_buffer_size,
            enable_syslog=fc.enable_syslog,
            syslog_facility=fc.syslog_facility,
            leave_on_interrupt=fc.leave_on_interrupt,
            leave_on_terminate=fc.leave_on_terminate,
            rpc_host=fc.addresses.rpc or fc.bind_addr or "127.0.0.1",
            rpc_port=fc.ports.rpc,
            start_join=list(fc.server.start_join),
            faults=(
                {"seed": fc.faults.seed, "sites": dict(fc.faults.sites)}
                if fc.faults.sites else None
            ),
        )


class Agent:
    def __init__(self, config: AgentConfig,
                 logger: Optional[logging.Logger] = None):
        for key, needs in NOT_PORTED.items():
            if getattr(config, key):
                raise NotPortedError(
                    f"AgentConfig.{key} needs {needs}, which "
                    "nomad_tpu_torch does not have yet"
                )
        self.config = config
        self.logger = logger or logging.getLogger("nomad_tpu_torch.agent")
        self.server: Optional[Server] = None
        self.client: Optional[Client] = None
        self.http: Optional[object] = None
        self.client_config: Optional[ClientConfig] = None
        self.inmem_sink = None
        self.lock_watchdog = None
        if config.lock_watchdog:
            # Before _setup_server(): only locks CONSTRUCTED after
            # install() are wrapped, and the server builds its locks in
            # __init__.
            self._install_lock_watchdog()
        try:
            if config.server_enabled:
                self._setup_server()
            if config.client_enabled:
                self._setup_client()
            if self.server is None and self.client_config is None:
                raise ValueError(
                    "must have at least client or server mode enabled")
        except BaseException:
            # No agent, so no shutdown() will restore the lock factories.
            if self.lock_watchdog is not None:
                self.lock_watchdog.uninstall()
                self.lock_watchdog = None
            raise

    def _install_lock_watchdog(self) -> None:
        """telemetry{lock_watchdog = true}: wrap lock construction so every
        lock the analysis knows checks acquisition order and times its
        contention. The analysis reads the repo's ``tools/nomadlint``; in
        a deployment without it the knob degrades to a warning."""
        from nomad_tpu_torch import telemetry

        try:
            self.lock_watchdog = telemetry.port_lock_watchdog().install()
        except Exception as e:
            self.logger.warning(
                "lock_watchdog requested but unavailable "
                "(the lock-order analysis failed): %s", e)

    def _setup_server(self) -> None:
        """agent.go:153-173. Dev mode runs the in-process server (the
        reference's raft.NewInmemStore posture, server.go:420-427);
        otherwise a ClusterServer with network RPC + Raft + membership."""
        server_config = ServerConfig(
            region=self.config.region,
            datacenter=self.config.datacenter,
            node_name=self.config.node_name or "server",
            scheduler_backend=self.config.scheduler_backend,
            device=self.config.device,
            eval_pending_cap=self.config.eval_pending_cap,
            plan_queue_cap=self.config.plan_queue_cap,
            max_blocking_watchers=self.config.max_blocking_watchers,
            **{
                name: (dict(getattr(self.config, name))
                       if getattr(self.config, name) is not None else None)
                for name in ("admission", "express", "capacity",
                             "raft_observe", "reads", "read_path",
                             "profile")
            },
        )
        if self.config.event_buffer_size:
            server_config.event_buffer_size = self.config.event_buffer_size
        if self.config.slo_objectives is not None:
            server_config.slo_objectives = dict(self.config.slo_objectives)
        if self.config.num_schedulers:
            # ServerConfig resolves + validates the worker count in
            # __post_init__; a post-construction override must set the
            # resolved field too (or start() would ignore it) and re-run
            # the validator.
            server_config.num_schedulers = self.config.num_schedulers
            server_config.scheduler_workers = self.config.num_schedulers
            server_config.__post_init__()
        if self.config.enabled_schedulers:
            server_config.enabled_schedulers = list(
                self.config.enabled_schedulers
            )
        if self.config.dev_mode:
            self.server = Server(
                server_config, logger=self.logger.getChild("server")
            )
            return

        from nomad_tpu_torch.server.cluster import ClusterConfig, ClusterServer

        cluster = ClusterConfig(
            node_id=server_config.node_name,
            bind_host=self.config.rpc_host or "127.0.0.1",
            bind_port=self.config.rpc_port,
            raft_data_dir=os.path.join(self._data_dir(), "raft"),
            bootstrap_expect=self.config.bootstrap_expect,
            start_join=list(self.config.start_join),
            # Production-profile raft timing (dev/test clusters tighten
            # these like server_test.go:12-16 does).
            heartbeat_interval=0.5,
            election_timeout_min=1.0,
            election_timeout_max=2.0,
        )
        self.server = ClusterServer(
            server_config, cluster, logger=self.logger.getChild("server")
        )

    def _data_dir(self) -> str:
        return self.config.data_dir or os.path.join(
            tempfile.gettempdir(), "nomad-tpu-torch-agent")

    def _setup_client(self) -> None:
        """agent.go:175-201. The client is built at start(): its
        construction fingerprints the node and opens its endpoint."""
        if self.server is None and not self.config.client_servers:
            raise ValueError(
                "client-only mode requires a servers list in the client "
                "config block"
            )
        data_dir = self._data_dir()
        self.client_config = ClientConfig(
            dev_mode=self.config.dev_mode,
            state_dir=self.config.client_state_dir
            or os.path.join(data_dir, "client"),
            alloc_dir=self.config.client_alloc_dir
            or os.path.join(data_dir, "allocs"),
            region=self.config.region,
            datacenter=self.config.datacenter,
            node_name=self.config.node_name,
            node_class=self.config.node_class,
            node_meta=dict(self.config.node_meta),
            options=dict(self.config.client_options),
            rpc_handler=self.server,
            servers=list(self.config.client_servers),
        )

    def setup_telemetry(self) -> None:
        """Metrics sinks + SIGUSR1 dump (upstream
        command/agent/command.go:486-520) + the eval tracer, served at
        /v1/agent/metrics and the trace endpoints."""
        import threading

        from nomad_tpu_torch import telemetry, trace

        inmem, sink = telemetry.build_sink(
            statsite_addr=self.config.statsite_addr,
            statsd_addr=self.config.statsd_addr,
            histogram_buckets=self.config.histogram_buckets or None,
        )
        self.inmem_sink = inmem
        telemetry.set_global(
            telemetry.Metrics(
                sink,
                service="nomad",
                enable_hostname=not self.config.disable_hostname_metrics,
            )
        )
        self.tracer = trace.configure(
            max_traces=self.config.trace_buffer_size or 256,
            enabled=not self.config.disable_tracing,
        )
        if threading.current_thread() is threading.main_thread():
            telemetry.setup_signal_dump(inmem)

    def setup_logging(self) -> None:
        """Level gate + circular stream buffer + optional syslog."""
        from nomad_tpu_torch.logbuf import setup_agent_logging

        self.log_writer = setup_agent_logging(
            log_level=self.config.log_level,
            enable_syslog=self.config.enable_syslog,
        )

    def start(self) -> None:
        from nomad_tpu_torch.api.http import HTTPServer

        if getattr(self, "log_writer", None) is None:
            self.setup_logging()
        if self.inmem_sink is None:
            self.setup_telemetry()
        if self.config.faults:
            # Arm the configured fault plan BEFORE any subsystem starts so
            # the very first heartbeat/RPC/solve is already under test.
            # A validation error here must fail agent start loudly, not
            # leave a half-armed plan.
            from nomad_tpu_torch import faults

            faults.get_registry().load(self.config.faults)
            self.logger.warning(
                "fault injection armed: %s",
                ", ".join(sorted(self.config.faults.get("sites", {}))),
            )
        if self.server is not None:
            self.server.start()
        if self.client_config is not None:
            self.client = Client(self.client_config,
                                 self.logger.getChild("client"))
            self.client.start()
        self.http = HTTPServer(
            self, self.config.http_host, self.config.http_port,
            self.logger.getChild("http"),
        )
        self.http.start()

    def shutdown(self) -> None:
        if self.http is not None:
            self.http.shutdown()
        if self.client is not None:
            self.client.shutdown(destroy_allocs=self.config.dev_mode)
        if self.server is not None:
            self.server.shutdown()
        if self.lock_watchdog is not None:
            # Restore the real lock constructors; locks wrapped during
            # this agent's lifetime keep their (harmless) proxies.
            self.lock_watchdog.uninstall()
            self.lock_watchdog = None

    # -- info for the agent HTTP endpoints -----------------------------------

    def debug_enabled(self) -> bool:
        return self.config.enable_debug

    def debug_info(self, query: Optional[Dict] = None) -> Dict:
        """Runtime introspection for /v1/agent/debug (the pprof analog,
        upstream command/agent/http.go:115-119): thread stacks, gc stats,
        tracemalloc's top allocations (only while tracing), the server's
        device and the kernels' build info (in place of nomad_tpu's device
        probe and Pallas state), the coalescer and the mirror cache."""
        import gc
        import tracemalloc

        from nomad_tpu_torch.bundle import thread_stacks

        query = query or {}
        out: Dict = {"threads": thread_stacks(depth=8)}
        # The full-heap walk is expensive: only on an explicit truthy
        # flag, never '?objects=false'.
        want_objects = str(query.get("objects", "")).lower() in ("1", "true")
        out["gc"] = {
            "counts": list(gc.get_count()),
            "thresholds": list(gc.get_threshold()),
            "objects": len(gc.get_objects()) if want_objects else None,
        }
        if tracemalloc.is_tracing():
            snap = tracemalloc.take_snapshot()
            out["tracemalloc_top"] = [
                str(stat) for stat in snap.statistics("lineno")[:15]
            ]
        else:
            out["tracemalloc_top"] = None  # start tracing to populate
        try:
            out["device"] = (self._device_info() if self.server is not None
                             else None)
        except Exception as e:
            out["device"] = {"error": str(e)}
        try:
            from nomad_tpu_torch.ops.coalesce import GLOBAL_SOLVER

            out["coalescer"] = {
                "dispatches": GLOBAL_SOLVER.dispatches,
                "coalesced": GLOBAL_SOLVER.coalesced,
            }
        except Exception as e:
            out["coalescer"] = {"error": str(e)}
        try:
            from nomad_tpu_torch.tpu.mirror import GLOBAL_MIRROR_CACHE

            out["mirror_cache"] = GLOBAL_MIRROR_CACHE.stats()
        except Exception as e:
            out["mirror_cache"] = {"error": str(e)}
        return out

    def debug_bundle(self, query: Optional[Dict] = None) -> Dict:
        """One-shot flight recorder (/v1/agent/debug/bundle): metrics,
        traces, events, redacted config, fault plan, device statement and
        thread stacks in a single JSON artifact (nomad_tpu_torch.bundle)."""
        from nomad_tpu_torch.bundle import collect

        query = query or {}
        try:
            last_events = int(query.get("events", "0"))
        except ValueError:
            last_events = 0
        return collect(agent=self, last_events=last_events or 512)

    def self_info(self) -> Dict:
        """/v1/agent/self: nomad_tpu's keys, with the server's device (name
        and capability from torch) and the kernels' build info in place of
        its device-probe status and Pallas mode."""
        info: Dict = {
            "config": {
                "region": self.config.region,
                "datacenter": self.config.datacenter,
                "node_name": self.config.node_name,
                "server_enabled": self.config.server_enabled,
                "client_enabled": self.config.client_enabled,
                "dev_mode": self.config.dev_mode,
                "scheduler_backend": self.config.scheduler_backend,
                "device": self.config.device,
            },
            "stats": {},
        }
        if self.server is not None:
            info["stats"]["server"] = self.server.stats()
            info["stats"]["leader"] = True
            info["stats"]["device"] = self._device_info()
        if self.client is not None:
            info["stats"]["client"] = self.client.stats()
        return info

    def _device_info(self) -> Dict:
        from nomad_tpu_torch.ops.kernels import BUILD_INFO

        device = self.server.device
        dev: Dict = {"device": str(device)}
        if device.type == "cuda":
            index = device.index if device.index is not None else 0
            dev["name"] = torch.cuda.get_device_name(index)
            dev["capability"] = list(torch.cuda.get_device_capability(index))
        dev["kernels"] = {k: BUILD_INFO[k] for k in ("built", "seconds")
                          if k in BUILD_INFO}
        return dev

    def members(self) -> List[Dict]:
        if self.server is None:
            return []
        if hasattr(self.server, "members"):
            return self.server.members()
        return [
            {
                "name": self.server.config.node_name,
                "addr": self.http.addr if self.http else "",
                "status": "alive",
                "leader": True,
            }
        ]

    def server_addrs(self) -> List[str]:
        if self.server is not None and hasattr(self.server, "rpc_addr"):
            return [self.server.rpc_addr]
        if self.client_config is not None and self.client_config.servers:
            return list(self.client_config.servers)
        return [self.http.addr] if self.http and self.server else []

    def leader_addr(self) -> str:
        if self.server is not None:
            leader = getattr(self.server.raft, "leader_addr", "")
            if leader:
                return leader
        return self.http.addr if self.http and self.server else ""

    def peer_addrs(self) -> List[str]:
        if self.server is not None and hasattr(self.server, "cluster"):
            return sorted(self.server.cluster.peers.values())
        return self.server_addrs()

    def join(self, addr: str) -> int:
        if self.server is not None and hasattr(self.server, "join"):
            return self.server.join(addr)
        self.logger.warning("agent join is a no-op in single-process mode")
        return 0

    def force_leave(self, node: str) -> None:
        if self.server is not None and hasattr(self.server, "force_leave"):
            self.server.force_leave(node)
            return
        self.logger.warning("agent force-leave is a no-op in single-process mode")
