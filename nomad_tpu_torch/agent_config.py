"""Agent configuration files: HCL/JSON parsing + merge semantics.

Port of nomad_tpu/agent_config.py (reference: upstream
command/agent/config.go) — the agent reads any number of config
files/directories given with ``-config``; later files override earlier
ones field-by-field, maps merge key-by-key, and CLI flags override files.
Blocks: ports, addresses, advertise, client, server, telemetry, faults,
atlas, tls.

The HCL dialect is the same one job specs use, so this reuses
``nomad_tpu_torch.jobspec.hcl``; ``.json`` files parse with the stdlib.

The port adds ``device`` (default ``cuda``): where the agent's server
solves.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nomad_tpu_torch.capacity import CapacityConfig
from nomad_tpu_torch.jobspec.hcl import Block, Body, parse as parse_hcl
from nomad_tpu_torch.parallel.mesh import SolverMeshConfig
from nomad_tpu_torch.profile_observe import ProfileObserveConfig
from nomad_tpu_torch.raft_observe import RaftObserveConfig
from nomad_tpu_torch.read_observe import ReadObserveConfig
from nomad_tpu_torch.server.admission import AdmissionConfig
from nomad_tpu_torch.server.express import ExpressConfig
from nomad_tpu_torch.server.read_path import ReadPathConfig
from nomad_tpu_torch.slo import Objective

@dataclass
class Ports:
    """config.go Ports block."""

    http: int = 4646
    rpc: int = 4647
    serf: int = 4648


@dataclass
class Addresses:
    """Bind overrides per subsystem (config.go Addresses block)."""

    http: str = ""
    rpc: str = ""
    serf: str = ""


@dataclass
class AdvertiseAddrs:
    """Addresses advertised to peers (config.go AdvertiseAddrs block)."""

    rpc: str = ""
    serf: str = ""


@dataclass
class ClientBlock:
    """config.go ClientConfig block (``AgentConfig.from_file_config`` maps
    it onto the agent's client fields)."""

    enabled: bool = False
    state_dir: str = ""
    alloc_dir: str = ""
    servers: List[str] = field(default_factory=list)
    node_class: str = ""
    node_id: str = ""
    meta: Dict[str, str] = field(default_factory=dict)
    options: Dict[str, str] = field(default_factory=dict)
    network_interface: str = ""
    network_speed: int = 0


@dataclass
class ServerBlock:
    """config.go ServerConfig block with nomad_tpu's scheduling and
    backpressure knobs: ``scheduler_workers`` (``num_schedulers`` the
    legacy alias; 0 = server default), ``eval_pending_cap``,
    ``plan_queue_cap`` and ``max_blocking_watchers`` (0 = unbounded), and
    the ``admission``, ``express``, ``capacity``, ``raft_observe``,
    ``reads``, ``read_path``, ``profile`` and ``solver_mesh`` sub-blocks
    (each validated at parse time by its module's ``Config.parse``; None =
    that module's defaults)::

        server {
          eval_pending_cap = 4096
          admission { client_rate = 10  client_burst = 50 }
          express { enabled = true }
        }
    """

    enabled: bool = False
    bootstrap_expect: int = 0
    data_dir: str = ""
    protocol_version: int = 0
    num_schedulers: int = 0
    scheduler_workers: int = 0
    eval_pending_cap: int = 0
    plan_queue_cap: int = 0
    max_blocking_watchers: int = 0
    admission: Optional[Dict[str, object]] = None
    express: Optional[Dict[str, object]] = None
    capacity: Optional[Dict[str, object]] = None
    raft_observe: Optional[Dict[str, object]] = None
    reads: Optional[Dict[str, object]] = None
    read_path: Optional[Dict[str, object]] = None
    profile: Optional[Dict[str, object]] = None
    # Solver device mesh (parallel/mesh.py): ``node_shards`` devices per
    # eval row, ``eval_parallel`` rows. None = single-device solves.
    solver_mesh: Optional[Dict[str, object]] = None
    enabled_schedulers: List[str] = field(default_factory=list)
    start_join: List[str] = field(default_factory=list)


@dataclass
class Telemetry:
    """config.go Telemetry block with the eval-trace knobs:
    ``statsite_address``/``statsd_address`` add push sinks beside the
    in-memory one, ``disable_hostname`` drops the hostname from metric
    keys, ``trace_buffer_size`` bounds the retained-trace ring (0 = 256),
    ``disable_tracing`` turns span recording off, ``event_buffer_size``
    bounds the event stream ring (0 = 2048), ``histogram_buckets``
    overrides the Prometheus histogram bounds in ms (empty =
    telemetry.DEFAULT_HISTOGRAM_BUCKETS_MS). The ``slo { }`` sub-block
    declares latency objectives (``submit_to_placed_p95_ms = 250``,
    nomad_tpu_torch.slo): no block (None) means the default objectives, an
    empty ``slo { }`` disables the monitor. ``lock_watchdog`` installs
    the telemetry.LockWatchdog at agent construction."""

    statsite_address: str = ""
    statsd_address: str = ""
    disable_hostname: bool = False
    trace_buffer_size: int = 0
    disable_tracing: bool = False
    event_buffer_size: int = 0
    histogram_buckets: List[float] = field(default_factory=list)
    slo: Optional[Dict[str, float]] = None
    lock_watchdog: bool = False


@dataclass
class Atlas:
    """config.go AtlasConfig block. When ``endpoint`` is set the agent
    dials it and exposes the HTTP API over the tunnel
    (nomad_tpu_torch.scada.UplinkProvider, ref command/agent/scada.go);
    without an explicit endpoint the uplink stays off — the reference's
    default points at a defunct third-party SaaS."""

    infrastructure: str = ""
    token: str = ""
    join: bool = False
    endpoint: str = ""


@dataclass
class FaultsBlock:
    """Deterministic fault-injection plan (nomad_tpu_torch.faults)::

        faults {
          seed = 42
          sites {
            "rpc.send" = { mode = "drop"  probability = 0.2 }
          }
        }

    Faults configured here arm at agent start; the debug-gated
    ``/v1/agent/faults`` endpoint reconfigures them live."""

    seed: int = 0
    sites: Dict[str, object] = field(default_factory=dict)


@dataclass
class TLSBlock:
    """TLS for the server RPC tier and the uplink tunnel (reference:
    nomad/tlsutil feeding the rpcTLS listener arm, nomad/rpc.go:104-110).
    ``uplink`` additionally wraps the dialed atlas tunnel."""

    enabled: bool = False
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    verify_incoming: bool = True
    verify_hostname: bool = False
    uplink: bool = False


@dataclass
class FileConfig:
    """Full agent config-file surface (config.go Config struct)."""

    region: str = ""
    datacenter: str = ""
    name: str = ""
    data_dir: str = ""
    log_level: str = ""
    bind_addr: str = ""
    enable_debug: bool = False
    ports: Ports = field(default_factory=Ports)
    addresses: Addresses = field(default_factory=Addresses)
    advertise: AdvertiseAddrs = field(default_factory=AdvertiseAddrs)
    client: ClientBlock = field(default_factory=ClientBlock)
    server: ServerBlock = field(default_factory=ServerBlock)
    telemetry: Telemetry = field(default_factory=Telemetry)
    faults: FaultsBlock = field(default_factory=FaultsBlock)
    atlas: Atlas = field(default_factory=Atlas)
    tls: TLSBlock = field(default_factory=TLSBlock)
    leave_on_interrupt: bool = False
    leave_on_terminate: bool = False
    enable_syslog: bool = False
    syslog_facility: str = "LOCAL0"
    disable_update_check: bool = False
    scheduler_backend: str = ""  # 'tpu' | 'host'
    device: str = ""  # where the server solves: 'cuda' (default), 'cpu'

    # -- merge ------------------------------------------------------------

    def merge(self, other: "FileConfig") -> "FileConfig":
        """Field-by-field override by ``other`` (config.go Merge): scalars
        override when set, maps/lists merge/extend, nested blocks recurse."""
        out = FileConfig()
        for name in (
            "region", "datacenter", "name", "data_dir", "log_level",
            "bind_addr", "syslog_facility", "scheduler_backend", "device",
        ):
            setattr(out, name, getattr(other, name) or getattr(self, name))
        for name in (
            "enable_debug", "leave_on_interrupt", "leave_on_terminate",
            "enable_syslog", "disable_update_check",
        ):
            setattr(out, name, getattr(other, name) or getattr(self, name))

        out.ports = Ports(
            http=other.ports.http if other.ports.http != 4646 else self.ports.http,
            rpc=other.ports.rpc if other.ports.rpc != 4647 else self.ports.rpc,
            serf=other.ports.serf if other.ports.serf != 4648 else self.ports.serf,
        )
        out.addresses = Addresses(
            http=other.addresses.http or self.addresses.http,
            rpc=other.addresses.rpc or self.addresses.rpc,
            serf=other.addresses.serf or self.addresses.serf,
        )
        out.advertise = AdvertiseAddrs(
            rpc=other.advertise.rpc or self.advertise.rpc,
            serf=other.advertise.serf or self.advertise.serf,
        )
        out.client = ClientBlock(
            enabled=other.client.enabled or self.client.enabled,
            state_dir=other.client.state_dir or self.client.state_dir,
            alloc_dir=other.client.alloc_dir or self.client.alloc_dir,
            servers=self.client.servers + [
                s for s in other.client.servers if s not in self.client.servers
            ],
            node_class=other.client.node_class or self.client.node_class,
            node_id=other.client.node_id or self.client.node_id,
            meta={**self.client.meta, **other.client.meta},
            options={**self.client.options, **other.client.options},
            network_interface=(
                other.client.network_interface or self.client.network_interface
            ),
            network_speed=other.client.network_speed or self.client.network_speed,
        )
        out.server = ServerBlock(
            enabled=other.server.enabled or self.server.enabled,
            bootstrap_expect=(
                other.server.bootstrap_expect or self.server.bootstrap_expect
            ),
            data_dir=other.server.data_dir or self.server.data_dir,
            protocol_version=(
                other.server.protocol_version or self.server.protocol_version
            ),
            num_schedulers=other.server.num_schedulers or self.server.num_schedulers,
            scheduler_workers=(
                other.server.scheduler_workers or self.server.scheduler_workers
            ),
            eval_pending_cap=(
                other.server.eval_pending_cap or self.server.eval_pending_cap
            ),
            plan_queue_cap=(
                other.server.plan_queue_cap or self.server.plan_queue_cap
            ),
            max_blocking_watchers=(
                other.server.max_blocking_watchers
                or self.server.max_blocking_watchers
            ),
            # The sub-blocks merge key-by-key: a later file overrides one
            # knob without dropping the rest.
            **{
                name: _merge_block(getattr(self.server, name),
                                   getattr(other.server, name))
                for name in _SERVER_BLOCKS
            },
            enabled_schedulers=(
                other.server.enabled_schedulers or self.server.enabled_schedulers
            ),
            start_join=self.server.start_join + [
                a for a in other.server.start_join
                if a not in self.server.start_join
            ],
        )
        out.telemetry = Telemetry(
            statsite_address=(
                other.telemetry.statsite_address
                or self.telemetry.statsite_address
            ),
            statsd_address=(
                other.telemetry.statsd_address
                or self.telemetry.statsd_address
            ),
            disable_hostname=(
                other.telemetry.disable_hostname
                or self.telemetry.disable_hostname
            ),
            trace_buffer_size=(
                other.telemetry.trace_buffer_size
                or self.telemetry.trace_buffer_size
            ),
            disable_tracing=(
                other.telemetry.disable_tracing
                or self.telemetry.disable_tracing
            ),
            event_buffer_size=(
                other.telemetry.event_buffer_size
                or self.telemetry.event_buffer_size
            ),
            histogram_buckets=(
                list(other.telemetry.histogram_buckets)
                or list(self.telemetry.histogram_buckets)
            ),
            # Objectives merge key-by-key; an explicit empty block anywhere
            # in the chain disables, so a later `slo {}` must override.
            slo=(
                self.telemetry.slo if other.telemetry.slo is None
                else other.telemetry.slo if (not other.telemetry.slo
                                             or self.telemetry.slo is None)
                else {**self.telemetry.slo, **other.telemetry.slo}
            ),
            lock_watchdog=(
                other.telemetry.lock_watchdog
                or self.telemetry.lock_watchdog
            ),
        )
        out.faults = FaultsBlock(
            seed=other.faults.seed or self.faults.seed,
            # Site rules merge key-by-key like client.meta: a later file
            # overrides a site's whole rule (list), never splices into it.
            sites={**self.faults.sites, **other.faults.sites},
        )
        out.atlas = Atlas(
            infrastructure=(other.atlas.infrastructure
                            or self.atlas.infrastructure),
            token=other.atlas.token or self.atlas.token,
            join=other.atlas.join or self.atlas.join,
            endpoint=other.atlas.endpoint or self.atlas.endpoint,
        )
        out.tls = TLSBlock(
            enabled=other.tls.enabled or self.tls.enabled,
            ca_file=other.tls.ca_file or self.tls.ca_file,
            cert_file=other.tls.cert_file or self.tls.cert_file,
            key_file=other.tls.key_file or self.tls.key_file,
            # verify_incoming defaults True; an explicit False in either
            # layer wins (relaxation must be expressible).
            verify_incoming=(self.tls.verify_incoming
                             and other.tls.verify_incoming),
            verify_hostname=(other.tls.verify_hostname
                             or self.tls.verify_hostname),
            uplink=other.tls.uplink or self.tls.uplink,
        )
        return out


def _merge_block(base: Optional[Dict], over: Optional[Dict]) -> Optional[Dict]:
    """Key-by-key merge of two optional config sub-blocks."""
    if over is None:
        return base
    if base is None:
        return over
    return {**base, **over}


# Server sub-blocks and the parser that validates each at load time (a
# typo'd knob fails config load, not agent start).
_SERVER_BLOCKS = {
    "admission": AdmissionConfig.parse,
    "express": ExpressConfig.parse,
    "capacity": CapacityConfig.parse,
    "raft_observe": RaftObserveConfig.parse,
    "reads": ReadObserveConfig.parse,
    "read_path": ReadPathConfig.parse,
    "profile": ProfileObserveConfig.parse,
    "solver_mesh": SolverMeshConfig.parse,
}


def default_config() -> FileConfig:
    """config.go DefaultConfig."""
    cfg = FileConfig()
    cfg.region = "global"
    cfg.datacenter = "dc1"
    cfg.log_level = "INFO"
    cfg.bind_addr = "127.0.0.1"
    return cfg


def dev_config() -> FileConfig:
    """config.go DevConfig: server + client in one process, permissive
    driver options."""
    cfg = default_config()
    cfg.name = "dev-node"
    cfg.server.enabled = True
    cfg.server.bootstrap_expect = 1
    cfg.client.enabled = True
    cfg.client.options = {
        "driver.raw_exec.enable": "1",
        "driver.mock_driver.enable": "1",
    }
    return cfg


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


def _from_mapping(data: dict) -> FileConfig:
    cfg = FileConfig()
    scalars = {
        "region", "datacenter", "name", "data_dir", "log_level", "bind_addr",
        "enable_debug", "leave_on_interrupt", "leave_on_terminate",
        "enable_syslog", "syslog_facility", "disable_update_check",
        "scheduler_backend", "device",
    }
    for key, value in data.items():
        if key in scalars:
            setattr(cfg, key, value)
        elif key == "ports":
            for k, v in value.items():
                setattr(cfg.ports, k, int(v))
        elif key == "addresses":
            for k, v in value.items():
                setattr(cfg.addresses, k, v)
        elif key == "advertise":
            for k, v in value.items():
                setattr(cfg.advertise, k, v)
        elif key == "client":
            for k, v in value.items():
                if k in ("meta", "options"):
                    getattr(cfg.client, k).update(
                        {str(mk): str(mv) for mk, mv in v.items()}
                    )
                elif k == "servers":
                    cfg.client.servers = list(v)
                elif k == "network_speed":
                    cfg.client.network_speed = int(v)
                else:
                    setattr(cfg.client, k, v)
        elif key == "server":
            for k, v in value.items():
                if k in ("enabled_schedulers", "start_join"):
                    setattr(cfg.server, k, list(v))
                elif k in ("scheduler_workers", "num_schedulers"):
                    # Validated knob (both spellings): worker concurrency
                    # is a capacity commitment — reject nonsense at parse
                    # time instead of spawning a surprise at
                    # leader-establish.
                    n = int(v)
                    if not 0 <= n <= 128:
                        raise ValueError(
                            f"server.{k} must be in [0, 128], got {n}"
                        )
                    setattr(cfg.server, k, n)
                elif k in ("eval_pending_cap", "plan_queue_cap",
                           "max_blocking_watchers"):
                    # Queue/watcher bounds: parse-time validated like
                    # scheduler_workers — a typo'd cap must fail config
                    # load, not silently unbound a production queue.
                    n = int(v)
                    if not 0 <= n <= 10_000_000:
                        raise ValueError(
                            f"server.{k} must be in [0, 10000000], got {n}"
                        )
                    setattr(cfg.server, k, n)
                elif k in _SERVER_BLOCKS:
                    if not isinstance(v, dict):
                        raise ValueError(f"server.{k} must be a mapping")
                    _SERVER_BLOCKS[k](dict(v))
                    setattr(cfg.server, k, dict(v))
                elif k in ("bootstrap_expect", "protocol_version"):
                    setattr(cfg.server, k, int(v))
                else:
                    setattr(cfg.server, k, v)
        elif key == "telemetry":
            for k, v in value.items():
                if not hasattr(cfg.telemetry, k):
                    raise ValueError(f"unknown telemetry config key {k!r}")
                if k in ("trace_buffer_size", "event_buffer_size"):
                    v = int(v)
                elif k == "histogram_buckets":
                    if (not isinstance(v, (list, tuple))
                            or not all(isinstance(b, (int, float))
                                       and not isinstance(b, bool)
                                       and b > 0 for b in v)):
                        raise ValueError(
                            "telemetry.histogram_buckets must be a list "
                            "of positive numbers (bucket bounds in ms)"
                        )
                    v = sorted(float(b) for b in v)
                elif k == "slo":
                    if not isinstance(v, dict):
                        raise ValueError("telemetry.slo must be a mapping")
                    # A typo'd objective name fails config load.
                    v = {name: float(ms) for name, ms in v.items()}
                    for name, ms in v.items():
                        Objective.parse(name, ms)
                elif k == "lock_watchdog":
                    # Parse-time validated: the knob is process-global
                    # (it patches threading.Lock), so a stringly-typed
                    # truthy surprise must fail config load.
                    if not isinstance(v, bool):
                        raise ValueError(
                            "telemetry.lock_watchdog must be a boolean")
                setattr(cfg.telemetry, k, v)
        elif key == "faults":
            for k, v in value.items():
                if k == "seed":
                    cfg.faults.seed = int(v)
                elif k == "sites":
                    if not isinstance(v, dict):
                        raise ValueError("faults.sites must be a mapping")
                    cfg.faults.sites.update(v)
                else:
                    raise ValueError(f"unknown faults config key {k!r}")
        elif key == "atlas":
            for k, v in value.items():
                setattr(cfg.atlas, k, v)
        elif key == "tls":
            for k, v in value.items():
                if not hasattr(cfg.tls, k):
                    raise ValueError(f"unknown tls config key {k!r}")
                setattr(cfg.tls, k, v)
        else:
            raise ValueError(f"unknown agent config key {key!r}")
    return cfg


def _body_to_mapping(body: Body) -> dict:
    """Collapse the generic HCL AST into the JSON-equivalent mapping:
    repeated blocks merge, block labels are invalid for agent config."""
    out: dict = dict(body.assigns())
    for item in body.items:
        if isinstance(item, Block):
            if item.labels:
                raise ValueError(
                    f"agent config block {item.type!r} takes no labels"
                )
            sub = _body_to_mapping(item.body)
            if item.type in out and isinstance(out[item.type], dict):
                out[item.type].update(sub)
            else:
                out[item.type] = sub
    return out


def parse_config(text: str, name: str = "<config>") -> FileConfig:
    """Parse one config file's text: JSON if it looks like JSON, else HCL."""
    stripped = text.lstrip()
    if stripped.startswith("{"):
        return _from_mapping(json.loads(text))
    return _from_mapping(_body_to_mapping(parse_hcl(text)))


def load_config_file(path: str) -> FileConfig:
    with open(path, "r") as fh:
        return parse_config(fh.read(), name=path)


def load_config_path(path: str) -> FileConfig:
    """File or directory (directories load *.hcl / *.json sorted by name,
    like config.go LoadConfigDir)."""
    if os.path.isdir(path):
        cfg = FileConfig()
        entries = sorted(
            e for e in os.listdir(path)
            if e.endswith(".hcl") or e.endswith(".json")
        )
        for entry in entries:
            cfg = cfg.merge(load_config_file(os.path.join(path, entry)))
        return cfg
    return load_config_file(path)
