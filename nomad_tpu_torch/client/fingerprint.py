"""Node fingerprinting: detect attributes + resources of the host.

Reference: upstream client/fingerprint/ (SURVEY.md §2.4). Each
fingerprinter mutates node.attributes/resources and reports applicability;
``BUILTIN_FINGERPRINTS`` is the ordered list (fingerprint.go:17-41). Some
fingerprints are periodic (consul in the reference); the framework supports
it via ``periodic()`` returning (enabled, interval). Port of
nomad_tpu/client/fingerprint.py, with ``GPUFingerprint`` in the place of
its ``TPUFingerprint``.
"""

from __future__ import annotations

import logging
import os
import platform
import shutil
import socket
from typing import Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.structs import Node, Resources


class Fingerprint:
    """Base fingerprinter (reference: fingerprint/fingerprint.go:44-79)."""

    name = "base"
    # A fatal fingerprint's error fails the client's start; any other
    # fingerprint's error is logged and the fingerprint skipped.
    fatal = False

    def __init__(self, logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger("nomad_tpu_torch.fingerprint")

    def fingerprint(self, config, node: Node) -> bool:
        """Mutate the node; return True if this fingerprint applies."""
        raise NotImplementedError

    def periodic(self) -> Tuple[bool, float]:
        return False, 0.0


class ArchFingerprint(Fingerprint):
    """fingerprint/arch.go"""

    name = "arch"

    def fingerprint(self, config, node: Node) -> bool:
        node.attributes["arch"] = platform.machine()
        return True


class HostFingerprint(Fingerprint):
    """OS/kernel/hostname (fingerprint/host.go)."""

    name = "host"

    def fingerprint(self, config, node: Node) -> bool:
        node.attributes["os.name"] = platform.system().lower()
        node.attributes["os.version"] = platform.release()
        node.attributes["kernel.name"] = platform.system().lower()
        node.attributes["kernel.version"] = platform.release()
        node.attributes["hostname"] = socket.gethostname()
        if not node.name:
            node.name = node.attributes["hostname"]
        return True


class CPUFingerprint(Fingerprint):
    """Cores x MHz -> Resources.cpu (fingerprint/cpu.go)."""

    name = "cpu"

    def fingerprint(self, config, node: Node) -> bool:
        cores = os.cpu_count() or 1
        mhz = self._cpu_mhz()
        node.attributes["cpu.numcores"] = str(cores)
        node.attributes["cpu.frequency"] = str(int(mhz))
        total = int(cores * mhz)
        node.attributes["cpu.totalcompute"] = str(total)
        if node.resources is None:
            node.resources = Resources()
        node.resources.cpu = total
        return True

    @staticmethod
    def _cpu_mhz() -> float:
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:
                    if line.lower().startswith("cpu mhz"):
                        return float(line.split(":")[1])
        except (OSError, ValueError, IndexError):
            pass
        return 1000.0


class MemoryFingerprint(Fingerprint):
    """fingerprint/memory.go"""

    name = "memory"

    def fingerprint(self, config, node: Node) -> bool:
        total_mb = self._total_memory_mb()
        node.attributes["memory.totalbytes"] = str(total_mb * 1024 * 1024)
        if node.resources is None:
            node.resources = Resources()
        node.resources.memory_mb = total_mb
        return True

    @staticmethod
    def _total_memory_mb() -> int:
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        return int(line.split()[1]) // 1024
        except (OSError, ValueError, IndexError):
            pass
        return 1024


class StorageFingerprint(Fingerprint):
    """Disk capacity of the alloc dir volume (fingerprint/storage.go)."""

    name = "storage"

    def fingerprint(self, config, node: Node) -> bool:
        path = getattr(config, "alloc_dir", "") or "/"
        try:
            usage = shutil.disk_usage(path)
        except OSError:
            return False
        node.attributes["storage.volume"] = path
        node.attributes["storage.bytestotal"] = str(usage.total)
        node.attributes["storage.bytesfree"] = str(usage.free)
        if node.resources is None:
            node.resources = Resources()
        node.resources.disk_mb = usage.free // (1024 * 1024)
        return True


class NetworkFingerprint(Fingerprint):
    """Interface + IP + throughput (fingerprint/network_*.go). Speed
    detection falls back to a default like the reference's non-Linux path."""

    name = "network"

    DEFAULT_MBITS = 1000

    def fingerprint(self, config, node: Node) -> bool:
        from nomad_tpu_torch.structs import NetworkResource

        ip = self._default_ip()
        if ip is None:
            return False
        node.attributes["network.ip-address"] = ip
        if node.resources is None:
            node.resources = Resources()
        if not node.resources.networks:
            node.resources.networks = [
                NetworkResource(
                    device="eth0", ip=ip, cidr=f"{ip}/32",
                    mbits=self.DEFAULT_MBITS,
                )
            ]
        return True

    @staticmethod
    def _default_ip() -> Optional[str]:
        try:
            hostname = socket.gethostname()
            ip = socket.gethostbyname(hostname)
            return ip
        except OSError:
            return "127.0.0.1"


class ConsulFingerprint(Fingerprint):
    """Local consul agent probe, re-checked periodically
    (fingerprint/consul.go: 15s period)."""

    name = "consul"

    def periodic(self) -> Tuple[bool, float]:
        return True, 15.0

    def fingerprint(self, config, node: Node) -> bool:
        import json
        import urllib.request

        addr = "127.0.0.1:8500"
        if config is not None and getattr(config, "read", None):
            addr = config.read("consul.address") or addr
        try:
            with urllib.request.urlopen(
                f"http://{addr}/v1/agent/self", timeout=0.5
            ) as resp:
                info = json.loads(resp.read().decode())
        except (OSError, ValueError):
            # Periodic: clear stale attributes when the agent goes away
            for key in list(node.attributes):
                if key.startswith("consul."):
                    del node.attributes[key]
            node.links.pop("consul", None)
            return False
        cfg = info.get("Config", {})
        node.attributes["consul.server"] = str(cfg.get("Server", False)).lower()
        node.attributes["consul.version"] = cfg.get("Version", "")
        node.attributes["consul.revision"] = cfg.get("Revision", "")
        node.attributes["consul.name"] = cfg.get("NodeName", "")
        node.attributes["consul.datacenter"] = cfg.get("Datacenter", "")
        node.links["consul"] = (
            f"{cfg.get('Datacenter', '')}.{cfg.get('NodeName', '')}"
        )
        return True


class _MetadataFingerprint(Fingerprint):
    """Cloud metadata probe base (fingerprint/env_aws.go, env_gce.go): a
    fast-timeout HTTP query against the link-local metadata service, keyed
    attributes on success, silent inapplicability off-cloud."""

    metadata_url = ""
    headers: Dict[str, str] = {}
    attr_prefix = "platform"
    keys: List[str] = []

    def _get(self, path: str) -> Optional[str]:
        import urllib.request

        req = urllib.request.Request(
            self.metadata_url + path, headers=self.headers
        )
        try:
            with urllib.request.urlopen(req, timeout=0.3) as resp:
                return resp.read().decode()
        except (OSError, ValueError):
            return None

    def fingerprint(self, config, node: Node) -> bool:
        probe = self._get(self.keys[0])
        if probe is None:
            return False
        node.attributes[f"{self.attr_prefix}.{self.keys[0]}"] = probe
        for key in self.keys[1:]:
            value = self._get(key)
            if value is not None:
                node.attributes[f"{self.attr_prefix}.{key}"] = value
        return True


class EnvAWSFingerprint(_MetadataFingerprint):
    """fingerprint/env_aws.go (instance metadata incl. type/placement)."""

    name = "env_aws"
    metadata_url = "http://169.254.169.254/latest/meta-data/"
    attr_prefix = "platform.aws"
    keys = [
        "instance-type", "ami-id", "hostname", "instance-id",
        "local-hostname", "local-ipv4", "public-hostname", "public-ipv4",
        "placement/availability-zone",
    ]


class EnvGCEFingerprint(_MetadataFingerprint):
    """fingerprint/env_gce.go."""

    name = "env_gce"
    metadata_url = "http://169.254.169.254/computeMetadata/v1/instance/"
    headers = {"Metadata-Flavor": "Google"}
    attr_prefix = "platform.gce"
    keys = ["machine-type", "hostname", "id", "zone"]


class GPUFingerprint(Fingerprint):
    """The counterpart of nomad_tpu's TPUFingerprint: surface the CUDA
    cards as schedulable node attributes (``gpu.count``, ``gpu.platform``,
    ``gpu.device_kind``, ``gpu.capability`` and ``driver.gpu``), which
    job constraints select through ``$attr.*``. Gated on
    ``fingerprint.gpu.enable`` like the TPU one.

    It reads device properties only: nothing is allocated on the card,
    so it runs beside a server that already holds the CUDA context. It
    returns False only where CUDA is not available; any other error from
    ``torch.cuda`` fails the client's start (``fatal``) instead of
    hiding the device."""

    name = "gpu"
    fatal = True

    def fingerprint(self, config, node: Node) -> bool:
        enabled = False
        if config is not None and getattr(config, "read_bool_default", None):
            enabled = config.read_bool_default("fingerprint.gpu.enable", False)
        if not enabled:
            return False
        import torch

        if not torch.cuda.is_available():
            return False
        major, minor = torch.cuda.get_device_capability(0)
        node.attributes["gpu.count"] = str(torch.cuda.device_count())
        node.attributes["gpu.platform"] = "cuda"
        node.attributes["gpu.device_kind"] = torch.cuda.get_device_name(0)
        node.attributes["gpu.capability"] = f"{major}.{minor}"
        node.attributes["driver.gpu"] = "1"
        return True


BUILTIN_FINGERPRINTS: List[Callable[..., Fingerprint]] = [
    ArchFingerprint,
    ConsulFingerprint,
    CPUFingerprint,
    EnvAWSFingerprint,
    EnvGCEFingerprint,
    HostFingerprint,
    MemoryFingerprint,
    StorageFingerprint,
    NetworkFingerprint,
    GPUFingerprint,
]
