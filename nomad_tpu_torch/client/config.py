"""Client configuration.

Reference: upstream client/config/config.go. ``options`` is the
namespaced free-form map consumed by drivers and fingerprinters via
read/read_default (config.go:51-75).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional



@dataclass
class ClientConfig:
    dev_mode: bool = False
    state_dir: str = ""
    alloc_dir: str = ""
    region: str = "global"
    datacenter: str = "dc1"
    node_name: str = ""
    node_class: str = ""
    node_meta: Dict[str, str] = field(default_factory=dict)
    servers: List[str] = field(default_factory=list)
    # Namespaced key-value options, e.g. {"driver.raw_exec.enable": "1"}
    options: Dict[str, str] = field(default_factory=dict)
    # In-process RPC short-circuit (reference: config.go:44-46 RPCHandler);
    # a Server instance in single-process mode.
    rpc_handler: object = None
    heartbeat_grace: float = 0.5
    # TLS for the client->server RPC path (nomad_tpu_torch.tlsutil.TLSConfig
    # or None): must match the servers' tls block or every RPC handshake
    # fails against their TLS listeners.
    tls: object = None

    def read(self, key: str) -> Optional[str]:
        return self.options.get(key)

    def read_default(self, key: str, default: str) -> str:
        return self.options.get(key, default)

    def read_bool_default(self, key: str, default: bool) -> bool:
        val = self.options.get(key)
        if val is None:
            return default
        return val.lower() in ("1", "true", "t", "yes")

