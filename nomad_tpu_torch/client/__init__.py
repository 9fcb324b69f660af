"""Client agent: the node-side muscle (port of nomad_tpu/client).

Mirrors the reference client (upstream client/, SURVEY.md §2.4):
fingerprinting the node, registering + heartbeating with servers, watching
for assigned allocations, and running them through pluggable task drivers
with restart policies and persisted state. Host code only: the one
module that touches ``torch`` is ``fingerprint.GPUFingerprint``, which
imports it when it is enabled.
"""

from nomad_tpu_torch.client.client import Client
from nomad_tpu_torch.client.config import ClientConfig

__all__ = ["Client", "ClientConfig"]
