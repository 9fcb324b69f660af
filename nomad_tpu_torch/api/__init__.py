"""HTTP API: server endpoints, the Python client SDK and the wire codec
(port of nomad_tpu.api).

Reference: upstream command/agent/http.go (routes + blocking-query
plumbing) and upstream api/ (the client SDK with QueryOptions /
QueryMeta / blocking-query semantics).
"""

from nomad_tpu_torch.api.client import ApiClient, ApiError, QueryMeta, QueryOptions

__all__ = ["ApiClient", "ApiError", "QueryMeta", "QueryOptions"]
