"""Raft consensus: replicated log for multi-server state.

Port of nomad_tpu/raft (upstream hashicorp/raft wired at
nomad/server.go:397-500 with the FSM at nomad/fsm.go): leader election,
log replication, commitment and follower catch-up over the port's RPC
layer. It exposes the same ``apply``/``applied_index`` interface as the
in-process replication layer, so the rest of the server is unchanged.
"""

from nomad_tpu_torch.raft.node import NotLeaderError, RaftConfig, RaftNode

__all__ = ["RaftNode", "RaftConfig", "NotLeaderError"]
