"""Log entry payload codec.

Port of nomad_tpu/raft/log_codec.py. FSM payloads carry data-model
objects; log entries must cross the wire. Upstream tags msgpack bodies
with a 1-byte MessageType (nomad/structs/structs.go:1586-1591); here each
message type maps its payload fields to dataclass types and round-trips
through the JSON codec. The encoded form is nomad_tpu's, field for field,
so a journal or an AppendEntries frame of either package decodes in the
other — with one difference: the stops of an ``alloc_update`` (its stop
copies and its block stop runs) ride as id runs (``allocs_stopped``,
structs.stop_id_runs) that the FSM resolves against its own store, where
nomad_tpu sends whole objects.
"""

from __future__ import annotations

from typing import Any, Dict

from nomad_tpu_torch.api.codec import from_dict, to_dict
from nomad_tpu_torch.structs import (
    AllocBatch,
    Allocation,
    AllocUpdateBatch,
    Evaluation,
    Job,
    Node,
    stop_id_runs,
)

# msg_type -> {payload_field: element_dataclass or None for plain values}
_SCHEMAS: Dict[str, Dict[str, Any]] = {
    "node_register": {"node": Node},
    "node_batch_register": {"nodes": [Node]},
    "node_deregister": {"node_id": None},
    "node_status_update": {"node_id": None, "status": None},
    "node_drain_update": {"node_id": None, "drain": None},
    "job_register": {"job": Job},
    "job_deregister": {"job_id": None},
    "eval_update": {"evals": [Evaluation]},
    "eval_delete": {"evals": None, "allocs": None},
    "alloc_update": {"allocs": [Allocation], "alloc_batches": "blocks",
                     "update_batches": "ubatches", "allocs_stopped": None},
    "alloc_client_update": {"allocs": [Allocation]},
}


def encode_payload(msg_type: str, payload: dict) -> dict:
    out = {}
    if msg_type == "alloc_update" and (payload.get("allocs")
                                       or payload.get("block_stops")):
        runs, rest = stop_id_runs(payload.get("block_stops") or (),
                                  payload.get("allocs") or [])
        payload = {k: v for k, v in payload.items() if k != "block_stops"}
        if runs:
            payload.update(allocs=rest, allocs_stopped=runs)
    for k, v in payload.items():
        spec = _SCHEMAS.get(msg_type, {}).get(k)
        if spec in ("blocks", "ubatches"):
            # Columnar batches carry their own compact wire form — runs/id
            # lists + shared fields, never per-Allocation rows.
            out[k] = [b.to_wire() for b in v]
        else:
            out[k] = to_dict(v)
    return out


def decode_payload(msg_type: str, payload: dict) -> dict:
    schema = _SCHEMAS.get(msg_type)
    if schema is None:
        return payload
    out = {}
    for key, value in payload.items():
        spec = schema.get(key)
        if spec is None:
            out[key] = value
        elif spec == "blocks":
            # Decode to plain batches; the FSM stamps indexes and the
            # deterministic block id at upsert (state/blocks.py from_batch).
            out[key] = [AllocBatch.from_wire(v) for v in value]
        elif spec == "ubatches":
            # Wire form carries member ids; the FSM resolves them against
            # its own store at apply (deterministic across replicas).
            out[key] = [AllocUpdateBatch.from_wire(v) for v in value]
        elif isinstance(spec, list):
            out[key] = [from_dict(spec[0], v) for v in value]
        else:
            out[key] = from_dict(spec, value)
    return out
