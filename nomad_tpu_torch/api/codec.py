"""JSON codec for the data model: dataclass <-> dict, recursively.

The reference serializes Go structs through encoding/json with field names;
our wire format is the dataclass field names (snake_case). Unknown keys are
ignored on decode so the API tolerates newer clients.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional, Type, get_args, get_origin, get_type_hints

_HINT_CACHE: Dict[type, Dict[str, Any]] = {}


def to_dict(obj: Any) -> Any:
    """Recursively convert dataclasses/lists/dicts to JSON-able values.
    Columnar types (AllocBatch) serialize through their own to_wire —
    columns stay columns on the wire."""
    if hasattr(type(obj), "to_wire"):
        return obj.to_wire()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    return obj


def _hints(cls: type) -> Dict[str, Any]:
    hints = _HINT_CACHE.get(cls)
    if hints is None:
        hints = get_type_hints(cls)
        _HINT_CACHE[cls] = hints
    return hints


def from_dict(cls: Type, data: Any) -> Any:
    """Build ``cls`` from a JSON dict, recursing through field type hints."""
    if data is None:
        return None
    if not dataclasses.is_dataclass(cls):
        return data
    hints = _hints(cls)
    kwargs = {}
    field_names = {f.name for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in field_names:
            continue
        kwargs[key] = _convert(hints.get(key), value)
    return cls(**kwargs)


def _convert(hint: Any, value: Any) -> Any:
    if value is None or hint is None:
        return value
    origin = get_origin(hint)
    if origin is typing.Union:  # Optional[T]
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return _convert(args[0], value)
        return value
    if origin in (list, tuple):
        (item_type,) = get_args(hint) or (Any,)
        return [_convert(item_type, v) for v in value]
    if origin is dict:
        args = get_args(hint)
        value_type = args[1] if len(args) == 2 else Any
        return {k: _convert(value_type, v) for k, v in value.items()}
    if hasattr(hint, "from_wire"):
        return hint.from_wire(value)
    if dataclasses.is_dataclass(hint):
        return from_dict(hint, value)
    return value
