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
# Per-class plans, built once: the field names to_dict walks, and the
# (field, converter) table from_dict applies. A client re-lists its
# node's allocations on every change, so the codec runs on the watch's
# hot path.
_FIELDS: Dict[type, Any] = {}
_DECODE_PLANS: Dict[type, Dict[str, Any]] = {}


def _field_names(cls: type):
    names = _FIELDS.get(cls)
    if names is None:
        if hasattr(cls, "to_wire"):
            names = False
        elif dataclasses.is_dataclass(cls):
            names = tuple(f.name for f in dataclasses.fields(cls))
        else:
            names = None
        _FIELDS[cls] = names
    return names


def to_dict(obj: Any) -> Any:
    """Recursively convert dataclasses/lists/dicts to JSON-able values.
    Columnar types (AllocBatch) serialize through their own to_wire —
    columns stay columns on the wire."""
    cls = type(obj)
    if cls in _SCALARS:
        return obj
    names = _field_names(cls)
    if names is False:
        return obj.to_wire()
    if names is not None and not isinstance(obj, type):
        return {name: to_dict(getattr(obj, name)) for name in names}
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    return obj


_SCALARS = frozenset((str, int, float, bool, type(None)))


def _hints(cls: type) -> Dict[str, Any]:
    hints = _HINT_CACHE.get(cls)
    if hints is None:
        hints = get_type_hints(cls)
        _HINT_CACHE[cls] = hints
    return hints


def _decode_plan(cls: type) -> Dict[str, Any]:
    """field -> converter (None: the value passes as it is)."""
    plan = _DECODE_PLANS.get(cls)
    if plan is None:
        hints = _hints(cls)
        plan = {}
        for f in dataclasses.fields(cls):
            hint = hints.get(f.name)
            if (hint is None or get_origin(hint) is not None
                    or hasattr(hint, "from_wire")
                    or dataclasses.is_dataclass(hint)):
                plan[f.name] = hint
            else:
                plan[f.name] = None
        _DECODE_PLANS[cls] = plan
    return plan


def from_dict(cls: Type, data: Any) -> Any:
    """Build ``cls`` from a JSON dict, recursing through field type hints."""
    if data is None:
        return None
    if not dataclasses.is_dataclass(cls):
        return data
    plan = _decode_plan(cls)
    kwargs = {}
    for key, value in data.items():
        if key not in plan:
            continue
        hint = plan[key]
        kwargs[key] = value if hint is None else _convert(hint, value)
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
