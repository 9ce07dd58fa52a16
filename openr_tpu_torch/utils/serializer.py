"""Deterministic wire serialization for LSDB objects.

The reference serializes thrift structs into KvStore value bytes; here
dataclasses are encoded as canonical JSON (sorted keys, no whitespace).
Determinism matters: the KvStore CRDT merge breaks same-version ties by
comparing value BYTES (KvStore.cpp:316-334), so two encodings of the same
logical object must be byte-identical.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any, Dict, Type

from openr_tpu_torch import types as T

_TYPE_REGISTRY: Dict[str, Type] = {
    cls.__name__: cls
    for cls in (
        T.Adjacency,
        T.AdjacencyDatabase,
        T.PrefixEntry,
        T.PrefixDatabase,
        T.PerfEvent,
        T.PerfEvents,
        T.MetricEntity,
        T.MetricVector,
        T.NextHop,
        T.MplsAction,
        T.UnicastRoute,
        T.MplsRoute,
    )
}

_ENUMS: Dict[str, Type] = {
    cls.__name__: cls
    for cls in (
        T.PrefixType,
        T.PrefixForwardingType,
        T.PrefixForwardingAlgorithm,
        T.CompareType,
        T.MplsActionCode,
    )
}


def _encode(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            "__t": type(obj).__name__,
            **{
                f.name: _encode(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
            },
        }
    if type(obj).__name__ in _ENUMS:
        return {"__t": type(obj).__name__, "v": obj.name}
    if isinstance(obj, bytes):
        return {"__t": "bytes", "v": obj.hex()}
    if isinstance(obj, (list, tuple)):
        return [_encode(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    return obj


# per-class decode plan: which field names are declared as tuples (list
# values must be converted back). Computed once per class — calling
# dataclasses.fields() per decoded object dominated cold-start ingest
# profiles at emulation scale.
_TUPLE_FIELDS: Dict[Type, frozenset] = {}


def _tuple_fields(cls: Type) -> frozenset:
    cached = _TUPLE_FIELDS.get(cls)
    if cached is None:
        cached = frozenset(
            f.name
            for f in dataclasses.fields(cls)
            if "Tuple" in str(f.type) or "tuple" in str(f.type)
        )
        _TUPLE_FIELDS[cls] = cached
    return cached


@functools.lru_cache(maxsize=65536)
def _ip_prefix(prefix: str) -> "T.IpPrefix":
    """IpPrefix is frozen; share parsed instances (ipaddress parsing is the
    second-hottest decode cost after field reconstruction)."""
    return T.IpPrefix(prefix)


def _decode(obj: Any) -> Any:
    if isinstance(obj, list):
        return [_decode(x) for x in obj]
    if isinstance(obj, dict):
        tname = obj.get("__t")
        if tname is None:
            return {k: _decode(v) for k, v in obj.items()}
        if tname == "IpPrefix":
            return _ip_prefix(obj["prefix"])
        if tname == "bytes":
            return bytes.fromhex(obj["v"])
        if tname in _ENUMS:
            return _ENUMS[tname][obj["v"]]
        cls = _TYPE_REGISTRY[tname]
        fields = {
            k: _decode(v) for k, v in obj.items() if k != "__t"
        }
        for name in _tuple_fields(cls):
            val = fields.get(name)
            if isinstance(val, list):
                fields[name] = tuple(val)
        return cls(**fields)
    return obj


def register_type(cls: Type) -> Type:
    """Make a wire-type dataclass decodable (journal payloads register
    KvStore Value this way). Idempotent; returns the class so it can be
    used as a decorator."""
    _TYPE_REGISTRY.setdefault(cls.__name__, cls)
    return cls


def to_jsonable(obj: Any) -> Any:
    """Encode to the tagged plain-JSON form without stringifying — for
    callers that embed wire objects inside larger JSON documents (the
    state journal's record payloads)."""
    return _encode(obj)


def from_jsonable(obj: Any) -> Any:
    """Inverse of to_jsonable."""
    return _decode(obj)


def dumps(obj: Any) -> bytes:
    return json.dumps(
        _encode(obj), sort_keys=True, separators=(",", ":")
    ).encode()


def loads(data: bytes) -> Any:
    return _decode(json.loads(data.decode()))
