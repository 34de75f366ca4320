"""JSON wire models (copy of `dds_tpu/http/json_protocol.py` without the
Prism analytics shapes):

    DDSSet          {"contents": [...]}
    DDSItem         {"value": x}
    DDSItemTriplet  {"value1": x, "value2": y, "value3": z}
    DDSValueResult  {"result": x}
    DDSKeysResult   {"keyset": ["...", ...]}

Values are JSON scalars (int / str / bool / null), like the reference's
`AnyJsonFormat`.
"""

from __future__ import annotations


def dds_set(contents: list) -> dict:
    return {"contents": contents}


def value_result(result) -> dict:
    return {"result": result}


def keys_result(keyset: list[str]) -> dict:
    return {"keyset": keyset}


def parse_set(obj) -> list:
    if not isinstance(obj, dict) or not isinstance(obj.get("contents"), list):
        raise ValueError("expected {'contents': [...]}")
    return obj["contents"]


def parse_item(obj):
    if not isinstance(obj, dict) or "value" not in obj:
        raise ValueError("expected {'value': ...}")
    return obj["value"]


def parse_triplet(obj) -> tuple:
    if not isinstance(obj, dict) or not all(f"value{i}" in obj for i in (1, 2, 3)):
        raise ValueError("expected {'value1','value2','value3'}")
    return obj["value1"], obj["value2"], obj["value3"]


def parse_range(obj) -> tuple[int, int]:
    """POST /Range body: {'value1': lo, 'value2': hi} — inclusive int
    bounds (decimal strings accepted, like every Search* item)."""
    if not isinstance(obj, dict) or not all(f"value{i}" in obj for i in (1, 2)):
        raise ValueError("expected {'value1': lo, 'value2': hi}")
    return int(obj["value1"]), int(obj["value2"])


def parse_keys(obj) -> list[str]:
    if not isinstance(obj, dict) or not isinstance(obj.get("keyset"), list):
        raise ValueError("expected {'keyset': [...]}")
    return [str(k) for k in obj["keyset"]]
