"""JSON wire models (copy of `dds_tpu/http/json_protocol.py`):

    DDSSet          {"contents": [...]}
    DDSItem         {"value": x}
    DDSItemTriplet  {"value1": x, "value2": y, "value3": z}
    DDSValueResult  {"result": x}
    DDSKeysResult   {"keyset": ["...", ...]}

Values are JSON scalars (int / str / bool / null), like the reference's
`AnyJsonFormat`. The Prism analytics routes take

    MatVec          {"weights": [[w, ...], ...]}
    WeightedSum     {"weights": [w, ...]}
    GroupBySum      {"groups": {label: [record key, ...], ...}}

with int weights (or decimal strings).
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


# ---- Prism analytics wire shapes (POST /MatVec, /WeightedSum, /GroupBySum)


def _parse_weight(x) -> int:
    # bool is an int subclass; a JSON true/false weight is a client bug,
    # not a 1/0. Decimal strings carry big weights losslessly.
    if isinstance(x, int) and not isinstance(x, bool):
        return x
    if isinstance(x, str):
        try:
            return int(x)
        except ValueError:
            raise ValueError(f"non-integer weight {x!r}") from None
    raise ValueError("weights must be integers (or decimal strings)")


def parse_weight_matrix(obj) -> list[list[int]]:
    if (
        not isinstance(obj, dict)
        or not isinstance(obj.get("weights"), list)
        or not obj["weights"]
    ):
        raise ValueError("expected {'weights': [[...], ...]}")
    rows = obj["weights"]
    if not all(isinstance(r, list) for r in rows):
        raise ValueError("'weights' must be a list of weight rows")
    return [[_parse_weight(x) for x in r] for r in rows]


def parse_weight_row(obj) -> list[int]:
    if (
        not isinstance(obj, dict)
        or not isinstance(obj.get("weights"), list)
        or not obj["weights"]
    ):
        raise ValueError("expected {'weights': [...]}")
    return [_parse_weight(x) for x in obj["weights"]]


def parse_groups(obj) -> dict[str, list[str]]:
    if not isinstance(obj, dict) or not isinstance(obj.get("groups"), dict):
        raise ValueError("expected {'groups': {label: [keys...]}}")
    out: dict[str, list[str]] = {}
    for label, keys in obj["groups"].items():
        if not isinstance(keys, list) or not all(
            isinstance(k, str) for k in keys
        ):
            raise ValueError(f"group {label!r} must list record-key strings")
        out[str(label)] = keys
    return out
