"""JSON wire models (trimmed copy of `dds_tpu/http/json_protocol.py`):

    DDSSet          {"contents": [...]}
    DDSValueResult  {"result": x}
"""

from __future__ import annotations


def dds_set(contents: list) -> dict:
    return {"contents": contents}


def value_result(result) -> dict:
    return {"result": result}


def parse_set(obj) -> list:
    if not isinstance(obj, dict) or not isinstance(obj.get("contents"), list):
        raise ValueError("expected {'contents': [...]}")
    return obj["contents"]
