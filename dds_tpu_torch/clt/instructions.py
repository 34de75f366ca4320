"""Client instruction set: the 7 basic + 15 extended operations.

Copy of `dds_tpu/clt/instructions.py`; the port's client executes every
one of them against its route of the proxy.

Counterpart of `clt/Instructions.scala` — one dataclass per operation the
workload generator can enqueue, batched in a `Digest`. Values are
*plaintext*; the client encrypts them per-column when building the HTTP
request (the reference does the same, `clt/DDSHttpClient.scala:158-352`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class Digest:
    payload: list  # queue of instructions


# basic API -----------------------------------------------------------------

@dataclass(frozen=True)
class PutSet:
    set: Optional[list]  # None -> empty PutSet (random key)


@dataclass(frozen=True)
class GetSet:
    pass


@dataclass(frozen=True)
class AddElement:
    elem: Any


@dataclass(frozen=True)
class RemoveSet:
    pass


@dataclass(frozen=True)
class WriteElem:
    elem: Any
    pos: int


@dataclass(frozen=True)
class ReadElem:
    pos: int


@dataclass(frozen=True)
class IsElement:
    elem: Any


# extended API --------------------------------------------------------------

@dataclass(frozen=True)
class Sum:
    pos: int


@dataclass(frozen=True)
class SumAll:
    pos: int


@dataclass(frozen=True)
class Mult:
    pos: int


@dataclass(frozen=True)
class MultAll:
    pos: int


@dataclass(frozen=True)
class SearchEq:
    pos: int
    elem: Any


@dataclass(frozen=True)
class SearchNEq:
    pos: int
    elem: Any


@dataclass(frozen=True)
class SearchGt:
    pos: int
    elem: Any


@dataclass(frozen=True)
class SearchGtEq:
    pos: int
    elem: Any


@dataclass(frozen=True)
class SearchLt:
    pos: int
    elem: Any


@dataclass(frozen=True)
class SearchLtEq:
    pos: int
    elem: Any


@dataclass(frozen=True)
class SearchEntry:
    elem: Any


@dataclass(frozen=True)
class SearchEntryOR:
    elem1: Any
    elem2: Any
    elem3: Any


@dataclass(frozen=True)
class SearchEntryAND:
    elem1: Any
    elem2: Any
    elem3: Any


@dataclass(frozen=True)
class OrderLS:
    pos: int


@dataclass(frozen=True)
class OrderSL:
    pos: int
