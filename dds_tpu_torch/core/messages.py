"""Wire messages for the BFT-ABD protocol and the proxy contract.

Trimmed copy of `dds_tpu/core/messages.py`: the messages the slice's path
sends over the in-memory transport (the JSON wire codec waits with
TcpNet). A "set" (the stored value) is a plain JSON list or None; tags
order writes by (seq, id), the standard ABD total order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

DDSSet = list  # a stored record: JSON-safe list of column values


@dataclass(frozen=True, order=True)
class ABDTag:
    seq: int
    id: str


# --------------------------------------------------------------------------
# proxy <-> replica intermediate API
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class IRead:
    key: str


@dataclass(frozen=True)
class IWrite:
    key: str
    set: Optional[DDSSet]


@dataclass(frozen=True)
class IReadReply:
    key: str
    set: Optional[DDSSet]
    # tag of the returned value, for the proxy's tag-validated aggregate
    # cache; covered by the proxy HMAC (tags are predictable)
    tag: Optional[ABDTag] = None


@dataclass(frozen=True)
class IWriteReply:
    key: str
    tag: Optional[ABDTag] = None  # the tag the coordinator wrote


@dataclass(frozen=True)
class Envelope:
    call: Any          # one of the I* messages above
    nonce: int
    signature: bytes


# --------------------------------------------------------------------------
# replica <-> replica ABD protocol
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ReadTag:
    key: str
    nonce: int


@dataclass(frozen=True)
class TagReply:
    tag: ABDTag
    key: str
    value: Optional[DDSSet]
    signature: bytes
    nonce: int


@dataclass(frozen=True)
class Write:
    tag: ABDTag
    key: str
    value: Optional[DDSSet]
    signature: bytes
    nonce: int


@dataclass(frozen=True)
class WriteAck:
    key: str
    nonce: int


@dataclass(frozen=True)
class Read:
    key: str
    nonce: int


@dataclass(frozen=True)
class ReadReply:
    tag: ABDTag
    key: str
    value: Optional[DDSSet]
    signature: bytes
    nonce: int


@dataclass(frozen=True)
class ReadTagBatch:
    """Tag-phase-only quorum read over many keys at once, broadcast by the
    PROXY itself (AbdClient.read_tags) so no single coordinator can
    deflate the max. `signature` is the proxy MAC over (keys-digest,
    nonce); `fingerprint` is the sha256 of the proxy's cached tag vector,
    which lets an unchanged replica answer without re-sending K tags."""

    keys: tuple
    nonce: int
    signature: bytes = b""
    fingerprint: Optional[bytes] = None


@dataclass(frozen=True)
class TagBatchReply:
    tags: tuple   # ABDTag per key in the request's order (empty if unchanged)
    digest: str
    signature: bytes
    nonce: int
    unchanged: bool = False
    fingerprint: Optional[bytes] = None


# --------------------------------------------------------------------------
# replica -> supervisor
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Suspect:
    replica: str       # endpoint of the suspected replica
    nonce: int
