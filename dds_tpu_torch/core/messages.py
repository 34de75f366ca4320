"""Wire messages for the BFT-ABD protocol and the proxy contract.

Trimmed copy of `dds_tpu/core/messages.py`: the messages the port's paths
send over the in-memory transport — the ABD rounds, the supervisor's
membership and recovery protocol, verified state transfer, Merkle
anti-entropy, the shard fence's `WrongShard`, live resharding's
`ShardMigrateBegin`/`ShardMigrateAck` and the fault-injection
backdoors, with the reference's field names in its order — and its wire
codec, tagged canonical JSON (`dumps`/`loads`), which ChaosNet's corrupt
fault flips a byte of. For every class here `dumps` gives the
reference's bytes: the same names, field order and string annotations
(`f.type == "tuple"` reads them). A "set" (the stored value) is a plain
JSON list or None; tags order writes by (seq, id), the standard ABD
total order.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, fields
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
    # Constellation shard-map epoch the SENDER routed under (-1 =
    # unsharded). Fenced at the replica: a group that does not own the
    # key under ITS current map answers WrongShard instead of serving, so
    # a stale map can never silently misroute an op during a reshard.
    epoch: int = -1


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
    # shard-map epoch, same fencing contract as Envelope.epoch
    epoch: int = -1


@dataclass(frozen=True)
class TagBatchReply:
    tags: tuple   # ABDTag per key in the request's order (empty if unchanged)
    digest: str
    signature: bytes
    nonce: int
    unchanged: bool = False
    fingerprint: Optional[bytes] = None


# --------------------------------------------------------------------------
# supervisor protocol (SupervisorAPI.scala)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Suspect:
    replica: str       # endpoint of the suspected replica
    nonce: int


@dataclass(frozen=True)
class Awake:
    pass


@dataclass(frozen=True)
class State:
    data: dict         # key -> {"tag": [seq, id], "value": set|None}
    nonces: list[int]


@dataclass(frozen=True)
class Sleep:
    data: dict
    nonces: list[int]


@dataclass(frozen=True)
class Complying:
    pass


@dataclass(frozen=True)
class Kill:
    """Control message: hard-restart the replica with empty state.

    The reference uses Akka `Kill` + the guardian's restart strategy
    (`BFTSupervisor.scala:115`, `BFTSupervisorStrategy.scala:8-10`); our
    transport delivers an explicit control message the node host honors.
    """


@dataclass(frozen=True)
class Redeploy:
    """Supervisor -> node-host agent: rebuild a fresh replica at `endpoint`
    (the host owning it re-instantiates and re-registers the node). The
    TCP analogue of the reference's remote actor deployment on a dead
    host (`BFTSupervisor.scala:130-149`, RemoteScope). Authentication is
    the transport's (frame MAC / mutual TLS / node signatures), the same
    trust the in-protocol Kill/Sleep control messages ride."""

    endpoint: str


@dataclass(frozen=True)
class Redeployed:
    """Node-host agent -> supervisor: the Redeploy target is registered
    (freshly rebuilt, or found already alive — idempotent success)."""

    endpoint: str


@dataclass(frozen=True)
class RequestReplicas:
    pass


@dataclass(frozen=True)
class ActiveReplicas:
    replicas: list[str]


# --------------------------------------------------------------------------
# Aegis recovery plane: verified state transfer + Merkle anti-entropy
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class StateDigestRequest:
    """Supervisor -> replica (or spare): send your signed state manifest.
    Answered by healthy AND sentinent nodes — the supervisor cross-checks a
    quorum of manifests before any recovery seeding, and ranks spares by
    manifest freshness."""

    nonce: int


@dataclass(frozen=True)
class StateDigest:
    """Replica -> supervisor: manifest = {key: [tag.seq, tag.id,
    value-digest]} over every tracked repository entry, HMAC-signed with
    the signer address bound in (utils/sigs.manifest_signature)."""

    manifest: dict
    nonce: int
    signature: bytes


@dataclass(frozen=True)
class SleepBegin:
    """Supervisor -> recovering node: verified-reseed header. `digests` is
    the collected quorum of manifests, each `[signer, manifest, nonce,
    signature-hex]`; the node re-verifies every HMAC and accepts a seeded
    entry only when its (tag, value-digest) is attested by at least
    `support` (= f+1) distinct signers. `total` StateChunk frames follow
    (any order — transports reorder)."""

    digests: list
    session: int
    total: int
    support: int
    nonces: list


@dataclass(frozen=True)
class StateChunk:
    """One slice of the seeding state: {key: {"tag": [seq, id], "value":
    set|None}}. Chunked so a large repository streams as bounded frames
    instead of one giant Sleep (TcpNet.MAX_FRAME)."""

    session: int
    seq: int
    entries: dict
    # which ingest path owns the session: "recovery" (SleepBegin reseed,
    # replaces the repository) or "migrate" (ShardMigrateBegin, merges
    # verified entries store-if-newer). Typed so a chunk that races its
    # header can never complete the WRONG kind of session.
    kind: str = "recovery"


@dataclass(frozen=True)
class MerkleRootRequest:
    nonce: int


@dataclass(frozen=True)
class MerkleRoot:
    """Anti-entropy phase 1 reply: root hash over the replica's (key ->
    tag, value-digest) index + tracked-entry count, HMAC-signed."""

    root: str
    count: int
    nonce: int
    signature: bytes


@dataclass(frozen=True)
class MerkleBucketRequest:
    nonce: int


@dataclass(frozen=True)
class MerkleBuckets:
    """Phase 2 reply: the per-bucket digest vector (hex per bucket)."""

    digests: list
    nonce: int
    signature: bytes


@dataclass(frozen=True)
class MerkleKeysRequest:
    buckets: list
    nonce: int


@dataclass(frozen=True)
class MerkleKeys:
    """Phase 3 reply: {key: [seq, id, value-digest]} for the requested
    divergent buckets — tags + digests only, values never travel here."""

    entries: dict
    nonce: int
    signature: bytes


@dataclass(frozen=True)
class RepairRequest:
    keys: list
    nonce: int


@dataclass(frozen=True)
class RepairReply:
    """Phase 4 reply: {key: {"tag": [seq, id], "value": set|None, "sig":
    hex}} where each sig is the standard ABD HMAC over (value, tag,
    nonce) — the same authenticity bar as a protocol Write, validated
    before store-if-newer."""

    entries: dict
    nonce: int


# --------------------------------------------------------------------------
# Constellation shard fencing (shard/)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class WrongShard:
    """Replica -> proxy: epoch fence rejection. The addressed group does
    not own `key` under the replica's current shard map (epoch `epoch`).
    `nonce` correlates: the challenge nonce for an Envelope op, the
    request nonce for a ReadTagBatch. Signed with the proxy MAC over
    (key, nonce, ["wrong-shard", epoch]) so an in-path attacker cannot
    forge fence storms that stall the router with fake refreshes."""

    key: str
    epoch: int
    nonce: int
    signature: bytes


@dataclass(frozen=True)
class ShardMigrateBegin:
    """Rebalancer -> receiving-group replica: verified shard-migration
    header. The attestation frame of SleepBegin (`digests` a quorum of
    HMAC-signed state manifests from the SOURCE group, `support` the
    distinct-signer threshold, >= f+1), but the receiver MERGES attested
    entries store-if-newer instead of replacing its repository, keeps its
    behaviour, and accepts only entries its own shard map says it owns
    at `epoch`. `total` StateChunk(kind="migrate") frames follow."""

    digests: list
    session: int
    total: int
    support: int
    epoch: int


@dataclass(frozen=True)
class ShardMigrateAck:
    """Receiving-group replica -> rebalancer: a migration session's
    result. `accepted` counts entries installed (or already held at >=
    the attested tag); `rejected` those that failed the digest quorum or
    fell outside the replica's owned keyspace."""

    session: int
    accepted: int
    rejected: int


# --------------------------------------------------------------------------
# fault injection backdoor (malicious/MaliciousAttack.scala:34)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Compromise:
    pass


@dataclass(frozen=True)
class Crash:
    """Fault-injection control: the node tears its endpoint off the
    transport and goes silent — the PoisonPill analogue that also works
    across the TCP fabric (the reference's Trudy holds in-process
    ActorRefs, `Trudy.scala:14-32`). A harness backdoor like Compromise,
    not a production message."""


# --------------------------------------------------------------------------
# serialization: tagged canonical JSON
# --------------------------------------------------------------------------

_TYPES = {
    cls.__name__: cls
    for cls in (
        IRead, IWrite, IReadReply, IWriteReply, Envelope,
        ReadTag, TagReply, Write, WriteAck, Read, ReadReply,
        ReadTagBatch, TagBatchReply,
        Suspect, Awake, State, Sleep, Complying, Kill,
        Redeploy, Redeployed, RequestReplicas, ActiveReplicas, Compromise,
        Crash,
        StateDigestRequest, StateDigest, SleepBegin, StateChunk,
        MerkleRootRequest, MerkleRoot, MerkleBucketRequest, MerkleBuckets,
        MerkleKeysRequest, MerkleKeys, RepairRequest, RepairReply,
        WrongShard, ShardMigrateBegin, ShardMigrateAck,
    )
}


def _enc(v):
    if isinstance(v, bytes):
        return {"__b64__": base64.b64encode(v).decode()}
    if isinstance(v, ABDTag):
        return {"__tag__": [v.seq, v.id]}
    if type(v) in _TYPES.values():
        return to_dict(v)
    return v


def _dec(v):
    if isinstance(v, dict):
        if "__b64__" in v:
            return base64.b64decode(v["__b64__"])
        if "__tag__" in v:
            return ABDTag(int(v["__tag__"][0]), str(v["__tag__"][1]))
        if "__msg__" in v:
            return from_dict(v)
    return v


def to_dict(msg) -> dict:
    # element-wise coding applies only to the tuple-typed protocol fields
    # (the batch messages' tag vectors and key tuples). Stored set contents
    # (list fields) stay opaque, so a crafted column value (e.g.
    # {"__msg__": ...}) is never decoded as a protocol object before any
    # MAC validation.
    d = {"__msg__": type(msg).__name__}
    for f in fields(msg):
        v = getattr(msg, f.name)
        if f.type == "tuple" and isinstance(v, (list, tuple)):
            d[f.name] = [_enc(x) for x in v]
        else:
            d[f.name] = _enc(v)
    return d


def from_dict(d: dict):
    """The message `d` encodes; a type name this package lacks raises
    KeyError, which a decoder treats as an undecodable frame."""
    cls = _TYPES[d["__msg__"]]
    kwargs = {}
    for f in fields(cls):
        v = d[f.name]
        if f.type == "tuple" and isinstance(v, list):  # JSON has no tuples
            v = tuple(_dec(x) for x in v)
        else:
            v = _dec(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def dumps(msg) -> bytes:
    return json.dumps(to_dict(msg), separators=(",", ":")).encode()


def loads(raw: bytes):
    return from_dict(json.loads(raw))
