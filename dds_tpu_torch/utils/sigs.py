"""Record keys, nonces and HMAC signatures.

Copy of `dds_tpu/utils/sigs.py`, trimmed to the functions the slice's
quorum path uses: SHA-512 content-hash record keys, random nonces, and two
HMAC families — the intranet (replica<->replica) "ABD" signature over
(value, tag, nonce) and the proxy<->replica signature over (key[, value],
nonce). All comparisons are constant-time. Values are serialized as
canonical JSON; the ABD signature covers the true `tag.seq`.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import secrets


def canonical(value) -> str:
    """Deterministic serialization of a JSON-ish value for hashing/signing."""
    return json.dumps(value, sort_keys=True, separators=(",", ":"), default=str)


def key_from_set(contents: list) -> str:
    """SHA-512 content-hash record key (hex, upper)."""
    return hashlib.sha512(canonical(contents).encode()).hexdigest().upper()


def random_key() -> str:
    """Random SHA-512 record key."""
    return hashlib.sha512(secrets.token_bytes(100)).hexdigest().upper()


def generate_nonce() -> int:
    return secrets.randbits(63)


def _mac(secret: bytes, content: bytes) -> bytes:
    return hmac.new(secret, content, hashlib.sha256).digest()


def abd_signature(secret: bytes, value, tag, nonce: int) -> bytes:
    """Intranet replica signature over (value, tag, nonce)."""
    content = f"{canonical(value)}|{tag.seq}|{tag.id}|{nonce}".encode()
    return _mac(secret, content)


def validate_abd_signature(secret: bytes, value, tag, nonce: int, given: bytes) -> bool:
    return hmac.compare_digest(abd_signature(secret, value, tag, nonce), given)


def tag_payload(tag):
    """Canonical JSON-safe form of one tag for signing: [seq, id] (None
    stays None). Tags are predictable, so reply MACs must cover them."""
    return None if tag is None else [tag.seq, tag.id]


def tags_blob(tags) -> bytes:
    """Packed byte form of a tag vector for MACs and fingerprints:
    "seq:len(id):id" fields joined by ";" (the id is length-prefixed so
    the packing stays injective whatever characters an id holds)."""
    return ";".join(f"{t.seq}:{len(t.id)}:{t.id}" for t in tags).encode()


def tags_fingerprint(tags) -> bytes:
    """Order-sensitive digest of a tag vector: equal fingerprints mean
    equal per-key tags (the unchanged-reply fast path of ReadTagBatch)."""
    return hashlib.sha256(tags_blob(tags)).digest()


def abd_batch_signature(secret: bytes, tags, digest: str, nonce: int) -> bytes:
    """Intranet replica signature over a ReadTagBatch reply (tag vector +
    requested-keys digest + nonce)."""
    content = tags_blob(tags) + f"|{digest}|{nonce}".encode()
    return _mac(secret, content)


def validate_abd_batch_signature(
    secret: bytes, tags, digest: str, nonce: int, given: bytes
) -> bool:
    return hmac.compare_digest(abd_batch_signature(secret, tags, digest, nonce), given)


def abd_batch_unchanged_signature(
    secret: bytes, fingerprint: bytes, digest: str, nonce: int
) -> bytes:
    """Replica signature over an 'unchanged' ReadTagBatch reply: "my tag
    vector for these keys fingerprints to `fingerprint`"."""
    content = b"unchanged|" + fingerprint + f"|{digest}|{nonce}".encode()
    return _mac(secret, content)


def validate_abd_batch_unchanged_signature(
    secret: bytes, fingerprint: bytes, digest: str, nonce: int, given: bytes
) -> bool:
    return hmac.compare_digest(
        abd_batch_unchanged_signature(secret, fingerprint, digest, nonce), given
    )


_NO_VALUE = object()


def proxy_signature(secret: bytes, key: str, nonce: int, value=_NO_VALUE) -> bytes:
    """Proxy<->replica signature, with or without a value."""
    if value is _NO_VALUE:
        content = f"{key}|{nonce}".encode()
    else:
        content = f"{key}|{canonical(value)}|{nonce}".encode()
    return _mac(secret, content)


def validate_proxy_signature(secret: bytes, key: str, nonce: int, given: bytes,
                             value=_NO_VALUE) -> bool:
    return hmac.compare_digest(proxy_signature(secret, key, nonce, value), given)
