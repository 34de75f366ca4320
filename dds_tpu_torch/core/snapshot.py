"""Crash-safe authenticated files: the discipline the segment store uses.

Trimmed copy of `dds_tpu/core/snapshot.py:55-117`, the part Stratum's
segment store (`storage/segment.py`) imports: the MAC-key derivation and
the framed write and read of one file,

    <body>\\n<hmac-sha256 hex footer>\\n

written tmp file -> flush + fsync -> atomic rename -> directory fsync, so
a crash at any point leaves either the previous file or the complete new
one, and read back only when the footer verifies. The same base, label
and framing as the reference, so a file either package writes verifies in
the other. Replica snapshots themselves come with the replica-recovery
slice.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import pathlib

# default derivation base = the default intranet secret, so bare calls
# (tests, tooling) stay self-consistent with a default config
DEFAULT_BASE = b"intranet-abd-secret"


def derive_secret(base: bytes = DEFAULT_BASE,
                  node_key_path: str | os.PathLike | None = None,
                  label: bytes = b"dds-snapshot-mac-v2") -> bytes:
    """MAC key: HMAC-derived from the intranet secret, mixed with the
    node's transport key file when one is provisioned — per-node keys then
    yield per-node file keys. `label` domain-separates sibling on-disk
    formats sharing the discipline (the segment store derives with its own
    label, so a snapshot footer can never verify as a segment footer)."""
    material = bytes(base)
    if node_key_path:
        p = pathlib.Path(node_key_path)
        if p.exists():
            material += p.read_bytes()
    return hmac.new(material, label, hashlib.sha256).digest()


def write_authenticated(path: pathlib.Path, body: bytes, secret: bytes) -> None:
    """Write `body` + HMAC-SHA256 hex footer crash-safely: tmp file,
    flush + fsync, atomic rename, then directory-fd fsync so the rename
    itself is durable. A crash at any point leaves either the previous
    file or the complete new one."""
    footer = hmac.new(secret, body, hashlib.sha256).hexdigest().encode()
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(body + b"\n" + footer + b"\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        # the rename itself must be durable, or a crash can resurface the
        # old directory entry with the new data gone
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # pragma: no cover - fs-dependent
        pass


def read_authenticated(path: pathlib.Path, secret: bytes) -> bytes:
    """Verify + strip the HMAC footer; returns the body bytes. Raises
    ValueError on truncation or footer mismatch (corrupt or forged)."""
    raw = path.read_bytes()
    body, sep, footer = raw.rstrip(b"\n").rpartition(b"\n")
    if not sep or not body:
        raise ValueError("truncated (no footer)")
    if not hmac.compare_digest(
        hmac.new(secret, body, hashlib.sha256).hexdigest().encode(),
        footer.strip(),
    ):
        raise ValueError("HMAC footer mismatch (corrupt or forged)")
    return body
