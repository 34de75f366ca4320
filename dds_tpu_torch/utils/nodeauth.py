"""Per-node transport credentials: Ed25519 frame signatures.

Copy of `dds_tpu/utils/nodeauth.py`. The quorum protocols key votes by
sender (WriteAck, Suspect, TagBatchReply), so the fabric binds a frame's
claimed `src` to a credential: every process (transport endpoint,
"host:port") holds an Ed25519 keypair, and a registry provisioned like the
TLS certs maps each host:port to its public key. `TcpNet` signs every
outbound frame and receivers verify it against the registry entry of the
claimed src's host:port, so a member forging another member's src fails.
Names within one process are not told apart (one process, one trust
domain). Keys and registries are hex strings, read alike by both packages.
"""

from __future__ import annotations

import pathlib

# gated: only the Ed25519 key operations need `cryptography`; the helpers
# below (write_secret_file) serve environments without it, and key users
# fail loudly at first use rather than at import
try:
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    _CRYPTO_ERR = None
except ModuleNotFoundError as _e:  # pragma: no cover - env-dependent
    Ed25519PrivateKey = Ed25519PublicKey = None
    _CRYPTO_ERR = _e


def _require_crypto() -> None:
    if Ed25519PrivateKey is None:
        raise ModuleNotFoundError(
            "per-node transport identity needs the 'cryptography' package, "
            "which is not installed"
        ) from _CRYPTO_ERR


def generate() -> Ed25519PrivateKey:
    _require_crypto()
    return Ed25519PrivateKey.generate()


def private_hex(key: Ed25519PrivateKey) -> str:
    return key.private_bytes_raw().hex()


def public_hex(key: Ed25519PrivateKey) -> str:
    return key.public_key().public_bytes_raw().hex()


def load_private(hexstr: str) -> Ed25519PrivateKey:
    _require_crypto()
    return Ed25519PrivateKey.from_private_bytes(bytes.fromhex(hexstr.strip()))


def load_public(hexstr: str) -> Ed25519PublicKey:
    _require_crypto()
    return Ed25519PublicKey.from_public_bytes(bytes.fromhex(hexstr.strip()))


def write_secret_file(path: str | pathlib.Path, content: str) -> None:
    """Create a secret file born 0600 (O_EXCL) — never world-readable,
    not even for the instant before a chmod."""
    import os

    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(p, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(content)


def load_or_create(path: str | pathlib.Path) -> Ed25519PrivateKey:
    """Process key from `path` (hex), generated on first use — the dev
    flow; production provisions the file like it provisions TLS keys."""
    p = pathlib.Path(path)
    if p.exists():
        return load_private(p.read_text())
    key = generate()
    write_secret_file(p, private_hex(key))
    return key


def registry(pubkeys: dict[str, str]) -> dict[str, Ed25519PublicKey]:
    """Parse a {host:port -> public key hex} config map."""
    return {hp: load_public(hx) for hp, hx in pubkeys.items()}
