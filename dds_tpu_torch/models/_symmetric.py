"""Shared symmetric-crypto primitives for the string schemes.

Copy of `dds_tpu/models/_symmetric.py`.

Single home for AES-256-CTR and base64 helpers used by det.py / rand.py /
searchable.py / keys.py — one implementation to audit and evolve.
"""

from __future__ import annotations

import base64

# `cryptography` is gated, not required at import: environments without it
# can still run the whole BFT/REST/chaos stack — only the AES-backed string
# schemes (det/rand/searchable) fail, loudly, at first USE.
try:
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    _CRYPTO_ERR = None
except ModuleNotFoundError as _e:  # pragma: no cover - env-dependent
    Cipher = algorithms = modes = None
    _CRYPTO_ERR = _e


def aes_available() -> bool:
    """True when the `cryptography` package backs the AES schemes. Callers
    that can degrade (Heliograph's canary domain encrypts only synthetic
    plaintexts) check this instead of trapping the first-use error."""
    return Cipher is not None


def aes_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-256-CTR keystream application (encrypt == decrypt)."""
    if Cipher is None:
        raise ModuleNotFoundError(
            "the AES-backed schemes (CHE/RND/searchable) need the "
            "'cryptography' package, which is not installed"
        ) from _CRYPTO_ERR
    c = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    return c.update(data) + c.finalize()


def b64e(b: bytes) -> str:
    return base64.b64encode(b).decode()


def b64d(s: str) -> bytes:
    return base64.b64decode(s)


def b64e_url(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def b64d_url(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))
