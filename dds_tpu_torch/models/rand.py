"""Probabilistic (non-homomorphic) encryption for strings (scheme tag "None").

Copy of `dds_tpu/models/rand.py`.

Mirrors the role of `hlib.hj.mlib.HomoRand` / `RandomKeyIv`
(`utils/SJHomoLibProvider.scala:60,70`). Deviation from the reference,
flagged per SURVEY.md §7: the reference reuses one fixed key+IV pair for
every encryption (AES-CBC with a static IV from `client.conf:88`) — a
keystream-reuse bug. We draw a fresh CTR nonce per encryption and carry it
in the ciphertext.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from dds_tpu_torch.models._symmetric import aes_ctr, b64d, b64e


@dataclass(frozen=True)
class RandKey:
    key: bytes  # 32 bytes

    def encrypt(self, pt: str) -> str:
        nonce = secrets.token_bytes(16)
        return b64e(nonce + aes_ctr(self.key, nonce, pt.encode()))

    def decrypt(self, ct: str) -> str:
        raw = b64d(ct)
        return aes_ctr(self.key, raw[:16], raw[16:]).decode()
