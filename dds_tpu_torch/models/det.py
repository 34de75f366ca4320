"""Deterministic comparable encryption for strings (scheme tag "CHE").

Copy of `dds_tpu/models/det.py`.

Mirrors the role of `hlib.hj.mlib.HomoDet` (`utils/SJHomoLibProvider.scala:
57,67`; proxy equality at `dds/http/DDSRestServer.scala:338,630`): equal
plaintexts yield equal ciphertexts, so the proxy compares ciphertexts by
string equality.

Construction: SIV-style AES — the IV is a PRF of the plaintext, so the
scheme is deterministic yet each distinct plaintext gets a distinct keystream:

    iv = HMAC-SHA256(k_mac, pt)[:16]
    ct = AES-256-CTR(k_enc, iv, pt)
    out = base64(iv || ct)
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

from dds_tpu_torch.models._symmetric import aes_ctr, b64d, b64e


@dataclass(frozen=True)
class DetKey:
    k_enc: bytes  # 32 bytes
    k_mac: bytes  # 32 bytes

    def encrypt(self, pt: str) -> str:
        data = pt.encode()
        iv = hmac.new(self.k_mac, data, hashlib.sha256).digest()[:16]
        return b64e(iv + aes_ctr(self.k_enc, iv, data))

    def decrypt(self, ct: str) -> str:
        raw = b64d(ct)
        iv, body = raw[:16], raw[16:]
        pt = aes_ctr(self.k_enc, iv, body)
        if hmac.new(self.k_mac, pt, hashlib.sha256).digest()[:16] != iv:
            raise ValueError("invalid CHE ciphertext")
        return pt.decode()

    @staticmethod
    def compare(c1: str, c2: str) -> bool:
        """Ciphertext-domain equality — what the proxy runs.

        Constant-time (`hmac.compare_digest`): both operands are
        attacker-influenced strings compared on the proxy, and a
        short-circuiting `==` would leak the length of the common prefix
        through timing. The scheme's leakage profile is unchanged —
        deterministic encryption reveals equality of ciphertexts by
        design, and equality (plus nothing positional) is still all this
        comparison reveals."""
        return hmac.compare_digest(c1.encode(), c2.encode())
