"""Order-preserving encryption for 32-bit ints (scheme tag "OPE").

Copy of `dds_tpu/models/ope.py`.

Mirrors the role of `hlib.hj.mlib.HomoOpeInt` (`utils/SJHomoLibProvider.scala:
44,55,65`): Int -> Long, strictly monotone, so the proxy can evaluate
range predicates and ordering on ciphertexts alone
(`dds/http/DDSRestServer.scala:541-606, 682-830`).

Construction: with u = x - INT32_MIN (unsigned shift) and a keyed PRF f with
outputs in [0, 2^20):

    enc(x) = u * 2^20 + f(u)

Strictly increasing in x for *any* f since f < 2^20: u1 < u2 implies
u1*S + f(u1) < (u1+1)*S <= u2*S <= enc(x2). Ciphertexts fit in 52 bits
(JSON-safe, "Long" in the reference's wire format). Like all OPE, this
leaks order by design; this construction additionally leaks approximate
magnitude — acceptable for the reference's threat model, and documented.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

_SHIFT = 20
_S = 1 << _SHIFT
_I32 = 1 << 31


@dataclass(frozen=True)
class OpeKey:
    key: bytes  # 32 bytes

    def _prf(self, u: int) -> int:
        mac = hmac.new(self.key, u.to_bytes(8, "big"), hashlib.sha256).digest()
        return int.from_bytes(mac[:4], "big") % _S

    def encrypt(self, x: int) -> int:
        if not (-_I32 <= x < _I32):
            raise ValueError("OPE plaintext must fit int32")
        u = x + _I32
        return u * _S + self._prf(u)

    def decrypt(self, c: int) -> int:
        u, rem = divmod(c, _S)
        if not (0 <= u < (1 << 32)) or self._prf(u) != rem:
            raise ValueError("invalid OPE ciphertext")
        return u - _I32
