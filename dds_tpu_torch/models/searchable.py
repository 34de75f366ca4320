"""Word-searchable encryption for strings (scheme tag "LSE").

Copy of `dds_tpu/models/searchable.py`.

Mirrors the role of `hlib.hj.mlib.HomoSearch` (`utils/SJHomoLibProvider.scala:
56,66`): the plaintext is recoverable by the key holder, and per-word
deterministic tags let an untrusted party test word membership without
decrypting.

Wire format (all base64, '.'-joined):  nonce.ciphertext.tag1.tag2...
where  ct = AES-256-CTR(k_enc, nonce, pt)  and  tag_i = HMAC(k_tag, word_i)[:12].

The nonce is SIV-style (a PRF of the plaintext), making encryption
deterministic: the proxy's `SearchEntry*` routes match records by ciphertext
equality (`DDSRestServer.scala:849-929` uses `HomoDet.compare`, i.e. string
equality), which requires equal plaintexts to encrypt equal.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

from dds_tpu_torch.models._symmetric import aes_ctr as _aes_ctr, b64d_url as _unb64, b64e_url as _b64


@dataclass(frozen=True)
class SearchKey:
    k_enc: bytes  # 32 bytes
    k_tag: bytes  # 32 bytes

    def _tag(self, word: str) -> str:
        return _b64(hmac.new(self.k_tag, word.encode(), hashlib.sha256).digest()[:12])

    def encrypt(self, pt: str) -> str:
        # SIV nonce keyed with k_enc, NOT k_tag: trapdoors/tags are public
        # HMAC(k_tag, word) values, so a k_tag-derived nonce would collide
        # with the tag of a 'siv|...' word and leak record equality
        nonce = hmac.new(self.k_enc, b"siv|" + pt.encode(), hashlib.sha256).digest()[:16]
        ct = _aes_ctr(self.k_enc, nonce, pt.encode())
        tags = sorted({self._tag(w) for w in pt.split()})
        return ".".join([_b64(nonce), _b64(ct), *tags])

    def decrypt(self, payload: str) -> str:
        parts = payload.split(".")
        nonce, ct = _unb64(parts[0]), _unb64(parts[1])
        return _aes_ctr(self.k_enc, nonce, ct).decode()

    def trapdoor(self, word: str) -> str:
        """Search token for `word` — hand to the untrusted searcher."""
        return self._tag(word)

    @staticmethod
    def matches(payload: str, trapdoor: str) -> bool:
        """Ciphertext-domain word test — runs without any key.

        Each tag is checked with `hmac.compare_digest` and the scan never
        short-circuits: `trapdoor in tags` would leak which tag slot
        matched (and the length of common prefixes) through timing on the
        untrusted searcher. The leakage profile stays what the scheme
        promises — whether SOME tag equals the trapdoor, nothing more."""
        found = False
        for tag in payload.split(".")[2:]:
            found |= hmac.compare_digest(tag.encode(), trapdoor.encode())
        return found
