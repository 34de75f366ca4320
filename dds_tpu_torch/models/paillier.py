"""Paillier additively homomorphic encryption (scheme tag "PSSE").

Copy of `dds_tpu/models/paillier.py`: key generation, encryption (with an
optional precomputed obfuscator), textbook bulk blinding through a
backend's batched modexp (`blind_batch`, `encrypt_batch`), the DJN
short-exponent blinding (`blind_fast`), the Prism weight encoding and its
host reference (`matvec_encode`, `matvec`), and CRT decryption, on Python
ints with the built-in `pow`. Bulk decryption (`decrypt_batch`) runs on
the Sanctum secret-material plane (`dds_tpu_torch/sanctum`): per-key
plans, host-only by default, both CRT legs in one batch on the card
behind the explicit device opt-in.

Math (g = n + 1, so g^m = 1 + m*n mod n^2 needs no modexp):

    enc(m; r) = (1 + m*n) * r^n  mod n^2      r random in Z_n*
    dec(c)    = L(c^lambda mod n^2) * mu mod n,  L(x) = (x-1)/n
    add       = c1 * c2 mod n^2
    scalar    = c^k mod n^2
"""

from __future__ import annotations

import functools
import secrets
from dataclasses import dataclass
from math import gcd

# gated: only key GENERATION at >= 1024 bits rides cryptography's fast RSA
# keygen; without the package the local prime generator takes over
try:
    from cryptography.hazmat.primitives.asymmetric import rsa
except ModuleNotFoundError:  # pragma: no cover - env-dependent
    rsa = None

from dds_tpu_torch.models.primes import rsa_primes

# rows per backend.powmod_batch call: bounds the (rows, L) limb batch and
# the exp kernel's (16, W, rows) window table per launch
POWMOD_CHUNK = 8192


def _lcm(a: int, b: int) -> int:
    return a // gcd(a, b) * b


# n -> B0 = r0^n mod n^2 for blind_fast (PaillierPublicKey is frozen;
# one fixed random base per key per process is exactly the DJN setup)
_B0_CACHE: dict[int, int] = {}


def _chunked_powmod(backend, bases: list[int], exp: int, mod: int) -> list[int]:
    """backend.powmod_batch in POWMOD_CHUNK-row chunks. PUBLIC moduli only
    (encrypt-side r^n): the backend caches per-modulus contexts
    process-wide, so secret CRT moduli must never come here."""
    out: list[int] = []
    for i in range(0, len(bases), POWMOD_CHUNK):
        out.extend(backend.powmod_batch(bases[i: i + POWMOD_CHUNK], exp, mod))
    return out


@dataclass(frozen=True)
class PaillierPublicKey:
    n: int

    @property
    def nsquare(self) -> int:
        return self.n * self.n

    def encrypt(self, m: int, r: int | None = None, *, rn: int | None = None) -> int:
        """enc(m; r). `rn` short-circuits the obfuscator with a precomputed
        r^n mod n^2 (`blind()`, `blind_batch()`), so bulk encryption pays
        one modmul per message; reusing one rn across messages weakens
        semantic security, so real clients never do."""
        n, n2 = self.n, self.nsquare
        m = m % n
        if rn is None:
            if r is None:
                r = self.random_r()
            rn = pow(r, n, n2)
        return (1 + m * n) % n2 * rn % n2

    def blind(self, r: int | None = None) -> int:
        """An obfuscator r^n mod n^2 for `encrypt(..., rn=...)` (fresh
        random r unless one is given)."""
        return pow(self.random_r() if r is None else r, self.n, self.nsquare)

    def _djn_s_bits(self) -> int:
        """Short-exponent width scaled to the modulus's NIST strength
        estimate (1024->80, 2048->112, 3072->128, 4096->152, 7680->192,
        15360->256 bits): s_bits = 4x strength, floor 320 — 448 at the
        2048-bit default. 16 bits of slack: an imported 2047-bit modulus
        must not drop a strength tier."""
        bits = self.n.bit_length()
        for thresh, strength in (
            (15360, 256), (7680, 192), (4096, 152), (3072, 128),
            (2048, 112), (0, 80),
        ):
            if bits >= thresh - 16:
                return max(320, 4 * strength)
        raise AssertionError("unreachable")

    def blind_fast(self, s_bits: int | None = None) -> int:
        """Fresh obfuscator via the Damgard-Jurik-Nielsen short-exponent
        trick: B0 = r0^n mod n^2 once per key, then B0^s for a random
        `s_bits`-wide s — (r0^s)^n, a valid r^n with r = r0^s, at the cost
        of one s-width modexp instead of an n-width one."""
        if s_bits is None:
            s_bits = self._djn_s_bits()
        b0 = _B0_CACHE.get(self.n)
        if b0 is None:
            b0 = pow(self.random_r(), self.n, self.nsquare)
            _B0_CACHE[self.n] = b0
        s = secrets.randbits(s_bits) | (1 << (s_bits - 1))
        return pow(b0, s, self.nsquare)

    def encrypt_fast(self, m: int) -> int:
        """enc(m) with a blind_fast() obfuscator (DJN variant, see above)."""
        return self.encrypt(m, rn=self.blind_fast())

    def blind_batch(self, count: int, backend=None, min_batch: int = 64) -> list[int]:
        """`count` fresh FULL-WIDTH obfuscators r^n mod n^2 — textbook
        blinding, each with an independent random r. A shared n-bit
        exponent over fresh random bases is exactly
        `CryptoBackend.powmod_batch`'s contract (on `cuda`: the exp
        kernel). Below `min_batch`, or with no backend, a host loop."""
        rs = [self.random_r() for _ in range(count)]
        if backend is not None and count >= min_batch:
            return _chunked_powmod(backend, rs, self.n, self.nsquare)
        n2 = self.nsquare
        return [pow(r, self.n, n2) for r in rs]

    def encrypt_batch(self, ms: list[int], backend=None, min_batch: int = 64) -> list[int]:
        """Bulk enc(m; r) with per-message full-width obfuscators from
        blind_batch (the textbook scheme, not DJN)."""
        rns = self.blind_batch(len(ms), backend, min_batch)
        return [self.encrypt(m, rn=rn) for m, rn in zip(ms, rns)]

    def random_r(self) -> int:
        n = self.n
        while True:
            r = secrets.randbelow(n - 1) + 1
            if gcd(r, n) == 1:
                return r

    def add(self, c1: int, c2: int) -> int:
        return c1 * c2 % self.nsquare

    def scalar_mul(self, c: int, k: int) -> int:
        return pow(c, k, self.nsquare)

    def matvec_encode(self, weights) -> list[list[int]]:
        """Encode a SIGNED plaintext weight matrix into Paillier exponent
        residues for ciphertext-side evaluation (the Prism analytics
        plane): Enc(x)^w = Enc(w*x mod n), and a negative weight encodes
        as n - |w|, an exponent congruent to -|w| mod n, so the signed
        decode (`PaillierKey.to_signed`) recovers the negative
        contribution. The REST plane and the weighted fold both take their
        exponents from here.

        Rejects |w| >= n (not representable as a distinct residue). Each
        row's plaintext W_r . x must stay in (-n/2, n/2] for the signed
        decode, the caller's contract as for every Paillier sum. A negative
        weight's exponent is full n-width: a scalar multiply by -3 costs a
        ~n-bit modexp, not a 2-bit one."""
        n = self.n
        out = []
        for row in weights:
            enc = []
            for w in row:
                w = int(w)
                if not -n < w < n:
                    raise ValueError(
                        f"weight magnitude {abs(w).bit_length()} bits "
                        f"exceeds the {n.bit_length()}-bit modulus"
                    )
                enc.append(w % n)
            out.append(enc)
        return out

    def matvec(self, cs: list[int], weights: list[list[int]]) -> list[int]:
        """Host reference for Enc(W @ x): per encoded weight row r
        (`matvec_encode` output), prod_j cs[j]^W[r][j] mod n^2, one modexp
        per nonzero weight. The batched twin is
        `ops/foldmany.fold_weighted`; backends pick between them."""
        n2 = self.nsquare
        out = []
        for row in weights:
            acc = 1
            for c, w in zip(cs, row, strict=True):
                if w:
                    acc = acc * pow(c, w, n2) % n2
            out.append(acc)
        return out


@dataclass(frozen=True)
class PaillierKey:
    """Private key. p, q are the prime factors of n (equal bit length)."""

    n: int
    p: int
    q: int

    @property
    def public(self) -> PaillierPublicKey:
        return PaillierPublicKey(self.n)

    @property
    def nsquare(self) -> int:
        return self.n * self.n

    @staticmethod
    def generate(bits: int = 2048) -> "PaillierKey":
        if bits >= 1024 and rsa is not None:
            # cryptography's RSA keygen produces two same-size primes fast;
            # only p and q are used (it refuses sizes below 1024)
            nums = rsa.generate_private_key(public_exponent=65537,
                                            key_size=bits).private_numbers()
            p, q = nums.p, nums.q
        else:
            p, q = rsa_primes(bits)
        return PaillierKey(n=p * q, p=p, q=q)

    @functools.cached_property
    def _crt(self):
        """Per-key CRT constants, living exactly as long as the key."""
        p, q, n = self.p, self.q, self.n
        hp = pow((pow(1 + n, p - 1, p * p) - 1) // p, -1, p)
        hq = pow((pow(1 + n, q - 1, q * q) - 1) // q, -1, q)
        qinv = pow(q, -1, p)
        return hp, hq, qinv

    def decrypt(self, c: int) -> int:
        """CRT decryption: two half-size modexps mod p^2 and q^2."""
        p, q = self.p, self.q
        hp, hq, qinv = self._crt
        mp = (pow(c % (p * p), p - 1, p * p) - 1) // p * hp % p
        mq = (pow(c % (q * q), q - 1, q * q) - 1) // q * hq % q
        return (mq + q * ((mp - mq) * qinv % p)) % self.n

    def decrypt_batch(self, cs: list[int], backend=None, min_batch: int = 64) -> list[int]:
        """Bulk CRT decrypt on the Sanctum plane (the reference's branches).

        Host-only by default: the key's host plan carries p^2, q^2 and the
        CRT constants, stored on THIS key object and closed with it.
        `backend` accepts ONLY a Sanctum handle (`sanctum.SecretBackend`):
        a public-parameter `CryptoBackend` raises, because its context
        cache outlives the key and p is recoverable from p^2. With a
        device-posture handle and at least `min_batch` ciphertexts, both
        CRT legs run as one batch on the handle's device (the device
        plan); below `min_batch` the host plan serves, as for every small
        batch: the reference's crossover, not a fallback."""
        from dds_tpu_torch import sanctum

        if backend is not None and not sanctum.is_secret_backend(backend):
            raise ValueError(
                "decrypt_batch does not accept public-parameter CryptoBackends "
                f"({getattr(backend, 'name', type(backend).__name__)!r}): the CRT "
                "legs' moduli p^2, q^2 are secrets and must never enter a "
                "process-wide context cache. Pass "
                "dds_tpu_torch.sanctum.SecretBackend(device=True) for the device "
                "opt-in, or None for the host-only default."
            )
        if backend is not None and getattr(backend, "device", None) and len(cs) >= min_batch:
            return sanctum.plan_for(self, backend).decrypt_batch(cs)
        return sanctum.plan_for(self).decrypt_batch(cs)

    def scrub(self) -> None:
        """Close every derived-secret cache this key accumulated: the
        `_crt` constants and every Sanctum plan (host constants, the
        device plan's limb arrays). p, q and n themselves are immutable
        ints; dropping the key finishes the job (a weakref finalizer
        closes the plans even without a scrub())."""
        from dds_tpu_torch import sanctum

        sanctum.scrub_key(self)

    def to_signed(self, m: int) -> int:
        """Map Z_n residues onto the signed range (-n/2, n/2]."""
        return m if 2 * m <= self.n else m - self.n

    def decrypt_signed(self, c: int) -> int:
        """Decrypt, mapping the upper half of Z_n back to negative ints."""
        return self.to_signed(self.decrypt(c))

    @property
    def lam(self) -> int:
        return _lcm(self.p - 1, self.q - 1)
