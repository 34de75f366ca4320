"""Paillier additively homomorphic encryption (scheme tag "PSSE").

Trimmed copy of `dds_tpu/models/paillier.py`: key generation, encryption
(with an optional precomputed obfuscator), blinding and CRT decryption,
all on Python ints with the built-in `pow`. The batched modexp paths
(bulk encrypt, device decrypt) wait for the port's modexp kernel.

Math (g = n + 1, so g^m = 1 + m*n mod n^2 needs no modexp):

    enc(m; r) = (1 + m*n) * r^n  mod n^2      r random in Z_n*
    dec(c)    = L(c^lambda mod n^2) * mu mod n,  L(x) = (x-1)/n
    add       = c1 * c2 mod n^2
"""

from __future__ import annotations

import functools
import secrets
from dataclasses import dataclass
from math import gcd

_SMALL_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
]


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    """Random prime with exactly `bits` bits (top two bits set, odd)."""
    while True:
        cand = secrets.randbits(bits) | (1 << (bits - 1)) | (1 << (bits - 2)) | 1
        if _is_probable_prime(cand):
            return cand


@dataclass(frozen=True)
class PaillierPublicKey:
    n: int

    @property
    def nsquare(self) -> int:
        return self.n * self.n

    def encrypt(self, m: int, r: int | None = None, *, rn: int | None = None) -> int:
        """enc(m; r). `rn` short-circuits the obfuscator with a precomputed
        r^n mod n^2 (`blind()`), so bulk loaders pay one modmul per
        message; reusing one rn across messages weakens semantic security,
        so real clients leave it None."""
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

    def random_r(self) -> int:
        n = self.n
        while True:
            r = secrets.randbelow(n - 1) + 1
            if gcd(r, n) == 1:
                return r

    def add(self, c1: int, c2: int) -> int:
        return c1 * c2 % self.nsquare


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
        half = bits // 2
        p = _random_prime(half)
        while True:
            q = _random_prime(bits - half)
            if q != p:
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
