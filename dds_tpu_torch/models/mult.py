"""RSA multiplicatively homomorphic encryption (scheme tag "MSE").

Copy of `dds_tpu/models/mult.py`, on the built-in `pow` (the reference's
C++ host powmod is not ported). Textbook RSA, where

    enc(m) = m^e mod n,  dec(c) = c^d mod n,  mult = c1 * c2 mod n

so dec(mult(c1, c2)) = m1 * m2 mod n. Deterministic, malleable — that is
the point: the proxy multiplies ciphertexts it cannot read.
"""

from __future__ import annotations

from dataclasses import dataclass

# gated: only key GENERATION at >= 1024 bits uses cryptography's fast RSA
# keygen; without the package the local prime generator takes over
try:
    from cryptography.hazmat.primitives.asymmetric import rsa
except ModuleNotFoundError:  # pragma: no cover - env-dependent
    rsa = None

from dds_tpu_torch.models.primes import rsa_primes


@dataclass(frozen=True)
class RsaMultPublicKey:
    n: int
    e: int = 65537

    def encrypt(self, m: int) -> int:
        return pow(m % self.n, self.e, self.n)

    def mult(self, c1: int, c2: int) -> int:
        return c1 * c2 % self.n


@dataclass(frozen=True)
class RsaMultKey:
    n: int
    e: int
    d: int
    p: int
    q: int

    @property
    def public(self) -> RsaMultPublicKey:
        return RsaMultPublicKey(self.n, self.e)

    @staticmethod
    def generate(bits: int = 1024) -> "RsaMultKey":
        if bits >= 1024 and rsa is not None:
            nums = rsa.generate_private_key(public_exponent=65537,
                                            key_size=bits).private_numbers()
            pub = nums.public_numbers
            return RsaMultKey(n=pub.n, e=pub.e, d=nums.d, p=nums.p, q=nums.q)
        e = 65537
        while True:
            p, q = rsa_primes(bits)
            phi = (p - 1) * (q - 1)
            if phi % e:
                return RsaMultKey(n=p * q, e=e, d=pow(e, -1, phi), p=p, q=q)

    def decrypt(self, c: int) -> int:
        # CRT decryption: two half-size modexps
        mp = pow(c % self.p, self.d % (self.p - 1), self.p)
        mq = pow(c % self.q, self.d % (self.q - 1), self.q)
        qinv = pow(self.q, -1, self.p)
        u = (mp - mq) * qinv % self.p
        return mq + u * self.q
