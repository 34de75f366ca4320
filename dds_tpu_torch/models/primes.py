"""Prime generation for HE key material.

Copy of `dds_tpu/models/primes.py`: Miller-Rabin generation, the single
place prime logic lives, shared by Paillier (PSSE) and RSA (MSE) key
generation. `cryptography`'s RSA keygen takes over at production sizes
(>= 1024-bit moduli) where that package is installed.
"""

from __future__ import annotations

import secrets

_SMALL_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
]


def is_probable_prime(n: int, rounds: int = 40) -> bool:
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


def random_prime(bits: int) -> int:
    """Random prime with exactly `bits` bits (top two bits set, odd)."""
    while True:
        cand = secrets.randbits(bits) | (1 << (bits - 1)) | (1 << (bits - 2)) | 1
        if is_probable_prime(cand):
            return cand


def rsa_primes(modulus_bits: int) -> tuple[int, int]:
    """Two distinct primes whose product has ~modulus_bits bits."""
    half = modulus_bits // 2
    p = random_prime(half)
    while True:
        q = random_prime(modulus_bits - half)
        if q != p:
            return p, q
