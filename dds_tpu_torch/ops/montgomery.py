"""Montgomery modular arithmetic: constants and the plain PyTorch path.

`ModCtx` holds one odd modulus's Montgomery constants. The kernel
(`ops/mont_cuda`, `csrc/mont_mul.cu`) works in W = ceil(L/2) 32-bit words,
so this package's Montgomery radix is R = 2^(32 W). For every even limb
count L (every Paillier and RSA size here) that is R = 2^(16 L), the
radix `dds_tpu` uses, and Montgomery-domain values agree bit for bit with
the reference; for odd L the radix is one limb wider and only plain-domain
results (`mul_mod`, `reduce_mul`) are comparable.

The plain path below is the kernel's reference: the same CIOS Montgomery
product, computed with int64 PyTorch tensors on 16-bit limbs over the
padded limb count 2W (so it uses the kernel's R), vectorized over the
batch. Carry bound: limbs enter each step below 2^17; adding the lo/hi
halves of a_i*b and m*n adds below 4*2^16; one carry pass per step
restores limbs below 2^17 + 2^3. Every intermediate stays far below 2^63.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from dds_tpu_torch.ops.bignum import (
    LIMB_BITS,
    LIMB_MASK,
    cond_sub,
    int_to_limbs,
    n_limbs_for_bits,
    normalize,
    to_device,
)


def _mont_mul_raw(a: torch.Tensor, b: torch.Tensor, N: torch.Tensor,
                  n0inv: int) -> torch.Tensor:
    """CIOS Montgomery product on 16-bit limbs.

    a, b: (B, Lp) int64 canonical with a*b < n*R; N: (Lp,) int64 limbs of
    n; n0inv = -n^-1 mod 2^16. Returns (B, Lp) int64 canonical (< n):
    a * b * R^-1 mod n with R = 2^(16 Lp)."""
    B, Lp = a.shape
    t = torch.zeros((B, Lp + 1), dtype=torch.int64, device=a.device)
    zero = torch.zeros((B, 1), dtype=torch.int64, device=a.device)
    Nb = N[None, :]
    for i in range(Lp):
        p = a[:, i:i + 1] * b                      # (B, Lp) < 2^32
        t[:, :Lp] += p & LIMB_MASK
        t[:, 1:] += p >> LIMB_BITS
        m = (t[:, :1] * n0inv) & LIMB_MASK         # (B, 1)
        q = m * Nb
        t[:, :Lp] += q & LIMB_MASK
        t[:, 1:] += q >> LIMB_BITS
        carry0 = t[:, :1] >> LIMB_BITS             # t[:, 0] = 0 mod 2^16
        t = torch.cat([t[:, 1:], zero], dim=1)
        t[:, :1] += carry0
        c = t[:, :Lp] >> LIMB_BITS                 # one redundant-carry pass
        t[:, :Lp] &= LIMB_MASK
        t[:, 1:] += c
    t, _ = normalize(t)                            # < 2n: the top limb holds it
    N_ext = torch.cat([N, N.new_zeros(1)])
    return cond_sub(t, N_ext)[:, :Lp]


def _tree_reduce_raw(cs: torch.Tensor, N: torch.Tensor, n0inv: int) -> torch.Tensor:
    """Binary-tree Montgomery product of cs (K, Lp), K a power of two:
    prod(cs) * R^-(K-1) mod n (the caller fixes the domain)."""
    t = cs
    while t.shape[0] > 1:
        t = _mont_mul_raw(t[0::2], t[1::2], N, n0inv)
    return t


# ModCtx.make's shared cache: public moduli only (n, n^2); entries outlive
# keys, so a secret-derived modulus must never be passed to `make`.
_CTX_CACHE: "OrderedDict[tuple[int, int | None], ModCtx]" = OrderedDict()
_CTX_CACHE_MAX = 64
_CTX_CACHE_LOCK = threading.Lock()

_FIX_CACHE_MAX = 512  # R^K fix constants kept per context


@dataclass(frozen=True, eq=False)
class ModCtx:
    """Montgomery constants for one odd modulus n.

    `L` is the interface limb count, `W` = ceil(L/2) the kernel's word
    count, R = 2^(32 W). N / R2 / one_mont are (L,) uint32 host arrays of
    n, R^2 mod n and R mod n; n0inv / n0inv32 are -n^-1 mod 2^16 (plain
    path) and mod 2^32 (kernel). Device copies are made once per device."""

    n: int
    L: int
    W: int
    N: np.ndarray = field(repr=False)
    n0inv: int = field(repr=False)
    n0inv32: int = field(repr=False)
    R2: np.ndarray = field(repr=False)
    one_mont: np.ndarray = field(repr=False)
    _dev: dict = field(default_factory=dict, init=False, repr=False)
    _fix: OrderedDict = field(default_factory=OrderedDict, init=False, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, init=False,
                                  repr=False)

    @staticmethod
    def build(n: int, L: int | None = None) -> "ModCtx":
        """An uncached context (public callers want `make`)."""
        if n % 2 == 0:
            raise ValueError("Montgomery modulus must be odd")
        if L is None:
            L = n_limbs_for_bits(n.bit_length())
        if n >> (LIMB_BITS * L):
            raise ValueError("modulus does not fit limb count")
        W = (L + 1) // 2
        R = 1 << (32 * W)
        return ModCtx(
            n=n,
            L=L,
            W=W,
            N=int_to_limbs(n, L),
            n0inv=(-pow(n, -1, 1 << 16)) % (1 << 16),
            n0inv32=(-pow(n, -1, 1 << 32)) % (1 << 32),
            R2=int_to_limbs(R * R % n, L),
            one_mont=int_to_limbs(R % n, L),
        )

    @staticmethod
    def make(n: int, L: int | None = None) -> "ModCtx":
        """The cached entry point for PUBLIC moduli: one context per
        modulus, process-wide."""
        key = (n, L)
        with _CTX_CACHE_LOCK:
            ctx = _CTX_CACHE.get(key)
            if ctx is not None:
                _CTX_CACHE.move_to_end(key)
                return ctx
        ctx = ModCtx.build(n, L)
        with _CTX_CACHE_LOCK:
            cached = _CTX_CACHE.get(key)
            if cached is not None:  # lost a benign build race: keep the first
                return cached
            while len(_CTX_CACHE) >= _CTX_CACHE_MAX:
                _CTX_CACHE.popitem(last=False)
            _CTX_CACHE[key] = ctx
        return ctx

    @property
    def R(self) -> int:
        return 1 << (32 * self.W)

    @property
    def Lp(self) -> int:
        """Limb count of the plain path: 2W (L plus a zero limb if odd)."""
        return 2 * self.W

    # -- device constants ----------------------------------------------------

    def consts(self, device) -> dict:
        """{"N64": (Lp,) int64 limbs, "N32": (W,) int32 words (uint32 bit
        patterns, the kernel's modulus), "one_mont": (L,) int32} on
        `device`, built once per device."""
        device = torch.device(device)
        with self._lock:
            c = self._dev.get(device)
            if c is None:
                n64 = np.zeros(self.Lp, np.int64)
                n64[: self.L] = self.N
                words = np.frombuffer(self.n.to_bytes(4 * self.W, "little"), "<u4")
                c = {
                    "N64": torch.from_numpy(n64).to(device),
                    "N32": torch.from_numpy(words.view(np.int32).copy()).to(device),
                    "one_mont": to_device(self.one_mont, device),
                }
                self._dev[device] = c
            return c

    def fold_fix(self, K: int, device) -> torch.Tensor:
        """R^K mod n as an (L, 1) int32 column on `device`: the one
        multiply that turns a K-row Montgomery tree product back into the
        plain-domain product. Cached per (K, device): the proxy folds the
        same store size again and again."""
        key = (K, torch.device(device))
        with self._lock:
            fix = self._fix.get(key)
            if fix is not None:
                self._fix.move_to_end(key)
                return fix
        limbs = int_to_limbs(pow(self.R % self.n, K, self.n), self.L)
        fix = to_device(limbs[:, None], device)
        with self._lock:
            while len(self._fix) >= _FIX_CACHE_MAX:
                self._fix.popitem(last=False)
            self._fix[key] = fix
        return fix

    # -- plain entry points: (B, L) tensors in, (B, L) int32 out --------------

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.int64)
        if self.Lp == self.L:
            return x
        return torch.cat([x, x.new_zeros((x.shape[0], self.Lp - self.L))], dim=1)

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a * b * R^-1 mod n for canonical (B, L) a, b < n."""
        c = self.consts(a.device)
        out = _mont_mul_raw(self._pad(a), self._pad(b), c["N64"], self.n0inv)
        return out[:, : self.L].to(torch.int32)

    def to_mont(self, x: torch.Tensor) -> torch.Tensor:
        r2 = to_device(self.R2, x.device).expand(x.shape[0], self.L)
        return self.mont_mul(x, r2)

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        one = torch.zeros_like(x, dtype=torch.int32)
        one[:, 0] = 1
        return self.mont_mul(x, one)

    def mul_mod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Plain-domain a * b mod n: one domain entry + one multiply."""
        return self.mont_mul(self.to_mont(a), b)

    def reduce_mul(self, cs: torch.Tensor) -> torch.Tensor:
        """Modular product of all K rows of cs ((K, L) plain domain, K >= 1)
        as (1, L) int32: pads K to a power of two with R mod n (the
        Montgomery identity), tree-reduces, then fixes the accumulated
        R^-(K-1) with one multiply by R^K mod n."""
        K = cs.shape[0]
        if K < 1:
            raise ValueError("reduce_mul needs at least one row")
        device = cs.device
        c = self.consts(device)
        P2 = 1 << max(0, (K - 1).bit_length())
        x = self._pad(cs)
        if P2 != K:
            pad = self._pad(c["one_mont"][None, :]).expand(P2 - K, self.Lp)
            x = torch.cat([x, pad], dim=0)
        prod = _tree_reduce_raw(x, c["N64"], self.n0inv)
        fix = self._pad(self.fold_fix(K, device).T)
        out = _mont_mul_raw(prod, fix, c["N64"], self.n0inv)
        return out[:, : self.L].to(torch.int32)
