"""Montgomery modular arithmetic: constants and the plain PyTorch path.

`ModCtx` holds one odd modulus's Montgomery constants. The kernel
(`ops/mont_cuda`, `csrc/mont_mul.cu`) works in W = ceil(L/2) 32-bit words,
so this package's Montgomery radix is R = 2^(32 W). For every even limb
count L (every Paillier and RSA size here) that is R = 2^(16 L), the
radix `dds_tpu` uses, and Montgomery-domain values agree bit for bit with
the reference; for odd L the radix is one limb wider and only plain-domain
results (`mul_mod`, `reduce_mul`, `pow_mod`) are comparable.

The plain path below is the kernels' reference: the same CIOS Montgomery
product, computed with int64 PyTorch tensors on 16-bit limbs over the
padded limb count 2W (so it uses the kernel's R), vectorized over the
batch, and the same 4-bit-window ladder over it (`mont_exp`, `pow_mod`);
their twins with one modulus (and one exponent) a row,
`_mont_mul_rowmod_raw` and `_mont_exp_rowdigits_raw`, are the plain
versions of the Sanctum decrypt's kernels.
The Karatsuba family's plain versions sit beside it: the full product
`prod`, the three half products `prod3` with the half sums `k1_halfsums`
before them and the recombination `k1_combine` after them, one Karatsuba
level `prod_kf`, the reduction `ModCtx.redc`, and the CIOS product without
its final subtraction `ModCtx.mont_mul_nofinal`.
Carry bound: each of the Lp steps adds a_i*b + m*n, below 2^33, to a limb
of the accumulator, so no limb passes Lp * 2^33 + 2^27 < 2^43 (Lp <= 512)
before the final carry passes, and the m step's product stays below
2^59 < 2^63.
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
    int_to_limbs,
    n_limbs_for_bits,
    to_device,
)

WINDOW = 4  # modexp window size (16-entry table)
DIGIT_MASK = (1 << WINDOW) - 1


def _mont_mul_raw(a: torch.Tensor, b: torch.Tensor, N: torch.Tensor,
                  n0inv, finalize: bool = True) -> torch.Tensor:
    """CIOS Montgomery product on 16-bit limbs.

    a, b: (B, Lp) int64 canonical with a*b < n*R; N: (Lp,) int64 limbs of
    n; n0inv = -n^-1 mod 2^16. Returns (B, Lp) int64 canonical (< n):
    a * b * R^-1 mod n with R = 2^(16 Lp). With `finalize` False the
    final subtraction is skipped and the result is t mod R, where
    t = (a*b + m*n) / R < 2n is the loop's accumulator (the probe of
    `benchmarks/profile_kernel.py::make_nofinal_mul`). N may also be
    (B, Lp) with n0inv a (B, 1) tensor: one modulus a row
    (`_mont_mul_rowmod_raw`)."""
    B, Lp = a.shape
    # step i adds a_i*b + m_i*n at limb offset i of one (B, 2Lp + 1)
    # accumulator, so nothing shifts; limb i is then 0 mod 2^16 and only
    # its carry moves up
    acc = torch.zeros((B, 2 * Lp + 1), dtype=torch.int64, device=a.device)
    Nb, b0 = (N if N.dim() == 2 else N[None, :]), b[:, :1]
    for i in range(Lp):
        ai = a[:, i:i + 1]
        m = (torch.addcmul(acc[:, i:i + 1], ai, b0) * n0inv) & LIMB_MASK
        w = acc[:, i:i + Lp]
        w.addcmul_(ai, b)
        w.addcmul_(m, Nb)
        acc[:, i + 1:i + 2] += acc[:, i:i + 1] >> LIMB_BITS
    t = _carry(acc[:, Lp:].clone())                # < 2n: the top limb holds it
    if not finalize:
        return t[:, :Lp]
    return _sub_if_geq(t, torch.cat([Nb, Nb.new_zeros((Nb.shape[0], 1))], dim=1))[:, :Lp]


def _mont_mul_rowmod_raw(a: torch.Tensor, b: torch.Tensor, N: torch.Tensor,
                         n0inv: torch.Tensor) -> torch.Tensor:
    """CIOS Montgomery product with one modulus a row: the plain version
    of `csrc/mont_rowmod.cu`'s `dds_mont_mul_rowmod` and the port of
    `dds_tpu/ops/montgomery.py::_mont_mul_rowmod_raw`.

    a, b: (B, Lp) int64 canonical, row i below N_i; N: (B, Lp) int64
    limbs of each row's modulus; n0inv: (B,) int64, -N_i^-1 mod 2^16.
    Returns (B, Lp) int64 canonical: row i is a_i * b_i * R^-1 mod N_i,
    R = 2^(16 Lp). Every step of `_mont_mul_raw` is already elementwise
    over the rows, so the carry bound above holds row by row."""
    return _mont_mul_raw(a, b, N, n0inv.reshape(-1, 1))


def _redc_raw(T: torch.Tensor, N: torch.Tensor, n0inv: int) -> torch.Tensor:
    """Montgomery reduction on 16-bit limbs: T * R^-1 mod n.

    T: (B, 2Lp) canonical with T < n*R; N: (Lp,) int64 limbs of n; n0inv
    = -n^-1 mod 2^16. The CIOS loop without its a_i*b term: step i adds
    m_i*n at limb offset i so that limb i becomes 0 mod 2^16, which leaves
    t = (T + m*n) / R < 2n in the top limbs; one conditional subtract of n
    finishes it. Returns (B, Lp) int64 canonical (< n)."""
    B, Lp = T.shape[0], N.shape[0]
    acc = torch.zeros((B, 2 * Lp + 1), dtype=torch.int64, device=T.device)
    acc[:, : 2 * Lp] = T
    Nb = N[None, :]
    for i in range(Lp):
        m = (acc[:, i:i + 1] * n0inv) & LIMB_MASK
        acc[:, i:i + Lp].addcmul_(m, Nb)
        acc[:, i + 1:i + 2] += acc[:, i:i + 1] >> LIMB_BITS
    t = _carry(acc[:, Lp:].clone())
    return _sub_if_geq(t, torch.cat([N, N.new_zeros(1)]))[:, :Lp]


def _prod_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product of canonical int64 limbs: (B, La) x (B, Lb) -> (B,
    La + Lb) canonical. Row i of `a` adds a_i*b (each < 2^32) at limb
    offset i, so no limb passes La * 2^32 before one carry resolution."""
    B, La = a.shape
    acc = torch.zeros((B, La + b.shape[1]), dtype=torch.int64, device=a.device)
    for i in range(La):
        acc[:, i:i + b.shape[1]].addcmul_(a[:, i:i + 1], b)
    return _carry(acc)


def prod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b for canonical (B, La) and (B, Lb) 16-bit limbs: (B, La + Lb)
    int32 canonical. The full product the Karatsuba kernels are built on
    (`dds_tpu/ops/mont_mxu.py::prod_lm`, canonical here)."""
    return _prod_raw(a.to(torch.int64), b.to(torch.int64)).to(torch.int32)


def prod3(a0, b0, a1, b1, sa, sb) -> torch.Tensor:
    """The plain version of `csrc/mont_prod3.cu` (B4,
    `mont_mxu._make_prod3_kernel`): three products of canonical (B, h)
    operands, stacked as (B, 6h) int32 canonical blocks [z0 | z2 | z1] with
    z0 = a0*b0, z2 = a1*b1, z1 = sa*sb."""
    return torch.cat([prod(a0, b0), prod(a1, b1), prod(sa, sb)], dim=1)


def k1_halfsums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of `dds_k1_halfsums` (csrc/mont_k1.cu; the
    reference's `carry_norm(a0 + a1)` in `mont_mxu.prod_lm_k1`): canonical
    (B, L) a and b, L even -> (B, L + 2) int32 [sa | sb | ca | cb] with
    h = L/2, X = 2^(16h), sa = (a0 + a1) mod X canonical and ca its 0/1
    overflow bit (the top limb of the sum carried into h + 1 limbs), the
    same for b."""
    B, L = a.shape
    h = L // 2

    def half_sum(x: torch.Tensor) -> torch.Tensor:  # (B, h + 1)
        x = x.to(torch.int64)
        return _carry(torch.cat([x[:, :h] + x[:, h:], x.new_zeros((B, 1))], dim=1))

    sa, sb = half_sum(a), half_sum(b)
    return torch.cat([sa[:, :h], sb[:, :h], sa[:, h:], sb[:, h:]], dim=1).to(torch.int32)


def k1_combine(z: torch.Tensor, s: torch.Tensor, L: int) -> torch.Tensor:
    """The plain version of `dds_k1_combine` (csrc/mont_k1.cu; the
    reference's `_karatsuba_combine` in `mont_mxu.prod_lm_k1`): B4's
    (B, 3L) [z0 | z2 | z1] and the (B, L + 2) half sums [sa | sb | ca | cb]
    -> the canonical (B, 2L) int32 product a*b = z0 + mid X + z2 X^2,
    h = L/2, X = 2^(16h), mid = z1 + (ca sb + cb sa) X + ca cb X^2 - z0 - z2.
    The middle term's limbs go negative before the signed carry passes of
    `_carry` settle them."""
    B = z.shape[0]
    h = L // 2
    z, s = z.to(torch.int64), s.to(torch.int64)
    z0, z2, z1 = z[:, : 2 * h], z[:, 2 * h: 4 * h], z[:, 4 * h:]
    sa, sb, ca, cb = s[:, :h], s[:, h: 2 * h], s[:, 2 * h: 2 * h + 1], s[:, 2 * h + 1:]
    T = z.new_zeros((B, 2 * L + 2))
    T[:, : 2 * h] += z0
    T[:, 2 * h: 4 * h] += z2
    T[:, h: 3 * h] += z1 - z0 - z2
    T[:, 2 * h: 3 * h] += ca * sb + cb * sa
    T[:, 3 * h] += (ca * cb)[:, 0]
    return _carry(T)[:, : 2 * L].to(torch.int32)


def prod_kf(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of `csrc/mont_kfused.cu` (B5,
    `mont_mxu._make_kfused_kernel`): a * b by one Karatsuba level for
    canonical (B, L) operands, L even, (B, 2L) int32 canonical out.

    With X = 2^(16h), h = L/2: a = a0 + a1 X, b = b0 + b1 X, the half sums
    sa = a0 + a1 and sb = b0 + b1 carried into h + 1 limbs (the top limb
    is the 0/1 overflow bit), and a*b = z0 + (z1 - z0 - z2) X + z2 X^2 with
    z0 = a0 b0, z2 = a1 b1, z1 = sa sb. The middle term's limbs go
    negative before the signed carry passes of `_carry` settle them."""
    B, L = a.shape
    h = L // 2
    a, b = a.to(torch.int64), b.to(torch.int64)
    pad = a.new_zeros((B, 1))
    sa = _carry(torch.cat([a[:, :h] + a[:, h:], pad], dim=1))
    sb = _carry(torch.cat([b[:, :h] + b[:, h:], pad], dim=1))
    z0 = _prod_raw(a[:, :h], b[:, :h])
    z2 = _prod_raw(a[:, h:], b[:, h:])
    z1 = _prod_raw(sa, sb)                                   # (B, 2h + 2)
    T = a.new_zeros((B, 2 * L + 2))
    T[:, : 2 * h] += z0
    T[:, 2 * h: 4 * h] += z2
    T[:, h: 3 * h + 2] += z1
    T[:, h: 3 * h] -= z0 + z2
    return _carry(T)[:, : 2 * L].to(torch.int32)


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Canonical limbs of non-negative (B, K) limbs whose value fits in K
    limbs, in place: whole-row carry passes until none is left (a few for
    random data, at most K)."""
    while True:
        c = t[:, :-1] >> LIMB_BITS
        if not bool(c.any()):
            return t
        t[:, :-1] &= LIMB_MASK
        t[:, 1:] += c


def _sub_if_geq(t: torch.Tensor, mod: torch.Tensor) -> torch.Tensor:
    """t - mod where t >= mod else t, for canonical (B, K) t and (K,) or
    (B, K) mod: whole-row borrow passes, the top limb's sign telling
    t < mod."""
    d = t - mod
    while True:
        borrow = (d[:, :-1] < 0).to(torch.int64)
        if not bool(borrow.any()):
            return torch.where(d[:, -1:] < 0, t, d)
        d[:, :-1] += borrow << LIMB_BITS
        d[:, 1:] -= borrow


def _mont_exp_raw(base: torch.Tensor, digits, one_mont: torch.Tensor,
                  N: torch.Tensor, n0inv: int) -> torch.Tensor:
    """Shared-exponent 4-bit-window ladder on the plain CIOS product.

    base: (B, Lp) int64 in the Montgomery domain; digits: MSB-first 4-bit
    digits (ints, or a 1-D tensor/array of them); one_mont: (Lp,) R mod n.
    Returns (B, Lp) int64 base^exp in the Montgomery domain. The table
    holds base^0..base^15 (14 products), then each digit costs 4
    squarings and 1 multiply by table[digit], starting from R mod n —
    the product sequence the exp kernel runs."""
    mul = lambda x, y: _mont_mul_raw(x, y, N, n0inv)
    one = one_mont[None, :].expand_as(base)
    table = [one, base]
    for _ in range(2, 1 << WINDOW):
        table.append(mul(table[-1], base))
    digits = digits.tolist() if hasattr(digits, "tolist") else list(digits)
    r = one
    for d in digits:
        for _ in range(WINDOW):
            r = mul(r, r)
        r = mul(r, table[int(d) & DIGIT_MASK])
    return r


def _mont_exp_rowdigits_raw(base: torch.Tensor, digits, one_mont: torch.Tensor,
                            N: torch.Tensor, n0inv: torch.Tensor) -> torch.Tensor:
    """The 4-bit-window ladder with a modulus and an exponent a row: the
    plain version of `csrc/mont_rowmod.cu`'s `dds_mont_exp_rowmod` and the
    port of `dds_tpu/ops/montgomery.py::_mont_exp_rowdigits_raw`.

    base: (B, Lp) int64 in each row's Montgomery domain; digits: (E, B)
    MSB-first 4-bit digits, row b's exponent in column b (a shorter
    exponent is padded with LEADING zero digits: a zero digit squares the
    identity and multiplies by table[0], a no-op), each taken mod 16;
    one_mont and N: (B, Lp) int64 limbs of R mod N_i and N_i; n0inv: (B,)
    int64, -N_i^-1 mod 2^16. Returns (B, Lp) int64, base_i^exp_i in the
    Montgomery domain: the product sequence of `_mont_exp_raw`, row by
    row."""
    mul = lambda x, y: _mont_mul_rowmod_raw(x, y, N, n0inv)
    table = [one_mont, base]
    for _ in range(2, 1 << WINDOW):
        table.append(mul(table[-1], base))
    table = torch.stack(table)                     # (16, B, Lp)
    digits = torch.as_tensor(digits, device=base.device).to(torch.int64) & DIGIT_MASK
    rows = torch.arange(base.shape[0], device=base.device)
    r = one_mont
    for e in range(digits.shape[0]):
        for _ in range(WINDOW):
            r = mul(r, r)
        r = mul(r, table[digits[e], rows])
    return r


def _exp_to_digits(exp: int) -> np.ndarray:
    """Python int -> MSB-first 4-bit digit array (at least one digit)."""
    if exp < 0:
        raise ValueError("negative exponent")
    ndig = max(1, -(-exp.bit_length() // WINDOW))
    return np.array(
        [(exp >> (WINDOW * i)) & DIGIT_MASK for i in range(ndig - 1, -1, -1)],
        dtype=np.uint32,
    )


def carry_edge_moduli(L: int) -> list[int]:
    """Odd moduli of exactly L 16-bit limbs made of long runs of
    0xFFFFFFFF (or zero) words: 2^(16L) - 3, 2^(16L) - 2^(8L+5) - 1 and
    2^(16L-1) + 2^(8L) - 1. With `carry_edge_operands` they push carries
    and borrows through whole lanes of the kernels' warp product
    (`csrc/mont_warp.cuh`), which random residues almost never do."""
    top = 16 * L
    return [(1 << top) - 3, (1 << top) - (1 << (8 * L + 5)) - 1,
            (1 << (top - 1)) + (1 << (8 * L)) - 1]


def carry_edge_operands(ctx: "ModCtx") -> list[int]:
    """Operands below ctx.n that stress the carry and borrow chains: 0, 1,
    n - 1, R mod n, every word all ones below the top word
    (2^(32(W-1)) - 1), and all ones below the top bit (2^(16L-1) - 1)."""
    n = ctx.n
    cands = [0, 1, n - 1, ctx.R % n, (1 << (32 * (ctx.W - 1))) - 1,
             (1 << (16 * ctx.L - 1)) - 1]
    return list(dict.fromkeys(x for x in cands if x < n))


def carry_edge_products(ctx: "ModCtx") -> list[int]:
    """The reduction's carry-edge inputs T: every product of two
    `carry_edge_operands`, then the extremes of T's range, T < top =
    min(n*R, 2^(32 L)) (`redc` takes 2L limbs): 0, R - 1 (T / R = 0, T mod
    R all ones), the largest multiple of R (T mod R = 0) and top - 1. At
    even L these are 0, R - 1, R (n - 1) and n*R - 1; at odd L, where R is
    one limb wider, top is 2^(32 L)."""
    ops = carry_edge_operands(ctx)
    R = ctx.R
    top = min(ctx.n * R, 1 << (2 * LIMB_BITS * ctx.L))
    return [x * y for x in ops for y in ops] + [0, R - 1, R * ((top - 1) // R), top - 1]


def karatsuba_edge_operands(ctx: "ModCtx") -> list[int]:
    """The Karatsuba product's carry-edge operands: `carry_edge_operands`,
    the all-ones L-limb number (its half sum overflows), and with
    X = 2^(16h), h = L/2: a0 all ones with a1 = 0 (the half sum all ones
    without the overflow: the largest z1), a1 all ones with a0 = 0, and
    a0 = a1 = X/2 (the half sum 0 with the overflow)."""
    X = 1 << (LIMB_BITS * (ctx.L // 2))
    return carry_edge_operands(ctx) + [(1 << (LIMB_BITS * ctx.L)) - 1, X - 1, (X - 1) * X,
                                       (X // 2) * (X + 1)]


def prod3_edge_columns(h: int) -> list[tuple[int, ...]]:
    """B4's carry-edge columns at h limbs a half: (a0, b0, a1, b1, sa, sb)
    for every ordered pair (a, b) of `karatsuba_edge_operands` of a 2h-limb
    carry-edge modulus, cut into halves with their half sums mod
    X = 2^(16h); then the all-ones column (every operand X - 1: z1 is the largest a half sum can
    give), and all ones times Y = 2^(32(H-1)) + 1, H = ceil(h/2) words: the
    product's high half Y - 1 builds up in the warp product as all-ones
    words with a pending carry, which its closing lookahead must carry
    across lanes."""
    ctx = ModCtx.make(carry_edge_moduli(2 * h)[0])
    X = 1 << (LIMB_BITS * h)
    Y = (1 << (32 * ((h - 1) // 2))) + 1
    ops = karatsuba_edge_operands(ctx)
    cols = []
    for a in ops:
        for b in ops:
            a0, a1, b0, b1 = a % X, a // X, b % X, b // X
            cols.append((a0, b0, a1, b1, (a0 + a1) % X, (b0 + b1) % X))
    return cols + [(X - 1,) * 6, (X - 1, Y, Y, X - 1, X - 1, Y)]


def _tree_reduce_raw(cs: torch.Tensor, N: torch.Tensor, n0inv: int) -> torch.Tensor:
    """Binary-tree Montgomery product of cs (K, Lp), K a power of two:
    prod(cs) * R^-(K-1) mod n (the caller fixes the domain)."""
    t = cs
    while t.shape[0] > 1:
        t = _mont_mul_raw(t[0::2], t[1::2], N, n0inv)
    return t


# ModCtx.make's shared cache: public moduli only (n, n^2); entries outlive
# keys, so a secret-derived modulus must never be passed to `make` (the
# Sanctum plane builds its per-key contexts with `ModCtx.build`). An
# explicit LRU, so its contents can be listed (`cached_moduli`).
_CTX_CACHE: "OrderedDict[tuple[int, int | None], ModCtx]" = OrderedDict()
_CTX_CACHE_MAX = 64
_CTX_CACHE_LOCK = threading.Lock()


def cached_moduli() -> list[int]:
    """The moduli `ModCtx.make`'s shared cache holds now: the hygiene
    check that no secret-derived modulus ever lands there."""
    with _CTX_CACHE_LOCK:
        return [k[0] for k in _CTX_CACHE]

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
        patterns, the kernel's modulus), "one_mont" and "R2": (L,) int32}
        on `device`, built once per device (a copy from the host waits for
        the stream; these do not)."""
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
                    "R2": to_device(self.R2, device),
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

    def mont_mul_nofinal(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The CIOS product without its final subtraction, for canonical
        (B, L) a, b < n: the low L limbs of t = (a*b + m*n) / R < 2n (t mod
        R at even L) — `mont_mul` is this or this minus n."""
        c = self.consts(a.device)
        out = _mont_mul_raw(self._pad(a), self._pad(b), c["N64"], self.n0inv,
                            finalize=False)
        return out[:, : self.L].to(torch.int32)

    def redc(self, T: torch.Tensor) -> torch.Tensor:
        """T * R^-1 mod n for canonical (B, 2L) T < n*R: (B, L) int32."""
        T = T.to(torch.int64)
        if self.Lp != self.L:
            T = torch.cat([T, T.new_zeros((T.shape[0], 2 * (self.Lp - self.L)))], dim=1)
        out = _redc_raw(T, self.consts(T.device)["N64"], self.n0inv)
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

    def mont_exp(self, base: torch.Tensor, digits) -> torch.Tensor:
        """base^exp in the Montgomery domain for canonical Montgomery-domain
        (B, L) `base` and MSB-first 4-bit `digits` (`_exp_to_digits`)."""
        c = self.consts(base.device)
        one = self._pad(c["one_mont"][None, :])[0]
        out = _mont_exp_raw(self._pad(base), digits, one, c["N64"], self.n0inv)
        return out[:, : self.L].to(torch.int32)

    def pow_mod(self, base: torch.Tensor, exp: int) -> torch.Tensor:
        """Plain-domain base^exp mod n for canonical (B, L) `base` and a
        shared host-int exponent: domain entry, the ladder, domain exit."""
        if exp == 0:
            one = torch.zeros((base.shape[0], self.L), dtype=torch.int32,
                              device=base.device)
            one[:, 0] = 1
            return one
        return self.from_mont(self.mont_exp(self.to_mont(base), _exp_to_digits(exp)))

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
