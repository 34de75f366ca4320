"""One Karatsuba level of the full product: the DDS_KARATSUBA=1|2 families.

Twin of `dds_tpu/ops/mont_mxu.py:188-393`. With X = 2^(16h), h = L/2,
a = a0 + a1 X and b = b0 + b1 X:

    a*b = z0 + (z1 - z0 - z2) X + z2 X^2,
    z0 = a0 b0, z2 = a1 b1, z1 = (a0 + a1)(b0 + b1),

three half-size products instead of one full one. Two variants, as in the
reference, each followed by the reduction `mont_cuda.redc` in
`mont_cuda.mul`:

- `prod_k1` (mode "k1", `prod_lm_k1` at :321-383): the half sums and
  their 0/1 overflow bits in PyTorch, ONE launch of `csrc/mont_prod3.cu`
  (B4) for the three products, then `_karatsuba_combine` in PyTorch ops
  (:188-215). The split between the kernel and the combine is what makes
  it the "composed" variant the reference keeps as its negative result.
- `prod_kf` (mode "fused", `prod_lm_kf` at :276-289): one launch of
  `csrc/mont_kfused.cu` (B5) does all of it.

Both take canonical limbs-major (L, B) int32 operands and return the
canonical (2L, B) int32 product, and both take the reference's shape rule
(`fits`, :285-286 and :361-362): the Karatsuba route is for even L with
(L/2) % 8 == 0, and `mont_cuda.mul` routes any other L to the CIOS kernel.
On CPU tensors the kernel wrappers run their plain versions.
"""

from __future__ import annotations

import torch

from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.bignum import LIMB_BITS, LIMB_MASK

GROUP = 8  # the reference's a-limbs per accumulator update: the shape rule


def fits(L: int) -> bool:
    """The reference's Karatsuba shape rule: L even, L/2 a multiple of 8."""
    return L % 2 == 0 and (L // 2) % GROUP == 0


def _check_fits(L: int) -> None:
    if not fits(L):
        raise ValueError(f"the Karatsuba products need even L with (L/2) % {GROUP} == 0, "
                         f"got L={L}")


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """Row r -> row r + k on the limb axis; the top k rows drop off."""
    out = torch.zeros_like(x)
    out[k:] = x[: x.shape[0] - k]
    return out


def carry_norm(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-negative redundant limbs (rows, B), each below 2^40 -> canonical
    int64 limbs and the (1, B) value carried out past the top row. A copy
    of `mont_mxu.carry_norm` (:406-438) in int64: three local passes leave
    at most one pending carry per limb, then a Kogge-Stone generate /
    propagate scan resolves the ripple in log2(rows) whole-array passes,
    with no wait on the device."""
    x = x.to(torch.int64)
    rows = x.shape[0]
    carry_out = torch.zeros_like(x[:1])
    for _ in range(3):
        c = x >> LIMB_BITS
        x = (x & LIMB_MASK) + _shift_up(c, 1)
        carry_out += c[-1:]
    c = x >> LIMB_BITS
    carry_out += c[-1:]
    s = (x & LIMB_MASK) + _shift_up(c, 1)       # <= LIMB_MASK + 1
    g = s > LIMB_MASK
    p = s == LIMB_MASK
    k = 1
    while k < rows:
        g = g | (p & _shift_up(g, k))
        p = p & _shift_up(p, k)
        k *= 2
    carry_out += g[-1:].to(torch.int64)
    return (s + _shift_up(g.to(torch.int64), 1)) & LIMB_MASK, carry_out


def _karatsuba_combine(z0, z2, z1, sa, ca, sb, cb, h: int, L: int) -> torch.Tensor:
    """The recombination of `mont_mxu._karatsuba_combine` (:188-215):
    canonical (2h, B) half products z0, z2, z1 (z1 of the h-limb parts of
    the half sums sa, sb, whose overflow bits are ca, cb) -> the canonical
    (2L, B) int32 product.

    The middle term runs borrow-free as a complement add over rows = 2h + 1
    limbs: with comp(z) = 2^(16 rows) - 1 - z digit by digit (z < 2^(32h),
    so its top digit is 0 and comp's is 0xFFFF),
        t = z1full + comp(z0) + comp(z2) + 2 = mid + 2 * 2^(16 rows),
    mid = a0 b1 + a1 b0 < 2^(32h + 1) <= 2^(16 rows). So t's carry-out is
    exactly 2 and its canonical digits are mid. The reference had to
    canonicalize z0 and z2 first; B4's products are canonical already,
    which is all the complement needs. Every digit stays below 6 * 2^16."""
    rows = 2 * h + 1
    z1f = torch.zeros((rows, z1.shape[1]), dtype=torch.int64, device=z1.device)
    z1f[: 2 * h] = z1
    z1f[h: 2 * h] += sb * ca + sa * cb
    z1f[2 * h] += (ca * cb)[0]
    t = z1f + 2 * LIMB_MASK
    t[: 2 * h] -= z0.to(torch.int64) + z2
    t[0] += 2
    mid, _ = carry_norm(t)
    T = torch.zeros((2 * L, z1.shape[1]), dtype=torch.int64, device=z1.device)
    T[: 2 * h] = z0
    T[2 * h:] = z2
    T[h: h + rows] += mid
    T, _ = carry_norm(T)                         # a*b < 2^(32L): no carry-out
    return T.to(torch.int32)


def prod_k1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b by the composed Karatsuba level: canonical limbs-major (L, B)
    int32 operands (column slices allowed) -> canonical (2L, B) int32.
    One `mont_cuda.prod3` launch (B4) between PyTorch ops."""
    L = a.shape[0]
    _check_fits(L)
    h = L // 2
    a0, a1, b0, b1 = a[:h], a[h:], b[:h], b[h:]
    sa, ca = carry_norm(a0.to(torch.int64) + a1)  # (h, B), (1, B) in {0, 1}
    sb, cb = carry_norm(b0.to(torch.int64) + b1)
    z = mont_cuda.prod3(a0, b0, a1, b1, sa.to(torch.int32), sb.to(torch.int32))
    return _karatsuba_combine(z[: 2 * h], z[2 * h: 4 * h], z[4 * h:],
                              sa, ca, sb, cb, h, L)


def prod_kf(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b by the fused Karatsuba level: one `mont_cuda.prod_kf` launch
    (B5), canonical (L, B) int32 in, canonical (2L, B) int32 out."""
    _check_fits(a.shape[0])
    return mont_cuda.prod_kf(a, b)
