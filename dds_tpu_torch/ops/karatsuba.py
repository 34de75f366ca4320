"""One Karatsuba level of the full product: the DDS_KARATSUBA=1|2 families.

Twin of `dds_tpu/ops/mont_mxu.py:188-393`. With X = 2^(16h), h = L/2,
a = a0 + a1 X and b = b0 + b1 X:

    a*b = z0 + (z1 - z0 - z2) X + z2 X^2,
    z0 = a0 b0, z2 = a1 b1, z1 = (a0 + a1)(b0 + b1),

three half-size products instead of one full one. Two variants, as in the
reference, each followed by the reduction `mont_cuda.redc` in
`mont_cuda.mul`:

- `prod_k1` (mode "k1", `prod_lm_k1` at :321-383): three launches, the
  half sums and their 0/1 overflow bits (`mont_cuda.k1_halfsums`), the
  three products (`mont_cuda.prod3`, B4), and the recombination
  (`mont_cuda.k1_combine`, the reference's `_karatsuba_combine` at
  :188-215). The separate product and combine launches are what make it
  the "composed" variant the reference keeps as its negative result.
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

GROUP = 8  # the reference's a-limbs per accumulator update: the shape rule


def fits(L: int) -> bool:
    """The reference's Karatsuba shape rule: L even, L/2 a multiple of 8."""
    return L % 2 == 0 and (L // 2) % GROUP == 0


def _check_fits(L: int) -> None:
    if not fits(L):
        raise ValueError(f"the Karatsuba products need even L with (L/2) % {GROUP} == 0, "
                         f"got L={L}")


def prod_k1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b by the composed Karatsuba level: canonical limbs-major (L, B)
    int32 operands (column slices allowed) -> canonical (2L, B) int32.
    Three launches and views between them: the half sums, B4 on row
    slices of the operands and of the half sums, the recombination."""
    L = a.shape[0]
    _check_fits(L)
    h = L // 2
    s = mont_cuda.k1_halfsums(a, b)  # (L + 2, B): [sa | sb | ca | cb]
    z = mont_cuda.prod3(a[:h], b[:h], a[h:], b[h:], s[:h], s[h: 2 * h])
    return mont_cuda.k1_combine(z, s, L)


def prod_kf(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b by the fused Karatsuba level: one `mont_cuda.prod_kf` launch
    (B5), canonical (L, B) int32 in, canonical (2L, B) int32 out."""
    _check_fits(a.shape[0])
    return mont_cuda.prod_kf(a, b)
