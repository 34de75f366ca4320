"""The composed Karatsuba multiply's own launches (DDS_KARATSUBA=1) against
the reference's XLA code, on the CPU.

`mont_cuda.k1_halfsums` and `mont_cuda.k1_combine` run their plain versions
(`montgomery.k1_halfsums`, `montgomery.k1_combine`) on CPU tensors; the
card runs `csrc/mont_k1.cu` (tests/test_torch_gpu.py). Held here against
what `dds_tpu/ops/mont_mxu.py::prod_lm_k1` computes around its Pallas
product: `carry_norm(a0 + a1)` for the half sums and `_karatsuba_combine`
for the recombination (XLA on the CPU, no Pallas), compared as the
integers they encode; and `karatsuba.prod_k1` end to end against
`prod_lm_k1` with its Pallas product in interpret mode. Inputs are made
from a numpy seed, plus the columns that set the overflow bits. Exact
integer arithmetic: tolerance zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dds_tpu.ops import mont_mxu
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import karatsuba, mont_cuda


def _ints(x) -> list[int]:
    """Limbs-major (rows, B) limbs, canonical or redundant -> ints."""
    a = np.asarray(x).astype(np.uint64)
    return [bn.limbs_to_int(a[:, j]) for j in range(a.shape[1])]


def _operands(L: int, B: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Limbs-major (L, B) uint32 a and b: seeded random limbs, then the
    overflow columns: all ones (both half sums overflow), a0 all ones with
    a1 = 0 (sa all ones, no overflow), a0 = a1 = 2^(16h - 1) (sa = 0 with
    the overflow), zero and one."""
    h = L // 2
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(L, B), dtype=np.uint32)
    b = rng.integers(0, 1 << 16, size=(L, B), dtype=np.uint32)
    a[:, 0] = b[:, 0] = 0xFFFF
    a[:h, 1], a[h:, 1], b[:, 1] = 0xFFFF, 0, 0xFFFF
    a[:, 2] = b[:, 2] = 0
    a[h - 1, 2] = a[L - 1, 2] = b[h - 1, 2] = b[L - 1, 2] = 0x8000
    a[:, 3] = b[:, 4] = 0
    a[0, 4] = b[0, 3] = 1
    return a, b


def _torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int32))


@pytest.mark.parametrize("L", [32, 64, 256])
def test_k1_halfsums_match_reference_carry_norm(L):
    h = L // 2
    a, b = _operands(L, 24, L)
    got = bn.to_host(mont_cuda.k1_halfsums(_torch(a), _torch(b)))
    assert got.shape == (L + 2, 24) and int(got.max()) <= 0xFFFF
    for x, rows, carry in ((a, slice(0, h), 2 * h), (b, slice(h, 2 * h), 2 * h + 1)):
        s, c = mont_mxu.carry_norm(jnp.asarray(x[:h] + x[h:]))
        np.testing.assert_array_equal(got[rows], np.asarray(s))
        np.testing.assert_array_equal(got[carry], np.asarray(c)[0])
    assert got[2 * h, :3].tolist() == [1, 0, 1] and got[2 * h + 1, :3].tolist() == [1, 1, 1]


@pytest.mark.parametrize("L", [32, 64, 256])
def test_k1_combine_matches_reference_karatsuba_combine(L):
    h = L // 2
    a, b = _operands(L, 24, L + 1)
    A, Bt = _torch(a), _torch(b)
    s = mont_cuda.k1_halfsums(A, Bt)
    z = mont_cuda.prod3(A[:h], Bt[:h], A[h:], Bt[h:], s[:h], s[h: 2 * h])
    got = mont_cuda.k1_combine(z, s, L)
    zu, su = bn.to_host(z).astype(np.uint32), bn.to_host(s).astype(np.uint32)
    ref = mont_mxu._karatsuba_combine(
        jnp.asarray(zu[: 2 * h]), jnp.asarray(zu[2 * h: 4 * h]), jnp.asarray(zu[4 * h:]),
        jnp.asarray(su[:h]), jnp.asarray(su[2 * h: 2 * h + 1]),
        jnp.asarray(su[h: 2 * h]), jnp.asarray(su[2 * h + 1:]), h, L)
    assert got.shape == (2 * L, 24) and got.dtype == torch.int32
    assert int(got.max()) <= 0xFFFF
    want = [x * y for x, y in zip(_ints(a), _ints(b))]
    assert _ints(bn.to_host(got)) == _ints(ref) == want


@pytest.mark.parametrize("L", [32, 64])
def test_prod_k1_matches_prod_lm_k1(L):
    """The three launches of `prod_k1` against the reference's composed
    level with its Pallas product in interpret mode, on column slices of a
    wider array as a fold level passes them."""
    a, b = _operands(L, 16, L + 2)
    wide = torch.cat([_torch(a), _torch(b)], dim=1)
    got = karatsuba.prod_k1(wide[:, :16], wide[:, 16:])
    ref = mont_mxu.prod_lm_k1(jnp.asarray(a), jnp.asarray(b), interpret=True)
    assert _ints(bn.to_host(got)) == _ints(ref) == [x * y for x, y in zip(_ints(a), _ints(b))]


def test_k1_wrappers_refuse_what_the_kernels_do_not_take():
    a = torch.zeros((36, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        mont_cuda.k1_halfsums(a[:34], a[:34])  # L not a multiple of 4
    s = mont_cuda.k1_halfsums(a, a)
    z = torch.zeros((108, 4), dtype=torch.int32)
    assert mont_cuda.k1_combine(z, s, 36).shape == (72, 4)
    with pytest.raises(ValueError):
        mont_cuda.k1_combine(z[:, :3], s, 36)  # batches differ
    with pytest.raises(ValueError):
        mont_cuda.k1_combine(z[:100], s, 36)  # not B4's (3L, B)
    with pytest.raises(ValueError):
        mont_cuda.k1_combine(z, s, 34)
