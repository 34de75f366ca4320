"""The port's plain Montgomery path against the reference's three.

`dds_tpu_torch.ops.montgomery.ModCtx` (plain PyTorch CIOS) and
`dds_tpu_torch.ops.mont_cuda` (the kernel wrapper, which runs that plain
path for CPU tensors) against `dds_tpu`'s jnp `ModCtx`, the v2 Pallas
product + MXU reduction (`mont_mxu.mul2_lm` / `reduce_mul2`) and the v1
fused CIOS kernel (`pallas_mont.mul_lm` / `reduce_mul`), the Pallas
kernels in interpret mode as tests/test_mxu.py runs them. Exact integer
arithmetic: tolerance zero. At even L both packages use R = 2^(16L), so
Montgomery-domain limbs agree too; the odd-L case compares plain-domain
results only.
"""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dds_tpu.ops import mont_mxu, pallas_mont
from dds_tpu.ops.montgomery import ModCtx as RefCtx
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx


def _rand_mod(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _operands(rng, n, count):
    vals = [rng.randrange(n) for _ in range(count)] + [0, n - 1]
    return vals


def _t(vals, L):
    return bn.to_device(bn.ints_to_batch(vals, L), "cpu")


@pytest.mark.parametrize("bits", [512, 1024])
def test_constants_match_reference_at_even_L(bits):
    n = _rand_mod(random.Random(bits), bits)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    assert ctx.L == ref.L and ctx.L % 2 == 0 and ctx.R == 1 << (16 * ref.L)
    np.testing.assert_array_equal(ctx.N, ref.N)
    np.testing.assert_array_equal(ctx.R2, ref.R2)
    np.testing.assert_array_equal(ctx.one_mont, ref.one_mont)
    assert ctx.n0inv == int(ref.n0inv)
    assert ctx.n0inv32 == (-pow(n, -1, 1 << 32)) % (1 << 32)


@pytest.mark.parametrize("bits", [512, 1024])
def test_mont_mul_matches_all_reference_multiplies(bits):
    rng = random.Random(bits + 1)
    n = _rand_mod(rng, bits)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    a, b = _operands(rng, n, 5), _operands(rng, n, 5)[::-1]
    A, B = bn.ints_to_batch(a, ctx.L), bn.ints_to_batch(b, ctx.L)
    got = bn.to_host(ctx.mont_mul(_t(a, ctx.L), _t(b, ctx.L)))
    # the kernel wrapper's CPU path: limbs-major (L, B) in and out
    got_lm = bn.to_host(mont_cuda.mul(ctx, _t(a, ctx.L).T.contiguous(),
                                      _t(b, ctx.L).T.contiguous())).T
    want = np.asarray(ref.mont_mul(jnp.asarray(A), jnp.asarray(B)))
    v2 = np.asarray(mont_mxu.mul2_lm(mont_mxu.MxuCtx.make(ref), jnp.asarray(A).T,
                                     jnp.asarray(B).T, interpret=True)).T
    v1 = np.asarray(pallas_mont.mul_lm(ref, jnp.asarray(A).T, jnp.asarray(B).T,
                                       interpret=True)).T
    for other in (got_lm, want, v2, v1):
        np.testing.assert_array_equal(got, other)
    Rinv = pow(ctx.R, -1, n)
    assert bn.batch_to_ints(got) == [x * y * Rinv % n for x, y in zip(a, b)]


def test_domain_conversions_match_reference():
    rng = random.Random(11)
    n = _rand_mod(rng, 512)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    x = _operands(rng, n, 4)
    X = bn.ints_to_batch(x, ctx.L)
    xm = ctx.to_mont(_t(x, ctx.L))
    np.testing.assert_array_equal(bn.to_host(xm), np.asarray(ref.to_mont(jnp.asarray(X))))
    np.testing.assert_array_equal(bn.to_host(ctx.from_mont(xm)), X)
    y = _operands(rng, n, 4)
    np.testing.assert_array_equal(
        bn.to_host(ctx.mul_mod(_t(x, ctx.L), _t(y, ctx.L))),
        np.asarray(ref.mul_mod(jnp.asarray(X), jnp.asarray(bn.ints_to_batch(y, ctx.L)))),
    )


@pytest.mark.parametrize("K", [1, 5, 8, 33])
def test_reduce_mul_matches_all_reference_folds(K):
    rng = random.Random(100 + K)
    n = _rand_mod(rng, 512)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    cs = [rng.randrange(n) for _ in range(K)]
    C = bn.ints_to_batch(cs, ctx.L)
    plain = bn.to_host(ctx.reduce_mul(_t(cs, ctx.L)))
    tree = bn.to_host(mont_cuda.reduce_mul(ctx, _t(cs, ctx.L)))
    want = np.asarray(mont_mxu.reduce_mul2(mont_mxu.MxuCtx.make(ref), C, interpret=True))
    v1 = np.asarray(pallas_mont.reduce_mul(ref, C, interpret=True))
    jnp_ref = np.asarray(ref.reduce_mul(jnp.asarray(C)))
    assert plain.shape == tree.shape == want.shape == (1, ctx.L)
    for other in (tree, want, v1, jnp_ref):
        np.testing.assert_array_equal(plain, other)
    prod = 1
    for c in cs:
        prod = prod * c % n
    assert bn.limbs_to_int(plain[0]) == prod


def test_odd_limb_count_plain_domain_matches_reference():
    """520-bit modulus: L = 33 limbs, so the port's radix is 2^(16*34)
    (one limb wider than the reference's) and only plain-domain results
    are comparable."""
    rng = random.Random(33)
    n = _rand_mod(rng, 520)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    assert ctx.L == ref.L == 33 and ctx.W == 17 and ctx.R == 1 << (16 * 34)
    a, b = _operands(rng, n, 3), _operands(rng, n, 3)
    A, B = bn.ints_to_batch(a, ctx.L), bn.ints_to_batch(b, ctx.L)
    np.testing.assert_array_equal(
        bn.to_host(ctx.mul_mod(_t(a, ctx.L), _t(b, ctx.L))),
        np.asarray(ref.mul_mod(jnp.asarray(A), jnp.asarray(B))),
    )
    Rinv = pow(ctx.R, -1, n)
    got = bn.batch_to_ints(bn.to_host(ctx.mont_mul(_t(a, ctx.L), _t(b, ctx.L))))
    assert got == [x * y * Rinv % n for x, y in zip(a, b)]
    cs = [rng.randrange(n) for _ in range(7)]
    C = bn.ints_to_batch(cs, ctx.L)
    want = np.asarray(ref.reduce_mul(jnp.asarray(C)))
    np.testing.assert_array_equal(bn.to_host(ctx.reduce_mul(_t(cs, ctx.L))), want)
    np.testing.assert_array_equal(bn.to_host(mont_cuda.reduce_mul(ctx, _t(cs, ctx.L))), want)


def test_kernel_wrapper_rejects_bad_operands():
    n = _rand_mod(random.Random(5), 512)
    ctx = ModCtx.make(n)
    good = torch.zeros((ctx.L, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        mont_cuda.mul(ctx, good.to(torch.int64), good)
    with pytest.raises(ValueError):
        mont_cuda.mul(ctx, good[:-1], good[:-1])
    with pytest.raises(ValueError):
        mont_cuda.mul(ctx, good, torch.zeros((ctx.L, 5), dtype=torch.int32))
    with pytest.raises(ValueError):  # column stride 2: not a column slice
        wide = torch.zeros((ctx.L, 8), dtype=torch.int32)
        mont_cuda.mul(ctx, wide[:, ::2], wide[:, 1::2])
    with pytest.raises(ValueError):  # neither cuda nor cpu: no silent path
        meta = torch.zeros((ctx.L, 4), dtype=torch.int32, device="meta")
        mont_cuda.mul(ctx, meta, meta)
    with pytest.raises(ValueError):
        mont_cuda.reduce_mul(ctx, torch.zeros((0, ctx.L), dtype=torch.int32))


def test_fold_launch_count_formula():
    assert [mont_cuda.fold_launches(k) for k in (1, 2, 3, 8192, 65536)] == [2, 2, 3, 14, 17]
