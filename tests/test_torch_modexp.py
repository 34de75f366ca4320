"""The port's modexp (plain ladder and the exp kernel's wrapper) against the
reference's, at a 256-bit modulus, in the Montgomery domain and at odd L.

`dds_tpu_torch.ops.montgomery.ModCtx.pow_mod` / `mont_exp` (the plain
PyTorch 4-bit-window ladder) and `dds_tpu_torch.ops.mont_cuda.pow_mod` /
`exp` (the exp kernel's wrapper, which runs that ladder for CPU tensors)
against `dds_tpu`'s jnp `ModCtx.pow_mod`, the v1 Pallas ladder
`pallas_mont.pow_mod` / `exp_lm` (the B3 kernel), the v2
`mont_mxu.pow_mod2`, and Python `pow`; the Pallas kernels in interpret
mode, as tests/test_pallas.py runs them. The 512-bit cases and the
backends are in tests/test_torch_modexp_backend.py. Exact integer
arithmetic: tolerance zero.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dds_tpu.ops import bignum as rbn
from dds_tpu.ops import mont_mxu, pallas_mont
from dds_tpu.ops.montgomery import ModCtx as RefCtx
from dds_tpu.ops.montgomery import _exp_to_digits as ref_digits
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx, _exp_to_digits

EXPS = [0, 1, 2, 65537, (1 << 64) + 12345]


def _rand_mod(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _t(vals, L):
    return bn.to_device(bn.ints_to_batch(vals, L), "cpu")


def pow_mod_against_all_references(bits: int, exp: int) -> None:
    """The port's two pow_mod entry points against the reference's three
    and Python `pow` on 4 seeded bases (one of them n - 1). One modulus
    per width, so the reference's compiled ladders serve every exponent
    with the same digit count."""
    n = _rand_mod(random.Random(bits), bits)
    rng = random.Random(bits * 7 + exp % 1009)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    bases = [rng.randrange(n) for _ in range(3)] + [n - 1]
    X = rbn.ints_to_batch(bases, ref.L)
    plain = bn.to_host(ctx.pow_mod(_t(bases, ctx.L), exp))
    wrapper = bn.to_host(mont_cuda.pow_mod(ctx, _t(bases, ctx.L), exp))
    jnp_ref = np.asarray(ref.pow_mod(jnp.asarray(X), exp))
    v1 = np.asarray(pallas_mont.pow_mod(ref, X, exp, interpret=True))
    v2 = np.asarray(mont_mxu.pow_mod2(mont_mxu.MxuCtx.make(ref), X, exp, interpret=True))
    for other in (wrapper, jnp_ref, v1, v2):
        np.testing.assert_array_equal(plain, other)
    assert bn.batch_to_ints(plain) == [pow(b, exp, n) for b in bases]


@pytest.mark.parametrize("exp", EXPS)
def test_pow_mod_matches_all_references_256(exp):
    pow_mod_against_all_references(256, exp)


@pytest.mark.parametrize("exp", EXPS + [(1 << 300) - 1, 3 << 500])
def test_exp_to_digits_matches_reference(exp):
    np.testing.assert_array_equal(_exp_to_digits(exp), ref_digits(exp))
    assert _exp_to_digits(exp).dtype == ref_digits(exp).dtype


def test_negative_exponent_raises():
    with pytest.raises(ValueError):
        _exp_to_digits(-1)


def test_mont_exp_matches_exp_lm_bit_exact_at_even_L():
    """Montgomery-domain ladder output, limb for limb: at even L the port's
    R is the reference's, so the plain ladder, the exp wrapper and the B3
    Pallas kernel agree bit for bit."""
    rng = random.Random(256)
    n = _rand_mod(rng, 256)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    assert ctx.L % 2 == 0 and ctx.R == 1 << (16 * ref.L)
    bases = [rng.randrange(n) for _ in range(5)]
    exp = (1 << 63) | 0x5DEECE66D
    xm = ctx.to_mont(_t(bases, ctx.L))
    np.testing.assert_array_equal(
        bn.to_host(xm), np.asarray(ref.to_mont(jnp.asarray(rbn.ints_to_batch(bases, ref.L)))))
    digits = _exp_to_digits(exp)
    plain = bn.to_host(ctx.mont_exp(xm, digits))
    wrapper = bn.to_host(mont_cuda.exp(
        ctx, xm.T.contiguous(), torch.from_numpy(digits.astype(np.int32)))).T
    v1 = np.asarray(pallas_mont.exp_lm(
        ref, jnp.asarray(bn.to_host(xm)).T, jnp.asarray(digits.astype(np.int32)),
        TB=128, interpret=True)).T
    np.testing.assert_array_equal(plain, wrapper)
    np.testing.assert_array_equal(plain, v1)
    Rinv = pow(ctx.R, -1, n)
    assert [x * Rinv % n for x in bn.batch_to_ints(plain)] == [pow(b, exp, n) for b in bases]


def test_odd_limb_count_plain_domain_matches_reference():
    """520-bit modulus: L = 33, so the port's R is one limb wider than the
    reference's and only plain-domain pow_mod results are comparable."""
    rng = random.Random(520)
    n = _rand_mod(rng, 520)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    assert ctx.L == ref.L == 33 and ctx.R == 1 << (16 * 34)
    bases = [rng.randrange(n) for _ in range(3)] + [0, 1, n - 1]
    for exp in (0, 1, 2, 65537):
        got = bn.to_host(mont_cuda.pow_mod(ctx, _t(bases, ctx.L), exp))
        want = np.asarray(ref.pow_mod(jnp.asarray(rbn.ints_to_batch(bases, ref.L)), exp))
        np.testing.assert_array_equal(got, want)
        assert bn.batch_to_ints(got) == [pow(b, exp, n) for b in bases]


def test_exp_wrapper_rejects_bad_operands_and_launches_nothing_on_cpu():
    n = _rand_mod(random.Random(5), 256)
    ctx = ModCtx.make(n)
    base = torch.zeros((ctx.L, 4), dtype=torch.int32)
    digits = torch.tensor([1, 0, 3], dtype=torch.int32)
    with pytest.raises(TypeError):
        mont_cuda.exp(ctx, base.to(torch.int64), digits)
    with pytest.raises(ValueError):
        mont_cuda.exp(ctx, base[:-1], digits)
    with pytest.raises(ValueError):  # a broadcast column is not taken
        mont_cuda.exp(ctx, base[:, :1].expand(ctx.L, 4), digits)
    with pytest.raises(ValueError):
        mont_cuda.exp(ctx, base, digits.to(torch.int64))
    with pytest.raises(ValueError):
        mont_cuda.exp(ctx, base, digits[:0])
    with pytest.raises(ValueError):  # neither cuda nor cpu: no silent path
        mont_cuda.exp(ctx, base.to("meta"), digits.to("meta"))
    with pytest.raises(ValueError):
        mont_cuda.pow_mod(ctx, torch.zeros((0, ctx.L), dtype=torch.int32), 3)
    before = (mont_cuda.exp_launches.value, mont_cuda.launches.value)
    one = torch.zeros((2, ctx.L), dtype=torch.int32)
    one[:, 0] = 1
    assert torch.equal(mont_cuda.pow_mod(ctx, _t([5, 7], ctx.L), 0), one)
    assert bn.batch_to_ints(bn.to_host(mont_cuda.pow_mod(ctx, _t([5, 7], ctx.L), 3))) == [
        125, 343]
    assert (mont_cuda.exp_launches.value, mont_cuda.launches.value) == before
