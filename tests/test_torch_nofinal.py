"""The CIOS product without its final subtraction (the probe P of
`benchmarks/profile_kernel.py::make_nofinal_mul`) against the reference.

`ModCtx.mont_mul_nofinal` and `mont_cuda.mul_nofinal` (its CPU path)
against the Pallas probe in interpret mode, which emits the loop's
redundant accumulator rows below L, and against Python's
t = (a*b + m*n) / R with m = -a*b*n^-1 mod R. Both compare mod R: the
probe drops the rows at and above L. Exact integer arithmetic: tolerance
zero.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks.profile_kernel import make_nofinal_mul
from dds_tpu.ops import pallas_mont as pm
from dds_tpu.ops.montgomery import ModCtx as RefCtx
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx


def _rand_mod(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _python_t(x: int, y: int, n: int, R: int) -> int:
    m = (-x * y * pow(n, -1, R)) % R
    return (x * y + m * n) // R


@pytest.mark.parametrize("bits", [256, 512])
def test_nofinal_matches_the_pallas_probe_mod_R(bits):
    rng = random.Random(bits)
    n = _rand_mod(rng, bits)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    L, TB = ctx.L, 128
    a = [rng.randrange(n) for _ in range(TB - 3)] + [0, 1, n - 1]
    b = [rng.randrange(n) for _ in range(TB - 3)] + [n - 1, 1, n - 1]
    A, B = bn.ints_to_batch(a, L), bn.ints_to_batch(b, L)
    probe = make_nofinal_mul(L, pm._pad_rows(L), TB)(TB)
    t_ref = np.asarray(probe(pm._n0(ref), jnp.asarray(A.T), jnp.asarray(B.T), pm._nbx(ref, TB)))
    got = bn.to_host(ctx.mont_mul_nofinal(bn.to_device(A, "cpu"), bn.to_device(B, "cpu")))
    R = ctx.R
    ref_vals = [bn.limbs_to_int(t_ref[:, j].astype(np.uint64)) % R for j in range(TB)]
    assert bn.batch_to_ints(got) == ref_vals
    assert ref_vals == [_python_t(x, y, n, R) % R for x, y in zip(a, b)]
    lm = mont_cuda.mul_nofinal(ctx, bn.to_device(A, "cpu").T.contiguous(),
                               bn.to_device(B, "cpu").T.contiguous())
    np.testing.assert_array_equal(bn.to_host(lm).T, got)


@pytest.mark.parametrize("bits", [256, 512, 528])
def test_nofinal_is_the_loop_accumulator_and_mul_is_its_reduction(bits):
    """The low L limbs of t = (a*b + m*n) / R (t mod R at even L); where t
    fits them (t < R at even L: the top word is 0), that is t itself,
    which is `mul`'s result or that plus n."""
    rng = random.Random(bits + 1)
    n = _rand_mod(rng, bits)
    ctx = ModCtx.make(n)
    a = [rng.randrange(n) for _ in range(40)] + [0, 1, n - 1]
    b = [rng.randrange(n) for _ in range(40)] + [n - 1, 1, n - 1]
    A, B = (bn.to_device(bn.ints_to_batch(v, ctx.L), "cpu") for v in (a, b))
    got = bn.batch_to_ints(bn.to_host(ctx.mont_mul_nofinal(A, B)))
    mul = bn.batch_to_ints(bn.to_host(ctx.mont_mul(A, B)))
    low = 1 << (16 * ctx.L)
    fits = 0
    for x, y, g, m in zip(a, b, got, mul):
        t = _python_t(x, y, n, ctx.R)
        assert t < 2 * n and g == t % low
        if t < low:
            fits += 1
            assert g in (m, m + n)
    assert fits > len(a) // 2
