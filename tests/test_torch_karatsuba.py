"""The port's Karatsuba families (DDS_KARATSUBA = 1 | 2) against the
reference's.

`dds_tpu_torch.ops.{flags,karatsuba,montgomery,mont_cuda}` on CPU tensors
(every kernel wrapper runs its plain version there) against `dds_tpu`'s
`flags.karatsuba_mode`, the Pallas products `mont_mxu._prod3_call` (B4),
`prod_lm_k1`, `prod_lm_kf` (B5), the XLA reduction `_redc`, `mul2_lm` and
`reduce_mul2`, the Pallas kernels in interpret mode as tests/test_mxu.py
runs them, and against Python ints. Small moduli: 256 and 512 bits (L = 16
and 32), and L = 33 and 36 for the shape rule. Exact integer arithmetic:
tolerance zero.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dds_tpu.ops import flags as ref_flags
from dds_tpu.ops import mont_mxu
from dds_tpu.ops.montgomery import ModCtx as RefCtx
from dds_tpu_torch.models.backend import CudaBackend
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import flags, karatsuba, mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx

MODES = [False, "k1", "fused"]


def _rand_mod(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _lm(vals, L):
    """Python ints -> limbs-major (L, B) int32 CPU tensor."""
    return bn.to_device(bn.ints_to_batch(vals, L), "cpu").T.contiguous()


def _ints_lm(x) -> list[int]:
    """Limbs-major (rows, B) limbs (canonical or redundant) -> ints."""
    a = np.asarray(x).astype(np.uint64)
    return [bn.limbs_to_int(a[:, j]) for j in range(a.shape[1])]


def _edge_operands(rng, n, count):
    return [rng.randrange(n) for _ in range(count)] + [0, 1, n - 1]


@pytest.mark.parametrize("value", ["", "0", "false", "OFF", "no", "1", "true", "on",
                                   "yes", "k1", "2", " Fused ", "3", "k2", "bogus"])
def test_karatsuba_mode_matches_reference(monkeypatch, value):
    monkeypatch.setenv("DDS_KARATSUBA", value)
    try:
        want = ref_flags.karatsuba_mode()
    except ValueError:
        with pytest.raises(ValueError):
            flags.karatsuba_mode()
        return
    assert flags.karatsuba_mode() == want


def test_backend_validates_the_mode_at_construction(monkeypatch):
    monkeypatch.setenv("DDS_KARATSUBA", "fast")
    with pytest.raises(ValueError):
        CudaBackend(device="cpu")
    for value, family in (("", "cios"), ("1", "k1"), ("fused", "fused")):
        monkeypatch.setenv("DDS_KARATSUBA", value)
        assert CudaBackend(device="cpu").fold_kernel() == family


@pytest.mark.parametrize("h", [8, 16])
def test_prod3_plain_matches_pallas_prod3(h):
    """The plain B4 (canonical [z0 | z2 | z1]) against `_prod3_call`'s
    redundant blocks, compared as the integers they encode."""
    rng = np.random.default_rng(h)
    ops = [rng.integers(0, 1 << 16, size=(h, 128), dtype=np.uint32) for _ in range(6)]
    ops[0][:, 0] = ops[1][:, 0] = 0xFFFF  # the largest operands
    ops[2][:, 1] = 0
    ref = np.asarray(mont_mxu._prod3_call(h, 128, 128, True)(*map(jnp.asarray, ops)))
    got = bn.to_host(mont_cuda.prod3(*(bn.to_device(x, "cpu") for x in ops)))
    assert got.shape == ref.shape == (6 * h, 128) and (got >> 16).max() == 0
    for p, (x, y) in enumerate(((0, 1), (2, 3), (4, 5))):
        block = slice(2 * h * p, 2 * h * (p + 1))
        want = [u * v for u, v in zip(_ints_lm(ops[x]), _ints_lm(ops[y]))]
        assert _ints_lm(got[block]) == _ints_lm(ref[block]) == want


@pytest.mark.parametrize("bits", [256, 512])
def test_karatsuba_products_match_reference_and_python(bits):
    rng = random.Random(bits)
    L = bn.n_limbs_for_bits(bits)
    top = (1 << bits) - 1  # all-ones halves: both overflow bits set
    xs = [rng.getrandbits(bits) for _ in range(5)] + [0, 1, top]
    ys = [rng.getrandbits(bits) for _ in range(5)] + [top, 1, top]
    want = [x * y for x, y in zip(xs, ys)]
    a, b = _lm(xs, L), _lm(ys, L)
    A, B = jnp.asarray(bn.ints_to_batch(xs, L).T), jnp.asarray(bn.ints_to_batch(ys, L).T)
    k1, kf = karatsuba.prod_k1(a, b), karatsuba.prod_kf(a, b)
    assert k1.shape == kf.shape == (2 * L, len(xs)) and k1.dtype == torch.int32
    assert _ints_lm(k1) == _ints_lm(mont_mxu.prod_lm_k1(A, B, interpret=True)) == want
    assert _ints_lm(kf) == _ints_lm(mont_mxu.prod_lm_kf(A, B, interpret=True)) == want
    assert torch.equal(k1, kf)  # both canonical
    # operands as column slices of a wider array, as a fold level passes them
    wide = torch.cat([a, b], dim=1)
    assert torch.equal(karatsuba.prod_k1(wide[:, :8], wide[:, 8:]), k1)


@pytest.mark.parametrize("bits", [256, 512])
def test_redc_plain_matches_reference_redc(bits):
    rng = random.Random(bits + 7)
    n = _rand_mod(rng, bits)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    assert ctx.R == 1 << (16 * ref.L)
    Ts = [rng.randrange(n * ctx.R) for _ in range(6)] + [0, 1, n * ctx.R - 1, (n - 1) ** 2]
    got = mont_cuda.redc(ctx, _lm(Ts, 2 * ctx.L))
    want = np.asarray(mont_mxu._redc(mont_mxu.MxuCtx.make(ref),
                                     jnp.asarray(bn.ints_to_batch(Ts, 2 * ctx.L).T)))
    np.testing.assert_array_equal(bn.to_host(got), want)
    Rinv = pow(ctx.R, -1, n)
    assert _ints_lm(bn.to_host(got)) == [T * Rinv % n for T in Ts]


@pytest.mark.parametrize("bits", [256, 512])
@pytest.mark.parametrize("mode", MODES)
def test_mul_each_mode_matches_mul2_lm(bits, mode):
    rng = random.Random(bits + 11)
    n = _rand_mod(rng, bits)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    a, b = _edge_operands(rng, n, 5), _edge_operands(rng, n, 5)[::-1]
    got = mont_cuda.mul(ctx, _lm(a, ctx.L), _lm(b, ctx.L), karatsuba=mode)
    want = np.asarray(mont_mxu.mul2_lm(
        mont_mxu.MxuCtx.make(ref), jnp.asarray(bn.ints_to_batch(a, ctx.L).T),
        jnp.asarray(bn.ints_to_batch(b, ctx.L).T), interpret=True, karatsuba=mode))
    np.testing.assert_array_equal(bn.to_host(got), want)
    Rinv = pow(ctx.R, -1, n)
    assert _ints_lm(bn.to_host(got)) == [x * y * Rinv % n for x, y in zip(a, b)]


@pytest.mark.parametrize("mode", ["0", "1", "2"])
@pytest.mark.parametrize("K", [1, 2, 11, 64])
def test_reduce_mul_each_mode_matches_reduce_mul2(monkeypatch, mode, K):
    monkeypatch.setenv("DDS_KARATSUBA", mode)
    rng = random.Random(K)
    n = _rand_mod(rng, 256)
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    cs = [rng.randrange(n) for _ in range(K)]
    rows = bn.ints_to_batch(cs, ctx.L)
    got = bn.to_host(mont_cuda.reduce_mul(ctx, bn.to_device(rows, "cpu")))
    want = np.asarray(mont_mxu.reduce_mul2(mont_mxu.MxuCtx.make(ref), rows, interpret=True))
    np.testing.assert_array_equal(got, want)
    prod = 1
    for c in cs:
        prod = prod * c % n
    assert bn.limbs_to_int(got[0]) == prod


class _Spy:
    """Counts the calls of the Karatsuba products and the reduction."""

    def __init__(self, monkeypatch):
        self.calls = {"prod_k1": 0, "prod_kf": 0, "redc": 0}
        for mod, name in ((karatsuba, "prod_k1"), (karatsuba, "prod_kf"), (mont_cuda, "redc")):
            monkeypatch.setattr(mod, name, self._wrap(name, getattr(mod, name)))

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return spy


@pytest.mark.parametrize("bits,L,karatsuba_route", [(512, 32, True), (528, 33, False),
                                                     (576, 36, False)])
@pytest.mark.parametrize("mode", ["k1", "fused"])
def test_shape_rule_routes_other_limb_counts_to_cios(monkeypatch, bits, L, karatsuba_route,
                                                     mode):
    """The reference's rule: even L with (L/2) % 8 == 0 takes the Karatsuba
    route, L = 33 and 36 the CIOS kernel; the values equal Python's."""
    rng = random.Random(bits)
    n = _rand_mod(rng, bits)
    ctx = ModCtx.make(n)
    assert ctx.L == L and karatsuba.fits(L) == karatsuba_route
    spy = _Spy(monkeypatch)
    a, b = _edge_operands(rng, n, 3), _edge_operands(rng, n, 3)
    got = mont_cuda.mul(ctx, _lm(a, L), _lm(b, L), karatsuba=mode)
    Rinv = pow(ctx.R, -1, n)
    assert _ints_lm(bn.to_host(got)) == [x * y * Rinv % n for x, y in zip(a, b)]
    used = {"k1": "prod_k1", "fused": "prod_kf"}[mode]
    assert spy.calls[used] == spy.calls["redc"] == (1 if karatsuba_route else 0)
    assert sum(spy.calls.values()) == (2 if karatsuba_route else 0)
    if not karatsuba_route:
        with pytest.raises(ValueError):
            karatsuba.prod_k1(_lm(a, L), _lm(b, L))


def test_mode_flipped_during_a_fold_keeps_the_folds_family(monkeypatch):
    """reduce_mul reads DDS_KARATSUBA once: a flip after its first level
    does not change the family of the rest of that fold."""
    monkeypatch.setenv("DDS_KARATSUBA", "1")
    rng = random.Random(3)
    n = _rand_mod(rng, 256)
    ctx = ModCtx.make(n)
    spy = _Spy(monkeypatch)
    real_mul = mont_cuda.mul

    def flipping_mul(*args, **kwargs):
        out = real_mul(*args, **kwargs)
        monkeypatch.setenv("DDS_KARATSUBA", "2")
        return out

    monkeypatch.setattr(mont_cuda, "mul", flipping_mul)
    cs = [rng.randrange(n) for _ in range(16)]
    got = mont_cuda.reduce_mul(ctx, bn.to_device(bn.ints_to_batch(cs, ctx.L), "cpu"))
    prod = 1
    for c in cs:
        prod = prod * c % n
    assert bn.limbs_to_int(bn.to_host(got)[0]) == prod
    assert flags.karatsuba_mode() == "fused"  # the flip happened
    assert spy.calls == {"prod_k1": mont_cuda.fold_launches(16), "prod_kf": 0,
                         "redc": mont_cuda.fold_launches(16)}


@pytest.mark.parametrize("mode", MODES)
def test_pow_mod_domain_multiplies_obey_the_mode(monkeypatch, mode):
    """pow_mod's two domain multiplies take the family; its ladder is the
    exp kernel's CIOS in every family. Values equal Python `pow`."""
    rng = random.Random(17)
    n = _rand_mod(rng, 256)
    ctx = ModCtx.make(n)
    spy = _Spy(monkeypatch)
    bases = _edge_operands(rng, n, 3)
    got = mont_cuda.pow_mod(ctx, bn.to_device(bn.ints_to_batch(bases, ctx.L), "cpu"), 65537,
                            karatsuba=mode)
    assert bn.batch_to_ints(bn.to_host(got)) == [pow(x, 65537, n) for x in bases]
    assert spy.calls["redc"] == (2 if mode else 0)
