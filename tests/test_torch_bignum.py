"""dds_tpu_torch.ops.bignum against its reference, dds_tpu.ops.bignum.

Same seeded inputs through both packages; the arithmetic is exact integer
arithmetic, so the tolerance is zero: limbs must be equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dds_tpu.ops import bignum as ref
from dds_tpu_torch.ops import bignum as bn


def _rand_ints(rng, count, bits):
    return [int.from_bytes(rng.bytes((bits + 7) // 8), "little") >> ((8 - bits % 8) % 8)
            for _ in range(count)]


@pytest.mark.parametrize("bits", [16, 512, 1040, 4096])
def test_host_conversions_match_reference(bits):
    rng = np.random.default_rng(bits)
    L = bn.n_limbs_for_bits(bits)
    assert L == ref.n_limbs_for_bits(bits)
    xs = _rand_ints(rng, 7, bits) + [0, (1 << bits) - 1]
    batch = bn.ints_to_batch(xs, L)
    assert batch.dtype == np.uint32
    np.testing.assert_array_equal(batch, ref.ints_to_batch(xs, L))
    assert bn.batch_to_ints(batch) == ref.batch_to_ints(batch) == xs
    for x in xs[:3]:
        np.testing.assert_array_equal(bn.int_to_limbs(x, L), ref.int_to_limbs(x, L))
    np.testing.assert_array_equal(bn.ones_batch(3, L), ref.ones_batch(3, L))
    assert bn.ints_to_batch([], L).shape == ref.ints_to_batch([], L).shape == (0, L)


def test_conversion_range_errors_match_reference():
    for mod in (bn, ref):
        with pytest.raises(ValueError):
            mod.int_to_limbs(-1, 4)
        with pytest.raises(ValueError):
            mod.int_to_limbs(1 << 64, 4)
        with pytest.raises(ValueError):
            mod.ints_to_batch([1 << 64], 4)


def test_limbs_to_int_redundant_limbs_match_reference():
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 1 << 20, size=9, dtype=np.uint32)  # limbs >= 2^16
    assert bn.limbs_to_int(arr) == ref.limbs_to_int(arr)


def test_device_round_trip_is_int32_view():
    rng = np.random.default_rng(4)
    batch = bn.ints_to_batch(_rand_ints(rng, 5, 256), 16)
    t = bn.to_device(batch, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (5, 16)
    np.testing.assert_array_equal(bn.to_host(t), batch)


def test_normalize_matches_reference():
    rng = np.random.default_rng(5)
    t = rng.integers(0, 1 << 31, size=(6, 24), dtype=np.uint32)
    got, carry = bn.normalize(torch.from_numpy(t.astype(np.int64)))
    want, wcarry = ref.normalize(jnp.asarray(t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(wcarry))


def test_sub_cond_sub_geq_match_reference():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 1 << 16, size=(8, 12), dtype=np.uint32)
    b = rng.integers(0, 1 << 16, size=(8, 12), dtype=np.uint32)
    b[0] = a[0]  # equal operands: borrow 0, diff 0
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    diff, borrow = bn.sub(ta, tb)
    wdiff, wborrow = ref.sub(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(diff.numpy(), np.asarray(wdiff))
    np.testing.assert_array_equal(borrow.numpy(), np.asarray(wborrow))
    mod = b[3]
    np.testing.assert_array_equal(
        bn.cond_sub(ta, torch.from_numpy(mod.astype(np.int64))).numpy(),
        np.asarray(ref.cond_sub(jnp.asarray(a), jnp.asarray(mod))),
    )
    np.testing.assert_array_equal(
        bn.geq(ta, torch.from_numpy(mod.astype(np.int64))).numpy(),
        np.asarray(ref.geq(jnp.asarray(a), jnp.asarray(mod))),
    )
