"""Prism's weighted fold, weight encoding, backends and row cap in the
port against the reference's.

`dds_tpu_torch.ops.foldmany.fold_weighted` runs on the CPU (the plain
PyTorch Montgomery product and Karatsuba pieces behind `mont_cuda.mul`)
and must equal `dds_tpu.ops.foldmany.fold_weighted` with `kernel="jnp"`
and with `kernel="v2"` (the Pallas kernels in interpret mode, as
tests/test_analytics.py runs them) bit for bit: at K = 5 operands and
R = 3 rows (neither a power of two, so both pads run), a zero weight, an
all-zero row, and the full-width n - 5 exponent of the negative-weight
encoding. A 256-bit odd modulus gives L = 16 limbs, where the Karatsuba
shape rule holds (`karatsuba.fits(16)`), so DDS_KARATSUBA = 1 and 2 run
their own products. Inputs come from seeded numpy generators; every check
is exact.
"""

import numpy as np
import pytest

from dds_tpu.models.backend import get_backend as ref_get_backend
from dds_tpu.models.paillier import PaillierKey as RefPaillierKey
from dds_tpu.ops import flags as ref_flags
from dds_tpu.ops.foldmany import fold_weighted as ref_fold_weighted
from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.models.backend import CpuBackend, CudaBackend
from dds_tpu_torch.ops import flags, foldmany, karatsuba, mont_cuda
from dds_tpu_torch.ops.foldmany import fold_weighted
from dds_tpu_torch.ops.montgomery import ModCtx

MODES = {"0": False, "1": "k1", "2": "fused"}


def _odd_modulus(seed: int, bits: int = 256) -> int:
    rng = np.random.default_rng(seed)
    return int.from_bytes(rng.bytes(bits // 8), "little") | (1 << (bits - 1)) | 1


def _below(rng, n: int, count: int) -> list[int]:
    nbytes = (n.bit_length() + 7) // 8
    return [int.from_bytes(rng.bytes(nbytes), "little") % (n - 1) + 1 for _ in range(count)]


def _python_rows(cs, weights, modulus) -> list[int]:
    out = []
    for row in weights:
        acc = 1
        for c, w in zip(cs, row):
            acc = acc * pow(c, w, modulus) % modulus
        out.append(acc)
    return out


@pytest.fixture(scope="module")
def case():
    """K = 5 operands, R = 3 rows of 20-bit weights (D = 5 digits), one
    zero weight and an all-zero row, at a 256-bit modulus (L = 16)."""
    n = _odd_modulus(11)
    rng = np.random.default_rng(12)
    cs = _below(rng, n, 5)
    weights = [[int(w) for w in rng.integers(0, 1 << 20, size=5)] for _ in range(3)]
    weights[1][2] = 0
    weights[2] = [0] * 5
    assert ModCtx.make(n).L == 16 and karatsuba.fits(16)
    return n, cs, weights


@pytest.fixture(scope="module")
def reference(case):
    """The reference's results: `jnp`, and `v2` in interpret mode (the
    family DDS_KARATSUBA names, here the default, mode 0)."""
    n, cs, weights = case
    out = {k: ref_fold_weighted(cs, weights, n, kernel=k) for k in ("jnp", "v2")}
    assert out["jnp"] == out["v2"] == _python_rows(cs, weights, n)
    return out


@pytest.mark.parametrize("kernel", ["jnp", "v2"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_fold_weighted_equals_the_reference(case, reference, monkeypatch, kernel, mode):
    n, cs, weights = case
    monkeypatch.setenv("DDS_KARATSUBA", mode)
    got = fold_weighted(cs, weights, n, device="cpu")
    assert got == reference[kernel]
    assert got[2] == 1  # the all-zero row


def test_fold_weighted_full_width_negative_encoding(monkeypatch):
    """n - 5 is a 256-bit exponent: D = 64 digits of the ladder."""
    monkeypatch.delenv("DDS_KARATSUBA", raising=False)
    n = _odd_modulus(13)
    cs = _below(np.random.default_rng(14), n, 2)
    weights = [[n - 5, 3]]
    got = fold_weighted(cs, weights, n, device="cpu")
    assert got == ref_fold_weighted(cs, weights, n, kernel="jnp") == _python_rows(cs, weights, n)


@pytest.mark.parametrize("cs, weights, why", [
    ([], [[1]], "no operand"),
    ([3], [], "no row"),
    ([3, 5], [[1]], "row narrower than the operands"),
    ([3], [[-1]], "unencoded negative"),
    ([3], [[(1 << 127) - 1]], "exponent >= modulus"),
])
def test_fold_weighted_rejects_bad_shapes_as_the_reference(cs, weights, why):
    n = (1 << 127) - 1
    with pytest.raises(ValueError):
        ref_fold_weighted(cs, weights, n)
    with pytest.raises(ValueError):
        fold_weighted(cs, weights, n, device="cpu")


def test_gather_columns_hold_each_cells_digits():
    """`_table_columns` against the reference's per-digit loop
    (`dds_tpu/ops/foldmany.py:226-230`): column k * Rp + r of digit row j
    is table column digit * P2 + k, pads on digit 0."""
    rng = np.random.default_rng(15)
    R, K, P2, Rp = 3, 5, 8, 4
    weights = [[int.from_bytes(rng.bytes(int(rng.integers(0, 9))), "little") for _ in range(K)]
               for _ in range(R)]
    weights[0][0] = (1 << 61) - 1  # the longest: E = 61, D = 16
    cols = foldmany._table_columns(weights, P2, Rp)
    D = 16
    digits = np.zeros((D, Rp, P2), np.int64)
    for r, row in enumerate(weights):
        for k, w in enumerate(row):
            for d in range(-(-w.bit_length() // 4)):
                digits[D - 1 - d, r, k] = (w >> (4 * d)) & 0xF
    want = digits.transpose(0, 2, 1) * P2 + np.arange(P2)[None, :, None]
    assert cols.shape == (D, P2 * Rp)
    assert np.array_equal(cols, want.reshape(D, P2 * Rp))
    assert foldmany._table_columns([[0, 0]], 2, 1).tolist() == [[0, 1]]  # D = 1


def test_ladder_calls_mul_as_often_as_the_formula(case, monkeypatch):
    """1 + 14 + D (4 + log2 P2 + 1) + 1 multiplies, every one in the
    family read once for the call: 56 at K = 5 (P2 = 8), D = 5."""
    n, cs, weights = case
    monkeypatch.setenv("DDS_KARATSUBA", "2")
    seen = []
    real = mont_cuda.mul

    def spy(ctx, a, b, karatsuba=None):
        seen.append(karatsuba)
        return real(ctx, a, b, karatsuba)

    monkeypatch.setattr(mont_cuda, "mul", spy)
    assert fold_weighted(cs, weights, n, device="cpu") == _python_rows(cs, weights, n)
    assert len(seen) == foldmany.fold_weighted_launches(5, 5) == 56
    assert set(seen) == {"fused"}
    assert foldmany.fold_weighted_launches(8192, 4) == 88
    assert foldmany.fold_weighted_launches(8192, 512) == 9232


def test_rows_from_the_device_skip_marshaling(case):
    """Operands given as (K, L) plain-domain rows (a resident pool's
    gather) fold to the same values; rows of another shape are ignored."""
    import torch

    from dds_tpu_torch.ops import bignum as bn

    n, cs, weights = case
    rows = bn.to_device(bn.ints_to_batch(cs, ModCtx.make(n).L), torch.device("cpu"))
    want = _python_rows(cs, weights, n)
    assert fold_weighted(cs, weights, n, device="cpu", rows=rows) == want
    assert fold_weighted(cs, weights, n, device="cpu", rows=rows[:4]) == want


# ------------------------------------------------------------------ encoding


def test_matvec_encode_and_host_matvec_as_the_reference():
    key = bench_paillier_key(512)
    ref_pk = RefPaillierKey(key.n, key.p, key.q).public
    pk = key.public
    n = pk.n
    W = [[3, -4, 0], [-(n - 1), n - 1, 1]]
    assert pk.matvec_encode(W) == ref_pk.matvec_encode(W) == [[3, n - 4, 0], [1, n - 1, 1]]
    for bad in ([[n]], [[-n]]):
        with pytest.raises(ValueError) as got:
            pk.matvec_encode(bad)
        with pytest.raises(ValueError) as want:
            ref_pk.matvec_encode(bad)
        assert str(got.value) == str(want.value)
    rng = np.random.default_rng(16)
    xs = [int(x) for x in rng.integers(0, 1 << 16, size=3)]
    cs = [pk.encrypt(x) for x in xs]
    W = [[2, -3, 1], [0, 0, 0]]
    out = pk.matvec(cs, pk.matvec_encode(W))
    assert out == ref_pk.matvec(cs, ref_pk.matvec_encode(W))
    assert [key.decrypt_signed(c) for c in out] == [
        sum(w * x for w, x in zip(row, xs)) for row in W]


@pytest.mark.parametrize("min_device_batch", [0, 12, 13, 10**6])
def test_backend_matvec_parity_across_the_crossover(monkeypatch, min_device_batch):
    """R x K = 12 cells: `CudaBackend(device="cpu")` folds on the device
    path from min_device_batch <= 12, the host loop above; both equal the
    reference's `cpu` backend, as does the port's `CpuBackend`."""
    key = bench_paillier_key(512)
    pk = key.public
    n2 = pk.nsquare
    rng = np.random.default_rng(17)
    cs = [pk.encrypt(int(x)) for x in rng.integers(0, 1 << 20, size=4)]
    enc = pk.matvec_encode([[int(w) for w in rng.integers(-9, 9, size=4)] for _ in range(3)])
    want = ref_get_backend("cpu").matvec(cs, enc, n2)
    calls = []
    real = foldmany.fold_weighted
    monkeypatch.setattr(foldmany, "fold_weighted",
                        lambda *a, **kw: calls.append(kw["device"]) or real(*a, **kw))
    assert CudaBackend(device="cpu", min_device_batch=min_device_batch).matvec(
        cs, enc, n2) == want
    assert len(calls) == (1 if min_device_batch <= 12 else 0)
    assert CpuBackend().matvec(cs, enc, n2) == want
    assert len(calls) == (1 if min_device_batch <= 12 else 0)


# ------------------------------------------------------------------ row cap


def test_analytics_max_rows_as_the_reference(monkeypatch):
    monkeypatch.delenv("DDS_ANALYTICS_MAX_ROWS", raising=False)
    assert flags.analytics_max_rows() == ref_flags.analytics_max_rows() == 256
    assert flags.analytics_max_rows(17) == 17
    monkeypatch.setenv("DDS_ANALYTICS_MAX_ROWS", "64")
    assert flags.analytics_max_rows(17) == ref_flags.analytics_max_rows(17) == 64
    for bad in ("zero", "0", "-3", "9999999", "65537"):
        monkeypatch.setenv("DDS_ANALYTICS_MAX_ROWS", bad)
        with pytest.raises(ValueError) as got:
            flags.analytics_max_rows()
        with pytest.raises(ValueError) as want:
            ref_flags.analytics_max_rows()
        assert str(got.value) == str(want.value) and "DDS_ANALYTICS_MAX_ROWS" in str(got.value)
    monkeypatch.setenv("DDS_ANALYTICS_MAX_ROWS", "65536")
    assert flags.analytics_max_rows() == 65536
    monkeypatch.delenv("DDS_ANALYTICS_MAX_ROWS", raising=False)
    for bad in (0, 70000, "x"):
        with pytest.raises(ValueError) as got:
            flags.analytics_max_rows(bad)
        assert "[analytics] max-rows" in str(got.value)
