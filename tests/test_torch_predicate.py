"""The port's predicate ops against the reference's, on JAX CPU.

`dds_tpu_torch/ops/predicate.py` (int64 lane tensors, PyTorch ops on the
CPU here) against `dds_tpu/ops/predicate.py` (uint32 lanes, jitted XLA on
JAX CPU) over the same seeded numpy inputs at N = 1, 37 and 4,096: the
packs' lanes, `compare_mask` in each op, `range_mask`, `eq_mask`,
`entry_mask` in both modes and `sort_perm` in both directions must be
identical. The inputs hold ties, the lane boundaries 0, LANE_MASK,
LANE_MASK + 1 and PACK_MAX, rows whose high lane equals the threshold's,
repeated and absent digests, padded element rows and an empty query list.
"""

import numpy as np
import pytest
import torch

from dds_tpu.ops import predicate as ref
from dds_tpu_torch.ops import predicate as port
from dds_tpu_torch.utils.trace import tracer

SIZES = (1, 37, 4096)
EDGES = [0, port.LANE_MASK, port.LANE_MASK + 1, port.PACK_MAX]
CPU = torch.device("cpu")


def ope_values(n: int, seed: int) -> list[int]:
    """Packable values: the lane edges, then half uniform draws and half
    draws from a small pool (ties)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, port.PACK_MAX + 1, size=max(1, n // 8))
    vals = np.where(rng.random(n) < 0.5,
                    rng.integers(0, port.PACK_MAX + 1, size=n), rng.choice(pool, size=n))
    out = [int(v) for v in vals]
    out[:min(n, len(EDGES))] = EDGES[:n]
    return out


def thresholds(vals: list[int], seed: int) -> list[int]:
    """The lane edges, stored values (ties at the threshold), and values
    sharing a stored value's high lane with another low lane (hi == thi)."""
    rng = np.random.default_rng(seed)
    picks = [vals[int(i)] for i in rng.integers(0, len(vals), size=4)]
    same_hi = [(v >> port.LANE_BITS << port.LANE_BITS) | int(rng.integers(0, port.LANE_MASK + 1))
               for v in picks]
    return EDGES + picks + same_hi + [1, port.PACK_MAX - 1]


def words(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [f"w{int(x)}" for x in rng.integers(0, max(2, n // 4), size=n)]


def lanes_equal(t: torch.Tensor, a: np.ndarray) -> bool:
    return t.dtype == torch.int64 and t.tolist() == a.astype(np.int64).tolist()


@pytest.mark.parametrize("n", SIZES)
def test_packs_hold_the_reference_lanes(n):
    vals = ope_values(n, n)
    (hi, lo), (rhi, rlo) = port.pack_ints(vals), ref.pack_ints(vals)
    assert lanes_equal(hi, rhi) and lanes_equal(lo, rlo)
    assert ((hi << port.LANE_BITS) | lo).tolist() == vals
    ws = words(n, n + 1)
    (dhi, dlo), (rdhi, rdlo) = port.pack_digests(ws), ref.pack_digests(ws)
    assert lanes_equal(dhi, rdhi) and lanes_equal(dlo, rdlo)
    assert [port.digest_lanes(w) for w in ws[:5]] == [ref.digest_lanes(w) for w in ws[:5]]
    assert [port.packable(v) for v in (-1, 0, port.PACK_MAX, port.PACK_MAX + 1)] == \
        [ref.packable(v) for v in (-1, 0, ref.PACK_MAX, ref.PACK_MAX + 1)] == \
        [False, True, True, False]
    assert (port.LANE_BITS, port.LANE_MASK, port.PACK_MAX) == \
        (ref.LANE_BITS, ref.LANE_MASK, ref.PACK_MAX)


@pytest.mark.parametrize("op", ("gt", "ge", "lt", "le"))
@pytest.mark.parametrize("n", SIZES)
def test_compare_mask_equals_the_reference(n, op):
    vals = ope_values(n, 10 + n)
    hi, lo = port.pack_ints(vals)
    rhi, rlo = ref.pack_ints(vals)
    host = {"gt": int.__gt__, "ge": int.__ge__, "lt": int.__lt__, "le": int.__le__}[op]
    for t in thresholds(vals, n):
        got = port.compare_mask(hi, lo, op, t, device=CPU)
        assert got.dtype == torch.bool and got.device == CPU
        assert got.tolist() == ref.compare_mask(rhi, rlo, op, t).tolist(), t
        assert got.tolist() == [host(v, t) for v in vals], t


@pytest.mark.parametrize("n", SIZES)
def test_range_mask_equals_the_reference(n):
    vals = ope_values(n, 20 + n)
    hi, lo = port.pack_ints(vals)
    rhi, rlo = ref.pack_ints(vals)
    ts = sorted(thresholds(vals, n + 3))
    for a, b in zip(ts, ts[3:] + ts[:3]):
        got = port.range_mask(hi, lo, a, b, device=CPU).tolist()
        assert got == ref.range_mask(rhi, rlo, a, b).tolist(), (a, b)
        assert got == [a <= v <= b for v in vals]


@pytest.mark.parametrize("n", SIZES)
def test_eq_mask_equals_the_reference(n):
    ws = words(n, 30 + n)
    dhi, dlo = port.pack_digests(ws)
    rdhi, rdlo = ref.pack_digests(ws)
    for q in ws[:3] + ["absent", ""]:
        got = port.eq_mask(dhi, dlo, q, device=CPU).tolist()
        assert got == ref.eq_mask(rdhi, rdlo, q).tolist(), q
        assert got == [w == q for w in ws]


def element_matrix(n: int, seed: int, width: int = 5):
    """(N, C) digest lanes of padded element rows and their validity."""
    rng = np.random.default_rng(seed)
    rows = [[f"e{int(x)}" for x in rng.integers(0, 12, size=int(rng.integers(0, width + 1)))]
            for _ in range(n)]
    dhi = np.zeros((n, width), np.uint32)
    dlo = np.zeros((n, width), np.uint32)
    valid = np.zeros((n, width), bool)
    for i, r in enumerate(rows):
        for j, s in enumerate(r):
            dhi[i, j], dlo[i, j] = ref.digest_lanes(s)
            valid[i, j] = True
    return rows, dhi, dlo, valid


@pytest.mark.parametrize("mode", ("any", "all"))
@pytest.mark.parametrize("n", SIZES)
def test_entry_mask_equals_the_reference(n, mode):
    rows, dhi, dlo, valid = element_matrix(n, 40 + n)
    t = [torch.from_numpy(a.astype(np.int64)) for a in (dhi, dlo)] + [torch.from_numpy(valid)]
    for queries in (["e3"], ["e1", "e5", "nowhere"], ["e2", "e2", "e7"], []):
        got = port.entry_mask(*t, queries, mode, device=CPU).tolist()
        assert got == ref.entry_mask(dhi, dlo, valid, queries, mode).tolist(), queries
        agg = all if mode == "all" else any
        assert got == [agg(q in r for q in queries) for r in rows]


@pytest.mark.parametrize("descending", (False, True))
@pytest.mark.parametrize("n", SIZES)
def test_sort_perm_equals_the_reference_ties_in_row_order(n, descending):
    vals = ope_values(n, 50 + n)
    hi, lo = port.pack_ints(vals)
    got = port.sort_perm(hi, lo, descending, device=CPU).tolist()
    assert got == ref.sort_perm(*ref.pack_ints(vals), descending).tolist()
    # Python's stable sorted(..., reverse=...) keeps ties in row order
    assert got == sorted(range(n), key=vals.__getitem__, reverse=descending)


def test_ops_record_the_reference_span_names():
    vals = ope_values(37, 7)
    hi, lo = port.pack_ints(vals)
    tracer.reset()
    port.compare_mask(hi, lo, "gt", 5, device=CPU)
    port.sort_perm(hi, lo, True, device=CPU)
    spans = tracer.summary()
    assert spans["kernel.predicate.dispatch"]["count"] == 2
    assert spans["kernel.predicate.execute"]["count"] == 2
    with pytest.raises(ValueError, match="compare op"):
        port.compare_mask(hi, lo, "eq", 5, device=CPU)
