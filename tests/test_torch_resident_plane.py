"""The port's resident plane and pools against `dds_tpu.resident`, on the CPU.

The same seeded operands go to the reference's `ResidentPlane` (its
portable `jnp` kernels) and `ResidentPool`, and to the port's on
`torch.device("cpu")` (the kernels' plain PyTorch versions, the way a
`CudaBackend(device="cpu")` builds them): the fused multi-group fold for
S = 1, 2 and 4 groups of unequal sizes in DDS_KARATSUBA modes 0, 1 and 2
at 512-bit moduli (L = 32) and once at Paillier-2048's n^2 (L = 256); the
launch count of a fused fold; the direct fallback's accounting; epoch and
memo across a reset; eviction waves (victims, survivors, spilled uint32
rows) and their race against concurrent folds; write ingest racing an
aggregate, and the first aggregate after a write ingesting nothing;
`no_pool` and `full` drops; `stats` keys, the `dds_resident_*` counters
and the exported gauges equal after the same sequence; `evict_tenant`.
Exact integer equality, no tolerance.
"""

import random
import sys
import threading

import numpy as np
import pytest
import torch

from dds_tpu.obs.metrics import Registry as RefRegistry
from dds_tpu.obs.metrics import metrics as ref_metrics
from dds_tpu.parallel.mesh import combine_partials as ref_combine
from dds_tpu.resident import ResidentPlane as RefPlane
from dds_tpu.resident import ResidentPool as RefPool
from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.models.backend import CudaBackend
from dds_tpu_torch.obs.metrics import Registry, metrics
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.parallel.mesh import combine_partials, group_sharding, mesh_fold_launches
from dds_tpu_torch.resident import ResidentPlane, ResidentPool

rng = random.Random(0x10DE)
MODULUS = rng.getrandbits(512) | (1 << 511) | 1  # L = 32


def pyfold(cs, n=MODULUS):
    acc = 1
    for c in cs:
        acc = acc * c % n
    return acc


def ciphers(seed, k, n=MODULUS):
    r = random.Random(seed)
    return [r.randrange(1, n) for _ in range(k)]


def port_plane(**kw):
    return ResidentPlane(device="cpu", **kw)


def counters(registry, names):
    """{(name, labels): value} of every counter series in `names`."""
    out = {}
    for line in registry.render().splitlines():
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        if series.split("{")[0] in names:
            out[series] = float(value)
    return out


def delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


RESIDENT_COUNTERS = ("dds_resident_resets_total", "dds_resident_evictions_total",
                     "dds_resident_ingest_total", "dds_ingest_h2d_bytes_total",
                     "dds_cipher_store_total", "dds_queue_dropped_total",
                     "dds_tenant_pool_evictions_total")


# ------------------------------------------------------------ the fused fold


@pytest.mark.parametrize("mode", ["0", "1", "2"])
@pytest.mark.parametrize("sizes", [[13], [5, 17], [1, 9, 4, 30]], ids=["S1", "S2", "S4"])
def test_fused_fold_equals_the_reference_plane(monkeypatch, mode, sizes):
    monkeypatch.setenv("DDS_KARATSUBA", mode)
    parts = [(f"s{g}", ciphers(100 * g + len(sizes), k)) for g, k in enumerate(sizes)]
    ref, port = RefPlane(kernel="jnp", initial_rows=8), port_plane(initial_rows=8)
    want = pyfold([c for _, ops in parts for c in ops])
    assert ref.fold_groups(parts, MODULUS) == want
    assert port.fold_groups(parts, MODULUS) == want
    assert port.fold_groups(parts, MODULUS) == want  # resident rows, row memos
    assert port.stats()["kernel"] == {"0": "cios", "1": "k1", "2": "fused"}[mode]
    assert [p["rows"] for p in port.stats()["pools"]] == \
        [p["rows"] for p in ref.stats()["pools"]]


def test_fused_fold_at_paillier_2048():
    n2 = bench_paillier_key(2048).nsquare  # L = 256
    parts = [("a", ciphers(1, 3, n2)), ("b", ciphers(2, 6, n2))]
    ref, port = RefPlane(kernel="jnp"), port_plane()
    want = pyfold(parts[0][1] + parts[1][1], n2)
    assert port.fold_groups(parts, n2) == ref.fold_groups(parts, n2) == want


@pytest.mark.parametrize("mode", ["0", "1", "2"])
def test_fused_fold_launches_one_multiply_per_level(monkeypatch, mode):
    """S = 4 groups of 2,048 (K = 8,192): 11 local levels, 2 tail levels
    and the fix, each one `mont_cuda.mul` over every group at once in the
    family read once for the fold; S lone folds would take 4 x 12."""
    monkeypatch.setenv("DDS_KARATSUBA", mode)
    calls = []
    real = mont_cuda.mul

    def counting(ctx, a, b, karatsuba=None):
        calls.append((a.shape[1], karatsuba))
        return real(ctx, a, b, karatsuba)

    monkeypatch.setattr(mont_cuda, "mul", counting)
    n = bench_paillier_key(512).nsquare  # L = 64
    parts = [(f"s{g}", ciphers(g, 2048, n)) for g in range(4)]
    plane = port_plane(max_rows=4096)
    assert plane.fold_groups(parts, n) == pyfold([c for _, o in parts for c in o], n)
    assert mesh_fold_launches([[2048] * 4]) == 14 == len(calls)
    assert [w for w, _ in calls] == [4096 >> i for i in range(13)] + [1]
    assert {m for _, m in calls} == {{"0": False, "1": "k1", "2": "fused"}[mode]}
    assert mont_cuda.fold_launches(2048) * 4 == 48
    assert mesh_fold_launches([[1]]) == 1 and mesh_fold_launches([[3, 1, 1]]) == 5


def test_lone_group_folds_run_the_backends_reduce():
    be = CudaBackend(device="cpu", min_device_batch=0)
    plane = be.resident_plane(initial_rows=4, max_rows=64)
    assert plane.device == torch.device("cpu") and plane.max_rows == 64
    cs = ciphers(7, 21)
    seen = []
    real = be.reduce_mul_device

    def spy(ctx, rows):
        seen.append(rows.shape)
        return real(ctx, rows)

    be.reduce_mul_device = spy
    assert plane.pool("g", MODULUS).fold(cs) == pyfold(cs)
    assert seen == [(21, 32)]
    assert group_sharding(plane.device, 3) == plane.device
    parts = [rng.randrange(MODULUS) for _ in range(7)]
    assert combine_partials(parts, MODULUS) == ref_combine(parts, MODULUS) == pyfold(parts)
    with pytest.raises(ValueError):
        combine_partials([], MODULUS)


# ------------------------------------------------------------------ pools


def test_direct_fallback_accounts_direct_not_resident():
    """An aggregate wider than max_rows resets the pool, then marshals
    every limb for a direct fold: it counts as outcome="direct" in both
    packages."""
    cs = ciphers(11, 12)
    got = {}
    for name, pool, reg in (
        ("ref", RefPool(MODULUS, initial_rows=4, max_rows=8, gid="sX"), ref_metrics),
        ("port", ResidentPool(MODULUS, initial_rows=4, max_rows=8, gid="sX", device="cpu"),
         metrics),
    ):
        before = counters(reg, RESIDENT_COUNTERS)
        assert pool.fold(cs) == pyfold(cs)
        got[name] = (delta(counters(reg, RESIDENT_COUNTERS), before), pool.hit_ratio())
    assert got["port"] == got["ref"]
    assert got["port"][0] == {'dds_cipher_store_total{outcome="direct"}': 12.0,
                              'dds_resident_resets_total{shard="sX"}': 1.0}
    assert got["port"][1] == 0.0


def test_epoch_and_memo_across_a_reset_as_the_reference():
    """A capacity reset invalidates row-index memos minted against the old
    placement: the SAME operand-list object folds right afterwards, and
    epoch, resets and the reset counter move as in the reference."""
    ref = RefPool(MODULUS, initial_rows=4, max_rows=8, gid="sE")
    port = ResidentPool(MODULUS, initial_rows=4, max_rows=8, gid="sE", device="cpu")
    cs, flood = ciphers(20, 4), ciphers(21, 7)
    trace = {}
    for name, pool, reg in (("ref", ref, ref_metrics), ("port", port, metrics)):
        before = counters(reg, RESIDENT_COUNTERS)
        steps = []
        for ops in (cs, flood, cs):
            assert pool.fold(ops) == pyfold(ops)
            steps.append((pool.epoch, pool.resets, pool.resident, pool.capacity,
                          pool._idx_memo[1]))
        assert pool._idx_memo[0] is cs
        trace[name] = (steps, delta(counters(reg, RESIDENT_COUNTERS), before))
    assert trace["port"] == trace["ref"]
    assert trace["port"][0][-1][:2] == (2, 2)
    assert port.stats()["last_reset_age_s"] is not None


def _sink_pools(max_rows=16, rank=None):
    """A reference and a port pool, each spilling into its own list."""
    out = []
    for cls, kw in ((RefPool, {}), (ResidentPool, {"device": "cpu"})):
        spilled = []
        pool = cls(MODULUS, initial_rows=4, max_rows=max_rows, gid="gV",
                   spill=spilled.append, evict_rank=rank, **kw)
        out.append((pool, spilled))
    return out


@pytest.mark.parametrize("ranked", [False, True], ids=["fifo", "ranked"])
def test_eviction_waves_spill_the_reference_rows(ranked):
    """Past max_rows with a tier sink: the same victims (FIFO, or the
    sink's coldest-first rank), survivors compacted in index order, the
    spilled rows equal host uint32 arrays, epoch bumped, no reset, and the
    operands being ensured never evicted."""
    rank = (lambda cs: sorted(cs, key=lambda c: c % 97)) if ranked else None
    (ref, ref_spill), (port, port_spill) = _sink_pools(rank=rank)
    waves = [ciphers(30 + i, 6) for i in range(8)]
    for ops in waves:
        for pool in (ref, port):
            pool.ingest(ops)
            assert pool.rows_for(ops) is not None
            assert all(c in pool._index for c in ops)  # protected, resident
    assert list(port._index.items()) == list(ref._index.items())
    assert (port.epoch, port.resets, port.resident, port.capacity) == \
        (ref.epoch, ref.resets, ref.resident, ref.capacity)
    assert port.resets == 0 and port.epoch > 0
    assert len(port_spill) == len(ref_spill) > 1
    for pb, rb in zip(port_spill, ref_spill):
        assert [c for c, _ in pb] == [c for c, _ in rb]
        for (_, prow), (_, rrow) in zip(pb, rb):
            assert prow.dtype == np.uint32 and prow.shape == (32,)
            np.testing.assert_array_equal(prow, rrow)
    # the device buffer holds the survivors' limbs in index order
    from dds_tpu_torch.ops import bignum as bn

    survivors = sorted(port._index, key=port._index.get)
    np.testing.assert_array_equal(bn.to_host(port._buf[: port.resident]),
                                  bn.ints_to_batch(survivors, 32))
    np.testing.assert_array_equal(bn.to_host(port._buf[: port.resident]),
                                  np.asarray(ref._buf[: ref.resident]))


def test_eviction_racing_concurrent_folds():
    """Folds on worker threads racing eviction waves (a sink wired, so
    overflow evicts instead of resetting) always return the right product
    and never deadlock; the buffer swaps never corrupt an enqueued
    gather."""
    spilled = []
    pool = ResidentPool(MODULUS, initial_rows=4, max_rows=16, device="cpu",
                        spill=spilled.append)
    stable = ciphers(40, 5)
    expect = pyfold(stable)
    errors = []

    def folder():
        for _ in range(12):
            try:
                if pool.fold(stable) != expect:
                    errors.append("wrong fold result")
            except Exception as e:  # surfaced below
                errors.append(repr(e))

    def flooder(seed):
        r = random.Random(seed)
        for _ in range(12):
            flood = [r.randrange(1, MODULUS) for _ in range(11)]
            try:
                if pool.fold(flood) != pyfold(flood):
                    errors.append("wrong flood result")
            except Exception as e:  # surfaced below
                errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=folder) for _ in range(3)] + [
            threading.Thread(target=flooder, args=(i,)) for i in range(3)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads), "fold/eviction race deadlocked"
    assert not errors, errors
    assert pool.resets == 0 and spilled  # the race really crossed eviction waves
    assert pool.resident <= 16


# ---------------------------------------------------------- write ingest


def test_write_ingest_racing_an_aggregate():
    """Write-path ingest racing a fused fold over the same ciphertexts:
    content addressing means both sides converge on identical rows — the
    result stays the host fold, nothing deadlocks."""
    plane = port_plane(initial_rows=8, max_rows=256)
    parts = [(f"s{i}", ciphers(50 + i, 6)) for i in range(3)]
    expect = pyfold([c for _, ops in parts for c in ops])
    assert plane.fold_groups(parts[:1], MODULUS) == pyfold(parts[0][1])
    errors = []

    def writer():
        for _ in range(10):
            for gid, ops in parts:
                plane.note_write(gid, list(ops))
            plane.ingest_pending()

    def folder():
        for _ in range(10):
            try:
                if plane.fold_groups(parts, MODULUS) != expect:
                    errors.append("fused fold diverged under ingest race")
            except Exception as e:  # surfaced below
                errors.append(repr(e))

    threads = [threading.Thread(target=writer), threading.Thread(target=folder),
               threading.Thread(target=folder)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "ingest/fold race deadlocked"
    assert not errors, errors
    assert plane.stats()["resets"] == 0


def test_first_aggregate_after_a_write_ingests_nothing():
    """Once a pool exists, `note_write` + `ingest_pending` place the new
    rows, and the next fold over old and new operands ingests 0 rows on
    the fold path — with the reference's counters and stats."""
    old, new = ciphers(60, 9), ciphers(61, 5)
    got = {}
    for name, plane, reg in (("ref", RefPlane(kernel="jnp", initial_rows=4), ref_metrics),
                             ("port", port_plane(initial_rows=4), metrics)):
        before = counters(reg, RESIDENT_COUNTERS)
        assert plane.fold_groups([("gW", old)], MODULUS) == pyfold(old)
        assert plane.note_write("gW", new + old[:2]) == 7
        assert plane.pending_ingest() == 7
        assert plane.ingest_pending() == 5 and plane.pending_ingest() == 0
        served = list(plane.pool("gW", MODULUS)._served)
        assert plane.fold_groups([("gW", old + new)], MODULUS) == pyfold(old + new)
        after = plane.pool("gW", MODULUS)._served
        assert after[1] == served[1]  # nothing ingested on the fold path
        got[name] = (after, delta(counters(reg, RESIDENT_COUNTERS), before))
    assert got["port"] == got["ref"]
    assert got["port"][1]['dds_resident_ingest_total{path="write",shard="gW"}'] == 5.0


def test_no_pool_and_full_drops_as_the_reference():
    got = {}
    for name, plane, reg in (("ref", RefPlane(kernel="jnp", max_pending=4), ref_metrics),
                             ("port", port_plane(max_pending=4), metrics)):
        before = counters(reg, RESIDENT_COUNTERS)
        assert plane.note_write("gD", ciphers(70, 3)) == 0  # no pool yet
        plane.pool("gD", MODULUS)
        assert plane.note_write("gD", ciphers(71, 6)) == 4  # 2 rejected: full
        assert plane.note_write("gD", []) == 0
        got[name] = (plane.stats()["dropped_pending"], plane._pending.stats(),
                     delta(counters(reg, RESIDENT_COUNTERS), before))
    assert got["port"] == got["ref"]
    assert got["port"][1]["dropped"] == {"no_pool": 3, "full": 2}


# ------------------------------------------------------- surface and tenancy


def _sequence(plane, reg):
    """Pools in two groups and two tenant stripes, two resets (the second
    before a direct fallback), an ingest, a queued write; returns the
    counter deltas."""
    before = counters(reg, RESIDENT_COUNTERS)
    a, b = ciphers(80, 10), ciphers(81, 6)
    assert plane.fold_groups([("s0", a), ("s1", b)], MODULUS) == pyfold(a + b)
    assert plane.fold_groups([("s0", a)], MODULUS) == pyfold(a)
    assert plane.fold_groups([("s0", ciphers(82, 9))], MODULUS) == pyfold(ciphers(82, 9))
    assert plane.fold_groups([("s0", ciphers(83, 20))], MODULUS) is None  # > max_rows
    plane.pool("s1", MODULUS).ingest(ciphers(84, 3))
    t = ciphers(85, 5)
    assert plane.fold_groups([("s0", t)], MODULUS, tenant="acme") == pyfold(t)
    plane.note_write("s1", ciphers(86, 2))
    return delta(counters(reg, RESIDENT_COUNTERS), before)


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_stats_counters_and_gauges_equal_the_reference():
    ref, port = RefPlane(kernel="jnp", initial_rows=4, max_rows=16), \
        port_plane(initial_rows=4, max_rows=16)
    assert _sequence(port, metrics) == _sequence(ref, ref_metrics)
    rs, ps = ref.stats(), port.stats()
    assert _keys(ps) == _keys(rs)
    assert [_keys(p) for p in ps["pools"]] == [_keys(p) for p in rs["pools"]]
    for k in rs:
        if k not in ("kernel", "pools", "last_reset_age_s"):
            assert ps[k] == rs[k], k
    for pp, rp in zip(ps["pools"], rs["pools"]):
        assert {k: v for k, v in pp.items() if k != "last_reset_age_s"} == \
            {k: v for k, v in rp.items() if k != "last_reset_age_s"}
    assert ps["resets"] == 2 and ps["pending_ingest"] == 2
    assert port.ingest_pending() == ref.ingest_pending() == 2  # the queue's age: 0
    ref_reg, port_reg = RefRegistry(), Registry()
    ref.export_gauges(ref_reg)
    port.export_gauges(port_reg)
    assert port_reg.render() == ref_reg.render()
    assert 'dds_resident_rows{shard="s0"}' in port_reg.render()


def test_evict_tenant_drops_only_that_stripe():
    got = {}
    for name, plane, reg in (("ref", RefPlane(kernel="jnp", initial_rows=4, max_rows=8),
                              ref_metrics),
                             ("port", port_plane(initial_rows=4, max_rows=8), metrics)):
        before = counters(reg, RESIDENT_COUNTERS)
        a, b = ciphers(90, 6), ciphers(91, 6)
        plane.fold_groups([("g", a)], MODULUS, tenant="a")
        plane.fold_groups([("g", b)], MODULUS, tenant="b")
        # tenant a overflowing its pool resets a's stripe, never b's
        plane.fold_groups([("g", ciphers(92, 5))], MODULUS, tenant="a")
        resets = {t: plane.pool("g", MODULUS, tenant=t).resets for t in ("a", "b")}
        dropped = plane.evict_tenant("a")
        left = sorted(k[1] for k in plane._pools)
        got[name] = (resets, dropped, left, plane.evict_tenant("zz"),
                     delta(counters(reg, RESIDENT_COUNTERS), before))
    assert got["port"] == got["ref"]
    assert got["port"][:4] == ({"a": 1, "b": 0}, 1, ["b"], 0)
