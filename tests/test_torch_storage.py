"""The port's Stratum (tiered storage) against `dds_tpu.storage`, on the CPU.

The segment store: round trip, corrupt and truncated files quarantined to
`*.corrupt`, a wrong secret, keep-N manifests that never strand a live
segment, orphan adoption after a crash between segment and manifest,
discard-then-compact — and a segment log written by either package
loading in the other (the on-disk format is the reference's). Then the
tiers over a resident plane on `torch.device("cpu")`, against the
reference's `Stratum` over its portable plane fed the same operands:
eviction to warm freezing `resets` and protecting the operands in flight;
tiered folds at 10x pool capacity, multi-group and empty, bit for bit an
all-resident twin's answers and the reference's; Zipf-head promotion back
to hot; a restart (of either package) reloading the cold tier; equal
`stats`, tier contents, `dds_tier_*` counters and gauges after the same
sequence; the directory's decay order, the warm budget, `pressure` and
`touch_keys`. Exact integer equality, no tolerance.

The tier directory's scores decay with `time.monotonic`. Where the tests
compare which rows sit in which tier across the packages, each package's
directory reads its own stepped clock (`clocks`): the same sequence of
touches then gives the same scores in both, whatever the runs' timings.
"""

import json
import random
import shutil

import numpy as np
import pytest

import dds_tpu.storage.directory as ref_directory
import dds_tpu_torch.storage.directory as port_directory
from dds_tpu.core.snapshot import derive_secret as ref_derive_secret
from dds_tpu.obs.metrics import Registry as RefRegistry
from dds_tpu.obs.metrics import metrics as ref_metrics
from dds_tpu.resident import ResidentPlane as RefPlane
from dds_tpu.storage import SegmentStore as RefSegmentStore
from dds_tpu.storage import Stratum as RefStratum
from dds_tpu.storage import derive_segment_secret as ref_segment_secret
from dds_tpu_torch.core.snapshot import derive_secret, read_authenticated
from dds_tpu_torch.obs.metrics import Registry, metrics
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.resident import ResidentPlane
from dds_tpu_torch.storage import (
    COLD,
    HOT,
    SegmentStore,
    Stratum,
    TierDirectory,
    WarmCache,
    derive_segment_secret,
)

rng = random.Random(0x57A7)
MODULUS = rng.getrandbits(512) | (1 << 511) | 1
L = 32  # 512-bit modulus at 16-bit limbs

TIER_COUNTERS = ("dds_tier_evictions_total", "dds_tier_hits_total",
                 "dds_tier_promotions_total", "dds_tier_cold_reads_total",
                 "dds_resident_evictions_total", "dds_resident_resets_total",
                 "dds_segment_verify_failures_total", "dds_segment_compactions_total")


class SteppedClock:
    """`time.monotonic` stand-in: 1 ms later at every reading."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self) -> float:
        self.t += 1e-3
        return self.t


@pytest.fixture
def clocks(monkeypatch):
    for module in (ref_directory, port_directory):
        monkeypatch.setattr(module, "time", SteppedClock())


def pyfold(cs, n=MODULUS):
    acc = 1
    for c in cs:
        acc = acc * c % n
    return acc


def stripe(gid="g0", tenant="", modulus=MODULUS):
    return (gid, tenant, modulus)


def population(k, seed=1):
    r = random.Random(seed)
    return [r.randrange(2, MODULUS) for _ in range(k)]


def counters(registry, names=TIER_COUNTERS):
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


def port_stratum(tmp, max_rows=16, initial_rows=4, **kw):
    plane = ResidentPlane(device="cpu", initial_rows=initial_rows, max_rows=max_rows)
    return plane, Stratum(plane, tmp, **kw)


def ref_stratum(tmp, max_rows=16, initial_rows=4, **kw):
    plane = RefPlane(kernel="jnp", initial_rows=initial_rows, max_rows=max_rows)
    return plane, RefStratum(plane, tmp, **kw)


def tiers_of(plane, stratum, st):
    """(hot rows in index order, warm ciphers, cold ciphers) of a stripe."""
    pool = plane.pool(st[0], st[2], st[1])
    warm = sorted(c for s, c, _ in stratum.warm.items() if s == st)
    return list(pool._index), warm, sorted(stratum.cold.entries().get(st, ()))


# ------------------------------------------------------------ segment store


def test_segment_append_read_roundtrip(tmp_path):
    store = SegmentStore(tmp_path, secret=b"seg-test")
    cs = population(12)
    assert store.append({stripe(): cs}) == 1
    assert all(store.contains(stripe(), c) for c in cs)
    assert not store.contains(stripe(), 999999999)
    want = [cs[3], cs[0], cs[3]]  # duplicates + order
    rows = store.read_rows(stripe(), want, L)
    np.testing.assert_array_equal(rows, bn.ints_to_batch(want, L))
    assert rows.dtype == np.uint32
    s = store.stats()
    assert (s["rows"], s["segments"], s["generation"], s["quarantined"]) == (12, 1, 1, 0)
    with pytest.raises(KeyError):
        store.read_rows(stripe(), [424242], L)
    assert store.append({stripe(): []}) is None


def test_segment_corrupt_and_truncated_quarantine_as_the_reference(tmp_path):
    """One flipped byte or a truncated tail quarantines that file to
    `*.corrupt`; boot indexes the survivors and never raises — in both
    packages, on copies of the same directory."""
    store = SegmentStore(tmp_path / "src", secret=b"seg-test")
    keep, a, b = population(4, seed=9), population(6), population(6, seed=2)
    store.append({stripe(): keep})
    store.append({stripe(): a})
    store.append({stripe("g1"): b})
    segs = sorted((tmp_path / "src").glob("stratum.segment.*.log"))
    raw = segs[1].read_bytes()
    segs[1].write_bytes(raw[:20] + b"X" + raw[21:])
    raw = segs[2].read_bytes()
    segs[2].write_bytes(raw[: len(raw) // 2])
    got = {}
    for name, cls, reg in (("port", SegmentStore, metrics), ("ref", RefSegmentStore, ref_metrics)):
        d = tmp_path / name
        shutil.copytree(tmp_path / "src", d)
        before = counters(reg)
        fresh = cls(d, secret=b"seg-test")
        got[name] = (fresh.load(), fresh.stats()["quarantined"], fresh.entries(),
                     sorted(p.name for p in d.glob("*.corrupt")),
                     sorted(p.name for p in d.glob("stratum.segment.*.log")),
                     delta(counters(reg), before))
    assert got["port"] == got["ref"]
    assert got["port"][:3] == (4, 2, {stripe(): keep})
    assert got["port"][5] == {"dds_segment_verify_failures_total": 2.0}


def test_segment_wrong_secret_never_verifies(tmp_path):
    store = SegmentStore(tmp_path, secret=b"seg-A")
    store.append({stripe(): population(4)})
    other = SegmentStore(tmp_path, secret=b"seg-B")
    assert other.load() == 0
    assert other.stats()["quarantined"] >= 1
    assert derive_secret(b"base", None) != derive_segment_secret(b"base")
    # the same derivations as the reference: each package verifies the other's files
    assert derive_segment_secret() == ref_segment_secret()
    assert derive_secret(b"base", None) == ref_derive_secret(b"base", None)


def test_manifest_keep_n_never_strands_live_segments(tmp_path):
    store = SegmentStore(tmp_path, secret=b"seg-test", keep=2, compact_segments=4)
    waves = [population(5, seed=s) for s in range(10)]
    for i, wave in enumerate(waves):
        store.append({stripe(f"g{i % 3}"): wave})
    manifests = sorted(tmp_path.glob("stratum.manifest.*.json"))
    assert 0 < len(manifests) <= 2
    body = json.loads(read_authenticated(manifests[-1], store._secret).decode())
    on_disk = {p.name for p in tmp_path.glob("stratum.segment.*.log")}
    assert store.stats()["compactions"] >= 1
    assert on_disk == set(body["segments"])
    fresh = SegmentStore(tmp_path, secret=b"seg-test")
    assert fresh.load() == sum(len(w) for w in waves)
    for i, wave in enumerate(waves):
        assert all(fresh.contains(stripe(f"g{i % 3}"), c) for c in wave)


def test_crash_mid_demotion_adopts_orphan_segments(tmp_path):
    store = SegmentStore(tmp_path, secret=b"seg-test")
    store.append({stripe(): population(4)})
    orphan = population(5, seed=9)
    store._write_segment(2, {stripe(): orphan})  # the crash: no manifest
    fresh = SegmentStore(tmp_path, secret=b"seg-test")
    assert fresh.load() == 9
    assert all(fresh.contains(stripe(), c) for c in orphan)
    newest = sorted(tmp_path.glob("stratum.manifest.*.json"))[-1]
    body = json.loads(read_authenticated(newest, store._secret).decode())
    assert "stratum.segment.00000002.log" in body["segments"]


def test_discard_then_compact_reclaims_bytes(tmp_path):
    store = SegmentStore(tmp_path, secret=b"seg-test")
    cs = population(8)
    store.append({stripe(): cs})
    assert store.discard(stripe(), cs[:5]) == 5
    assert store.discard(stripe("nope"), cs) == 0
    store.compact()
    assert store.stats()["rows"] == 3
    fresh = SegmentStore(tmp_path, secret=b"seg-test")
    fresh.load()
    assert sorted(fresh.entries()[stripe()]) == sorted(cs[5:])
    assert not any(fresh.contains(stripe(), c) for c in cs[:5])


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_segment_logs_cross_load_between_packages(tmp_path, writer):
    """A log written by one package (two waves, a discard, a compaction,
    then one more wave; the manifests of both generations) loads in the
    other: the same entries, the same rows, and a compaction there keeps
    them."""
    classes = {"ref": RefSegmentStore, "port": SegmentStore}
    reader = "port" if writer == "ref" else "ref"
    w = classes[writer](tmp_path, secret=b"seg-x", keep=2)
    a, b, c = population(7, seed=1), population(5, seed=2), population(4, seed=3)
    w.append({stripe(): a, stripe("g1", "acme"): b})
    w.append({stripe(): c})
    w.discard(stripe(), a[:2])
    w.compact()
    w.append({stripe("g2"): a[:2]})
    r = classes[reader](tmp_path, secret=b"seg-x", keep=2)
    assert r.load() == w.stats()["rows"] == 16
    assert {s: sorted(v) for s, v in r.entries().items()} == \
        {s: sorted(v) for s, v in w.entries().items()}
    assert r.stats()["quarantined"] == 0
    want = [c[0], a[3], c[0]]
    np.testing.assert_array_equal(r.read_rows(stripe(), want, L),
                                  w.read_rows(stripe(), want, L))
    r.compact()  # the reader rewrites the log; the writer's package reads it back
    back = classes[writer](tmp_path, secret=b"seg-x")
    assert back.load() == 16 and back.stats()["segments"] == 1


# ---------------------------------------------------------- eviction to warm


def test_eviction_to_warm_freezes_reset_counter(tmp_path, clocks):
    """Driving 10x max_rows through a pool with Stratum attached never
    resets it: overflow demotes coldest-first into warm and cold, every
    ingested row sits in some tier, and the tiers, spilled rows and
    counters equal the reference's."""
    pop = population(160)
    st = stripe("gE")
    got = {}
    for name, build, reg in (("port", port_stratum, metrics), ("ref", ref_stratum, ref_metrics)):
        plane, stratum = build(tmp_path / name, warm_bytes=2048, chunk_rows=8)
        before = counters(reg)
        for i in range(0, len(pop), 8):  # write-path style batched ingest
            plane.pool("gE", MODULUS).ingest(pop[i: i + 8])
        pool = plane.pool("gE", MODULUS)
        assert pool.resets == 0 and pool.resident <= 16
        hot, warm, cold = tiers_of(plane, stratum, st)
        assert set(hot) | set(warm) | set(cold) == set(pop)
        warm_rows = {c: stratum.warm.get(st, c) for c in warm}
        got[name] = (hot, warm, cold, stratum.stats()["evictions"], stratum.dir.counts(),
                     delta(counters(reg), before), warm_rows)
    for i in range(6):
        assert got["port"][i] == got["ref"][i], i
    assert got["port"][5]['dds_resident_evictions_total{shard="gE"}'] > 0
    for c, row in got["port"][6].items():  # spilled rows: host uint32 limbs
        assert row.dtype == np.uint32
        np.testing.assert_array_equal(row, got["ref"][6][c])
        np.testing.assert_array_equal(row, bn.int_to_limbs(c, L))


def test_eviction_protects_inflight_operands(tmp_path):
    plane, _ = port_stratum(tmp_path, warm_bytes=4096)
    pool = plane.pool("gP", MODULUS)
    pool.ingest(population(16, seed=3))  # fill to the brim
    cs = population(12, seed=4)
    rows = pool.rows_for(cs)
    assert rows is not None and tuple(rows.shape) == (12, L)
    np.testing.assert_array_equal(bn.to_host(rows), bn.ints_to_batch(cs, L))
    assert all(c in pool._index for c in cs)
    assert pool.resets == 0
    assert plane.stats()["tiered"] is True


# ----------------------------------------------------------- the planner


def test_tiered_fold_bit_for_bit_at_10x_capacity(tmp_path, clocks):
    """One group holds 10x the pool's max_rows; folds (full population,
    resident head, cold tail with duplicates, a cross-tier mix) equal an
    all-resident twin's answers and the reference Stratum's, with no
    reset, the same hits, evictions, promotions and tier contents, and the
    same `dds_tier_*` counters."""
    pop = population(160, seed=7)
    cases = [pop, pop[:10], pop[150:] * 3, pop[::13] + pop[:3]]
    twin = ResidentPlane(device="cpu", initial_rows=4, max_rows=1 << 14)
    got = {}
    for name, build, reg in (("port", port_stratum, metrics), ("ref", ref_stratum, ref_metrics)):
        plane, stratum = build(tmp_path / name, warm_bytes=1024, chunk_rows=8)
        before = counters(reg)
        for ops in cases:
            want = twin.fold_groups([("gF", ops)], MODULUS)
            assert want == pyfold(ops)
            assert stratum.fold_groups([("gF", ops)], MODULUS) == want
        assert plane.pool("gF", MODULUS).resets == 0
        s = stratum.stats()
        got[name] = ({k: s[k] for k in ("hits", "evictions", "cold_reads", "promotions",
                                        "demotions", "directory", "pressure")},
                     s["tiers"]["warm"], s["tiers"]["cold"]["rows"],
                     tiers_of(plane, stratum, stripe("gF")),
                     delta(counters(reg), before))
    assert got["port"] == got["ref"]
    stats = got["port"][0]
    assert stats["hits"]["warm"] + stats["hits"]["cold"] > 0 and got["port"][2] > 0


def test_streamed_legs_fold_through_the_kernel_wrapper(tmp_path, monkeypatch):
    """The warm, cold and direct legs fold in `chunk_rows` slices through
    `mont_cuda.reduce_mul` on the plane's device."""
    seen = []
    real = mont_cuda.reduce_mul

    def spy(ctx, rows, karatsuba=None):
        seen.append((rows.device.type, rows.shape[0]))
        return real(ctx, rows, karatsuba)

    monkeypatch.setattr(mont_cuda, "reduce_mul", spy)
    plane, stratum = port_stratum(tmp_path, warm_bytes=1024, chunk_rows=8)
    pop = population(40, seed=12)
    assert stratum.fold_groups([("gL", pop)], MODULUS) == pyfold(pop)
    # 16 fresh operands admit hot; the 24 past the pool's room stream
    assert seen == [("cpu", 8)] * 3
    assert stratum.fold_groups([("gL", pop)], MODULUS) == pyfold(pop)
    assert len(seen) > 3 and all(d == "cpu" and k <= 8 for d, k in seen)


def test_tiered_fold_multi_group_and_empty(tmp_path, clocks):
    parts = [(f"s{i}", population(40, seed=20 + i)) for i in range(3)]
    twin = ResidentPlane(device="cpu", initial_rows=4, max_rows=1 << 14)
    want = twin.fold_groups(parts, MODULUS)
    assert want == pyfold([c for _, o in parts for c in o])
    got = {}
    for name, build in (("port", port_stratum), ("ref", ref_stratum)):
        plane, stratum = build(tmp_path / name, max_rows=8, warm_bytes=512, chunk_rows=4)
        assert stratum.fold_groups(parts, MODULUS) == want
        assert stratum.fold_groups(parts, MODULUS) == want
        assert stratum.fold_groups([], MODULUS) == 1 % MODULUS
        assert stratum.fold_groups([("s0", [])], MODULUS) == 1 % MODULUS
        got[name] = [tiers_of(plane, stratum, stripe(g)) for g, _ in parts]
    assert got["port"] == got["ref"]


def test_zipf_head_promotes_back_to_hot(tmp_path):
    """Repeated folds over a tiered subset clear the promote-score bar and
    re-enter the device: later folds serve them as hot hits."""
    plane, stratum = port_stratum(tmp_path, warm_bytes=1024, chunk_rows=8,
                                  promote_score=2.0)
    pop = population(160, seed=8)
    stratum.fold_groups([("gZ", pop)], MODULUS)  # tier the population
    tail = pop[120:132]  # lives in warm/cold now
    st = stripe("gZ")
    assert not any(stratum.dir.tier_of(st, c) == HOT for c in tail)
    want = pyfold(tail)
    for _ in range(3):
        assert stratum.fold_groups([("gZ", tail)], MODULUS) == want
    assert stratum.stats()["promotions"] >= len(tail)
    assert all(stratum.dir.tier_of(st, c) == HOT for c in tail)
    hot_before = stratum.stats()["hits"]["hot"]
    assert stratum.fold_groups([("gZ", tail)], MODULUS) == want
    assert stratum.stats()["hits"]["hot"] >= hot_before + len(tail)
    assert plane.pool("gZ", MODULUS).resets == 0


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_restart_reloads_the_cold_tier(tmp_path, writer):
    """A fresh port Stratum over a directory that a Stratum of either
    package filled reloads every verified segment as cold, and its first
    fold is already exact."""
    build = port_stratum if writer == "port" else ref_stratum
    _, first = build(tmp_path, warm_bytes=1024, chunk_rows=8)
    pop = population(160, seed=11)
    want = pyfold(pop)
    assert first.fold_groups([("gB", pop)], MODULUS) == want
    cold_rows = first.cold.stats()["rows"]
    assert cold_rows > 0
    plane2, second = port_stratum(tmp_path, warm_bytes=1024, chunk_rows=8)
    assert second.cold.stats()["rows"] == cold_rows
    st = stripe("gB")
    assert all(second.dir.tier_of(st, c) == COLD for c in second.cold.entries()[st])
    assert second.fold_groups([("gB", pop)], MODULUS) == want
    assert plane2.pool("gB", MODULUS).resets == 0


def test_gauges_and_write_touches_as_the_reference(tmp_path, clocks):
    """`note_write` (with a key) and `touch_keys` feed the directory as in
    the reference; the exported dds_tier_* gauges (the cold tier's bytes
    aside: segment files hold a timestamp) render the same."""
    pop = population(60, seed=31)
    got = {}
    for name, build in (("port", port_stratum), ("ref", ref_stratum)):
        plane, stratum = build(tmp_path / name, warm_bytes=1024, chunk_rows=8)
        stratum.fold_groups([("gT", pop)], MODULUS)
        st = stripe("gT")
        stratum.note_write("gT", pop[50:53], key="k1")
        stratum.touch_keys(["k1", "never-written"], weight=2.0)
        stratum.touch("gT", MODULUS, pop[:2])
        scores = [round(stratum.dir.score(st, c), 6) for c in pop[:3] + pop[50:54]]
        reg = Registry() if name == "port" else RefRegistry()
        stratum.export_gauges(reg)
        gauges = [ln for ln in reg.render().splitlines()
                  if not ln.startswith('dds_tier_bytes{shard="-",tier="cold"}')]
        got[name] = (scores, gauges, stratum.pressure())
    assert got["port"] == got["ref"]
    scores = got["port"][0]
    # fold 1 + write 0.5 + keys 2.0, decayed a little; touch 1 + 1; fold 1
    assert all(3.4 < x < 3.5 for x in scores[3:6])
    assert all(1.9 < x < 2.0 for x in scores[:2]) and 0.9 < scores[2] < 1.0
    assert any(ln.startswith('dds_tier_rows{shard="gT",tier="cold"}') for ln in got["port"][1])


# ------------------------------------------------ directory, warm, pressure


def test_tier_directory_decay_rank_orders_like_zipf():
    d = TierDirectory(half_life=60.0)
    st = stripe()
    r = random.Random(5)
    items = list(range(40))
    weights = [1.0 / ((i + 1) ** 0.9) for i in items]
    total = sum(weights)
    for _ in range(2000):
        x = r.random() * total
        acc = 0.0
        for i, w in zip(items, weights):
            acc += w
            if acc >= x:
                d.touch(st, i)
                break
    order = [c for _, c in d.coldest([(st, i) for i in items])]
    head = set(items[:8])
    assert head & set(order[-12:]) == head
    assert d.score(st, items[0]) > d.score(st, items[-1])
    d.set_tier(st, 3, COLD)
    assert d.tier_of(st, 3) == COLD and d.counts()[COLD] == 1
    d.drop(st, 3)
    assert d.tier_of(st, 3) is None
    assert d.drop_stripe(st) == 39


def test_warm_cache_budget_and_pop():
    w = WarmCache(max_bytes=256)
    st = stripe()
    row = np.ones(16, dtype=np.uint32)  # 64 bytes
    for c in range(5):
        w.put(st, c, row)
    assert w.bytes == 5 * 64 and w.over_budget() == 5 * 64 - 256
    assert w.contains(st, 3)
    got = w.pop(st, 3)
    assert got is not None and not w.contains(st, 3)
    assert w.pop(st, 3) is None and len(w.items()) == 4
    assert w.stats() == {"rows": 4, "bytes": 256, "max_bytes": 256}


def test_stratum_pressure(tmp_path):
    plane, stratum = port_stratum(tmp_path, warm_bytes=1 << 30)
    assert stratum.pressure() == 0.0
    plane.pool("gH", MODULUS).ingest(population(16, seed=13))
    assert stratum.pressure() == 1.0  # pool at max_rows
    assert stratum.stats()["pressure"] == 1.0
    _, small = port_stratum(tmp_path / "w", max_rows=1 << 10, warm_bytes=256)
    small.demote(stripe("gW"), [(c, bn.int_to_limbs(c, L)) for c in population(1, 14)])
    assert small.pressure() == 0.5  # one 128-byte row of a 256-byte budget
