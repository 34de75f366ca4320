"""The port's search plane against the reference's, on JAX CPU.

`dds_tpu_torch.search` (`GroupIndex`, `SearchPlane` on the CPU) against
`dds_tpu.search` over the same seeded numpy rows at N = 1, 37 and 4,096:
every `eval_*` answer (key sets, and the ordered runs of `eval_order`)
must be identical, and so must `len`, `pack_count` and `stats()`. The rows
hold OPE ties and the lane boundaries, rows shorter than the queried
position, tombstones, a column that is not packable (the host branch), a
non-integer column (ValueError in both), out-of-band thresholds, an empty
pack, and the ingest queue with overflow and invalidation.
"""

import numpy as np
import pytest
import torch

from dds_tpu.obs.metrics import Registry as RefRegistry
from dds_tpu.search import GroupIndex as RefGroupIndex
from dds_tpu.search import SearchPlane as RefSearchPlane
from dds_tpu_torch.obs.metrics import Registry
from dds_tpu_torch.ops.predicate import LANE_MASK, PACK_MAX
from dds_tpu_torch.search import GroupIndex, SearchPlane

SIZES = (1, 37, 4096)
EDGES = [0, LANE_MASK, LANE_MASK + 1, PACK_MAX]


def make_rows(n: int, seed: int) -> list[tuple[str, tuple, list | None]]:
    """(key, tag, value) writes: OPE-like ints at 0 (ties, lane edges), an
    unpackable int at 1 (negatives and > PACK_MAX), a DET label at 2,
    element words after; some rows end early, some are tombstones."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, PACK_MAX + 1, size=max(1, n // 8))
    out = []
    for i in range(n):
        ope = EDGES[i] if i < len(EDGES) else int(
            rng.choice(pool) if rng.random() < 0.5 else rng.integers(0, PACK_MAX + 1))
        wide = int(rng.integers(-(1 << 60), 1 << 60))
        width = int(rng.integers(1, 7))
        value = [ope, wide, f"name-{int(rng.integers(0, 6))}"] + \
            [f"w{int(x)}" for x in rng.integers(0, 9, size=4)]
        value = value[:width]
        if i % 11 == 5:
            value = None  # a tombstone
        out.append((f"k{int(rng.integers(0, 1 << 40)):011x}-{i}", (1, f"c{i}"), value))
    return out


def both(n: int, seed: int = 0):
    rows = make_rows(n, seed + n)
    port, ref = GroupIndex(), RefGroupIndex()
    for key, tag, value in rows:
        port.upsert(key, tag, value)
        ref.upsert(key, tag, value)
    return port, ref, rows


def queries(rows, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    live = [v for _, _, v in rows if v]
    opes = [v[0] for v in live]
    picks = [opes[int(i)] for i in rng.integers(0, len(opes), size=3)] if opes else []
    same_hi = [(v >> 26 << 26) | int(rng.integers(0, LANE_MASK + 1)) for v in picks]
    return {"thresholds": EDGES + picks + same_hi + [-5, PACK_MAX + 1, 1 << 70],
            "labels": [f"name-{i}" for i in range(3)] + ["absent"],
            "entries": [["w3"], ["w1", "name-2", "nowhere"], ["name-0", "w2", "w5"]]}


@pytest.mark.parametrize("n", SIZES)
def test_every_eval_equals_the_reference(n):
    port, ref, rows = both(n)
    q = queries(rows, n)
    for pos in (0, 1):  # packed, then the host branch
        for t in q["thresholds"]:
            for op in ("gt", "ge", "lt", "le"):
                assert port.eval_compare(pos, op, t) == ref.eval_compare(pos, op, t), (pos, op, t)
        ts = sorted(q["thresholds"])
        for a, b in zip(ts, ts[2:] + ts[:2]):
            assert port.eval_range(pos, a, b) == ref.eval_range(pos, a, b), (pos, a, b)
        for desc in (False, True):
            assert port.eval_order(pos, desc) == ref.eval_order(pos, desc), (pos, desc)
    for pos in (2, 3, 40):  # DET labels, element words, past every row
        for item in q["labels"] + ["w4"]:
            for want in (True, False):
                assert port.eval_eq(pos, item, want) == ref.eval_eq(pos, item, want)
    for qs in q["entries"] + [[]]:
        for mode in ("any", "all"):
            assert port.eval_entry(qs, mode) == ref.eval_entry(qs, mode), (qs, mode)
    assert (len(port), port.pack_count()) == (len(ref), ref.pack_count())
    for pos in (2, 0):  # not an integer: 400 on both paths of the route
        if any(v and len(v) > pos and not isinstance(v[pos], int) for _, _, v in rows):
            with pytest.raises(ValueError):
                port.eval_order(pos, False)
            with pytest.raises(ValueError):
                ref.eval_order(pos, False)


@pytest.mark.parametrize("n", SIZES)
def test_packs_live_on_the_plane_device_and_drop_on_mutation(n):
    port, ref, rows = both(n)
    port.eval_compare(0, "gt", 7)
    port.eval_eq(2, "name-1", True)
    port.eval_entry(["w1"], "any")
    packs = port._packs
    live = [p for p in packs.values() if "hi" in p or "dhi" in p]
    assert live and all(t.device == torch.device("cpu") and t.dtype in (torch.int64, torch.bool)
                        for p in live for k, t in p.items() if k in ("hi", "lo", "dhi", "dlo",
                                                                     "valid"))
    key, tag, _ = rows[0]
    port.upsert(key, (0, "older"), [1])  # an older tag never wins
    assert port.pack_count() == len(packs) > 0
    port.upsert(key, (2, "newer"), [1])
    ref.upsert(key, (2, "newer"), [1])
    assert port.pack_count() == 0 and port.tag(key) == ref.tag(key) == (2, "newer")
    assert port.eval_order(0, True) == ref.eval_order(0, True)
    port.remove(key)
    ref.remove(key)
    assert port.tag(key) is None and len(port) == len(ref)
    assert port.eval_range(0, 0, PACK_MAX) == ref.eval_range(0, 0, PACK_MAX)


def test_tombstones_and_empty_packs_answer_empty():
    port, ref = GroupIndex(), RefGroupIndex()
    for idx in (port, ref):
        idx.upsert("a", (1, "x"), None)
        idx.upsert("b", (1, "x"), None)
        idx.upsert("c", None, [5])  # no tag: never indexed
    for idx in (port, ref):
        assert idx.eval_compare(0, "ge", 0) == set()
        assert idx.eval_range(0, 0, 9) == set() and idx.eval_order(0, False) == []
        assert idx.eval_eq(0, "5", False) == set() and idx.eval_entry(["5"], "any") == set()
        assert len(idx) == 2 and idx.tag("a") == (1, "x") and idx.tag("c") is None
    assert port.pack_count() == ref.pack_count()
    port.upsert("a", (2, "y"), [3])
    ref.upsert("a", (2, "y"), [3])
    assert port.eval_compare(0, "le", 3) == ref.eval_compare(0, "le", 3) == {"a"}
    assert port.eval_range(0, 4, 2) == ref.eval_range(0, 4, 2) == set()
    assert port.eval_range(0, -9, -1) == ref.eval_range(0, -9, -1) == set()


@pytest.mark.parametrize("n", SIZES)
def test_plane_ingest_overflow_invalidation_and_stats(n):
    rows = make_rows(n, 99 + n)
    cap = max(1, n // 2)
    port, ref = SearchPlane(max_pending=cap), RefSearchPlane(max_pending=cap)
    assert port.device == torch.device("cpu")
    port.register_groups(["", "g1"])
    ref.register_groups(["", "g1"])
    accepted = [(port.note_write("g1" if i % 3 else "", k, t, v),
                 ref.note_write("g1" if i % 3 else "", k, t, v))
                for i, (k, t, v) in enumerate(rows)]
    assert all(a == b for a, b in accepted)
    assert sum(a for a, _ in accepted) == min(n, cap)
    assert port.stats() == ref.stats() and port.pending_ingest() == min(n, cap)
    assert port.ingest_pending() == ref.ingest_pending() == min(n, cap)
    k0, t0, v0 = rows[0]
    for plane in (port, ref):
        plane.upsert("", "direct", (1, "d"), [4, 0, "name-1"])
        plane.upsert("", "direct", (0, "d"), [9])  # older: ignored
        plane.group("", tenant="t1").upsert("tenant-key", (1, "d"), [1])
    assert port.tag("", "direct") == ref.tag("", "direct") == (1, "d")
    for gid in ("", "g1"):
        assert port.group(gid).eval_order(0, True) == ref.group(gid).eval_order(0, True)
        assert port.group(gid).eval_eq(2, "name-1", True) == \
            ref.group(gid).eval_eq(2, "name-1", True)
    assert port.stats() == ref.stats()
    assert port.group_ids() == ref.group_ids() == ["", "g1"]
    regs = Registry(), RefRegistry()
    port.export_gauges(regs[0])
    ref.export_gauges(regs[1])
    for name, labels in (("dds_search_index_keys", {"shard": "-"}),
                         ("dds_search_index_keys", {"shard": "g1"}),
                         ("dds_search_index_packs", {"shard": "-"}),
                         ("dds_tenant_search_keys", {"tenant": "t1"}),
                         ("dds_search_pending_ingest", {}),
                         ("dds_search_ingest_dropped", {}),
                         ("dds_search_invalidations", {})):
        assert regs[0].value(name, **labels) == regs[1].value(name, **labels), name
    port.remove("", "direct")
    ref.remove("", "direct")
    assert port.evict_tenant("t1") == ref.evict_tenant("t1") == 1
    # queued writes, then an invalidation: entries and queue both dropped
    for plane in (port, ref):
        plane.note_write("", "late", (3, "z"), [1])
        plane.invalidate()
    assert port.stats() == ref.stats()
    st = port.stats()
    assert st["indexed_keys"] == 0 and st["pending_ingest"] == 0 and st["invalidations"] == 1
    assert port._pending.dropped("invalidated") == ref._pending.dropped("invalidated") == 1


def test_touch_sink_is_best_effort():
    port = SearchPlane()
    seen = []
    port.touch_sink = lambda keys, tenant: seen.append((list(keys), tenant))
    port.note_selected(["a", "b"])
    port.note_selected([])
    assert seen == [(["a", "b"], "")]

    def broken(keys, tenant):
        raise RuntimeError("sink down")

    port.touch_sink = broken
    port.note_selected(["a"])  # never fails the query


def test_a_cuda_plane_without_a_card_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchPlane(device="cuda")
