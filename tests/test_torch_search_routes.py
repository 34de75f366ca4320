"""The Search*, Order* and Range routes through the port's search plane.

Both stacks boot with `[search]` on over `test_torch_routes.py`'s rows and
request sequence (every data route, the twelve search routes with
offset/limit paging, Order ties, RemoveSet, 400s): every status and body
of the port's indexed stack must equal the reference's indexed stack and
the port's own legacy scan. Then, on the port: a write made after the
first query is repaired (through the tag round with write ingest off, or
the ingest queue with it on), RemoveSet tombstones the index entry, a
warm query makes one `read_tags` round and no full read, every search
route counts `dds_search_requests_total{path="indexed"}`, an audit flush
invalidates the plane, and on a `[resident]` + `[storage]` stack the
plane's `touch_sink` reaches `Stratum.touch_keys`.
"""

import asyncio
import dataclasses
import json

import pytest

from dds_tpu.http.miniserver import http_request as ref_http
from dds_tpu.run import launch as ref_launch
from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.http.miniserver import http_request
from dds_tpu_torch.models.keys import HEKeys
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.run import launch
from dds_tpu_torch.utils.trace import tracer
from tests.test_torch_routes import OPE_POS, PSSE_POS, drive, make_rows, port_config, ref_config

ROUTES = ("OrderLS", "OrderSL", "SearchEq", "SearchNEq", "SearchGt", "SearchGtEq",
          "SearchLt", "SearchLtEq", "Range", "SearchEntry", "SearchEntryOR",
          "SearchEntryAND")


@pytest.fixture(scope="module")
def keys():
    return dataclasses.replace(HEKeys.generate(512, 1024), psse=bench_paillier_key(512))


def requests_by_path(path: str) -> dict:
    return {r: metrics.value("dds_search_requests_total", route=r, path=path) or 0
            for r in ROUTES}


def search_config(write_ingest: bool = True):
    cfg = port_config()
    cfg.search.enabled = True
    cfg.search.write_ingest = write_ingest
    cfg.search.ingest_window = 0.001
    return cfg


def test_every_route_with_search_answers_as_the_reference_and_the_legacy_scan(keys):
    rows, _ = make_rows(keys)

    async def run(boot, cfg, request):
        dep = await boot(cfg)
        try:
            return await drive(dep.server.cfg.port, request, rows, keys)
        finally:
            await dep.stop()

    port_req = lambda h, p, m, t, b=None: http_request(h, p, m, t, b)
    ref_req = lambda h, p, m, t, b=None: ref_http(h, p, m, t, b)
    rcfg = ref_config()
    rcfg.search.enabled = True

    async def go():
        before = requests_by_path("indexed")
        indexed = await run(launch, search_config(), port_req)
        after = requests_by_path("indexed")
        legacy = await run(launch, port_config(), port_req)
        ref = await run(ref_launch, rcfg, ref_req)
        return indexed, legacy, ref, before, after

    indexed, legacy, ref, before, after = asyncio.run(go())
    assert [(lb, s) for lb, s, _ in indexed] == [(lb, s) for lb, s, _ in ref] == \
        [(lb, s) for lb, s, _ in legacy]
    for (lb, st, body), (_, _, lbody), (_, _, rbody) in zip(indexed, legacy, ref):
        assert body == rbody, lb
        # a 400's text names the failing check, which differs between the
        # paths in the reference too ("non-integer value at position p"
        # against int()'s message); every other body is the legacy scan's
        assert body == lbody or st == 400, lb
    # every one of the twelve routes took the indexed path on the port
    assert all(after[r] > before[r] for r in ROUTES), (before, after)
    order = [b for lb, _, b in indexed if lb == "OrderSL"]
    assert len(json.loads(order[0])["keyset"]) == len(rows)


async def put_rows(port: int, rows) -> list[str]:
    keys = []
    for r in rows:
        st, body = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                      json.dumps({"contents": r}).encode())
        assert st == 200
        keys.append(body.decode())
    return keys


async def both_paths(server, method, target, obj=None):
    """(indexed, legacy) (status, body) for one request on the SAME server:
    the legacy scan is forced by unplugging the plane, so both paths see
    identical keys and the comparison is exact, ties included."""
    body = json.dumps(obj).encode() if obj is not None else None
    port = server.cfg.port
    indexed = await http_request("127.0.0.1", port, method, target, body)
    plane, server._search = server._search, None
    try:
        legacy = await http_request("127.0.0.1", port, method, target, body)
    finally:
        server._search = plane
    return indexed, legacy


def sweep(keys):
    che = lambda s: {"value": keys.che.encrypt(s)}
    ope = lambda x: {"value": keys.ope.encrypt(x)}
    return [("GET", f"/OrderLS?position={OPE_POS}", None),
            ("GET", f"/OrderSL?position={OPE_POS}&offset=2&limit=6", None),
            ("POST", "/SearchEq?position=1", che("name-2")),
            ("POST", "/SearchNEq?position=1&limit=4", che("name-2")),
            ("POST", f"/SearchGt?position={OPE_POS}", ope(300)),
            ("POST", f"/SearchGtEq?position={OPE_POS}", ope(300)),
            ("POST", f"/SearchLt?position={OPE_POS}", ope(300)),
            ("POST", f"/SearchLtEq?position={OPE_POS}&offset=1", ope(300)),
            ("POST", f"/Range?position={OPE_POS}",
             {"value1": keys.ope.encrypt(200), "value2": keys.ope.encrypt(500)}),
            ("POST", "/SearchEntry", che("b")),
            ("POST", "/SearchEntryOR", {"value1": keys.che.encrypt("w1"),
                                        "value2": keys.che.encrypt("name-3"),
                                        "value3": keys.che.encrypt("absent")}),
            ("POST", "/SearchEntryAND", {"value1": keys.che.encrypt("c"),
                                         "value2": keys.che.encrypt("w1"),
                                         "value3": keys.che.encrypt("a")})]


async def settle(server) -> None:
    task = server._search_ingest_task
    if task is not None:
        await task


@pytest.mark.parametrize("write_ingest", [False, True], ids=["tag-round", "ingest"])
def test_writes_after_a_query_are_repaired_and_removes_tombstone(keys, write_ingest):
    rows, _ = make_rows(keys, seed=4)

    async def go():
        dep = await launch(search_config(write_ingest))
        server = dep.server
        try:
            stored = await put_rows(server.cfg.port, rows)
            await settle(server)
            for m, t, o in sweep(keys):
                idx, leg = await both_paths(server, m, t, o)
                assert idx == leg and idx[0] == 200, t
            stale0 = metrics.value("dds_search_index_total", outcome="stale") or 0
            # rewrite an Order column in place and append an element
            st, _ = await http_request(
                "127.0.0.1", server.cfg.port, "PUT",
                f"/WriteElement/{stored[3]}?position={OPE_POS}",
                json.dumps({"value": keys.ope.encrypt(450)}).encode())
            assert st == 200
            st, _ = await http_request("127.0.0.1", server.cfg.port, "PUT",
                                       f"/AddElement/{stored[5]}",
                                       json.dumps({"value": keys.che.encrypt("b")}).encode())
            assert st == 200
            await settle(server)
            for m, t, o in sweep(keys):
                idx, leg = await both_paths(server, m, t, o)
                assert idx == leg, t
            stale = (metrics.value("dds_search_index_total", outcome="stale") or 0) - stale0
            # without ingest the first query's tag round finds both rewritten
            # keys stale and repairs them; with it, the drain got there first
            assert stale == (0 if write_ingest else 2)
            st, _ = await http_request("127.0.0.1", server.cfg.port, "DELETE",
                                       f"/RemoveSet/{stored[0]}")
            assert st == 200
            await settle(server)
            entry = server._search.group("")._entries.get(stored[0])
            if write_ingest:  # the RemoveSet's write is a tombstone
                assert entry is not None and entry[1] is None
            for m, t, o in sweep(keys):
                idx, leg = await both_paths(server, m, t, o)
                assert idx == leg, t
                assert stored[0] not in json.loads(idx[1])["keyset"], t
        finally:
            await dep.stop()

    asyncio.run(go())


def test_warm_query_is_one_tag_round_and_no_full_read(keys, monkeypatch):
    rows, _ = make_rows(keys, seed=5)

    async def go():
        dep = await launch(search_config())
        server = dep.server
        try:
            await put_rows(server.cfg.port, rows)
            await settle(server)
            target = f"/SearchGtEq?position={OPE_POS}"
            body = json.dumps({"value": 0}).encode()
            await http_request("127.0.0.1", server.cfg.port, "POST", target, body)  # cold
            fetches = []
            real = server._fetch_tagged

            async def counted(key, exclude=()):
                fetches.append(key)
                return await real(key, exclude)

            monkeypatch.setattr(server, "_fetch_tagged", counted)
            hits0 = metrics.value("dds_search_index_total", outcome="hit") or 0
            tracer.reset()
            st, out = await http_request("127.0.0.1", server.cfg.port, "POST", target, body)
            assert st == 200 and len(json.loads(out)["keyset"]) == len(rows)
            spans = tracer.summary()
            assert spans["abd.read_tags"]["count"] == 1, spans
            assert "abd.fetch" not in spans and fetches == []
            assert spans["proxy.search_eval"]["count"] == 1
            assert spans["kernel.predicate.dispatch"]["count"] == 1
            assert spans["kernel.predicate.execute"]["count"] == 1
            hits = (metrics.value("dds_search_index_total", outcome="hit") or 0) - hits0
            assert hits == len(rows)
            # an audit flush of the aggregate cache voids the plane too
            server._flush_cache()
            assert server._search.stats()["indexed_keys"] == 0
            st, out2 = await http_request("127.0.0.1", server.cfg.port, "POST", target, body)
            assert (st, out2) == (200, out) and len(fetches) == len(rows)
        finally:
            await dep.stop()

    asyncio.run(go())


def test_touch_sink_reaches_stratum_touch_keys(keys, tmp_path):
    rows, _ = make_rows(keys, seed=6)

    async def go():
        cfg = search_config()
        cfg.resident.enabled = True
        cfg.resident.min_fold = 1
        cfg.storage.enabled = True
        cfg.storage.dir = str(tmp_path)
        dep = await launch(cfg)
        server = dep.server
        try:
            stratum = server._stratum
            assert server._search.touch_sink == stratum.touch_keys
            stored = await put_rows(server.cfg.port, rows)
            nsqr = keys.psse.public.nsquare
            st, _ = await http_request("127.0.0.1", server.cfg.port, "GET",
                                       f"/SumAll?position={PSSE_POS}&nsqr={nsqr}")
            assert st == 200  # the pool exists: selections now touch its stripe
            touched = []
            real = stratum.dir.touch
            stratum.dir.touch = lambda stripe, c, weight=1.0: (
                touched.append((stripe, c)), real(stripe, c, weight=weight))
            st, out = await http_request(
                "127.0.0.1", server.cfg.port, "POST", "/SearchEq?position=1",
                json.dumps({"value": keys.che.encrypt("name-2")}).encode())
            hits = json.loads(out)["keyset"]
            assert st == 200 and hits
            want = {int(rows[stored.index(k)][PSSE_POS]) for k in hits}
            assert want <= {c for _, c in touched}
            assert {stripe for stripe, _ in touched} == {("", "", nsqr)}
        finally:
            await dep.stop()

    asyncio.run(go())
