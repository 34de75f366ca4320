"""Every data route of the port's proxy against the reference's.

Both stacks boot the north-star topology of benchmarks/bft_sum.py (4
BFT-ABD replicas, quorum 3, f = 1, recovery off, in-memory transport), as
tests/test_torch_slice.py boots them; the port folds on
`CudaBackend(device="cpu", min_device_batch=0)` (the kernels' plain
PyTorch paths), the reference on its `cpu` backend. The same seeded
ciphertext rows (OPE, CHE, Paillier on the 512-bit bench key, RSA-1024,
random-IV blobs) go into both through `POST /PutSet`, then both take the
same request sequence over every ported route: element reads and writes
(a WriteElement past the end appends), RemoveSet followed by SumAll, the
pair aggregates and the folds with and without a modulus, SumAll and
MultAll alternating over two columns, the Search/Order/Range scans with
offset/limit paging, 404 for a missing key or position and 400 for a
negative position or a non-integer Order column. Every status and body
must be identical, and the port's aggregates must decrypt to the
plaintexts' fold. Exact equality throughout; the tests wait on completed
requests, never on timing.
"""

import asyncio
import dataclasses
import json

import numpy as np
import pytest

from dds_tpu.http.miniserver import http_request as ref_http
from dds_tpu.run import launch as ref_launch
from dds_tpu.utils.config import DDSConfig as RefConfig
from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.http.miniserver import http_request
from dds_tpu_torch.models.keys import HEKeys
from dds_tpu_torch.run import launch
from dds_tpu_torch.utils.config import DDSConfig

N = 24
OPE_POS, CHE_POS, PSSE_POS, MSE_POS = 0, 1, 2, 3


@pytest.fixture(scope="module")
def keys():
    return dataclasses.replace(HEKeys.generate(512, 1024), psse=bench_paillier_key(512))


def make_rows(keys, seed: int = 0):
    """N canonical 8-column rows plus a 2-column one, encrypted per column
    (obfuscators and plaintexts from numpy), and their plaintexts."""
    rng = np.random.default_rng(seed)
    pk = keys.psse.public
    blinds = [pk.blind(int(rng.integers(2, 1 << 62))) for _ in range(4)]
    plain, rows = [], []
    for i in range(N):
        # OPE values repeat (ties in Order*), names repeat (SearchEq sets)
        p = [int(rng.integers(0, 8)) * 100, f"name-{i % 5}", int(rng.integers(1, 1 << 20)),
             int(rng.integers(2, 1 << 16)), "a" if i % 3 else "b", "c", f"w{i % 4}", f"blob-{i}"]
        plain.append(p)
        rows.append([keys.ope.encrypt(p[0]), keys.che.encrypt(p[1]),
                     str(pk.encrypt(p[2], rn=blinds[i % 4])), str(keys.mse.public.encrypt(p[3])),
                     keys.che.encrypt(p[4]), keys.che.encrypt(p[5]), keys.che.encrypt(p[6]),
                     keys.none.encrypt(p[7])])
    plain.append([7, "short"])
    rows.append([keys.ope.encrypt(7), keys.che.encrypt("short")])
    return rows, plain


def ref_config() -> RefConfig:
    rcfg = RefConfig()
    rcfg.replicas.endpoints = [f"replica-{i}" for i in range(4)]
    rcfg.replicas.sentinent = []
    rcfg.replicas.byz_quorum_size = 3
    rcfg.replicas.byz_max_faults = 1
    rcfg.recovery.enabled = False
    rcfg.proxy.port = 0
    rcfg.proxy.crypto_backend = "cpu"
    return rcfg


def port_config() -> DDSConfig:
    cfg = DDSConfig()
    cfg.proxy.device = "cpu"
    cfg.proxy.min_device_batch = 0
    return cfg


async def drive(port: int, request, rows, keys) -> list:
    """The request sequence; [(label, status, body)] in order."""
    out = []

    async def call(label, method, target, obj=None):
        body = json.dumps(obj).encode() if obj is not None else None
        status, resp = await request("127.0.0.1", port, method, target, body)
        out.append((label, status, resp))
        return status, resp

    nsqr, n = keys.psse.public.nsquare, keys.mse.n
    stored = []
    for i, r in enumerate(rows):
        _, k = await call(f"put{i}", "POST", "/PutSet", {"contents": r})
        stored.append(k.decode())
    k0, k1, k2, short = stored[0], stored[1], stored[2], stored[-1]
    che = lambda s: {"value": keys.che.encrypt(s)}
    ope = lambda x: {"value": keys.ope.encrypt(x)}

    # element routes
    await call("get", "GET", f"/GetSet/{k0}")
    await call("get-missing", "GET", "/GetSet/nope")
    await call("read", "GET", f"/ReadElement/{k0}?position={CHE_POS}")
    await call("read-past-end", "GET", f"/ReadElement/{short}?position={PSSE_POS}")
    await call("read-negative", "GET", f"/ReadElement/{k0}?position=-1")
    await call("read-missing", "GET", f"/ReadElement/nope?position=0")
    await call("read-no-position", "GET", f"/ReadElement/{k0}")
    await call("is", "POST", f"/IsElement/{k0}", {"value": rows[0][CHE_POS]})
    await call("is-not", "POST", f"/IsElement/{k0}", che("absent"))
    await call("is-missing", "POST", "/IsElement/nope", che("a"))
    await call("add", "PUT", f"/AddElement/{k1}", {"value": "tail-1"})
    await call("add-missing", "PUT", "/AddElement/nope", {"value": "x"})
    await call("add-bad-body", "PUT", f"/AddElement/{k1}", {"val": 1})
    await call("read-added", "GET", f"/ReadElement/{k1}?position=8")
    await call("write-append", "PUT", f"/WriteElement/{k1}?position=12", {"value": "app"})
    await call("write-in-place", "PUT", f"/WriteElement/{k2}?position={OPE_POS}", ope(250))
    await call("write-missing", "PUT", "/WriteElement/nope?position=0", {"value": 1})
    await call("get-written", "GET", f"/GetSet/{k1}")
    await call("get-in-place", "GET", f"/GetSet/{k2}")

    # aggregates, with and without a modulus
    await call("sum", "GET", f"/Sum?key1={k0}&key2={k1}&position={PSSE_POS}&nsqr={nsqr}")
    await call("sum-plain", "GET", f"/Sum?key1={k0}&key2={k1}&position={PSSE_POS}")
    await call("mult", "GET", f"/Mult?key1={k0}&key2={k1}&position={MSE_POS}&pubkey={n}")
    await call("mult-plain", "GET", f"/Mult?key1={k0}&key2={k1}&position={MSE_POS}")
    await call("sum-missing", "GET", f"/Sum?key1={k0}&key2=nope&position={PSSE_POS}&nsqr={nsqr}")
    await call("sum-past-end", "GET",
               f"/Sum?key1={k0}&key2={short}&position={PSSE_POS}&nsqr={nsqr}")
    await call("sum-no-key", "GET", f"/Sum?key1={k0}&position={PSSE_POS}")
    for rnd in range(2):  # alternating columns: the operand memo never crosses
        await call(f"sumall{rnd}", "GET", f"/SumAll?position={PSSE_POS}&nsqr={nsqr}")
        await call(f"multall{rnd}", "GET", f"/MultAll?position={MSE_POS}&pubkey={n}")
    await call("sumall-plain", "GET", f"/SumAll?position={PSSE_POS}")
    await call("multall-plain", "GET", f"/MultAll?position={OPE_POS}")
    await call("multall-plain-too-long", "GET", f"/MultAll?position={MSE_POS}")
    await call("sumall-no-column", "GET", f"/SumAll?position=40&nsqr={nsqr}")
    await call("sumall-negative", "GET", f"/SumAll?position=-2&nsqr={nsqr}")

    # scans, paged
    for route in ("OrderLS", "OrderSL"):
        await call(route, "GET", f"/{route}?position={OPE_POS}")
        await call(f"{route}-page", "GET", f"/{route}?position={OPE_POS}&offset=3&limit=5")
    await call("order-not-int", "GET", f"/OrderLS?position={CHE_POS}")
    await call("order-negative", "GET", "/OrderSL?position=-1")
    await call("order-bad-offset", "GET", f"/OrderSL?position={OPE_POS}&offset=-1")
    await call("order-bad-limit", "GET", f"/OrderSL?position={OPE_POS}&limit=-1")
    await call("order-no-column", "GET", "/OrderSL?position=30")
    for route in ("SearchEq", "SearchNEq"):
        await call(route, "POST", f"/{route}?position={CHE_POS}", che("name-2"))
        await call(f"{route}-page", "POST", f"/{route}?position={CHE_POS}&offset=1&limit=2",
                   che("name-2"))
    for route in ("SearchGt", "SearchGtEq", "SearchLt", "SearchLtEq"):
        await call(route, "POST", f"/{route}?position={OPE_POS}", ope(300))
    await call("gt-not-int", "POST", f"/SearchGt?position={CHE_POS}", ope(300))
    await call("range", "POST", f"/Range?position={OPE_POS}",
               {"value1": keys.ope.encrypt(200), "value2": keys.ope.encrypt(500)})
    await call("range-page", "POST", f"/Range?position={OPE_POS}&offset=2",
               {"value1": str(keys.ope.encrypt(200)), "value2": keys.ope.encrypt(500)})
    await call("range-bad-body", "POST", f"/Range?position={OPE_POS}", {"value1": 1})
    await call("entry", "POST", "/SearchEntry", che("b"))
    triple = {"value1": keys.che.encrypt("w1"), "value2": keys.che.encrypt("name-3"),
              "value3": keys.che.encrypt("absent")}
    await call("entry-or", "POST", "/SearchEntryOR", triple)
    await call("entry-and", "POST", "/SearchEntryAND", triple)
    await call("entry-and-all", "POST", "/SearchEntryAND",
               {"value1": keys.che.encrypt("c"), "value2": keys.che.encrypt("w1"),
                "value3": keys.che.encrypt("a")})
    await call("entry-page", "POST", "/SearchEntryOR?limit=2", triple)

    # RemoveSet, then the aggregates again: the removed record must not fold
    await call("remove", "DELETE", f"/RemoveSet/{k0}")
    await call("get-removed", "GET", f"/GetSet/{k0}")
    await call("remove-missing", "DELETE", "/RemoveSet/nope")
    await call("sumall-after-remove", "GET", f"/SumAll?position={PSSE_POS}&nsqr={nsqr}")
    await call("multall-after-remove", "GET", f"/MultAll?position={MSE_POS}&pubkey={n}")
    await call("order-after-remove", "GET", f"/OrderSL?position={OPE_POS}")
    await call("unknown-route", "GET", "/Nope")
    return out


def _result(out, label) -> int:
    (body,) = [b for lb, _, b in out if lb == label]
    return int(json.loads(body)["result"])


def _keyset(out, label) -> list:
    (body,) = [b for lb, _, b in out if lb == label]
    return json.loads(body)["keyset"]


def test_every_route_answers_as_the_reference_does(keys):
    rows, plain = make_rows(keys)

    async def go():
        dep = await launch(port_config())
        try:
            port = await drive(dep.server.cfg.port,
                               lambda h, p, m, t, b=None: http_request(h, p, m, t, b),
                               rows, keys)
        finally:
            await dep.stop()
        rdep = await ref_launch(ref_config())
        try:
            ref = await drive(rdep.server.cfg.port,
                              lambda h, p, m, t, b=None: ref_http(h, p, m, t, b),
                              rows, keys)
        finally:
            await rdep.stop()
        return port, ref

    port, ref = asyncio.run(go())
    assert [(lb, s) for lb, s, _ in port] == [(lb, s) for lb, s, _ in ref]
    for (lb, _, body), (_, _, rbody) in zip(port, ref):
        assert body == rbody, lb
    status = {lb: s for lb, s, _ in port}
    for lb in ("get-missing", "read-past-end", "read-missing", "is-missing", "add-missing",
               "write-missing", "sum-missing", "sum-past-end", "sumall-no-column",
               "get-removed", "unknown-route"):
        assert status[lb] == 404, lb
    for lb in ("read-negative", "read-no-position", "add-bad-body", "sum-no-key",
               "sumall-negative", "order-not-int", "order-negative", "order-bad-offset",
               "order-bad-limit", "gt-not-int", "range-bad-body",
               # the plain product of 24 RSA-1024 ciphertexts has more than
               # the 4,300 decimal digits `str(int)` allows: ValueError
               "multall-plain-too-long"):
        assert status[lb] == 400, lb

    # the port's answers, decrypted against the plaintexts
    full = plain[:N]
    psse, mse = keys.psse, keys.mse
    total = sum(p[PSSE_POS] for p in full)
    prod = 1
    for p in full:
        prod = prod * p[MSE_POS] % mse.n
    for rnd in range(2):
        assert psse.decrypt(_result(port, f"sumall{rnd}")) == total
        assert mse.decrypt(_result(port, f"multall{rnd}")) == prod
    assert psse.decrypt(_result(port, "sum")) == full[0][PSSE_POS] + full[1][PSSE_POS]
    assert mse.decrypt(_result(port, "mult")) == full[0][MSE_POS] * full[1][MSE_POS]
    assert psse.decrypt(_result(port, "sumall-after-remove")) == total - full[0][PSSE_POS]
    assert mse.decrypt(_result(port, "multall-after-remove")) == (
        prod * pow(full[0][MSE_POS], -1, mse.n) % mse.n)
    cts = [int(r[PSSE_POS]) for r in rows[:N]]
    assert _result(port, "sumall-plain") == sum(cts)
    opes = [int(r[OPE_POS]) for r in rows]
    opes[2] = keys.ope.encrypt(250)  # written in place
    assert _result(port, "multall-plain") == int(np.prod(opes, dtype=object))
    order = _keyset(port, "OrderSL")
    assert len(order) == N + 1 and _keyset(port, "OrderSL-page") == order[3:8]
    assert len(_keyset(port, "order-after-remove")) == N
    assert _keyset(port, "order-no-column") == []  # records without it are excluded
    assert len(_keyset(port, "SearchEq")) == sum(p[CHE_POS] == "name-2" for p in full)
    assert len(_keyset(port, "SearchEq")) + len(_keyset(port, "SearchNEq")) == N + 1
