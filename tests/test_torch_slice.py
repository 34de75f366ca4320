"""The SumAll path end to end: the port's 4-replica SumAll against the
reference's.

Both stacks boot the north-star topology of benchmarks/bft_sum.py
(4 BFT-ABD replicas, quorum 3, f = 1, recovery off, in-memory transport)
on the same 512-bit bench key, and take the same 64 seeded Paillier rows
through `POST /PutSet`. The SumAll ciphertexts must be identical strings
and decrypt to the plaintext total, and every `GET /GetSet` body must be
equal. The port folds through its resident pool and the kernel wrapper's
plain PyTorch path (`device="cpu"`, `min_device_batch=0`). The test waits
on completed requests only, never on timing.
"""

import asyncio
import json

import numpy as np

from dds_tpu.bench_key import bench_paillier_key as ref_key
from dds_tpu.http.miniserver import http_request as ref_http
from dds_tpu.run import launch as ref_launch
from dds_tpu.utils.config import DDSConfig as RefConfig
from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.http.miniserver import http_request
from dds_tpu_torch.run import launch
from dds_tpu_torch.utils.config import DDSConfig
from dds_tpu_torch.utils.trace import tracer

K = 64
PSSE_POS = 2


def _rows(pk, seed=0):
    """bft_sum.make_rows' shape with seeded obfuscators: r from numpy."""
    rng = np.random.default_rng(seed)
    blinds = [pk.blind(int(rng.integers(2, 1 << 62))) for _ in range(8)]
    rows = [
        [i, f"name-{i}", pk.encrypt(i + 1, rn=blinds[i % len(blinds)]),
         2, "a", "b", "c", "blob"]
        for i in range(K)
    ]
    return rows, K * (K + 1) // 2


async def _drive(port, put, rows, nsqr):
    keys = []
    for r in rows:
        status, body = await put(port, "POST", "/PutSet",
                                 json.dumps({"contents": r}).encode())
        assert status == 200
        keys.append(body.decode())
    sums = []
    for _ in range(2):  # cold (ingest) and warm (cached tags, resident rows)
        status, body = await put(port, "GET", f"/SumAll?position={PSSE_POS}&nsqr={nsqr}")
        assert status == 200
        sums.append(json.loads(body)["result"])
    gets = []
    for k in keys[:8]:
        status, body = await put(port, "GET", f"/GetSet/{k}")
        assert status == 200
        gets.append(json.loads(body))
    status, _ = await put(port, "GET", "/MultAll?position=2")
    return keys, sums, gets, status


def test_port_sumall_equals_reference_sumall():
    key, rkey = bench_paillier_key(512), ref_key(512)
    assert key.n == rkey.n
    rows, total = _rows(key.public)

    async def go():
        cfg = DDSConfig()
        cfg.proxy.device = "cpu"
        cfg.proxy.min_device_batch = 0
        dep = await launch(cfg)
        try:
            port = await _drive(
                dep.server.cfg.port,
                lambda p, m, t, b=None: http_request("127.0.0.1", p, m, t, b),
                rows, key.public.nsquare,
            )
            fold_spans = [e for e in tracer.events("kernel.fold")]
        finally:
            await dep.stop()

        rcfg = RefConfig()
        rcfg.replicas.endpoints = [f"replica-{i}" for i in range(4)]
        rcfg.replicas.sentinent = []
        rcfg.replicas.byz_quorum_size = 3
        rcfg.replicas.byz_max_faults = 1
        rcfg.recovery.enabled = False
        rcfg.proxy.port = 0
        rcfg.proxy.crypto_backend = "cpu"
        rdep = await ref_launch(rcfg)
        try:
            ref = await _drive(
                rdep.server.cfg.port,
                lambda p, m, t, b=None: ref_http("127.0.0.1", p, m, t, b),
                rows, key.public.nsquare,
            )
        finally:
            await rdep.stop()
        return port, ref, fold_spans

    (keys, sums, gets, mult), (rkeys, rsums, rgets, rmult), spans = asyncio.run(go())
    assert keys == rkeys                       # content-hash record keys
    assert sums[0] == sums[1] == rsums[0] == rsums[1]
    assert key.decrypt(int(sums[0])) == rkey.decrypt(int(rsums[0])) == total
    assert gets == rgets
    # MultAll without pubkey is the plain product: 64 ciphertexts of 1,024
    # bits give more decimal digits than `str(int)` allows, 400 on both
    assert mult == rmult == 400
    assert any(e.meta.get("k") == K and e.meta.get("resident") for e in spans)
