"""MultAll at RSA-1024 (L = 64) through the port's stack, in every
DDS_KARATSUBA mode, against the reference's fold and Python ints.

The port's 4-replica stack (`CudaBackend(device="cpu",
min_device_batch=0)`: the kernels' plain PyTorch paths) stores K = 12
records whose column 3 holds RSA-1024 ciphertexts (seeded plaintexts), and
answers `GET /MultAll?position=3&pubkey=n` under DDS_KARATSUBA = 0, 1 or
2. The answer must equal the reference's `mont_mxu.reduce_mul2` over the
same column in the same mode (its Pallas kernels in interpret mode, as
tests/test_mxu.py runs them) and the Python-int product mod n (so every
mode returns mode 0's ciphertext), and must decrypt to the product of the
plaintexts; the fold must go through its mode's product family (a spy on
`karatsuba.prod_k1`, `karatsuba.prod_kf` and `mont_cuda.redc`). Exact
equality.
"""

import asyncio
import json

import numpy as np
import pytest

from dds_tpu.ops import mont_mxu
from dds_tpu.ops.montgomery import ModCtx as RefCtx
from dds_tpu_torch.http.miniserver import http_request
from dds_tpu_torch.models.mult import RsaMultKey
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import karatsuba, mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx
from dds_tpu_torch.run import launch
from dds_tpu_torch.utils.config import DDSConfig

K, MSE_POS = 12, 3


@pytest.fixture(scope="module")
def rsa():
    return RsaMultKey.generate(1024)


@pytest.mark.parametrize("mode", ["0", "1", "2"])
def test_multall_at_rsa1024_equals_the_reference_fold(monkeypatch, rsa, mode):
    n = rsa.n
    assert ModCtx.make(n).L == 64 and karatsuba.fits(64)
    rng = np.random.default_rng(4)
    plains = [int(x) for x in rng.integers(2, 1 << 30, size=K)]
    cts = [rsa.public.encrypt(m) for m in plains]
    calls = {"prod_k1": 0, "prod_kf": 0, "redc": 0}
    for mod, name in ((karatsuba, "prod_k1"), (karatsuba, "prod_kf"), (mont_cuda, "redc")):
        def spy(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, spy)

    monkeypatch.setenv("DDS_KARATSUBA", mode)

    async def go():
        cfg = DDSConfig()
        cfg.proxy.device = "cpu"
        cfg.proxy.min_device_batch = 0
        dep = await launch(cfg)
        port = dep.server.cfg.port
        try:
            for i, c in enumerate(cts):
                row = [i, f"name-{i}", "1", str(c)]
                status, _ = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                               json.dumps({"contents": row}).encode())
                assert status == 200
            status, body = await http_request(
                "127.0.0.1", port, "GET", f"/MultAll?position={MSE_POS}&pubkey={n}")
        finally:
            await dep.stop()
        assert status == 200
        return int(json.loads(body)["result"])

    result = asyncio.run(go())
    want = 1
    for c in cts:
        want = want * c % n
    levels = (K - 1).bit_length() + 1  # tree levels + the R^K fix
    assert calls == {"0": {"prod_k1": 0, "prod_kf": 0, "redc": 0},
                     "1": {"prod_k1": levels, "prod_kf": 0, "redc": levels},
                     "2": {"prod_k1": 0, "prod_kf": levels, "redc": levels}}[mode]
    ref = np.asarray(mont_mxu.reduce_mul2(mont_mxu.MxuCtx.make(RefCtx.make(n)),
                                          bn.ints_to_batch(cts, 64), interpret=True))
    assert bn.limbs_to_int(ref[0]) == result == want
    prod = 1
    for m in plains:
        prod = prod * m % n
    assert rsa.decrypt(want) == prod
