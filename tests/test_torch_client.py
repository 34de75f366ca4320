"""The client's bulk-encryption path against the reference's.

Bulk Paillier blinding through `CudaBackend(device="cpu").powmod_batch`
(the exp kernel's wrapper on its plain PyTorch ladder), the HE provider's
obfuscator pool, `HEKeys` JSON carried between the packages
(`convert.keys_from_reference` / `keys_to_reference`), `load_provider`, and
the client slice end to end: `load_provider` + `launch` + 2 clients
executing PutSet digests with `bulk-encrypt-backend = "cuda"` on the CPU,
then the same digests through `dds_tpu.run` with the keys carried across.
The PSSE key is the 512-bit bench key. Exact integer arithmetic: every
comparison is equality; the tests wait on completed requests, never on
timing.
"""

import asyncio
import dataclasses
import json
import os
import random
import socket
import stat

import pytest

from benchmarks.put_concurrency import make_digest as ref_make_digest
from dds_tpu.clt.client import ClientConfig as RefClientConfig
from dds_tpu.clt.client import DDSHttpClient as RefClient
from dds_tpu.models.facade import HomoProvider as RefProvider
from dds_tpu.models.keys import HEKeys as RefKeys
from dds_tpu.models.paillier import PaillierKey as RefPaillierKey
from dds_tpu.models.paillier import PaillierPublicKey as RefPublicKey
from dds_tpu.run import launch as ref_launch
from dds_tpu.run import load_provider as ref_load_provider
from dds_tpu.utils.config import DDSConfig as RefConfig
from dds_tpu_torch import convert
from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.clt import instructions as I
from dds_tpu_torch.clt.client import ClientConfig, DDSHttpClient
from dds_tpu_torch.http.miniserver import http_request
from dds_tpu_torch.models.backend import CudaBackend, get_backend
from dds_tpu_torch.models.facade import HomoProvider
from dds_tpu_torch.models.keys import HEKeys
from dds_tpu_torch.models.paillier import PaillierPublicKey
from dds_tpu_torch.run import launch, load_provider
from dds_tpu_torch.utils.config import DDSConfig
from dds_tpu_torch.utils.trace import tracer

PSSE_POS = 2
KEYS = dataclasses.replace(HEKeys.generate(512, 512), psse=bench_paillier_key(512))


def _pow_spans() -> list:
    return [e for e in tracer.events()
            if e.name in ("kernel.pow.dispatch", "kernel.pow.compile")]


# ------------------------------------------------------------ bulk blinding

def test_encrypt_batch_decrypts_through_the_bulk_backend():
    """Full-width n-bit exponent through `powmod_batch`: every ciphertext
    decrypts, and the same message twice gives two ciphertexts (a fresh
    obfuscator per message)."""
    pk, be = KEYS.psse.public, get_backend("cuda", device="cpu")
    ms = [7, 7] + [random.Random(1).randrange(1 << 32) for _ in range(9)]
    tracer.reset()
    cts = pk.encrypt_batch(ms, backend=be, min_batch=1)
    assert [e.meta["b"] for e in _pow_spans()] == [len(ms)]
    assert [KEYS.psse.decrypt(c) for c in cts] == ms
    assert len(set(cts)) == len(ms)
    # below min_batch: the host loop, same contract, no backend call
    tracer.reset()
    host = pk.encrypt_batch(ms, backend=be, min_batch=10_000)
    assert [KEYS.psse.decrypt(c) for c in host] == ms and _pow_spans() == []


def test_provider_blind_pool_feeds_psse_encrypts_then_djn_takes_over():
    """precompute_psse_blinds fills the pool through the bulk backend; each
    PSSE encrypt pops one obfuscator (never shared), and once the pool is
    empty the DJN path serves. Without a backend precompute is a no-op."""
    prov = HomoProvider(KEYS, bulk_backend=get_backend("cuda", device="cpu"))
    assert prov.precompute_psse_blinds(4, min_batch=1) == 4
    pool = list(prov._blind_pool)
    assert len(pool) == 4 and len(set(pool)) == 4
    assert all(KEYS.psse.decrypt(rn) == 0 for rn in pool)  # each is some r^n
    assert prov.precompute_psse_blinds(3) == 0  # below the default min_batch
    cts = [int(prov.encrypt(9, "PSSE")) for _ in range(5)]  # 4 pooled + 1 DJN
    assert prov._blind_pool == []
    assert [KEYS.psse.decrypt(c) for c in cts] == [9] * 5
    assert len(set(cts)) == 5
    bare = HomoProvider(KEYS)
    assert bare.precompute_psse_blinds(100) == 0 and bare._blind_pool == []
    assert KEYS.psse.decrypt_signed(int(bare.encrypt(-42, "PSSE"))) == -42


@pytest.mark.parametrize("bits", [512, 1024, 2031, 2032, 2048, 3072, 4096, 7680, 15360])
def test_djn_exponent_width_matches_reference(bits):
    n = (1 << (bits - 1)) | 1
    assert PaillierPublicKey(n)._djn_s_bits() == RefPublicKey(n)._djn_s_bits()


def test_paillier_helpers_match_reference():
    k = KEYS.psse
    ref = RefPaillierKey(n=k.n, p=k.p, q=k.q)
    rng = random.Random(3)
    ms = [0, 1, k.n - 1, k.n // 2, k.n // 2 + 1] + [rng.randrange(k.n) for _ in range(4)]
    assert k.lam == ref.lam
    assert [k.to_signed(m) for m in ms] == [ref.to_signed(m) for m in ms]
    c = k.public.encrypt(12345)
    assert k.public.scalar_mul(c, 7) == ref.public.scalar_mul(c, 7)
    assert ref.decrypt(k.public.scalar_mul(c, 7)) == 7 * 12345
    fast = [k.public.encrypt_fast(-m) for m in (5, 6)]
    assert [ref.decrypt_signed(x) for x in fast] == [-5, -6]
    assert k.decrypt(k.public.blind_fast()) == 0
    assert k.decrypt_batch(fast) == [ref.decrypt(x) for x in fast]


def test_decrypt_batch_refuses_every_backend():
    cts = [KEYS.psse.public.encrypt(m) for m in (1, 2)]
    for be in (get_backend("cpu"), CudaBackend(device="cpu")):
        with pytest.raises(ValueError, match="public-parameter"):
            KEYS.psse.decrypt_batch(cts, backend=be, min_batch=1)
    with pytest.raises(ValueError, match="public-parameter"):
        KEYS.psse.decrypt_batch(cts, backend=object(), min_batch=1)


def test_decrypt_rows_refuses_an_unknown_handle():
    """The provider takes any `secret_backend`, as the reference's does;
    one that is not a Sanctum handle raises at `decrypt_rows`, in
    `decrypt_batch`, once the batch reaches `min_batch`."""
    provider = HomoProvider(KEYS, secret_backend=object())
    rows = [[provider.encrypt(i, "PSSE")] for i in range(4)]
    assert provider.decrypt_rows(rows, 1, ["PSSE"], min_batch=64) == [[i] for i in range(4)]
    with pytest.raises(ValueError, match="public-parameter"):
        provider.decrypt_rows(rows, 1, ["PSSE"], min_batch=4)


# ------------------------------------------------------------- key interop

VALUES = {"OPE": 4242, "CHE": "alice", "LSE": "bob", "PSSE": -31337, "MSE": 77,
          "None": "blob-1"}


def test_keys_cross_between_packages_and_decrypt_each_other():
    ref_keys = RefKeys.generate(512, 512)
    blob = ref_keys.to_json()
    port_keys = convert.keys_from_reference(blob)
    assert convert.keys_to_reference(port_keys) == blob
    assert RefKeys.from_json(convert.keys_to_reference(port_keys)) == ref_keys
    port, ref = HomoProvider(port_keys), RefProvider(ref_keys)
    for tag, v in VALUES.items():
        assert ref.decrypt(port.encrypt(v, tag), tag) == v, tag
        assert port.decrypt(ref.encrypt(v, tag), tag) == v, tag


def _mutations():
    def edit(fn):
        def apply(d):
            fn(d)
            return d
        return apply

    return {
        "missing scheme": edit(lambda d: d.pop("LSE")),
        "extra field": edit(lambda d: d["OPE"].update(extra="AA==")),
        "bad hex": edit(lambda d: d["PSSE"].update(n="0xZZ")),
        "n != p*q": edit(lambda d: d["PSSE"].update(n=hex(int(d["PSSE"]["n"], 16) + 2))),
        "short key": edit(lambda d: d["CHE"].update(k_mac="AAAA")),
        "not base64": edit(lambda d: d["None"].update(key="!!!")),
        "int field": edit(lambda d: d["MSE"].update(e=65537)),
        "wrong d": edit(lambda d: d["MSE"].update(d=hex(int(d["MSE"]["d"], 16) + 2))),
    }


@pytest.mark.parametrize("name", sorted(_mutations()))
def test_key_json_is_validated_field_by_field(name):
    d = json.loads(KEYS.to_json())
    bad = json.dumps(_mutations()[name](d))
    with pytest.raises(ValueError):
        convert.keys_from_reference(bad)


# ---------------------------------------------------------- load_provider

def _client_cfg(**client) -> DDSConfig:
    cfg = DDSConfig()
    cfg.client.paillier_bits, cfg.client.rsa_bits = 512, 512
    for k, v in client.items():
        setattr(cfg.client, k, v)
    return cfg


def test_load_provider_keys_file_inline_blob_and_bulk_backend(tmp_path, monkeypatch):
    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    path = tmp_path / "keys" / "he.json"
    first = load_provider(_client_cfg(he_keys_path=str(path)))
    assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
    again = load_provider(_client_cfg(he_keys_path=str(path)))
    assert again.keys == first.keys and first.bulk_backend is None
    inline = load_provider(_client_cfg(he_keys_path=str(path),
                                       he_keys_inline=KEYS.to_json(),
                                       bulk_encrypt_backend="cuda", device="cpu",
                                       fast_blinding=False))
    assert inline.keys == KEYS and not inline.fast_blinding
    assert isinstance(inline.bulk_backend, CudaBackend)
    assert str(inline.bulk_backend.device) == "cpu"
    assert type(load_provider(_client_cfg(bulk_encrypt_backend="cpu")).bulk_backend
                ).__name__ == "CpuBackend"


def test_load_provider_refuses_the_secret_device_opt_in(monkeypatch):
    """The opt-in (`[crypto] secret-device` or DDS_SECRET_DEVICE) gives the
    provider a device-posture Sanctum handle on `[client] device`; it is
    refused when that device is `cuda` on a host without a card, when the
    config value is not a boolean, and when the variable is unknown."""
    from dds_tpu_torch.sanctum import is_secret_backend

    cfg = _client_cfg(he_keys_inline=KEYS.to_json(), device="cpu")
    cfg.crypto.secret_device = True
    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    handle = load_provider(cfg).secret_backend
    assert is_secret_backend(handle) and handle.device.type == "cpu"
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    cfg.client.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_provider(cfg)
    cfg.crypto.secret_device = "yes"
    with pytest.raises(ValueError, match="secret-device must be a boolean"):
        load_provider(cfg)
    cfg.crypto.secret_device = False
    cfg.client.device = "cpu"
    assert load_provider(cfg).secret_backend is None
    monkeypatch.setenv("DDS_SECRET_DEVICE", "on")
    assert is_secret_backend(load_provider(cfg).secret_backend)
    monkeypatch.setenv("DDS_SECRET_DEVICE", "maybe")
    with pytest.raises(ValueError, match="DDS_SECRET_DEVICE"):
        load_provider(cfg)


# ------------------------------------------------------------------ client

@pytest.mark.parametrize("instr,route", [
    (I.MultAll(3), "MultAll"), (I.SearchEq(1, "x"), "SearchEq"),
    (I.OrderLS(0), "OrderLS"), (I.WriteElem("x", 9), "WriteElement"),
    (I.ReadElem(2), "ReadElement"), (I.Sum(2), "Sum"),
])
def test_client_refuses_unported_routes(instr, route):
    """No route is left unported: each of these instructions, refused
    before its route was ported, now goes to that route; what the client
    refuses is an object that is not an instruction, counted as failed."""
    client = DDSHttpClient(HomoProvider(KEYS), ClientConfig(proxies=["127.0.0.1:9"]))
    client.stored_keys.append("k")
    sent = []

    async def request(method, target, obj=None):
        sent.append((method, target))
        return 200, b"{}"

    client._request = request
    assert asyncio.run(client._one(instr)) == 200
    assert [t.split("?")[0].split("/")[1] for _, t in sent] == [route]
    with pytest.raises(ValueError, match="unknown instruction"):
        asyncio.run(client._one(route))
    report = asyncio.run(client.execute(I.Digest([route])))
    assert (report.operations, report.failed, report.succeeded) == (1, 1, 0)


def test_client_blacklists_a_dead_proxy_after_three_strikes():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"  # closed when the block ends
    client = DDSHttpClient(HomoProvider(KEYS), ClientConfig(proxies=[dead],
                                                             request_timeout=2.0))
    for _ in range(3):
        with pytest.raises(OSError):
            asyncio.run(client._request("GET", "/GetSet/x"))
    assert client.proxies.get_untrusted() == [dead]


def test_digest_rows_are_put_concurrency_rows():
    """chip_smoke's copy of the benchmark's row generator, row for row."""
    import chip_smoke

    for seed in (0, 3):
        ours, ref = chip_smoke.make_digest(20, seed), ref_make_digest(20, seed)
        assert [i.set for i in ours.payload] == [i.set for i in ref.payload]


def test_chip_smoke_mixes_are_the_reference_mixes():
    """chip_smoke's copies of benchmarks/mixed.py's MIX and of
    configs/default.toml's [client.proportions]."""
    import tomllib
    from pathlib import Path

    import chip_smoke
    from benchmarks.mixed import MIX

    toml = Path(__file__).resolve().parent.parent / "configs" / "default.toml"
    assert chip_smoke.MIXED_MIX == MIX
    assert chip_smoke.DEFAULT_TOML_MIX == tomllib.loads(toml.read_text())["client"]["proportions"]


def _port_digest(n_ops: int, seed: int) -> I.Digest:
    return I.Digest([I.PutSet(list(i.set)) for i in ref_make_digest(n_ops, seed).payload])


async def _sumall(request, port, nsqr) -> int:
    status, body = await request("127.0.0.1", port, "GET",
                                 f"/SumAll?position={PSSE_POS}&nsqr={nsqr}")
    assert status == 200
    return int(json.loads(body)["result"])


def test_client_slice_bulk_encrypts_and_sums_like_the_reference():
    """2 clients x 64 PutSets through the port with the cuda bulk backend on
    the CPU (one pre-pass per client, every PSSE ciphertext with its own
    obfuscator), SumAll decrypting to the total; the same digests through
    `dds_tpu.run` with the keys carried across give the same total."""
    C, ops = 2, 64
    total = sum(i.set[PSSE_POS] for s in range(C) for i in ref_make_digest(ops, s).payload)
    nsqr = KEYS.psse.public.nsquare

    async def port_run():
        cfg = _client_cfg(he_keys_inline=KEYS.to_json(), bulk_encrypt_backend="cuda",
                          device="cpu")
        cfg.proxy.device = "cpu"
        cfg.proxy.min_device_batch = 0
        provider = load_provider(cfg)
        dep = await launch(cfg)
        try:
            port = dep.server.cfg.port
            clients = [DDSHttpClient(provider, ClientConfig(proxies=[f"127.0.0.1:{port}"]),
                                     rng=random.Random(i)) for i in range(C)]
            tracer.reset()
            reports = await asyncio.gather(
                *(c.execute(_port_digest(ops, s)) for s, c in enumerate(clients)))
            spans = _pow_spans()
            result = await _sumall(http_request, port, nsqr)
            stored = []
            for key in (k for c in clients for k in c.stored_keys):
                status, body = await http_request("127.0.0.1", port, "GET", f"/GetSet/{key}")
                assert status == 200
                stored.append(json.loads(body)["contents"][PSSE_POS])
        finally:
            await dep.stop()
        return provider, reports, spans, result, stored

    async def ref_run():
        rcfg = RefConfig()
        rcfg.replicas.endpoints = [f"replica-{i}" for i in range(4)]
        rcfg.replicas.sentinent = []
        rcfg.replicas.byz_quorum_size = 3
        rcfg.replicas.byz_max_faults = 1
        rcfg.recovery.enabled = False
        rcfg.proxy.port = 0
        rcfg.proxy.crypto_backend = "cpu"
        rcfg.client.he_keys_inline = convert.keys_to_reference(KEYS)
        rcfg.client.bulk_encrypt_backend = "cpu"
        provider = ref_load_provider(rcfg)
        rdep = await ref_launch(rcfg)
        try:
            port = rdep.server.cfg.port
            clients = [RefClient(provider, RefClientConfig(proxies=[f"127.0.0.1:{port}"]),
                                 rng=random.Random(i)) for i in range(C)]
            reports = await asyncio.gather(
                *(c.execute(ref_make_digest(ops, s)) for s, c in enumerate(clients)))
            from dds_tpu.http.miniserver import http_request as ref_http

            result = await _sumall(ref_http, port, nsqr)
        finally:
            await rdep.stop()
        return provider, reports, result

    provider, reports, spans, result, stored = asyncio.run(port_run())
    assert [(r.operations, r.succeeded) for r in reports] == [(ops, ops)] * C
    assert sorted(e.meta["b"] for e in spans) == [ops] * C  # one pre-pass each
    assert provider._blind_pool == []
    assert len(set(stored)) == C * ops  # no obfuscator served twice
    assert KEYS.psse.decrypt(result) == total

    ref_provider, ref_reports, ref_result = asyncio.run(ref_run())
    assert [(r.operations, r.succeeded) for r in ref_reports] == [(ops, ops)] * C
    assert ref_provider.keys.psse.decrypt(ref_result) == KEYS.psse.decrypt(result) == total
    assert ref_provider.keys.psse.decrypt(result) == total
