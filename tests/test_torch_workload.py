"""`run_workload` on the port's stack against the reference's.

Both packages boot the 4-replica north-star topology (as
tests/test_torch_slice.py boots them) and run `run_workload` with one seed,
two concurrent clients and keys carried across with
`convert.keys_to_reference` (the 512-bit Paillier bench key, RSA-1024):
first `configs/default.toml`'s proportions (PutSet, GetSet, Sum, SumAll,
MultAll, SearchEq, SearchGt, OrderLS; its SearchEntry share needs an LSE
column, which the canonical schema lacks), then a mix of the element
routes, Mult, SearchNEq, the remaining comparisons and OrderSL. Each
client's digest must hold the same instructions in both packages, the
reports the same operation counts, and no operation may fail on either
stack. The port folds on `CudaBackend(device="cpu", min_device_batch=0)`:
SumAll in its n^2 pool (L = 32 here) and MultAll in its RSA-1024 pool
(L = 64). The tests wait on completed requests, never on timing. Also the
`[client]` workload settings against the reference's.
"""

import asyncio
import dataclasses
import tomllib
from pathlib import Path

import pytest

from dds_tpu import run as ref_run
from dds_tpu.clt.client import DDSHttpClient as RefClient
from dds_tpu.models.facade import HomoProvider as RefProvider
from dds_tpu.models.keys import HEKeys as RefKeys
from dds_tpu.utils.config import DDSConfig as RefConfig
from dds_tpu_torch import convert
from dds_tpu_torch import run as port_run
from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.clt.client import DDSHttpClient
from dds_tpu_torch.models.facade import HomoProvider
from dds_tpu_torch.models.keys import HEKeys
from dds_tpu_torch.ops.montgomery import ModCtx
from dds_tpu_torch.utils.config import DDSConfig

ROOT = Path(__file__).resolve().parent.parent
MIXES = {
    "default.toml": tomllib.loads((ROOT / "configs" / "default.toml").read_text())
    ["client"]["proportions"],
    "elements": {"put-set": 0.3, "remove-set": 0.05, "add-element": 0.05,
                 "read-element": 0.1, "write-element": 0.1, "is-element": 0.1,
                 "mult": 0.1, "search-neq": 0.05, "search-gteq": 0.05, "search-lt": 0.05,
                 "search-lteq": 0.05, "order-sl": 0.05, "sum-all": 0.05},
}


@pytest.fixture(scope="module")
def keys():
    return dataclasses.replace(HEKeys.generate(512, 1024), psse=bench_paillier_key(512))


def _record_digests(monkeypatch, cls) -> list:
    seen = []
    execute = cls.execute

    async def spy(self, digest):
        seen.append([(type(i).__name__, dataclasses.astuple(i)) for i in digest.payload])
        return await execute(self, digest)

    monkeypatch.setattr(cls, "execute", spy)
    return seen


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_run_workload_matches_the_reference(monkeypatch, keys, mix):
    ops, clients, seed = 40, 2, 11
    port_digests = _record_digests(monkeypatch, DDSHttpClient)
    ref_digests = _record_digests(monkeypatch, RefClient)

    async def port():
        cfg = DDSConfig()
        cfg.proxy.device = "cpu"
        cfg.proxy.min_device_batch = 0
        cfg.client.nr_of_operations, cfg.client.nr_of_local_clients = ops, clients
        cfg.client.proportions = dict(MIXES[mix])
        dep = await port_run.launch(cfg)
        try:
            reports = await port_run.run_workload(dep, HomoProvider(keys), seed=seed)
            stores = {m: s._ctx.L for m, s in dep.server.backend._stores.items()}
        finally:
            await dep.stop()
        return reports, stores

    async def ref():
        rcfg = RefConfig()
        rcfg.replicas.endpoints = [f"replica-{i}" for i in range(4)]
        rcfg.replicas.sentinent = []
        rcfg.replicas.byz_quorum_size = 3
        rcfg.replicas.byz_max_faults = 1
        rcfg.recovery.enabled = False
        rcfg.proxy.port = 0
        rcfg.proxy.crypto_backend = "cpu"
        rcfg.client.nr_of_operations, rcfg.client.nr_of_local_clients = ops, clients
        rcfg.client.proportions = dict(MIXES[mix])
        provider = RefProvider(RefKeys.from_json(convert.keys_to_reference(keys)))
        rdep = await ref_run.launch(rcfg)
        try:
            return await ref_run.run_workload(rdep, provider, seed=seed)
        finally:
            await rdep.stop()

    reports, stores = asyncio.run(port())
    ref_reports = asyncio.run(ref())
    assert len(port_digests) == len(ref_digests) == clients
    assert port_digests == ref_digests
    assert [r.operations for r in reports] == [r.operations for r in ref_reports]
    assert [r.operations for r in reports] == [len(d) for d in port_digests]
    assert all(r.failed == 0 for r in reports), [vars(r) for r in reports]
    assert all(r.failed == 0 for r in ref_reports), [vars(r) for r in ref_reports]
    kinds = {k for d in port_digests for k, _ in d}
    if mix == "default.toml":
        assert {"SumAll", "MultAll", "Sum", "OrderLS", "SearchEq"} <= kinds
        # MultAll folded mod the RSA-1024 n in its own pool, at L = 64
        assert stores == {keys.psse.public.nsquare: ModCtx.make(keys.psse.public.nsquare).L,
                          keys.mse.n: 64}
    else:
        assert {"RemoveSet", "WriteElem", "ReadElem", "IsElement", "Mult"} <= kinds


def test_client_config_has_the_reference_workload_defaults():
    """`[client]`'s workload keys and `[client.data-table]` parse from the
    reference's TOML spelling with the reference's defaults; an unknown key
    still raises."""
    ref, port = RefConfig().client, DDSConfig().client
    for name in ("nr_of_local_clients", "nr_of_operations", "failed_contact_attempts_threshold",
                 "http_requests_timeout", "proportions"):
        assert getattr(port, name) == getattr(ref, name), name
    assert dataclasses.asdict(port.data_table) == dataclasses.asdict(ref.data_table)
    section = {"nr-of-local-clients": 4, "nr-of-operations": 7,
               "proportions": MIXES["default.toml"],
               "data-table": {"max-nr-of-columns": 12, "fixed-nr-of-columns": 8}}
    cfg = DDSConfig.from_dict({"client": section})
    rcfg = RefConfig.from_dict({"client": section})
    assert cfg.client.nr_of_local_clients == rcfg.client.nr_of_local_clients == 4
    assert cfg.client.proportions == rcfg.client.proportions
    assert cfg.client.data_table.max_nr_of_columns == rcfg.client.data_table.max_nr_of_columns
    for bad in ({"client": {"nr-of-clients": 2}}, {"client": {"data-table": {"width": 3}}}):
        with pytest.raises(ValueError, match="unknown config key"):
            DDSConfig.from_dict(bad)


def test_failed_contact_attempts_threshold_accepts_only_the_reference_default():
    """No client of either package reads `failed-contact-attempts-threshold`:
    the port parses the reference's default and refuses any other value
    rather than silently running without it."""
    assert RefConfig().client.failed_contact_attempts_threshold == 3
    cfg = DDSConfig.from_dict({"client": {"failed-contact-attempts-threshold": 3}})
    assert cfg.client.failed_contact_attempts_threshold == 3
    for bad in (0, 5):
        with pytest.raises(ValueError, match="failed-contact-attempts-threshold"):
            DDSConfig.from_dict({"client": {"failed-contact-attempts-threshold": bad}})
