"""Benchmark HTTP client: executes instruction digests with client-side HE.

Trimmed copy of `dds_tpu/clt/client.py`, the counterpart of
`clt/DDSHttpClient.scala`: one client holds the HE keys (`HomoProvider`),
load-balances over proxies at random with 3-strike blacklisting
(`:354-406`), encrypts every value before it leaves the process
(`:158-352`), remembers the SHA-512 record keys the proxies return
(`:103-115`), accepts 404s for randomly-targeted keys (`:108`), and reports
wall time + ops/s at the end (`:410-415`).

With a provider bulk backend, `execute` first precomputes every
full-width PSSE obfuscator the digest needs in one batched modexp (on
`cuda`: the exp kernel). Every instruction of `clt/instructions.py` goes
to its route of the proxy, encrypted as the reference encrypts it; an
object that is not an instruction raises ValueError (counted as a failed
operation).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import time
from dataclasses import dataclass, field

from dds_tpu_torch.clt import instructions as I
from dds_tpu_torch.http.miniserver import http_request
from dds_tpu_torch.models.facade import DEFAULT_SCHEMA, HomoProvider
from dds_tpu_torch.utils.trust import TrustedNodesList

log = logging.getLogger("dds.client")

@dataclass
class ClientConfig:
    proxies: list[str] = field(default_factory=lambda: ["127.0.0.1:8443"])
    request_timeout: float = 10.0
    fixed_columns: int = 8
    schema: list[str] = field(default_factory=lambda: list(DEFAULT_SCHEMA))
    ssl_context: object = None  # HTTPS (mutual TLS) to the proxies


@dataclass
class RunReport:
    operations: int = 0
    succeeded: int = 0
    not_found: int = 0
    failed: int = 0
    wall_seconds: float = 0.0

    @property
    def ops_per_second(self) -> float:
        return self.operations / self.wall_seconds if self.wall_seconds else 0.0


class DDSHttpClient:
    def __init__(self, provider: HomoProvider, config: ClientConfig | None = None,
                 rng: random.Random | None = None):
        self.provider = provider
        self.cfg = config or ClientConfig()
        self.proxies = TrustedNodesList(self.cfg.proxies, rng)
        self.stored_keys: list[str] = []
        self._rng = rng or random.Random()

    # ------------------------------------------------------------ transport

    async def _request(self, method: str, target: str, obj=None) -> tuple[int, bytes]:
        body = json.dumps(obj).encode() if obj is not None else None
        last_exc: Exception | None = None
        for _ in range(max(1, len(self.proxies.get_trusted()))):
            proxy = self.proxies.defer_to()
            host, _, port = proxy.partition(":")
            try:
                return await http_request(
                    host, int(port), method, target, body,
                    ssl_context=self.cfg.ssl_context,
                    timeout=self.cfg.request_timeout,
                )
            except (OSError, asyncio.TimeoutError) as e:
                # 3 strikes blacklists the proxy (DDSHttpClient.scala:377-398)
                self.proxies.increment_suspicion(proxy)
                last_exc = e
        raise last_exc if last_exc else RuntimeError("no proxies")

    def _random_key(self) -> str | None:
        return self._rng.choice(self.stored_keys) if self.stored_keys else None

    # ------------------------------------------------------------ execution

    def _psse_encrypts_in(self, digest: I.Digest) -> int:
        """How many PSSE encryptions executing `digest` will perform: one
        per PutSet row column whose schema slot is PSSE (the bulk of
        client-side HE cost; reference hot loop SJHomoLibProvider.scala:
        74-86)."""
        psse_cols = [
            i for i, s in enumerate(self.cfg.schema[: self.cfg.fixed_columns])
            if s == "PSSE"
        ]
        count = 0
        for instr in digest.payload:
            if isinstance(instr, I.PutSet) and instr.set is not None:
                count += sum(1 for i in psse_cols if i < len(instr.set))
        return count

    async def execute(self, digest: I.Digest) -> RunReport:
        # bulk-encryption pre-pass: with a provider bulk backend, one batched
        # modexp precomputes every full-width obfuscator this digest needs.
        # On a worker thread: in a single-process deployment this event loop
        # also serves the proxy and replicas, which must not stall.
        if self.provider.bulk_backend is not None:
            count = self._psse_encrypts_in(digest)
            if count:
                await asyncio.to_thread(self.provider.precompute_psse_blinds, count)
        report = RunReport()
        t0 = time.perf_counter()
        for instr in digest.payload:
            report.operations += 1
            try:
                status = await self._one(instr)
                if status in (200, 204):
                    report.succeeded += 1
                elif status == 404:
                    report.not_found += 1  # accepted outcome for random keys
                else:
                    report.failed += 1
            except Exception:
                log.exception("instruction failed: %r", instr)
                report.failed += 1
        report.wall_seconds = time.perf_counter() - t0
        log.info(
            "executed %d ops in %.2fs -> %.1f ops/s (%d ok, %d miss, %d failed)",
            report.operations, report.wall_seconds, report.ops_per_second,
            report.succeeded, report.not_found, report.failed,
        )
        return report

    async def _one(self, instr) -> int:
        p, cfg = self.provider, self.cfg
        enc_pos = lambda v, pos: p.encrypt(
            v, cfg.schema[pos] if pos < cfg.fixed_columns else "None"
        )
        psse_nsqr = p.keys.psse.public.nsquare
        mse_n = p.keys.mse.n
        key = self._random_key()  # drawn for every instruction, as the reference does

        match instr:
            case I.PutSet(None):
                status, body = await self._request("POST", "/PutSet")
                if status == 200:
                    self.stored_keys.append(body.decode())
                return status
            case I.PutSet(row):
                enc = p.encrypt_row(row, cfg.fixed_columns, cfg.schema)
                status, body = await self._request("POST", "/PutSet", {"contents": enc})
                if status == 200:
                    self.stored_keys.append(body.decode())
                return status
            case I.GetSet():
                if key is None:
                    return 404
                status, _ = await self._request("GET", f"/GetSet/{key}")
                return status
            case I.RemoveSet():
                if key is None:
                    return 404
                status, _ = await self._request("DELETE", f"/RemoveSet/{key}")
                if status == 200 and key in self.stored_keys:
                    self.stored_keys.remove(key)
                return status
            case I.AddElement(elem):
                if key is None:
                    return 404
                status, _ = await self._request(
                    "PUT", f"/AddElement/{key}", {"value": p.encrypt(elem, "None")}
                )
                return status
            case I.WriteElem(elem, pos):
                if key is None:
                    return 404
                status, _ = await self._request(
                    "PUT", f"/WriteElement/{key}?position={pos}",
                    {"value": enc_pos(elem, pos)},
                )
                return status
            case I.ReadElem(pos):
                if key is None:
                    return 404
                status, _ = await self._request("GET", f"/ReadElement/{key}?position={pos}")
                return status
            case I.IsElement(elem):
                if key is None:
                    return 404
                status, _ = await self._request(
                    "POST", f"/IsElement/{key}", {"value": p.encrypt(elem, "CHE")}
                )
                return status
            case I.Sum(pos):
                k1, k2 = self._random_key(), self._random_key()
                if k1 is None or k2 is None:
                    return 404
                status, _ = await self._request(
                    "GET", f"/Sum?key1={k1}&key2={k2}&position={pos}&nsqr={psse_nsqr}"
                )
                return status
            case I.SumAll(pos):
                status, _ = await self._request(
                    "GET", f"/SumAll?position={pos}&nsqr={psse_nsqr}"
                )
                return status
            case I.Mult(pos):
                k1, k2 = self._random_key(), self._random_key()
                if k1 is None or k2 is None:
                    return 404
                status, _ = await self._request(
                    "GET", f"/Mult?key1={k1}&key2={k2}&position={pos}&pubkey={mse_n}"
                )
                return status
            case I.MultAll(pos):
                status, _ = await self._request(
                    "GET", f"/MultAll?position={pos}&pubkey={mse_n}"
                )
                return status
            case I.SearchEq(pos, elem) | I.SearchNEq(pos, elem):
                route = "SearchEq" if isinstance(instr, I.SearchEq) else "SearchNEq"
                status, _ = await self._request(
                    "POST", f"/{route}?position={pos}", {"value": enc_pos(elem, pos)}
                )
                return status
            case (
                I.SearchGt(pos, elem)
                | I.SearchGtEq(pos, elem)
                | I.SearchLt(pos, elem)
                | I.SearchLtEq(pos, elem)
            ):
                route = type(instr).__name__
                status, _ = await self._request(
                    "POST",
                    f"/{route}?position={pos}",
                    {"value": p.encrypt(int(elem), "OPE")},
                )
                return status
            case I.SearchEntry(elem):
                status, _ = await self._request(
                    "POST", "/SearchEntry", {"value": p.encrypt(elem, "LSE")}
                )
                return status
            case I.SearchEntryOR(e1, e2, e3) | I.SearchEntryAND(e1, e2, e3):
                route = (
                    "SearchEntryOR" if isinstance(instr, I.SearchEntryOR) else "SearchEntryAND"
                )
                status, _ = await self._request(
                    "POST",
                    f"/{route}",
                    {
                        "value1": p.encrypt(e1, "LSE"),
                        "value2": p.encrypt(e2, "LSE"),
                        "value3": p.encrypt(e3, "LSE"),
                    },
                )
                return status
            case I.OrderLS(pos) | I.OrderSL(pos):
                route = "OrderLS" if isinstance(instr, I.OrderLS) else "OrderSL"
                status, _ = await self._request("GET", f"/{route}?position={pos}")
                return status
        raise ValueError(f"unknown instruction {instr!r}")
