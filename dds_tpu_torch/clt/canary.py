"""Heliograph's golden transactions: the client half of the canary plane.

Copy of `dds_tpu/clt/canary.py`; the port serves no TLS, so the client
takes no `ssl_context`.

A `CanaryClient` owns a private crypto domain (its own small-key
`HomoProvider` — the prober measures the PIPE, not the modmul kernel) and
a known plaintext population of canonical 8-column rows stored under the
reserved `__heliograph__` tenant. Every probe drives a REAL route through
the REST edge — the same HTTP parser, tenant clamp, admission carve-out,
quorum client, and fold/search/analytics planes user traffic takes — and
then verifies the answer *by decrypting it*:

- ``putget``: PutSet one population row (content-addressed: the returned
  key must equal the known key) -> GetSet read-your-write -> decrypt_row
  and compare column-for-column against the known plaintext;
- ``sum`` / ``mult``: SumAll over the PSSE column / MultAll over the MSE
  column -> decrypt and compare against the population's known sum /
  product — a wrong-but-well-MAC'd ciphertext fails HERE, where no
  passive integrity check can see it;
- ``search``: one Spyglass SearchEq on the deterministic CHE column ->
  the matching canary key (and only it) must come back;
- ``matvec``: one Prism MatVec with a known weight matrix -> decrypt each
  output and compare against the dot products recomputed over the
  response's own key order.

The exact-value checks are sound because canary visibility is
ownership-scoped at the server (http/server.py `_tenant_pairs`): a canary
aggregate folds exactly the canary population, with or without Bastion
tenancy enabled — and, symmetrically, canary rows never appear in any
user-facing aggregate, search, or analytics result.

Probes return a `ProbeCheck`; classification into ok / slow / wrong-answer
/ unreachable (deadlines, latency thresholds, scheduling) lives in
obs/heliograph.py. Network-level failures propagate as exceptions — the
prober's deadline wrapper turns them into `unreachable` verdicts. The
probes' folds cover `population` rows, below the backend's
`min_device_batch`, so they run on the host in both packages: the canary
measures the pipe, not the fold kernels.
"""

from __future__ import annotations

import asyncio
import json
import secrets
from dataclasses import dataclass, field

from dds_tpu_torch.core.tenant import CANARY_TENANT
from dds_tpu_torch.http.miniserver import http_request
from dds_tpu_torch.models._symmetric import aes_available
from dds_tpu_torch.models.facade import DEFAULT_SCHEMA, HomoProvider
from dds_tpu_torch.obs import context as obs_context

__all__ = [
    "CanaryTarget", "ProbeCheck", "CanaryClient", "PROBE_KINDS",
    "parse_canary_targets",
]

PROBE_KINDS = ("putget", "sum", "mult", "search", "matvec")

# canonical column positions in DEFAULT_SCHEMA
_OPE_POS, _CHE_POS, _PSSE_POS, _MSE_POS = 0, 1, 2, 3
_FIXED_COLUMNS = 8


@dataclass(frozen=True)
class CanaryTarget:
    """One proxy edge the prober drives golden transactions against."""

    host: str
    port: int
    region: str = ""

    @property
    def label(self) -> str:
        return f"{self.host}:{self.port}"


def parse_canary_targets(entries) -> tuple[list[CanaryTarget], list[str]]:
    """Configured `[heliograph].targets` entries ("host:port" or
    "region=host:port") into CanaryTargets. Returns (targets, malformed)
    so call sites can warn about skipped entries without this module
    taking a logging dependency."""
    out: list[CanaryTarget] = []
    bad: list[str] = []
    for entry in entries or []:
        region, _, hp = str(entry).rpartition("=")
        h, _, p = hp.rpartition(":")
        if not h or not p.isdigit():
            bad.append(str(entry))
            continue
        out.append(CanaryTarget(h, int(p), region=region))
    return out, bad


@dataclass
class ProbeCheck:
    """One probe's verified outcome: `correct` means the decrypted answer
    matched the known plaintext expectation; `status` is the HTTP status
    of the (last) request; `detail` carries expected/observed on mismatch
    for the ledger's failure report."""

    correct: bool
    status: int
    detail: dict = field(default_factory=dict)


class CanaryClient:
    """Golden-transaction executor for one prober (see module docstring).

    `timeout` is the per-request socket budget (the prober's per-probe
    deadline also wraps the whole coroutine)."""

    def __init__(self, provider: HomoProvider, population: int = 4,
                 timeout: float = 2.0):
        self.provider = provider
        self.schema = list(DEFAULT_SCHEMA)
        if not aes_available():
            # AES-less environments (no `cryptography` package): the
            # canary domain is private and its plaintexts synthetic, so
            # the AES-backed string columns (CHE deterministic, "None"
            # randomized) degrade to the "Plain" null cipher rather than
            # killing the prober at first encrypt. Every probe kind
            # keeps working — SearchEq only compares stored bytes for
            # equality, and determinism is all that route needs.
            self.schema = ["Plain" if s in ("CHE", "None") else s
                           for s in self.schema]
        self.population = max(2, int(population))
        self.timeout = float(timeout)
        # content-addressing salt: two probers (or two runs) must never
        # collide on the same canary keys even with identical plaintexts
        self.salt = secrets.token_hex(8)
        self.rows: list[list] = [self._row(i) for i in range(self.population)]
        # server-assigned SHA-512 keys, filled by populate(); index-aligned
        # with self.rows
        self.keys: list[str] = []
        # the population's ciphertexts, frozen at populate(): PSSE/MSE/
        # RND encryption is randomized, so re-encrypting the same
        # plaintext would content-address to a DIFFERENT key — probes
        # re-put these exact bytes to make the write idempotent
        self.enc_rows: list[list] = []
        self.expected_sum = sum(r[_PSSE_POS] for r in self.rows)
        self.expected_product = 1
        for r in self.rows:
            self.expected_product *= r[_MSE_POS]

    # ------------------------------------------------------------ plaintext

    def _row(self, i: int) -> list:
        """Known plaintext row i. Values are small and distinct so sum /
        product / per-column mismatches are attributable; the salted blob
        column keeps the content-addressed keys unique per prober."""
        return [
            100 + i,                     # OPE
            f"canary-{i}",               # CHE (deterministic: SearchEq target)
            10 + i,                      # PSSE (SumAll ground truth)
            2 + (i % 2),                 # MSE (MultAll ground truth)
            "probe", "of", "light",      # CHE x3
            f"beam-{i}-{self.salt}",     # None (salt -> unique content key)
        ]

    # ----------------------------------------------------------------- wire

    async def _request(self, target: CanaryTarget, method: str, route: str,
                       payload: dict | None = None,
                       trace_id: str | None = None) -> tuple[int, bytes]:
        """One canary HTTP request: the real wire path, tagged with the
        canary tenant and an explicit trace id so every probe's span tree
        is findable from its ledger exemplar."""
        headers = {"x-dds-tenant": CANARY_TENANT}
        if trace_id is not None:
            headers["x-dds-trace"] = trace_id
        body = json.dumps(payload).encode() if payload is not None else None
        return await http_request(
            target.host, target.port, method, route, body,
            timeout=self.timeout, headers=headers,
        )

    @staticmethod
    def mint_trace() -> str:
        """A fresh trace id for one probe (the exemplar the ledger keeps)."""
        return obs_context.new_id()

    # --------------------------------------------------------------- probes

    async def populate(self, target: CanaryTarget,
                       trace_id: str | None = None) -> None:
        """Store the full known population and freeze its ciphertexts
        (idempotent thereafter: content addressing maps identical
        ciphertexts to identical keys, and the canary tenant owns them).
        Fills `self.keys` / `self.enc_rows`."""
        enc_rows = [
            self.provider.encrypt_row(row, _FIXED_COLUMNS, self.schema)
            for row in self.rows
        ]
        keys = []
        for enc in enc_rows:
            status, body = await self._request(
                target, "POST", "/PutSet", {"contents": enc}, trace_id
            )
            if status != 200:
                raise RuntimeError(f"canary populate PutSet -> {status}")
            keys.append(body.decode())
        self.keys = keys
        self.enc_rows = enc_rows

    async def probe_putget(self, target: CanaryTarget, trace_id: str,
                           cycle: int = 0) -> ProbeCheck:
        """PutSet -> quorum write -> GetSet read-your-write -> decrypt and
        compare. Rotates through the population so every canary key takes
        a fresh quorum write + verified read over `population` cycles."""
        i = cycle % self.population
        row = self.rows[i]
        enc = (self.enc_rows[i] if self.enc_rows
               else self.provider.encrypt_row(row, _FIXED_COLUMNS,
                                              self.schema))
        status, body = await self._request(
            target, "POST", "/PutSet", {"contents": enc}, trace_id
        )
        if status != 200:
            return ProbeCheck(False, status, {"phase": "put"})
        key = body.decode()
        if self.keys and key != self.keys[i]:
            return ProbeCheck(
                False, status,
                {"phase": "put", "expected": self.keys[i], "observed": key},
            )
        status, body = await self._request(
            target, "GET", f"/GetSet/{key}", None, trace_id
        )
        if status != 200:
            return ProbeCheck(False, status, {"phase": "get", "key": key})
        contents = json.loads(body.decode()).get("contents")
        try:
            plain = self.provider.decrypt_row(
                contents, _FIXED_COLUMNS, self.schema
            )
        except Exception as e:
            return ProbeCheck(
                False, status, {"phase": "decrypt", "key": key, "error": str(e)}
            )
        if plain != row:
            return ProbeCheck(
                False, status,
                {"phase": "verify", "key": key,
                 "expected": row, "observed": plain},
            )
        return ProbeCheck(True, status, {"key": key})

    async def probe_sum(self, target: CanaryTarget,
                        trace_id: str) -> ProbeCheck:
        """SumAll over the PSSE column, decrypted and compared against the
        population's known sum — the decrypt-and-verify check that catches
        a wrong-but-well-MAC'd ciphertext."""
        nsqr = self.provider.keys.psse.public.nsquare
        status, body = await self._request(
            target, "GET", f"/SumAll?position={_PSSE_POS}&nsqr={nsqr}",
            None, trace_id,
        )
        if status != 200:
            return ProbeCheck(False, status, {})
        cipher = json.loads(body.decode()).get("result")
        try:
            observed = self.provider.decrypt(cipher, "PSSE")
        except Exception as e:
            return ProbeCheck(False, status, {"phase": "decrypt",
                                              "error": str(e)})
        if observed != self.expected_sum:
            return ProbeCheck(
                False, status,
                {"expected": self.expected_sum, "observed": observed},
            )
        return ProbeCheck(True, status, {})

    async def probe_mult(self, target: CanaryTarget,
                         trace_id: str) -> ProbeCheck:
        """MultAll over the MSE column vs the known product."""
        n = self.provider.keys.mse.n
        status, body = await self._request(
            target, "GET", f"/MultAll?position={_MSE_POS}&pubkey={n}",
            None, trace_id,
        )
        if status != 200:
            return ProbeCheck(False, status, {})
        cipher = json.loads(body.decode()).get("result")
        try:
            observed = self.provider.decrypt(cipher, "MSE")
        except Exception as e:
            return ProbeCheck(False, status, {"phase": "decrypt",
                                              "error": str(e)})
        if observed != self.expected_product:
            return ProbeCheck(
                False, status,
                {"expected": self.expected_product, "observed": observed},
            )
        return ProbeCheck(True, status, {})

    async def probe_search(self, target: CanaryTarget, trace_id: str,
                           cycle: int = 0) -> ProbeCheck:
        """One Spyglass SearchEq on the deterministic CHE column: exactly
        the matching canary key must come back (canary-scoped universe)."""
        i = cycle % self.population
        enc = self.provider.encrypt(self.rows[i][_CHE_POS],
                                    self.schema[_CHE_POS])
        status, body = await self._request(
            target, "POST", f"/SearchEq?position={_CHE_POS}", {"value": enc},
            trace_id,
        )
        if status != 200:
            return ProbeCheck(False, status, {})
        keyset = json.loads(body.decode()).get("keyset", [])
        expected = [self.keys[i]] if self.keys else None
        if expected is not None and sorted(keyset) != sorted(expected):
            return ProbeCheck(
                False, status, {"expected": expected, "observed": keyset},
            )
        return ProbeCheck(True, status, {"matches": len(keyset)})

    async def probe_matvec(self, target: CanaryTarget,
                           trace_id: str) -> ProbeCheck:
        """One Prism MatVec over the PSSE column: a known 2-row weight
        matrix, each output decrypted and compared against the dot product
        recomputed over the RESPONSE's key order (the server sorts keys;
        the prober doesn't assume which order)."""
        p = len(self.rows)
        weights = [[1] * p, [(j % 3) + 1 for j in range(p)]]
        nsqr = self.provider.keys.psse.public.nsquare
        status, body = await self._request(
            target, "POST", f"/MatVec?position={_PSSE_POS}&nsqr={nsqr}",
            {"weights": weights}, trace_id,
        )
        if status != 200:
            return ProbeCheck(False, status, {})
        obj = json.loads(body.decode())
        keys = obj.get("keys", [])
        by_key = dict(zip(self.keys, (r[_PSSE_POS] for r in self.rows)))
        if sorted(keys) != sorted(self.keys):
            return ProbeCheck(
                False, status,
                {"phase": "universe", "expected": sorted(self.keys),
                 "observed": sorted(keys)},
            )
        values = [by_key[k] for k in keys]
        for j, cipher in enumerate(obj.get("result", [])):
            try:
                observed = self.provider.decrypt(cipher, "PSSE")
            except Exception as e:
                return ProbeCheck(False, status, {"phase": "decrypt",
                                                  "row": j, "error": str(e)})
            expected = sum(w * v for w, v in zip(weights[j], values))
            if observed != expected:
                return ProbeCheck(
                    False, status,
                    {"row": j, "expected": expected, "observed": observed},
                )
        return ProbeCheck(True, status, {})

    async def probe(self, kind: str, target: CanaryTarget, trace_id: str,
                    cycle: int = 0) -> ProbeCheck:
        """Dispatch one probe kind (PROBE_KINDS member)."""
        match kind:
            case "putget":
                return await self.probe_putget(target, trace_id, cycle)
            case "sum":
                return await self.probe_sum(target, trace_id)
            case "mult":
                return await self.probe_mult(target, trace_id)
            case "search":
                return await self.probe_search(target, trace_id, cycle)
            case "matvec":
                return await self.probe_matvec(target, trace_id)
        raise ValueError(f"unknown probe kind {kind!r}")


async def build_provider(paillier_bits: int = 512,
                         rsa_bits: int = 512) -> HomoProvider:
    """Generate the canary's private crypto domain off-loop: keygen is
    hundreds of ms of host bignum work, and the prober starts inside the
    proxy's event loop."""
    return await asyncio.to_thread(
        HomoProvider.generate, paillier_bits, rsa_bits
    )
