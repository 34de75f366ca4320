"""Heliograph: the active canary plane — synthetic probes that decrypt.

Copy of `dds_tpu/obs/heliograph.py`. Helmsman reads
`unreachable_regions()` (the port has no Panopticon yet); the prober's
`ssl_context` reaches targets that serve HTTPS.
`stop()` is a coroutine here: it cancels the prober's task and awaits it,
for the proxy's `stop`.

Every other observability surface here is passive: Chronoscope profiles
traffic that happens to arrive, the SLO engine burns on served-request
ratios, Watchtower audits tag algebra over traces it is shown. A quiesced
region, a shredded-but-routable tenant, or a ciphertext-corrupting fault
that never trips an HMAC check is invisible to all of them until a real
user pays for it. Heliograph closes that gap from the OUTSIDE: a
supervised async prober per proxy (and per Meridian process) owns the
reserved `__heliograph__` tenant and continuously drives golden
transactions through the real client crypto path (clt/canary.py) —
PutSet -> quorum write -> GetSet read-your-write, SumAll/MultAll over a
known plaintext population, one Spyglass search, one Prism MatVec — and
verifies every answer by decrypting it.

Outcomes are typed (ok / slow / wrong-answer / unreachable) and land in
three places:

1. the `CanaryLedger`: bounded-cardinality `/metrics` gauges+histograms,
   the `GET /canary` report (fleet-federated by Panopticon as
   `GET /fleet/canary`), and a `/health` section that degrades to
   "stale" but never blocks; each failure carries an exemplar trace id
   linking into the Chronoscope span tree for that probe;
2. the SLO engine, as synthetic `canary.<kind>` availability streams —
   burn alerts fire on black-box evidence even at zero user load;
3. Watchtower/Helmsman: a wrong-answer verdict files a
   `canary_wrong_answer` Watchtower incident (decrypt-and-verify is the
   only check that catches a well-MAC'd wrong ciphertext), and sustained
   unreachable against one region feeds Helmsman's region_down /
   promotion signal — synthetic detection closing the self-healing loop.

Scheduling is jittered (a fleet of probers must never phase-lock into a
thundering herd), every probe carries a wall deadline, and canary
requests pass a dedicated rate-bounded admission carve-out at the edge
(http/server.py) so a wedged prober can never self-DoS the fleet.

`seed_ciphertext_corruption` is the drill fault: it flips a stored
ciphertext IN PLACE on every replica, past the transport-HMAC boundary —
replicas re-MAC their answers over the corrupted value, every passive
surface stays green, and only a probe that decrypts notices.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field

from dds_tpu_torch.clt.canary import (CanaryClient, CanaryTarget, PROBE_KINDS,
                                      build_provider)
from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.tasks import supervised_task

__all__ = [
    "VERDICTS", "ProbeResult", "CanaryLedger", "Heliograph",
    "seed_ciphertext_corruption",
]

# verdict -> gauge enum value (dds_canary_verdict); order is severity
VERDICTS = ("ok", "slow", "wrong_answer", "unreachable")

# verdict -> synthetic SLO status for the canary.<kind> streams
_SLO_STATUS = {"ok": 200, "slow": 200, "wrong_answer": 500,
               "unreachable": 503}


@dataclass
class ProbeResult:
    """One typed probe outcome as the ledger stores it."""

    kind: str
    verdict: str
    latency_s: float
    trace_id: str
    target: str = ""
    region: str = ""
    at: float = 0.0            # ledger clock timestamp
    detail: dict = field(default_factory=dict)


class CanaryLedger:
    """Typed probe results with bounded export cardinality.

    Counters (`dds_canary_probes_total{kind,verdict}`) and the latency
    histogram (`dds_canary_probe_seconds{kind}`) are written at record
    time; point-in-time state (last verdict / last-ok age per kind, the
    rotating failure exemplars) exports at scrape time via
    `export_gauges`. Label sets are bounded by construction: kind is one
    of PROBE_KINDS, verdict one of VERDICTS, and the exemplar family is
    cleared and re-set each sample so rotating trace ids never accrete."""

    def __init__(self, clock=time.monotonic, history: int = 64,
                 unreachable_streak: int = 3, registry=None):
        self._clock = clock
        self._history = int(history)
        self.unreachable_streak = max(1, int(unreachable_streak))
        self._reg = registry if registry is not None else metrics
        self._results: list[ProbeResult] = []
        self._last: dict[str, ProbeResult] = {}
        self._last_ok: dict[str, float] = {}
        self._last_failure: dict[str, ProbeResult] = {}
        self._counts: dict[tuple[str, str], int] = {}
        # region -> consecutive unreachable probes (any kind); reset by
        # any non-unreachable result from that region
        self._region_fail: dict[str, int] = {}
        self._seq = 0

    # -------------------------------------------------------------- record

    def record(self, result: ProbeResult) -> None:
        self._seq += 1
        result.at = self._clock()
        self._results.append(result)
        del self._results[:-self._history]
        self._last[result.kind] = result
        key = (result.kind, result.verdict)
        self._counts[key] = self._counts.get(key, 0) + 1
        if result.verdict in ("ok", "slow"):
            self._last_ok[result.kind] = result.at
        else:
            self._last_failure[result.kind] = result
        region = result.region
        if result.verdict == "unreachable":
            self._region_fail[region] = self._region_fail.get(region, 0) + 1
        else:
            self._region_fail[region] = 0
        self._reg.inc(
            "dds_canary_probes_total", kind=result.kind,
            verdict=result.verdict,
            help="Heliograph golden-transaction probes by typed verdict",
        )
        self._reg.observe(
            "dds_canary_probe_seconds", result.latency_s, kind=result.kind,
            help="Heliograph end-to-end probe latency (encrypt, HTTP, "
                 "quorum, decrypt-and-verify)",
        )

    # --------------------------------------------------------------- reads

    def last(self, kind: str) -> ProbeResult | None:
        return self._last.get(kind)

    def last_age(self) -> float | None:
        """Seconds since the most recent probe of any kind (None = never)."""
        if not self._last:
            return None
        return self._clock() - max(r.at for r in self._last.values())

    def unreachable_regions(self) -> set[str]:
        """Regions with >= unreachable_streak consecutive unreachable
        probes — Helmsman's region_down/promotion evidence. The anonymous
        "" region (untargeted local probes) never feeds the signal."""
        return {
            r for r, n in self._region_fail.items()
            if r and n >= self.unreachable_streak
        }

    def report(self) -> dict:
        """The `GET /canary` body: per-kind state, counts, recent
        failures with exemplar trace ids, region streaks."""
        now = self._clock()
        kinds: dict[str, dict] = {}
        for kind, r in self._last.items():
            ok_at = self._last_ok.get(kind)
            entry = {
                "verdict": r.verdict,
                "age_s": round(now - r.at, 3),
                "latency_ms": round(r.latency_s * 1e3, 3),
                "trace_id": r.trace_id,
                "last_ok_age_s": (
                    round(now - ok_at, 3) if ok_at is not None else None
                ),
            }
            fail = self._last_failure.get(kind)
            if fail is not None:
                entry["last_failure"] = {
                    "verdict": fail.verdict,
                    "trace_id": fail.trace_id,
                    "age_s": round(now - fail.at, 3),
                    "target": fail.target,
                    "region": fail.region,
                    "detail": _safe_detail(fail.detail),
                }
            kinds[kind] = entry
        return {
            "kinds": kinds,
            "counts": {
                f"{k}.{v}": n for (k, v), n in sorted(self._counts.items())
            },
            "unreachable_regions": sorted(self.unreachable_regions()),
            "region_streaks": {
                r: n for r, n in self._region_fail.items() if r and n
            },
            "probes_recorded": self._seq,
        }

    def health_section(self, enabled: bool, stale_after: float) -> dict:
        """The `/health` canary section: pure in-memory state, O(kinds),
        never awaits — a wedged prober degrades this to "stale", it can
        never block the health probe itself."""
        if not enabled:
            return {"status": "disabled"}
        age = self.last_age()
        status = "ok"
        if age is None or age > stale_after:
            status = "stale"
        elif any(r.verdict not in ("ok", "slow")
                 for r in self._last.values()):
            status = "failing"
        out: dict = {"status": status, "last_probe_age_s": (
            round(age, 3) if age is not None else None)}
        out["kinds"] = {
            kind: {"verdict": r.verdict,
                   "age_s": round(self._clock() - r.at, 3)}
            for kind, r in sorted(self._last.items())
        }
        return out

    # -------------------------------------------------------------- export

    def export_gauges(self, reg) -> None:
        """Scrape-time gauges (bounded: kinds x 1, plus one rotating
        exemplar series per kind — the family is cleared first so rotated
        trace ids never accrete toward the cardinality cap)."""
        now = self._clock()
        for kind, r in self._last.items():
            reg.set(
                "dds_canary_verdict", VERDICTS.index(r.verdict), kind=kind,
                help="last canary verdict per probe kind "
                     "(0 ok, 1 slow, 2 wrong_answer, 3 unreachable)",
            )
            ok_at = self._last_ok.get(kind)
            if ok_at is not None:
                reg.set(
                    "dds_canary_last_ok_age_seconds", now - ok_at, kind=kind,
                    help="seconds since the last ok/slow canary probe",
                )
        reg.clear_family("dds_canary_exemplar")
        for kind, fail in self._last_failure.items():
            reg.set(  # argus: ok[metrics.unbounded-label] family cleared each scrape above; bounded at one exemplar series per probe kind
                "dds_canary_exemplar", self._seq, kind=kind,
                trace_id=fail.trace_id, verdict=fail.verdict,
                help="latest canary failure exemplar per kind; the value "
                     "orders exemplars fleet-wide (ledger sequence)",
            )
        for region in self.unreachable_regions():
            reg.set(
                "dds_canary_region_unreachable", 1, region=region,
                help="regions at/over the consecutive-unreachable canary "
                     "streak (Helmsman region_down evidence)",
            )


def _safe_detail(detail: dict) -> dict:
    """Failure detail clamped for reports: short strings only (expected/
    observed rows can carry ciphertext-sized ints — truncate, the trace
    id is the real pointer)."""
    out = {}
    for k, v in list(detail.items())[:8]:
        s = str(v)
        out[str(k)] = s if len(s) <= 120 else s[:117] + "..."
    return out


class Heliograph:
    """The supervised prober: owns the canary crypto domain + population,
    schedules jittered probe cycles with per-probe deadlines, records
    every outcome in the ledger, and feeds the SLO / Watchtower /
    Helmsman planes. Construct with a duck-typed `HeliographConfig`;
    `clock`/`rng`/`sleep` inject for deterministic tests."""

    def __init__(self, cfg, targets: list[CanaryTarget], *,
                 slo=None, watchtower=None, ssl_context=None,
                 clock=time.monotonic, rng: random.Random | None = None,
                 sleep=asyncio.sleep, client: CanaryClient | None = None):
        self.cfg = cfg
        self.targets = list(targets) or [CanaryTarget("127.0.0.1", 0)]
        self.slo = slo
        self.watchtower = watchtower
        self.ssl_context = ssl_context
        self.clock = clock
        self.rng = rng if rng is not None else random.Random()
        self.sleep = sleep
        self.client = client
        self.kinds = [k for k in getattr(cfg, "probes", list(PROBE_KINDS))
                      if k in PROBE_KINDS]
        self.ledger = CanaryLedger(
            clock=clock,
            unreachable_streak=getattr(cfg, "unreachable_streak", 3),
        )
        self.cycles = 0
        self._task = None
        self._populated: set[str] = set()

    # ---------------------------------------------------------- scheduling

    def next_delay(self) -> float:
        """Jittered inter-cycle delay: cadence +/- jitter fraction, never
        below 50 ms. Uniform jitter de-phases a fleet of probers whose
        processes started together (same argument as anti-entropy's
        de-synchronising sleep)."""
        cadence = max(0.05, float(self.cfg.cadence))
        jitter = min(1.0, max(0.0, float(self.cfg.jitter)))
        return max(0.05, cadence * (1.0 + jitter * (2 * self.rng.random() - 1)))

    def classify(self, correct: bool, status: int, latency_s: float) -> str:
        """Typed verdict from one probe's verified outcome."""
        if correct and status == 200:
            slow = latency_s * 1e3 > float(self.cfg.slow_ms)
            return "slow" if slow else "ok"
        if status != 200:
            return "unreachable"
        return "wrong_answer"

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._task is None:
            self._task = supervised_task(self._run(), name="heliograph")

    async def stop(self) -> None:
        """Cancel the prober's task and wait for it to end: no prober task
        outlives the proxy."""
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    @property
    def enabled(self) -> bool:
        return bool(getattr(self.cfg, "enabled", False))

    def stale_after(self) -> float:
        """A ledger older than ~3 cadences is stale (missed cycles plus
        jitter headroom)."""
        return 3.0 * max(0.05, float(self.cfg.cadence))

    # ----------------------------------------------------------- the loop

    async def _run(self) -> None:
        if self.client is None:
            provider = await build_provider(
                getattr(self.cfg, "paillier_bits", 512),
                getattr(self.cfg, "rsa_bits", 512),
            )
            self.client = CanaryClient(
                provider, population=getattr(self.cfg, "population", 4),
                ssl_context=self.ssl_context,
                timeout=float(self.cfg.deadline),
            )
        while True:
            target = self.targets[self.cycles % len(self.targets)]
            await self.run_cycle(target)
            self.cycles += 1
            await self.sleep(self.next_delay())

    async def run_cycle(self, target: CanaryTarget) -> None:
        """One probe cycle against one target: populate once (lazily, per
        target set — idempotent content-addressed writes), then every
        configured probe kind under its own deadline. Exceptions never
        escape: an unreachable edge is a VERDICT, not a crash."""
        if target.label not in self._populated:
            trace = self.client.mint_trace()
            try:
                await asyncio.wait_for(
                    self.client.populate(target, trace),
                    timeout=float(self.cfg.deadline) * self.client.population,
                )
                self._populated.add(target.label)
            except (Exception, asyncio.TimeoutError) as e:
                self.ledger.record(ProbeResult(
                    "putget", "unreachable", 0.0, trace,
                    target=target.label, region=target.region,
                    detail={"phase": "populate", "error": str(e)},
                ))
                return
        for kind in self.kinds:
            await self.probe_once(kind, target)

    async def probe_once(self, kind: str, target: CanaryTarget) -> ProbeResult:
        trace_id = self.client.mint_trace()
        t0 = self.clock()
        status, correct, detail = 0, False, {}
        try:
            check = await asyncio.wait_for(
                self.client.probe(kind, target, trace_id, self.cycles),
                timeout=float(self.cfg.deadline),
            )
            status, correct, detail = check.status, check.correct, check.detail
        except (asyncio.TimeoutError, TimeoutError, OSError) as e:
            detail = {"error": type(e).__name__}
        except asyncio.CancelledError:
            raise
        except Exception as e:  # garbled body / broken crypto = wrong answer
            status, detail = 200, {"error": f"{type(e).__name__}: {e}"}
        latency = self.clock() - t0
        verdict = self.classify(correct, status, latency)
        result = ProbeResult(
            kind, verdict, latency, trace_id,
            target=target.label, region=target.region, detail=detail,
        )
        self.ledger.record(result)
        self._feed(result)
        return result

    # ------------------------------------------------------------- feeding

    def _feed(self, result: ProbeResult) -> None:
        """Fan one typed result out to the passive planes (never raises:
        a broken feed must not kill the prober)."""
        try:
            if self.slo is not None:
                self.slo.observe(
                    f"canary.{result.kind}", _SLO_STATUS[result.verdict],
                    result.latency_s,
                )
        except Exception:  # noqa: BLE001
            pass
        if result.verdict == "wrong_answer":
            try:
                if self.watchtower is not None:
                    self.watchtower.report_violation(
                        "canary_wrong_answer", result.trace_id,
                        probe=result.kind, target=result.target,
                        region=result.region,
                        **_safe_detail(result.detail),
                    )
                else:
                    flight.record(
                        "canary_wrong_answer", trace_id=result.trace_id,
                        probe=result.kind, **_safe_detail(result.detail),
                    )
            except Exception:  # noqa: BLE001
                pass
        elif result.verdict == "unreachable":
            try:
                flight.record(
                    "canary_unreachable", trace_id=result.trace_id,
                    probe=result.kind, target=result.target,
                    region=result.region,
                )
            except Exception:  # noqa: BLE001
                pass

    # ---------------------------------------------------------- plane taps

    def unreachable_regions(self) -> set[str]:
        """Helmsman's injected canary signal (fleet/helmsman.py)."""
        return self.ledger.unreachable_regions()

    def export_gauges(self, reg) -> None:
        self.ledger.export_gauges(reg)

    def report(self) -> dict:
        out = self.ledger.report()
        out["enabled"] = self.enabled
        out["cadence_s"] = float(self.cfg.cadence)
        out["cycles"] = self.cycles
        out["targets"] = [
            {"target": t.label, "region": t.region} for t in self.targets
        ]
        return out

    def health_section(self) -> dict:
        return self.ledger.health_section(
            self.enabled and self._task is not None, self.stale_after()
        )


# ------------------------------------------------------------------ drill

def seed_ciphertext_corruption(replicas, key: str, position: int = 2) -> int:
    """The ChaosNet corruption drill's seeded fault: mutate `key`'s stored
    ciphertext at `position` IN PLACE on every replica, preserving the
    tag. This lands PAST the transport-HMAC boundary — each replica
    re-MACs its (corrupted) answer, quorums agree, Watchtower's tag
    algebra holds, every passive surface stays green — and models a
    storage-layer bit flip / firmware bug rather than a network forgery
    (ChaosNet's own `corrupt` fault is caught by the frame MAC and can
    never produce a valid-MAC wrong answer). Only decrypt-and-verify
    notices: a Paillier ciphertext c+1 is still a valid ciphertext of a
    DIFFERENT plaintext. Returns the number of replicas mutated."""
    nodes = replicas.values() if isinstance(replicas, dict) else replicas
    mutated = 0
    for node in nodes:
        entry = node.repository.get(key)
        if entry is None:
            continue
        tag, value = entry
        if value is None or position >= len(value):
            continue
        v = list(value)
        cell = v[position]
        s = str(cell)
        v[position] = str(int(s) + 1) if s.isdigit() else s + "\x00"
        node._store(key, tag, v)
        mutated += 1
    return mutated
