"""Meridian load plane: an open-loop, coordinated-omission-safe generator.

Copy of `dds_tpu/fabric/loadgen.py`. The workload client
(`clt/client.py`) is closed-loop: each client waits for its previous
response, so a slow server slows the offered load and the measured
latencies flatter the system (coordinated omission). This generator is
open-loop:

- arrivals follow a seeded Poisson process at the target rate, and a
  request fires at its scheduled instant however many predecessors are
  still in flight;
- every latency is measured from the request's scheduled arrival, not
  its send, so queueing inside the generator (the symptom of an
  overloaded server) lands in the percentiles; arrivals the socket pool
  cannot admit are recorded as failures at the full timeout, never
  dropped from the sample;
- keys are Zipf-popular (`clt/distribution.ZipfKeys`) over a seeded
  keyset written with the closed-loop client's row distribution;
- the mix is per class: interactive point ops (GetSet, WriteElement)
  and aggregate folds (SumAll), Bulwark's priority classes;
- every sample feeds an `obs.slo.SloEngine`, so a sweep reports burn
  rates and budget with the serving side's math.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import random
from dataclasses import dataclass, field

from dds_tpu_torch.clt.distribution import ZipfKeys, random_row
from dds_tpu_torch.http.miniserver import http_request
from dds_tpu_torch.obs.slo import SloEngine
from dds_tpu_torch.utils.tasks import supervised_task

log = logging.getLogger("dds_torch.fabric.loadgen")

# route -> Bulwark priority class (mirrors core/admission's default map)
_CLASS = {"GetSet": "interactive", "WriteElement": "interactive",
          "PutSet": "interactive", "SumAll": "aggregate"}

DEFAULT_MIX = {"GetSet": 0.70, "WriteElement": 0.25, "SumAll": 0.05}


def percentile(sorted_vals: list[float], p: float) -> float:
    """Nearest-rank percentile over an ASCENDING list (0 when empty):
    the smallest value with at least p% of the sample at or below it."""
    if not sorted_vals:
        return 0.0
    k = max(1, math.ceil(p / 100.0 * len(sorted_vals)))
    return sorted_vals[min(k, len(sorted_vals)) - 1]


@dataclass
class LoadReport:
    rate: float                  # offered arrivals/s
    duration: float
    scheduled: int               # arrivals the open loop generated
    completed: int               # responses received (any status)
    good: int                    # 2xx within timeout
    errors: int                  # non-2xx responses
    failures: int                # transport errors / timeouts / shed slots
    achieved_rps: float          # good completions per second
    p50_ms: float
    p95_ms: float
    p99_ms: float
    per_class: dict = field(default_factory=dict)
    slo: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "rate": self.rate, "duration": self.duration,
            "scheduled": self.scheduled, "completed": self.completed,
            "good": self.good, "errors": self.errors,
            "failures": self.failures,
            "achieved_rps": round(self.achieved_rps, 2),
            "p50_ms": round(self.p50_ms, 3),
            "p95_ms": round(self.p95_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "per_class": self.per_class,
            "slo": self.slo,
        }


class OpenLoopLoad:
    def __init__(self, targets: list[str], *, keys: int = 64,
                 zipf_s: float = 1.1, mix: dict | None = None,
                 timeout: float = 5.0, seed: int = 0,
                 max_outstanding: int = 2048, ssl_context=None,
                 slo: SloEngine | None = None):
        """`targets` are proxy "host:port" listeners; arrivals spread
        across them round-robin (the multi-proxy front door). One
        instance = one fleet under test; `run()` per rate point."""
        if not targets:
            raise ValueError("open-loop load needs at least one target")
        self.targets = list(targets)
        self.n_keys = keys
        self.zipf_s = zipf_s
        self.mix = dict(mix or DEFAULT_MIX)
        if not self.mix or any(v < 0 for v in self.mix.values()):
            raise ValueError("mix must be non-negative fractions")
        unknown = set(self.mix) - set(_CLASS)
        if unknown:
            raise ValueError(f"unknown mix routes: {sorted(unknown)}")
        self.timeout = timeout
        self._seed = seed
        self.max_outstanding = max_outstanding
        self.ssl_context = ssl_context
        # the SLO engine the sweep reports through — same objectives/
        # windows/burn math as the serving side's /slo
        self.slo = slo or SloEngine()
        self.keys: list[str] = []
        self._zipf: ZipfKeys | None = None
        self._rr = 0

    # ----------------------------------------------------------------- seed

    async def seed(self) -> list[str]:
        """Populate the store: `n_keys` rows from the shared closed-loop
        row distribution (integer lead columns so SumAll folds them),
        keys collected for the Zipf popularity ranking."""
        rng = random.Random(self._seed)
        self.keys = []
        for _ in range(self.n_keys):
            row = random_row(["Int", "Int", "Int"], 5, rng)
            host, port = self._target()
            status, body = await http_request(
                host, port, "POST", "/PutSet",
                json.dumps({"contents": [str(v) for v in row]}).encode(),
                ssl_context=self.ssl_context, timeout=self.timeout * 4,
            )
            if status != 200:
                raise ConnectionError(
                    f"seed PutSet answered {status}: {body[:120]!r}"
                )
            self.keys.append(body.decode())
        self._zipf = ZipfKeys(self.keys, self.zipf_s,
                              random.Random(self._seed + 1))
        return self.keys

    def _target(self) -> tuple[str, int]:
        t = self.targets[self._rr % len(self.targets)]
        self._rr += 1
        host, _, port = t.partition(":")
        return host, int(port)

    # ------------------------------------------------------------------ ops

    def _pick_op(self, rng: random.Random) -> tuple[str, str, str, bytes | None]:
        """(route, method, target-path, body) drawn from the mix."""
        total = sum(self.mix.values())
        u = rng.random() * total
        acc = 0.0
        route = next(iter(self.mix))
        for name, frac in self.mix.items():
            acc += frac
            if u <= acc:
                route = name
                break
        key = self._zipf.pick() if self._zipf is not None else ""
        if route == "GetSet":
            return route, "GET", f"/GetSet/{key}", None
        if route == "WriteElement":
            body = json.dumps({"value": str(rng.randrange(1 << 16))}).encode()
            return route, "PUT", f"/WriteElement/{key}?position=0", body
        if route == "PutSet":
            row = random_row(["Int", "Int", "Int"], 5, rng)
            return route, "POST", "/PutSet", json.dumps(
                {"contents": [str(v) for v in row]}
            ).encode()
        return "SumAll", "GET", "/SumAll?position=0", None

    # ------------------------------------------------------------------ run

    async def run(self, rate: float, duration: float) -> LoadReport:
        """One open-loop rate point. Arrivals are Poisson(`rate`) for
        `duration` seconds; the report's percentiles are over latencies
        measured from each request's scheduled arrival instant."""
        if self._zipf is None:
            await self.seed()
        loop = asyncio.get_running_loop()
        rng = random.Random((self._seed << 16) ^ int(rate * 1000))
        samples: dict[str, list[float]] = {}
        counts = {"good": 0, "errors": 0, "failures": 0, "completed": 0}
        outstanding = 0
        tasks: list[asyncio.Task] = []

        async def one(route: str, method: str, path: str,
                      body, sched: float) -> None:
            nonlocal outstanding
            cls = _CLASS[route]
            host, port = self._target()
            status = 599
            try:
                # per-request budget measured from the SCHEDULED arrival:
                # time already lost queueing inside the generator counts
                # against it, exactly like an impatient user's patience
                budget = max(0.05, self.timeout - (loop.time() - sched))
                status, _ = await http_request(
                    host, port, method, path, body,
                    ssl_context=self.ssl_context, timeout=budget,
                )
                counts["completed"] += 1
                if 200 <= status < 300:
                    counts["good"] += 1
                else:
                    counts["errors"] += 1
            except (OSError, asyncio.TimeoutError, EOFError,
                    ConnectionError, ValueError):
                counts["failures"] += 1
            finally:
                outstanding -= 1
                lat = loop.time() - sched
                samples.setdefault(cls, []).append(lat)
                self.slo.observe(route, status if status < 599 else 503, lat)

        start = loop.time()
        t = 0.0
        scheduled = 0
        while True:
            t += rng.expovariate(rate)
            if t >= duration:
                break
            sched = start + t
            delay = sched - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            scheduled += 1
            route, method, path, body = self._pick_op(rng)
            if outstanding >= self.max_outstanding:
                # the socket pool itself is saturated: an honest sample
                # records the arrival as a full-timeout failure instead
                # of pretending it never happened
                counts["failures"] += 1
                samples.setdefault(_CLASS[route], []).append(self.timeout)
                self.slo.observe(route, 503, self.timeout)
                continue
            outstanding += 1
            tasks.append(supervised_task(
                one(route, method, path, body, sched),
                name=f"loadgen.{route}",
            ))
        if tasks:
            await asyncio.wait(tasks, timeout=self.timeout + 1.0)
        for task in tasks:
            if not task.done():
                task.cancel()
        all_lat = sorted(v for vals in samples.values() for v in vals)
        per_class = {}
        for cls, vals in sorted(samples.items()):
            svals = sorted(vals)
            per_class[cls] = {
                "count": len(svals),
                "p50_ms": round(percentile(svals, 50) * 1e3, 3),
                "p95_ms": round(percentile(svals, 95) * 1e3, 3),
                "p99_ms": round(percentile(svals, 99) * 1e3, 3),
            }
        slo_report = self.slo.report()
        return LoadReport(
            rate=rate, duration=duration, scheduled=scheduled,
            completed=counts["completed"], good=counts["good"],
            errors=counts["errors"], failures=counts["failures"],
            achieved_rps=counts["good"] / duration if duration else 0.0,
            p50_ms=percentile(all_lat, 50) * 1e3,
            p95_ms=percentile(all_lat, 95) * 1e3,
            p99_ms=percentile(all_lat, 99) * 1e3,
            per_class=per_class,
            slo={
                "alerts": self.slo.alerts(),
                "routes": {
                    r: {
                        "burn_rate": d["windows"][
                            f"{int(self.slo.windows[0])}s"]["burn_rate"],
                        "budget_remaining": d["budget_remaining"],
                    }
                    for r, d in slo_report["routes"].items()
                },
            },
        )

    async def sweep(self, rates: list[float],
                    duration: float) -> list[LoadReport]:
        """Arrival-rate sweep, one open-loop run per point (ascending, so
        earlier points warm caches the way a ramping fleet would)."""
        out = []
        for rate in rates:
            out.append(await self.run(rate, duration))
            log.info("rate %.0f/s: good=%d p99=%.1fms", rate,
                     out[-1].good, out[-1].p99_ms)
        return out
