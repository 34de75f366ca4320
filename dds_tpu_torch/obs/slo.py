"""SLO engine: per-route latency objectives + error-budget burn tracking.

Copy of `dds_tpu/obs/slo.py`: the same classification, bins, windows,
burn math, report shapes and `dds_slo_*` gauges, so the same observations
on the same clock give the same `report()`, `alerts()` and `burns()` in
both packages.

A latency histogram tells you what happened; an SLO says whether it was
GOOD ENOUGH. Each route carries an objective — "`objective` of requests
answer under `latency_ms` without a server error" — and every request is
classified good/bad at the REST edge (`http/server.handle`). Bad requests
burn the route's error budget (`1 - objective`); the burn RATE over two
rolling windows (a fast one that catches a cliff, a slow one that
confirms it is not a blip) is the page signal, the multiwindow multi-
burn-rate shape SRE alerting converged on. `GET /slo` serves the whole
report; `export_gauges` mirrors it as `dds_slo_*` gauges for scrapers.

Classification: good = HTTP status < 500 AND latency <= the route's
threshold. 4xx are the client's fault and do not burn the server's
budget; 503 degradations and deadline exhaustions do — that is exactly
what the budget is for.

Time is bucketed into fixed bins (fast_window/60, floor 1 s) so a window
sum is O(bins), state stays bounded per route, and no per-request
timestamps are retained.

Bastion addendum — per-TENANT attribution: `observe` optionally carries
the requesting tenant, binned into a parallel bounded table (at most
`max_tenants` tracked; beyond that, outcomes fold into the "overflow"
tenant, so a tenant-id cardinality attack coarsens attribution instead
of growing state). `tenant_burns()` is the Helmsman/Bulwark signal that
says WHOSE burn it is; `report()` gains a "tenants" section.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from dataclasses import dataclass

__all__ = ["RouteSlo", "SloEngine", "slo_class"]

# The Spyglass-served encrypted query surface (Search*/Order*/Range):
# classified as its own SLO family so operators can budget the indexed
# query plane separately from the fold aggregates it used to hide behind.
_SEARCH_ROUTES = frozenset({
    "OrderLS", "OrderSL", "Range",
    "SearchEq", "SearchNEq", "SearchGt", "SearchGtEq", "SearchLt",
    "SearchLtEq", "SearchEntry", "SearchEntryOR", "SearchEntryAND",
})
_AGGREGATE_ROUTES = frozenset({"Sum", "Mult", "SumAll", "MultAll"})
_ANALYTICS_ROUTES = frozenset({"MatVec", "WeightedSum", "GroupBySum"})
_POINT_ROUTES = frozenset({
    "GetSet", "PutSet", "RemoveSet", "AddElement", "ReadElement",
    "WriteElement", "IsElement",
})


def slo_class(route: str) -> str:
    """Coarse route family for SLO reporting: search | aggregate |
    analytics | point | other. Distinct from core/admission.route_class
    (priority classes for shedding) — this is the reporting taxonomy the
    /slo body and dashboards group by."""
    if route in _SEARCH_ROUTES:
        return "search"
    if route in _AGGREGATE_ROUTES:
        return "aggregate"
    if route in _ANALYTICS_ROUTES:
        return "analytics"
    if route in _POINT_ROUTES:
        return "point"
    return "other"


@dataclass(frozen=True)
class RouteSlo:
    """One route's objective: `objective` of requests good, where good
    means `status < 500 and latency_ms <= latency`."""

    objective: float = 0.99
    latency_ms: float = 250.0


class SloEngine:
    def __init__(
        self,
        default: RouteSlo | None = None,
        routes: dict[str, RouteSlo] | None = None,
        windows: tuple[float, float] = (300.0, 3600.0),
        burn_alert: float = 14.4,
        clock=time.monotonic,
        max_tenants: int = 256,
    ):
        self.default = default or RouteSlo()
        self.routes = dict(routes or {})
        fast, slow = float(windows[0]), float(windows[1])
        if fast > slow:
            fast, slow = slow, fast
        self.windows = (fast, slow)
        self.burn_alert = float(burn_alert)
        self._clock = clock
        self.bin_s = max(1.0, fast / 60.0)
        maxbins = int(math.ceil(slow / self.bin_s)) + 1
        # route -> deque of [bin_index, good, bad_latency, bad_error]
        self._bins: dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=maxbins)
        )
        # tenant -> same bin shape (bounded: max_tenants then "overflow")
        self.max_tenants = int(max_tenants)
        self._tenant_bins: dict[str, collections.deque] = {}
        self._maxbins = maxbins
        self._lock = threading.Lock()

    @classmethod
    def from_obs(cls, obs) -> "SloEngine":
        """Build from an ObsConfig-shaped object (duck-typed so this module
        never imports the config tree). Per-route overrides accept either
        `latency-ms` (TOML idiom) or `latency_ms` keys."""
        default = RouteSlo(
            objective=float(getattr(obs, "slo_objective", 0.99)),
            latency_ms=float(getattr(obs, "slo_latency_ms", 250.0)),
        )
        routes = {}
        for name, spec in (getattr(obs, "slo_routes", None) or {}).items():
            if not isinstance(spec, dict):
                continue
            routes[str(name)] = RouteSlo(
                objective=float(spec.get("objective", default.objective)),
                latency_ms=float(
                    spec.get("latency-ms", spec.get("latency_ms",
                                                    default.latency_ms))
                ),
            )
        return cls(
            default=default,
            routes=routes,
            windows=(
                float(getattr(obs, "slo_fast_window", 300.0)),
                float(getattr(obs, "slo_slow_window", 3600.0)),
            ),
            burn_alert=float(getattr(obs, "slo_burn_alert", 14.4)),
        )

    def slo_for(self, route: str) -> RouteSlo:
        return self.routes.get(route, self.default)

    # --------------------------------------------------------------- intake

    def observe(self, route: str, status: int, dur_s: float,
                tenant: str | None = None) -> None:
        slo = self.slo_for(route)
        err = status >= 500
        slow = dur_s * 1e3 > slo.latency_ms
        idx = int(self._clock() / self.bin_s)
        with self._lock:
            targets = [self._bins[route]]
            if tenant is not None:
                tbins = self._tenant_bins.get(tenant)
                if tbins is None:
                    if len(self._tenant_bins) >= self.max_tenants:
                        tenant = "overflow"
                        tbins = self._tenant_bins.get(tenant)
                    if tbins is None:
                        tbins = self._tenant_bins[tenant] = collections.deque(
                            maxlen=self._maxbins
                        )
                targets.append(tbins)
            for bins in targets:
                if not bins or bins[-1][0] != idx:
                    bins.append([idx, 0, 0, 0])
                cur = bins[-1]
                if err:
                    cur[3] += 1
                elif slow:
                    cur[2] += 1
                else:
                    cur[1] += 1

    # -------------------------------------------------------------- reports

    def _window_counts(self, bins, window: float) -> tuple[int, int, int]:
        """(good, bad_latency, bad_error) over the trailing `window` s."""
        cutoff = int((self._clock() - window) / self.bin_s)
        good = bad_lat = bad_err = 0
        for idx, g, bl, be in bins:
            if idx > cutoff:
                good += g
                bad_lat += bl
                bad_err += be
        return good, bad_lat, bad_err

    def report(self) -> dict:
        """The `GET /slo` body: per observed route, the objective and the
        per-window burn state. Burn rate = bad_fraction / error_budget
        (1.0 = burning exactly at the sustainable rate; `burn_alert`x =
        page). `budget_remaining` is the slow window's unspent fraction."""
        out: dict = {
            "windows_s": list(self.windows),
            "burn_alert": self.burn_alert,
            "routes": {},
        }
        with self._lock:
            items = [(r, list(b)) for r, b in self._bins.items()]
        for route, bins in sorted(items):
            slo = self.slo_for(route)
            budget = max(1e-9, 1.0 - slo.objective)
            wreport = {}
            burns = []
            for w in self.windows:
                good, bad_lat, bad_err = self._window_counts(bins, w)
                total = good + bad_lat + bad_err
                bad = bad_lat + bad_err
                frac = (bad / total) if total else 0.0
                burn = frac / budget
                burns.append((burn, total, bad))
                wreport[f"{int(w)}s"] = {
                    "total": total,
                    "bad": bad,
                    "bad_latency": bad_lat,
                    "bad_error": bad_err,
                    "bad_fraction": round(frac, 6),
                    "burn_rate": round(burn, 3),
                }
            _, slow_total, slow_bad = burns[-1]
            remaining = (
                1.0 - min(1.0, slow_bad / (slow_total * budget))
                if slow_total else 1.0
            )
            out["routes"][route] = {
                "objective": slo.objective,
                "latency_ms": slo.latency_ms,
                "class": slo_class(route),
                "windows": wreport,
                "budget_remaining": round(remaining, 6),
                # page only when BOTH windows burn hot: the fast window
                # catches the cliff, the slow one proves it is sustained
                "alert": all(b[0] >= self.burn_alert for b in burns),
            }
        tenants = self.tenant_report()
        if tenants:
            out["tenants"] = tenants
        return out

    def alerts(self) -> list[str]:
        """Routes whose multiwindow burn alert is CURRENTLY firing (both
        windows burning >= burn_alert). The page signal as a cheap list —
        the Bulwark admission controller polls this every evaluation tick,
        so it skips report()'s full per-window dict construction."""
        with self._lock:
            items = [(r, list(b)) for r, b in self._bins.items()]
        out = []
        for route, bins in items:
            slo = self.slo_for(route)
            budget = max(1e-9, 1.0 - slo.objective)
            firing = True
            for w in self.windows:
                good, bad_lat, bad_err = self._window_counts(bins, w)
                total = good + bad_lat + bad_err
                bad = bad_lat + bad_err
                burn = (bad / total) / budget if total else 0.0
                if burn < self.burn_alert:
                    firing = False
                    break
            if firing:
                out.append(route)
        return out

    def burns(self) -> dict[str, list[float]]:
        """Route -> [burn per window, fast first] — the compact snapshot
        the Helmsman controller flight-records with each decision, so an
        autoscale action is auditable against the burn that drove it
        (alerts() says WHETHER a route pages; this says how hard)."""
        with self._lock:
            items = [(r, list(b)) for r, b in self._bins.items()]
        out: dict[str, list[float]] = {}
        for route, bins in items:
            slo = self.slo_for(route)
            budget = max(1e-9, 1.0 - slo.objective)
            row = []
            for w in self.windows:
                good, bad_lat, bad_err = self._window_counts(bins, w)
                total = good + bad_lat + bad_err
                bad = bad_lat + bad_err
                row.append(round((bad / total) / budget if total else 0.0, 3))
            out[route] = row
        return out

    def tenant_burns(self) -> dict[str, list[float]]:
        """Tenant -> [burn per window, fast first], against the DEFAULT
        objective (tenant attribution spans routes, so the per-route
        thresholds already shaped good/bad at observe time). The signal
        Helmsman and dashboards use to answer WHOSE burn the fleet's
        alert is."""
        budget = max(1e-9, 1.0 - self.default.objective)
        with self._lock:
            items = [(t, list(b)) for t, b in self._tenant_bins.items()]
        out: dict[str, list[float]] = {}
        for tenant, bins in items:
            row = []
            for w in self.windows:
                good, bad_lat, bad_err = self._window_counts(bins, w)
                total = good + bad_lat + bad_err
                bad = bad_lat + bad_err
                row.append(round((bad / total) / budget if total else 0.0, 3))
            out[tenant] = row
        return out

    def tenant_report(self) -> dict:
        """Per-tenant window totals for /slo's "tenants" section."""
        with self._lock:
            items = [(t, list(b)) for t, b in self._tenant_bins.items()]
        out: dict = {}
        for tenant, bins in sorted(items):
            wreport = {}
            for w in self.windows:
                good, bad_lat, bad_err = self._window_counts(bins, w)
                total = good + bad_lat + bad_err
                wreport[f"{int(w)}s"] = {
                    "total": total, "bad": bad_lat + bad_err,
                    "bad_latency": bad_lat, "bad_error": bad_err,
                }
            out[tenant] = wreport
        return out

    def export_gauges(self, registry) -> None:
        """Mirror the report as scrape-time gauges (http/server calls this
        from `_sample_state_gauges`)."""
        rep = self.report()
        for route, r in rep["routes"].items():
            for wname, w in r["windows"].items():
                registry.set(
                    "dds_slo_burn_rate", w["burn_rate"], route=route,
                    window=wname,
                    help="error-budget burn rate (1.0 = sustainable) per window",
                )
            registry.set(
                "dds_slo_error_budget_remaining", r["budget_remaining"],
                route=route,
                help="unspent error-budget fraction over the slow window",
            )
            registry.set(
                "dds_slo_objective", r["objective"], route=route,
                help="configured good-request objective per route",
            )
            registry.set(
                "dds_slo_alert", 1.0 if r["alert"] else 0.0, route=route,
                help="1 when both burn windows exceed the alert threshold",
            )
        for tenant, row in self.tenant_burns().items():
            registry.set(
                "dds_slo_tenant_burn_rate", row[0], tenant=tenant,
                help="fast-window error-budget burn rate attributed per "
                     "tenant (bounded cardinality; overflow folds)",
            )
