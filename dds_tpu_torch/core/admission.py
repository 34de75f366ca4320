"""Bulwark: SLO-driven admission control and priority load shedding.

Copy of `dds_tpu/core/admission.py`: the same buckets, ratchet, tenant
bookkeeping and adaptive window, so one sequence of calls on one fake
clock gives the same decisions, levels and Retry-After values in both
packages. The port serves one tenant (tenancy is not ported): requests
carry the validated `x-dds-tenant` header as their bucket label, the
Bastion weights and burn-shed thresholds keep their defaults, and the
REST edge does not feed `note_outcome` (the reference feeds it only with
tenancy on).

Everything upstream of this module *observes* overload: the SLO engine
(obs/slo) tracks error-budget burn, breakers (utils/retry) track dead
coordinators, the flight recorder freezes the evidence. Nothing *decides*
— under sustained overload every request still burns its full Deadline
budget before 503ing, and one hot tenant starves the rest. Bulwark is the
decision loop, sitting at the REST edge BEFORE a Deadline is minted:

- `TokenBucket` per (tenant, priority class): a request that exceeds its
  tenant's refill rate is rejected in microseconds with 429 and a
  Retry-After equal to the bucket's actual refill ETA — the hot tenant
  pays, everyone else keeps their budget. With Bastion the buckets are
  *weighted-fair*: when a class's aggregate demand exceeds its configured
  rate, each active tenant's refill contracts to its weight share of the
  class rate (work-conserving — under-subscribed classes leave every
  tenant at the full rate), so a flooding tenant cannot monopolize a
  class simply by arriving first.
- Per-tenant burn-driven shedding: the controller tracks per-(tenant,
  class) outcomes in the evaluation window; when the fleet's SLO burn
  alert fires AND one tenant owns at least `tenant_burn_threshold` of
  the window's bad outcomes, THAT tenant is shed (429s for its sheddable
  classes) instead of ratcheting the whole fleet — a distressed tenant
  sheds itself, not the fleet. Tenant state is bounded
  (`max_tracked_tenants`; beyond it tenants share an "overflow" bucket
  and attribution coarsens, but requests still serve).
- `AdmissionController`: a shedding ratchet driven by the SLO engine's
  multiwindow burn alerts and the breaker census. Distress raises the
  shed level one class at a time (lowest priority first: background,
  then aggregates; interactive only if `max_shed_level` allows), each
  rejection a microsecond 503; recovery steps DOWN one level only after
  `shed_hold` consecutive healthy evaluations — the hysteresis that
  keeps a marginal system from flapping. Every transition is
  flight-recorded and counted (`dds_admission_*`).
- `AdaptiveCoalescer`: sizes the proxy's fold-coalescing window from the
  OBSERVED fold arrival rate instead of a fixed knob — the BTS insight
  (arxiv 2112.15479) that HE throughput comes from keeping batch shapes
  full and steady: under load the window stretches until an expected
  `target_folds` arrivals fit (so device batches stay full), and snaps
  back to the base window when traffic goes idle (so a lone aggregate
  never waits for company that is not coming).

The controller imports no config tree and no SLO engine — the burn and
breaker signals arrive as injected callables, and every class takes an
injectable clock, so the tests run the whole shed/unshed state machine on
a fake clock.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.trace import tracer

__all__ = [
    "CLASSES", "route_class",
    "TokenBucket", "Decision", "AdmissionController", "AdaptiveCoalescer",
]

# Priority classes, highest first. The shed ratchet drops them from the
# RIGHT: level 1 sheds background, level 2 also aggregates, level 3
# (opt-in) shedding interactive means the edge answers nothing but the
# exempt observability routes.
CLASSES = ("interactive", "aggregate", "background")

# Route -> class defaults. Point ops are what a human is waiting on;
# aggregates/search/analytics fan out over the whole store and can be
# recomputed; gossip and anything unrecognized is background.
_INTERACTIVE = frozenset({
    "GetSet", "PutSet", "RemoveSet", "AddElement", "ReadElement",
    "WriteElement", "IsElement", "Sum", "Mult",
})
_AGGREGATE = frozenset({
    "SumAll", "MultAll", "OrderLS", "OrderSL", "Range",
    "SearchEq", "SearchNEq", "SearchGt", "SearchGtEq", "SearchLt",
    "SearchLtEq", "SearchEntry", "SearchEntryOR", "SearchEntryAND",
    "MatVec", "WeightedSum", "GroupBySum",
})


def route_class(route: str, overrides: dict | None = None) -> int:
    """Class index for a route (0 = interactive ... 2 = background)."""
    if overrides:
        name = overrides.get(route)
        if name in CLASSES:
            return CLASSES.index(name)
    if route in _INTERACTIVE:
        return 0
    if route in _AGGREGATE:
        return 1
    return 2


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill up to `burst` capacity.

    Not thread-safe on its own — the controller serializes access under
    its lock (the REST edge calls from one event loop anyway)."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        if now > self._last:
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    @property
    def tokens(self) -> float:
        self._refill()
        return self._tokens

    def try_acquire(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def refill_eta(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (0 = now). This is
        the honest Retry-After for a throttled request — derived from
        refill state, not a config constant."""
        self._refill()
        deficit = n - self._tokens
        if deficit <= 0:
            return 0.0
        if self.rate <= 0:
            return math.inf
        return deficit / self.rate


@dataclass(frozen=True)
class Decision:
    """One admission verdict. `retry_after` is in seconds and already
    derived from real state (bucket refill / breaker ETA / ratchet
    cadence); 0 means the caller should fall back to its config hint."""

    admitted: bool
    status: int = 200
    retry_after: float = 0.0
    reason: str = ""
    klass: str = CLASSES[0]


class AdmissionController:
    """The Bulwark decision loop: per-(tenant, class) token buckets plus
    the shed-level ratchet.

    `alerts` yields the routes whose multiwindow SLO burn alert is firing
    (SloEngine.alerts); `breakers` returns `(coordinator_count,
    open_etas)` — how many coordinators the storage layer trusts and the
    half-open ETA of each one whose breaker currently refuses traffic
    (AbdClient/ShardRouter.breaker_census). Both are re-read on every
    evaluation, never cached."""

    def __init__(
        self,
        rates: dict[str, tuple[float, float]] | None = None,
        class_overrides: dict[str, str] | None = None,
        eval_interval: float = 1.0,
        shed_hold: int = 3,
        max_shed_level: int = 2,
        breaker_shed_fraction: float = 0.5,
        tenant_header: str = "x-dds-tenant",
        alerts: Optional[Callable[[], Iterable[str]]] = None,
        breakers: Optional[Callable[[], tuple[int, list[float]]]] = None,
        clock: Callable[[], float] = time.monotonic,
        tenant_weights: dict[str, float] | None = None,
        default_weight: float = 1.0,
        tenant_burn_threshold: float = 0.5,
        tenant_shed_hold: int = 3,
        max_tracked_tenants: int = 1024,
    ):
        # class name -> (rate, burst); a missing class is unthrottled
        self.rates = dict(rates or {})
        self.class_overrides = dict(class_overrides or {})
        self.eval_interval = float(eval_interval)
        self.shed_hold = int(shed_hold)
        self.max_shed_level = max(0, min(int(max_shed_level), len(CLASSES)))
        self.breaker_shed_fraction = float(breaker_shed_fraction)
        self.tenant_header = tenant_header
        self._alerts = alerts or (lambda: ())
        self._breakers = breakers or (lambda: (0, []))
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[tuple[str, int], TokenBucket] = {}
        self.shed_level = 0
        self._healthy_streak = 0
        self._last_eval = clock()
        self.transitions: list[dict] = []  # bounded history for /slo + tests
        # ---- Bastion per-tenant state (all bounded by max_tracked_tenants)
        self.tenant_weights = dict(tenant_weights or {})
        self.default_weight = float(default_weight)
        self.tenant_burn_threshold = float(tenant_burn_threshold)
        self.tenant_shed_hold = int(tenant_shed_hold)
        self.max_tracked_tenants = int(max_tracked_tenants)
        self._tenants: set[str] = set()
        # (tenant, class idx) -> [arrivals, bad outcomes] in the current
        # evaluation window; arrivals tick in decide(), bad in note_outcome
        self._window: dict[tuple[str, int], list] = {}
        # tenant -> {"level": shed classes, "streak": clean evals since}
        self._tenant_shed: dict[str, dict] = {}
        self.tenant_transitions: list[dict] = []
        # transition subscribers (event-driven waits for harnesses and
        # tests — the sleep-free alternative to polling `transitions`);
        # invoked synchronously at transition time, exceptions swallowed
        # so an observer can never wedge the decision loop
        self._subscribers: list = []

    @classmethod
    def from_config(cls, acfg, alerts=None, breakers=None,
                    clock: Callable[[], float] = time.monotonic,
                    tenancy=None) -> "AdmissionController":
        """Build from an AdmissionConfig-shaped object (duck-typed so this
        module never imports the config tree — the SloEngine.from_obs
        pattern). `tenancy` optionally supplies a TenancyConfig-shaped
        object for the Bastion weighted-fair / burn-shed knobs."""
        g = lambda name, dflt: getattr(acfg, name, dflt)  # noqa: E731
        t = lambda name, dflt: getattr(tenancy, name, dflt)  # noqa: E731
        rates = {
            "interactive": (g("interactive_rate", 400.0), g("interactive_burst", 800.0)),
            "aggregate": (g("aggregate_rate", 64.0), g("aggregate_burst", 128.0)),
            "background": (g("background_rate", 16.0), g("background_burst", 32.0)),
        }
        return cls(
            rates=rates,
            class_overrides=dict(g("classes", None) or {}),
            eval_interval=g("eval_interval", 1.0),
            shed_hold=g("shed_hold", 3),
            max_shed_level=g("max_shed_level", 2),
            breaker_shed_fraction=g("breaker_shed_fraction", 0.5),
            tenant_header=g("tenant_header", "x-dds-tenant"),
            alerts=alerts,
            breakers=breakers,
            clock=clock,
            tenant_weights=dict(t("weights", None) or {}),
            default_weight=t("default_weight", 1.0),
            tenant_burn_threshold=t("burn_threshold", 0.5),
            tenant_shed_hold=t("shed_hold", 3),
            max_tracked_tenants=t("max_tenants", 1024),
        )

    # ------------------------------------------------------------ decisions

    def route_class(self, route: str) -> int:
        return route_class(route, self.class_overrides)

    def _track(self, tenant: str) -> str:
        """Bounded tenant tracking: a tenant beyond `max_tracked_tenants`
        folds into the shared "overflow" identity for buckets, windows,
        and shed state (requests still serve; attribution coarsens)."""
        if tenant in self._tenants:
            return tenant
        if len(self._tenants) < self.max_tracked_tenants:
            self._tenants.add(tenant)
            return tenant
        return "overflow"

    def weight(self, tenant: str) -> float:
        return float(self.tenant_weights.get(tenant, self.default_weight))

    def _bucket(self, tenant: str, ci: int) -> TokenBucket | None:
        spec = self.rates.get(CLASSES[ci])
        if spec is None:
            return None
        key = (tenant, ci)
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = TokenBucket(spec[0], spec[1], self._clock)
        return b

    def _shed_floor(self) -> int:
        """Lowest class index currently being shed (len(CLASSES) = none)."""
        return len(CLASSES) - self.shed_level

    def note_outcome(self, tenant: str, klass: str, good: bool) -> None:
        """Per-tenant burn attribution feed: the REST edge reports how
        each ADMITTED request actually ended (good = non-5xx within its
        latency objective). Bad outcomes accumulate against the tenant in
        the current evaluation window; `_evaluate_locked` uses the shares
        to decide whether distress is one tenant's or the fleet's."""
        ci = CLASSES.index(klass) if klass in CLASSES else len(CLASSES) - 1
        with self._lock:
            cell = self._window.setdefault((self._track(tenant), ci), [0, 0])
            if not good:
                cell[1] += 1

    def decide(self, route: str, tenant: str = "default") -> Decision:
        """Admit/reject one request. Called at the REST edge BEFORE a
        Deadline is minted, so every rejection costs microseconds, not a
        burned budget."""
        with self._lock:
            self._maybe_evaluate()
            ci = self.route_class(route)
            klass = CLASSES[ci]
            tenant = self._track(tenant)
            self._window.setdefault((tenant, ci), [0, 0])[0] += 1
            if ci >= self._shed_floor():
                metrics.inc("dds_admission_requests_total", outcome="shed",
                            help="admission verdicts by outcome and class",
                            **{"class": klass})
                return Decision(False, 503, self._shed_retry_after(),
                                f"shedding {klass} (level {self.shed_level})",
                                klass)
            tshed = self._tenant_shed.get(tenant)
            if tshed is not None and ci >= len(CLASSES) - tshed["level"]:
                metrics.inc("dds_admission_requests_total",
                            outcome="tenant_shed",
                            help="admission verdicts by outcome and class",
                            **{"class": klass})
                return Decision(
                    False, 429,
                    self.eval_interval * max(1, self.tenant_shed_hold),
                    f"tenant {tenant!r} shed (burn-driven)", klass)
            bucket = self._bucket(tenant, ci)
            if bucket is not None and not bucket.try_acquire():
                eta = bucket.refill_eta()
                metrics.inc("dds_admission_requests_total", outcome="throttled",
                            help="admission verdicts by outcome and class",
                            **{"class": klass})
                return Decision(False, 429, eta,
                                f"tenant {tenant!r} over {klass} rate", klass)
            metrics.inc("dds_admission_requests_total", outcome="admitted",
                        help="admission verdicts by outcome and class",
                        **{"class": klass})
            return Decision(True, 200, 0.0, "", klass)

    def _shed_retry_after(self) -> float:
        """When should a shed client come back? The nearest breaker
        half-open probe if the distress is breaker-shaped, else the
        soonest the ratchet could possibly step down."""
        _, etas = self._breakers()
        positive = [e for e in etas if e > 0]
        if positive:
            return min(positive)
        return self.eval_interval * max(1, self.shed_hold)

    # ----------------------------------------------------------- evaluation

    def _maybe_evaluate(self) -> None:
        if self._clock() - self._last_eval >= self.eval_interval:
            self._evaluate_locked()

    def evaluate(self) -> int:
        """One controller tick (the proxy runs this on a timer; decide()
        also ticks lazily under traffic). Returns the shed level."""
        with self._lock:
            self._evaluate_locked()
            return self.shed_level

    def _evaluate_locked(self) -> None:
        elapsed = max(1e-6, self._clock() - self._last_eval)
        self._last_eval = self._clock()
        alert_classes = {self.route_class(r) for r in self._alerts()}
        n_coord, open_etas = self._breakers()
        breaker_bad = (
            n_coord > 0
            and len(open_etas) >= max(1, math.ceil(self.breaker_shed_fraction * n_coord))
        )
        # only classes we are still SERVING count as distress: a shed
        # class burns its budget by construction (its 503s are ours), and
        # feeding that back would latch the ratchet at max forever
        serving_floor = self._shed_floor()
        slo_bad = any(ci < serving_floor for ci in alert_classes)
        window, self._window = self._window, {}
        self._rebalance_locked(window, elapsed)
        dominant = self._attribute_locked(window) if slo_bad else None
        self._step_tenants_locked(dominant)
        if dominant is not None and not breaker_bad:
            # one tenant owns the burn: it has just been shed above —
            # hold the FLEET ratchet where it is (the point of Bastion:
            # a distressed tenant sheds itself, not everyone)
            self._healthy_streak = 0
        elif breaker_bad or slo_bad:
            self._healthy_streak = 0
            if self.shed_level < self.max_shed_level:
                reason = "breakers" if breaker_bad else "slo_burn"
                self._transition(self.shed_level + 1, reason)
        else:
            self._healthy_streak += 1
            # hysteresis: one level at a time, and only after shed_hold
            # consecutive clean evaluations — recovery is gradual where
            # onset is immediate
            if self.shed_level > 0 and self._healthy_streak >= self.shed_hold:
                self._healthy_streak = 0
                self._transition(self.shed_level - 1, "recovered")
        metrics.set("dds_admission_shed_level", self.shed_level,
                    help="Bulwark shed level (0=none; higher sheds lower "
                         "priority classes first)")
        metrics.set("dds_admission_tenants_shed", len(self._tenant_shed),
                    help="tenants currently burn-shed by Bulwark")

    # ------------------------------------------------- Bastion tenant logic

    def _rebalance_locked(self, window: dict, elapsed: float) -> None:
        """Weighted-fair bucket refill: per class, when the window's
        aggregate arrival rate exceeds the class rate, each active
        tenant's bucket contracts to its weight share of the class rate;
        otherwise every bucket restores to the full class rate
        (work-conserving — fairness only costs anything under
        contention)."""
        for ci, klass in enumerate(CLASSES):
            spec = self.rates.get(klass)
            if spec is None:
                continue
            active = [t for (t, c), cell in window.items()
                      if c == ci and cell[0] > 0]
            demand = sum(window[(t, ci)][0] for t in active) / elapsed
            contended = len(active) > 1 and demand > spec[0]
            wsum = sum(self.weight(t) for t in active) or 1.0
            for (t, c), bucket in self._buckets.items():
                if c != ci:
                    continue
                if contended and t in active:
                    share = self.weight(t) / wsum
                    bucket.rate = max(1e-9, spec[0] * share)
                    bucket.burst = max(1.0, spec[1] * share)
                else:
                    bucket.rate, bucket.burst = spec[0], spec[1]

    def _attribute_locked(self, window: dict) -> str | None:
        """The tenant owning >= tenant_burn_threshold of the window's bad
        outcomes, or None when the burn is not attributable to one tenant
        (too little signal, or spread across tenants). The "default"
        tenant is never self-shed — in single-tenant deployments it IS
        the fleet, and the global ratchet already covers that."""
        bad: dict[str, int] = {}
        for (t, _c), cell in window.items():
            bad[t] = bad.get(t, 0) + cell[1]
        total = sum(bad.values())
        if total < 4:
            return None
        tenant, worst = max(bad.items(), key=lambda kv: kv[1])
        if tenant == "default" or worst / total < self.tenant_burn_threshold:
            return None
        return tenant

    def _step_tenants_locked(self, dominant: str | None) -> None:
        """Shed the dominant burning tenant; age out tenants whose burn
        stopped (tenant_shed_hold clean evaluations, same hysteresis as
        the global ratchet)."""
        if dominant is not None:
            state = self._tenant_shed.get(dominant)
            if state is None:
                self._tenant_shed[dominant] = {
                    "level": max(1, self.max_shed_level), "streak": 0,
                }
                self._tenant_transition(dominant, "shed", "tenant_burn")
            else:
                state["streak"] = 0
        for tenant in list(self._tenant_shed):
            if tenant == dominant:
                continue
            state = self._tenant_shed[tenant]
            state["streak"] += 1
            if state["streak"] >= self.tenant_shed_hold:
                del self._tenant_shed[tenant]
                self._tenant_transition(tenant, "unshed", "recovered")

    def _tenant_transition(self, tenant: str, direction: str,
                           reason: str) -> None:
        record = {"at": self._clock(), "tenant": tenant,
                  "direction": direction, "reason": reason}
        self.tenant_transitions.append(record)
        del self.tenant_transitions[:-64]
        tracer.event("admission.tenant_" + direction, tenant=tenant,
                     reason=reason)
        metrics.inc("dds_admission_tenant_transitions_total",
                    direction=direction,
                    help="Bulwark per-tenant burn-shed transitions")
        flight.record(f"admission_tenant_{direction}", tenant=tenant,
                      reason=reason)

    def shed_tenants(self) -> list[str]:
        """Tenants currently burn-shed (Helmsman's tenant-attribution
        signal rides on this plus SloEngine.tenant_burns)."""
        with self._lock:
            return sorted(self._tenant_shed)

    def subscribe(self, fn) -> None:
        """Register a transition observer: `fn(record)` fires on every
        shed/unshed transition (same dict shape as `transitions`
        entries). The event-driven hook the overload harnesses wait on
        instead of sleeping and polling. A NON-ZERO current level is
        delivered immediately on subscription, so a late subscriber
        (the Helmsman controller attaching mid-incident) sees the shed
        it joined into instead of waiting for the next transition."""
        self._subscribers.append(fn)
        if self.shed_level > 0:
            try:
                fn({
                    "at": self._clock(), "from": self.shed_level,
                    "to": self.shed_level, "direction": "shed",
                    "reason": "subscribed mid-shed",
                    "shedding": [CLASSES[i] for i in range(len(CLASSES))
                                 if i >= len(CLASSES) - self.shed_level],
                })
            except Exception:  # observers must never wedge the ratchet
                pass

    def unsubscribe(self, fn) -> None:
        try:
            self._subscribers.remove(fn)
        except ValueError:
            pass

    def _transition(self, level: int, reason: str) -> None:
        direction = "shed" if level > self.shed_level else "unshed"
        prev, self.shed_level = self.shed_level, level
        record = {
            "at": self._clock(), "from": prev, "to": level,
            "direction": direction, "reason": reason,
            "shedding": [CLASSES[i] for i in range(len(CLASSES))
                         if i >= len(CLASSES) - level],
        }
        self.transitions.append(record)
        del self.transitions[:-64]  # bounded history
        for fn in list(self._subscribers):
            try:
                fn(dict(record))
            except Exception:  # observers must never wedge the ratchet
                pass
        tracer.event("admission." + direction, level=level, reason=reason)
        metrics.inc("dds_admission_transitions_total", direction=direction,
                    reason=reason,
                    help="Bulwark shed-level transitions")
        # a shed-level change IS an incident-grade event either way:
        # post-mortems need to know when load shedding began and ended
        flight.record(f"admission_{direction}", level=level, prev=prev,
                      reason=reason, shedding=record["shedding"])

    # -------------------------------------------------------------- surface

    def report(self) -> dict:
        """Operator view (served under GET /slo): current level, what is
        being shed, and the recent transition history."""
        with self._lock:
            return {
                "shed_level": self.shed_level,
                "max_shed_level": self.max_shed_level,
                "shedding": [CLASSES[i] for i in range(len(CLASSES))
                             if i >= len(CLASSES) - self.shed_level],
                "healthy_streak": self._healthy_streak,
                "shed_hold": self.shed_hold,
                "transitions": list(self.transitions[-8:]),
                "tenants": {
                    "tracked": len(self._tenants),
                    "max_tracked": self.max_tracked_tenants,
                    "shed": sorted(self._tenant_shed),
                    "burn_threshold": self.tenant_burn_threshold,
                    "transitions": list(self.tenant_transitions[-8:]),
                },
            }


class AdaptiveCoalescer:
    """Sizes the fold-coalescing window from observed arrival rate.

    The proxy's coalescing window (ProxyConfig.coalesce_window) gathers
    concurrent sub-crossover folds into one segmented device dispatch. A
    fixed window is wrong at both ends: too short under load (batches
    dispatch half-full, dispatch overhead per fold stays high) and pure
    latency when sized for load but traffic is idle. This tracks a
    time-decayed EWMA of the fold arrival rate (`note_fold`, called per
    aggregate fold at the proxy) and answers `window()`:

        idle (expected co-arrivals ~ 0)  -> base window (snap small)
        loaded                           -> clamp(target_folds / rate,
                                                 base, max_window)

    so the window stretches exactly until ~`target_folds` arrivals are
    expected to share the dispatch, and no further — full, steady batch
    shapes, the property the HE-accelerator literature (BTS) gets its
    throughput from."""

    def __init__(self, base_window: float, max_window: float,
                 target_folds: float = 8.0, half_life: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.base_window = float(base_window)
        self.max_window = max(float(max_window), self.base_window)
        self.target_folds = float(target_folds)
        self.half_life = float(half_life)
        self._clock = clock
        self._lock = threading.Lock()
        self._ewma_rate = 0.0   # folds per second
        self._last: float | None = None
        self._folds = 0

    def note_fold(self, width: int = 1) -> None:
        """Record one fold arrival (the observed-load signal)."""
        with self._lock:
            self._folds += 1
            now = self._clock()
            if self._last is None:
                self._last = now
                return
            dt = max(1e-6, now - self._last)
            self._last = now
            # time-decayed EWMA: one arrival every dt seconds is an
            # instantaneous rate of 1/dt; weight by how much of the
            # half-life elapsed so bursts and lulls both converge fast
            alpha = 1.0 - math.exp(-dt / self.half_life)
            self._ewma_rate += alpha * ((1.0 / dt) - self._ewma_rate)

    def rate(self) -> float:
        """Current folds/s estimate, decayed for elapsed idle time (a
        burst an hour ago must not keep the window stretched)."""
        with self._lock:
            if self._last is None:
                return 0.0
            idle = max(0.0, self._clock() - self._last)
            return self._ewma_rate * math.exp(-idle / self.half_life)

    def window(self) -> float:
        r = self.rate()
        # fewer than one expected co-arrival even at the widest window:
        # waiting buys nothing — snap to the base window
        if r * self.max_window < 1.0:
            return self.base_window
        return min(self.max_window, max(self.base_window, self.target_folds / r))

    def stats(self) -> dict:
        return {
            "rate": round(self.rate(), 3),
            "window": round(self.window(), 6),
            "folds": self._folds,
        }
