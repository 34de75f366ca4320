"""Helmsman: the fleet's self-steering loop — SLO burn in, shape out.

Copy of `dds_tpu/fleet/helmsman.py`: the same decision tick, restraint,
override, records and series, so one signal sequence on one clock gives
the same actions, reports and flight records in both packages. In-process
(`run._launch_constellation`) the `source_ages` and `regions` feeds stay
None, as the reference's launch leaves them: their sources (the fleet
collector's heartbeats, geo labels) are multi-host planes the port does
not serve, so only an injected `source_ages` (or a `canary_unreachable`
feed with `regions`) reaches `_check_liveness` here.

The reproduction's dependability story is proactive at the replica level
(supervisor swaps in sentinent spares) and reactive at the proxy
(Bulwark sheds, breakers fast-fail), but the FLEET SHAPE — how many
quorum groups serve the keyspace — was hand-steered: a human watched SLO
burn and POSTed /_reshard, and nothing ever merged capacity back.
Helmsman closes that loop. One instance per fleet, resident next to the
router it observes, flight-recorded like every other controller:

- **signals** (injected callables, the AdmissionController pattern — the
  controller owns no collection machinery and tests drive it with plain
  lambdas + a fake clock): multiwindow SLO burn (`SloEngine.alerts`),
  Bulwark shed level, breaker census, per-group routed-op share
  (`ShardRouter.load_census` deltas), resident-pool pressure, and — for
  dead-group detection — the Panopticon collector's per-source heartbeat
  ages (the span shipper beats ~1/s even when idle, so a silent group
  process is a LOUD signal).
- **actions**: `split(hot_gid)` onto a warm standby when the fleet is in
  distress and one group carries the load; `merge(cold_gid)` to fold a
  cold group back into its ring neighbors when the fleet is calm;
  `promote(dead_gid)` to relabel a dead group's keyspace onto a standby.
- **restraint** (the BTS lesson — throughput tracks how little
  ciphertext you re-move): hot/cold streak hysteresis, a cooldown after
  every action, and a sliding-window **migrated-bytes budget** charged
  with the rebalancer's actual moved bytes, so the controller prices
  every reshape in data moved and can never thrash the fleet into
  permanent migration.
- **override**: `pin()` freezes the shape (autoscaling halts, liveness
  promotion keeps running); `unpin()` resumes. The runbook knob for
  planned maintenance and incident triage.

`step()` is one synchronous-decision tick (async only because actions
are); `start()` runs it on a supervised task every `interval` seconds.
"""

from __future__ import annotations

import collections
import logging
import time

from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.tasks import supervised_task

log = logging.getLogger("dds_torch.fleet.helmsman")


class Helmsman:
    def __init__(
        self,
        *,
        # ---- signals (callables; None disables that signal) ----
        load_census,                 # () -> {gid: cumulative routed ops}
        slo_alerts=None,             # () -> [route, ...] currently burning
        shed_level=None,             # () -> int (Bulwark shed level)
        breaker_census=None,         # () -> (trusted_total, [open ETAs])
        pool_pressure=None,          # () -> 0..1 resident-pool occupancy
        source_ages=None,            # () -> {gid: seconds since heartbeat}
        regions=None,                # () -> {gid: home region} (Atlas)
        tenant_burns=None,           # () -> {tenant: burn} (Bastion)
        canary_unreachable=None,     # () -> {region, ...} (Heliograph)
        # ---- actions (async callables) ----
        split=None,                  # async (gid) -> None
        merge=None,                  # async (gid) -> None
        promote=None,                # async (gid) -> None
        moved_bytes=None,            # () -> cumulative migrated bytes
        reshard_busy=None,           # () -> bool (a plan holds the lock)
        # ---- knobs (mirrored by utils/config.HelmsmanConfig) ----
        interval: float = 5.0,
        hot_streak: int = 3,
        cold_streak: int = 6,
        hot_share: float = 0.5,
        cold_share: float = 0.1,
        min_ops: int = 20,
        min_groups: int = 1,
        max_groups: int = 8,
        cooldown: float = 30.0,
        budget_bytes: int = 64 * 1024 * 1024,
        budget_window: float = 600.0,
        heartbeat_timeout: float = 15.0,
        clock=time.monotonic,
    ):
        self._load_census = load_census
        self._slo_alerts = slo_alerts or (lambda: [])
        self._shed_level = shed_level or (lambda: 0)
        self._breaker_census = breaker_census or (lambda: (0, []))
        self._pool_pressure = pool_pressure
        self._source_ages = source_ages
        self._regions = regions
        self._tenant_burns = tenant_burns
        self._canary_unreachable = canary_unreachable
        self._regions_down: set = set()  # regions currently declared dead
        self._split = split
        self._merge = merge
        self._promote = promote
        self._moved_bytes = moved_bytes or (lambda: 0)
        self._reshard_busy = reshard_busy or (lambda: False)
        self.interval = interval
        self.hot_streak = hot_streak
        self.cold_streak = cold_streak
        self.hot_share = hot_share
        self.cold_share = cold_share
        self.min_ops = min_ops
        self.min_groups = min_groups
        self.max_groups = max_groups
        self.cooldown = cooldown
        self.budget_bytes = budget_bytes
        self.budget_window = budget_window
        self.heartbeat_timeout = heartbeat_timeout
        self._clock = clock
        self.pinned = False
        self._last_counts: dict[str, int] = dict(load_census())
        self._hot_streaks: dict[str, int] = {}
        self._cold_streaks: dict[str, int] = {}
        self._cooldown_until = 0.0
        self._promoted: dict[str, float] = {}   # gid -> last promote time
        self._spend = collections.deque()       # (t, bytes) in the window
        self._last_admission: dict | None = None
        self.history = collections.deque(maxlen=64)
        self._task = None
        self.ticks = 0

    @classmethod
    def from_config(cls, hm_cfg, **signals) -> "Helmsman":
        """Build from a HelmsmanConfig-shaped object (duck-typed), with
        the signal/action callables passed through. `pin = true` starts
        the controller with autoscaling frozen."""
        hm = cls(
            interval=float(getattr(hm_cfg, "interval", 5.0)),
            hot_streak=int(getattr(hm_cfg, "hot_streak", 3)),
            cold_streak=int(getattr(hm_cfg, "cold_streak", 6)),
            hot_share=float(getattr(hm_cfg, "hot_share", 0.5)),
            cold_share=float(getattr(hm_cfg, "cold_share", 0.1)),
            min_ops=int(getattr(hm_cfg, "min_ops", 20)),
            min_groups=int(getattr(hm_cfg, "min_groups", 1)),
            max_groups=int(getattr(hm_cfg, "max_groups", 8)),
            cooldown=float(getattr(hm_cfg, "cooldown", 30.0)),
            budget_bytes=int(getattr(hm_cfg, "budget_bytes", 1 << 26)),
            budget_window=float(getattr(hm_cfg, "budget_window", 600.0)),
            heartbeat_timeout=float(
                getattr(hm_cfg, "heartbeat_timeout", 15.0)
            ),
            **signals,
        )
        hm.pinned = bool(getattr(hm_cfg, "pin", False))
        return hm

    # ------------------------------------------------------------- signals

    def on_admission(self, record: dict) -> None:
        """`AdmissionController.subscribe` target: shed transitions reach
        the controller push-style (no polling race on short sheds)."""
        self._last_admission = dict(record)

    # ------------------------------------------------------------ override

    def pin(self) -> None:
        """Freeze the fleet shape: no split/merge until `unpin()` —
        liveness promotion of a DEAD group keeps running (a pin must
        never turn a process crash into an unserved keyspace)."""
        self.pinned = True
        self._note("pin")

    def unpin(self) -> None:
        self.pinned = False
        # fresh hysteresis: pre-pin streaks must not trigger instantly
        self._hot_streaks.clear()
        self._cold_streaks.clear()
        self._note("unpin")

    # -------------------------------------------------------------- budget

    def _budget_spent(self) -> int:
        now = self._clock()
        while self._spend and now - self._spend[0][0] > self.budget_window:
            self._spend.popleft()
        return sum(b for _, b in self._spend)

    def budget_remaining(self) -> int:
        return max(0, self.budget_bytes - self._budget_spent())

    def _charge(self, before: int) -> int:
        moved = max(0, self._moved_bytes() - before)
        if moved:
            self._spend.append((self._clock(), moved))
        return moved

    # ------------------------------------------------------------- records

    def _note(self, action: str, **detail) -> None:
        rec = {"t": self._clock(), "action": action, **detail}
        self.history.append(rec)
        metrics.inc("dds_helmsman_actions_total", action=action,
                    help="Helmsman decisions by kind")
        flight.record("helmsman", action=action, **detail)
        log.info("helmsman %s %s", action, detail or "")

    # ----------------------------------------------------------------- tick

    def _shares(self) -> tuple[dict[str, float], int]:
        counts = dict(self._load_census())
        delta = {
            g: counts.get(g, 0) - self._last_counts.get(g, 0)
            for g in counts
        }
        self._last_counts = counts
        total = sum(max(0, d) for d in delta.values())
        if total <= 0:
            return {g: 0.0 for g in counts}, 0
        return {g: max(0, d) / total for g, d in delta.items()}, total

    def _distressed(self) -> tuple[bool, dict]:
        alerts = list(self._slo_alerts())
        shed = int(self._shed_level())
        _, etas = self._breaker_census()
        pool = self._pool_pressure() if self._pool_pressure else 0.0
        detail = {"slo_alerts": alerts, "shed_level": shed,
                  "open_breakers": len(etas), "pool_pressure": round(pool, 3)}
        # Bastion attribution: when one tenant dominates the burn, every
        # decision this tick records WHO drove it — a split announced as
        # "tenant X's burn" is the runbook difference between adding
        # capacity and asking why X floods (Bulwark sheds X either way)
        if self._tenant_burns is not None:
            try:
                burns = {t: float(b) for t, b
                         in dict(self._tenant_burns()).items() if b > 0}
            except Exception:  # noqa: BLE001 — a broken signal never blocks
                burns = {}
            if burns:
                top = max(burns, key=burns.get)
                detail["tenant"] = top
                detail["tenant_burn"] = round(burns[top], 3)
        return bool(alerts or shed > 0 or pool >= 0.9), detail

    def _dead_regions(self, ages: dict, known: set) -> dict:
        """Atlas region-death detection: regions whose EVERY homed group's
        heartbeat has aged out at once. Returns {gid: home region} labels
        for promotion detail; declares/clears `region_down` incidents as
        the region dies and heals (a single dead group in a live region
        is a process crash, not a region event)."""
        if self._regions is None:
            return {}
        labels = {g: r for g, r in dict(self._regions()).items() if r}
        stale = {g for g, a in ages.items()
                 if g in known and a >= self.heartbeat_timeout}
        for region in sorted(set(labels.values())):
            homed = {g for g, r in labels.items()
                     if r == region and g in known}
            if homed and homed <= stale:
                if region not in self._regions_down:
                    self._regions_down.add(region)
                    self._note("region_down", region=region,
                               groups=sorted(homed))
                    metrics.inc(
                        "dds_helmsman_region_down_total", region=region,
                        help="whole-region heartbeat losses declared by "
                             "Helmsman",
                    )
            else:
                self._regions_down.discard(region)
        return labels

    async def _check_liveness(self) -> str | None:
        """Dead-group takeover — runs even when pinned. Region-aware
        (Atlas): a whole region aging out is declared `region_down`, and
        each of its groups is promoted like any dead group — the fabric's
        promote prefers a standby homed where the dead group lived, which
        for a dead region means the cross-region takeover the drill
        exercises."""
        if self._promote is None or (
                self._source_ages is None
                and self._canary_unreachable is None):
            return None
        now = self._clock()
        known = set(self._last_counts)
        ages = dict(self._source_ages()) if self._source_ages else {}
        # Heliograph black-box evidence: a region whose canary probes hit
        # the sustained-unreachable streak is treated as aged-out even
        # while its heartbeats still arrive — a process can heartbeat
        # with its SERVING path dead (wedged event loop downstream of the
        # edge, partitioned quorum), and the probes drive the real route.
        # Synthesizing the age (instead of a separate path) feeds the
        # same `_dead_regions` declaration and promotion flow the
        # heartbeat evidence does.
        if self._canary_unreachable is not None and self._regions is not None:
            try:
                down = set(self._canary_unreachable())
            except Exception:  # noqa: BLE001 — a broken signal is silence
                down = set()
            if down:
                for gid, region in dict(self._regions()).items():
                    if region in down:
                        ages[gid] = max(ages.get(gid, 0.0),
                                        self.heartbeat_timeout)
        labels = self._dead_regions(ages, known)
        for gid, age in ages.items():
            if gid not in known or age < self.heartbeat_timeout:
                continue
            if now - self._promoted.get(gid, -1e18) < 2 * self.cooldown:
                continue  # takeover already launched; give it time
            self._promoted[gid] = now
            self._note("promote", dead=gid, heartbeat_age=round(age, 1),
                       region=labels.get(gid, ""))
            try:
                await self._promote(gid)
                self._cooldown_until = now + self.cooldown
                return "promote"
            except Exception as e:
                self._note("promote_failed", dead=gid, error=repr(e))
                return None
        return None

    async def step(self) -> str | None:
        """One decision tick. Returns the action taken ("split", "merge",
        "promote") or None — the unit tests' whole surface."""
        self.ticks += 1
        shares, total = self._shares()
        metrics.set("dds_helmsman_groups", len(shares),
                    help="groups in the active shard map (Helmsman view)")
        acted = await self._check_liveness()
        if acted:
            return acted
        if self.pinned:
            return None
        now = self._clock()
        if now < self._cooldown_until or self._reshard_busy():
            return None
        distressed, detail = self._distressed()
        confident = total >= self.min_ops

        # hot side: distress + one group carrying the load -> split
        for gid, share in shares.items():
            if distressed and confident and share >= self.hot_share:
                self._hot_streaks[gid] = self._hot_streaks.get(gid, 0) + 1
            else:
                self._hot_streaks.pop(gid, None)
        # cold side: calm fleet + a group seeing almost nothing -> merge
        for gid, share in shares.items():
            if (not distressed and confident and shed_ok(self._shed_level)
                    and share <= self.cold_share):
                self._cold_streaks[gid] = self._cold_streaks.get(gid, 0) + 1
            else:
                self._cold_streaks.pop(gid, None)

        budget_left = self.budget_remaining()
        if budget_left <= 0:
            metrics.set("dds_helmsman_budget_exhausted", 1,
                        help="1 while the migrated-bytes window is spent")
            return None
        metrics.set("dds_helmsman_budget_exhausted", 0,
                    help="1 while the migrated-bytes window is spent")

        if self._split is not None and len(shares) < self.max_groups:
            hot = [g for g, s in self._hot_streaks.items()
                   if s >= self.hot_streak]
            if hot:
                gid = max(hot, key=lambda g: shares.get(g, 0.0))
                return await self._act("split", self._split, gid,
                                       share=round(shares.get(gid, 0), 3),
                                       **detail)
        if self._merge is not None and len(shares) > self.min_groups:
            cold = [g for g, s in self._cold_streaks.items()
                    if s >= self.cold_streak]
            if cold:
                gid = min(cold, key=lambda g: shares.get(g, 1.0))
                return await self._act("merge", self._merge, gid,
                                       share=round(shares.get(gid, 0), 3),
                                       **detail)
        return None

    async def _act(self, action: str, fn, gid: str, **detail) -> str | None:
        before = self._moved_bytes()
        self._note(action, group=gid,
                   budget_remaining=self.budget_remaining(), **detail)
        try:
            await fn(gid)
        except Exception as e:
            # an aborted plan left the old map in force — cool down and
            # re-observe rather than hammering the same reshape
            self._note(f"{action}_failed", group=gid, error=repr(e))
            self._cooldown_until = self._clock() + self.cooldown
            return None
        moved = self._charge(before)
        self._cooldown_until = self._clock() + self.cooldown
        self._hot_streaks.clear()
        self._cold_streaks.clear()
        self._note(f"{action}_done", group=gid, moved_bytes=moved)
        return action

    # ----------------------------------------------------------- lifecycle

    async def _loop(self) -> None:
        import asyncio

        while True:
            await asyncio.sleep(self.interval)
            try:
                await self.step()
            except Exception:  # noqa: BLE001 — the loop must outlive a tick
                log.exception("helmsman tick failed")

    def start(self) -> None:
        if self._task is None:
            self._task = supervised_task(self._loop(), name="helmsman")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    # -------------------------------------------------------------- health

    def report(self) -> dict:
        return {
            "pinned": self.pinned,
            "ticks": self.ticks,
            "cooldown_remaining": max(
                0.0, round(self._cooldown_until - self._clock(), 2)
            ),
            "budget_remaining_bytes": self.budget_remaining(),
            "hot_streaks": dict(self._hot_streaks),
            "cold_streaks": dict(self._cold_streaks),
            "last_admission": self._last_admission,
            "recent": list(self.history)[-8:],
        }


def shed_ok(shed_level) -> bool:
    """Merging is forbidden while Bulwark sheds ANY class — removing
    capacity under admission pressure is how autoscalers oscillate."""
    try:
        return int(shed_level()) == 0
    except Exception:  # noqa: BLE001 — a broken signal must not block ticks
        return False
