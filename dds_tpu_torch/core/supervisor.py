"""Membership + failure manager: suspicion quorums, spares, proactive recovery.

Copy of `dds_tpu/core/supervisor.py`.

Counterpart of `dds/core/BFTSupervisor.scala`: tracks active/sentinent
replica lists, dedupes `Suspect` votes by nonce, recovers a replica once a
quorum of distinct voters suspects it, proactively recovers the oldest
active replica on a timer, and serves proxies the freshest half of the
active list.

Recovery (BFTSupervisor.scala:97-153): wake a random sentinent spare
(`Awake` -> `State{data, nonces}`), promote it to active; `Kill` the
offender (guardian-restart semantics) and re-seed it with the spare's state
via `Sleep` -> `Complying`, demoting it to sentinent. If the offender's
host is dead (ask timeout), redeploy a fresh replica at the same endpoint
through the injected factory and seed that instead. Nodes that prove
unreachable — a spare that never Awakes, or an offender that never
Complies after redeploy — accrue strikes; one miss is treated as transient
(slow restart, supervisor-side blip) and the node stays a (deprioritized)
spare, but DROP_STRIKES consecutive failures drop it from membership with
a loud warning rather than keeping a phantom that pins future recoveries
(deviation from the reference, which would retry forever); the operator
restores dropped nodes explicitly. Successful contact clears strikes.

Deviations (documented): suspicion voters are the *senders* of Suspect
votes (the reference seeds the voter set with the suspected node itself,
`BFTSupervisor.scala:79` — a bookkeeping bug); `RequestReplicas` returns at
least one endpoint even with a single active replica.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.core.transport import Transport
from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils import sigs
from dds_tpu_torch.utils.tasks import supervised_task
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.supervisor")


@dataclass
class SupervisorConfig:
    quorum_size: int = 5
    proactive_recovery_warmup: float = 5.0
    proactive_recovery_interval: float = 7.0
    sentinent_awake_timeout: float = 5.0
    crashed_recovery_timeout: float = 12.0
    proactive_recovery_enabled: bool = True
    # Aegis verified state transfer: collect HMAC-signed (tag, value-
    # digest) manifests from a quorum of active replicas before seeding;
    # the recovering node accepts only entries attested by >= f+1 distinct
    # signers (f+1 derived as 2*quorum - n_active, the BFT quorum-
    # intersection bound). Off = the reference's single-spare trust.
    verified_transfer: bool = True
    manifest_timeout: float = 2.0
    # keys per StateChunk frame: large repositories stream as bounded
    # frames instead of one giant Sleep payload
    state_chunk_keys: int = 256
    # intranet secret for verifying manifest HMACs at collection time
    # (the recovering node re-verifies them independently)
    abd_mac_secret: bytes = b"intranet-abd-secret"
    debug: bool = False


class BFTSupervisor:
    def __init__(
        self,
        addr: str,
        active: list[str],
        sentinent: list[str],
        net: Transport,
        config: SupervisorConfig | None = None,
        redeploy: Optional[Callable[[str], Awaitable[None]]] = None,
        rng: random.Random | None = None,
    ):
        self.addr = addr
        self.net = net
        self.cfg = config or SupervisorConfig()
        self.active: list[tuple[str, int]] = [(a, time.monotonic_ns()) for a in active]
        self.sentinent: list[str] = list(sentinent)
        self.nonces: set[int] = set()
        self.quorum: dict[str, set[str]] = {}
        self.redeploy = redeploy
        self._rng = rng or random.Random()
        self._pending: dict[str, asyncio.Future] = {}
        self._task: Optional[asyncio.Task] = None
        self._recovering: set[str] = set()  # endpoints with recovery in flight
        # recovery-complete hook: set whenever NO recovery is in flight.
        # Event-driven waiters (tests, graceful stop) use this instead of
        # sleeping-and-hoping — cancelling a recovery mid-swap tears
        # membership (spare promoted, offender not yet demoted).
        self._idle = asyncio.Event()
        self._idle.set()
        self._inflight: Optional[asyncio.Task] = None  # proactive recover task
        # consecutive unreachability strikes (Awake / post-redeploy Sleep
        # timeouts). One timeout may be transient (slow restart, supervisor-
        # side blip), so nodes are only DROPPED from membership after
        # DROP_STRIKES consecutive failures; any successful contact clears
        # the count. Least-struck spares are preferred for recovery.
        self._strikes: dict[str, int] = {}
        # manifest collections in flight: request nonce -> (future,
        # sender -> StateDigest, target reply count)
        self._manifest_collects: dict[int, tuple] = {}
        net.register(addr, self.handle)

    # ----------------------------------------------------------- life cycle

    def start(self) -> None:
        if self.cfg.proactive_recovery_enabled and self._task is None:
            self._task = supervised_task(self._proactive_loop(),
                                         name="supervisor.proactive")

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # graceful: a recovery the loop had in flight keeps running under
        # the shield below — await it so stop() never tears membership
        # mid-swap (promoted spare without the offender demoted). Bounded
        # by the recovery path's own timeouts.
        inflight = self._inflight
        if inflight is not None and not inflight.done():
            try:
                await inflight
            except Exception:  # recovery failures are already logged
                pass
        self._inflight = None

    async def wait_recovery_idle(self, timeout: float = 10.0) -> bool:
        """Event-driven recovery-complete hook: resolves once no recovery
        (proactive OR suspicion-quorum-driven) is in flight. Returns False
        on timeout instead of raising — callers decide how loud to be."""
        try:
            await asyncio.wait_for(self._idle.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def _proactive_loop(self) -> None:
        await asyncio.sleep(self.cfg.proactive_recovery_warmup)
        while True:
            if self.active:
                oldest, _ = min(self.active, key=lambda r: r[1])
                if self.cfg.debug:
                    log.info("proactively recovering %s", oldest)
                # shield: cancelling this loop (stop()) must not cancel a
                # swap mid-flight — stop() awaits the task instead
                rec = supervised_task(self.recover(oldest),
                                      name=f"supervisor.recover:{oldest}")
                self._inflight = rec
                try:
                    await asyncio.shield(rec)
                finally:
                    if rec.done():
                        self._inflight = None
            await asyncio.sleep(self.cfg.proactive_recovery_interval)

    # ------------------------------------------------------------- messages

    async def handle(self, sender: str, msg) -> None:
        match msg:
            case M.RequestReplicas():
                # freshest half of the active list, minimum one
                by_age = sorted(self.active, key=lambda r: r[1], reverse=True)
                take = max(1, len(by_age) // 2)
                self.net.send(
                    self.addr, sender, M.ActiveReplicas([a for a, _ in by_age[:take]])
                )

            case M.Suspect(replica, nonce):
                if nonce in self.nonces:
                    return
                self.nonces.add(nonce)
                voters = self.quorum.setdefault(replica, set())
                voters.add(sender)
                if len(voters) >= self.cfg.quorum_size:
                    if self.cfg.debug:
                        log.info("replica %s suspected faulty; recovering", replica)
                    # a suspicion quorum IS a fault event: freeze the
                    # telemetry that led here before recovery churns it
                    tracer.event("supervisor.suspicion_quorum",
                                 replica=replica, voters=len(voters))
                    metrics.inc(
                        "dds_suspicion_quorums_total",
                        replica=replica.rsplit("/", 1)[-1],
                        help="suspicion quorums reached (recovery triggers)",
                    )
                    await flight.record_async(
                        "suspicion_quorum", replica=replica,
                        voters=sorted(voters),
                    )
                    # clear the vote tally NOW so votes landing while the
                    # recovery awaits don't re-trigger it
                    self.quorum[replica] = set()
                    await self.recover(replica)

            case M.State(_, _) | M.Complying():
                fut = self._pending.pop(f"{type(msg).__name__}:{sender}", None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)

            case M.StateDigest(manifest, nonce, signature):
                coll = self._manifest_collects.get(nonce)
                if coll is None:
                    return
                fut, votes, target = coll
                if sender in votes:
                    return
                # verify at collection time too (the recovering node
                # re-verifies independently); an invalid HMAC is dropped
                # and never counted toward the quorum
                if not sigs.validate_manifest_signature(
                    self.cfg.abd_mac_secret, sender, manifest, nonce, signature
                ):
                    log.warning("dropping StateDigest with bad HMAC from %s",
                                sender)
                    return
                votes[sender] = msg
                if len(votes) >= target and not fut.done():
                    fut.set_result(None)

    def _expect(self, dest: str, reply_type: str) -> asyncio.Future:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[f"{reply_type}:{dest}"] = fut
        return fut

    async def _await_reply(self, dest: str, reply_type: str,
                           fut: asyncio.Future, timeout: float):
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(f"{reply_type}:{dest}", None)

    async def _ask(self, dest: str, msg, reply_type: str, timeout: float):
        fut = self._expect(dest, reply_type)
        self.net.send(self.addr, dest, msg)
        return await self._await_reply(dest, reply_type, fut, timeout)

    # ------------------------------------------------------------- recovery

    DROP_STRIKES = 3

    def _strike(self, endpoint: str, why: str) -> bool:
        """Record an unreachability strike; True = threshold reached and
        the endpoint should be dropped from membership (loud warning)."""
        self._strikes[endpoint] = self._strikes.get(endpoint, 0) + 1
        if self._strikes[endpoint] >= self.DROP_STRIKES:
            log.warning(
                "replica %s %s (%d consecutive failures); dropping it from "
                "membership (operator action required)",
                endpoint, why, self._strikes[endpoint],
            )
            self._strikes.pop(endpoint, None)
            return True
        log.warning(
            "replica %s %s (strike %d/%d)",
            endpoint, why, self._strikes[endpoint], self.DROP_STRIKES,
        )
        return False

    def _support(self) -> int:
        """Distinct-signer threshold for one verified entry: the quorum-
        intersection bound 2q - n equals f+1 in a canonically-sized BFT
        topology (q = ceil((n+f+1)/2)), so any completed write's quorum
        intersects any manifest quorum in >= f+1 replicas — at least one
        honest — making the attested (tag, digest) unforgeable by any f."""
        return max(1, 2 * self.cfg.quorum_size - len(self.active))

    async def _collect_manifests(self, exclude: set) -> tuple | None:
        """Broadcast StateDigestRequest to the active replicas (minus
        `exclude`) and gather a quorum of signed manifests. Returns
        (digests, support) ready to relay in a SleepBegin, or None when
        fewer than `support` replicas attested within the timeout (a
        verified seed would then reject everything — degrade loudly)."""
        support = self._support()
        targets = [a for a, _ in self.active if a not in exclude]
        if not targets:
            return None
        target_count = min(len(targets), self.cfg.quorum_size)
        nonce = sigs.generate_nonce()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        votes: dict[str, M.StateDigest] = {}
        self._manifest_collects[nonce] = (fut, votes, target_count)
        for t in targets:
            self.net.send(self.addr, t, M.StateDigestRequest(nonce))
        try:
            await asyncio.wait_for(fut, self.cfg.manifest_timeout)
        except asyncio.TimeoutError:
            pass
        finally:
            self._manifest_collects.pop(nonce, None)
        if len(votes) < support:
            log.warning(
                "manifest quorum failed: %d/%d replicas attested (need >= %d)",
                len(votes), len(targets), support,
            )
            return None
        digests = [
            [sender, d.manifest, d.nonce, d.signature.hex()]
            for sender, d in votes.items()
        ]
        return digests, support

    async def _probe_spares(self, spares: list[str]) -> dict[str, int]:
        """Freshness per spare = the max tag seq in its signed manifest
        (0 when empty or silent — a silent spare is not *penalized* here;
        the Awake strike path owns unreachability)."""
        fresh = {s: 0 for s in spares}
        if not spares:
            return fresh
        nonce = sigs.generate_nonce()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        votes: dict[str, M.StateDigest] = {}
        self._manifest_collects[nonce] = (fut, votes, len(spares))
        for s in spares:
            self.net.send(self.addr, s, M.StateDigestRequest(nonce))
        timeout = min(self.cfg.manifest_timeout,
                      self.cfg.sentinent_awake_timeout)
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            pass
        finally:
            self._manifest_collects.pop(nonce, None)
        for sender, d in votes.items():
            if sender in fresh:
                fresh[sender] = max(
                    (int(e[0]) for e in d.manifest.values()), default=0
                )
        return fresh

    async def _seed(self, dest: str, state: M.State, verified: tuple | None,
                    timeout: float):
        """Reseed `dest` with the spare's state and await its Complying.

        Verified path: relay the collected manifest quorum in a SleepBegin
        header, then stream the state as bounded StateChunk frames — the
        node cross-checks every entry against the digest quorum, so the
        spare's State is data, not truth. `verified=None` falls back to
        the legacy single-frame Sleep (reference behavior)."""
        if verified is None:
            return await self._ask(
                dest, M.Sleep(state.data, state.nonces), "Complying", timeout
            )
        digests, support = verified
        session = sigs.generate_nonce()
        items = sorted(state.data.items())
        k = max(1, self.cfg.state_chunk_keys)
        chunks = [dict(items[i:i + k]) for i in range(0, len(items), k)] or [{}]
        fut = self._expect(dest, "Complying")
        self.net.send(
            self.addr, dest,
            M.SleepBegin(digests, session, len(chunks), support,
                         list(state.nonces)),
        )
        for seq, chunk in enumerate(chunks):
            self.net.send(self.addr, dest, M.StateChunk(session, seq, chunk))
        tracer.event("supervisor.seed", dest=dest, chunks=len(chunks),
                     keys=len(items), verified=True)
        return await self._await_reply(dest, "Complying", fut, timeout)

    async def recover(self, byzantine: str) -> None:
        """Swap the suspect with a sentinent spare; reseed or redeploy it.

        Guards (beyond the reference): only ACTIVE replicas are recoverable —
        a suspicion quorum naming an arbitrary endpoint (e.g. a proxy) must
        not consume a spare or redeploy over a non-replica address — and a
        recovery already in flight for the same endpoint (or using the last
        spare) is not re-entered by concurrent votes / the proactive timer.

        Aegis: with verified_transfer on, a quorum of signed state
        manifests is collected FIRST and relayed with the seed, so the
        recovering node never has to trust the single seeding spare; the
        spare itself is chosen freshest-first (max manifest tag seq,
        tie-break random) among the least-struck candidates.
        """
        if byzantine in self._recovering:
            return
        if byzantine not in (a for a, _ in self.active):
            log.warning("refusing to recover non-active endpoint %s", byzantine)
            return
        self._recovering.add(byzantine)
        self._idle.clear()
        spare = None
        tried: set[str] = set()
        with tracer.span("supervisor.recover", victim=byzantine) as span:
            try:
                verified = None
                if self.cfg.verified_transfer:
                    verified = await self._collect_manifests({byzantine})
                    if verified is None:
                        log.warning(
                            "verified state transfer degraded for %s: no "
                            "manifest quorum; seeding UNVERIFIED from a "
                            "single spare", byzantine,
                        )
                        metrics.inc(
                            "dds_recovery_unverified_total",
                            help="recoveries that fell back to single-spare "
                                 "trust (no manifest quorum)",
                        )
                span["verified"] = verified is not None
                freshness = await self._probe_spares(
                    [s for s in self.sentinent if s not in self._recovering]
                ) if self.cfg.verified_transfer else {}
                while True:
                    pool = [
                        s for s in self.sentinent
                        if s not in self._recovering and s not in tried
                    ]
                    if not pool:
                        log.warning(
                            "no (responsive) spare available to recover %s; "
                            "it stays active until a spare returns", byzantine,
                        )
                        return
                    # prefer the least-struck spares (recently-unresponsive
                    # ones are retried only when nothing better remains);
                    # among those, the freshest repository seeds fastest
                    best = min(self._strikes.get(s, 0) for s in pool)
                    candidates = [
                        s for s in pool if self._strikes.get(s, 0) == best
                    ]
                    top = max(freshness.get(s, 0) for s in candidates)
                    spare = self._rng.choice(
                        [s for s in candidates if freshness.get(s, 0) == top]
                    )
                    tried.add(spare)
                    self._recovering.add(spare)
                    try:
                        state = await self._ask(
                            spare, M.Awake(), "State",
                            self.cfg.sentinent_awake_timeout,
                        )
                        self._strikes.pop(spare, None)
                        break
                    except asyncio.TimeoutError:
                        self._recovering.discard(spare)
                        if self._strike(spare, "did not wake up"):
                            self.sentinent.remove(spare)
                        spare = None

                span["seeder"] = spare
                tracer.event("supervisor.seeder", victim=byzantine,
                             seeder=spare, freshness=freshness.get(spare, 0))

                # promote the spare
                self.sentinent.remove(spare)
                self.active.append((spare, time.monotonic_ns()))

                # kill (-> guardian restart) and demote the offender
                self.net.send(self.addr, byzantine, M.Kill())
                self.active = [r for r in self.active if r[0] != byzantine]

                try:
                    await self._seed(
                        byzantine, state, verified,
                        self.cfg.sentinent_awake_timeout,
                    )
                    self._strikes.pop(byzantine, None)
                    self.sentinent.append(byzantine)
                    self.quorum[byzantine] = set()
                except asyncio.TimeoutError:
                    # host is dead: redeploy a fresh replica at the endpoint
                    if self.redeploy is None:
                        log.warning("replica %s dead and no redeploy hook",
                                    byzantine)
                        return
                    if self.cfg.debug:
                        log.info("replica %s crashed; rebooting", byzantine)
                    await self.redeploy(byzantine)
                    try:
                        await self._seed(
                            byzantine, state, verified,
                            self.cfg.crashed_recovery_timeout,
                        )
                        self._strikes.pop(byzantine, None)
                    except asyncio.TimeoutError:
                        # One miss may just be a slow restart: keep it as a
                        # (struck) spare so it self-heals when it comes back.
                        # Persistent unreachability accrues strikes — here or
                        # when it is later retried as a spare — and only then
                        # is it dropped, so phantoms cannot pin recoveries
                        # forever yet a transient blip costs nothing.
                        if self._strike(byzantine, "never complied after reboot"):
                            self.quorum[byzantine] = set()
                            return
                    self.sentinent.append(byzantine)
                    self.quorum[byzantine] = set()
            finally:
                self._recovering.discard(byzantine)
                if spare is not None:
                    self._recovering.discard(spare)
                if not self._recovering:
                    self._idle.set()
