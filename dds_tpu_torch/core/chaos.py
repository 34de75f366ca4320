"""ChaosNet: a seeded network-fault fabric over any `Transport`.

Copy of `dds_tpu/core/chaos.py`. ChaosNet wraps a transport (the port's
`InMemoryNet`) and applies a SEEDED fault schedule per (src, dest) link,
so linearizability and recovery can be tested under adversarial
schedules and every run is reproducible from its seed:

- **drop**: the message never arrives;
- **delay** (fixed + uniform jitter): delivery is deferred off-loop;
- **duplicate**: the message arrives twice;
- **reorder**: the message is parked and overtaken by the link's next
  message (flushed on a timer so a quiet link cannot strand it);
- **corrupt**: one byte of the message's wire form (`messages.dumps`)
  is flipped; the receiver's HMAC and codec layers must reject it, and an
  undecodable corruption degrades to a drop;
- **partition**: symmetric or asymmetric link cuts between endpoint
  groups, with optional timed heal.

Fault decisions are drawn from one seeded `random.Random` synchronously
inside `send()`, in call order, and appended to `trace`: the same seed
over the same send sequence reproduces the same fault trace, and the
reference's ChaosNet draws the same trace from it (the wire bytes the
corrupt fault indexes are the reference's). Endpoints are matched by
bare name (`"host:port/replica-3"` -> `"replica-3"`). The region API
(`set_regions`, `set_region_link`, `region_partition`) is kept for the
geo plane, which labels endpoints; nothing in the port labels them yet.
A deferred delivery runs in its own task, which copies the sender's
contextvars, so the receiver's spans join the request's trace and the
Watchtower audits them with it.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import random
from dataclasses import dataclass, field
from typing import Optional

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.core.transport import Transport
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.tasks import supervised_task
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.chaos")


@dataclass
class LinkFaults:
    """Fault rates/parameters for one link (or one destination)."""

    drop: float = 0.0        # P(message silently lost)
    delay: float = 0.0       # fixed delivery delay, seconds
    jitter: float = 0.0      # + U(0, jitter) seconds
    duplicate: float = 0.0   # P(delivered twice)
    reorder: float = 0.0     # P(parked until the link's next message passes)
    corrupt: float = 0.0     # P(one payload byte flipped)


def _name(addr: str) -> str:
    """Bare endpoint name, transport-agnostic ("h:p/replica-3" -> "replica-3")."""
    return addr.rsplit("/", 1)[-1]


@dataclass
class Partition:
    """An active cut between `a` and `b` (None = everyone else). Symmetric
    cuts both directions; asymmetric cuts only a -> b (one-way loss)."""

    a: frozenset
    b: Optional[frozenset] = None
    symmetric: bool = True
    healed: bool = False
    _fabric: object = field(default=None, repr=False)

    def blocks(self, src: str, dest: str) -> bool:
        if self.healed:
            return False
        s, d = _name(src), _name(dest)
        if self.b is None:
            cut = (s in self.a) != (d in self.a)
            if self.symmetric:
                return cut
            return cut and s in self.a
        fwd = s in self.a and d in self.b
        if self.symmetric:
            return fwd or (s in self.b and d in self.a)
        return fwd

    def heal(self) -> None:
        self.healed = True
        if self._fabric is not None:
            self._fabric._note("*", "*", "partition", "heal")


class ChaosNet(Transport):
    """Seeded fault-injection wrapper; registration passes straight through
    to the inner transport, only `send` is intercepted."""

    def __init__(self, inner: Transport, seed: int = 0):
        self.inner = inner
        self.seed = seed
        self._rng = random.Random(seed)
        self.default_faults = LinkFaults()
        # (src_name, dest_name) -> LinkFaults, or dest_name -> LinkFaults;
        # the pair key wins over the dest key, which wins over the default
        self.links: dict = {}
        # WAN topology: bare endpoint name -> region label, and
        # (src_region, dest_region) -> LinkFaults. Resolution order per
        # send is pair > dest > region-pair > default, so a surgical
        # per-link override still beats the blanket WAN matrix
        self.regions: dict[str, str] = {}
        self.region_links: dict = {}
        self.partitions: list[Partition] = []
        # (seq, src, dest, msg type, action) — the deterministic fault trace
        self.trace: list[tuple] = []
        self._seq = 0
        self._tasks: set = set()
        # (src, dest) -> parked (msg, flush handle, sender's context) for
        # reordering
        self._parked: dict = {}

    # -------------------------------------------------- Transport interface

    def register(self, addr, handler):
        self.inner.register(addr, handler)

    def unregister(self, addr):
        self.inner.unregister(addr)

    def has_endpoint(self, addr):
        return self.inner.has_endpoint(addr)

    @property
    def advertised(self) -> str:
        """The inner transport's peer-visible "host:port"; empty for a
        fabric without one (the in-memory transport)."""
        return getattr(self.inner, "advertised", "")

    def local_addr(self, name: str) -> str:
        fn = getattr(self.inner, "local_addr", None)
        return fn(name) if fn is not None else name

    # ------------------------------------------------------------- schedule

    def set_link(self, src: str, dest: str, faults: LinkFaults) -> None:
        """Fault the (src, dest) link, both named by bare endpoint name."""
        self.links[(src, dest)] = faults

    def set_dest(self, dest: str, faults: LinkFaults) -> None:
        """Fault every link INTO `dest` (bare endpoint name)."""
        self.links[dest] = faults

    def set_pair(self, a: str, b: str, faults: LinkFaults) -> None:
        """Fault both directions between two endpoints."""
        self.links[(a, b)] = faults
        self.links[(b, a)] = faults

    def set_regions(self, mapping: dict) -> None:
        """Assign endpoints (bare names) to named regions. Merges into the
        existing assignment so groups can be labeled incrementally."""
        self.regions.update({_name(k): v for k, v in mapping.items()})

    def region_of(self, addr: str) -> str:
        """The endpoint's region label ("" when unassigned)."""
        return self.regions.get(_name(addr), "")

    def set_region_link(self, src_region: str, dest_region: str,
                        faults: LinkFaults) -> None:
        """Fault every link from `src_region` into `dest_region`. One-way:
        call twice for a symmetric WAN."""
        self.region_links[(src_region, dest_region)] = faults

    def region_members(self, region: str) -> list[str]:
        """Bare endpoint names currently assigned to `region`, sorted."""
        return sorted(n for n, r in self.regions.items() if r == region)

    def region_partition(
        self,
        region: str,
        symmetric: bool = True,
        duration: Optional[float] = None,
    ) -> Partition:
        """Cut an entire region off from the rest of the fleet — the
        region-death primitive. Asymmetric cuts only traffic LEAVING the
        region (its members still hear the world but cannot answer)."""
        members = self.region_members(region)
        if not members:
            raise ValueError(f"region {region!r} has no registered endpoints")
        return self.partition(members, symmetric=symmetric, duration=duration)

    def clear_faults(self) -> None:
        self.links.clear()
        self.region_links.clear()
        self.default_faults = LinkFaults()

    def partition(
        self,
        a,
        b=None,
        symmetric: bool = True,
        duration: Optional[float] = None,
    ) -> Partition:
        """Cut links between groups `a` and `b` (None = everyone else);
        returns the Partition, healable via `.heal()` or automatically
        after `duration` seconds."""
        p = Partition(
            frozenset(_name(x) for x in a),
            None if b is None else frozenset(_name(x) for x in b),
            symmetric,
            _fabric=self,
        )
        self.partitions.append(p)
        self._note("*", "*", "partition", f"cut a={sorted(p.a)}")
        if duration is not None:
            self._spawn(self._timed_heal(p, duration))
        return p

    def heal_all(self) -> None:
        """Lift every partition and clear all link faults."""
        for p in self.partitions:
            p.healed = True
        self.partitions.clear()
        self.clear_faults()
        self._note("*", "*", "heal", "all")

    async def _timed_heal(self, p: Partition, duration: float) -> None:
        await asyncio.sleep(duration)
        p.heal()

    # ----------------------------------------------------------------- send

    def _faults_for(self, src: str, dest: str) -> LinkFaults:
        s, d = _name(src), _name(dest)
        explicit = self.links.get((s, d)) or self.links.get(d)
        if explicit is not None:
            return explicit
        if self.region_links:
            rp = self.region_links.get(
                (self.regions.get(s, ""), self.regions.get(d, "")))
            if rp is not None:
                return rp
        return self.default_faults

    def _note(self, src: str, dest: str, kind: str, action: str) -> None:
        self.trace.append((self._seq, _name(src), _name(dest), kind, action))
        self._seq += 1
        # trace annotations: _note runs synchronously inside send(), so
        # the event lands on the REQUEST's trace (contextvar still set) —
        # a post-mortem sees exactly which quorum leg the fabric dropped or
        # delayed. The metric label is the action family only ("delay", not
        # "delay=0.0123"): label values must stay bounded.
        act = action.split("=", 1)[0]
        metrics.inc("dds_chaos_events_total", action=act,
                    help="ChaosNet fault injections by action")
        tracer.event("chaos." + act, src=_name(src), dest=_name(dest),
                     msg=kind, action=action)

    def send(self, src: str, dest: str, msg: object) -> None:
        # every fault decision happens HERE, synchronously in send-call
        # order, so the rng stream (and therefore the trace) is a pure
        # function of the seed and the send sequence
        kind = type(msg).__name__
        for p in self.partitions:
            if p.blocks(src, dest):
                self._note(src, dest, kind, "partition_drop")
                return
        f = self._faults_for(src, dest)
        rng = self._rng
        if f.drop and rng.random() < f.drop:
            self._note(src, dest, kind, "drop")
            return
        if f.corrupt and rng.random() < f.corrupt:
            msg = self._corrupt(msg)
            if msg is None:
                self._note(src, dest, kind, "corrupt_undecodable")
                return
            self._note(src, dest, kind, "corrupt")
        delay = f.delay + (rng.uniform(0.0, f.jitter) if f.jitter else 0.0)
        copies = 2 if f.duplicate and rng.random() < f.duplicate else 1
        if copies == 2:
            self._note(src, dest, kind, "duplicate")
        park = bool(f.reorder) and rng.random() < f.reorder

        # a parked predecessor on this link is released BEHIND this message
        link = (_name(src), _name(dest))
        parked = self._parked.pop(link, None)

        if park and parked is None:
            self._note(src, dest, kind, "parked")
            handle = self._spawn(self._flush_parked(link, delay + 0.05))
            self._parked[link] = (src, dest, msg, delay, copies, handle,
                                  contextvars.copy_context())
            return
        if delay > 0:
            self._note(src, dest, kind, f"delay={delay:.4f}")
        for _ in range(copies):
            self._dispatch(src, dest, msg, delay)
        if parked is not None:
            psrc, pdest, pmsg, pdelay, pcopies, phandle, pctx = parked
            phandle.cancel()
            self._note(psrc, pdest, type(pmsg).__name__, "released_reordered")
            self._release(parked)

    def _release(self, parked: tuple) -> None:
        """Deliver a parked message under its own sender's context, so the
        receiver's spans join the trace that sent it, not the trace whose
        send (or quiesce) happened to release it. The reference releases
        it under the releasing send's context, which moves those spans to
        another trace and makes the Watchtower see two broken quorums."""
        src, dest, msg, delay, copies, _, ctx = parked
        for _ in range(copies):
            ctx.run(self._dispatch, src, dest, msg, delay)

    def _dispatch(self, src: str, dest: str, msg: object, delay: float) -> None:
        if delay > 0:
            self._spawn(self._deliver_later(src, dest, msg, delay))
        else:
            self.inner.send(src, dest, msg)

    async def _deliver_later(self, src, dest, msg, delay) -> None:
        await asyncio.sleep(delay)
        self.inner.send(src, dest, msg)

    async def _flush_parked(self, link, after: float) -> None:
        """A quiet link must not strand a parked message forever."""
        await asyncio.sleep(after)
        parked = self._parked.pop(link, None)
        if parked is not None:
            self._release(parked)

    def _corrupt(self, msg):
        """Flip one byte of the canonical serialization. A still-decodable
        mutation reaches the receiver (whose MAC layer must reject it); an
        undecodable one degrades to a drop, as a frame decoder's guard
        would."""
        try:
            raw = bytearray(M.dumps(msg))
        except Exception:
            return None
        raw[self._rng.randrange(len(raw))] ^= 0x20
        try:
            return M.loads(bytes(raw))
        except Exception:
            return None

    def _spawn(self, coro) -> asyncio.Task:
        task = supervised_task(coro, name="chaos.delivery")
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    # ------------------------------------------------------------ lifecycle

    async def quiesce(self) -> None:
        """Drain chaos-deferred deliveries, then the inner transport's
        in-flight work (and any follow-ups they spawned)."""
        while True:
            pending = [t for t in self._tasks if not t.done()]
            if not pending and not self._parked:
                break
            for link in list(self._parked):
                parked = self._parked.pop(link, None)
                if parked is not None:
                    parked[5].cancel()
                    self._release(parked)
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            await asyncio.sleep(0)
        inner_quiesce = getattr(self.inner, "quiesce", None)
        if inner_quiesce is not None:
            await inner_quiesce()

    async def start(self) -> None:
        start = getattr(self.inner, "start", None)
        if start is not None:
            await start()

    async def stop(self) -> None:
        """Cancel chaos-deferred deliveries. The INNER transport is left to
        its own owner (launch() tracks it as a separate stoppable; wrapping
        must not double-stop it)."""
        for t in list(self._tasks):
            t.cancel()
        for t in list(self._tasks):
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._parked.clear()
