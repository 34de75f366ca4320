"""Watchtower: online BFT invariant auditing over the Telescope plane.

Copy of `dds_tpu/obs/watchtower.py`: the same invariants, verdicts and
bookkeeping, so the same records give the same verdicts in both packages.
The lease checks audit the geo plane's read-local reads: the quorum
client tags each one `lease=True` with the serving `replica`, and `run`
configures `lease_lookup` on the Constellation's lease tables. One
divergence: a trace evicted unaudited from the in-flight buffer (more
than `max_traces` in flight) stays unaudited; its later spans are
dropped, where the reference audits them from a fresh buffer as if the
trace began there, so an overloaded proxy's evicted reads came out as
`quorum_intersection` verdicts with no replica in their read phase.

Telescope (obs/) records what happened — span trees per request, metrics,
flight incidents — but nothing *consumes* it: a Byzantine coordinator that
answers a write without a quorum, a forged tag that moves a key backwards,
or a breaker that teleports between states all pass silently unless a
human reads traces. Watchtower closes that loop: it subscribes to the
process tracer (`utils/trace.Tracer.subscribe`) and audits every completed
trace online, checking the dependability invariants the paper's claim
rests on:

- `quorum_intersection` — every committed quorum op's phase participant
  sets (replicas that handled the Read/ReadTag phase vs the Write phase,
  scoped to that op's span subtree) must each hold >= quorum_size distinct
  replicas and pairwise intersect in >= max(1, 2q - n) (= f+1 at n=2f+q-n
  ... the bound verified state transfer already uses). A coordinator that
  answered the proxy early — fewer than q replicas ever saw the write —
  is caught here.
- `tag_monotonicity` — per key, across reads AND writes: an op that
  starts after another op on the same key completed must never commit a
  LOWER (seq, id) tag, and a committed write must never re-mint a tag an
  earlier completed op already carried. A coordinator forging a stale
  (properly MAC'd) reply is caught here.
- `read_sees_latest` — within one trace: a read must return a tag >= any
  write to the same key that completed earlier in the same trace.
- `repair_convergence` — anti-entropy `audit.repair` events must install
  a tag >= the tag the peer advertised for that key (a lying peer that
  advertises fresh and serves stale never converges).
- `breaker_legality` — per-target breaker transitions must follow the
  machine: `half_open` is only reachable from `open` (any state may close
  on success or open on failure).
- `suspicion_legality` — a coordinator that accumulated 3 protocol
  violations is permanently excluded; any op committed through it AFTER
  the third strike is a violation.
- `lease_intersection` — Atlas lease reads (spans tagged `lease=True`)
  legally bypass the quorum-intersection bound: their freshness rests on
  the holder-pinned quorum geometry instead (while a lease is active,
  every quorum its group closes includes the holder — dds_tpu/geo). The
  auditable residue is that the serving replica actually HOLDS a lease:
  with a configured `lease_lookup`, a lease-tagged read served by a
  non-holder is a forged local read and a violation.
- `lease_staleness` — the documented weaker bound for lease reads: a
  lease read that returns a tag older than a write known-completed
  before it started is REPORTED under this invariant (the residual
  grant-instant window, bounded by one in-flight round + lease TTL by
  construction), never as `tag_monotonicity`/`read_sees_latest` — so a
  geo drill can assert "only the documented lease-window verdicts, and
  nothing else".

Every violation becomes a structured `Verdict`, increments
`dds_audit_violations_total{invariant=...}`, and files a flight-recorder
incident (`audit_<invariant>`) carrying the offending trace — telemetry
to automated verdicts, never an exception into the audited path.

Scope: the auditor sees THIS process's tracer ring, so quorum checks are
only sound when every replica of the deployment records spans here
(single-process topologies — the default, and every chaos/test harness).
`run.launch` disables `check_quorum` for multi-host splits; the tag,
repair, and state-machine checks audit proxy/agent-side commits and stay
sound everywhere. Late spans that land after a root span completed (a
chaos-delayed straggler delivery) are not re-audited: completed ops
causally precede their root's completion, so the audited tree is always a
superset of what the commit required.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass, field

from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics

log = logging.getLogger("dds_torch.watchtower")

__all__ = ["Verdict", "Watchtower", "watchtower"]

# phase classification of replica.handle spans by message type
_READ_PHASE_MSGS = {"Read", "ReadTag"}
_WRITE_PHASE_MSGS = {"Write"}
_BREAKER_EVENTS = {"breaker.open", "breaker.half_open", "breaker.closed"}


@dataclass(frozen=True)
class Verdict:
    """One audited invariant violation."""

    invariant: str
    trace_id: str | None
    ts: float
    detail: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "invariant": self.invariant,
            "trace_id": self.trace_id,
            "ts": self.ts,
            "detail": self.detail,
        }


@dataclass
class _Op:
    """A committed quorum op distilled from an abd.* span."""

    op: str                 # "read" | "write"
    key: str
    tag: tuple              # (seq, id)
    start: float
    end: float
    trace_id: str | None
    coordinator: str = ""
    lease: bool = False     # Atlas read-local lease fast path
    replica: str = ""       # the lease holder that served it


class Watchtower:
    """Online trace auditor; attach to a Tracer via `attach()`."""

    def __init__(
        self,
        quorum_size: int = 5,
        n_replicas: int = 7,
        check_quorum: bool = True,
        suspicion_limit: int = 3,
        max_traces: int = 512,
        max_trace_spans: int = 4096,
        max_verdicts: int = 256,
        history_per_key: int = 8,
    ):
        self._lock = threading.Lock()
        self._tracer = None
        self.configure(
            quorum_size=quorum_size,
            n_replicas=n_replicas,
            check_quorum=check_quorum,
        )
        self.suspicion_limit = suspicion_limit
        self.max_traces = max_traces
        self.max_trace_spans = max_trace_spans
        self.history_per_key = history_per_key
        # trace_id -> [SpanRecord] for traces still in flight
        self._traces: collections.OrderedDict = collections.OrderedDict()
        # ids of traces evicted unaudited whose roots have not arrived yet
        # (bounded): their later spans are dropped, never audited as a tree
        self._evicted: collections.OrderedDict = collections.OrderedDict()
        self._verdicts: collections.deque = collections.deque(maxlen=max_verdicts)
        self._violation_counts: collections.Counter = collections.Counter()
        # key -> bounded [_Op] history (max-tag entry always retained)
        self._key_history: dict[str, list] = {}
        self._breaker_state: dict[str, str] = {}
        self._suspicion: collections.Counter = collections.Counter()
        self._excluded_at: dict[str, float] = {}  # node -> ts of 3rd strike
        self.traces_audited = 0
        self.ops_audited = 0

    def configure(
        self,
        quorum_size: int | None = None,
        n_replicas: int | None = None,
        check_quorum: bool | None = None,
        group_geometry: dict | None = None,
        lease_lookup=None,
    ) -> None:
        """Late wiring from a deployment config (run.launch).

        `group_geometry` maps a Constellation group id (the replica-name
        prefix, e.g. "s0" for "s0-replica-3") to that group's (quorum
        size, active replica count): a sharded deployment's ops are
        audited against the geometry of the GROUP whose replicas served
        them, not a global q/n — heterogeneous groups audit correctly.

        `lease_lookup` (Atlas) is a callable `replica_name -> bool`
        answering "does this replica hold an active read lease?" — the
        ground truth the `lease_intersection` invariant audits lease-
        tagged reads against (typically a closure over the fabric's
        per-group LeaseTables). Audit runs at trace completion, so keep
        the lookup tolerant of grants that expired moments ago (renewing
        sessions keep holders stable in practice)."""
        if quorum_size is not None:
            self.quorum_size = quorum_size
        if n_replicas is not None:
            self.n_replicas = n_replicas
        if check_quorum is not None:
            self.check_quorum = check_quorum
        if group_geometry is not None:
            self.group_geometry = dict(group_geometry)
        elif not hasattr(self, "group_geometry"):
            self.group_geometry = {}
        if lease_lookup is not None:
            self.lease_lookup = lease_lookup
        elif not hasattr(self, "lease_lookup"):
            self.lease_lookup = None
        # quorum-intersection bound: any two quorums of size q out of n
        # replicas share >= 2q - n members (>= f+1 for honest quorums)
        self.intersection = max(1, 2 * self.quorum_size - self.n_replicas)

    def _geometry_for(self, participants: set[str]) -> tuple[int, int]:
        """(quorum, intersection bound) for the group that served an op,
        resolved from the participants' name prefixes; falls back to the
        global geometry for unsharded deployments."""
        if self.group_geometry:
            for name in participants:
                for gid, (q, n) in self.group_geometry.items():
                    if name.startswith(gid + "-"):
                        return q, max(1, 2 * q - n)
        return self.quorum_size, self.intersection

    # ------------------------------------------------------------ lifecycle

    def attach(self, tracer) -> None:
        """Subscribe to `tracer`; idempotent (re-attach moves the feed)."""
        if self._tracer is not None:
            self._tracer.unsubscribe(self.on_record)
        self._tracer = tracer
        tracer.subscribe(self.on_record)

    def detach(self) -> None:
        if self._tracer is not None:
            self._tracer.unsubscribe(self.on_record)
            self._tracer = None

    @property
    def attached(self) -> bool:
        return self._tracer is not None

    def reset(self) -> None:
        """Drop all audit state (tests; a fresh deployment in-process)."""
        with self._lock:
            self._traces.clear()
            self._evicted.clear()
            self._verdicts.clear()
            self._violation_counts.clear()
            self._key_history.clear()
            self._breaker_state.clear()
            self._suspicion.clear()
            self._excluded_at.clear()
            self.traces_audited = 0
            self.ops_audited = 0

    # -------------------------------------------------------------- reports

    def verdicts(self) -> list[Verdict]:
        with self._lock:
            return list(self._verdicts)

    def stats(self) -> dict:
        with self._lock:
            return {
                "attached": self.attached,
                "check_quorum": self.check_quorum,
                "quorum_size": self.quorum_size,
                "n_replicas": self.n_replicas,
                "traces_audited": self.traces_audited,
                "ops_audited": self.ops_audited,
                "pending_traces": len(self._traces),
                "violations": dict(self._violation_counts),
            }

    # ----------------------------------------------------------------- feed

    def on_record(self, rec) -> None:
        """Tracer subscriber: buffer per trace, audit on root completion.
        Called on the recording thread — must stay cheap and never raise
        (the tracer also guards, but a broken auditor silently eating
        telemetry is its own failure mode)."""
        try:
            self._ingest(rec)
        except Exception:  # noqa: BLE001
            log.exception("watchtower ingest failed for %r", rec.name)

    def _ingest(self, rec) -> None:
        # cross-trace state machines update on arrival (their legality is
        # about per-target event ORDER, not trace membership)
        if rec.kind == "event":
            if rec.name in _BREAKER_EVENTS:
                self._on_breaker(rec)
            elif rec.name == "abd.coordinator_violation":
                self._on_suspicion(rec)
        if rec.trace_id is None:
            return
        with self._lock:
            buf = self._traces.get(rec.trace_id)
            if buf is None and rec.trace_id in self._evicted:
                # the rest of an evicted trace: a tree missing its first
                # spans would audit as a quorum of nobody
                if rec.kind == "span" and rec.parent_id is None:
                    del self._evicted[rec.trace_id]
                return
            if buf is None:
                buf = self._traces[rec.trace_id] = []
                while len(self._traces) > self.max_traces:
                    # oldest in-flight trace is evicted unaudited (bounded
                    # memory beats a complete audit of a leaked trace id)
                    evicted, _ = self._traces.popitem(last=False)
                    self._evicted[evicted] = None
                    while len(self._evicted) > 8 * self.max_traces:
                        self._evicted.popitem(last=False)
            if len(buf) < self.max_trace_spans:
                buf.append(rec)
            complete = rec.kind == "span" and rec.parent_id is None
            if complete:
                self._traces.pop(rec.trace_id, None)
        if complete:
            self._audit_trace(rec.trace_id, buf)

    # ------------------------------------------------- cross-trace machines

    def _on_breaker(self, rec) -> None:
        target = str(rec.meta.get("target", ""))
        state = rec.name.rsplit(".", 1)[-1]
        with self._lock:
            prev = self._breaker_state.get(target, "closed")
            self._breaker_state[target] = state
        # legal: anything -> open (threshold / failed probe), anything ->
        # closed (a success proves health, even from open via an in-flight
        # request begun before the trip); half_open ONLY matures from open.
        if state == "half_open" and prev != "open":
            self._violate(
                "breaker_legality", rec.trace_id,
                target=target, transition=f"{prev}->half_open",
            )

    def _on_suspicion(self, rec) -> None:
        node = str(rec.meta.get("node", ""))
        with self._lock:
            self._suspicion[node] += 1
            if (
                self._suspicion[node] >= self.suspicion_limit
                and node not in self._excluded_at
            ):
                self._excluded_at[node] = rec.ts

    # ------------------------------------------------------------ trace audit

    def _audit_trace(self, trace_id: str, records: list) -> None:
        children: dict[str, list] = collections.defaultdict(list)
        for r in records:
            if r.parent_id is not None:
                children[r.parent_id].append(r)

        ops: list[_Op] = []
        for r in records:
            if r.kind != "span":
                continue
            if r.name in ("abd.write", "abd.fetch") and r.meta.get("ok"):
                op = self._distill_op(r)
                if op is not None:
                    ops.append(op)
                if r.meta.get("lease"):
                    # a lease read is a single hop — no quorum subtree to
                    # intersect; audit the weaker lease invariant instead
                    self._check_lease_intersection(r)
                elif self.check_quorum:
                    self._check_quorum_intersection(r, children)
        for r in records:
            if r.kind == "event" and r.name == "audit.repair":
                self._check_repair(r)

        # completion order within the records list IS commit order (spans
        # record when they exit); audit within-trace read-after-write first,
        # then fold each op into the cross-trace per-key history
        last_write: dict[str, _Op] = {}
        for op in ops:
            flagged = False
            if op.op == "read":
                w = last_write.get(op.key)
                if w is not None and w.end <= op.start and op.tag < w.tag:
                    flagged = True
                    if op.lease:
                        # documented lease-window bound, not a BFT violation
                        self._violate(
                            "lease_staleness", op.trace_id,
                            key=op.key, read_tag=list(op.tag),
                            write_tag=list(w.tag), replica=op.replica,
                            window="intra_trace",
                        )
                    else:
                        self._violate(
                            "read_sees_latest", op.trace_id,
                            key=op.key, read_tag=list(op.tag),
                            write_tag=list(w.tag), coordinator=op.coordinator,
                        )
            self._check_key_history(op, already_flagged=flagged)
            self._check_suspicion_legality(op)
            if op.op == "write":
                cur = last_write.get(op.key)
                if cur is None or op.tag > cur.tag:
                    last_write[op.key] = op
            self.ops_audited += 1
        with self._lock:
            self.traces_audited += 1

    @staticmethod
    def _distill_op(rec) -> _Op | None:
        key = rec.meta.get("key")
        seq = rec.meta.get("seq")
        if not isinstance(key, str) or seq is None:
            return None
        end = rec.ts
        start = end - rec.dur_ms / 1e3
        return _Op(
            op=str(rec.meta.get("op") or
                   ("write" if rec.name == "abd.write" else "read")),
            key=key,
            tag=(int(seq), str(rec.meta.get("tag_id", ""))),
            start=start,
            end=end,
            trace_id=rec.trace_id,
            coordinator=str(rec.meta.get("coordinator", "")),
            lease=bool(rec.meta.get("lease")),
            replica=str(rec.meta.get("replica", "")),
        )

    def _check_lease_intersection(self, op_span) -> None:
        """Audit a lease-tagged read against the lease ground truth: the
        serving replica must hold an active lease (AbdClient only marks
        `lease=True` on the single-hop fast path, whose whole safety case
        is the holder-pinned quorum geometry). Without a configured
        `lease_lookup` there is no ground truth to check — the span is
        merely exempted from the quorum-intersection bound."""
        if self.lease_lookup is None:
            return
        replica = str(op_span.meta.get("replica", ""))
        try:
            holds = bool(self.lease_lookup(replica))
        except Exception:  # noqa: BLE001 — a broken lookup must not drop audits
            log.exception("lease_lookup failed for %r", replica)
            return
        if not holds:
            self._violate(
                "lease_intersection", op_span.trace_id,
                key=op_span.meta.get("key"), replica=replica,
            )

    def _check_quorum_intersection(self, op_span, children) -> None:
        """Phase participant sets over the op span's subtree: committed
        means the coordinator saw a full quorum of phase replies, and each
        reply was sent only AFTER its replica recorded the handler span —
        so an honest commit always shows >= q distinct handlers per phase
        here, and two phases of one op must overlap like any two quorums."""
        read_set: set[str] = set()
        write_set: set[str] = set()
        stack = list(children.get(op_span.span_id, ()))
        seen = 0
        while stack and seen < self.max_trace_spans:
            r = stack.pop()
            seen += 1
            stack.extend(children.get(r.span_id, ()))
            if r.name != "replica.handle":
                continue
            msg = r.meta.get("msg")
            replica = str(r.meta.get("replica", ""))
            if msg in _READ_PHASE_MSGS:
                read_set.add(replica)
            elif msg in _WRITE_PHASE_MSGS:
                write_set.add(replica)
        q, intersection = self._geometry_for(read_set | write_set)
        is_write = op_span.name == "abd.write"
        problems = []
        if len(read_set) < q:
            problems.append(f"read_phase={len(read_set)}<{q}")
        # reads may legally skip the write-back (all-tags-equal fast path):
        # an empty write set is fine, a sub-quorum one never is
        if (is_write or write_set) and len(write_set) < q:
            problems.append(f"write_phase={len(write_set)}<{q}")
        if (
            read_set and write_set
            and len(read_set & write_set) < intersection
        ):
            problems.append(
                f"intersection={len(read_set & write_set)}<{intersection}"
            )
        if problems:
            self._violate(
                "quorum_intersection", op_span.trace_id,
                op=op_span.name, key=op_span.meta.get("key"),
                coordinator=op_span.meta.get("coordinator"),
                read_phase=sorted(read_set), write_phase=sorted(write_set),
                problems=problems,
            )

    def _check_key_history(self, op: _Op, already_flagged: bool) -> None:
        with self._lock:
            hist = self._key_history.setdefault(op.key, [])
            prior = list(hist)
        for h in prior:
            if h.end > op.start:
                continue  # overlapped in real time: no order to enforce
            stale = op.tag < h.tag
            dup_mint = op.op == "write" and op.tag == h.tag
            if (stale or dup_mint) and not already_flagged:
                already_flagged = True
                if op.lease and stale:
                    # the residual grant-instant window (dds_tpu/geo):
                    # file it under the documented lease invariant so a
                    # drill can distinguish it from a real BFT violation
                    self._violate(
                        "lease_staleness", op.trace_id,
                        key=op.key, tag=list(op.tag),
                        prior_tag=list(h.tag), prior_trace=h.trace_id,
                        replica=op.replica, window="cross_trace",
                    )
                    continue
                self._violate(
                    "tag_monotonicity", op.trace_id,
                    key=op.key, op=op.op, tag=list(op.tag),
                    prior_tag=list(h.tag), prior_trace=h.trace_id,
                    coordinator=op.coordinator,
                    violation_kind="duplicate_mint" if dup_mint else "stale",
                )
        with self._lock:
            hist.append(op)
            if len(hist) > self.history_per_key:
                # keep the max-tag entry (the strongest witness) and shed
                # the oldest of the rest
                mx = max(range(len(hist)), key=lambda i: hist[i].tag)
                for i in range(len(hist)):
                    if i != mx:
                        hist.pop(i)
                        break

    def _check_suspicion_legality(self, op: _Op) -> None:
        node = op.coordinator
        if not node:
            return
        with self._lock:
            excluded_ts = self._excluded_at.get(node)
        if excluded_ts is not None and op.start > excluded_ts:
            self._violate(
                "suspicion_legality", op.trace_id,
                coordinator=node, key=op.key, op=op.op,
                strikes=self._suspicion.get(node, 0),
            )

    def _check_repair(self, rec) -> None:
        m = rec.meta
        try:
            src = (int(m["src_seq"]), str(m["src_id"]))
            installed = (int(m["seq"]), str(m["tag_id"]))
        except (KeyError, TypeError, ValueError):
            return
        if installed < src:
            self._violate(
                "repair_convergence", rec.trace_id,
                key=m.get("key"), replica=m.get("replica"),
                peer=m.get("peer"), advertised=list(src),
                installed=list(installed),
            )

    # -------------------------------------------------------------- verdicts

    def report_violation(self, invariant: str, trace_id, **detail) -> "Verdict":
        """External evidence entry point: a plane that PROVED a violation
        by independent means files the verdict here so it lands in the
        same ledger / metrics / flight-incident surface as the passive
        audits. Heliograph's decrypt-and-verify probes use this for
        `canary_wrong_answer` — exactly the forged-tag/corruption class
        the BFT audits exist for, caught by an active check the passive
        tag algebra cannot see (a well-MAC'd wrong ciphertext is
        quorum-consistent)."""
        return self._violate(invariant, trace_id, **detail)

    def _violate(self, invariant: str, trace_id, **detail) -> Verdict:
        v = Verdict(invariant, trace_id, time.time(), detail)
        with self._lock:
            self._verdicts.append(v)
            self._violation_counts[invariant] += 1
        log.warning("audit violation %s (trace %s): %s", invariant, trace_id,
                    detail)
        metrics.inc(
            "dds_audit_violations_total", invariant=invariant,
            help="BFT invariant violations detected by the Watchtower auditor",
        )
        # the offending trace, frozen for post-mortem (no-op when the
        # flight recorder has no directory); per-invariant kind so one
        # noisy invariant cannot rate-limit another's first incident.
        # Detail keys that would shadow record()'s own parameters are
        # namespaced out of the way.
        safe = {
            (k if k not in ("kind", "trace_id") else f"detail_{k}"): val
            for k, val in detail.items()
        }
        flight.record(f"audit_{invariant}", trace_id=trace_id, **safe)
        return v


# process-wide auditor; run.launch() configures + attaches it
watchtower = Watchtower()
