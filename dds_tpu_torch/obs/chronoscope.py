"""Chronoscope: critical-path attribution over span trees.

Copy of `dds_tpu/obs/chronoscope.py` on the port's tracer. It consumes
finished traces (as a `Tracer` subscriber, `attach`, or whole trees fed
to `ingest_tree`) and, per trace:

1. extracts the CRITICAL PATH: per node, children are clamped to the
   parent's window and claimed back to front, so overlapping siblings
   (a parallel fan-out) contribute only their non-overlapped tail; the
   slowest branch wins and claimed windows recurse. Every node's self
   time (its window less its claimed children) lands in exactly one
   stage, so the per-stage waterfall sums to the root's duration;
2. classifies each span into the closed stage taxonomy `STAGES`; an
   unknown name falls into "other", which counts against coverage;
3. aggregates per route: windowed p50/p95 self time per stage, EWMA
   stage shares and coverage, cumulative totals (the folded flamegraph
   text, `folded`), and the worst-k slow traces per rotating window,
   frozen through the flight recorder (`slow_trace`) past `slow_ms`.

With tenancy the REST edge also feeds every served request's wall time
to `note_usage`, a bounded per-tenant ledger (`tenant_usage`). `profile`
is the `GET /profile` body, `ingest_tree` Panopticon's collector feed
(a stitched cross-host trace, analyzed whole); `export_gauges` publishes the `dds_pipe_*` and `dds_tenant_usage_*`
gauges. `launch` attaches the process-wide `chronoscope` to the tracer
and `Deployment.stop` detaches and resets it; `DDS_OBS_PIPE=0` keeps it
dormant.

Roots: a parent-less `http.*` span closes its trace (children record
before the root, since spans record on exit). `replica.handle` spans are
also analyzed as subtree roots.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import threading
import time
from typing import Iterable, Optional

from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.trace import SpanRecord, _percentile, tracer

log = logging.getLogger("dds_torch.chronoscope")

# The closed stage taxonomy, in pipe order. Every span name maps to
# exactly one stage; root HTTP self-time (parse/encode/cache work around
# the downstream calls) is the "response" stage.
STAGES = (
    "admission",                # backpressure decision at the front door
    "coalesce-wait",            # sat in the proxy fold coalescer window
    "serialize",                # message -> wire frame (+ MAC/sig)
    "quorum-rtt",               # ABD round: on the wire + remote queueing
    "hmac-verify",              # proxy-side reply signature validation
    "replica-apply",            # replica handler work (storage + sign)
    "ingest-queue-wait",        # sat in a TimedQueue before a drain
    "host-to-device-transfer",  # host limbs -> HBM rows
    "tier-promote",             # Stratum warm/cold rows re-entering HBM
    "tier-demote",              # Stratum eviction: HBM -> warm -> segments
    "tier-cold-read",           # segment read + HMAC re-verify from disk
    "trace-compile",            # one-time jit trace+compile (cold call)
    "dispatch",                 # host-side dispatch orchestration
    "device-execute",           # on-device kernel time
    "response",                 # proxy host work around the calls
    "other",                    # unclassified — counts against coverage
)

_EPS = 1e-9


def classify(name: str, *, root: bool = False) -> str:
    """Map a span name to its pipe stage (see STAGES)."""
    if name == "proxy.admission":
        return "admission"
    if name == "proxy.coalesce_wait":
        return "coalesce-wait"
    if name == "net.serialize":
        return "serialize"
    if name == "abd.verify":
        return "hmac-verify"
    if name.startswith("abd."):
        return "quorum-rtt"
    if name == "ingest.queue_wait":
        return "ingest-queue-wait"
    if name == "ingest.h2d":
        return "host-to-device-transfer"
    if name == "tier.promote":
        return "tier-promote"
    if name == "tier.demote":
        return "tier-demote"
    if name == "tier.cold_read":
        return "tier-cold-read"
    if name.startswith("replica.") or name.startswith("antientropy."):
        return "replica-apply"
    if name.startswith("kernel."):
        if name.endswith(".compile"):
            return "trace-compile"
        if name.endswith(".dispatch"):
            return "dispatch"
        return "device-execute"
    if name in ("proxy.fold", "proxy.resident_fold", "proxy.scatter_fold",
                "proxy.coalesced_fold"):
        # fold orchestration: the kernel children claim their windows,
        # the marshaling remainder is host-side dispatch work
        return "dispatch"
    if name.startswith("http.") or name.startswith("proxy."):
        return "response"
    return "other"


class _Node:
    __slots__ = ("rec", "start", "end", "children", "events")

    def __init__(self, rec: SpanRecord):
        self.rec = rec
        self.end = rec.ts
        self.start = rec.ts - max(0.0, rec.dur_ms) / 1e3
        self.children: list["_Node"] = []
        self.events: list[SpanRecord] = []


def _build_nodes(records: Iterable[SpanRecord]):
    nodes: dict[str, _Node] = {}
    order: list[_Node] = []
    events: list[SpanRecord] = []
    for r in records:
        if r is None or getattr(r, "trace_id", None) is None:
            continue
        if r.kind == "event":
            events.append(r)
            continue
        if r.kind != "span":
            continue
        n = _Node(r)
        order.append(n)
        if r.span_id is not None and r.span_id not in nodes:
            nodes[r.span_id] = n
    return nodes, order, events


def critical_path(records: Iterable[SpanRecord], *,
                  root_span_id: Optional[str] = None,
                  orphans_to_root: bool = True) -> Optional[dict]:
    """Extract the blocking chain and per-stage self-times of one trace.

    Without `root_span_id` the longest parent-less span wins the root.
    With `orphans_to_root`, spans whose parent never arrived (stragglers,
    intermediate contexts that never became spans) hang off
    the root and are clamped to its window — a partial tree still
    attributes. Returns None when no root can be found.
    """
    nodes, order, events = _build_nodes(records)
    if not order:
        return None
    if root_span_id is not None:
        root = nodes.get(root_span_id)
    else:
        tops = [n for n in order if n.rec.parent_id is None]
        cands = [n for n in tops if n.rec.name.startswith("http.")] or tops
        root = max(cands, key=lambda n: n.end - n.start, default=None)
    if root is None or root.end - root.start <= _EPS:
        return None
    for n in order:
        if n is root:
            continue
        parent = nodes.get(n.rec.parent_id) if n.rec.parent_id else None
        if parent is n:
            parent = None
        if parent is not None:
            parent.children.append(n)
        elif orphans_to_root:
            root.children.append(n)
    for ev in events:
        holder = nodes.get(ev.parent_id) if ev.parent_id else None
        if holder is not None:
            holder.events.append(ev)

    stages: dict[str, float] = {}
    path: list[dict] = []
    _attribute(root, root.start, root.end, 0, stages, path, root.start)
    wall_ms = (root.end - root.start) * 1e3
    named = sum(v for k, v in stages.items() if k != "other")
    return {
        "route": root.rec.name,
        "trace_id": root.rec.trace_id,
        "wall_ms": round(wall_ms, 3),
        "coverage": round(min(1.0, named / wall_ms), 4) if wall_ms else 1.0,
        "stages": {k: round(v, 3) for k, v in stages.items() if v > 0},
        "path": path,
    }


def _attribute(node: _Node, w_start: float, w_end: float, depth: int,
               stages: dict, path: list, t0: float) -> None:
    """Claim non-overlapping child windows back-to-front inside
    [w_start, w_end]; the unclaimed remainder is this node's self-time.
    Overlapping siblings keep only the tail the later-ending one left
    uncovered, so a parallel fan-out attributes its slowest branch."""
    window = max(0.0, w_end - w_start)
    cursor = w_end
    claimed: list[tuple[_Node, float, float]] = []
    for c in sorted(node.children, key=lambda c: c.end, reverse=True):
        e = min(c.end, cursor)
        s = max(c.start, w_start)
        if e - s <= _EPS:
            continue
        claimed.append((c, s, e))
        cursor = s
    self_s = max(0.0, window - sum(e - s for _, s, e in claimed))
    stage = classify(node.rec.name, root=depth == 0)
    stages[stage] = stages.get(stage, 0.0) + self_s * 1e3
    entry = {
        "name": node.rec.name,
        "stage": stage,
        "depth": depth,
        "start_ms": round((w_start - t0) * 1e3, 3),
        "dur_ms": round(window * 1e3, 3),
        "self_ms": round(self_s * 1e3, 3),
    }
    if node.rec.meta:
        entry["meta"] = dict(node.rec.meta)
    if node.events:
        entry["events"] = [
            {"name": ev.name, **({"meta": ev.meta} if ev.meta else {})}
            for ev in node.events[:8]
        ]
    path.append(entry)
    if depth >= 64:
        return
    for c, s, e in reversed(claimed):  # chronological order
        _attribute(c, s, e, depth + 1, stages, path, t0)


class Chronoscope:
    """Continuous per-route pipe profiler (see module docstring)."""

    MAX_TRACES = 1024        # in-flight trace buffers
    MAX_TRACE_SPANS = 2048   # spans buffered per trace
    DONE_LRU = 2048          # analyzed trace ids (straggler dedup)
    MAX_ROUTES = 64          # gauge-cardinality guard
    MAX_TENANTS = 256        # Bastion usage-ledger cardinality guard
    MAX_TENANT_ROUTES = 16   # per-tenant route breakdown cap

    def __init__(self, registry=metrics, *, window_s: float = 60.0,
                 exemplars: int = 3, slow_ms: float = 50.0,
                 max_samples: int = 512, ewma_alpha: float = 0.2):
        self._registry = registry
        self.window_s = float(window_s)
        self.exemplars = max(1, int(exemplars))
        self.slow_ms = float(slow_ms)
        self.max_samples = max(16, int(max_samples))
        self.ewma_alpha = float(ewma_alpha)
        self.enabled = os.environ.get("DDS_OBS_PIPE", "").strip().lower() \
            not in ("0", "false", "off", "no")
        self._lock = threading.Lock()
        self._traces: collections.OrderedDict = collections.OrderedDict()
        self._done: collections.OrderedDict = collections.OrderedDict()
        self._routes: dict[str, dict] = {}
        self._tenants: dict[str, dict] = {}
        self._attached = None
        self._last_export = 0.0
        self.traces_profiled = 0
        self.traces_evicted = 0

    # ------------------------------------------------------------ lifecycle

    def attach(self, tr=None) -> None:
        """Subscribe to a tracer (detaching any previous one); the
        process tracer by default."""
        self.detach()
        tr = tr if tr is not None else tracer
        tr.subscribe(self.on_record)
        self._attached = tr

    def detach(self) -> None:
        if self._attached is not None:
            self._attached.unsubscribe(self.on_record)
            self._attached = None

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._done.clear()
            self._routes.clear()
            self._tenants.clear()
            self.traces_profiled = 0
            self.traces_evicted = 0

    # ------------------------------------------- Bastion usage attribution

    def note_usage(self, tenant: str, route: str, dur_s: float) -> None:
        """One served request's wall time attributed to its tenant (fed
        from the REST edge; cheap enough for every request). Cardinality
        is bounded: past MAX_TENANTS live tenants the rest fold into the
        shared "overflow" row, and each tenant's route breakdown caps at
        MAX_TENANT_ROUTES — a tenant flood can never balloon the profile
        (the same argument as the route-gauge guard)."""
        if not self.enabled or not tenant:
            return
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                if len(self._tenants) >= self.MAX_TENANTS:
                    tenant = "overflow"
                    st = self._tenants.get(tenant)
                if st is None:
                    st = self._tenants[tenant] = {
                        "requests": 0, "seconds": 0.0, "routes": {},
                    }
            st["requests"] += 1
            st["seconds"] += dur_s
            rt = st["routes"]
            if route in rt or len(rt) < self.MAX_TENANT_ROUTES:
                rt[route] = rt.get(route, 0) + 1

    def tenant_usage(self) -> dict:
        """Per-tenant cumulative usage: request count, attributed wall
        seconds, top routes."""
        with self._lock:
            return {
                t: {
                    "requests": s["requests"],
                    "seconds": round(s["seconds"], 6),
                    "top_routes": dict(sorted(
                        s["routes"].items(), key=lambda kv: -kv[1]
                    )[:4]),
                }
                for t, s in self._tenants.items()
            }

    # ----------------------------------------------------------- ingestion

    def on_record(self, rec) -> None:
        """Tracer-subscriber feed: buffer per trace, analyze on root."""
        if not self.enabled:
            return
        try:
            tid = getattr(rec, "trace_id", None)
            if tid is None or rec.kind not in ("span", "event"):
                return
            with self._lock:
                if tid in self._done:
                    return
                buf = self._traces.get(tid)
                if buf is None:
                    buf = self._traces[tid] = {"records": [], "roots": set()}
                    while len(self._traces) > self.MAX_TRACES:
                        self._traces.popitem(last=False)
                        self.traces_evicted += 1
                if len(buf["records"]) < self.MAX_TRACE_SPANS:
                    buf["records"].append(rec)
            if rec.kind != "span":
                return
            if rec.parent_id is None and rec.name.startswith("http."):
                with self._lock:
                    buf = self._traces.pop(tid, None)
                    self._done[tid] = True
                    while len(self._done) > self.DONE_LRU:
                        self._done.popitem(last=False)
                if buf is not None:
                    self._analyze(buf["records"], done_roots=buf["roots"])
            elif rec.name == "replica.handle":
                with self._lock:
                    buf = self._traces.get(tid)
                    if buf is None:
                        return
                    buf["roots"].add(rec.span_id)
                    records = list(buf["records"])
                res = critical_path(records, root_span_id=rec.span_id,
                                    orphans_to_root=False)
                if res is not None:
                    self._absorb(res)
        except Exception:  # noqa: BLE001 — observers never break observed paths
            log.exception("chronoscope ingest failed")

    def ingest_tree(self, records) -> None:
        """Collector feed: one stitched trace (children + root), analyzed
        whole — the http root plus every replica.handle subtree."""
        if not self.enabled:
            return
        try:
            self._analyze(list(records), done_roots=set())
        except Exception:  # noqa: BLE001
            log.exception("chronoscope stitched ingest failed")

    def _analyze(self, records: list, *, done_roots: set) -> None:
        roots = [
            r for r in records
            if r.kind == "span" and r.parent_id is None
            and r.name.startswith("http.")
        ]
        for root in roots:
            res = critical_path(records, root_span_id=root.span_id)
            if res is not None:
                self._absorb(res)
        for r in records:
            if (r.kind == "span" and r.name == "replica.handle"
                    and r.span_id not in done_roots):
                res = critical_path(records, root_span_id=r.span_id,
                                    orphans_to_root=False)
                if res is not None:
                    self._absorb(res)

    # ---------------------------------------------------------- aggregation

    def _absorb(self, res: dict) -> None:
        route, wall = res["route"], res["wall_ms"]
        if wall <= 0:
            return
        now = time.monotonic()
        a = self.ewma_alpha
        admitted = False
        with self._lock:
            st = self._routes.get(route)
            if st is None:
                if len(self._routes) >= self.MAX_ROUTES:
                    return
                st = self._routes[route] = {
                    "count": 0,
                    "wall": collections.deque(maxlen=self.max_samples),
                    "coverage": None,
                    "stages": {},
                    "share": {},
                    "totals": {},
                    "ex_start": now,
                    "ex_cur": [],
                    "ex_prev": [],
                }
            st["count"] += 1
            st["wall"].append(wall)
            cov = st["coverage"]
            st["coverage"] = (
                res["coverage"] if cov is None
                else (1 - a) * cov + a * res["coverage"]
            )
            for k in set(st["stages"]) | set(res["stages"]):
                v = res["stages"].get(k, 0.0)
                dq = st["stages"].get(k)
                if dq is None:
                    dq = st["stages"][k] = collections.deque(
                        maxlen=self.max_samples
                    )
                dq.append(v)
                share = v / wall
                old = st["share"].get(k)
                st["share"][k] = (
                    share if old is None else (1 - a) * old + a * share
                )
                st["totals"][k] = st["totals"].get(k, 0.0) + v
            if now - st["ex_start"] >= self.window_s:
                st["ex_prev"] = st["ex_cur"]
                st["ex_cur"] = []
                st["ex_start"] = now
            cur = st["ex_cur"]
            if len(cur) < self.exemplars or wall > cur[-1][0]:
                cur.append((wall, res))
                cur.sort(key=lambda t: -t[0])
                del cur[self.exemplars:]
                admitted = any(r is res for _, r in cur)
            self.traces_profiled += 1
        try:
            self._registry.inc("dds_pipe_traces_total", route=route,
                               help="traces profiled by Chronoscope")
        except Exception:  # noqa: BLE001
            pass
        if admitted and wall >= self.slow_ms:
            self._capture(res)
        self._maybe_export()

    # ------------------------------------------------------------ exemplars

    def _capture(self, res: dict) -> None:
        """Freeze a slow-trace exemplar through the flight recorder.
        Runs inside a tracer subscriber (possibly ON the event loop
        thread), so the blocking write is dispatched supervised via
        `record_async`; only off-loop callers write synchronously."""
        from dds_tpu_torch.obs.flight import flight

        if not getattr(flight, "enabled", False):
            return
        stages = res.get("stages") or {}
        top = max(stages.items(), key=lambda kv: kv[1])[0] if stages \
            else "other"
        info = {
            "route": res["route"], "wall_ms": res["wall_ms"],
            "coverage": res["coverage"], "top_stage": top,
            "stages": stages,
        }
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            try:
                flight.record("slow_trace", trace_id=res["trace_id"], **info)
            except Exception:  # noqa: BLE001
                log.exception("chronoscope exemplar capture failed")
            return
        from dds_tpu_torch.utils.tasks import supervised_task

        supervised_task(
            flight.record_async("slow_trace", trace_id=res["trace_id"],
                                **info),
            name="chronoscope.exemplar",
        )

    # -------------------------------------------------------------- surface

    def _snapshot(self) -> dict:
        with self._lock:
            out = {}
            for route, st in self._routes.items():
                wall = sorted(st["wall"])
                stages = {}
                for k, dq in st["stages"].items():
                    durs = sorted(dq)
                    if not durs or durs[-1] <= 0:
                        continue
                    stages[k] = {
                        "p50_ms": round(_percentile(durs, 0.50), 3),
                        "p95_ms": round(_percentile(durs, 0.95), 3),
                        "share": round(st["share"].get(k, 0.0), 4),
                    }
                # the bottleneck must be a NAMED stage: unattributed
                # residue ("other") only wins when nothing else exists
                cand = {k: v for k, v in stages.items() if k != "other"} \
                    or stages
                top = max(cand.items(), key=lambda kv: kv[1]["p95_ms"])[0] \
                    if cand else None
                exemplars = sorted(
                    st["ex_cur"] + st["ex_prev"], key=lambda t: -t[0]
                )[: self.exemplars]
                out[route] = {
                    "count": st["count"],
                    "wall_p50_ms": round(_percentile(wall, 0.50), 3),
                    "wall_p95_ms": round(_percentile(wall, 0.95), 3),
                    "coverage": round(st["coverage"] or 0.0, 4),
                    "top_stage": top,
                    "stages": stages,
                    "totals_ms": {
                        k: round(v, 1) for k, v in st["totals"].items()
                    },
                    "exemplars": [r for _, r in exemplars],
                }
            return out

    def profile(self) -> dict:
        """The GET /profile JSON body."""
        out = {
            "enabled": self.enabled,
            "window_s": self.window_s,
            "taxonomy": list(STAGES),
            "traces_profiled": self.traces_profiled,
            "routes": self._snapshot(),
        }
        tenants = self.tenant_usage()
        if tenants:
            out["tenants"] = tenants
        return out

    def folded(self) -> str:
        """Folded flamegraph text (route;stage <self_ms>), one line per
        (route, stage) cumulative self-time — feed to any FlameGraph
        renderer."""
        lines = []
        with self._lock:
            for route, st in sorted(self._routes.items()):
                for stage, total in sorted(st["totals"].items()):
                    if total >= 1.0:
                        lines.append(f"{route};{stage} {int(total)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_gauges(self, registry=None) -> None:
        """Publish the per-route/per-stage profile as dds_pipe_* gauges.
        Called throttled at analyze time and again at scrape time."""
        reg = registry if registry is not None else self._registry
        snap = self._snapshot()
        for route, rs in snap.items():
            reg.set("dds_pipe_wall_p50_ms", rs["wall_p50_ms"], route=route,
                    help="profiled request wall time p50 per route")
            reg.set("dds_pipe_wall_p95_ms", rs["wall_p95_ms"], route=route,
                    help="profiled request wall time p95 per route")
            reg.set("dds_pipe_coverage", rs["coverage"], route=route,
                    help="EWMA fraction of wall time attributed to named "
                         "stages")
            for stage, ss in rs["stages"].items():
                reg.set("dds_pipe_stage_p50_ms", ss["p50_ms"],
                        route=route, stage=stage,
                        help="per-stage critical-path self-time p50")
                reg.set("dds_pipe_stage_p95_ms", ss["p95_ms"],
                        route=route, stage=stage,
                        help="per-stage critical-path self-time p95")
                reg.set("dds_pipe_stage_share", ss["share"],
                        route=route, stage=stage,
                        help="EWMA share of wall time per stage")
        for t, ts in self.tenant_usage().items():
            reg.set("dds_tenant_usage_seconds", ts["seconds"], tenant=t,
                    help="cumulative request wall seconds per tenant")
            reg.set("dds_tenant_usage_requests", ts["requests"], tenant=t,
                    help="cumulative served requests per tenant")

    def _maybe_export(self) -> None:
        now = time.monotonic()
        with self._lock:
            if now - self._last_export < 1.0:
                return
            self._last_export = now
        try:
            self.export_gauges()
        except Exception:  # noqa: BLE001
            log.exception("chronoscope gauge export failed")

    def stats(self) -> dict:
        with self._lock:
            return {
                "attached": self._attached is not None,
                "traces_profiled": self.traces_profiled,
                "traces_evicted": self.traces_evicted,
                "buffered_traces": len(self._traces),
                "routes": len(self._routes),
            }


# process-wide profiler (run/deploy attach it alongside the Watchtower)
chronoscope = Chronoscope()
