"""Panopticon: the fleet-wide observability plane.

Copy of `dds_tpu/obs/panopticon.py`: the same frames, batch MAC, stitch
rules, federation bodies and counters, so a batch one package's shipper
signs verifies at the other's collector and the same inputs give the same
bodies and verdicts. Three divergences, kept on purpose:

- the shipper's in-flight traces and the collector's stitch buffers are
  guarded by a lock: the tracer calls its subscribers on the thread that
  records the span, and the proxy's folds record their `kernel.*` spans
  on worker threads while the loop iterates the buffers;
- a trace the collector evicts unaudited from a full buffer (more than
  `MAX_TRACES` in flight) stays unaudited: its later spans and its root
  are dropped, where the reference opens a fresh buffer for them and
  replays it as a whole tree that has lost its replica spans, which
  audits as a `quorum_intersection` verdict (ROADMAP §C 21);
- a group process late with its spans does not lose them to the stitch
  window (ROADMAP §C 22). The reference ships one batch a flush, which
  caps a group at `batch_max / flush_interval` trees a second (128 at the
  defaults), and replays a root one fixed stitch window after it ends, so
  under load the proxy audits traces whose replica spans are still on
  their way. A flush here ships the whole spool, `batch_max` trees a
  batch, and the collector replays a root only once every live source
  has delivered a batch that arrived a flush interval past the root's
  due time (or after the rootless grace), on the collector's own
  monotonic clock: the hosts' wall clocks may disagree.

Meridian splits the quorum groups across OS processes, where the proxy's
tracer never sees a remote replica's handler spans, so a quorum audit
there would flag every op. Panopticon closes that loop:

- **SpanShipper** (every non-proxy process): subscribes to the process
  tracer, spools completed span trees (plus flight-incident index entries
  and metric/SLO snapshots) into a bounded buffer, and ships HMAC-signed
  `TelemetryBatch` frames to the proxy's collector over the TcpNet
  fabric. Telemetry is best-effort: the spool drops (and counts) under
  pressure, the request path is never blocked.
- **FleetCollector** (the proxy process): verifies batch MACs, stitches
  shipped spans with the proxy's own spans into single trace trees keyed
  by the propagated `tc` context, and replays each stitched tree into the
  Watchtower — children first, root last — after a `stitch_window` grace
  so cross-host straggler spans land before the audit fires. It also
  federates every source's Prometheus exposition (`GET /fleet/metrics`,
  `host`/`role`/`shard`-labelled, staleness-marked per source), rolls up
  fleet SLO burn (`GET /fleet/slo`), the pipe profiles (`GET
  /fleet/profile`) and the canaries (`GET /fleet/canary`), and correlates
  flight incidents fleet-wide by trace id (`GET /fleet/incidents`).

Trust model: batches are HMAC-SHA256-signed with the fleet telemetry
secret on top of the frame MAC, so the collector never ingests telemetry
forged by a keyless network attacker. The signer is the reporting host:
a Byzantine host can still sign lies about its own stats. What the audits
catch is what lying cannot hide: a coordinator that claims a quorum must
show >= q distinct handler spans shipped from other processes, and a
forged stale tag is caught by the committed-tag history whatever its
host reports. DEPLOY.md "Fleet observability (Panopticon)".
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import hmac as hmac_mod
import json
import logging
import os
import pathlib
import threading
import time

from dds_tpu_torch import __version__
from dds_tpu_torch.core import messages as M
from dds_tpu_torch.obs.metrics import metrics as default_metrics
from dds_tpu_torch.utils.tasks import supervised_task
from dds_tpu_torch.utils.trace import SpanRecord, Tracer
from dds_tpu_torch.utils.trace import tracer as default_tracer

log = logging.getLogger("dds_torch.panopticon")

__all__ = [
    "SpanShipper", "FleetCollector", "NullWatchtower",
    "COLLECTOR_ENDPOINT", "SHIPPER_ENDPOINT",
    "batch_mac", "process_info",
]


class NullWatchtower:
    """Audit sink for collectors deployed with `[obs] audit-enabled =
    false`: stitching and federation stay live, but replayed traces are
    discarded instead of being judged against a geometry nobody
    configured (the global Watchtower's defaults would flag every
    stitched commit of a differently-sized fleet)."""

    def on_record(self, rec) -> None:
        pass

    def verdicts(self) -> list:
        return []

# TcpNet endpoint names (full addresses are "host:port/<name>")
COLLECTOR_ENDPOINT = "panopticon"
SHIPPER_ENDPOINT = "panopticon-ship"

# loose (trace-less) events worth shipping: they drive the Watchtower's
# cross-trace breaker/suspicion state machines
_LOOSE_EVENTS = frozenset({
    "breaker.open", "breaker.half_open", "breaker.closed",
    "abd.coordinator_violation",
})

_START_TS = time.time()


def process_info(registry=None, *, role: str, shard: str = "",
                 region: str = "") -> None:
    """Publish the per-process identity gauge every `/metrics` carries:
    `dds_process_info{role,shard,region,pid,start_ts,version} 1`.
    Federated scrapes and incident correlation attribute sources by it."""
    reg = registry if registry is not None else default_metrics
    reg.set(  # argus: ok[metrics.unbounded-label] one series per process lifetime; start_ts is boot identity, not request-scoped
        "dds_process_info", 1.0,
        role=role, shard=shard or "-", region=region or "-",
        pid=str(os.getpid()),
        start_ts=f"{_START_TS:.3f}", version=__version__,
        help="process identity (value is always 1; the labels carry it)",
    )


def batch_mac(secret: bytes, host: str, role: str, shard: str, seq: int,
              ts: float, spans: list, incidents: list, metrics_text: str,
              slo: dict, dropped: int, region: str = "") -> bytes:
    """HMAC-SHA256 over the canonical JSON of a batch payload. The Atlas
    `region` label is covered too — a forged region would let a
    compromised source masquerade into another region's federated view."""
    body = json.dumps(
        [host, role, shard, seq, ts, spans, incidents, metrics_text, slo,
         dropped, region],
        sort_keys=True, separators=(",", ":"),
    ).encode()
    return hmac_mod.new(secret, body, hashlib.sha256).digest()


def record_from_dict(d: dict) -> SpanRecord | None:
    """Rebuild a SpanRecord from a shipped `Tracer.event_dict` dict.
    Defensive: a collector must survive any shape a (lying) source ships."""
    try:
        return SpanRecord(
            ts=float(d["ts"]),
            name=str(d["name"]),
            dur_ms=float(d.get("dur_ms", 0.0)),
            meta=d.get("meta") if isinstance(d.get("meta"), dict) else {},
            trace_id=d.get("trace_id"),
            span_id=d.get("span_id"),
            parent_id=d.get("parent_id"),
            kind=str(d.get("kind", "span")),
        )
    except (KeyError, TypeError, ValueError):
        return None


# --------------------------------------------------------------------------
# shipper (group / non-proxy processes)
# --------------------------------------------------------------------------


class SpanShipper:
    """Tracer subscriber -> bounded spool -> batched TcpNet shipping.

    The subscriber side (`on_record`) runs on the recording path and does
    one dict append under no lock contention worth naming; everything
    slow (JSON sanitization, incident-index tailing, the actual send)
    lives in the supervised flush task. A trace's locally-recorded spans
    are packaged as one tree once the trace has gone quiet for a flush
    interval — group processes never see the remote root complete, so
    quiescence IS completion from their vantage point."""

    # per-trace local span cap: a runaway trace must not own the spool
    MAX_TREE_SPANS = 512
    # in-flight (not yet quiesced) traces tracked at once
    MAX_ACTIVE = 1024

    def __init__(self, net, *, collector: str, secret: bytes, host: str,
                 role: str, shard: str = "", region: str = "",
                 spool_max: int = 256,
                 batch_max: int = 32, flush_interval: float = 0.25,
                 flight_dir: str = "", slo=None, tracer: Tracer | None = None,
                 registry=None):
        self.net = net
        # collector is "host:port" (the proxy's transport bind)
        self.collector_addr = f"{collector}/{COLLECTOR_ENDPOINT}"
        self.secret = secret
        self.host, self.role, self.shard = host, role, shard
        self.region = region  # Atlas: [fabric] region, MAC-covered
        self.spool_max = max(1, spool_max)
        self.batch_max = max(1, batch_max)
        self.flush_interval = max(0.01, flush_interval)
        self.flight_dir = flight_dir
        self.slo = slo
        self.tracer = tracer if tracer is not None else default_tracer
        self.metrics = registry if registry is not None else default_metrics
        self.src_addr = net.local_addr(SHIPPER_ENDPOINT)
        # trace_id -> {"records": [dict], "last": monotonic}
        self._active: collections.OrderedDict = collections.OrderedDict()
        # quiesced trees awaiting shipment
        self._spool: collections.deque = collections.deque()
        self._loose: collections.deque = collections.deque(maxlen=256)
        # `on_record` runs on the recording thread (worker threads too),
        # the flush on the loop
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0
        self._index_pos = 0  # byte offset into flight index.jsonl
        self._task: asyncio.Task | None = None
        self._last_ship = 0.0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self.net.register(self.src_addr, self.handle)
        self.tracer.subscribe(self.on_record)
        if self._task is None or self._task.done():
            self._task = supervised_task(self._flush_loop(),
                                         name="panopticon.shipper")

    async def stop(self) -> None:
        self.tracer.unsubscribe(self.on_record)
        self.net.unregister(self.src_addr)
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # ----------------------------------------------------------- subscriber

    def on_record(self, rec) -> None:
        """Cheap and non-blocking: convert + append. Never raises (the
        tracer guards too, but telemetry must not break observed paths)."""
        try:
            if rec.trace_id is None:
                if rec.kind == "event" and rec.name in _LOOSE_EVENTS:
                    with self._lock:
                        self._loose.append(Tracer.event_dict(rec))
                return
            drops = []
            with self._lock:
                buf = self._active.get(rec.trace_id)
                if buf is None:
                    buf = self._active[rec.trace_id] = {"records": [], "last": 0.0}
                    while len(self._active) > self.MAX_ACTIVE:
                        self._active.popitem(last=False)
                        drops.append("active_overflow")
                if len(buf["records"]) < self.MAX_TREE_SPANS:
                    buf["records"].append(Tracer.event_dict(rec))
                else:
                    drops.append("tree_overflow")
                buf["last"] = time.monotonic()
            for reason in drops:
                self._drop(reason)
        except Exception:  # noqa: BLE001 — observers never break observed paths
            log.exception("shipper on_record failed")

    def _drop(self, reason: str) -> None:
        with self._lock:
            self._dropped += 1
        self.metrics.inc(
            "dds_fleet_ship_dropped_total", reason=reason,
            help="telemetry units dropped by the span shipper (accounted, "
                 "never blocking)",
        )

    # ------------------------------------------------------------- ack side

    async def handle(self, src: str, msg) -> None:
        if isinstance(msg, M.TelemetryAck):
            if msg.ok:
                self.metrics.inc("dds_fleet_ship_acked_total",
                                 help="telemetry batches the collector "
                                      "acknowledged")
            else:
                self._drop("rejected")
                log.warning("collector rejected telemetry batch %d: %s",
                            msg.seq, msg.error)

    # ------------------------------------------------------------ flush loop

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.flush_interval)
            try:
                await self._flush_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("panopticon shipper flush failed")

    def _collect_quiesced(self) -> list[list]:
        """Move quiet traces out of the active set into the spool."""
        now = time.monotonic()
        overflow = 0
        with self._lock:
            done = [
                tid for tid, buf in self._active.items()
                if now - buf["last"] >= self.flush_interval
            ]
            for tid in done:
                buf = self._active.pop(tid)
                if len(self._spool) >= self.spool_max:
                    self._spool.popleft()
                    overflow += 1
                self._spool.append(buf["records"])
            loose = list(self._loose)
            self._loose.clear()
        for _ in range(overflow):
            self._drop("spool_overflow")
        trees = []
        while self._spool and len(trees) < self.batch_max:
            trees.append(self._spool.popleft())
        if loose:
            trees.append(loose)
        return trees

    def _read_new_incidents(self) -> list[dict]:
        """Tail the flight recorder's index.jsonl from the last shipped
        offset (runs on a worker thread — file I/O off the loop)."""
        if not self.flight_dir:
            return []
        idx = pathlib.Path(self.flight_dir) / "index.jsonl"
        try:
            size = idx.stat().st_size
        except OSError:
            return []
        if size < self._index_pos:
            self._index_pos = 0  # pruned/rewritten: re-tail from the top
        if size == self._index_pos:
            return []
        out = []
        try:
            with open(idx) as f:
                f.seek(self._index_pos)
                for line in f:
                    try:
                        entry = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(entry, dict):
                        out.append(entry)
                self._index_pos = f.tell()
        except OSError:
            return []
        return out[-64:]

    async def _flush_once(self) -> None:
        trees = self._collect_quiesced()
        incidents = await asyncio.to_thread(self._read_new_incidents)
        now = time.monotonic()
        # always ship a metrics/SLO heartbeat at least once per second so
        # federation staleness reflects liveness, not workload idleness
        if not trees and not incidents and now - self._last_ship < 1.0:
            return
        self._last_ship = now
        # the rest of the spool goes out now too, `batch_max` trees a batch:
        # one batch a flush would cap the shipping rate at batch_max /
        # flush_interval trees a second and hold every later tree past the
        # collector's stitch window (ROADMAP §C 22)
        self._ship(trees, incidents)
        while self._spool:
            self._ship([self._spool.popleft()
                        for _ in range(min(self.batch_max, len(self._spool)))], [])

    def _ship(self, trees: list, incidents: list) -> None:
        """One signed batch of `trees` and `incidents` to the collector."""
        spans = json.loads(json.dumps(trees, default=str))
        self._seq += 1
        ts = time.time()
        metrics_text = self.metrics.render()
        slo = self.slo.report() if self.slo is not None else {}
        mac = batch_mac(self.secret, self.host, self.role, self.shard,
                        self._seq, ts, spans, incidents, metrics_text, slo,
                        self._dropped, self.region)
        batch = M.TelemetryBatch(
            host=self.host, role=self.role, shard=self.shard, seq=self._seq,
            ts=ts, spans=spans, incidents=incidents,
            metrics_text=metrics_text, slo=slo, dropped=self._dropped,
            mac=mac, region=self.region,
        )
        self.net.send(self.src_addr, self.collector_addr, batch)
        self.metrics.inc("dds_fleet_ship_batches_total",
                         help="telemetry batches shipped to the collector")
        n_spans = sum(len(t) for t in trees)
        if n_spans:
            self.metrics.inc("dds_fleet_ship_spans_total", n_spans,
                             help="span records shipped to the collector")

    def stats(self) -> dict:
        with self._lock:
            return {
                "seq": self._seq,
                "dropped": self._dropped,
                "active_traces": len(self._active),
                "spooled_trees": len(self._spool),
            }


# --------------------------------------------------------------------------
# Prometheus exposition parsing / relabeling (federation)
# --------------------------------------------------------------------------


def _inject_labels(line: str, labels: dict) -> str:
    """Add `labels` to one exposition sample line."""
    extra = ",".join(f'{k}="{v}"' for k, v in labels.items())
    if "{" in line:
        name, rest = line.split("{", 1)
        return f"{name}{{{extra},{rest}"
    name, _, value = line.partition(" ")
    return f"{name}{{{extra}}} {value}"


def merge_expositions(sources: list[dict]) -> str:
    """Merge several Prometheus text expositions into one valid document:
    each family's `# HELP`/`# TYPE` emitted once, every sample line
    relabeled with its source's host/role/shard. `sources` entries are
    {"labels": dict, "text": str}."""
    fams: dict = {}
    order: list[str] = []

    def fam(name: str) -> dict:
        f = fams.get(name)
        if f is None:
            f = fams[name] = {"help": "", "type": "", "samples": []}
            order.append(name)
        return f

    for src in sources:
        labels = src["labels"]
        current = None
        for line in src["text"].splitlines():
            if line.startswith("# HELP "):
                name, _, help_text = line[len("# HELP "):].partition(" ")
                f = fam(name)
                if not f["help"]:
                    f["help"] = help_text
            elif line.startswith("# TYPE "):
                name, _, kind = line[len("# TYPE "):].partition(" ")
                current = name
                f = fam(name)
                if not f["type"]:
                    f["type"] = kind
            elif line and not line.startswith("#"):
                line_name = line.split("{", 1)[0].split(" ", 1)[0]
                target = (
                    current
                    if current is not None and line_name.startswith(current)
                    else line_name
                )
                fam(target)["samples"].append(_inject_labels(line, labels))
    out: list[str] = []
    for name in order:
        f = fams[name]
        if f["help"]:
            out.append(f"# HELP {name} {f['help']}")
        if f["type"]:
            out.append(f"# TYPE {name} {f['type']}")
        out.extend(f["samples"])
    return "\n".join(out) + "\n"


def parse_samples(text: str, name: str) -> list[tuple[dict, float]]:
    """Extract one family's (labels, value) samples from exposition text
    (the collector reads resident-pool/shed gauges out of shipped
    snapshots with this — no second wire format needed)."""
    out = []
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        if "{" in line:
            lname, rest = line.split("{", 1)
            if lname != name:
                continue
            labelstr, _, value = rest.rpartition("} ")
            labels = {}
            # keys are unquoted, so '",' unambiguously ends a label value
            # (our registries never emit escaped quotes in values)
            for part in labelstr.split('",'):
                if "=" not in part:
                    continue
                k, _, v = part.partition("=")
                labels[k.strip(' ,"')] = v.strip('"')
        else:
            lname, _, value = line.partition(" ")
            if lname != name:
                continue
            labels = {}
        try:
            out.append((labels, float(value)))
        except ValueError:
            continue
    return out


# --------------------------------------------------------------------------
# collector (proxy / controller process)
# --------------------------------------------------------------------------


class FleetCollector:
    """Stitch + audit + federate. One per proxy-role process.

    Subscribes to the LOCAL tracer (taking over the Watchtower's seat —
    deploy wires the Watchtower to be fed exclusively through here, so a
    trace is audited exactly once, with the remote spans present) and
    registers the `panopticon` endpoint on the process's TcpNet for
    shipped batches."""

    MAX_TRACES = 1024
    MAX_TRACE_SPANS = 4096
    MAX_INCIDENTS = 1024
    DONE_LRU = 2048

    def __init__(self, net, *, secret: bytes, host: str, role: str = "proxy",
                 region: str = "", stitch_window: float = 1.0,
                 staleness: float = 10.0, flush_interval: float = 0.25,
                 watchtower=None, tracer: Tracer | None = None,
                 registry=None, slo=None):
        self.net = net
        self.secret = secret
        self.host, self.role = host, role
        self.region = region  # Atlas: the collector process's own region
        self.stitch_window = max(0.0, stitch_window)
        # the fleet's shippers' flush interval: a source whose batch
        # arrived a flush interval past a root's due time has shipped that
        # trace's spans
        self.flush_interval = max(0.0, flush_interval)
        self.staleness = staleness
        if watchtower is None:
            from dds_tpu_torch.obs.watchtower import watchtower as _wt
            watchtower = _wt
        self.watchtower = watchtower
        self.tracer = tracer if tracer is not None else default_tracer
        self.metrics = registry if registry is not None else default_metrics
        self.slo = slo  # the proxy's own SloEngine (local source)
        # Chronoscope (or None): fed each stitched tree at replay time so
        # the proxy's pipe profile sees remote replica/ingest spans too.
        # Deploy detaches the Chronoscope from the raw tracer and parks it
        # here — a trace is profiled exactly once, stitched.
        self.profiler = None
        self.addr = net.local_addr(COLLECTOR_ENDPOINT)
        # trace_id -> {"records": [SpanRecord], "root": SpanRecord | None,
        #              "due": monotonic | None, "first": monotonic}
        self._traces: collections.OrderedDict = collections.OrderedDict()
        self._done: collections.OrderedDict = collections.OrderedDict()
        # ids of traces evicted unaudited whose roots have not arrived yet
        # (bounded): their later spans are dropped, never replayed as a tree
        self._evicted: collections.OrderedDict = collections.OrderedDict()
        # local spans land on the recording thread (the folds' worker
        # threads too), shipped ones and the replay on the loop
        self._lock = threading.Lock()
        # host -> latest snapshot {"role","shard","ts","mono","seq",
        #                          "metrics_text","slo","dropped"}
        self._sources: dict[str, dict] = {}
        self._incidents: collections.deque = collections.deque(
            maxlen=self.MAX_INCIDENTS
        )
        self._task: asyncio.Task | None = None
        self.traces_stitched = 0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self.net.register(self.addr, self.handle)
        self.tracer.subscribe(self.on_record)
        if self._task is None or self._task.done():
            self._task = supervised_task(self._stitch_loop(),
                                         name="panopticon.collector")

    async def stop(self) -> None:
        self.tracer.unsubscribe(self.on_record)
        self.net.unregister(self.addr)
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # ------------------------------------------------- local tracer feed

    def on_record(self, rec) -> None:
        try:
            if rec.trace_id is None:
                # trace-less events (breaker transitions, suspicion
                # strikes) drive cross-trace machines: feed straight
                # through, nothing to stitch
                self.watchtower.on_record(rec)
                return
            self._buffer(rec, local=True)
        except Exception:  # noqa: BLE001
            log.exception("collector local ingest failed")

    def _buffer(self, rec, *, local: bool) -> None:
        tid = rec.trace_id
        root = rec.kind == "span" and rec.parent_id is None
        evicted = 0
        with self._lock:
            if tid in self._done:
                return  # already replayed/audited — a straggler
            if tid in self._evicted:
                # the rest of an evicted trace: a tree missing its first
                # spans would audit as a quorum of nobody
                if root:
                    del self._evicted[tid]
                return
            buf = self._traces.get(tid)
            if buf is None:
                buf = self._traces[tid] = {
                    "records": [], "root": None, "due": None,
                    "first": time.monotonic(),
                }
                while len(self._traces) > self.MAX_TRACES:
                    old_tid, _ = self._traces.popitem(last=False)
                    self._evicted[old_tid] = None
                    while len(self._evicted) > 8 * self.MAX_TRACES:
                        self._evicted.popitem(last=False)
                    evicted += 1
            if root:
                # the trace's root: hold the audit open one stitch window
                # so remote handler spans (a socket + flush interval
                # behind) join the tree before the Watchtower sees it
                # complete
                buf["root"] = rec
                buf["due"] = time.monotonic() + self.stitch_window
            elif len(buf["records"]) < self.MAX_TRACE_SPANS:
                buf["records"].append(rec)
        for _ in range(evicted):
            self.metrics.inc(
                "dds_fleet_collect_evicted_total",
                help="in-flight stitch buffers evicted unaudited "
                     "(bounded memory)",
            )

    # ------------------------------------------------------ shipped batches

    async def handle(self, src: str, msg) -> None:
        if not isinstance(msg, M.TelemetryBatch):
            return
        expect = batch_mac(self.secret, msg.host, msg.role, msg.shard,
                           msg.seq, msg.ts, msg.spans, msg.incidents,
                           msg.metrics_text, msg.slo, msg.dropped,
                           getattr(msg, "region", ""))
        if not hmac_mod.compare_digest(msg.mac, expect):
            self.metrics.inc(
                "dds_fleet_collect_rejected_total", reason="mac",
                help="telemetry batches the collector refused",
            )
            self.net.send(self.addr, src,
                          M.TelemetryAck(seq=msg.seq, ok=False,
                                         error="bad mac"))
            return
        self._sources[msg.host] = {
            "role": msg.role, "shard": msg.shard, "ts": msg.ts,
            "region": getattr(msg, "region", ""),
            "mono": time.monotonic(), "seq": msg.seq,
            "metrics_text": msg.metrics_text, "slo": msg.slo,
            "dropped": msg.dropped,
        }
        for entry in msg.incidents:
            if isinstance(entry, dict):
                self._incidents.append(
                    {**entry, "host": msg.host, "role": msg.role}
                )
        for tree in msg.spans:
            if not isinstance(tree, list):
                continue
            for d in tree:
                if not isinstance(d, dict):
                    continue
                rec = record_from_dict(d)
                if rec is None:
                    continue
                if rec.trace_id is None:
                    self.watchtower.on_record(rec)
                else:
                    self._buffer(rec, local=False)
        self.metrics.inc("dds_fleet_collect_batches_total", host=msg.host,
                         help="verified telemetry batches ingested")
        self.net.send(self.addr, src, M.TelemetryAck(seq=msg.seq, ok=True))

    # ----------------------------------------------------------- stitching

    async def _stitch_loop(self) -> None:
        tick = max(0.05, min(0.25, self.stitch_window / 4 or 0.25))
        while True:
            await asyncio.sleep(tick)
            try:
                self._replay_due()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("panopticon stitch replay failed")

    def _heard_from_all(self, now: float) -> float | None:
        """The collector's monotonic time by which every live source has
        delivered a batch (the oldest of their latest arrivals), or None
        with no live source."""
        live = [src["mono"] for src in self._sources.values()
                if not (self.staleness and now - src["mono"] > self.staleness)]
        return min(live) if live else None

    def _replay_due(self) -> None:
        now = time.monotonic()
        grace = max(8 * self.stitch_window, 8.0)
        heard = self._heard_from_all(now)
        bufs = []
        with self._lock:
            due = [
                tid for tid, buf in self._traces.items()
                # a root is replayed a stitch window after it arrived and
                # once every live source has delivered a batch a flush
                # interval past that: a group process running late holds
                # the audit back (up to the grace) instead of having its
                # spans missed (ROADMAP §C 22). One clock, this process's:
                # a group host's may run fast or slow
                if (buf["due"] is not None and buf["due"] <= now
                    and (heard is None
                         or heard >= buf["due"] + self.flush_interval
                         or now - buf["due"] > grace))
                # rootless traces (background work on a remote host whose
                # root never reaches this process) are dropped unaudited
                # after a generous grace
                or (buf["due"] is None and now - buf["first"] > grace)
            ]
            for tid in due:
                buf = self._traces.pop(tid, None)
                if buf is None:
                    continue
                self._done[tid] = True
                while len(self._done) > self.DONE_LRU:
                    self._done.popitem(last=False)
                bufs.append(buf)
        for buf in bufs:
            if buf["root"] is None:
                continue
            # children first, root LAST: the Watchtower audits on root
            # completion, so the stitched tree must be fully buffered
            # before the root record lands
            for rec in buf["records"]:
                self.watchtower.on_record(rec)
            self.watchtower.on_record(buf["root"])
            if self.profiler is not None:
                try:
                    self.profiler.ingest_tree(buf["records"] + [buf["root"]])
                except Exception:  # noqa: BLE001 — profiling never breaks stitching
                    log.exception("chronoscope stitched-tree ingest failed")
            self.traces_stitched += 1
            self.metrics.inc(
                "dds_fleet_traces_stitched_total",
                help="cross-host trace trees stitched and replayed into "
                     "the Watchtower",
            )

    # ----------------------------------------------------------- federation

    def _source_rows(self) -> list[dict]:
        """Every known source, local process first, with staleness."""
        now = time.monotonic()
        rows = [{
            "host": self.host, "role": self.role, "shard": "",
            "region": self.region,
            "age_s": 0.0, "stale": False,
            "metrics_text": self.metrics.render(),
            "slo": self.slo.report() if self.slo is not None else {},
            "dropped": 0,
        }]
        for host, src in sorted(self._sources.items()):
            age = now - src["mono"]
            rows.append({
                "host": host, "role": src["role"], "shard": src["shard"],
                "region": src.get("region", ""),
                "age_s": age,
                "stale": bool(self.staleness and age > self.staleness),
                "metrics_text": src["metrics_text"], "slo": src["slo"],
                "dropped": src["dropped"],
            })
        return rows

    def source_ages(self) -> dict[str, float]:
        """Shard gid -> seconds since that group process's last shipped
        batch. The span shipper beats ~1/s even when idle, so an age of
        tens of seconds means the PROCESS is gone, not merely quiet —
        the Helmsman controller's dead-group takeover signal. Sources
        without a shard label (proxies, observers) are skipped; when two
        sources claim one shard the freshest wins."""
        now = time.monotonic()
        out: dict[str, float] = {}
        for src in self._sources.values():
            gid = src.get("shard") or ""
            if not gid:
                continue
            age = now - src["mono"]
            if gid not in out or age < out[gid]:
                out[gid] = age
        return out

    def source_regions(self) -> dict[str, str]:
        """Shard gid -> home region, from the shipped identity labels.
        Feeds Helmsman's `regions` signal on the Meridian proxy role so
        canary region evidence (Heliograph) and region_down declarations
        can map back to the groups homed there. Freshest source wins a
        contested gid, mirroring `source_ages`."""
        now = time.monotonic()
        best: dict[str, tuple[float, str]] = {}
        for src in self._sources.values():
            gid = src.get("shard") or ""
            region = src.get("region", "") or ""
            if not gid or not region:
                continue
            age = now - src["mono"]
            if gid not in best or age < best[gid][0]:
                best[gid] = (age, region)
        return {gid: region for gid, (_, region) in best.items()}

    def fleet_metrics(self) -> str:
        """The `GET /fleet/metrics` body: every source's exposition merged
        into one valid document, samples labeled by origin, plus
        synthesized per-source freshness series."""
        rows = self._source_rows()
        sources = []
        for r in rows:
            labels = {"host": r["host"], "role": r["role"]}
            if r["shard"]:
                labels["shard"] = r["shard"]
            if r.get("region"):
                labels["region"] = r["region"]
            sources.append({"labels": labels, "text": r["metrics_text"]})
        doc = merge_expositions(sources)
        extra = [
            "# HELP dds_fleet_source_age_seconds seconds since each "
            "source's last telemetry batch (0 for the collector itself)",
            "# TYPE dds_fleet_source_age_seconds gauge",
        ]
        for r in rows:
            extra.append(
                f'dds_fleet_source_age_seconds{{host="{r["host"]}",'
                f'role="{r["role"]}"}} {r["age_s"]:.3f}'
            )
        extra.append("# HELP dds_fleet_source_stale 1 when a source's "
                     "last batch is older than obs.fleet.staleness")
        extra.append("# TYPE dds_fleet_source_stale gauge")
        for r in rows:
            extra.append(
                f'dds_fleet_source_stale{{host="{r["host"]}",'
                f'role="{r["role"]}"}} {1 if r["stale"] else 0}'
            )
        extra.append("# HELP dds_fleet_ship_dropped_by_source telemetry "
                     "units each source reports having dropped")
        extra.append("# TYPE dds_fleet_ship_dropped_by_source gauge")
        for r in rows:
            extra.append(
                f'dds_fleet_ship_dropped_by_source{{host="{r["host"]}"}} '
                f'{r["dropped"]}'
            )
        return doc + "\n".join(extra) + "\n"

    def fleet_slo(self) -> dict:
        """The `GET /fleet/slo` body: per-host SLO reports plus the fleet
        rollup — per route/window, worst-of burn across hosts and the
        sum-of burn over pooled counts — and the autoscaler sensor suite
        (per-group resident-pool pressure, per-host shed level)."""
        rows = self._source_rows()
        hosts: dict = {}
        routes: dict = {}
        resident: dict = {}
        shed: dict = {}
        for r in rows:
            hosts[r["host"]] = {
                "role": r["role"], "shard": r["shard"],
                "region": r.get("region", ""),
                "age_s": round(r["age_s"], 3), "stale": r["stale"],
                "dropped": r["dropped"],
                "slo": r["slo"],
            }
            for labels, v in parse_samples(r["metrics_text"],
                                           "dds_resident_rows"):
                gid = labels.get("shard", r["shard"] or "-")
                resident.setdefault(gid, {})["rows"] = v
                resident[gid]["host"] = r["host"]
            for labels, v in parse_samples(r["metrics_text"],
                                           "dds_resident_bytes"):
                gid = labels.get("shard", r["shard"] or "-")
                resident.setdefault(gid, {})["bytes"] = v
            for _, v in parse_samples(r["metrics_text"],
                                      "dds_admission_shed_level"):
                shed[r["host"]] = v
            slo = r["slo"] if isinstance(r["slo"], dict) else {}
            for route, rep in (slo.get("routes") or {}).items():
                agg = routes.setdefault(route, {
                    "objective": rep.get("objective"),
                    "class": rep.get("class"),
                    "windows": {},
                })
                for wname, w in (rep.get("windows") or {}).items():
                    wa = agg["windows"].setdefault(
                        wname,
                        {"total": 0, "bad": 0, "burn_rate_worst": 0.0},
                    )
                    wa["total"] += int(w.get("total", 0))
                    wa["bad"] += int(w.get("bad", 0))
                    wa["burn_rate_worst"] = max(
                        wa["burn_rate_worst"], float(w.get("burn_rate", 0.0))
                    )
        for route, agg in routes.items():
            budget = max(1e-9, 1.0 - float(agg.get("objective") or 0.99))
            for w in agg["windows"].values():
                frac = (w["bad"] / w["total"]) if w["total"] else 0.0
                w["burn_rate_sum_of"] = round(frac / budget, 3)
        return {
            "hosts": hosts,
            "fleet": {
                "routes": routes,
                "resident": resident,
                "shed_level": shed,
                "shed_level_max": max(shed.values(), default=0.0),
            },
        }

    def fleet_profile(self) -> dict:
        """The `GET /fleet/profile` body: every host's Chronoscope pipe
        profile (carried as `dds_pipe_*` gauges inside the shipped
        metrics_text — zero wire-format changes) rolled up per route.

        Rollup semantics: a stage's fleet p95 is the MAX across hosts —
        stages run on different processes (proxy coalesce vs replica
        apply vs group ingest), so the worst host's self-time is the
        fleet's bottleneck candidate, not an average that would dilute a
        single hot shard. `top` names the single (route, stage) pair with
        the largest p95 self-time fleet-wide."""
        hosts: dict = {}
        routes: dict = {}
        for r in self._source_rows():
            hrow = hosts.setdefault(r["host"], {
                "role": r["role"], "shard": r["shard"],
                "region": r.get("region", ""),
                "age_s": round(r["age_s"], 3), "stale": r["stale"],
                "routes": {},
            })
            text = r["metrics_text"]
            for labels, v in parse_samples(text, "dds_pipe_wall_p95_ms"):
                route = labels.get("route", "-")
                hrow["routes"].setdefault(route, {})["wall_p95_ms"] = v
                agg = routes.setdefault(route, {
                    "wall_p95_ms": 0.0, "coverage_min": None, "stages": {},
                })
                agg["wall_p95_ms"] = max(agg["wall_p95_ms"], v)
            for labels, v in parse_samples(text, "dds_pipe_coverage"):
                route = labels.get("route", "-")
                hrow["routes"].setdefault(route, {})["coverage"] = v
                agg = routes.setdefault(route, {
                    "wall_p95_ms": 0.0, "coverage_min": None, "stages": {},
                })
                cur = agg["coverage_min"]
                agg["coverage_min"] = v if cur is None else min(cur, v)
            for labels, v in parse_samples(text, "dds_pipe_stage_p95_ms"):
                route = labels.get("route", "-")
                stage = labels.get("stage", "other")
                agg = routes.setdefault(route, {
                    "wall_p95_ms": 0.0, "coverage_min": None, "stages": {},
                })
                st = agg["stages"].setdefault(
                    stage, {"p95_ms": 0.0, "host": None})
                if v >= st["p95_ms"]:
                    st["p95_ms"], st["host"] = v, r["host"]
        top = None
        for route, agg in routes.items():
            best = None
            for stage, st in agg["stages"].items():
                if stage == "other":
                    continue  # the unattributed residue is not a bottleneck NAME
                if best is None or st["p95_ms"] > best[1]:
                    best = (stage, st["p95_ms"], st["host"])
            if best is not None:
                agg["top_stage"] = {
                    "stage": best[0], "p95_ms": round(best[1], 3),
                    "host": best[2],
                }
                if top is None or best[1] > top["p95_ms"]:
                    top = {"route": route, "stage": best[0],
                           "p95_ms": round(best[1], 3), "host": best[2]}
        return {"hosts": hosts, "fleet": {"routes": routes, "top": top}}

    _CANARY_VERDICTS = ("ok", "slow", "wrong_answer", "unreachable")

    def fleet_canary(self) -> dict:
        """The `GET /fleet/canary` body: every host's Heliograph ledger
        state (carried as `dds_canary_*` gauges inside the shipped
        metrics_text — zero wire-format changes, like the pipe profile)
        rolled up per probe kind.

        Rollup semantics: a kind's fleet verdict is the WORST across
        hosts (the verdict enum is severity-ordered) — one region's
        prober seeing wrong answers IS the fleet's problem, not a
        minority report to average away. `failures` lists every host's
        current exemplar, newest-first by ledger sequence; each trace id
        resolves via `GET /fleet/incidents?trace_id=...` into the
        stitched Chronoscope span tree for that probe."""
        hosts: dict = {}
        kinds: dict = {}
        failures: list = []
        regions_down: set[str] = set()
        enum = self._CANARY_VERDICTS
        for r in self._source_rows():
            hrow = hosts.setdefault(r["host"], {
                "role": r["role"], "shard": r["shard"],
                "region": r.get("region", ""),
                "age_s": round(r["age_s"], 3), "stale": r["stale"],
                "kinds": {},
            })
            text = r["metrics_text"]
            for labels, v in parse_samples(text, "dds_canary_verdict"):
                kind = labels.get("kind", "-")
                i = int(v) if 0 <= v < len(enum) else len(enum) - 1
                hrow["kinds"].setdefault(kind, {})["verdict"] = enum[i]
                agg = kinds.setdefault(kind, {"worst": 0, "hosts": 0})
                agg["hosts"] += 1
                agg["worst"] = max(agg["worst"], i)
            for labels, v in parse_samples(
                    text, "dds_canary_last_ok_age_seconds"):
                kind = labels.get("kind", "-")
                hrow["kinds"].setdefault(kind, {})["last_ok_age_s"] = (
                    round(v, 3))
            for labels, v in parse_samples(text, "dds_canary_exemplar"):
                failures.append({
                    "host": r["host"], "region": r.get("region", ""),
                    "kind": labels.get("kind", "-"),
                    "verdict": labels.get("verdict", "-"),
                    "trace_id": labels.get("trace_id", ""),
                    "seq": v,
                })
            for labels, v in parse_samples(
                    text, "dds_canary_region_unreachable"):
                if v and labels.get("region"):
                    regions_down.add(labels["region"])
        failures.sort(key=lambda f: -f["seq"])
        for agg in kinds.values():
            agg["worst"] = enum[agg["worst"]]
        return {
            "hosts": hosts,
            "fleet": {
                "kinds": kinds,
                "failures": failures[:32],
                "unreachable_regions": sorted(regions_down),
            },
        }

    def fleet_incidents(self, trace_id: str | None = None) -> dict:
        """The `GET /fleet/incidents` body: shipped incident-index entries
        (newest last) correlated by trace id, plus the collector-side
        audit verdicts — the fleet-wide `why` for any offending trace."""
        entries = [e for e in self._incidents
                   if trace_id is None or e.get("trace_id") == trace_id]
        by_trace: dict = {}
        for e in entries:
            tid = e.get("trace_id")
            if tid:
                by_trace.setdefault(tid, []).append(e)
        verdicts = [
            v.as_dict() for v in self.watchtower.verdicts()
            if trace_id is None or v.trace_id == trace_id
        ]
        return {
            "count": len(entries),
            "incidents": entries,
            "by_trace": by_trace,
            "verdicts": verdicts,
        }

    def sample_gauges(self) -> None:
        """Scrape-time collector gauges (http/server's
        `_sample_state_gauges` hook)."""
        self.metrics.set("dds_fleet_sources", len(self._sources),
                         help="remote telemetry sources the collector "
                              "currently knows")
        with self._lock:
            pending = len(self._traces)
        self.metrics.set("dds_fleet_pending_traces", pending,
                         help="trace trees buffered awaiting stitch replay")

    def stats(self) -> dict:
        with self._lock:
            pending = len(self._traces)
        return {
            "sources": sorted(self._sources),
            "pending_traces": pending,
            "traces_stitched": self.traces_stitched,
            "incidents": len(self._incidents),
        }
