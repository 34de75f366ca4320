"""Flight recorder: fault-triggered incident dumps for post-mortems.

Copy of `dds_tpu/obs/flight.py`, the same file format and index.

When the stack detects a fault — a suspicion quorum, a circuit breaker
opening, a request budget exhausting (`DeadlineExceededError`), a
Trudy/Nemesis attack firing — the in-memory telemetry that explains it is
about to be overwritten by the span ring. The flight recorder freezes it:
one JSONL incident file per fault with a header record (fault kind, info,
live counters, span summary) followed by the faulting trace's full span
tree and the tail of the span ring. Every chaos-suite failure becomes
self-describing instead of un-reproducible.

Disabled unless given a directory (config `obs.flight_dir` or env
`DDS_OBS_FLIGHT_DIR`) — recording is a disk write on a fault path, so it
must be opt-in and can never raise into the caller. Incidents are
rate-limited per kind (`min_interval`) and pruned to `max_incidents`
files, so a flapping breaker cannot fill a disk. Writes are atomic
(tmp + rename): a crash mid-dump leaves no truncated incident.

Every incident also appends one line to `<dir>/index.jsonl` —
`{"ts", "kind", "trace_id", "path"}` — so operators (and tooling)
enumerate incidents in order without globbing or opening each file;
pruning rewrites the index to drop entries whose file is gone, keeping
it authoritative under the same `max_incidents` retention bound.

Env flags: DDS_OBS_FLIGHT_DIR, DDS_OBS_FLIGHT_MAX (default 32),
DDS_OBS_FLIGHT_INTERVAL (seconds per kind, default 1.0).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import pathlib
import threading
import time

from dds_tpu_torch.obs import context as obs_context
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.flight")

__all__ = ["FlightRecorder", "flight"]


class FlightRecorder:
    # span-ring tail included in every incident alongside the faulting trace
    RING_TAIL = 512

    def __init__(self, dir: str | None = None, max_incidents: int | None = None,
                 min_interval: float | None = None):
        env_dir = os.environ.get("DDS_OBS_FLIGHT_DIR", "")
        self.dir = dir if dir is not None else (env_dir or None)
        self.max_incidents = (
            max_incidents
            if max_incidents is not None
            else int(os.environ.get("DDS_OBS_FLIGHT_MAX", "32") or 32)
        )
        self.min_interval = (
            min_interval
            if min_interval is not None
            else float(os.environ.get("DDS_OBS_FLIGHT_INTERVAL", "1.0") or 1.0)
        )
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}  # kind -> monotonic ts of last dump
        self._seq = 0
        # process identity stamped into every incident header (host/role/
        # shard) so fleet-wide correlation (obs/panopticon) can attribute
        # an incident to its source without parsing file paths
        self.identity: dict = {}

    def configure(self, dir: str | None = None, max_incidents: int | None = None,
                  min_interval: float | None = None,
                  identity: dict | None = None) -> None:
        """Late wiring from a deployment config (run.launch)."""
        if dir is not None:
            self.dir = dir or None
        if max_incidents is not None:
            self.max_incidents = max_incidents
        if min_interval is not None:
            self.min_interval = min_interval
        if identity is not None:
            self.identity = {k: str(v) for k, v in identity.items()}

    @property
    def enabled(self) -> bool:
        return bool(self.dir)

    def record(self, kind: str, trace_id: str | None = None, **info):
        """Dump one incident; returns its path, or None (disabled /
        rate-limited / write failure — never raises). `trace_id` defaults
        to the active trace so the faulting request's tree is captured."""
        if not self.enabled:
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last.get(kind)
            if last is not None and now - last < self.min_interval:
                metrics.inc(
                    "dds_incidents_suppressed_total", kind=kind,
                    help="flight-recorder dumps skipped by rate limiting",
                )
                return None
            self._last[kind] = now
            self._seq += 1
            seq = self._seq
        if trace_id is None:
            cur = obs_context.current()
            trace_id = cur.trace_id if cur is not None else None
        try:
            return self._write(kind, seq, trace_id, info)
        except OSError as e:
            log.warning("flight recorder dump for %r failed: %s", kind, e)
            return None

    async def record_async(self, kind: str, trace_id: str | None = None,
                           **info):
        """`record` for coroutine callers: same semantics, but the lock
        acquisition and disk write happen on a worker thread so an
        incident dump never stalls the event loop (which is busy running
        every other replica in the process). The trace id is resolved
        HERE, on the loop thread, so the faulting request's context is
        captured before the thread hop."""
        if not self.enabled:
            return None
        if trace_id is None:
            cur = obs_context.current()
            trace_id = cur.trace_id if cur is not None else None
        return await asyncio.to_thread(self.record, kind, trace_id, **info)

    # ----------------------------------------------------------- internals

    def _write(self, kind: str, seq: int, trace_id: str | None, info: dict):
        events = tracer.events()
        faulting = (
            [e for e in events if e.trace_id == trace_id] if trace_id else []
        )
        tail = events[-self.RING_TAIL:]
        header = {
            "incident": kind,
            "ts": time.time(),
            "trace_id": trace_id,
            **self.identity,
            "info": info,
            "counters": tracer.counters(),
            "summary": tracer.summary(),
            "trace_spans": len(faulting),
            "ring_tail": len(tail),
        }
        d = pathlib.Path(self.dir)
        d.mkdir(parents=True, exist_ok=True)
        safe_kind = "".join(c if c.isalnum() or c in "-_" else "_" for c in kind)
        name = f"incident-{int(time.time() * 1e3):013d}-{seq:04d}-{safe_kind}.jsonl"
        tmp = d / (name + ".tmp")
        with open(tmp, "w") as f:
            f.write(json.dumps(header, default=str) + "\n")
            for e in faulting:
                f.write(json.dumps(
                    {"section": "trace", **tracer.event_dict(e)}, default=str,
                ) + "\n")
            for e in tail:
                f.write(json.dumps(
                    {"section": "ring", **tracer.event_dict(e)}, default=str,
                ) + "\n")
        path = d / name
        os.replace(tmp, path)
        self._index_append(d, {
            "ts": header["ts"], "kind": kind, "trace_id": trace_id,
            "path": name, **self.identity,
        })
        metrics.inc("dds_incidents_total", kind=kind,
                    help="flight-recorder incident dumps written")
        self._prune(d)
        return str(path)

    INDEX = "index.jsonl"

    def _index_append(self, d: pathlib.Path, entry: dict) -> None:
        try:
            with open(d / self.INDEX, "a") as f:
                f.write(json.dumps(entry, default=str) + "\n")
        except OSError as e:
            log.warning("flight index append failed: %s", e)

    def _prune(self, d: pathlib.Path) -> None:
        incidents = sorted(d.glob("incident-*.jsonl"))
        pruned = incidents[: max(0, len(incidents) - self.max_incidents)]
        for old in pruned:
            try:
                old.unlink()
            except OSError:
                pass
        if pruned:
            self._rewrite_index(d)

    def _rewrite_index(self, d: pathlib.Path) -> None:
        """Drop index entries whose incident file is gone (atomic rewrite:
        a crash mid-prune leaves the previous index, never a truncated
        one). Unparseable lines are dropped too — the index is derived
        state, the incident files stay authoritative."""
        idx = d / self.INDEX
        try:
            lines = idx.read_text().splitlines()
        except OSError:
            return
        kept = []
        for line in lines:
            try:
                entry = json.loads(line)
            except ValueError:
                continue
            if isinstance(entry, dict) and (d / str(entry.get("path"))).exists():
                kept.append(json.dumps(entry, default=str))
        try:
            tmp = idx.with_name(idx.name + ".tmp")
            tmp.write_text("".join(l + "\n" for l in kept))
            os.replace(tmp, idx)
        except OSError as e:
            log.warning("flight index rewrite failed: %s", e)


# process-wide recorder; run.launch() configures it from DDSConfig.obs
flight = FlightRecorder()
