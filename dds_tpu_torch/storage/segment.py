"""Stratum cold tier: append-only log-structured ciphertext segments.

Port of `dds_tpu/storage/segment.py`, on-disk format unchanged: a segment
log either package writes loads in the other. One `SegmentStore` per
node persists demoted ciphertexts as a sequence of immutable segment
files plus a rotating manifest, with the snapshot discipline of
`core/snapshot.py` (HMAC footer, fsync before rename, directory fsync):

    {name}.segment.{seq:08d}.log
        <canonical JSON body>\n<hmac-sha256 hex footer>\n
        body = {"v": 1, "seq": s, "saved_at": ts,
                "records": [{"gid": g, "tenant": t, "modulus": hex,
                             "ciphers": [hex, ...]}, ...]}

    {name}.manifest.{gen:08d}.json
        same framing; body = {"v": 1, "generation": g, "saved_at": ts,
                              "segments": [segment file names]}

Properties the tier planner leans on:

- **Append-only**: a demotion wave writes ONE new segment (fsync before
  rename, directory fd fsync'd after — `snapshot.write_authenticated`),
  then a new manifest generation referencing it. A crash between the
  two leaves an *orphan* segment: `load()` scans the directory, verifies
  every footer, and ADOPTS verified orphans into a fresh manifest — a
  crash mid-demotion never loses a durably-written row.
- **Logical deletes**: promotion back to warmer tiers only drops the
  in-memory index entry; the bytes stay until `compact()` rewrites the
  live set into one segment. Content addressing makes re-appends of the
  same value harmless (set union at load).
- **Keep-N manifests, never-strand segments**: manifest generations
  rotate keep-N like snapshots, and segment pruning deletes ONLY files
  absent from the NEWEST manifest — a file any retained generation still
  names but the newest dropped is compaction garbage by definition,
  while everything the newest names is load-bearing and untouchable.
- **Verify-on-read**: `read_rows` re-verifies the segment footer at
  every cold read (bit-rot between boot and read is caught, not folded);
  corrupt files quarantine to `*.corrupt` exactly like snapshots.

The store is synchronous and blocking by design — every caller reaches
it from a worker thread (`asyncio.to_thread`), never the event loop.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import re
import threading
import time

import numpy as np

from dds_tpu_torch.core.snapshot import (
    DEFAULT_BASE,
    derive_secret,
    read_authenticated,
    write_authenticated,
)
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.ops import bignum as bn

log = logging.getLogger("dds.stratum")

_SEG_RE = re.compile(r"\.segment\.(\d{8})\.log$")
_MAN_RE = re.compile(r"\.manifest\.(\d{8})\.json$")

# (gid, tenant, modulus) — the same pool address Lodestone stripes by
Stripe = tuple


def derive_segment_secret(base: bytes = DEFAULT_BASE,
                          node_key_path=None) -> bytes:
    """Segment MAC key: the snapshot derivation with Stratum's own label,
    so a snapshot footer can never verify as a segment footer."""
    return derive_secret(base, node_key_path, label=b"dds-stratum-mac-v1")


def _stripe_to_wire(stripe: Stripe) -> dict:
    gid, tenant, modulus = stripe
    return {"gid": gid, "tenant": tenant, "modulus": f"{modulus:x}"}


def _stripe_from_wire(rec: dict) -> Stripe:
    return (str(rec["gid"]), str(rec["tenant"]), int(str(rec["modulus"]), 16))


class SegmentStore:
    """Append-only HMAC'd segment log + rotating manifest (see module
    docstring). Thread-safe; all disk work happens under one lock (the
    callers are worker threads, so serializing demotion waves is the
    point, not a hazard)."""

    def __init__(self, directory, name: str = "stratum",
                 secret: bytes | None = None, keep: int = 3,
                 compact_segments: int = 8):
        self.dir = pathlib.Path(directory)
        self.name = name
        self.keep = max(1, int(keep))
        self.compact_segments = max(2, int(compact_segments))
        self._secret = secret or derive_segment_secret()
        self._lock = threading.Lock()
        # seq -> path of every live (manifest-referenced or adopted) segment
        self._live: dict[int, pathlib.Path] = {}
        # stripe -> {cipher int -> seq holding it}
        self._index: dict[Stripe, dict[int, int]] = {}
        self._generation = 0
        self.quarantined = 0
        self.compactions = 0

    # -------------------------------------------------------------- framing

    def _seg_path(self, seq: int) -> pathlib.Path:
        return self.dir / f"{self.name}.segment.{seq:08d}.log"

    def _scan(self, pattern: re.Pattern, glob: str):
        out = []
        for p in self.dir.glob(glob):
            m = pattern.search(p.name)
            if m:
                out.append((int(m.group(1)), p))
        return sorted(out)

    def _quarantine(self, path: pathlib.Path, reason: str) -> None:
        target = path.with_name(path.name + ".corrupt")
        log.warning("quarantining segment file %s -> %s (%s)",
                    path, target.name, reason)
        self.quarantined += 1
        metrics.inc(
            "dds_segment_verify_failures_total",
            help="segment/manifest files quarantined (corrupt/truncated/"
                 "forged)",
        )
        try:
            os.replace(path, target)
        except OSError as e:  # pragma: no cover - fs-dependent
            log.warning("could not quarantine %s: %s", path, e)

    def _read_segment(self, path: pathlib.Path) -> dict:
        body = json.loads(read_authenticated(path, self._secret))
        if body.get("v") != 1 or not isinstance(body.get("records"), list):
            raise ValueError(f"unsupported segment body v={body.get('v')!r}")
        return body

    def _write_segment(self, seq: int,
                       entries: dict[Stripe, list[int]]) -> pathlib.Path:
        records = [
            {**_stripe_to_wire(stripe),
             "ciphers": [f"{c:x}" for c in ciphers]}
            for stripe, ciphers in entries.items() if ciphers
        ]
        body = json.dumps(
            {"v": 1, "seq": seq, "saved_at": time.time(), "records": records},
            sort_keys=True, separators=(",", ":"),
        ).encode()
        path = self._seg_path(seq)
        write_authenticated(path, body, self._secret)
        return path

    def _write_manifest(self) -> None:
        """New manifest generation naming every live segment, then keep-N
        rotation of OLDER manifest generations only (caller holds lock)."""
        self._generation += 1
        body = json.dumps(
            {"v": 1, "generation": self._generation, "saved_at": time.time(),
             "segments": [p.name for _, p in sorted(self._live.items())]},
            sort_keys=True, separators=(",", ":"),
        ).encode()
        path = self.dir / f"{self.name}.manifest.{self._generation:08d}.json"
        write_authenticated(path, body, self._secret)
        for gen, old in self._scan(_MAN_RE, f"{self.name}.manifest.*.json"):
            if gen <= self._generation - self.keep:
                try:
                    old.unlink()
                except OSError:  # pragma: no cover - fs-dependent
                    pass

    # ----------------------------------------------------------------- boot

    def load(self) -> int:
        """Scan + verify every segment on disk, quarantining corrupt or
        truncated files; adopt verified orphans (crash-mid-demotion) into
        a fresh manifest. Returns distinct entries indexed. Never raises
        for bad files — one flipped byte cannot abort boot."""
        self.dir.mkdir(parents=True, exist_ok=True)
        with self._lock:
            # newest verified manifest seeds the generation counter (and
            # is itself quarantined when unverifiable — the segment scan
            # below is the source of truth for contents either way)
            manifested: set[str] = set()
            for gen, path in reversed(
                self._scan(_MAN_RE, f"{self.name}.manifest.*.json")
            ):
                try:
                    body = json.loads(read_authenticated(path, self._secret))
                    if body.get("v") != 1:
                        raise ValueError("unsupported manifest version")
                except (OSError, ValueError, json.JSONDecodeError) as e:
                    self._quarantine(path, str(e))
                    continue
                self._generation = max(self._generation, gen)
                manifested = set(body.get("segments") or [])
                break
            adopted = 0
            for seq, path in self._scan(
                _SEG_RE, f"{self.name}.segment.*.log"
            ):
                try:
                    body = self._read_segment(path)
                except (OSError, ValueError, json.JSONDecodeError) as e:
                    self._quarantine(path, str(e))
                    continue
                self._live[seq] = path
                if path.name not in manifested:
                    adopted += 1
                for rec in body["records"]:
                    stripe = _stripe_from_wire(rec)
                    dest = self._index.setdefault(stripe, {})
                    for hexc in rec.get("ciphers", ()):
                        dest[int(hexc, 16)] = seq
            if adopted:
                # crash-mid-demotion: the segment made it, the manifest
                # didn't — re-manifest so the next compaction sees it live
                log.info("adopting %d orphan segment(s) into manifest",
                         adopted)
                self._write_manifest()
            return sum(len(v) for v in self._index.values())

    # --------------------------------------------------------------- writes

    def append(self, entries: dict[Stripe, list[int]]) -> int | None:
        """Persist one demotion wave as a new segment + manifest
        generation; returns the new seq (None when `entries` is empty).
        Durable (fsync'd) before return — a row acked into the cold tier
        survives any crash after this call."""
        entries = {s: [c for c in cs] for s, cs in entries.items() if cs}
        if not entries:
            return None
        with self._lock:
            self.dir.mkdir(parents=True, exist_ok=True)
            seq = (max(self._live) + 1) if self._live else 1
            path = self._write_segment(seq, entries)
            self._live[seq] = path
            for stripe, ciphers in entries.items():
                dest = self._index.setdefault(stripe, {})
                for c in ciphers:
                    dest[c] = seq
            self._write_manifest()
            if len(self._live) > self.compact_segments:
                self._compact_locked()
            return seq

    def _compact_locked(self) -> None:
        """Rewrite the live entry set into ONE fresh segment, manifest it,
        then delete every segment file the NEWEST manifest no longer
        names. Pruning is driven off the newest manifest alone — a
        segment any retained generation references is only deleted once
        the newest generation has stopped naming it, and everything the
        newest names survives (the co-rotation invariant the tests pin)."""
        live_entries: dict[Stripe, list[int]] = {
            stripe: sorted(m) for stripe, m in self._index.items() if m
        }
        seq = (max(self._live) + 1) if self._live else 1
        path = self._write_segment(seq, live_entries)
        old = dict(self._live)
        self._live = {seq: path}
        for stripe in list(self._index):
            self._index[stripe] = {
                c: seq for c in self._index[stripe]
            }
        self._write_manifest()
        for oseq, opath in old.items():
            if oseq == seq:
                continue
            try:
                opath.unlink()
            except OSError:  # pragma: no cover - fs-dependent
                pass
        self.compactions += 1
        metrics.inc(
            "dds_segment_compactions_total",
            help="cold-tier segment compactions (live set rewritten)",
        )

    def compact(self) -> None:
        with self._lock:
            if self._live:
                self._compact_locked()

    def discard(self, stripe: Stripe, ciphers) -> int:
        """Logical delete (promotion to a warmer tier): drop the index
        entries; bytes reclaim at the next compaction."""
        with self._lock:
            dest = self._index.get(stripe)
            if not dest:
                return 0
            dropped = 0
            for c in ciphers:
                if dest.pop(c, None) is not None:
                    dropped += 1
            return dropped

    # ---------------------------------------------------------------- reads

    def contains(self, stripe: Stripe, cipher: int) -> bool:
        with self._lock:
            dest = self._index.get(stripe)
            return bool(dest) and cipher in dest

    def entries(self) -> dict[Stripe, list[int]]:
        """Stripe -> live ciphers (boot-time directory seeding)."""
        with self._lock:
            return {s: list(m) for s, m in self._index.items() if m}

    def read_rows(self, stripe: Stripe, ciphers: list[int],
                  L: int) -> np.ndarray:
        """(K, L) uint32 limb rows for `ciphers` (duplicates allowed, order
        preserved) read from disk with footer re-verification per touched
        segment. Raises KeyError when a cipher is not in the cold index,
        ValueError when a touched segment fails verification (the caller
        falls back to converting from the operand it already holds)."""
        modulus = stripe[2]
        with self._lock:
            dest = self._index.get(stripe) or {}
            need: dict[int, int] = {}
            for c in ciphers:
                seq = dest.get(c)
                if seq is None:
                    raise KeyError(c)
                need[c] = seq
            paths = {seq: self._live[seq] for seq in set(need.values())}
        present: set[int] = set()
        nbytes = 0
        for seq, path in paths.items():
            body = self._read_segment(path)  # re-verify at read time
            nbytes += path.stat().st_size
            for rec in body["records"]:
                if _stripe_from_wire(rec) != stripe:
                    continue
                for hexc in rec.get("ciphers", ()):
                    present.add(int(hexc, 16))
        missing = [c for c in need if c not in present]
        if missing:
            raise KeyError(missing[0])
        metrics.inc(
            "dds_tier_cold_read_bytes_total", nbytes, shard=stripe[0] or "-",
            help="segment bytes read + re-verified by cold-tier streams",
        )
        return bn.ints_to_batch([c % modulus for c in ciphers], L)

    # -------------------------------------------------------------- surface

    def stats(self) -> dict:
        with self._lock:
            rows = sum(len(m) for m in self._index.values())
            nbytes = 0
            for p in self._live.values():
                try:
                    nbytes += p.stat().st_size
                except OSError:  # pragma: no cover - fs-dependent
                    pass
            return {
                "rows": rows,
                "bytes": nbytes,
                "segments": len(self._live),
                "generation": self._generation,
                "quarantined": self.quarantined,
                "compactions": self.compactions,
            }
