"""Crash-safe authenticated snapshots (v2) of replica state, and the file
discipline Stratum's segment store (`storage/segment.py`) shares.

Copy of `dds_tpu/core/snapshot.py`: the MAC-key derivation and the framed
write and read of one file,

    <body>\\n<hmac-sha256 hex footer>\\n

written tmp file -> flush + fsync -> atomic rename -> directory fsync, so
a crash at any point leaves either the previous file or the complete new
one, and read back only when the footer verifies; then replica snapshots
on top of it, one file per generation, `{name}.snapshot.{gen:08d}.json`:

    body = {"v": 2, "generation": g, "saved_at": unix-ts,
            "repository": {key: [tag.seq, tag.id, value]},
            "nonces": {str(nonce): expired_bool}}

`save_replica` writes the next generation and prunes to the newest
`keep`; `load_replica` walks newest-first, quarantines every file that
fails verification (renamed `*.corrupt`, never loaded, never raised) and
installs the first that verifies, the FULL anti-replay nonce map
included. Unauthenticated v1 files (`{name}.snapshot.json`) still load
with a warning. Snapshots warm cold starts only: replication stays the
source of truth and anti-entropy converges a restored replica. The same
base, label, framing and body as the reference, so a file either package
writes loads in the other.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
import os
import pathlib
import re
import time

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.obs.metrics import metrics

log = logging.getLogger("dds_torch.snapshot")

# default derivation base = the default intranet secret, so bare calls
# (tests, tooling) stay self-consistent with a default config
DEFAULT_BASE = b"intranet-abd-secret"

_GEN_RE = re.compile(r"\.snapshot\.(\d{8})\.json$")


def derive_secret(base: bytes = DEFAULT_BASE,
                  node_key_path: str | os.PathLike | None = None,
                  label: bytes = b"dds-snapshot-mac-v2") -> bytes:
    """MAC key: HMAC-derived from the intranet secret, mixed with the
    node's transport key file when one is provisioned — per-node keys then
    yield per-node file keys. `label` domain-separates sibling on-disk
    formats sharing the discipline (the segment store derives with its own
    label, so a snapshot footer can never verify as a segment footer)."""
    material = bytes(base)
    if node_key_path:
        p = pathlib.Path(node_key_path)
        if p.exists():
            material += p.read_bytes()
    return hmac.new(material, label, hashlib.sha256).digest()


def write_authenticated(path: pathlib.Path, body: bytes, secret: bytes) -> None:
    """Write `body` + HMAC-SHA256 hex footer crash-safely: tmp file,
    flush + fsync, atomic rename, then directory-fd fsync so the rename
    itself is durable. A crash at any point leaves either the previous
    file or the complete new one."""
    footer = hmac.new(secret, body, hashlib.sha256).hexdigest().encode()
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(body + b"\n" + footer + b"\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        # the rename itself must be durable, or a crash can resurface the
        # old directory entry with the new data gone
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # pragma: no cover - fs-dependent
        pass


def read_authenticated(path: pathlib.Path, secret: bytes) -> bytes:
    """Verify + strip the HMAC footer; returns the body bytes. Raises
    ValueError on truncation or footer mismatch (corrupt or forged)."""
    raw = path.read_bytes()
    body, sep, footer = raw.rstrip(b"\n").rpartition(b"\n")
    if not sep or not body:
        raise ValueError("truncated (no footer)")
    if not hmac.compare_digest(
        hmac.new(secret, body, hashlib.sha256).hexdigest().encode(),
        footer.strip(),
    ):
        raise ValueError("HMAC footer mismatch (corrupt or forged)")
    return body


def _generations(directory: pathlib.Path, name: str) -> list[tuple[int, pathlib.Path]]:
    """(gen, path) for every v2 generation file of `name`, newest first."""
    out = []
    for p in directory.glob(f"{name}.snapshot.*.json"):
        m = _GEN_RE.search(p.name)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out, reverse=True)


def _quarantine(path: pathlib.Path, reason: str, replica: str) -> None:
    """Rename a bad snapshot aside (`*.corrupt`) instead of loading it or
    letting its parse error abort boot."""
    target = path.with_name(
        path.name[:-len(".json")] + ".corrupt"
        if path.name.endswith(".json") else path.name + ".corrupt"
    )
    log.warning("quarantining snapshot %s -> %s (%s)", path, target.name, reason)
    metrics.inc(
        "dds_snapshot_verify_failures_total", replica=replica,
        help="snapshot files quarantined at load (corrupt/truncated/forged)",
    )
    try:
        os.replace(path, target)
    except OSError as e:  # pragma: no cover - fs-dependent
        log.warning("could not quarantine %s: %s", path, e)


def save_replica(node, directory: str | os.PathLike,
                 secret: bytes | None = None, keep: int = 3) -> pathlib.Path:
    """Write one authenticated generation of the node's state; prune to
    the newest `keep` generations."""
    secret = secret or derive_secret()
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    gens = _generations(d, node.name)
    gen = (gens[0][0] + 1) if gens else 1
    state = {
        "v": 2,
        "generation": gen,
        "saved_at": time.time(),
        "repository": {
            k: [t.seq, t.id, v] for k, (t, v) in node.repository.items()
        },
        # the FULL anti-replay map: in-flight (unexpired) nonces must
        # survive a restore or they become replayable
        "nonces": {str(n): bool(e) for n, e in node.incoming.items()},
    }
    body = json.dumps(state, sort_keys=True, separators=(",", ":")).encode()
    path = d / f"{node.name}.snapshot.{gen:08d}.json"
    write_authenticated(path, body, secret)
    for _, old in _generations(d, node.name)[max(1, keep):]:
        try:
            old.unlink()
        except OSError:  # pragma: no cover - fs-dependent
            pass
    node.snapshot_meta = {"generation": gen, "saved_at": state["saved_at"]}
    metrics.set("dds_snapshot_generation", gen, replica=node.name,
                help="latest snapshot generation written or loaded")
    return path


def _read_v2(path: pathlib.Path, secret: bytes) -> dict:
    state = json.loads(read_authenticated(path, secret))
    if state.get("v") != 2:
        raise ValueError(f"unsupported snapshot version {state.get('v')!r}")
    return state


def _install(node, state: dict, generation: int) -> None:
    node._install_repository({
        k: (M.ABDTag(int(seq), str(tid)), v)
        for k, (seq, tid, v) in (
            (k, tuple(entry)) for k, entry in state["repository"].items()
        )
    })
    for n, expired in (state.get("nonces") or {}).items():
        node.incoming[int(n)] = bool(expired)
    for n in state.get("expired_nonces", []):  # v1 files
        node.incoming[int(n)] = True
    node.snapshot_meta = {
        "generation": generation,
        "saved_at": state.get("saved_at"),
        "loaded": True,
    }
    metrics.set("dds_snapshot_generation", generation, replica=node.name,
                help="latest snapshot generation written or loaded")


def load_replica(node, directory: str | os.PathLike,
                 secret: bytes | None = None) -> bool:
    """Restore the newest VERIFIED snapshot generation, quarantining every
    corrupt/truncated/forged file it walks past; never raises for bad
    files, so one flipped byte cannot abort `run.launch`."""
    secret = secret or derive_secret()
    d = pathlib.Path(directory)
    for gen, path in _generations(d, node.name):
        try:
            state = _read_v2(path, secret)
        except (OSError, ValueError, json.JSONDecodeError, UnicodeDecodeError) as e:
            _quarantine(path, str(e), node.name)
            continue
        _install(node, state, gen)
        return True
    legacy = d / f"{node.name}.snapshot.json"
    if legacy.exists():
        try:
            state = json.loads(legacy.read_text())
            if not isinstance(state, dict) or "repository" not in state:
                raise ValueError("not a v1 snapshot object")
        except (OSError, ValueError, json.JSONDecodeError, UnicodeDecodeError) as e:
            _quarantine(legacy, str(e), node.name)
            return False
        log.warning(
            "loaded UNAUTHENTICATED v1 snapshot %s; the next save upgrades "
            "it to the authenticated v2 format", legacy,
        )
        _install(node, state, int(state.get("generation", 0)))
        return True
    return False


def save_all(replicas: dict, directory: str | os.PathLike,
             secret: bytes | None = None, keep: int = 3) -> int:
    for node in replicas.values():
        save_replica(node, directory, secret=secret, keep=keep)
    return len(replicas)


def load_all(replicas: dict, directory: str | os.PathLike,
             secret: bytes | None = None) -> int:
    return sum(
        1 for node in replicas.values()
        if load_replica(node, directory, secret=secret)
    )
