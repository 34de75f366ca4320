"""Kernel sentry: per-kernel timing baselines and their comparison.

Copy of `dds_tpu/obs/sentry.py`. It distills the kprof spans
(`kernel.<name>.dispatch`, `.compile` and `.execute`, `obs/kprof.py`)
into per-kernel-and-shape p50/p95 statistics (`collect`), persists them
as a baseline file (`save_baseline`, `load_baseline`) and lists what a
fresh run lost against a stored baseline (`compare`: slower than the
threshold and past a floor).

Baseline file schema (JSON), the reference's:

    {"version": 1, "updated": <unix ts>, "kernels": {
        "<platform>::<kernel>[k=...,R=...]": {
            "dispatch": {"p50_ms": ..., "p95_ms": ..., "count": N},
            "execute":  {"p50_ms": ..., "p95_ms": ..., "count": N},
            "compile":  {"p50_ms": ..., "p95_ms": ..., "count": N}}}}

Each phase is optional per entry; a phase missing on either side is not
compared. Keys carry the execution platform (`platform()`), so a row
taken on one device is never compared with another's.

`check_geo_records(root)` is the geo-latency row checker of the
reference's `benchmarks/sentry.py` (`_check_geo_records`): the same rows
of `<root>/benchmarks/results.json` and `results_quick.json` pass or
raise ValueError in both.

Two divergences from the reference:
- `platform()` answers from torch: `cuda` once this process has used a
  card (the kernel spans then come from one), `cpu` otherwise; the
  reference asks jax for its default backend. `DDS_SENTRY_PLATFORM`
  overrides in both.
- `baseline_path()` defaults to `dds_tpu_torch/kernel_baseline.json`
  (listed in `.gitignore`), a file of the port's own: the reference's
  default, `benchmarks/kernel_baseline.json`, belongs to the JAX package
  and holds its `tpu::` and `cpu::` rows, so the port neither reads nor
  writes it. `DDS_KERNEL_BASELINE` overrides in both.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import time

__all__ = [
    "collect", "load_baseline", "save_baseline", "compare",
    "baseline_path", "persist_from_tracer", "platform", "check_geo_records",
]

PHASES = ("dispatch", "execute", "compile")
# span meta keys that name the kernel's shape: part of the key, never
# averaged across
SHAPE_KEYS = ("k", "K", "R", "P2", "L")

_VERSION = 1
_DEFAULT_PATH = pathlib.Path(__file__).resolve().parents[1] / "kernel_baseline.json"


def baseline_path(path: str | None = None) -> pathlib.Path:
    """The baseline file: the explicit argument, else DDS_KERNEL_BASELINE,
    else the port's own `dds_tpu_torch/kernel_baseline.json`."""
    if path:
        return pathlib.Path(path)
    env = os.environ.get("DDS_KERNEL_BASELINE", "")
    if env:
        return pathlib.Path(env)
    return _DEFAULT_PATH


def platform() -> str:
    """The platform prefixed onto every baseline key: DDS_SENTRY_PLATFORM,
    else `cuda` when this process has initialised a card (its kernel spans
    come from one), else `cpu`."""
    env = os.environ.get("DDS_SENTRY_PLATFORM", "").strip()
    if env:
        return env
    import torch

    return "cuda" if torch.cuda.is_initialized() else "cpu"


def _percentile(sorted_vals: list[float], q: float) -> float:
    k = len(sorted_vals)
    return sorted_vals[max(0, min(k - 1, math.ceil(q * k) - 1))]


def collect(trc=None) -> dict:
    """Per-kernel {phase: {p50_ms, p95_ms, count}} from the tracer ring's
    `kernel.*` spans, keyed by platform, kernel name and shape meta."""
    if trc is None:
        from dds_tpu_torch.utils.trace import tracer as trc
    plat = platform()
    groups: dict[str, dict[str, list[float]]] = {}
    for e in trc.events():
        if e.kind != "span" or not e.name.startswith("kernel."):
            continue
        base, _, phase = e.name[len("kernel."):].rpartition(".")
        if phase not in PHASES or not base:
            continue
        shape = ",".join(f"{k}={e.meta[k]}" for k in SHAPE_KEYS if k in e.meta)
        key = f"{plat}::{base}[{shape}]" if shape else f"{plat}::{base}"
        groups.setdefault(key, {}).setdefault(phase, []).append(e.dur_ms)
    out: dict = {}
    for key, phases in sorted(groups.items()):
        entry = {}
        for phase, durs in phases.items():
            durs.sort()
            entry[phase] = {
                "p50_ms": round(_percentile(durs, 0.50), 4),
                "p95_ms": round(_percentile(durs, 0.95), 4),
                "count": len(durs),
            }
        out[key] = entry
    return out


# ---------------------------------------------------------------- baseline


def load_baseline(path: str | None = None) -> dict:
    """The baseline file's `kernels` dict; {} when the file is missing.
    Raises ValueError on a malformed file."""
    p = baseline_path(path)
    if not p.exists():
        return {}
    try:
        data = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"unreadable baseline {p}: {e}") from e
    if not isinstance(data, dict) or not isinstance(data.get("kernels"), dict):
        raise ValueError(f"malformed baseline {p}: expected {{'kernels': ...}}")
    kernels = {}
    for name, entry in data["kernels"].items():
        if not isinstance(entry, dict):
            raise ValueError(f"malformed baseline entry {name!r} in {p}")
        for phase, stats in entry.items():
            if phase not in PHASES or not isinstance(stats, dict):
                raise ValueError(f"malformed baseline phase {name!r}.{phase!r} in {p}")
            for k in ("p50_ms", "p95_ms"):
                if not isinstance(stats.get(k), (int, float)):
                    raise ValueError(f"baseline {name!r}.{phase}.{k} is not a number in {p}")
        kernels[str(name)] = entry
    return kernels


def save_baseline(stats: dict, path: str | None = None,
                  overwrite: bool = False) -> dict:
    """Merge `stats` into the baseline file (written to a temporary file,
    then renamed). Existing kernels win unless `overwrite`: a routine run
    must not ratchet a baseline to a slower value. Returns the merged
    kernels."""
    p = baseline_path(path)
    try:
        existing = load_baseline(p)
    except ValueError:
        existing = {}  # a corrupt baseline is replaced, not fatal
    merged = dict(existing)
    for name, entry in stats.items():
        if overwrite or name not in merged:
            merged[name] = entry
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text(json.dumps(
        {"version": _VERSION, "updated": time.time(), "kernels": merged},
        indent=1, sort_keys=True,
    ))
    os.replace(tmp, p)
    return merged


def persist_from_tracer(path: str | None = None,
                        overwrite: bool | None = None) -> dict | None:
    """Collect the tracer's kernel stats and merge them into the baseline
    file; None when no kernel span exists. DDS_KERNEL_BASELINE="" disables;
    DDS_KERNEL_BASELINE_UPDATE=1 lets the run overwrite existing entries."""
    if "DDS_KERNEL_BASELINE" in os.environ and not os.environ["DDS_KERNEL_BASELINE"]:
        return None
    stats = collect()
    if not stats:
        return None
    if overwrite is None:
        overwrite = os.environ.get(
            "DDS_KERNEL_BASELINE_UPDATE", ""
        ).strip().lower() in ("1", "true", "yes", "on")
    save_baseline(stats, path, overwrite=overwrite)
    return stats


# --------------------------------------------------------------- comparison


def compare(baseline: dict, fresh: dict, threshold: float = 0.20,
            floor_ms: float = 0.05) -> list[dict]:
    """Each (kernel, phase, stat) of the kernels in both sides where
    fresh > baseline * (1 + threshold) and the difference clears
    `floor_ms`; [] is clean."""
    findings = []
    for name in sorted(set(baseline) & set(fresh)):
        for phase in PHASES:
            b, f = baseline[name].get(phase), fresh[name].get(phase)
            if not b or not f:
                continue
            for stat in ("p50_ms", "p95_ms"):
                bv, fv = float(b[stat]), float(f[stat])
                if fv > bv * (1.0 + threshold) and fv - bv > floor_ms:
                    findings.append({
                        "kernel": name,
                        "phase": phase,
                        "stat": stat,
                        "baseline_ms": bv,
                        "fresh_ms": fv,
                        "ratio": round(fv / bv, 3) if bv > 0 else None,
                    })
    return findings


def _iter_result_rows(root: str):
    """(file name, record) for every row of the result files under
    `<root>/benchmarks`. An unreadable or mis-shaped file raises
    ValueError."""
    for name in ("results.json", "results_quick.json"):
        path = os.path.join(root, "benchmarks", name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            try:
                rows = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"unreadable results file {name}: {e}") from e
        if not isinstance(rows, list):
            raise ValueError(f"malformed results file {name}: expected a list")
        for row in rows:
            yield name, row


def check_geo_records(root: str) -> dict:
    """Validate `geo latency` rows: a positive read-local-vs-quorum
    speedup and a detail block proving where it came from (both p95s, a
    leased-read count, the mid-run revocation flag, ZERO stale reads and a
    named WAN preset). Returns {"rows": n}; a malformed row raises
    ValueError."""
    presets = {"wan-100", "wan-200", "wan-300"}

    def positive(v) -> bool:
        return isinstance(v, (int, float)) and v > 0

    found = 0
    for name, row in _iter_result_rows(root):
        if not (isinstance(row, dict)
                and str(row.get("metric", "")).startswith("geo latency")):
            continue
        detail = row.get("detail")
        ok = (
            positive(row.get("value"))
            and isinstance(detail, dict)
            and positive(detail.get("local_p95_ms"))
            and positive(detail.get("quorum_p95_ms"))
            and isinstance(detail.get("reads"), int) and detail["reads"] > 0
            and isinstance(detail.get("leased_reads"), int)
            and detail["leased_reads"] > 0
            and isinstance(detail.get("fallbacks"), int)
            and detail["fallbacks"] >= 0
            and detail.get("revoked_mid_run") is True
            and detail.get("stale_reads") == 0
            and detail.get("wan_preset") in presets
        )
        if not ok:
            raise ValueError(f"malformed geo-latency record in {name}: "
                             f"{row.get('metric')!r}")
        found += 1
    return {"rows": found}
