"""Counters, gauges and fixed-bucket histograms; Prometheus text.

Trimmed copy of `dds_tpu/obs/metrics.py`: the `Registry` (`inc`, `set`,
`observe`, `value`, `render`, `reset`) and the process-wide `metrics`
instance. The resident plane, its pools and ingest queue, Stratum's tiers
and segment store, and Prism count into it under the reference's series
names (`dds_resident_*`, `dds_tier_*`, `dds_queue_*`,
`dds_cipher_store_total`, `dds_analytics_*`),
so a sequence of operations leaves the same counter values in both
packages. The `/metrics` route that serves `render()` comes with the obs
planes.

- histograms are FIXED-bucket (chosen at first observe): cumulative
  `_bucket{le=...}` counts plus `_sum`/`_count`, the standard shape
  Prometheus quantile queries expect;
- every mutation takes one short lock;
- label cardinality is BOUNDED per family (`max_series`, default 1024):
  once a family holds that many distinct label sets, new label sets fold
  into a single `overflow` series and `dds_metrics_label_overflow_total
  {family=...}` counts the fold.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field

__all__ = [
    "Registry", "metrics",
    "LATENCY_BUCKETS", "SIZE_BUCKETS",
    "OVERFLOW_LABEL", "OVERFLOW_COUNTER",
]

# seconds: 1ms .. 10s, the REST/quorum latency range under chaos schedules
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
# element counts: fold widths / batch sizes
SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _escape(v: str) -> str:
    # label VALUE escaping per the text-format spec: backslash first (or
    # the escapes we add would themselves be re-escaped), then quote and
    # newline — a raw newline would split the sample line mid-series
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    # HELP text escaping per the spec: only backslash and newline (quotes
    # are legal in help text, unlike in label values)
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    # integers render without a trailing .0 — smaller payloads, and exact
    # counter values survive a text round-trip
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


@dataclass
class _Family:
    kind: str                      # counter | gauge | histogram
    help: str = ""
    buckets: tuple = ()
    # label-key -> float (counter/gauge) or [bucket_counts, sum, count]
    samples: dict = field(default_factory=dict)


OVERFLOW_LABEL = "overflow"
OVERFLOW_COUNTER = "dds_metrics_label_overflow_total"


class Registry:
    def __init__(self, max_series: int = 1024):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self.max_series = int(max_series)

    # -------------------------------------------------------------- writes

    def _family(self, name: str, kind: str, help: str, buckets: tuple = ()):
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(kind, help, buckets)
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, not {kind}"
            )
        elif not fam.help and help:
            # backfill: the first touch may come from a call site that
            # passes no help (scrape-time gauges are set from several
            # places) — a later documented touch must still yield # HELP
            fam.help = help
        return fam

    def _admit(self, fam: _Family, name: str, key: tuple) -> tuple:
        """Cardinality guard (caller holds the lock): an already-known
        label set, any label set while the family is under `max_series`,
        and the overflow counter itself pass through; a NEW label set at
        the cap folds into the family's single `overflow` series and is
        counted in `dds_metrics_label_overflow_total{family=...}`."""
        if (
            not key
            or key in fam.samples
            or len(fam.samples) < self.max_series
            or name == OVERFLOW_COUNTER
        ):
            return key
        oc = self._family(
            OVERFLOW_COUNTER, "counter",
            "label sets folded into the overflow series by the per-family "
            "cardinality cap",
        )
        okey = _label_key({"family": name})
        oc.samples[okey] = oc.samples.get(okey, 0.0) + 1
        return tuple((k, OVERFLOW_LABEL) for k, _ in key)

    def inc(self, name: str, n: float = 1.0, help: str = "", **labels) -> None:
        """Add `n` to a counter series (created on first touch)."""
        key = _label_key(labels)
        with self._lock:
            fam = self._family(name, "counter", help)
            key = self._admit(fam, name, key)
            fam.samples[key] = fam.samples.get(key, 0.0) + n

    def set(self, name: str, value: float, help: str = "", **labels) -> None:
        """Set a gauge series to `value`."""
        key = _label_key(labels)
        with self._lock:
            fam = self._family(name, "gauge", help)
            key = self._admit(fam, name, key)
            fam.samples[key] = float(value)

    def observe(self, name: str, value: float, buckets: tuple = LATENCY_BUCKETS,
                help: str = "", **labels) -> None:
        """Record one observation into a fixed-bucket histogram series."""
        key = _label_key(labels)
        with self._lock:
            fam = self._family(name, "histogram", help, tuple(buckets))
            key = self._admit(fam, name, key)
            s = fam.samples.get(key)
            if s is None:
                s = fam.samples[key] = [[0] * len(fam.buckets), 0.0, 0]
            i = bisect.bisect_left(fam.buckets, value)
            if i < len(fam.buckets):
                s[0][i] += 1
            s[1] += value
            s[2] += 1

    # --------------------------------------------------------------- reads

    def value(self, name: str, **labels) -> float | None:
        """Current counter/gauge value of one series (tests/introspection)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam.kind == "histogram":
                return None
            return fam.samples.get(_label_key(labels))

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    # ---------------------------------------------------------- exposition

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: list[str] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if fam.help:
                    out.append(f"# HELP {name} {_escape_help(fam.help)}")
                out.append(f"# TYPE {name} {fam.kind}")
                for key in sorted(fam.samples):
                    labels = dict(key)
                    if fam.kind == "histogram":
                        counts, total, count = fam.samples[key]
                        cum = 0
                        for le, c in zip(fam.buckets, counts):
                            cum += c
                            out.append(
                                f"{name}_bucket{{{self._labels(labels, le=_fmt(le))}}} {cum}"
                            )
                        out.append(
                            f'{name}_bucket{{{self._labels(labels, le="+Inf")}}} {count}'
                        )
                        suffix = self._labels(labels)
                        brace = f"{{{suffix}}}" if suffix else ""
                        out.append(f"{name}_sum{brace} {_fmt(total)}")
                        out.append(f"{name}_count{brace} {count}")
                    else:
                        suffix = self._labels(labels)
                        brace = f"{{{suffix}}}" if suffix else ""
                        out.append(f"{name}{brace} {_fmt(fam.samples[key])}")
        return "\n".join(out) + "\n"

    @staticmethod
    def _labels(labels: dict, **extra) -> str:
        items = {**labels, **extra}
        return ",".join(f'{k}="{_escape(str(v))}"' for k, v in items.items())


# process-wide default registry (subsystems import this)
metrics = Registry()
