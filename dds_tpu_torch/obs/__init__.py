"""Observability of the port: trace context, metrics, kernel profiling,
the flight recorder, the SLO engine, the Watchtower, Chronoscope, the
kernel sentry (`obs.sentry`), Heliograph's active canary
(`obs.heliograph`) and Panopticon, the fleet-wide plane
(`obs.panopticon`: cross-host span shipping, the proxy's collector that
stitches and audits, federated metrics, SLO, profile and canary views,
incident correlation).

Only the leaf modules load eagerly; the rest resolve on first access
(PEP 562), as in the reference, so the import graph stays acyclic and
importing the package starts nothing.
"""

from dds_tpu_torch.obs import context  # noqa: F401
from dds_tpu_torch.obs.metrics import Registry, metrics  # noqa: F401

__all__ = [
    "context", "metrics", "Registry", "flight", "kprof", "watchtower", "slo",
    "sentry", "chronoscope", "heliograph", "panopticon",
]

_LAZY = ("flight", "kprof", "watchtower", "slo", "sentry", "chronoscope", "heliograph",
         "panopticon")


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
