"""Tenant identity at the trust boundary: validate before anything keys on it.

Copy of `dds_tpu/core/tenant.py`. The REST edge parses the tenant header
on every request, whether tenancy is on or off; tenancy itself (per-tenant
keyspaces, plane striping) is not ported, so here the id keys admission
buckets only.

The ``x-dds-tenant`` header is wire input that used to flow RAW into
admission bucket labels — and with Bastion it flows into keyring lookups,
pool striping, and metric labels, all of which are dictionaries keyed by
the value. This module is the single clamp every consumer goes through:

- absent / empty header → ``DEFAULT_TENANT`` (single-tenant deployments
  never notice tenancy exists);
- well-formed ids (``[A-Za-z0-9][A-Za-z0-9._-]{0,63}``) pass through;
- anything else — control bytes, quotes, over-length, leading
  punctuation — raises the typed `TenantError`, which the REST edge maps
  to a 400 (never a silent fallback: a garbled id that fell back to
  "default" would silently read another tenant's keyspace).

The charset is the conservative DNS-label-plus-dots alphabet: safe in
metric label values, file names, JSON, and log lines without escaping.
"""

from __future__ import annotations

import re

__all__ = ["DEFAULT_TENANT", "CANARY_TENANT", "TENANT_RE", "MAX_TENANT_LEN",
           "TenantError", "validate_tenant"]

DEFAULT_TENANT = "default"
MAX_TENANT_LEN = 64
TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

# Heliograph's reserved canary keyspace. The leading underscore is
# REJECTED by TENANT_RE for everyone else, which is exactly the point:
# no wire-supplied tenant id can ever collide with (or squat on) the
# canary keyspace; only the explicit carve-out below admits it. Canary
# traffic is clamped like any tenant but bypasses tenant-fair admission
# through its own rate-bounded bucket and is excluded from the SLO
# engine's route objectives — see http/server.py.
CANARY_TENANT = "__heliograph__"


class TenantError(ValueError):
    """Typed 400: the tenant header is present but malformed."""

    def __init__(self, raw: str, reason: str):
        super().__init__(f"invalid tenant id: {reason}")
        self.raw = raw
        self.reason = reason


def validate_tenant(raw: str | None) -> str:
    """Clamp a wire-supplied tenant header to a safe identifier.

    Returns `DEFAULT_TENANT` for None/empty, the id itself when valid,
    and raises `TenantError` otherwise.
    """
    if raw is None:
        return DEFAULT_TENANT
    value = raw.strip()
    if not value:
        return DEFAULT_TENANT
    if value == CANARY_TENANT:
        # the one id allowed to break the leading-character rule: the
        # prober's own requests arrive through the same REST edge
        return value
    if len(value) > MAX_TENANT_LEN:
        raise TenantError(value[:MAX_TENANT_LEN] + "...",
                          f"longer than {MAX_TENANT_LEN} chars")
    if not TENANT_RE.match(value):
        raise TenantError(value, "must match [A-Za-z0-9][A-Za-z0-9._-]*")
    return value
