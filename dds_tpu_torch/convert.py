"""Carry state across from `dds_tpu`: constants, resident rows, client keys.

In this system what plays the role of weights is the per-modulus
Montgomery constants, the device-resident ciphertext rows and the
client's HE key material, one family or a tenant keyring's families. The
first two cross as plain numpy arrays in the shared layout — (count, L)
uint32 of 16-bit little-endian limbs, the layout `dds_tpu`'s pools hold
and its Stratum segment files persist — and the keys as `HEKeys` JSON,
the format both packages write; a keyring crosses as each tenant's epochs
`(version, HEKeys JSON, created_at, grace_until)`, newest first, plus the
set of shredded tenants. Nothing here imports the reference.
"""

from __future__ import annotations

import base64
import binascii
import json
from math import gcd

import numpy as np

from dds_tpu_torch.models.keys import HEKeys
from dds_tpu_torch.models.tenancy import KeyEpoch, TenantKeyring, _TenantDomain
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops.montgomery import ModCtx
from dds_tpu_torch.resident.pool import ResidentPool


def ctx_from_numpy(n: int, N, R2, one_mont, n0inv) -> ModCtx:
    """The port's context for modulus `n`, checked against a reference
    context's numpy constants (`dds_tpu.ops.montgomery.ModCtx` fields N,
    R2, one_mont, n0inv). The limbs and n0' must always agree. At even L
    the radix is the same, so R^2 mod n and R mod n must agree too; at odd
    L the reference's radix is one limb narrower, and its constants are
    checked against that radix instead. Raises ValueError on a mismatch."""
    ctx = ModCtx.make(n)
    N = np.asarray(N, np.uint32)
    if not np.array_equal(N, ctx.N):
        raise ValueError("modulus limbs differ")
    if int(n0inv) != ctx.n0inv:
        raise ValueError("n0' differs")
    R_ref = 1 << (16 * len(N))
    want_r2 = ctx.R2 if R_ref == ctx.R else bn.int_to_limbs(R_ref * R_ref % n, ctx.L)
    want_one = ctx.one_mont if R_ref == ctx.R else bn.int_to_limbs(R_ref % n, ctx.L)
    if not np.array_equal(np.asarray(R2, np.uint32), want_r2):
        raise ValueError("R^2 mod n differs")
    if not np.array_equal(np.asarray(one_mont, np.uint32), want_one):
        raise ValueError("R mod n differs")
    return ctx


def pool_from_numpy(modulus: int, ciphers: list[int], rows_u32,
                    device="cuda", **pool_kwargs) -> ResidentPool:
    """A port `ResidentPool` holding a reference pool's rows: `rows_u32`
    is the (count, L) uint32 buffer prefix and `ciphers[i]` the
    ciphertext whose limbs row i holds. Every row is checked against its
    ciphertext (content addressing: a row that does not encode its key
    must never become resident). Raises ValueError on a mismatch."""
    rows = np.asarray(rows_u32, np.uint32)
    ctx = ModCtx.make(modulus)
    if rows.ndim != 2 or rows.shape != (len(ciphers), ctx.L):
        raise ValueError(f"rows must be ({len(ciphers)}, {ctx.L}), got {rows.shape}")
    if not np.array_equal(rows, bn.ints_to_batch([c % modulus for c in ciphers], ctx.L)):
        raise ValueError("a row does not hold its ciphertext")
    pool = ResidentPool(modulus, device=device, **pool_kwargs)
    pool.ingest(list(ciphers), rows)
    return pool


# HEKeys JSON: scheme tag -> {field: "hex" (an int) | "b64" (32 key bytes)}
_KEY_FIELDS = {
    "OPE": {"key": "b64"},
    "CHE": {"k_enc": "b64", "k_mac": "b64"},
    "LSE": {"k_enc": "b64", "k_tag": "b64"},
    "PSSE": {"n": "hex", "p": "hex", "q": "hex"},
    "MSE": {"n": "hex", "e": "hex", "d": "hex", "p": "hex", "q": "hex"},
    "None": {"key": "b64"},
}


def _validated_key_json(blob: str) -> dict:
    """Parse HEKeys JSON and check it field by field: exactly the schemes
    and fields of `_KEY_FIELDS`, hex ints > 1, base64 keys of 32 bytes,
    n = p * q for PSSE and MSE, and e * d = 1 mod lcm(p - 1, q - 1) for
    MSE. Raises ValueError naming the first bad field."""
    d = json.loads(blob)
    if not isinstance(d, dict) or set(d) != set(_KEY_FIELDS):
        raise ValueError(f"key JSON must hold exactly {sorted(_KEY_FIELDS)}")
    ints = {}
    for tag, fields in _KEY_FIELDS.items():
        if not isinstance(d[tag], dict) or set(d[tag]) != set(fields):
            raise ValueError(f"{tag} must hold exactly {sorted(fields)}")
        for name, kind in fields.items():
            v = d[tag][name]
            if not isinstance(v, str):
                raise ValueError(f"{tag}.{name} must be a string")
            if kind == "hex":
                try:
                    x = int(v, 16)
                except ValueError:
                    raise ValueError(f"{tag}.{name} is not a hex int") from None
                if x <= 1:
                    raise ValueError(f"{tag}.{name} must be > 1")
                ints[tag, name] = x
            else:
                try:
                    raw = base64.b64decode(v, validate=True)
                except binascii.Error:
                    raise ValueError(f"{tag}.{name} is not base64") from None
                if len(raw) != 32:
                    raise ValueError(f"{tag}.{name} must be 32 bytes, got {len(raw)}")
    for tag in ("PSSE", "MSE"):
        if ints[tag, "n"] != ints[tag, "p"] * ints[tag, "q"]:
            raise ValueError(f"{tag}.n != p * q")
    p1, q1 = ints["MSE", "p"] - 1, ints["MSE", "q"] - 1
    if ints["MSE", "e"] * ints["MSE", "d"] % (p1 // gcd(p1, q1) * q1) != 1:
        raise ValueError("MSE.d is not the inverse of e mod lcm(p - 1, q - 1)")
    return d


def keys_from_reference(blob: str) -> HEKeys:
    """The port's `HEKeys` from a reference `HEKeys.to_json()` blob: the
    same JSON, validated field by field. Raises ValueError on a bad field."""
    _validated_key_json(blob)
    return HEKeys.from_json(blob)


def keys_to_reference(keys: HEKeys) -> str:
    """The JSON a reference `HEKeys.from_json` reads: the port's own
    `to_json()`, validated the same way."""
    blob = keys.to_json()
    _validated_key_json(blob)
    return blob


def _checked_epochs(tenant: str, epochs) -> list[tuple[int, str, float, float | None]]:
    """One tenant's epochs, validated: at least one, newest first with
    strictly falling versions >= 1, the active (first) one with no grace
    deadline and every older one with one, each key family valid JSON."""
    if not isinstance(tenant, str) or not tenant:
        raise ValueError(f"tenant ids must be non-empty strings, got {tenant!r}")
    out = []
    for ep in epochs:
        version, blob, created_at, grace_until = ep
        if not isinstance(version, int) or version < 1:
            raise ValueError(f"{tenant}: epoch versions must be ints >= 1, got {version!r}")
        if out and version >= out[-1][0]:
            raise ValueError(f"{tenant}: epochs must run newest first")
        if (grace_until is None) != (not out):
            raise ValueError(f"{tenant}: only the active (first) epoch has no grace deadline")
        _validated_key_json(blob)
        out.append((version, blob, float(created_at),
                    None if grace_until is None else float(grace_until)))
    if not out:
        raise ValueError(f"{tenant}: a live tenant needs at least one epoch")
    return out


def keyring_from_reference(epochs: dict, shredded=(), **keyring_kwargs) -> TenantKeyring:
    """A port `TenantKeyring` holding a reference keyring's key families:
    `epochs` maps each live tenant to its `(version, HEKeys JSON,
    created_at, grace_until)` epochs, newest first (the form
    `keyring_to_reference` gives); `shredded` names the tenants in the
    terminal shredded state (stamped at the keyring clock's now). The
    rotation count is the active version less one, as `rotate` keeps it.
    `keyring_kwargs` go to `TenantKeyring` (bits, grace, max_tenants,
    clock). Raises ValueError on a bad epoch or a tenant both live and
    shredded."""
    kr = TenantKeyring(**keyring_kwargs)
    shredded = set(shredded)
    if shredded & set(epochs):
        raise ValueError(f"tenants both live and shredded: {sorted(shredded & set(epochs))}")
    for tenant, eps in epochs.items():
        eps = _checked_epochs(tenant, eps)
        kr._domains[tenant] = _TenantDomain(
            epochs=[KeyEpoch(v, HEKeys.from_json(blob), created, grace)
                    for v, blob, created, grace in eps],
            rotations=eps[0][0] - 1,
        )
    for tenant in sorted(shredded):
        kr._domains[tenant] = _TenantDomain(shredded_at=kr._clock())
    return kr


def keyring_to_reference(keyring: TenantKeyring) -> tuple[dict, set]:
    """`(epochs, shredded)` for a reference keyring, the inverse of
    `keyring_from_reference`: each live tenant's epochs as `(version,
    HEKeys JSON, created_at, grace_until)`, newest first, every family
    validated, and the set of shredded tenants."""
    with keyring._lock:
        domains = {t: (list(d.epochs), d.shredded_at) for t, d in keyring._domains.items()}
    epochs, shredded = {}, set()
    for tenant, (eps, shredded_at) in domains.items():
        if shredded_at is not None:
            shredded.add(tenant)
        elif eps:  # a domain whose first generation is still pending has none
            epochs[tenant] = _checked_epochs(tenant, [
                (e.version, keys_to_reference(e.keys), e.created_at, e.grace_until)
                for e in eps])
    return epochs, shredded
