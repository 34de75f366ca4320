"""Sanctum: the secret-material execution plane.

Port of `dds_tpu/sanctum`. Everything that computes WITH private-key
material (the CRT legs of Paillier decryption: moduli p^2 and q^2,
exponents p-1 and q-1) runs here, under residency rules the
public-parameter hot path does not have:

- per-KEY plans and constants, stored on the key object itself (the
  `_crt` cached_property pattern), never in `ModCtx.make`'s process-wide
  cache, whose entries outlive every key (`ops.montgomery.cached_moduli`
  lists it);
- host-only by default; the explicit device opt-in (`[crypto]
  secret-device` / DDS_SECRET_DEVICE, `SecretBackend(device=True)`) runs
  both CRT legs as one stacked batch on the per-column-modulus kernels
  (`csrc/mont_rowmod.cu`) with every secret passed as a runtime kernel
  argument;
- `close()` / `PaillierKey.scrub()`, and a `weakref` finalizer that
  zero-fills the host copies when the key object is dropped.

`plane` holds the host side; `device` is imported on the first device
plan (`plan_for`).
"""

from dds_tpu_torch.sanctum.plane import (
    HostCrtPlan,
    SecretBackend,
    is_secret_backend,
    plan_for,
    scrub_key,
)

__all__ = [
    "HostCrtPlan",
    "SecretBackend",
    "is_secret_backend",
    "plan_for",
    "scrub_key",
]
