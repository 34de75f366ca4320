"""Content-addressed device-resident ciphertext store (compat surface).

Port of `dds_tpu/ops/store.py`: the single-store `DeviceCipherStore` is a
thin alias of `dds_tpu_torch.resident.pool.ResidentPool`, kept under its
name so the backend's `store_for` reads like the reference's.
"""

from __future__ import annotations

from dds_tpu_torch.resident.pool import ResidentPool


class DeviceCipherStore(ResidentPool):
    """Resident (rows, L) int32 limb buffer for one modulus — the
    unsharded (single-pool) alias of `ResidentPool`."""


__all__ = ["DeviceCipherStore"]
