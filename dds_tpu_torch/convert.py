"""Carry state across from `dds_tpu`: Montgomery constants and resident rows.

In this system what plays the role of weights is the per-modulus
Montgomery constants and the device-resident ciphertext rows. Both cross
as plain numpy arrays in the shared layout — (count, L) uint32 of 16-bit
little-endian limbs, the layout `dds_tpu`'s pools hold and its Stratum
segment files persist — so nothing here imports the reference.
"""

from __future__ import annotations

import numpy as np

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
