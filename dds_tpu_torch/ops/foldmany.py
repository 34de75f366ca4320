"""Segmented (multi-request) modular-product folds in one device pass.

Port of `fold_many` in `dds_tpu/ops/foldmany.py:241-274`. A proxy serving
concurrent small aggregates (each below the backend's `min_device_batch`,
where a lone device fold loses to a host fold) coalesces them: R requests'
folds become one elem-major batch that tree-reduces in one halving tree of
`mont_cuda.mul` launches, so the launch latency is paid once for all R
(BASELINE.md config 5, the small-aggregate regime).

Layout: limbs-major (L, P2 * Rp) with column elem * Rp + req (the
reference's elem-major (P2 * R, L) rows, transposed), so a level's halving
`x[:, :h*Rp] * x[:, h*Rp:2h*Rp]` multiplies elem i with elem i + h within
every request at once. Each request pads to the shared power-of-two width
P2 with the Montgomery identity R mod n, the request axis pads to a power
of two Rp with dummy folds of one identity row, and each request's
accumulated R^-(K_r - 1) is fixed by one final multiply by R^K_r mod n
(dummies: R). The product family is read once per call and passed to
every level, as `mont_cuda.reduce_mul` does. All requests share one
modulus: the proxy's coalescer groups by modulus.

The reference's `fold_weighted` (Prism's plaintext-ciphertext matrix
product) is not ported here: it comes with the Prism analytics plane.
"""

from __future__ import annotations

import numpy as np
import torch

from dds_tpu_torch.obs import kprof
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import flags, mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx


def fold_many(folds: list[list[int]], modulus: int, device="cuda") -> list[int]:
    """Modular product of each request's operand list (non-negative ints,
    at least one each), in one halving tree on `device`; the
    kernels on a CUDA device, their plain versions on the CPU. Runs under
    the `kernel.foldmany.{dispatch|compile,execute}` spans."""
    if not folds or any(len(f) == 0 for f in folds):
        raise ValueError("fold_many needs at least one fold, each with >= 1 operand")
    ctx = ModCtx.make(modulus)
    device = torch.device(device)
    R_real = len(folds)
    Rp = 1 << max(0, (R_real - 1).bit_length())
    Kmax = max(len(f) for f in folds)
    P2 = 1 << max(0, (Kmax - 1).bit_length())
    mode = flags.karatsuba_mode()

    arr = np.empty((P2, Rp, ctx.L), np.uint32)
    arr[:] = ctx.one_mont  # identity pads (elem pads + dummy requests)
    for r, f in enumerate(folds):
        arr[: len(f), r, :] = bn.ints_to_batch([c % modulus for c in f], ctx.L)
    sizes = [len(f) for f in folds] + [1] * (Rp - R_real)

    def run() -> torch.Tensor:
        x = bn.to_device(arr.reshape(P2 * Rp, ctx.L), device).T.contiguous()
        fixes = torch.cat([ctx.fold_fix(k, device) for k in sizes], dim=1)
        w = P2
        while w > 1:
            h = w // 2
            x = mont_cuda.mul(ctx, x[:, : h * Rp], x[:, h * Rp: 2 * h * Rp], mode)
            w = h
        return mont_cuda.mul(ctx, x, fixes, mode)          # (L, Rp) plain domain

    out = kprof.profiled("foldmany", run, R=R_real, P2=P2)
    return bn.batch_to_ints(bn.to_host(out.T)[:R_real])
