"""Segmented (multi-request) modular-product folds and weighted folds.

Port of `fold_many` and `fold_weighted` in `dds_tpu/ops/foldmany.py`. A proxy serving
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

`fold_weighted` (the reference's `:167-238` and its jit body
`_fold_weighted_fn`, `:105-162`) is the plaintext-matrix x
ciphertext-vector product of the Prism analytics plane, composed from the
same `mont_cuda.mul` launches with one `index_select` gather a digit.
"""

from __future__ import annotations

import numpy as np
import torch

from dds_tpu_torch.obs import kprof
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import flags, mont_cuda
from dds_tpu_torch.ops.montgomery import DIGIT_MASK, WINDOW, ModCtx


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


def _table_columns(weights: list[list[int]], P2: int, Rp: int) -> np.ndarray:
    """The weighted fold's gather index: (D, P2 * Rp) int32, D = max(1,
    ceil(E / 4)) for the longest weight's bit length E. Row j is digit j,
    most significant first, of every (row r, operand k) weight, stored in
    column k * Rp + r as the table column d * P2 + k of its digit d (the
    table holds operand k's power d there). Pad operands and pad rows take
    digit 0, the table's identity. The digits are the nibbles of each
    weight's little-endian bytes, so the cost is one `to_bytes` a weight,
    not one Python step a digit."""
    E = max(w.bit_length() for row in weights for w in row)
    D = max(1, -(-E // WINDOW))
    nbytes = -(-D // 2)
    R, K = len(weights), len(weights[0])
    raw = np.frombuffer(b"".join(w.to_bytes(nbytes, "little") for row in weights for w in row),
                        np.uint8).reshape(R, K, nbytes)
    nib = np.empty((R, K, 2 * nbytes), np.uint8)  # nib[r, k, d] = (w >> 4d) & 0xF
    nib[..., 0::2] = raw & DIGIT_MASK
    nib[..., 1::2] = raw >> WINDOW
    digits = np.zeros((D, P2, Rp), np.int32)
    digits[:, :K, :R] = nib[..., D - 1::-1].transpose(2, 1, 0)  # MSB first
    digits *= P2
    digits += np.arange(P2, dtype=np.int32)[None, :, None]
    return digits.reshape(D, P2 * Rp)


def fold_weighted(cs: list[int], weights: list[list[int]], modulus: int,
                  device="cuda", rows=None) -> list[int]:
    """Per-row weighted modular products in one composed device pass:

        out[r] = prod_k cs[k] ** weights[r][k]  mod modulus

    Prism's PC-MM product: with modulus = n^2 and negative weights encoded
    as n - |w| by the caller (`models/paillier.matvec_encode`), row r is
    Enc(W_r . x). Weights must be ints in [0, modulus); every row spans
    len(cs) operands.

    A shared 4-bit-window ladder over the longest weight's digits, all in
    the Montgomery domain (entry by a multiply with R^2, exit by one with
    plain 1), on limbs-major (L, columns) int32:
    1. cs_m = cs * R^2, then a 16-entry table [R mod n, cs_m, cs_m^2, ...]
       of (L, P2) blocks (14 more multiplies), concatenated as (L, 16 P2);
    2. per digit: 4 squarings of the (L, Rp) accumulator; one
       `index_select` of every (row, operand) cell's table entry into one
       (L, P2 * Rp) buffer, allocated once a call, with cell (r, k) in
       column k * Rp + r (the layout of `fold_many`); a halving tree over
       the operand axis, one `mont_cuda.mul` on two column halves a level;
       one multiply into the accumulator;
    3. one multiply by plain 1.
    That is 1 + 14 + D (4 + log2 P2 + 1) + 1 `mul` calls, every one in the
    product family read once a call. Operands pad to P2 = 2^ceil(log2 K)
    with plain 1 (the reference multiplies every operand by R^2 on entry)
    and rows to Rp = 2^ceil(log2 R) with all-zero weight vectors: both
    gather the identity entry, so padding never perturbs a result.

    `rows` optionally gives the operands as a (K, L) int32 plain-domain
    tensor already on the device (`ResidentPlane.rows_for`): the host
    marshaling of `cs` is skipped and only the pads are built. `cs` is
    still required for the operand count. Runs the kernels on a CUDA
    device and their plain versions on the CPU, under the
    `kernel.fold_weighted.{dispatch|compile,execute}` spans."""
    ctx = ModCtx.make(modulus)
    device = torch.device(device)
    K, R_real = len(cs), len(weights)
    if K == 0 or R_real == 0:
        raise ValueError("fold_weighted needs >= 1 operand and >= 1 row")
    for row in weights:
        if len(row) != K:
            raise ValueError(f"weight row spans {len(row)} operands, expected {K}")
        for w in row:
            if w < 0 or w >= modulus:
                raise ValueError(
                    "weights must be encoded to [0, modulus) before the "
                    "kernel (negative weights: models/paillier.matvec_encode)"
                )
    L = ctx.L
    P2 = 1 << max(0, (K - 1).bit_length())
    Rp = 1 << max(0, (R_real - 1).bit_length())
    columns = _table_columns(weights, P2, Rp)
    D = columns.shape[0]
    host = None
    if rows is None or tuple(rows.shape) != (K, L):
        host = bn.ints_to_batch([c % modulus for c in cs] + [1] * (P2 - K), L)
    mode = flags.karatsuba_mode()

    def run() -> torch.Tensor:
        if host is not None:
            x = bn.to_device(host, device).T.contiguous()
        else:
            x = torch.zeros((L, P2), dtype=torch.int32, device=device)
            x[:, :K] = rows.to(device).T
            x[0, K:] = 1
        return weighted_ladder(ctx, x, torch.from_numpy(columns).to(device), Rp,
                               lambda a, b: mont_cuda.mul(ctx, a, b, mode))

    out = kprof.profiled("fold_weighted", run, R=R_real, K=K, D=D)
    return bn.batch_to_ints(bn.to_host(out.T)[:R_real])


def weighted_ladder(ctx: ModCtx, x: torch.Tensor, columns: torch.Tensor, Rp: int,
                    mul) -> torch.Tensor:
    """The device half of `fold_weighted`: `x` the (L, P2) int32
    plain-domain operands, `columns` the (D, P2 * Rp) int32 gather index
    (`_table_columns`) on x's device, `mul(a, b)` the Montgomery product
    of two (L, B) blocks. Returns the (L, Rp) plain-domain row products,
    enqueued, not waited for: nothing here copies from the host, so
    nothing waits for the stream."""
    L, P2 = x.shape
    device = x.device
    consts = ctx.consts(device)
    r2 = consts["R2"][:, None].expand(L, P2).contiguous()
    one_mont = consts["one_mont"][:, None]
    cs_m = mul(x, r2)
    tab = [one_mont.expand(L, P2), cs_m]
    for _ in range(2, 1 << WINDOW):
        tab.append(mul(tab[-1], cs_m))
    table = torch.cat(tab, dim=1)  # operand k's power d in column d * P2 + k
    del tab
    sel = torch.empty((L, P2 * Rp), dtype=torch.int32, device=device)
    acc = one_mont.expand(L, Rp).contiguous()
    for digit in columns:
        for _ in range(WINDOW):
            acc = mul(acc, acc)
        x = torch.index_select(table, 1, digit, out=sel)
        w = P2
        while w > 1:
            h = w // 2
            x = mul(x[:, : h * Rp], x[:, h * Rp: 2 * h * Rp])
            w = h
        acc = mul(acc, x)
    one = torch.zeros((L, Rp), dtype=torch.int32, device=device)
    one[0] = 1
    return mul(acc, one)


def fold_weighted_launches(K: int, D: int) -> int:
    """`mul` calls of one weighted fold over K operands with D digits
    (each one mont_mul launch, or a product and `redc` in a Karatsuba
    mode): the entry, the table, D x (4 squarings + log2 P2 levels + 1),
    the exit."""
    return 1 + ((1 << WINDOW) - 2) + D * (WINDOW + max(0, (K - 1).bit_length()) + 1) + 1
