"""Fixed-shape big-integer limb arithmetic, in PyTorch.

Big integers are ``(batch, L)`` arrays of 16-bit limbs, little-endian
(limb 0 is the least significant 16 bits), held in 32-bit words: numpy
``uint32`` on the host, ``torch.int32`` on the device. That layout is kept
at every interface so rows move unchanged between this package and
`dds_tpu` (whose pools and segment files persist it).

The tensor primitives compute in ``int64``: PyTorch on the CPU has no
``>>``, ``+`` or ``>`` for ``uint32``, and int64 holds every intermediate
of the 16-bit-limb algorithms below exactly.
"""

from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1  # 0xFFFF


# ---------------------------------------------------------------------------
# Host-side conversions (python int <-> numpy limb arrays)
# ---------------------------------------------------------------------------

def n_limbs_for_bits(bits: int) -> int:
    """Number of 16-bit limbs needed for `bits`-bit integers."""
    return -(-bits // LIMB_BITS)


def int_to_limbs(x: int, L: int) -> np.ndarray:
    """Python int -> little-endian uint32 array of L 16-bit limbs."""
    if x < 0:
        raise ValueError("negative ints not representable")
    if x >> (LIMB_BITS * L):
        raise ValueError(f"{x.bit_length()}-bit int does not fit {L} limbs")
    b = x.to_bytes(2 * L, "little")
    return np.frombuffer(b, dtype="<u2").astype(np.uint32)


def limbs_to_int(arr) -> int:
    """Little-endian limb array -> python int. Canonical arrays (limbs
    < 2^16) convert through one bytes round-trip; redundant limbs fall
    back to the exact per-limb fold."""
    a = np.asarray(arr).astype(np.uint64)
    if not (a >> LIMB_BITS).any():
        return int.from_bytes(a.astype("<u2").tobytes(), "little")
    out = 0
    for i in range(a.shape[-1] - 1, -1, -1):
        out = (out << LIMB_BITS) + int(a[i])  # + not |: digits may carry
    return out


def ones_batch(B: int, L: int) -> np.ndarray:
    """(B, L) limb batch of the integer 1."""
    out = np.zeros((B, L), np.uint32)
    out[:, 0] = 1
    return out


def ints_to_batch(xs, L: int) -> np.ndarray:
    """List of python ints -> (B, L) uint32 limb batch, through one joined
    bytes buffer. Raises ValueError for negatives and ints wider than L
    limbs."""
    xs = list(xs)
    if not xs:
        return np.zeros((0, L), np.uint32)
    nbytes = 2 * L
    try:
        buf = b"".join(x.to_bytes(nbytes, "little") for x in xs)
    except OverflowError as e:
        raise ValueError(f"operand out of range for {L} limbs: {e}") from None
    return (
        np.frombuffer(buf, dtype="<u2")
        .astype(np.uint32)
        .reshape(len(xs), L)
    )


def batch_to_ints(batch) -> list[int]:
    """(B, L) limb batch -> python ints. A canonical batch converts
    through one bytes buffer; one with redundant limbs row by row
    (`limbs_to_int`)."""
    b = np.asarray(batch)
    if b.size and not (b.astype(np.uint64) >> LIMB_BITS).any():
        buf, step = b.astype("<u2").tobytes(), 2 * b.shape[1]
        return [int.from_bytes(buf[i: i + step], "little") for i in range(0, len(buf), step)]
    return [limbs_to_int(b[i]) for i in range(b.shape[0])]


def to_device(batch: np.ndarray, device) -> torch.Tensor:
    """Host uint32 limb batch -> int32 tensor on `device` (16-bit limbs
    are non-negative, so the int32 view holds the same values)."""
    return torch.from_numpy(np.ascontiguousarray(batch, np.uint32).view(np.int32)).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Canonical limb tensor -> host uint32 array."""
    return t.detach().to("cpu", torch.int64).numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# Tensor primitives (int64, vectorized over the batch axis)
# ---------------------------------------------------------------------------

def normalize(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fully propagate carries -> canonical limbs (< 2^16).

    `t`: (B, K) non-negative limbs below 2^62. Returns (canonical (B, K)
    int64, carry_out (B,) int64). Sequential over the K limb axis,
    vectorized over the batch."""
    t = t.to(torch.int64)
    cols = []
    carry = torch.zeros(t.shape[0], dtype=torch.int64, device=t.device)
    for k in range(t.shape[1]):
        s = t[:, k] + carry
        cols.append(s & LIMB_MASK)
        carry = s >> LIMB_BITS
    return torch.stack(cols, dim=1), carry


def sub(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a - b with borrow propagation (canonical inputs, equal shapes).

    Returns (diff (B, K) canonical, borrow_out (B,) — 1 where a < b, in
    which case diff is the 2^(16K)-complement value)."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    cols = []
    borrow = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    for k in range(a.shape[1]):
        d = a[:, k] - b[:, k] - borrow
        borrow = (d < 0).to(torch.int64)
        cols.append(d + (borrow << LIMB_BITS))
    return torch.stack(cols, dim=1), borrow


def cond_sub(t: torch.Tensor, mod: torch.Tensor) -> torch.Tensor:
    """t - mod where t >= mod else t (canonical t (B, K); mod (K,))."""
    t = t.to(torch.int64)
    diff, borrow = sub(t, mod.to(torch.int64).expand_as(t))
    return torch.where((borrow == 1)[:, None], t, diff)


def geq(a: torch.Tensor, mod: torch.Tensor) -> torch.Tensor:
    """(B,) bool: a >= mod (canonical limbs; mod (K,))."""
    _, borrow = sub(a, mod.to(torch.int64).expand_as(a))
    return borrow == 0
