"""Stratum warm tier: host-pinned numpy limb rows under a byte budget.

Copy of `dds_tpu/storage/warm.py`.

The middle rung of the hierarchy: rows evicted from a ResidentPool's device
buffer land here as plain `(L,)` uint32 numpy arrays — already
limb-converted, so promotion back to the device is a pure H2D transfer and a
streamed warm fold skips the CPU-heavy `ints_to_batch` conversion that
makes cold/direct folds expensive. The cache itself is policy-free: it
tracks bytes and answers membership; the `TierDirectory`'s Zipf/EWMA
scores decide WHICH entries `Stratum` pushes down to the segment store
when the budget is exceeded (`over_budget` + `items` are the hooks).
"""

from __future__ import annotations

import threading

import numpy as np

Stripe = tuple  # (gid, tenant, modulus)


class WarmCache:
    """Byte-budgeted host cache of limb rows keyed (stripe, cipher)."""

    def __init__(self, max_bytes: int = 64 << 20):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._rows: dict[Stripe, dict[int, np.ndarray]] = {}
        self._bytes = 0

    def put(self, stripe: Stripe, cipher: int, row: np.ndarray) -> None:
        row = np.ascontiguousarray(row, dtype=np.uint32)
        with self._lock:
            dest = self._rows.setdefault(stripe, {})
            old = dest.get(cipher)
            if old is not None:
                self._bytes -= old.nbytes
            dest[cipher] = row
            self._bytes += row.nbytes

    def get(self, stripe: Stripe, cipher: int) -> np.ndarray | None:
        with self._lock:
            dest = self._rows.get(stripe)
            return None if dest is None else dest.get(cipher)

    def pop(self, stripe: Stripe, cipher: int) -> np.ndarray | None:
        with self._lock:
            dest = self._rows.get(stripe)
            if dest is None:
                return None
            row = dest.pop(cipher, None)
            if row is not None:
                self._bytes -= row.nbytes
            return row

    def contains(self, stripe: Stripe, cipher: int) -> bool:
        with self._lock:
            dest = self._rows.get(stripe)
            return bool(dest) and cipher in dest

    # ------------------------------------------------------------- pressure

    @property
    def bytes(self) -> int:
        return self._bytes

    def over_budget(self) -> int:
        """Bytes above the budget (0 when within) — the demotion trigger."""
        with self._lock:
            return max(0, self._bytes - self.max_bytes)

    def items(self) -> list[tuple[Stripe, int, int]]:
        """(stripe, cipher, nbytes) of every cached row — the victim-
        selection sweep (Stratum scores these against the directory)."""
        with self._lock:
            return [
                (stripe, c, row.nbytes)
                for stripe, dest in self._rows.items()
                for c, row in dest.items()
            ]

    def stats(self) -> dict:
        with self._lock:
            return {
                "rows": sum(len(d) for d in self._rows.values()),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
            }
