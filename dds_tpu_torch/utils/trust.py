"""Per-node suspicion strike counter with random load balancing.

Copy of `dds_tpu/utils/trust.py`: 3 strikes exclude a node from the
trusted set; `defer_to` picks a random trusted node.
"""

from __future__ import annotations

import random

STRIKE_LIMIT = 3


class NoTrustedNodesError(RuntimeError):
    """Every member is excluded (3-strike): nothing left to coordinate a
    quorum. The REST layer degrades to 503 + Retry-After."""


class TrustedNodesList:
    def __init__(self, nodes: list[str] | None = None, rng: random.Random | None = None):
        self._strikes: dict[str, int] = {n: 0 for n in (nodes or [])}
        self._rng = rng or random.Random()

    def increment_suspicion(self, node: str) -> None:
        """Strike a MEMBER. Unknown names are ignored, so a crafted sender
        can never insert itself into the membership."""
        if node in self._strikes:
            self._strikes[node] += 1

    def suspicions(self) -> dict[str, int]:
        return dict(self._strikes)

    def get_untrusted(self) -> list[str]:
        return [n for n, s in self._strikes.items() if s >= STRIKE_LIMIT]

    def get_trusted(self) -> list[str]:
        return [n for n, s in self._strikes.items() if s < STRIKE_LIMIT]

    def get_all(self) -> list[str]:
        return list(self._strikes)

    def defer_to(self, exclude=(), prefer=()) -> str:
        """Pick a random trusted node, avoiding `exclude` when any other
        trusted node remains; `prefer` narrows the choice when any of its
        nodes qualify."""
        trusted = self.get_trusted()
        if not trusted:
            raise NoTrustedNodesError("no trusted nodes left")
        candidates = [n for n in trusted if n not in exclude]
        preferred = [n for n in candidates if n in prefer]
        return self._rng.choice(preferred or candidates or trusted)
