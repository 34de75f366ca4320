"""Workload distributions: typed column values, rows and key popularity.

Copy of `dds_tpu/clt/distribution.py` (the reference shares it with its
open-loop load plane, which is not ported). This module owns:

- the typed column-value generators (`generate_column_data`, the
  canonical table at `DDSDataGenerator.scala:271-282`);
- whole-row synthesis (`random_row`: fixed typed prefix + random-length
  plaintext tail, `DDSDataGenerator.scala`'s row shape);
- `ZipfKeys`, the skewed key-popularity distribution (a handful of hot
  keys take most of the traffic, the long tail keeps the cache honest).

Every `rng` call is in the reference's order, so one seed draws the same
values in both packages.
"""

from __future__ import annotations

import bisect
import random
import string

# column type vocabulary, as in DDSDataGenerator.ALLOWED_DATA_TYPES
ALLOWED_DATA_TYPES = (
    "String", "Char", "Int", "Long", "Float", "Double", "Boolean", "Blob"
)


def generate_column_data(ctype: str, rng: random.Random):
    """Random typed value for one column (`DDSDataGenerator.scala:271-282`)."""
    match ctype:
        case "Int":
            return rng.randrange(0, 1 << 16)
        case "Long":
            return rng.randrange(0, 1 << 31)
        case "Float" | "Double":
            # encrypted columns carry ints; floats only appear in the tail
            return round(rng.uniform(0, 1e6), 3)
        case "Char":
            return rng.choice(string.ascii_letters)
        case "Boolean":
            return rng.choice([True, False])
        case "Blob":
            return "".join(rng.choices(string.ascii_letters + string.digits, k=32))
        case _:
            return " ".join(
                "".join(rng.choices(string.ascii_lowercase, k=rng.randrange(3, 9)))
                for _ in range(rng.randrange(1, 4))
            )


def random_row(mappings: list[str], max_nr_of_columns: int,
               rng: random.Random) -> list:
    """One record: every fixed column typed per `mappings`, then a
    random-length tail of randomly-typed values up to
    `max_nr_of_columns` total — the generator's row shape, reused
    verbatim by the load plane's seed phase."""
    fixed = len(mappings)
    row = [generate_column_data(mappings[i], rng) for i in range(fixed)]
    for _ in range(rng.randrange(0, max(1, max_nr_of_columns - fixed + 1))):
        row.append(generate_column_data(rng.choice(ALLOWED_DATA_TYPES), rng))
    return row


class ZipfKeys:
    """Zipf(s) popularity over a fixed key list: P(rank r) ∝ 1/r^s.
    Rank-1 is the hottest key; s=0 degenerates to uniform. Sampling is
    O(log K) via an inverse-CDF bisect over the precomputed harmonic
    prefix sums, so a million-arrival sweep spends its time on I/O, not
    on the distribution."""

    def __init__(self, keys: list[str], s: float = 1.1,
                 rng: random.Random | None = None):
        if not keys:
            raise ValueError("ZipfKeys needs at least one key")
        self.keys = list(keys)
        self.s = float(s)
        self.rng = rng or random.Random()
        acc, cdf = 0.0, []
        for r in range(1, len(self.keys) + 1):
            acc += 1.0 / (r ** self.s)
            cdf.append(acc)
        self._cdf = [c / acc for c in cdf]

    def pick(self) -> str:
        u = self.rng.random()
        return self.keys[bisect.bisect_left(self._cdf, u)]

    def weight(self, rank: int) -> float:
        """P(rank) for tests/reporting (1-indexed)."""
        lo = self._cdf[rank - 2] if rank >= 2 else 0.0
        return self._cdf[rank - 1] - lo
