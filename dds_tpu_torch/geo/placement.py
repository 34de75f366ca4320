"""Region-aware placement helpers (copy of `dds_tpu/geo/placement.py`).

- `spread`: one GROUP's replicas distributed round-robin across the
  region list, the span-group shape read-local leases need (every region
  holds a replica of every span group);
- `group_regions`: whole groups homed per region round-robin, the shape
  Helmsman's region-aware promotion reasons about;
- `prefer`: the standby-acquisition order, a region's natives first.

All are deterministic in input order, so a seeded fleet places the same
way every run and in both packages.
"""

from __future__ import annotations


def spread(endpoints: list, regions: list[str]) -> dict[str, str]:
    """endpoint -> region, round-robin in endpoint order."""
    if not regions:
        return {}
    return {e: regions[i % len(regions)] for i, e in enumerate(endpoints)}


def group_regions(gids: list, regions: list[str]) -> dict[str, str]:
    """gid -> home region, round-robin in gid order."""
    if not regions:
        return {}
    return {g: regions[i % len(regions)] for i, g in enumerate(gids)}


def prefer(candidates: list, region_of: dict, region: str) -> list:
    """Candidates reordered: `region` natives first, then the rest, input
    order kept within each half."""
    if not region:
        return list(candidates)
    native = [c for c in candidates if region_of.get(c, "") == region]
    other = [c for c in candidates if region_of.get(c, "") != region]
    return native + other
