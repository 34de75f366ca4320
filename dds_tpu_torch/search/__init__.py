"""Spyglass: the encrypted search plane, its indexes on the plane's device."""

from dds_tpu_torch.search.plane import GroupIndex, SearchPlane

__all__ = ["GroupIndex", "SearchPlane"]
