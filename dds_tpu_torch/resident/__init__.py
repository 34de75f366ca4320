"""The resident plane: per-group content-addressed limb pools pinned in
device memory (`ResidentPool`), write-path ingest, and the fused
multi-group fold (`ResidentPlane.fold_groups`)."""

from dds_tpu_torch.resident.plane import ResidentPlane
from dds_tpu_torch.resident.pool import ResidentPool

__all__ = ["ResidentPlane", "ResidentPool"]
