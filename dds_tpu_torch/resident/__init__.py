"""Device-resident ciphertext pools."""

from dds_tpu_torch.resident.pool import ResidentPool

__all__ = ["ResidentPool"]
