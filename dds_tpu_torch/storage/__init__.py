"""Stratum: tiered ciphertext storage — device -> host -> segment log.

Three explicit tiers per (shard group, tenant, modulus) stripe:

- hot: the resident plane's `ResidentPool` device buffer
  (resident/pool.py),
- warm: `WarmCache` host numpy limb rows under a byte budget,
- cold: `SegmentStore`, an append-only log of HMAC'd segment files with
  keep-N manifest rotation (snapshot v2's crash-safety discipline).

`Stratum` orchestrates: a `TierDirectory` drives Zipf-aware (decayed
touch count) promotion/eviction, pool overflow demotes instead of
resetting, and `fold_groups` splits every aggregate into a resident-
fused leg plus streamed-from-tier legs merged bit-for-bit exactly.
"""

from dds_tpu_torch.storage.directory import COLD, HOT, TIERS, WARM, TierDirectory
from dds_tpu_torch.storage.segment import SegmentStore, derive_segment_secret
from dds_tpu_torch.storage.stratum import Stratum
from dds_tpu_torch.storage.warm import WarmCache

__all__ = [
    "Stratum", "SegmentStore", "WarmCache", "TierDirectory",
    "derive_segment_secret", "TIERS", "HOT", "WARM", "COLD",
]
