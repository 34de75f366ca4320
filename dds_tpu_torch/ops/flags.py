"""Environment-flag parsing for the kernel layer.

Copy of `karatsuba_mode` in `dds_tpu/ops/flags.py:10-26`: the port keeps
its own copy rather than importing the reference package.
"""

from __future__ import annotations

import os


def karatsuba_mode() -> str | bool:
    """DDS_KARATSUBA: "" / 0 -> off (the CIOS kernel), 1 / k1 -> the
    composed Karatsuba variant (three half products in one launch, the
    recombination in PyTorch ops), 2 / "fused" -> the one-kernel variant.
    Unknown values raise: a typo silently running another family would
    mislead every number downstream."""
    flag = os.environ.get("DDS_KARATSUBA", "").strip().lower()
    if not flag or flag in ("0", "false", "off", "no"):
        return False
    if flag in ("2", "fused"):
        return "fused"
    if flag in ("1", "true", "on", "yes", "k1"):
        return "k1"
    raise ValueError(
        f"unknown DDS_KARATSUBA value {flag!r} (use 0, 1/k1, or 2/fused)"
    )
