"""Environment-flag parsing for the kernel layer.

Copies of `karatsuba_mode`, `analytics_max_rows` and `secret_device` in
`dds_tpu/ops/flags.py:10-80`: the port keeps its own copies rather than
importing the reference package.
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


def analytics_max_rows(default: int = 256) -> int:
    """Per-request weight-row cap of the Prism analytics routes (MatVec
    rows, GroupBySum groups): DDS_ANALYTICS_MAX_ROWS when set, else
    `default` (the `[analytics] max-rows` value). Whichever wins must be an
    int in [1, 65536], or the proxy fails at construction with an error
    naming its source instead of answering 500 per request. The ceiling
    bounds the kernel work one request can demand: rows x columns x
    exponent-width Montgomery products all scale with it."""
    env = os.environ.get("DDS_ANALYTICS_MAX_ROWS", "").strip()
    source = "DDS_ANALYTICS_MAX_ROWS" if env else "[analytics] max-rows"
    raw = env if env else default
    try:
        rows = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"{source} must be an integer row count, got {raw!r}"
        ) from None
    if not 1 <= rows <= 65536:
        raise ValueError(
            f"{source} must be in [1, 65536] (per-request analytics row "
            f"cap), got {rows}"
        )
    return rows


def secret_device(default: bool = False) -> bool:
    """Sanctum device opt-in: run the secret-material CRT decrypt legs as
    one fused batched dispatch on the card instead of the host-only
    default. DDS_SECRET_DEVICE when set, else `default` (the `[crypto]
    secret-device` config value). Both are validated loudly: an operator
    who believes they opted in (or out) of device residency for key
    material must never be silently wrong about it, so a non-boolean
    config value and an unknown environment value raise."""
    env = os.environ.get("DDS_SECRET_DEVICE", "").strip().lower()
    if not env:
        if not isinstance(default, bool):
            raise ValueError(
                "[crypto] secret-device must be a boolean, got "
                f"{default!r}"
            )
        return default
    if env in ("1", "true", "on", "yes"):
        return True
    if env in ("0", "false", "off", "no"):
        return False
    raise ValueError(
        f"unknown DDS_SECRET_DEVICE value {env!r} (use 1/true/on/yes or "
        "0/false/off/no)"
    )
