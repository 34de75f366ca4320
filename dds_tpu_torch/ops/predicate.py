"""Spyglass predicate ops: batched predicate evaluation on the plane's device.

Port of `dds_tpu/ops/predicate.py`. The `Search*`/`Order*`/`Range` routes
are selection problems: given every stored record's column ciphertext,
produce a selection mask (or a sort permutation) in one batch of device
ops instead of a host Python loop over N records. The search plane
(`search/`) keeps the packed columns on its device and calls down here.

Operand encodings. The reference keeps every lane in uint32 (x64-off
JAX); here the lanes are int64 tensors, because torch on the CPU has no
`>`, `+` or `>>` for uint32. Their values are the reference's:

- OPE ciphertexts (`models/ope`: `enc(x) = (x + 2^31) * 2^20 + prf`,
  at most 52 bits, strictly order-preserving) split into two 26-bit lanes
  ``hi = c >> 26, lo = c & (2^26 - 1)``; the lexicographic (hi, lo)
  compare IS the integer compare. The sort folds the lanes back into one
  int64 key ``hi << 26 | lo`` (exact on [0, 2^52)) and runs one stable
  `torch.sort`. Descending order complements the lanes first
  (``PACK_MAX - key``, an order-reversing bijection), so ties keep the
  ascending row order, exactly like Python's stable
  `sorted(..., reverse=True)`; `torch.sort(descending=True)` is never
  relied on for ties.
- DET/CHE and element equality operands are blake2b-64 digests of the
  ciphertext STRING, split into two 32-bit lanes. Digest equality is a
  candidate filter only: 64-bit collisions are possible, so callers
  confirm candidates against the exact strings on the host (the search
  plane does, through `DetKey.compare`), which keeps results identical to
  the legacy scan's.

Every op takes the device it runs on, moves its lanes there (a no-op for
a pack already on it) and dispatches through
`kprof.profiled("predicate", ..., op=..., n=...)`, so the
`kernel.predicate.{dispatch,execute}` spans keep the reference's names.
It returns a tensor on that device. The reference's `_FN_CACHE` of jitted
functions and its `kprof.cache_event` accounting have no counterpart in
eager PyTorch and are left out.
"""

from __future__ import annotations

import hashlib

import torch

from dds_tpu_torch.obs import kprof

# 52-bit OPE ciphertexts split into two 26-bit lanes (see module docstring)
LANE_BITS = 26
LANE_MASK = (1 << LANE_BITS) - 1
# largest integer the two-lane packing can represent; values outside
# [0, PACK_MAX] (foreign plaintext ints, negative thresholds) make the
# caller take its host evaluation path
PACK_MAX = (1 << (2 * LANE_BITS)) - 1

_CMP_OPS = ("gt", "ge", "lt", "le")


def packable(v: int) -> bool:
    return 0 <= v <= PACK_MAX


def pack_ints(values, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int64 lane tensors on `device` for a column of packable
    ints."""
    v = torch.tensor(list(values), dtype=torch.int64)
    return (v >> LANE_BITS).to(device), (v & LANE_MASK).to(device)


def digest_lanes(s: str) -> tuple[int, int]:
    """blake2b-64 of a ciphertext string as two 32-bit lanes."""
    d = hashlib.blake2b(s.encode(), digest_size=8).digest()
    return int.from_bytes(d[:4], "big"), int.from_bytes(d[4:], "big")


def pack_digests(values, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int64 digest-lane tensors on `device` for a column of
    strings."""
    pairs = torch.tensor([digest_lanes(s) for s in values],
                         dtype=torch.int64).reshape(-1, 2)
    return pairs[:, 0].to(device), pairs[:, 1].to(device)


def _lanes(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def _lex_gt(hi, lo, thi, tlo):
    return (hi > thi) | ((hi == thi) & (lo > tlo))


def _lex_ge(hi, lo, thi, tlo):
    return (hi > thi) | ((hi == thi) & (lo >= tlo))


def compare_mask(hi, lo, op: str, threshold: int, *, device) -> torch.Tensor:
    """Boolean mask of rows whose packed value satisfies `op threshold`.

    op in {"gt", "ge", "lt", "le"}; threshold must be packable (the
    caller clamps or takes its host path otherwise).
    """
    if op not in _CMP_OPS:
        raise ValueError(f"unknown compare op {op!r}")
    thi, tlo = threshold >> LANE_BITS, threshold & LANE_MASK

    def run():
        h, l = _lanes(hi, device), _lanes(lo, device)
        if op == "gt":
            return _lex_gt(h, l, thi, tlo)
        if op == "ge":
            return _lex_ge(h, l, thi, tlo)
        if op == "lt":
            return ~_lex_ge(h, l, thi, tlo)
        return ~_lex_gt(h, l, thi, tlo)

    return kprof.profiled("predicate", run, op=op, n=len(hi))


def range_mask(hi, lo, lo_bound: int, hi_bound: int, *, device) -> torch.Tensor:
    """Boolean mask of rows with lo_bound <= value <= hi_bound (both
    bounds packable)."""

    def run():
        h, l = _lanes(hi, device), _lanes(lo, device)
        return (_lex_ge(h, l, lo_bound >> LANE_BITS, lo_bound & LANE_MASK)
                & ~_lex_gt(h, l, hi_bound >> LANE_BITS, hi_bound & LANE_MASK))

    return kprof.profiled("predicate", run, op="range", n=len(hi))


def eq_mask(dhi, dlo, query: str, *, device) -> torch.Tensor:
    """Candidate mask of rows whose digest lanes equal the query's.
    Collisions are possible — confirm candidates on the host."""
    qhi, qlo = digest_lanes(query)

    def run():
        return (_lanes(dhi, device) == qhi) & (_lanes(dlo, device) == qlo)

    return kprof.profiled("predicate", run, op="eq", n=len(dhi))


def entry_mask(dhi, dlo, valid, queries: list[str], mode: str, *,
               device) -> torch.Tensor:
    """Candidate mask over an (N, C) element-digest matrix.

    mode "any": rows where ANY valid element matches ANY query
    (SearchEntry with one query, SearchEntryOR with three).
    mode "all": rows where EVERY query matches some valid element
    (SearchEntryAND). Candidates only — confirm on the host.
    """
    q = [digest_lanes(s) for s in queries]

    def run():
        h, l = _lanes(dhi, device), _lanes(dlo, device)
        v = torch.as_tensor(valid, dtype=torch.bool, device=device)
        # per query, element-vs-query digest equality masked to real
        # (non-padding) elements, reduced over the row: the reference's
        # (N, C, Q) broadcast one query at a time, with the query lanes as
        # scalars, so no host-to-device copy waits on the stream
        cols = [((h == qh) & (l == ql) & v).any(dim=1) for qh, ql in q]
        per_query = (torch.stack(cols, dim=1) if cols else
                     torch.zeros((h.shape[0], 0), dtype=torch.bool, device=device))
        if mode == "all":
            return per_query.all(dim=1)
        return per_query.any(dim=1)

    return kprof.profiled("predicate", run, op=f"entry_{mode}", n=len(dhi))


def sort_perm(hi, lo, descending: bool, *, device) -> torch.Tensor:
    """Stable sort permutation over the packed column: row indices in
    ascending (or descending) value order, ties keeping row order — the
    device twin of Python's stable `sorted` by value."""

    def run():
        key = (_lanes(hi, device) << LANE_BITS) | _lanes(lo, device)
        if descending:
            # complementing both 26-bit lanes reverses the order while the
            # stable sort keeps ties in ascending row order — exactly
            # sorted(reverse=True)
            key = PACK_MAX - key
        return torch.sort(key, stable=True).indices

    return kprof.profiled("predicate", run,
                          op="sort_desc" if descending else "sort_asc", n=len(hi))
