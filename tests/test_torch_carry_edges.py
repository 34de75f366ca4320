"""Carry-edge inputs for the warp-per-product Montgomery kernels, on the CPU.

Three parts:

1. A lane-level model of `dds_tpu_torch/csrc/mont_warp.cuh::mont_mul_warp`:
   a line-for-line Python transliteration of the warp schedule with the 32
   lanes as lists, shuffles as index maps and ballots as bit masks. It is
   held against Python ints at WPL = 1, 2, 4 and 8 words per lane, with
   and without the finalize, on moduli made of long runs of 0xFFFFFFFF
   words and on the operands 0, 1, n - 1, R mod n and all-ones words
   (`montgomery.carry_edge_moduli` / `carry_edge_operands`): the inputs
   that push a pending carry or a borrow through every lane.
2. The port's plain path (`mont_cuda.mul`, `mul_nofinal`, `exp` on CPU
   tensors) on the same inputs: at L = 33 and 64 against
   `pallas_mont.mul_lm`, `mont_mxu.mul2_lm` and `pallas_mont.exp_lm` in
   interpret mode (as tests/test_torch_montgomery.py runs them), at L = 256
   and 512 against Python ints. At odd L the port's R is one limb wider
   than the reference's, so the reference's Montgomery-domain outputs are
   carried over by R_ref / R before the comparison; at even L they agree
   limb for limb.
3. `KernelLib.library_path` keys a build on every header beside the
   source, so an edited `mont_warp.cuh` never loads a stale library.

Exact integer arithmetic: tolerance zero. The same inputs run on the card
in tests/test_torch_gpu.py and in chip_smoke.py's parity phases.
"""

import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dds_tpu.ops import mont_mxu, pallas_mont
from dds_tpu.ops.montgomery import ModCtx as RefCtx
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.montgomery import (
    ModCtx,
    _exp_to_digits,
    carry_edge_moduli,
    carry_edge_operands,
)

M32 = (1 << 32) - 1
LANES = 32


# -- 1. the lane-level model --------------------------------------------------


def words_per_lane(W: int) -> int:
    """`dds::words_per_lane`."""
    return 1 if W <= 32 else 2 if W <= 64 else 4 if W <= 128 else 8


def _lanes(x: int, WPL: int) -> list[list[int]]:
    """Lane l holds words [WPL*l, WPL*l + WPL) of x (zeros above)."""
    return [[(x >> (32 * (WPL * lane + k))) & M32 for k in range(WPL)]
            for lane in range(LANES)]


def _value(t: list[list[int]], WPL: int) -> int:
    return sum(w << (32 * (WPL * lane + k))
               for lane in range(LANES) for k, w in enumerate(t[lane]))


def _lookahead(generate: list[bool], propagate: list[bool]) -> tuple[list[int], int]:
    """`dds::lookahead`: ballots as bit masks; (carry-in bit of each lane,
    carry out of lane 31)."""
    G = sum(1 << lane for lane in range(LANES) if generate[lane])
    P = sum(1 << lane for lane in range(LANES) if propagate[lane])
    assert G & P == 0, "generate and propagate must be disjoint"
    s = (G | P) + G
    cin = (s & M32) ^ P
    return [(cin >> lane) & 1 for lane in range(LANES)], s >> 32


def warp_mont_mul(a: int, b: int, n: int, W: int, finalize: bool = True) -> int:
    """The warp schedule of `mont_mul_warp` for a, b < n < 2^(32W): the
    32 * WPL words the lanes hold at the end."""
    WPL = words_per_lane(W)
    n0inv = (-pow(n, -1, 1 << 32)) % (1 << 32)
    A, B, N = _lanes(a, WPL), _lanes(b, WPL), _lanes(n, WPL)
    t = [[0] * WPL for _ in range(LANES)]
    p = [0] * LANES
    for src in range(-(-W // WPL)):
        for k in range(WPL):
            if src * WPL + k >= W:
                continue
            ai = A[src][k]                                      # __shfl_sync
            c1 = [0] * LANES
            for lane in range(LANES):
                c = 0
                for j in range(WPL):
                    s = ai * B[lane][j] + t[lane][j] + c
                    t[lane][j], c = s & M32, s >> 32
                c1[lane] = c
            m = (t[0][0] * n0inv) & M32                         # lane 0, broadcast
            c2 = [0] * LANES
            for lane in range(LANES):
                c = 0
                for j in range(WPL):
                    s = m * N[lane][j] + t[lane][j] + c
                    t[lane][j], c = s & M32, s >> 32
                c2[lane] = c
            assert t[0][0] == 0
            up = [t[lane + 1][0] if lane < LANES - 1 else 0     # __shfl_down_sync
                  for lane in range(LANES)]
            for lane in range(LANES):
                t[lane] = t[lane][1:] + [0]
                s = up[lane] + p[lane] + c1[lane] + c2[lane]
                t[lane][WPL - 1], p[lane] = s & M32, s >> 32
                assert p[lane] <= 2
    # resolve the pending carries once
    q = [0] + p[:-1]                                            # __shfl_up_sync
    top = p[LANES - 1]
    gen, ones = [False] * LANES, [True] * LANES
    for lane in range(LANES):
        c = q[lane]
        for j in range(WPL):
            s = t[lane][j] + c
            t[lane][j], c = s & M32, s >> 32
            ones[lane] = ones[lane] and t[lane][j] == M32
        gen[lane] = c != 0
    cin, carry_out = _lookahead(gen, ones)
    ovf = top + carry_out
    assert ovf in (0, 1)
    for lane in range(LANES):
        c = cin[lane]
        for j in range(WPL):
            s = t[lane][j] + c
            t[lane][j], c = s & M32, s >> 32
    if finalize:
        bgen, eq = [False] * LANES, [True] * LANES
        for lane in range(LANES):
            bw = 0
            for j in range(WPL):
                d = t[lane][j] - N[lane][j] - bw
                bw = 1 if d < 0 else 0
                eq[lane] = eq[lane] and t[lane][j] == N[lane][j]
            bgen[lane] = bw != 0
        bin_, borrow_out = _lookahead(bgen, eq)
        if ovf != 0 or borrow_out == 0:
            for lane in range(LANES):
                bw = bin_[lane]
                for j in range(WPL):
                    d = t[lane][j] - N[lane][j] - bw
                    t[lane][j], bw = d & M32, 1 if d < 0 else 0
    return _value(t, WPL)


def _cios_t(a: int, b: int, n: int, R: int) -> int:
    """The loop's pre-finalize t = (a*b + m*n) / R, m the unique m < R."""
    m = (-a * b * pow(n, -1, R)) % R
    return (a * b + m * n) // R


@pytest.mark.parametrize("finalize", [True, False], ids=["final", "nofinal"])
@pytest.mark.parametrize("L", [33, 64, 66, 128, 256, 512])
def test_lane_model_matches_python_ints(L, finalize):
    """L = 33, 64, 66, 128, 256, 512 -> W = 17, 32, 33, 64, 128, 256, so
    WPL = 1, 1, 2, 2, 4, 8: lanes with padding above W and lanes filled to
    the top, where the overflow word is lane 31's pending carry."""
    W = (L + 1) // 2
    moduli = carry_edge_moduli(L)
    for n in moduli[:2] if W > 64 else moduli:  # the model is slow in Python
        ctx = ModCtx.make(n)
        assert ctx.L == L and ctx.W == W
        R = ctx.R
        Rinv = pow(R, -1, n)
        ops = carry_edge_operands(ctx)
        for a, b in ((x, y) for x in ops for y in ops):
            got = warp_mont_mul(a, b, n, W, finalize)
            t = _cios_t(a, b, n, R)
            assert t < 2 * n
            if finalize:
                assert got == a * b * Rinv % n, (hex(n), hex(a), hex(b))
            else:
                assert got == t % (1 << (32 * LANES * words_per_lane(W))), (hex(a), hex(b))


def test_lane_model_on_random_residues_at_every_width():
    rng = random.Random(2026)
    for L in (33, 64, 66, 128, 256, 512):
        W = (L + 1) // 2
        n = rng.getrandbits(16 * L) | (1 << (16 * L - 1)) | 1
        R = 1 << (32 * W)
        for _ in range(2):
            a, b = rng.randrange(n), rng.randrange(n)
            assert warp_mont_mul(a, b, n, W) == a * b * pow(R, -1, n) % n


# -- 2. the port's plain path on the carry edges -----------------------------


def _lm(vals: list[int], L: int) -> torch.Tensor:
    """Limbs-major (L, B) int32 CPU tensor of the ints."""
    return bn.to_device(bn.ints_to_batch(vals, L), "cpu").T.contiguous()


def _ints(x_lm) -> list[int]:
    return bn.batch_to_ints(np.asarray(x_lm).T)


def _pairs(ctx: ModCtx) -> tuple[list[int], list[int]]:
    ops = carry_edge_operands(ctx)
    return [x for x in ops for _ in ops], [y for _ in ops for y in ops]


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("L", [33, 64])
def test_mul_on_carry_edges_matches_the_reference_kernels(L, which):
    n = carry_edge_moduli(L)[which]
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    assert ctx.L == ref.L == L
    a, b = _pairs(ctx)
    got = mont_cuda.mul(ctx, _lm(a, L), _lm(b, L))
    nofinal = mont_cuda.mul_nofinal(ctx, _lm(a, L), _lm(b, L))
    A, B = jnp.asarray(bn.ints_to_batch(a, L)).T, jnp.asarray(bn.ints_to_batch(b, L)).T
    v1 = np.asarray(pallas_mont.mul_lm(ref, A, B, interpret=True))
    v2 = np.asarray(mont_mxu.mul2_lm(mont_mxu.MxuCtx.make(ref), A, B, interpret=True))
    R_ref = 1 << (16 * L)
    Rinv = pow(ctx.R, -1, n)
    assert _ints(got) == [x * y * Rinv % n for x, y in zip(a, b)]
    for other in (v1, v2):
        # the reference's a*b/R_ref, carried to the port's R (equal at even L)
        assert [v * R_ref * Rinv % n for v in _ints(other)] == _ints(got)
        if L % 2 == 0:
            np.testing.assert_array_equal(bn.to_host(got), other)
    low = 1 << (16 * L)
    assert _ints(nofinal) == [_cios_t(x, y, n, ctx.R) % low for x, y in zip(a, b)]


@pytest.mark.parametrize("which", [0, 2])
@pytest.mark.parametrize("L", [33, 64])
def test_exp_on_carry_edges_matches_exp_lm(L, which):
    """Montgomery-domain ladder from the edge operands as bases; the
    exponent's digits include 0 and 15."""
    n = carry_edge_moduli(L)[which]
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    bases = carry_edge_operands(ctx)
    exp = 0xF0E1
    digits = _exp_to_digits(exp).astype(np.int32)
    got = mont_cuda.exp(ctx, _lm(bases, L), torch.from_numpy(digits))
    R, R_ref = ctx.R, 1 << (16 * L)
    # the same plain-domain bases in the reference's Montgomery domain
    ref_bases = [x * R_ref * pow(R, -1, n) % n for x in bases]
    v1 = np.asarray(pallas_mont.exp_lm(
        ref, jnp.asarray(bn.ints_to_batch(ref_bases, L)).T, jnp.asarray(digits),
        TB=128, interpret=True))
    assert [v * R * pow(R_ref, -1, n) % n for v in _ints(v1)] == _ints(got)
    if L % 2 == 0:
        np.testing.assert_array_equal(bn.to_host(got), v1)
    Rinv = pow(R, -1, n)
    assert _ints(got) == [pow(x * Rinv, exp, n) * R % n for x in bases]


@pytest.mark.parametrize("L", [256, 512])
def test_mul_and_nofinal_on_carry_edges_match_python(L):
    for n in carry_edge_moduli(L):
        ctx = ModCtx.make(n)
        a, b = _pairs(ctx)
        got = mont_cuda.mul(ctx, _lm(a, L), _lm(b, L))
        nofinal = mont_cuda.mul_nofinal(ctx, _lm(a, L), _lm(b, L))
        Rinv = pow(ctx.R, -1, n)
        assert _ints(got) == [x * y * Rinv % n for x, y in zip(a, b)]
        assert _ints(nofinal) == [_cios_t(x, y, n, ctx.R) % ctx.R for x, y in zip(a, b)]


@pytest.mark.parametrize("L", [256, 512])
def test_exp_on_carry_edges_matches_python(L):
    n = carry_edge_moduli(L)[0]
    ctx = ModCtx.make(n)
    bases = carry_edge_operands(ctx)
    exp = 0xF0E1
    got = mont_cuda.exp(ctx, _lm(bases, L),
                        torch.from_numpy(_exp_to_digits(exp).astype(np.int32)))
    R = ctx.R
    Rinv = pow(R, -1, n)
    assert _ints(got) == [pow(x * Rinv, exp, n) * R % n for x in bases]


def test_carry_edge_inputs_are_what_they_claim():
    for L in (33, 64, 256, 512):
        for n in carry_edge_moduli(L):
            ctx = ModCtx.make(n)
            assert n % 2 == 1 and ctx.L == L
            words = [(n >> (32 * j)) & M32 for j in range(ctx.W)]
            assert words.count(M32) >= ctx.W // 2 - 1  # long runs of ones
            ops = carry_edge_operands(ctx)
            assert {0, 1, n - 1, ctx.R % n} <= set(ops) and all(x < n for x in ops)


# -- 3. the build key covers the headers ------------------------------------


def test_library_path_changes_when_a_header_changes(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(mont_cuda.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    lib = mont_cuda.KernelLib(str(csrc / "mont_mul.cu"), {})
    header = csrc / "mont_warp.cuh"
    assert header.exists()
    first = lib.library_path()
    assert first == lib.library_path()
    assert first.name.startswith("libmont_mul-")
    original = header.read_bytes()
    header.write_bytes(original + b"\n// edited\n")
    edited = lib.library_path()
    assert edited != first
    header.write_bytes(original)
    assert lib.library_path() == first
    (csrc / "extra.cuh").write_bytes(b"#pragma once\n")
    assert lib.library_path() not in (first, edited)
