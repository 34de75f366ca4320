"""Carry-edge inputs for the warp-per-column Montgomery kernels, on the CPU.

Three parts:

1. Lane-level models of the warp kernels of `dds_tpu_torch/csrc/`:
   line-for-line Python transliterations with the 32 lanes as lists,
   shuffles as index maps and ballots as bit masks, sharing the helpers of
   `mont_warp.cuh` (`add_warp`, `sub_warp`, `settle`, `finalize`, ...):
   `mont_mul_warp` (B1, P and B3), `mont_redc_warp` (the reduction of
   `mont_redc.cu`) and `mont_kfused_kernel` (B5: the half products, the half
   sums, the corrections, the subtractions and the assembly, with the
   column's shared-memory row as a list). Each is held against Python ints
   at 1, 2, 4 and 8 words per lane on moduli made of long runs of
   0xFFFFFFFF words and on the operands 0, 1, n - 1, R mod n and all-ones
   words (`montgomery.carry_edge_moduli` / `carry_edge_operands`), and
   REDC also on the extreme T (0, R - 1, R (n - 1), n R - 1): the inputs
   that push a pending carry or a borrow through every lane.
2. The port's plain path (`mont_cuda.mul`, `mul_nofinal`, `exp`, `redc`,
   `prod_kf` on CPU tensors) on the same inputs: at L = 32, 33 and 64
   against `pallas_mont.mul_lm`, `mont_mxu.mul2_lm`, `mont_mxu._redc`,
   `mont_mxu.prod_lm_kf` and `pallas_mont.exp_lm` in interpret mode (as
   tests/test_torch_montgomery.py runs them), at L = 256 and 512 against
   Python ints. At odd L the port's R is one limb wider than the
   reference's, so the reference's Montgomery-domain outputs are carried
   over by R_ref / R before the comparison; at even L they agree limb for
   limb.
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
    carry_edge_products,
    karatsuba_edge_operands,
    prod3_edge_columns,
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


def _add_warp(x: list[list[int]], y, cin: list[int], N: int) -> int:
    """`dds::add_warp`: x += y (None: no y) + cin[lane] at each lane's word
    0; returns the carry out of lane 31."""
    gen, ones = [False] * LANES, [True] * LANES
    for lane in range(LANES):
        c = cin[lane]
        for j in range(N):
            s = x[lane][j] + (y[lane][j] if y is not None else 0) + c
            x[lane][j], c = s & M32, s >> 32
            ones[lane] = ones[lane] and x[lane][j] == M32
        assert c <= 1, "a lane's chain carries out at most 1"
        gen[lane] = c != 0
    cin2, out = _lookahead(gen, ones)
    for lane in range(LANES):
        c = cin2[lane]
        for j in range(N):
            s = x[lane][j] + c
            x[lane][j], c = s & M32, s >> 32
        assert c == 0 or not gen[lane], "a lane owes its neighbour a carry of 2"
    return out


def _sub_warp(x: list[list[int]], y: list[list[int]], N: int) -> int:
    """`dds::sub_warp`: x -= y; returns the borrow out of lane 31."""
    gen, zeros = [False] * LANES, [True] * LANES
    for lane in range(LANES):
        bw = 0
        for j in range(N):
            d = x[lane][j] - y[lane][j] - bw
            x[lane][j], bw = d & M32, 1 if d < 0 else 0
            zeros[lane] = zeros[lane] and x[lane][j] == 0
        gen[lane] = bw != 0
    bin_, out = _lookahead(gen, zeros)
    for lane in range(LANES):
        bw = bin_[lane]
        for j in range(N):
            d = x[lane][j] - bw
            x[lane][j], bw = d & M32, 1 if d < 0 else 0
    return out


def _take_word(x: list[list[int]], pos: int, clear: bool, N: int) -> int:
    """`dds::take_word`: word `pos` of the frame (0 at and above 32 N)."""
    if pos >= LANES * N:
        return 0
    w = x[pos // N][pos % N]
    if clear:
        x[pos // N][pos % N] = 0
    return w


def _settle(t: list[list[int]], p: list[int], N: int) -> int:
    """`dds::settle`: t += each lane's pending carry at the next lane's
    word 0 (__shfl_up_sync); returns lane 31's p + the carry out."""
    q = [0] + p[:-1]
    return p[LANES - 1] + _add_warp(t, None, q, N)


def _finalize(t: list[list[int]], N_: list[list[int]], ovf: int, N: int) -> None:
    """`dds::finalize`: subtract n once when t + ovf * 2^(32 * 32 N) >= n."""
    bgen, eq = [False] * LANES, [True] * LANES
    for lane in range(LANES):
        bw = 0
        for j in range(N):
            d = t[lane][j] - N_[lane][j] - bw
            bw = 1 if d < 0 else 0
            eq[lane] = eq[lane] and t[lane][j] == N_[lane][j]
        bgen[lane] = bw != 0
    bin_, borrow_out = _lookahead(bgen, eq)
    if ovf != 0 or borrow_out == 0:
        for lane in range(LANES):
            bw = bin_[lane]
            for j in range(N):
                d = t[lane][j] - N_[lane][j] - bw
                t[lane][j], bw = d & M32, 1 if d < 0 else 0


def _shift(t: list[list[int]], p: list[int], c: list[int], N: int) -> None:
    """The shift down one word: lane l's new top word is the next lane's
    word 0 (__shfl_down_sync; 0 on lane 31) + its pending carry + its
    chain's carry out; what carries out of it is the new pending carry."""
    up = [t[lane + 1][0] if lane < LANES - 1 else 0 for lane in range(LANES)]
    for lane in range(LANES):
        t[lane] = t[lane][1:] + [0]
        s = up[lane] + p[lane] + c[lane]
        t[lane][N - 1], p[lane] = s & M32, s >> 32


def _chain(t: list[list[int]], xi: int, y: list[list[int]], N: int) -> list[int]:
    """Each lane's t += xi * y, a lane-local carry chain; the carries out."""
    out = [0] * LANES
    for lane in range(LANES):
        c = 0
        for j in range(N):
            s = xi * y[lane][j] + t[lane][j] + c
            t[lane][j], c = s & M32, s >> 32
        out[lane] = c
    return out


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
            c1 = _chain(t, ai, B, WPL)
            m = (t[0][0] * n0inv) & M32                         # lane 0, broadcast
            c2 = _chain(t, m, N, WPL)
            assert t[0][0] == 0
            _shift(t, p, [x + y for x, y in zip(c1, c2)], WPL)
            assert max(p) <= 2
    ovf = _settle(t, p, WPL)
    assert ovf in (0, 1)
    if finalize:
        _finalize(t, N, ovf, WPL)
    return _value(t, WPL)


def warp_redc(T: int, n: int, W: int) -> int:
    """The warp schedule of `mont_redc_warp` (csrc/mont_redc.cu) for
    T < n * R: t starts as T mod R, h is T / R, W steps of m on lane 0 and
    t += m * n with the shift, then `settle` adds the pending carries, one
    more warp add adds h, and `finalize` subtracts n once. Returns the
    lanes' words."""
    WPL = words_per_lane(W)
    n0inv = (-pow(n, -1, 1 << 32)) % (1 << 32)
    t = _lanes(T % (1 << (32 * W)), WPL)
    h = _lanes(T >> (32 * W), WPL)
    N = _lanes(n, WPL)
    p = [0] * LANES
    for _ in range(W):
        m = (t[0][0] * n0inv) & M32                             # lane 0, broadcast
        c = _chain(t, m, N, WPL)
        assert t[0][0] == 0
        _shift(t, p, c, WPL)
        assert max(p) <= 1
    ovf = _settle(t, p, WPL)
    ovf += _add_warp(t, h, [0] * LANES, WPL)
    assert ovf in (0, 1)
    _finalize(t, N, ovf, WPL)
    return _value(t, WPL)


def _load_lanes(mem: list[int], off: int, count: int, N: int) -> list[list[int]]:
    """`dds::load_lanes`: lane l's words [N*l, N*l + N) of mem[off:],
    zeros at and above count."""
    return [[mem[off + N * lane + k] if N * lane + k < count else 0 for k in range(N)]
            for lane in range(LANES)]


def _store_lanes(mem: list[int], off: int, x: list[list[int]], count: int, N: int) -> None:
    for lane in range(LANES):
        for k in range(N):
            if N * lane + k < count:
                mem[off + N * lane + k] = x[lane][k]


def _mul_half(mem: list[int], off: int, x, y, H: int, HPL: int) -> None:
    """`dds::mul_half_warp`: the 2H words of x * y into mem[off:off + 2H];
    lane 0 writes the word leaving it at each shift, the lanes the high H
    words after `settle`."""
    t = [[0] * HPL for _ in range(LANES)]
    p = [0] * LANES
    for src in range(-(-H // HPL)):
        for k in range(HPL):
            if src * HPL + k >= H:
                continue
            xi = x[src][k]                                      # __shfl_sync
            c = _chain(t, xi, y, HPL)
            mem[off + src * HPL + k] = t[0][0]                  # lane 0
            _shift(t, p, c, HPL)
            assert max(p) <= 1
    assert _settle(t, p, HPL) == 0
    _store_lanes(mem, off + H, t, H, HPL)


def _half_sum(x, mem: list[int], lo: int, H: int, N: int) -> int:
    """`dds::half_sum_warp`: x += the H words at mem[lo:] (x holds the
    other half); the carry out of word H - 1, taken from frame word H (then
    cleared) or out of lane 31 when H = 32 N."""
    u = _load_lanes(mem, lo, H, N)
    c = _add_warp(x, u, [0] * LANES, N)
    return c + _take_word(x, H, True, N)


def _recombine(mem: list[int], T: int, z1: int, sa: int, sb: int, ca: int, cb: int,
               H: int, HPL: int) -> None:
    """`dds::karatsuba_recombine_warp` on one column's row `mem`: T holds z0
    at [0, 2H) and z2 at [2H, 4H); z1 (2H words), sa and sb (H words) are
    offsets too. The middle term in the frame of 2 HPL words a lane, `top`
    above it, then the add at word H and the carry into z2's high half."""
    DPL = 2 * HPL
    zero = [0] * LANES
    m = _load_lanes(mem, z1, 2 * H, DPL)
    top = 0
    if 2 * H < LANES * DPL:
        m[2 * H // DPL][2 * H % DPL] = ca & cb
    else:
        top = ca & cb
    for s in range(2):                                          # + ca sb X, + cb sa X
        if (ca if s == 0 else cb) != 0:
            src = sb if s == 0 else sa
            v = [[mem[src + DPL * lane + k - H] if H <= DPL * lane + k < 2 * H else 0
                  for k in range(DPL)] for lane in range(LANES)]
            top += _add_warp(m, v, zero, DPL)
    v = _load_lanes(mem, T, 2 * H, DPL)                         # - z0
    top -= _sub_warp(m, v, DPL)
    v = _load_lanes(mem, T + 2 * H, 2 * H, DPL)                 # - z2
    top -= _sub_warp(m, v, DPL)
    assert top in (0, 1) and _value(m, DPL) + (top << (32 * LANES * DPL)) < 2 << (64 * H)

    v = _load_lanes(mem, T + H, 2 * H, DPL)
    top += _add_warp(v, m, zero, DPL)
    top += _take_word(v, 2 * H, False, DPL)
    assert top <= 2
    _store_lanes(mem, T + H, v, 2 * H, DPL)
    u = _load_lanes(mem, T + 3 * H, H, HPL)
    assert _add_warp(u, None, [top] + [0] * (LANES - 1), HPL) == 0
    _store_lanes(mem, T + 3 * H, u, H, HPL)


def warp_kfused(a: int, b: int, L: int) -> int:
    """The warp schedule of `mont_kfused_kernel` (csrc/mont_kfused.cu) for
    L-limb a and b, L a multiple of 4: the column's row of the shared tile
    as a list ([A | B | T], 64 HPL + 64 HPL + 128 HPL words), the three
    half products, the half sums with their overflow bits (`_half_sum`)
    and the recombination (`_recombine`). Returns T, the 4H words of a*b."""
    W = L // 2
    H = W // 2
    HPL = words_per_lane(H)
    half = LANES * HPL
    kA, kB, kT = 0, 2 * half, 4 * half
    row = [0] * (8 * half)
    for j in range(W):                                          # staging
        row[kA + j] = (a >> (32 * j)) & M32
        row[kB + j] = (b >> (32 * j)) & M32
    x, y = _load_lanes(row, kA, H, HPL), _load_lanes(row, kB, H, HPL)
    _mul_half(row, kT, x, y, H, HPL)                            # z0
    x, y = _load_lanes(row, kA + H, H, HPL), _load_lanes(row, kB + H, H, HPL)
    _mul_half(row, kT + 2 * H, x, y, H, HPL)                    # z2
    ca = _half_sum(x, row, kA, H, HPL)                          # sa = x
    cb = _half_sum(y, row, kB, H, HPL)                          # sb = y
    assert ca in (0, 1) and cb in (0, 1)
    _store_lanes(row, kB, x, H, HPL)
    _store_lanes(row, kB + half, y, H, HPL)
    _mul_half(row, kA, x, y, H, HPL)                            # z1
    _recombine(row, kT, kA, kB, kB + half, ca, cb, H, HPL)
    return sum(w << (32 * j) for j, w in enumerate(row[kT: kT + 4 * H]))


def _stage(mem: list[int], off: int, x: int, rows: int, words: int) -> None:
    """`dds::stage_limbs` for one column: limbs below `rows` of x, packed
    two to a word, into mem[off:off + words]."""
    x &= (1 << (16 * rows)) - 1
    for j in range(words):
        mem[off + j] = (x >> (32 * j)) & M32


def _unstage(mem: list[int], off: int, rows: int) -> int:
    """`dds::unstage_limbs` for one column: the value of limbs [0, rows) of
    the words at mem[off:]."""
    return sum(((mem[off + i // 2] >> (16 * (i & 1))) & 0xFFFF) << (16 * i)
               for i in range(rows))


def warp_prod3(col: tuple[int, ...], h: int) -> tuple[int, int, int]:
    """The warp schedule of `mont_prod3_kernel` (csrc/mont_prod3.cu, B4) for
    one column (a0, b0, a1, b1, sa, sb) of h-limb operands: each staged in
    its slot of 32 HPL words (H = ceil(h/2) words, the top one holding one
    limb at odd h), then product p loads slots 2p and 2p + 1 into the
    lanes and `_mul_half` writes it over them. Returns (z0, z2, z1) from
    the 2h limbs of each product's slots."""
    H = (h + 1) // 2
    HPL = words_per_lane(H)
    slot = LANES * HPL
    row = [0] * (6 * slot)
    for o, x in enumerate(col):
        _stage(row, o * slot, x, h, H)
    for p in range(3):
        x = _load_lanes(row, 2 * p * slot, H, HPL)
        y = _load_lanes(row, (2 * p + 1) * slot, H, HPL)
        _mul_half(row, 2 * p * slot, x, y, H, HPL)              # over x's and y's slots
    return tuple(_unstage(row, 2 * p * slot, 2 * h) for p in range(3))


def warp_k1_halfsums(a: int, b: int, L: int) -> tuple[int, int, int, int]:
    """The warp schedule of `mont_k1_halfsums_kernel` (csrc/mont_k1.cu): a and b
    staged at 0 and 64 HPL, a1 and b1 into the lanes, `_half_sum` with a0
    and b0. Returns (sa, sb, ca, cb)."""
    h, H = L // 2, L // 4
    HPL = words_per_lane(H)
    half = LANES * HPL
    row = [0] * (4 * half + 4)
    _stage(row, 0, a, L, 2 * H)
    _stage(row, 2 * half, b, L, 2 * H)
    x, y = _load_lanes(row, H, H, HPL), _load_lanes(row, 2 * half + H, H, HPL)
    ca = _half_sum(x, row, 0, H, HPL)
    cb = _half_sum(y, row, 2 * half, H, HPL)
    _store_lanes(row, 0, x, H, HPL)
    _store_lanes(row, 2 * half, y, H, HPL)
    return _unstage(row, 0, h), _unstage(row, 2 * half, h), ca, cb


def warp_k1_combine(z: tuple[int, int, int], sa: int, sb: int, ca: int, cb: int,
                    L: int) -> int:
    """The warp schedule of `mont_k1_combine_kernel` (csrc/mont_k1.cu): B4's
    (z0, z2, z1) and the half sums staged into B5's row layout (z1 in A, sa
    and sb in B, z0 and z2 in T), then `_recombine`. Returns the 2L limbs
    of T."""
    z0, z2, z1 = z
    h, H = L // 2, L // 4
    HPL = words_per_lane(H)
    half = LANES * HPL
    kA, kB, kT = 0, 2 * half, 4 * half
    row = [0] * (8 * half + 4)
    _stage(row, kA, z1, 2 * h, 2 * H)
    _stage(row, kB, sa, h, H)
    _stage(row, kB + half, sb, h, H)
    _stage(row, kT, z0, 2 * h, 2 * H)
    _stage(row, kT + 2 * H, z2, 2 * h, 2 * H)
    _recombine(row, kT, kA, kB, kB + half, ca, cb, H, HPL)
    return _unstage(row, kT, 2 * L)


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


@pytest.mark.parametrize("L", [33, 36, 64, 128, 256, 512])
def test_redc_lane_model_matches_python_ints(L):
    """W = 17, 18, 32, 64, 128, 256: WPL = 1, 1, 1, 2, 4, 8."""
    W = (L + 1) // 2
    moduli = carry_edge_moduli(L)
    for n in moduli[:2] if W > 64 else moduli:  # the model is slow in Python
        ctx = ModCtx.make(n)
        assert ctx.W == W
        Rinv = pow(ctx.R, -1, n)
        for T in carry_edge_products(ctx):
            assert T < n * ctx.R
            assert warp_redc(T, n, W) == T * Rinv % n, (hex(n), hex(T))


@pytest.mark.parametrize("L", [36, 64, 128, 256, 512])
def test_kfused_lane_model_matches_python_ints(L):
    """H = 9, 16, 32, 64, 128 words a half: HPL = 1, 1, 1, 2, 4 (2H in the
    frame of 2, 2, 2, 4, 8 words a lane); at L = 128, 256 and 512 a half
    fills the lanes (H = 32 HPL), so the half sums' carries leave lane 31
    and the middle term's top word lies above the frame."""
    moduli = carry_edge_moduli(L)
    for n in moduli[:2] if L > 128 else moduli:
        ops = karatsuba_edge_operands(ModCtx.make(n))
        for a in ops:
            for b in ops:
                assert warp_kfused(a, b, L) == a * b, (hex(a), hex(b))


def test_warp_models_on_random_operands_at_every_width():
    rng = random.Random(2027)
    for L in (36, 64, 128, 256, 512):
        for _ in range(2):
            a, b = rng.getrandbits(16 * L), rng.getrandbits(16 * L)
            assert warp_kfused(a, b, L) == a * b
    for L in (33, 36, 64, 128, 256, 512):
        W = (L + 1) // 2
        n = rng.getrandbits(16 * L) | (1 << (16 * L - 1)) | 1
        R = 1 << (32 * W)
        T = rng.randrange(n * R)
        assert warp_redc(T, n, W) == T * pow(R, -1, n) % n


@pytest.mark.parametrize("h", [8, 9, 32, 128, 256])
def test_prod3_lane_model_matches_python_ints(h):
    """B4 at H = 4, 5, 16, 64, 128 words an operand: HPL = 1, 1, 1, 2, 4; at
    h = 9 the top word holds one limb, at 128 and 256 the operands fill the
    lanes (H = 32 HPL). The columns are the halves and half sums of every
    pair of Karatsuba edge operands and the all-ones column."""
    for col in prod3_edge_columns(h):
        a0, b0, a1, b1, sa, sb = col
        assert warp_prod3(col, h) == (a0 * b0, a1 * b1, sa * sb), [hex(x) for x in col]


@pytest.mark.parametrize("L", [16, 36, 64, 132, 256, 512])
def test_k1_lane_models_match_python_ints(L):
    """The half sums and the recombination of mont_k1.cu at h = 8, 18, 32,
    66, 128, 256 limbs a half (H = 4, 9, 16, 33, 64, 128 words, HPL = 1, 1,
    1, 2, 2, 4): at L = 132 a half does not start on a lane boundary; at
    L = 256 and 512 (H = 32 HPL) the half sums' carries leave lane 31 and
    the middle term's top word lies above its frame. The products between
    them are Python's; the random test chains the three models."""
    h = L // 2
    X = 1 << (16 * h)
    ops = karatsuba_edge_operands(ModCtx.make(carry_edge_moduli(L)[0]))
    for a in ops:
        for b in ops:
            sa, sb, ca, cb = warp_k1_halfsums(a, b, L)
            assert (ca, sa) == divmod(a % X + a // X, X), (hex(a), hex(b))
            assert (cb, sb) == divmod(b % X + b // X, X), (hex(a), hex(b))
            z = ((a % X) * (b % X), (a // X) * (b // X), sa * sb)
            assert warp_k1_combine(z, sa, sb, ca, cb, L) == a * b, (hex(a), hex(b))


def test_k1_chain_of_lane_models_on_random_operands():
    """Half sums, B4 and the recombination chained, as `prod_k1` launches
    them, on random operands and at odd h for B4 alone."""
    rng = random.Random(2028)
    for L in (16, 36, 64, 132, 256, 512):
        h = L // 2
        for _ in range(2):
            a, b = rng.getrandbits(16 * L), rng.getrandbits(16 * L)
            sa, sb, ca, cb = warp_k1_halfsums(a, b, L)
            X = 1 << (16 * h)
            z = warp_prod3((a % X, b % X, a // X, b // X, sa, sb), h)
            assert warp_k1_combine(z, sa, sb, ca, cb, L) == a * b
    for h in (1, 3, 9, 65, 129):
        col = tuple(rng.getrandbits(16 * h) for _ in range(6))
        assert warp_prod3(col, h) == (col[0] * col[1], col[2] * col[3], col[4] * col[5])


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


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("L", [32, 64])
def test_redc_on_carry_edges_matches_reference_redc(L, which):
    """`mont_cuda.redc` on CPU tensors (its plain version) against the
    reference's XLA `mont_mxu._redc`, limb for limb, and Python ints."""
    n = carry_edge_moduli(L)[which]
    ctx, ref = ModCtx.make(n), RefCtx.make(n)
    assert ctx.L == ref.L == L and ctx.R == 1 << (16 * L)
    Ts = carry_edge_products(ctx)
    got = mont_cuda.redc(ctx, _lm(Ts, 2 * L))
    want = np.asarray(mont_mxu._redc(mont_mxu.MxuCtx.make(ref),
                                     jnp.asarray(bn.ints_to_batch(Ts, 2 * L).T)))
    np.testing.assert_array_equal(bn.to_host(got), want)
    Rinv = pow(ctx.R, -1, n)
    assert _ints(got) == [T * Rinv % n for T in Ts]


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("L", [32, 64])
def test_prod_kf_on_carry_edges_matches_prod_lm_kf(L, which):
    """`mont_cuda.prod_kf` on CPU tensors (its plain version) against the
    reference's fused Karatsuba product `mont_mxu.prod_lm_kf` in interpret
    mode, compared as the integers they encode, and Python ints."""
    n = carry_edge_moduli(L)[which]
    ops = karatsuba_edge_operands(ModCtx.make(n))
    a, b = [x for x in ops for _ in ops], [y for _ in ops for y in ops]
    got = mont_cuda.prod_kf(_lm(a, L), _lm(b, L))
    ref = mont_mxu.prod_lm_kf(jnp.asarray(bn.ints_to_batch(a, L)).T,
                              jnp.asarray(bn.ints_to_batch(b, L)).T, interpret=True)
    limbs = np.asarray(ref).astype(np.uint64)
    assert got.shape == (2 * L, len(a)) and int(got.max()) <= 0xFFFF
    assert _ints(got) == [bn.limbs_to_int(limbs[:, j]) for j in range(len(a))]
    assert _ints(got) == [x * y for x, y in zip(a, b)]


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
