// One Montgomery product a*b*R^-1 mod n per warp, in registers, on Hopper.
//
// The product core shared by mont_mul.cu (B1, which also serves B2 and the
// probe P) and mont_exp.cu (B3); its reduction-only sibling mont_redc_warp
// serves mont_redc.cu, and its product-only sibling mul_half_warp the three
// half products of mont_prod3.cu (B4) and mont_kfused.cu (B5). The
// Karatsuba half sums (half_sum_warp) and recombination
// (karatsuba_recombine_warp) are here once, for B5 and for the composed
// variant's own launches in mont_k1.cu. It computes what the TPU kernels'
// pallas_mont._cios_loop + _finalize compute (dds_tpu/ops/pallas_mont.py
// :68-128), in W = ceil(L/2) 32-bit words with R = 2^(32 W): for even L the
// R = 2^(16 L) of the TPU kernels, as ModCtx.n0inv32 and ModCtx.R assume.
//
// What bounds it: a product is 2 W^2 + W word multiply-adds (32,896 at
// W = 128), each a 32x32->64 IMAD.WIDE plus its carry adds. Hopper issues
// 64 integer multiply-adds per SM per clock, so the product is bound by
// integer operations, not bytes. A design with one thread per product walks
// that whole carry chain serially, keeps the accumulator in local memory
// and leaves most of the card idle; this one
// - gives each product a warp: lane l holds words [WPL*l, WPL*l + WPL) of
//   b, n and the accumulator t, WPL = 1, 2, 4 or 8 words for W <= 32, 64,
//   128 or 256 (lanes above W hold zeros), so one step of the outer loop is
//   WPL multiply-adds per lane instead of 2W in one thread;
// - keeps every operand, the accumulator and its pending carries in
//   registers: register arrays are indexed only by compile-time constants
//   in fully unrolled loops;
// - resolves carries across lanes once per product, not once per step.
//
// Schedule (a distributed CIOS). The outer loop runs exactly W steps, one
// per word of a, whatever the padding: R stays 2^(32 W). Step i:
//   1. a_i is broadcast from the lane that holds it (__shfl_sync);
//   2. each lane adds a_i * b to its words with a lane-local carry chain;
//   3. m = t_0 * n0' mod 2^32 on lane 0, broadcast. t_0 is exact there: no
//      pending carry ever enters word 0;
//   4. each lane adds m * n the same way (word 0 becomes 0 mod 2^32);
//   5. t shifts down one word: each lane takes the next lane's lowest word
//      as its new top word (__shfl_down_sync). The carries out of a lane's
//      top word (steps 2 and 4) and its pending carry p, all of the weight
//      of the next lane's word 0, now have the weight of the lane's own new
//      top word: they are added there, and what carries out of it becomes
//      the new p (at most 2). Nothing crosses lanes but the shift.
// After step W-1, t = sum of the lanes' words + sum_l p_l * 2^(32 WPL (l+1)).
// One carry-lookahead adds each p_l into lane l+1: every lane adds its
// neighbour's p, then generate (a carry out) and propagate (all words
// 0xFFFFFFFF) bits from __ballot_sync give every lane's carry-in by one
// 32-bit add, (G|P) + G, the carry-in bits being ((G|P) + G) ^ P. The
// finalize compares t >= n the same way (generate = a borrow out of the
// lane, propagate = the lane's words equal n's) and subtracts n once with
// each lane's borrow-in. The pre-finalize t = (a*b + m*n) / R < 2n is
// unique (m is the unique m < R with a*b + m*n = 0 mod R), so any schedule
// gives the same integer: the no-finalize probe P stays bit-exact. Every
// multi-word add and subtract below (add_warp, sub_warp) is the same shape:
// one lane-local chain, then one lookahead for the carries between lanes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dds {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kWarp = 32;
constexpr int kMaxWords = 256;  // moduli up to 8192 bits (Paillier-4096 n^2)

// Words per lane for W words: the template argument of every kernel below.
__host__ __device__ constexpr int words_per_lane(int W) {
  return W <= 32 ? 1 : W <= 64 ? 2 : W <= 128 ? 4 : 8;
}

// This lane's WPL words of a W-word little-endian array (zeros above W).
template <int WPL>
__device__ __forceinline__ void load_words(uint32_t (&x)[WPL],
                                           const uint32_t* __restrict__ src,
                                           int W, int lane) {
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    const int j = WPL * lane + k;
    x[k] = j < W ? __ldg(&src[j]) : 0u;
  }
}

// This lane's WPL words of column `col` of a limbs-major (L, *) int32 array
// of 16-bit little-endian limbs with row stride `s` (zeros above L).
template <int WPL>
__device__ __forceinline__ void load_limbs(uint32_t (&x)[WPL],
                                           const int32_t* __restrict__ src,
                                           long long s, long long col, int L,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    const int j = WPL * lane + k;
    uint32_t w = 0;
    if (2 * j < L) w = static_cast<uint32_t>(src[2LL * j * s + col]);
    if (2 * j + 1 < L) w |= static_cast<uint32_t>(src[(2LL * j + 1) * s + col]) << 16;
    x[k] = w;
  }
}

// Write this lane's words as limbs 2j, 2j+1 < L of column `col`.
template <int WPL>
__device__ __forceinline__ void store_limbs(int32_t* __restrict__ dst,
                                            long long s, long long col, int L,
                                            const uint32_t (&x)[WPL], int lane) {
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    const int j = WPL * lane + k;
    if (2 * j < L) dst[2LL * j * s + col] = static_cast<int32_t>(x[k] & 0xFFFFu);
    if (2 * j + 1 < L) dst[(2LL * j + 1) * s + col] = static_cast<int32_t>(x[k] >> 16);
  }
}

// This lane's N words of a `count`-word array in shared memory, in the
// frame where lane l holds words [N*l, N*l + N) (zeros at and above count).
template <int N>
__device__ __forceinline__ void load_lanes(uint32_t (&x)[N], const uint32_t* src,
                                           int count, int lane) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = N * lane + k;
    x[k] = j < count ? src[j] : 0u;
  }
}

// Write this lane's words below `count` to dst[N*l + k].
template <int N>
__device__ __forceinline__ void store_lanes(uint32_t* dst, const uint32_t (&x)[N],
                                            int count, int lane) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = N * lane + k;
    if (j < count) dst[j] = x[k];
  }
}

// Carry-in bit of this lane from the warp's generate and propagate masks
// (disjoint): bit l of ((G|P) + G) ^ P. `out` gets the carry out of lane 31.
__device__ __forceinline__ uint32_t lookahead(bool generate, bool propagate,
                                              int lane, uint32_t& out) {
  const uint32_t G = __ballot_sync(kFullMask, generate);
  const uint32_t P = __ballot_sync(kFullMask, propagate);
  const uint64_t sum = static_cast<uint64_t>(G | P) + G;
  out = static_cast<uint32_t>(sum >> 32);
  return ((static_cast<uint32_t>(sum) ^ P) >> lane) & 1u;
}

// x += y + cin across the warp (x and y in the frame of N words per lane,
// cin added at this lane's word 0; kY = false adds no y): one lane-local
// carry chain, one lookahead. Each lane's x + y + cin must stay below
// 2^(32 N + 1) - 1: then a lane that carries out is not all ones (generate
// and propagate stay disjoint) and with its carry-in it still carries out
// at most 1. True for two N-word numbers (cin = 0), or for one and
// cin <= 2. Returns the carry out of lane 31 (the word 32 N).
template <int N, bool kY = true>
__device__ __forceinline__ uint32_t add_warp(uint32_t (&x)[N], const uint32_t (&y)[N],
                                             uint32_t cin, int lane) {
  uint32_t c = cin;
  bool ones = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t s = static_cast<uint64_t>(x[j]) + (kY ? y[j] : 0u) + c;
    x[j] = static_cast<uint32_t>(s);
    c = static_cast<uint32_t>(s >> 32);
    ones = ones && x[j] == 0xFFFFFFFFu;
  }
  uint32_t out;
  c = lookahead(c != 0, ones, lane, out);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t s = static_cast<uint64_t>(x[j]) + c;
    x[j] = static_cast<uint32_t>(s);
    c = static_cast<uint32_t>(s >> 32);
  }
  return out;
}

// x -= y across the warp: one lane-local borrow chain, one lookahead (a
// lane whose difference is all zeros passes a borrow on). Returns the
// borrow out of lane 31.
template <int N>
__device__ __forceinline__ uint32_t sub_warp(uint32_t (&x)[N], const uint32_t (&y)[N],
                                             int lane) {
  uint32_t bw = 0;
  bool zeros = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t d = static_cast<uint64_t>(x[j]) - y[j] - bw;
    x[j] = static_cast<uint32_t>(d);
    bw = static_cast<uint32_t>(d >> 63);
    zeros = zeros && x[j] == 0u;
  }
  uint32_t out;
  bw = lookahead(bw != 0, zeros, lane, out);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t d = static_cast<uint64_t>(x[j]) - bw;
    x[j] = static_cast<uint32_t>(d);
    bw = static_cast<uint32_t>(d >> 63);
  }
  return out;
}

// Word `pos` of a number in the frame of N words per lane (0 when pos is at
// or above 32 N), the same on every lane; `clear` zeroes it in x.
template <int N>
__device__ __forceinline__ uint32_t take_word(uint32_t (&x)[N], int pos, bool clear,
                                              int lane) {
  if (pos >= kWarp * N) return 0;  // warp-uniform
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (N * lane + k == pos) {
      w = x[k];
      if (clear) x[k] = 0;
    }
  }
  return __shfl_sync(kFullMask, w, pos / N);
}

// The shifting loop's end: t += sum_l p_l * 2^(32 WPL (l+1)), where p_l
// (at most 2) is lane l's pending carry, of the weight of the next lane's
// word 0. Returns the word 32 * WPL: lane 31's p plus the carry out of the
// warp.
template <int WPL>
__device__ __forceinline__ uint32_t settle(uint32_t (&t)[WPL], uint32_t p, int lane) {
  uint32_t c = __shfl_up_sync(kFullMask, p, 1);
  if (lane == 0) c = 0;
  const uint32_t top = __shfl_sync(kFullMask, p, kWarp - 1);
  return top + add_warp<WPL, false>(t, t, c, lane);
}

// t mod n for t + ovf * 2^(32 * 32 WPL) < 2n: subtract n once when t >= n
// (the comparison is a borrow chain and one lookahead, generate = a borrow
// out of the lane, propagate = the lane's words equal n's).
template <int WPL>
__device__ __forceinline__ void finalize(uint32_t (&t)[WPL], const uint32_t (&n)[WPL],
                                         uint32_t ovf, int lane) {
  uint32_t bw = 0;
  bool eq = true;
#pragma unroll
  for (int j = 0; j < WPL; ++j) {
    const uint64_t d = static_cast<uint64_t>(t[j]) - n[j] - bw;
    bw = static_cast<uint32_t>(d >> 63);
    eq = eq && t[j] == n[j];
  }
  uint32_t borrow_out;
  bw = lookahead(bw != 0, eq, lane, borrow_out);
  if (ovf != 0 || borrow_out == 0) {  // warp-uniform
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
      const uint64_t d = static_cast<uint64_t>(t[j]) - n[j] - bw;
      t[j] = static_cast<uint32_t>(d);
      bw = static_cast<uint32_t>(d >> 63);
    }
  }
}

// r = a * b * R^-1 mod n (kFinalize) or the loop's t = (a*b + m*n) / R < 2n
// mod 2^(32 * 32 WPL) (!kFinalize), for a, b < n. Every lane of the warp
// calls it with its own words; r may alias a and b (written last).
template <int WPL, bool kFinalize = true>
__device__ __forceinline__ void mont_mul_warp(uint32_t (&r)[WPL],
                                              const uint32_t (&a)[WPL],
                                              const uint32_t (&b)[WPL],
                                              const uint32_t (&n)[WPL],
                                              uint32_t n0inv, int W, int lane) {
  uint32_t t[WPL];
#pragma unroll
  for (int k = 0; k < WPL; ++k) t[k] = 0;
  uint32_t p = 0;  // pending carry, of the weight of word WPL * (lane + 1)

  const int lanes = (W + WPL - 1) / WPL;
  for (int src = 0; src < lanes; ++src) {
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
      if (src * WPL + k < W) {  // warp-uniform: exactly W steps
        const uint32_t ai = __shfl_sync(kFullMask, a[k], src);
        uint32_t c1 = 0;  // t += ai * b
#pragma unroll
        for (int j = 0; j < WPL; ++j) {
          const uint64_t s = static_cast<uint64_t>(ai) * b[j] + t[j] + c1;
          t[j] = static_cast<uint32_t>(s);
          c1 = static_cast<uint32_t>(s >> 32);
        }
        const uint32_t m = __shfl_sync(kFullMask, t[0] * n0inv, 0);
        uint32_t c2 = 0;  // t += m * n
#pragma unroll
        for (int j = 0; j < WPL; ++j) {
          const uint64_t s = static_cast<uint64_t>(m) * n[j] + t[j] + c2;
          t[j] = static_cast<uint32_t>(s);
          c2 = static_cast<uint32_t>(s >> 32);
        }
        // t /= 2^32: the next lane's lowest word becomes this lane's top
        uint32_t up = __shfl_down_sync(kFullMask, t[0], 1);
        if (lane == kWarp - 1) up = 0;
#pragma unroll
        for (int j = 0; j + 1 < WPL; ++j) t[j] = t[j + 1];
        const uint64_t s = static_cast<uint64_t>(up) + p + c1 + c2;
        t[WPL - 1] = static_cast<uint32_t>(s);
        p = static_cast<uint32_t>(s >> 32);
      }
    }
  }

  // resolve: lane l's p belongs at the next lane's word 0; lane 31's is
  // word 32 * WPL (nonzero only when W = 32 * WPL)
  const uint32_t ovf = settle<WPL>(t, p, lane);  // t's word 32 * WPL: 0 or 1
  if constexpr (kFinalize) finalize<WPL>(t, n, ovf, lane);
#pragma unroll
  for (int k = 0; k < WPL; ++k) r[k] = t[k];
}

// t = T * R^-1 mod n for T < n*R, R = 2^(32 W): the Montgomery reduction of
// mont_redc.cu, mont_mul_warp's schedule with the a_i * b term dropped. t
// enters holding T_lo = T mod R (this lane's words of it, zeros above W),
// h holds T_hi = T / R < n the same way. Exactly W steps, each m =
// t_0 * n0' on lane 0, broadcast, t += m * n, shift down one word; the
// pending carry stays at most 1 because only one product is added. Then
// one lookahead settles the pending carries and one more adds h, since
// (T + m*n) / R = T_hi + (T_lo + m*n) / R and m depends on T_lo only (one
// lookahead for both could owe a lane a carry of 2); the sum is below 2n,
// and the finalize subtracts n once.
template <int WPL>
__device__ __forceinline__ void mont_redc_warp(uint32_t (&t)[WPL], const uint32_t (&h)[WPL],
                                               const uint32_t (&n)[WPL], uint32_t n0inv,
                                               int W, int lane) {
  uint32_t p = 0;  // pending carry, of the weight of word WPL * (lane + 1)
  for (int i = 0; i < W; ++i) {
    const uint32_t m = __shfl_sync(kFullMask, t[0] * n0inv, 0);
    uint32_t c = 0;  // t += m * n
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
      const uint64_t s = static_cast<uint64_t>(m) * n[j] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = static_cast<uint32_t>(s >> 32);
    }
    uint32_t up = __shfl_down_sync(kFullMask, t[0], 1);
    if (lane == kWarp - 1) up = 0;
#pragma unroll
    for (int j = 0; j + 1 < WPL; ++j) t[j] = t[j + 1];
    const uint64_t s = static_cast<uint64_t>(up) + p + c;
    t[WPL - 1] = static_cast<uint32_t>(s);
    p = static_cast<uint32_t>(s >> 32);
  }
  uint32_t ovf = settle<WPL>(t, p, lane);
  ovf += add_warp<WPL>(t, h, 0, lane);
  finalize<WPL>(t, n, ovf, lane);
}

// The product of two H-word numbers x and y (this lane's HPL words each,
// zeros at and above H): the 2H words of x * y into dst[0, 2H), this
// warp's shared memory. mont_mul_warp's shifting schedule with no m * n:
// H steps, each broadcasts x_i and adds x_i * y lane-locally; the word that
// leaves lane 0 at the shift is exact (no pending carry enters lane 0) and
// is product word i, which lane 0 writes to dst[i]. The lanes then hold
// words [H, H + 32 HPL); one lookahead settles their pending carries (at
// most 1 each), and each lane writes its words below 2H.
template <int HPL>
__device__ __forceinline__ void mul_half_warp(uint32_t* dst, const uint32_t (&x)[HPL],
                                              const uint32_t (&y)[HPL], int H, int lane) {
  uint32_t t[HPL];
#pragma unroll
  for (int k = 0; k < HPL; ++k) t[k] = 0;
  uint32_t p = 0;
  const int lanes = (H + HPL - 1) / HPL;
  for (int src = 0; src < lanes; ++src) {
#pragma unroll
    for (int k = 0; k < HPL; ++k) {
      if (src * HPL + k < H) {  // warp-uniform: exactly H steps
        const uint32_t xi = __shfl_sync(kFullMask, x[k], src);
        uint32_t c = 0;  // t += xi * y
#pragma unroll
        for (int j = 0; j < HPL; ++j) {
          const uint64_t s = static_cast<uint64_t>(xi) * y[j] + t[j] + c;
          t[j] = static_cast<uint32_t>(s);
          c = static_cast<uint32_t>(s >> 32);
        }
        if (lane == 0) dst[src * HPL + k] = t[0];
        uint32_t up = __shfl_down_sync(kFullMask, t[0], 1);
        if (lane == kWarp - 1) up = 0;
#pragma unroll
        for (int j = 0; j + 1 < HPL; ++j) t[j] = t[j + 1];
        const uint64_t s = static_cast<uint64_t>(up) + p + c;
        t[HPL - 1] = static_cast<uint32_t>(s);
        p = static_cast<uint32_t>(s >> 32);
      }
    }
  }
  settle<HPL>(t, p, lane);  // x * y < 2^(64 H): nothing above
  store_lanes<HPL>(dst + H, t, H, lane);
}

// s = lo + hi for two H-word numbers, hi in this lane's N words (zeros at
// and above H), lo read from shared memory: s replaces hi, and its carry
// out of word H - 1 (0 or 1) is returned. The carry lands in frame word H,
// which is cleared, or leaves lane 31 when H = 32 N; both are taken. The
// half sums of a Karatsuba level, mont_mxu.carry_norm(a0 + a1) in the
// reference.
template <int N>
__device__ __forceinline__ uint32_t half_sum_warp(uint32_t (&x)[N], const uint32_t* lo,
                                                  int H, int lane) {
  uint32_t u[N];
  load_lanes<N>(u, lo, H, lane);
  const uint32_t c = add_warp<N>(x, u, 0, lane);
  return c + take_word<N>(x, H, true, lane);
}

// One Karatsuba level's recombination, the reference's _karatsuba_combine
// (dds_tpu/ops/mont_mxu.py:188-215), on one column's rows in shared memory.
// With X = 2^(32 H): T holds z0 = a0 b0 at [0, 2H) and z2 = a1 b1 at
// [2H, 4H); z1 (2H words) is the product of the H-word half sums sa and sb,
// whose overflow bits are ca and cb. Then
//   mid = z1 + (ca sb + cb sa) X + ca cb X^2 - z0 - z2 = a0 b1 + a1 b0,
// below 2 X^2 (2H + 1 words), is formed in the frame of 2 HPL words a lane,
// `top` counting what lies above it (only when H = 32 HPL), and added at
// word H; what carries to word 3H (mid's top word plus the carry) goes into
// z2's high half. T ends as the 4H words of a*b. The reference adds
// complements, because its u32 lanes have no borrow chain; here each add
// and subtract is one lane-local chain and one lookahead. Every lane
// calls it after the rows are visible to the whole warp.
template <int HPL>
__device__ __forceinline__ void karatsuba_recombine_warp(uint32_t* T, const uint32_t* z1,
                                                         const uint32_t* sa,
                                                         const uint32_t* sb, uint32_t ca,
                                                         uint32_t cb, int H, int lane) {
  constexpr int DPL = 2 * HPL;  // words per lane of a 2H-word number
  uint32_t m[DPL], v[DPL], u[HPL];
  load_lanes<DPL>(m, z1, 2 * H, lane);
  uint32_t top = 0;
  if (2 * H < kWarp * DPL) {
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      if (DPL * lane + k == 2 * H) m[k] = ca & cb;
    }
  } else {
    top = ca & cb;
  }
  for (int s = 0; s < 2; ++s) {  // + ca sb X, then + cb sa X
    if ((s == 0 ? ca : cb) != 0) {  // warp-uniform
      const uint32_t* src = s == 0 ? sb : sa;
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int j = DPL * lane + k;
        v[k] = (j >= H && j < 2 * H) ? src[j - H] : 0u;
      }
      top += add_warp<DPL>(m, v, 0, lane);
    }
  }
  load_lanes<DPL>(v, T, 2 * H, lane);          // - z0
  top -= sub_warp<DPL>(m, v, lane);
  load_lanes<DPL>(v, T + 2 * H, 2 * H, lane);  // - z2
  top -= sub_warp<DPL>(m, v, lane);

  // T[H, 3H) += mid's low 2H words; what carries to word 3H (mid's top
  // word plus the carry) then goes into z2's high half, T[3H, 4H)
  load_lanes<DPL>(v, T + H, 2 * H, lane);
  top += add_warp<DPL>(v, m, 0, lane);
  top += take_word<DPL>(v, 2 * H, false, lane);
  __syncwarp();
  store_lanes<DPL>(T + H, v, 2 * H, lane);
  __syncwarp();
  load_lanes<HPL>(u, T + 3 * H, H, lane);
  add_warp<HPL, false>(u, u, lane == 0 ? top : 0u, lane);  // a*b < X^4
  __syncwarp();
  store_lanes<HPL>(T + 3 * H, u, H, lane);
}

// Block-wide staging of limbs-major operands through shared memory, for
// blocks of kCols warps, one warp a column: thread (word j < words, column
// c) packs limbs 2j and 2j+1 (zeros at and above `rows`) of column
// col0 + c of src (row stride s, zeros at and above column B) into
// tile[c * stride + off + j]. Eight adjacent columns of a limb row are one
// 32-byte sector; a stride of 4 mod 32 words puts the 32 (word, column)
// pairs a warp writes in 32 distinct banks.
template <int kCols>
__device__ __forceinline__ void stage_limbs(uint32_t* tile, int stride, int off,
                                            const int32_t* __restrict__ src, long long s,
                                            int rows, int words, long long col0, int B) {
  for (int e = threadIdx.x; e < words * kCols; e += kCols * kWarp) {
    const int j = e / kCols, c = e % kCols;
    const long long col = col0 + c;
    uint32_t w = 0;
    if (col < B) {
      if (2 * j < rows) w = static_cast<uint32_t>(src[2LL * j * s + col]);
      if (2 * j + 1 < rows) w |= static_cast<uint32_t>(src[(2LL * j + 1) * s + col]) << 16;
    }
    tile[c * stride + off + j] = w;
  }
}

// The way back: thread (limb row i < rows, column c) writes limb i of the
// words at tile[c * stride + off] to dst, 8 columns of a row per sector.
template <int kCols>
__device__ __forceinline__ void unstage_limbs(int32_t* __restrict__ dst, long long s, int rows,
                                              const uint32_t* tile, int stride, int off,
                                              long long col0, int B) {
  for (int e = threadIdx.x; e < rows * kCols; e += kCols * kWarp) {
    const int i = e / kCols, c = e % kCols;
    const long long col = col0 + c;
    if (col < B) {
      const uint32_t w = tile[c * stride + off + i / 2];
      dst[static_cast<long long>(i) * s + col] =
          static_cast<int32_t>((i & 1) ? (w >> 16) : (w & 0xFFFFu));
    }
  }
}

}  // namespace dds
