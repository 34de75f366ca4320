// One Karatsuba level of a*b in one launch on Hopper (sm_90a): the half
// sums, the three half products and the recombination, out = a*b.
//
// Replaces the TPU kernel dds_tpu/ops/mont_mxu.py::_make_kfused_kernel
// (:218-254, called through _kfused_call at :258), the product of the
// fused Karatsuba multiply prod_lm_kf (DDS_KARATSUBA=2), whose reduction
// is csrc/mont_redc.cu.
//
// With X = 2^(32 H), H = W/2 words per half (W = L/2), a = a0 + a1 X and
// b = b0 + b1 X:
//   sa = a0 + a1 and sb = b0 + b1, each H words plus a 0/1 overflow bit
//   (ca, cb); z0 = a0 b0, z2 = a1 b1, z1 = sa sb over the H-word parts;
//   z1full = z1 + (ca sb + cb sa) X + ca cb X^2 = (a0 + a1)(b0 + b1);
//   mid = z1full - z0 - z2 = a0 b1 + a1 b0 < 2 X^2 (2H + 1 words);
//   a*b = z0 + mid X + z2 X^2.
// The TPU kernel formed the middle term as a complement add, because its
// u32 lanes have no borrow chain (:198-215); here it is a subtract with
// borrow.
//
// Layout: a, b limbs-major (L, B) int32 canonical 16-bit limbs with row
// strides, columns contiguous; out (2L, B) int32 canonical. L must be a
// multiple of 4 so that each half is a whole number of 32-bit words (the
// wrapper only launches at even L with (L/2) % 8 == 0, the reference's
// shape rule).
//
// Bound and design: 3 H^2 word multiply-adds a column against 2 W^2 for
// the schoolbook product (12,288 at L = 256), bound by the card's integer
// multiply-add rate (operations); the 12.6 MB of operands and results at
// B = 4,096 move in half that time at 3.35 TB/s. One warp computes one
// column on the warp core of mont_warp.cuh:
// - each half product is dds::mul_half_warp over all 32 lanes at
//   HPL = words_per_lane(H) words a lane (2 at L = 256, 4 at L = 512), the
//   shifting schedule without m * n: x_i broadcast, x_i * y added
//   lane-locally, the word leaving lane 0 written to shared memory as
//   product word i, one lookahead at the end;
// - every multi-word add and subtract (the half sums, the overflow-bit
//   corrections, the two subtractions, the final add of mid at word H) is
//   one lane-local chain and one lookahead (dds::add_warp, dds::sub_warp).
//   The half sums and the recombination are the header's
//   dds::half_sum_warp and dds::karatsuba_recombine_warp, which
//   mont_k1.cu's launches of the composed variant (DDS_KARATSUBA=1) call
//   too: one copy, as the reference keeps one _karatsuba_combine;
// - operands and accumulators stay in registers, indexed only by
//   compile-time constants. Shared memory holds each column's staged a and
//   b, then the products: a half does not start on a lane boundary when H
//   is not a multiple of HPL (L = 36: W = 18, H = 9), so the halves are
//   redistributed by reading them back from shared memory at offset H.
// A block of 8 warps takes 8 adjacent columns; a and b come in, and T goes
// out, through shared memory with one 32-byte sector per limb row's 8
// columns, as mont_mul.cu stages its operands. Each column's row of the
// tile is [A | B | T]: A and B hold a and b (64 HPL words each), later z1
// (in A) and sa, sb (in B); T (128 HPL words) collects z0, z2 and the
// result. The row is 256 HPL + 4 words long, so staging is free of bank
// conflicts.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont_warp.cuh"

namespace {

constexpr int kCols = 8;  // warps (columns) per block
constexpr int kThreads = kCols * dds::kWarp;

template <int HPL>
__global__ void __launch_bounds__(kThreads)
mont_kfused_kernel(const int32_t* __restrict__ a, long long sa,
                   const int32_t* __restrict__ b, long long sb,
                   int32_t* __restrict__ out, long long so,
                   int L, int W, int B) {
  constexpr int kHalf = dds::kWarp * HPL;  // words an H-word number can hold
  constexpr int kA = 0, kB = 2 * kHalf, kT = 4 * kHalf;
  constexpr int kStride = 8 * kHalf + 4;   // words per staged column
  __shared__ uint32_t tile[kCols * kStride];
  const int warp = threadIdx.x / dds::kWarp;
  const int lane = threadIdx.x % dds::kWarp;
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;
  const int H = W / 2;

  // stage: thread (word j < W, column c) packs limbs 2j and 2j+1 of a and b
  for (int e = threadIdx.x; e < W * kCols; e += kThreads) {
    const int j = e / kCols, c = e % kCols;
    const long long col = col0 + c;
    uint32_t wa = 0, wb = 0;
    if (col < B) {
      wa = static_cast<uint32_t>(a[2LL * j * sa + col]) |
           (static_cast<uint32_t>(a[(2LL * j + 1) * sa + col]) << 16);
      wb = static_cast<uint32_t>(b[2LL * j * sb + col]) |
           (static_cast<uint32_t>(b[(2LL * j + 1) * sb + col]) << 16);
    }
    tile[c * kStride + kA + j] = wa;
    tile[c * kStride + kB + j] = wb;
  }
  __syncthreads();

  uint32_t* A = tile + warp * kStride + kA;
  uint32_t* Bw = tile + warp * kStride + kB;
  uint32_t* T = tile + warp * kStride + kT;
  uint32_t x[HPL], y[HPL];

  dds::load_lanes<HPL>(x, A, H, lane);          // a0
  dds::load_lanes<HPL>(y, Bw, H, lane);         // b0
  dds::mul_half_warp<HPL>(T, x, y, H, lane);    // z0 -> T[0, 2H)
  dds::load_lanes<HPL>(x, A + H, H, lane);      // a1
  dds::load_lanes<HPL>(y, Bw + H, H, lane);     // b1
  dds::mul_half_warp<HPL>(T + 2 * H, x, y, H, lane);  // z2 -> T[2H, 4H)

  // half sums and their overflow bits (dds::half_sum_warp): x holds a1,
  // y b1
  const uint32_t ca = dds::half_sum_warp<HPL>(x, A, H, lane);   // sa = x
  const uint32_t cb = dds::half_sum_warp<HPL>(y, Bw, H, lane);  // sb = y
  __syncwarp();  // a and b are read: A takes z1, B takes sa and sb
  dds::store_lanes<HPL>(Bw, x, H, lane);
  dds::store_lanes<HPL>(Bw + kHalf, y, H, lane);
  dds::mul_half_warp<HPL>(A, x, y, H, lane);    // z1 -> A[0, 2H)
  __syncwarp();
  dds::karatsuba_recombine_warp<HPL>(T, A, Bw, Bw + kHalf, ca, cb, H, lane);
  __syncthreads();

  // unstage: thread (limb row i < 2L, column c), 8 columns of a row per sector
  for (int e = threadIdx.x; e < 2 * L * kCols; e += kThreads) {
    const int i = e / kCols, c = e % kCols;
    const long long col = col0 + c;
    if (col < B) {
      const uint32_t w = tile[c * kStride + kT + i / 2];
      out[static_cast<long long>(i) * so + col] =
          static_cast<int32_t>((i & 1) ? (w >> 16) : (w & 0xFFFFu));
    }
  }
}

template <int HPL>
void launch_hpl(const int32_t* a, long long sa, const int32_t* b, long long sb,
                int32_t* out, long long so, int L, int W, int B, cudaStream_t stream) {
  const int grid = (B + kCols - 1) / kCols;
  mont_kfused_kernel<HPL><<<grid, kThreads, 0, stream>>>(a, sa, b, sb, out, so, L, W, B);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// a, b: limbs-major (L, B) int32 with row strides sa/sb, L a multiple of 4;
// out: (2L, B) int32 with row stride so.
extern "C" int dds_mont_kfused(const int32_t* a, long long sa,
                               const int32_t* b, long long sb,
                               int32_t* out, long long so,
                               int L, int B, void* stream) {
  const int W = L / 2;
  if (L < 4 || L % 4 != 0 || W > dds::kMaxWords || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (dds::words_per_lane(W / 2)) {  // H <= 128 words: 1, 2 or 4
    case 1: launch_hpl<1>(a, sa, b, sb, out, so, L, W, B, s); break;
    case 2: launch_hpl<2>(a, sa, b, sb, out, so, L, W, B, s); break;
    default: launch_hpl<4>(a, sa, b, sb, out, so, L, W, B, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
