// The composed Karatsuba multiply's two launches around B4 on Hopper
// (sm_90a): the half sums before csrc/mont_prod3.cu and the recombination
// after it (DDS_KARATSUBA=1: half sums, B4, recombination, then
// csrc/mont_redc.cu).
//
// Replaces XLA code of the reference, not a Pallas kernel: in
// dds_tpu/ops/mont_mxu.py::prod_lm_k1 (:321-383), carry_norm (:406) of the
// half sums a0 + a1 and b0 + b1, and after _prod3_call the carry_norm of z0
// and z2 and _karatsuba_combine (:188-215).
//
// With h = L/2 limbs and H = h/2 words a half (L a multiple of 4, so each
// half is whole words), X = 2^(16h), a = a0 + a1 X and b = b0 + b1 X:
// - dds_k1_halfsums: canonical limbs-major (L, B) int32 a and b (row
//   strides; column slices allowed) -> (2h + 2, B) int32 rows
//   [sa | sb | ca | cb], sa = (a0 + a1) mod X and ca its 0/1 overflow bit,
//   the same for b. B4 reads sa and sb as row slices of it.
// - dds_k1_combine: B4's (6h, B) [z0 | z2 | z1] and the half sums ->
//   the canonical (2L, B) int32 product a*b = z0 + mid X + z2 X^2, with
//   mid = z1 + (ca sb + cb sa) X + ca cb X^2 - z0 - z2, by subtract with
//   borrow where the reference adds complements; canonical limbs are
//   unique, so the integers are equal.
//
// Bound: bytes. A column moves 2L + 2h + 2 int32 rows in the half sums
// (12.6 MB at L = 256, B = 4,096: 3.8 us at 3.35 TB/s) and 8h + 2 + 2L in
// the recombination (25 MB: 7.5 us); their adds are a few per word. The
// design keeps each column's words in one pass through shared memory and
// registers, as mont_kfused.cu (B5) does for the same arithmetic:
// - one warp a column, 8 columns a block; operands staged through shared
//   memory, 8 adjacent columns of a limb row one 32-byte sector
//   (dds::stage_limbs), the result unstaged the same way;
// - the arithmetic is B5's own, from mont_warp.cuh: dds::half_sum_warp
//   (one lane-local chain and one lookahead a sum) and
//   dds::karatsuba_recombine_warp (the overflow-bit corrections, two
//   subtractions and the add at word H, each one chain and one lookahead)
//   over the same [A | B | T] row B5 uses: z1 in A, sa and sb in B, z0 and
//   z2 in T, so both Karatsuba variants run one copy of the recombination.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont_warp.cuh"

namespace {

constexpr int kCols = 8;  // warps (columns) per block
constexpr int kThreads = kCols * dds::kWarp;

template <int HPL>
__global__ void __launch_bounds__(kThreads)
mont_k1_halfsums_kernel(const int32_t* __restrict__ a, long long sa,
                        const int32_t* __restrict__ b, long long sb,
                        int32_t* __restrict__ out, long long so, int L, int B) {
  constexpr int kHalf = dds::kWarp * HPL;  // words an H-word number can hold
  constexpr int kA = 0, kB = 2 * kHalf, kC = 4 * kHalf;  // kC: ca, cb
  constexpr int kStride = 4 * kHalf + 4;   // words per staged column
  __shared__ uint32_t tile[kCols * kStride];
  const int warp = threadIdx.x / dds::kWarp;
  const int lane = threadIdx.x % dds::kWarp;
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;
  const int h = L / 2, H = L / 4;

  dds::stage_limbs<kCols>(tile, kStride, kA, a, sa, L, 2 * H, col0, B);
  dds::stage_limbs<kCols>(tile, kStride, kB, b, sb, L, 2 * H, col0, B);
  __syncthreads();

  uint32_t* A = tile + warp * kStride + kA;
  uint32_t* Bw = tile + warp * kStride + kB;
  uint32_t x[HPL], y[HPL];
  dds::load_lanes<HPL>(x, A + H, H, lane);   // a1
  dds::load_lanes<HPL>(y, Bw + H, H, lane);  // b1
  const uint32_t ca = dds::half_sum_warp<HPL>(x, A, H, lane);   // sa = x
  const uint32_t cb = dds::half_sum_warp<HPL>(y, Bw, H, lane);  // sb = y
  __syncwarp();  // a and b are read: their rows take sa and sb
  dds::store_lanes<HPL>(A, x, H, lane);
  dds::store_lanes<HPL>(Bw, y, H, lane);
  if (lane == 0) {
    tile[warp * kStride + kC] = ca;
    tile[warp * kStride + kC + 1] = cb;
  }
  __syncthreads();

  dds::unstage_limbs<kCols>(out, so, h, tile, kStride, kA, col0, B);
  dds::unstage_limbs<kCols>(out + h * so, so, h, tile, kStride, kB, col0, B);
  dds::unstage_limbs<kCols>(out + 2 * h * so, so, 1, tile, kStride, kC, col0, B);
  dds::unstage_limbs<kCols>(out + (2 * h + 1) * so, so, 1, tile, kStride, kC + 1, col0, B);
}

template <int HPL>
__global__ void __launch_bounds__(kThreads)
mont_k1_combine_kernel(const int32_t* __restrict__ z, long long sz,
                       const int32_t* __restrict__ s, long long ss,
                       int32_t* __restrict__ out, long long so, int L, int B) {
  constexpr int kHalf = dds::kWarp * HPL;  // words an H-word number can hold
  constexpr int kA = 0, kB = 2 * kHalf, kT = 4 * kHalf, kC = 8 * kHalf;
  constexpr int kStride = 8 * kHalf + 4;   // words per staged column, as in B5
  __shared__ uint32_t tile[kCols * kStride];
  const int warp = threadIdx.x / dds::kWarp;
  const int lane = threadIdx.x % dds::kWarp;
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;
  const int h = L / 2, H = L / 4;

  // [A | B | T | ca cb]: z1 in A, sa and sb in B, z0 and z2 in T
  dds::stage_limbs<kCols>(tile, kStride, kA, z + 4LL * h * sz, sz, 2 * h, 2 * H, col0, B);
  dds::stage_limbs<kCols>(tile, kStride, kB, s, ss, h, H, col0, B);
  dds::stage_limbs<kCols>(tile, kStride, kB + kHalf, s + 1LL * h * ss, ss, h, H, col0, B);
  dds::stage_limbs<kCols>(tile, kStride, kT, z, sz, 2 * h, 2 * H, col0, B);
  dds::stage_limbs<kCols>(tile, kStride, kT + 2 * H, z + 2LL * h * sz, sz, 2 * h, 2 * H,
                          col0, B);
  dds::stage_limbs<kCols>(tile, kStride, kC, s + 2LL * h * ss, ss, 2, 1, col0, B);
  __syncthreads();

  uint32_t* row = tile + warp * kStride;
  const uint32_t ca = row[kC] & 0xFFFFu, cb = row[kC] >> 16;
  dds::karatsuba_recombine_warp<HPL>(row + kT, row + kA, row + kB, row + kB + kHalf, ca, cb,
                                     H, lane);
  __syncthreads();

  dds::unstage_limbs<kCols>(out, so, 2 * L, tile, kStride, kT, col0, B);
}

template <int HPL>
void launch_halfsums(const int32_t* a, long long sa, const int32_t* b, long long sb,
                     int32_t* out, long long so, int L, int B, cudaStream_t stream) {
  const int grid = (B + kCols - 1) / kCols;
  mont_k1_halfsums_kernel<HPL><<<grid, kThreads, 0, stream>>>(a, sa, b, sb, out, so, L, B);
}

template <int HPL>
void launch_combine(const int32_t* z, long long sz, const int32_t* s, long long ss,
                    int32_t* out, long long so, int L, int B, cudaStream_t stream) {
  const int grid = (B + kCols - 1) / kCols;
  mont_k1_combine_kernel<HPL><<<grid, kThreads, 0, stream>>>(z, sz, s, ss, out, so, L, B);
}

bool bad_shape(int L, int B) {
  return L < 4 || L % 4 != 0 || L / 2 > dds::kMaxWords || B < 1;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// a, b: limbs-major (L, B) int32 with row strides sa/sb, L a multiple of 4,
// L <= 512; out: (L + 2, B) int32 with row stride so, [sa | sb | ca | cb].
extern "C" int dds_k1_halfsums(const int32_t* a, long long sa,
                               const int32_t* b, long long sb,
                               int32_t* out, long long so,
                               int L, int B, void* stream) {
  if (bad_shape(L, B)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dds::words_per_lane(L / 4)) {  // H <= 128 words: 1, 2 or 4
    case 1: launch_halfsums<1>(a, sa, b, sb, out, so, L, B, st); break;
    case 2: launch_halfsums<2>(a, sa, b, sb, out, so, L, B, st); break;
    default: launch_halfsums<4>(a, sa, b, sb, out, so, L, B, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// z: (3L, B) int32 [z0 | z2 | z1] (B4's output) with row stride sz; s:
// (L + 2, B) int32 half sums with row stride ss; out: (2L, B) int32 with
// row stride so.
extern "C" int dds_k1_combine(const int32_t* z, long long sz,
                              const int32_t* s, long long ss,
                              int32_t* out, long long so,
                              int L, int B, void* stream) {
  if (bad_shape(L, B)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dds::words_per_lane(L / 4)) {
    case 1: launch_combine<1>(z, sz, s, ss, out, so, L, B, st); break;
    case 2: launch_combine<2>(z, sz, s, ss, out, so, L, B, st); break;
    default: launch_combine<4>(z, sz, s, ss, out, so, L, B, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
