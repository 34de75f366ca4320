// Batched Montgomery reduction out = T * R^-1 mod n on Hopper (sm_90a), for
// a full product T < n*R: the second half of a Karatsuba multiply, after
// csrc/mont_prod3.cu (with the PyTorch combine of ops/karatsuba.py) or
// csrc/mont_kfused.cu.
//
// Replaces dds_tpu/ops/mont_mxu.py::_redc (:543-571), which is XLA code,
// not a Pallas kernel: m = T*N' mod R and (T + m*N)/R as int8 band
// matmuls against Toeplitz matrices of the modulus digits, with
// Kogge-Stone carry passes between them, because int8 matmuls are nearly
// free on the TPU while its u32 multiplies are slow. Hopper has a native
// 32x32->64 integer multiply-add, so the reduction here is word-serial:
// W steps of m = t_0 * n0' mod 2^32, t += m * n, t /= 2^32, then
// (T + m*n) / R < 2n and one conditional subtract of n. m is the unique
// m < R with T + m*n = 0 mod R, so for even L, where R = 2^(32 W) =
// 2^(16 L), the result equals _redc's bit for bit.
//
// Layout: T limbs-major (2L, B) int32 canonical 16-bit limbs with row
// stride st, columns contiguous; out (L, B) int32 canonical with row
// stride so; n the W = ceil(L/2) little-endian words of the modulus.
//
// Bound and design: W^2 + W word multiply-adds a column (16,512 at
// W = 128), bound by the card's integer multiply-add rate (operations);
// T and the result (12.6 MB at L = 256, B = 4,096) take a third of that
// time at 3.35 TB/s. One warp reduces one column (dds::mont_redc_warp in
// mont_warp.cuh): lane l holds words [WPL*l, WPL*l + WPL) of T mod R, n and
// the accumulator in registers, one lane-local chain per step and one
// lookahead at the end, so a step is WPL multiply-adds per lane and the
// column's W^2 chain is spread over 32 lanes. A block of 8 warps takes 8
// adjacent columns and stages T through shared memory as mont_mul.cu
// stages its operands: 8 threads read one limb row's 8 columns as one
// 32-byte sector, packing limb pairs into words; each column's T mod R
// sits at [0, W) and T / R at [32 WPL, 32 WPL + W) of its staged row, so
// every lane reads its own words of either half. The result goes back the
// same way. The staged column is 64 WPL + 4 words long, so the 32
// (word, column) pairs a warp stages fall in 32 distinct banks.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont_warp.cuh"

namespace {

constexpr int kCols = 8;  // warps (columns) per block
constexpr int kThreads = kCols * dds::kWarp;

template <int WPL>
__global__ void __launch_bounds__(kThreads)
mont_redc_kernel(const int32_t* __restrict__ T, long long st,
                 int32_t* __restrict__ out, long long so,
                 const uint32_t* __restrict__ n, uint32_t n0inv,
                 int L, int W, int B) {
  constexpr int kHalf = dds::kWarp * WPL;    // words of one staged half
  constexpr int kStride = 2 * kHalf + 4;     // words per staged column
  __shared__ uint32_t tile[kCols * kStride];
  const int warp = threadIdx.x / dds::kWarp;
  const int lane = threadIdx.x % dds::kWarp;
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;

  // stage: thread (word j < 2W, column c) packs limbs 2j and 2j+1 of T;
  // word j of T mod R goes to j, word j of T / R to kHalf + j
  for (int e = threadIdx.x; e < 2 * W * kCols; e += kThreads) {
    const int j = e / kCols, c = e % kCols;
    const long long col = col0 + c;
    uint32_t w = 0;
    if (col < B && 2 * j < 2 * L) {
      w = static_cast<uint32_t>(T[2LL * j * st + col]);
      if (2 * j + 1 < 2 * L) w |= static_cast<uint32_t>(T[(2LL * j + 1) * st + col]) << 16;
    }
    tile[c * kStride + (j < W ? j : kHalf + j - W)] = w;
  }
  __syncthreads();

  uint32_t* mine = tile + warp * kStride;
  uint32_t t[WPL], h[WPL], nw[WPL];
  dds::load_lanes<WPL>(t, mine, W, lane);
  dds::load_lanes<WPL>(h, mine + kHalf, W, lane);
  dds::load_words<WPL>(nw, n, W, lane);
  dds::mont_redc_warp<WPL>(t, h, nw, n0inv, W, lane);
  __syncwarp();  // every lane has read this column's T: reuse its row
  dds::store_lanes<WPL>(mine, t, W, lane);
  __syncthreads();

  // unstage: thread (limb row i, column c), 8 columns of a row per sector
  for (int e = threadIdx.x; e < L * kCols; e += kThreads) {
    const int i = e / kCols, c = e % kCols;
    const long long col = col0 + c;
    if (col < B) {
      const uint32_t w = tile[c * kStride + i / 2];
      out[static_cast<long long>(i) * so + col] =
          static_cast<int32_t>((i & 1) ? (w >> 16) : (w & 0xFFFFu));
    }
  }
}

template <int WPL>
void launch_wpl(const int32_t* T, long long st, int32_t* out, long long so,
                const uint32_t* n, uint32_t n0inv, int L, int W, int B,
                cudaStream_t stream) {
  const int grid = (B + kCols - 1) / kCols;
  mont_redc_kernel<WPL><<<grid, kThreads, 0, stream>>>(T, st, out, so, n, n0inv, L, W, B);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// T: (2L, B) int32 with row stride st, value < n*R; out: (L, B) with row
// stride so; n: W = ceil(L/2) little-endian words of the modulus on the
// device; n0inv: -n^-1 mod 2^32.
extern "C" int dds_mont_redc(const int32_t* T, long long st,
                             int32_t* out, long long so,
                             const uint32_t* n, unsigned int n0inv,
                             int L, int B, void* stream) {
  const int W = (L + 1) / 2;
  if (L < 1 || W > dds::kMaxWords || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (dds::words_per_lane(W)) {
    case 1: launch_wpl<1>(T, st, out, so, n, n0inv, L, W, B, s); break;
    case 2: launch_wpl<2>(T, st, out, so, n, n0inv, L, W, B, s); break;
    case 4: launch_wpl<4>(T, st, out, so, n, n0inv, L, W, B, s); break;
    default: launch_wpl<8>(T, st, out, so, n, n0inv, L, W, B, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
