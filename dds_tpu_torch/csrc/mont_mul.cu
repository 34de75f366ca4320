// Batched Montgomery product a*b*R^-1 mod n on Hopper (sm_90a).
//
// Replaces the TPU pair dds_tpu/ops/mont_mxu.py::_make_prod_kernel (the
// Pallas schoolbook product, :119-148) + its XLA reduction _redc
// (:543-571), and computes the same function as
// dds_tpu/ops/pallas_mont.py::_make_mul_kernel (fused CIOS, :131-149).
// The TPU split the product from the reduction because u32 multiplies are
// slow on its vector unit while int8 matmuls are nearly free; Hopper has a
// native 32x32->64 integer multiply-add, so one fused CIOS in 32-bit words
// is the design here.
//
// Layout: a, b and out are limbs-major (L, B) int32 arrays of 16-bit
// little-endian limbs. Row i of column j lives at i*stride + j, and a fold
// level passes the halves x[:, :h] and x[:, h:2h] as views (pointer
// offset, same stride). Limb pairs are packed into W = ceil(L/2) 32-bit
// words, so R = 2^(32 W): for even L the same R = 2^(16 L) the TPU kernels
// use.
//
// Bound and design: a product is 2 W^2 + W word multiply-adds, bound by
// integer operations (mont_warp.cuh). One warp computes one product with
// operands and accumulator in registers (dds::mont_mul_warp); a block of
// 8 warps takes 8 adjacent columns. One warp reading one column would
// fetch a 32-byte sector for every 4-byte limb, so the block stages both
// operands through shared memory: 8 threads read one limb row's 8 columns
// as one full sector, packing limb pairs into words, and each warp then
// reads its column's words from shared memory. The output goes back the
// same way. The staged column is 32 * WPL + 4 words long, so the 32
// (word, column) pairs a warp stages fall in 32 distinct banks.
//
// The result is canonical (< n): CIOS keeps t < 2n, and one conditional
// subtract of n finishes it. A second entry point, dds_mont_mul_nofinal,
// instantiates the same kernel without that subtraction (kFinalize).

#include <cstdint>
#include <cuda_runtime.h>

#include "mont_warp.cuh"

namespace {

constexpr int kCols = 8;  // warps (columns) per block
constexpr int kThreads = kCols * dds::kWarp;

// kFinalize = false is the probe of benchmarks/profile_kernel.py::
// make_nofinal_mul (:33-61), which runs pallas_mont._cios_loop without
// _finalize to measure the finalize's share of a multiply: the same loop,
// then t mod R (t < 2n) written out as it stands, no subtraction.
template <int WPL, bool kFinalize>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int32_t* __restrict__ a, long long sa,
                const int32_t* __restrict__ b, long long sb,
                int32_t* __restrict__ out, long long so,
                const uint32_t* __restrict__ n, uint32_t n0inv,
                int L, int W, int B) {
  constexpr int kStride = dds::kWarp * WPL + 4;  // words per staged column
  __shared__ uint32_t tile_a[kCols * kStride];
  __shared__ uint32_t tile_b[kCols * kStride];
  const int warp = threadIdx.x / dds::kWarp;
  const int lane = threadIdx.x % dds::kWarp;
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;

  // stage: thread (word j, column c) packs limbs 2j and 2j+1 of both
  // operands; words at and above W are zeros (the lanes' padding)
  for (int e = threadIdx.x; e < dds::kWarp * WPL * kCols; e += kThreads) {
    const int j = e / kCols, c = e % kCols;
    const long long col = col0 + c;
    uint32_t wa = 0, wb = 0;
    if (col < B && 2 * j < L) {
      wa = static_cast<uint32_t>(a[2LL * j * sa + col]);
      wb = static_cast<uint32_t>(b[2LL * j * sb + col]);
      if (2 * j + 1 < L) {
        wa |= static_cast<uint32_t>(a[(2LL * j + 1) * sa + col]) << 16;
        wb |= static_cast<uint32_t>(b[(2LL * j + 1) * sb + col]) << 16;
      }
    }
    tile_a[c * kStride + j] = wa;
    tile_b[c * kStride + j] = wb;
  }
  __syncthreads();

  uint32_t x[WPL], y[WPL], nw[WPL];
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    x[k] = tile_a[warp * kStride + WPL * lane + k];
    y[k] = tile_b[warp * kStride + WPL * lane + k];
  }
  dds::load_words<WPL>(nw, n, W, lane);
  dds::mont_mul_warp<WPL, kFinalize>(x, x, y, nw, n0inv, W, lane);

  __syncthreads();  // every warp has read its operands: reuse tile_a
#pragma unroll
  for (int k = 0; k < WPL; ++k) tile_a[warp * kStride + WPL * lane + k] = x[k];
  __syncthreads();

  // unstage: thread (limb row i, column c), 8 columns of a row per sector
  for (int e = threadIdx.x; e < L * kCols; e += kThreads) {
    const int i = e / kCols, c = e % kCols;
    const long long col = col0 + c;
    if (col < B) {
      const uint32_t w = tile_a[c * kStride + i / 2];
      out[static_cast<long long>(i) * so + col] =
          static_cast<int32_t>((i & 1) ? (w >> 16) : (w & 0xFFFFu));
    }
  }
}

template <int WPL, bool kFinalize>
void launch_wpl(const int32_t* a, long long sa, const int32_t* b, long long sb,
                int32_t* out, long long so, const uint32_t* n, uint32_t n0inv,
                int L, int W, int B, cudaStream_t stream) {
  const int grid = (B + kCols - 1) / kCols;
  mont_mul_kernel<WPL, kFinalize><<<grid, kThreads, 0, stream>>>(
      a, sa, b, sb, out, so, n, n0inv, L, W, B);
}

template <bool kFinalize>
int launch(const int32_t* a, long long sa, const int32_t* b, long long sb,
           int32_t* out, long long so, const uint32_t* n, unsigned int n0inv,
           int L, int B, void* stream) {
  const int W = (L + 1) / 2;
  if (L < 1 || W > dds::kMaxWords || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (dds::words_per_lane(W)) {
    case 1: launch_wpl<1, kFinalize>(a, sa, b, sb, out, so, n, n0inv, L, W, B, s); break;
    case 2: launch_wpl<2, kFinalize>(a, sa, b, sb, out, so, n, n0inv, L, W, B, s); break;
    case 4: launch_wpl<4, kFinalize>(a, sa, b, sb, out, so, n, n0inv, L, W, B, s); break;
    default: launch_wpl<8, kFinalize>(a, sa, b, sb, out, so, n, n0inv, L, W, B, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// n: W = ceil(L/2) little-endian 32-bit words of the modulus, on the device.
// n0inv: -n^-1 mod 2^32.
extern "C" int dds_mont_mul(const int32_t* a, long long sa,
                            const int32_t* b, long long sb,
                            int32_t* out, long long so,
                            const uint32_t* n, unsigned int n0inv,
                            int L, int B, void* stream) {
  return launch<true>(a, sa, b, sb, out, so, n, n0inv, L, B, stream);
}

// The same loop without the final subtraction: out = the low L limbs of
// t = (a*b + m*n) / R < 2n, not reduced below n.
extern "C" int dds_mont_mul_nofinal(const int32_t* a, long long sa,
                                    const int32_t* b, long long sb,
                                    int32_t* out, long long so,
                                    const uint32_t* n, unsigned int n0inv,
                                    int L, int B, void* stream) {
  return launch<false>(a, sa, b, sb, out, so, n, n0inv, L, B, stream);
}
