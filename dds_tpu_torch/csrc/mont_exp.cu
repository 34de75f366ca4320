// Batched shared-exponent modular exponentiation on Hopper (sm_90a), in the
// Montgomery domain: out = base^exp for every column, one exponent for all.
//
// Replaces the TPU kernel dds_tpu/ops/pallas_mont.py::_make_exp_kernel
// (:152-199, called through _exp_call / exp_lm), and with the wrapper's two
// mont_mul launches around it computes pallas_mont.pow_mod and
// mont_mxu.pow_mod2: Paillier's obfuscators r^n mod n^2 for bulk
// encryption. The Pallas kernel kept a 16-entry window table and the
// accumulator in VMEM for a whole tile; here one warp walks one row's
// whole ladder:
//
//   table[0] = R mod n, table[1] = base, table[d] = table[d-1] * base
//   (14 products); then, from r = R mod n, for each MSB-first 4-bit digit
//   d: r = r^2 four times, r = r * table[d] (5 products per digit).
//
// The digits are a device array read at run time (warp-uniformly), never a
// compile-time constant, so one build serves every exponent. A digit is
// taken mod 16 (the wrapper only passes digits in [0, 16)), so no digit can
// index past the table.
//
// Layout: base and out are limbs-major (L, B) int32 arrays of 16-bit
// little-endian limbs with a row stride, as in mont_mul.cu. The product is
// the same 32-bit-word CIOS, W = ceil(L/2) words, R = 2^(32 W): at even L
// the R = 2^(16 L) of the TPU kernels, so Montgomery-domain outputs match
// exp_lm bit for bit.
//
// Bound and design: every row is 5 E + 14 products of 2 W^2 + W word
// multiply-adds, bound by integer operations (mont_warp.cuh); the table
// and the bases are far below the memory bound. Each product is
// dds::mont_mul_warp, one warp with the accumulator in registers. The
// row's 16-entry table lives in shared memory, 16 * 32 * WPL words (8 KiB
// a row at W = 128, 16 KiB at W = 256), laid out so that word k of lane l
// in entry d sits at (d * WPL + k) * 32 + l: each lane reads and writes
// only its own words, bank-conflict-free, straight into the product's
// operand registers. A block holds kRows rows in dynamic shared memory
// (64 KiB at W = 256, above the 48 KB default: the launch raises the
// kernel's limit). Nothing goes to device memory but the bases and the
// result.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont_warp.cuh"

namespace {

constexpr int kRows = 4;    // warps (rows) per block
constexpr int kThreads = kRows * dds::kWarp;
constexpr int kTable = 16;  // 4-bit window

template <int WPL>
constexpr int kTableWords = kTable * WPL * dds::kWarp;  // per row

template <int WPL>
__global__ void __launch_bounds__(kThreads)
mont_exp_kernel(const int32_t* __restrict__ base, long long sb,
                int32_t* __restrict__ out, long long so,
                const int32_t* __restrict__ digits, int E,
                const uint32_t* __restrict__ n,
                const int32_t* __restrict__ one_mont, uint32_t n0inv,
                int L, int W, int B) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x / dds::kWarp;
  const int lane = threadIdx.x % dds::kWarp;
  const long long col = static_cast<long long>(blockIdx.x) * kRows + warp;
  if (col >= B) return;  // warp-uniform; no block-wide barrier below
  uint32_t* tab = smem + warp * kTableWords<WPL> + lane;

  uint32_t nw[WPL], x[WPL], acc[WPL];
  dds::load_words<WPL>(nw, n, W, lane);

  // table[0] = R mod n, table[1] = base, table[d] = table[d-1] * base
  dds::load_limbs<WPL>(acc, one_mont, 1, 0, L, lane);
#pragma unroll
  for (int k = 0; k < WPL; ++k) tab[k * dds::kWarp] = acc[k];
  dds::load_limbs<WPL>(x, base, sb, col, L, lane);
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    tab[(WPL + k) * dds::kWarp] = x[k];
    acc[k] = x[k];
  }
  for (int d = 2; d < kTable; ++d) {
    dds::mont_mul_warp<WPL>(acc, acc, x, nw, n0inv, W, lane);
#pragma unroll
    for (int k = 0; k < WPL; ++k) tab[(d * WPL + k) * dds::kWarp] = acc[k];
  }

  // r = R mod n; per digit: 4 squarings, then one multiply by table[digit]
#pragma unroll
  for (int k = 0; k < WPL; ++k) acc[k] = tab[k * dds::kWarp];
  for (int e = 0; e < E; ++e) {
    for (int s = 0; s < 4; ++s) dds::mont_mul_warp<WPL>(acc, acc, acc, nw, n0inv, W, lane);
    const int d = __ldg(&digits[e]) & (kTable - 1);
#pragma unroll
    for (int k = 0; k < WPL; ++k) x[k] = tab[(d * WPL + k) * dds::kWarp];
    dds::mont_mul_warp<WPL>(acc, acc, x, nw, n0inv, W, lane);
  }

  dds::store_limbs<WPL>(out, so, col, L, acc, lane);
}

template <int WPL>
cudaError_t launch_wpl(const int32_t* base, long long sb, int32_t* out,
                       long long so, const int32_t* digits, int E,
                       const uint32_t* n, const int32_t* one_mont,
                       uint32_t n0inv, int L, int W, int B,
                       cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(uint32_t) * kRows * kTableWords<WPL>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mont_exp_kernel<WPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (B + kRows - 1) / kRows;
  mont_exp_kernel<WPL><<<grid, kThreads, kSmem, stream>>>(
      base, sb, out, so, digits, E, n, one_mont, n0inv, L, W, B);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// base/out: limbs-major (L, B) int32 with row strides sb/so; digits: E
// device int32 MSB-first 4-bit digits; n: W = ceil(L/2) little-endian
// 32-bit words of the modulus; one_mont: (L,) int32 limbs of R mod n;
// n0inv: -n^-1 mod 2^32.
extern "C" int dds_mont_exp(const int32_t* base, long long sb,
                            int32_t* out, long long so,
                            const int32_t* digits, int E, const uint32_t* n,
                            const int32_t* one_mont, unsigned int n0inv,
                            int L, int B, void* stream) {
  const int W = (L + 1) / 2;
  if (L < 1 || W > dds::kMaxWords || B < 1 || E < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dds::words_per_lane(W)) {
    case 1: err = launch_wpl<1>(base, sb, out, so, digits, E, n, one_mont, n0inv, L, W, B, s); break;
    case 2: err = launch_wpl<2>(base, sb, out, so, digits, E, n, one_mont, n0inv, L, W, B, s); break;
    case 4: err = launch_wpl<4>(base, sb, out, so, digits, E, n, one_mont, n0inv, L, W, B, s); break;
    default: err = launch_wpl<8>(base, sb, out, so, digits, E, n, one_mont, n0inv, L, W, B, s); break;
  }
  return static_cast<int>(err);
}
