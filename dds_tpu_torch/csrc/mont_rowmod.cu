// Montgomery product and window ladder with ONE MODULUS A COLUMN, on Hopper
// (sm_90a): the device math of the Sanctum decrypt (the CRT legs of
// Paillier decryption, moduli p^2 and q^2 stacked in one batch).
//
// Replaces the reference's XLA device math, which has no Pallas twin:
// - dds_mont_mul_rowmod: dds_tpu/ops/montgomery.py::_mont_mul_rowmod_raw
//   (:115), a*b*R^-1 mod N_i for every column i;
// - dds_mont_exp_rowmod: montgomery.py::_mont_exp_rowdigits_raw (:155), the
//   4-bit-window ladder with a modulus and an exponent digit column a row.
// Three launches of them (entry by R^2, the ladder, exit by 1) compute
// dds_tpu/sanctum/device.py::_fused_crt_raw (:95); the wrapper
// (ops/mont_cuda.py mul_rowmod, exp_rowmod) and the plan
// (sanctum/device.py) lay the two legs out as columns.
//
// These are mont_mul.cu's and mont_exp.cu's kernels with the modulus words
// read at n + col * W ((B, W) words, one row a column), n0inv[col], and for
// the ladder one_mont (L, B) limbs-major and digits[e * sd + col]: the same
// product core (dds::mont_mul_warp), the same staging and the same table
// layout. One warp is one column, so a column's digit is warp-uniform. A
// digit is taken mod 16, so no digit can index past the table.
//
// Secrets: the moduli, n0inv, R^2, R mod N and the exponent digits are
// runtime kernel ARGUMENTS (device arrays), never template arguments,
// #defines or other compile-time constants. The library is built from this
// source text and its flags alone (keyed by their hash), so one build
// serves every key and no compiled file holds a secret.
//
// Layout: a, b, base, one_mont and out are limbs-major (L, B) int32 arrays
// of 16-bit little-endian limbs with a row stride; a column slice is a
// pointer offset with the same stride. W = ceil(L/2) 32-bit words,
// R = 2^(32 W): at even L the R = 2^(16 L) of the reference, so
// Montgomery-domain values match it bit for bit.
//
// Bound and design: a product is 2 W^2 + W word multiply-adds, bound by
// integer operations (mont_warp.cuh); a ladder column is 5 E + 14
// products (the table, then 4 squarings and 1 multiply a digit). The
// per-column modulus costs one W-word read a column (coalesced: lane l
// reads words [WPL l, WPL l + WPL)) and the ladder keeps it in registers
// for all its products; nothing else changes against the shared-modulus
// kernels. The ladder's 16-entry table lives in shared memory as in
// mont_exp.cu: word k of lane l in entry d at (d * WPL + k) * 32 + l, each
// lane reading only its own words, bank-conflict-free.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont_warp.cuh"

namespace {

constexpr int kCols = 8;  // the product: warps (columns) per block
constexpr int kMulThreads = kCols * dds::kWarp;
constexpr int kRows = 4;  // the ladder: warps (columns) per block
constexpr int kExpThreads = kRows * dds::kWarp;
constexpr int kTable = 16;  // 4-bit window

template <int WPL>
constexpr int kTableWords = kTable * WPL * dds::kWarp;  // per column

// mont_mul.cu's staged product with column col's own modulus. The block
// stages both operands through shared memory (8 columns of a limb row are
// one 32-byte sector), each warp multiplies its column, and the result goes
// back the same way. A warp past B computes on zero operands with the last
// column's modulus and stores nothing: the block barriers need it.
template <int WPL>
__global__ void __launch_bounds__(kMulThreads)
mont_mul_rowmod_kernel(const int32_t* __restrict__ a, long long sa,
                       const int32_t* __restrict__ b, long long sb,
                       int32_t* __restrict__ out, long long so,
                       const uint32_t* __restrict__ n,
                       const uint32_t* __restrict__ n0inv,
                       int L, int W, int B) {
  constexpr int kStride = dds::kWarp * WPL + 4;  // words per staged column
  __shared__ uint32_t tile_a[kCols * kStride];
  __shared__ uint32_t tile_b[kCols * kStride];
  const int warp = threadIdx.x / dds::kWarp;
  const int lane = threadIdx.x % dds::kWarp;
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;

  // stage: thread (word j, column c) packs limbs 2j and 2j+1 of both
  // operands; words at and above W are zeros (the lanes' padding)
  for (int e = threadIdx.x; e < dds::kWarp * WPL * kCols; e += kMulThreads) {
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
  // a warp past B reads the last column's modulus
  const long long mcol = col0 + warp < B ? col0 + warp : B - 1;
  dds::load_words<WPL>(nw, n + mcol * W, W, lane);
  dds::mont_mul_warp<WPL>(x, x, y, nw, __ldg(&n0inv[mcol]), W, lane);

  __syncthreads();  // every warp has read its operands: reuse tile_a
#pragma unroll
  for (int k = 0; k < WPL; ++k) tile_a[warp * kStride + WPL * lane + k] = x[k];
  __syncthreads();

  // unstage: thread (limb row i, column c), 8 columns of a row per sector
  for (int e = threadIdx.x; e < L * kCols; e += kMulThreads) {
    const int i = e / kCols, c = e % kCols;
    const long long col = col0 + c;
    if (col < B) {
      const uint32_t w = tile_a[c * kStride + i / 2];
      out[static_cast<long long>(i) * so + col] =
          static_cast<int32_t>((i & 1) ? (w >> 16) : (w & 0xFFFFu));
    }
  }
}

// mont_exp.cu's ladder with column col's own modulus, identity R mod N_col
// and digit column.
template <int WPL>
__global__ void __launch_bounds__(kExpThreads)
mont_exp_rowmod_kernel(const int32_t* __restrict__ base, long long sb,
                       int32_t* __restrict__ out, long long so,
                       const int32_t* __restrict__ digits, long long sd, int E,
                       const uint32_t* __restrict__ n,
                       const uint32_t* __restrict__ n0inv,
                       const int32_t* __restrict__ one_mont, long long s1,
                       int L, int W, int B) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x / dds::kWarp;
  const int lane = threadIdx.x % dds::kWarp;
  const long long col = static_cast<long long>(blockIdx.x) * kRows + warp;
  if (col >= B) return;  // warp-uniform; no block-wide barrier below
  uint32_t* tab = smem + warp * kTableWords<WPL> + lane;

  uint32_t nw[WPL], x[WPL], acc[WPL];
  dds::load_words<WPL>(nw, n + col * W, W, lane);
  const uint32_t n0 = __ldg(&n0inv[col]);

  // table[0] = R mod N, table[1] = base, table[d] = table[d-1] * base
  dds::load_limbs<WPL>(acc, one_mont, s1, col, L, lane);
#pragma unroll
  for (int k = 0; k < WPL; ++k) tab[k * dds::kWarp] = acc[k];
  dds::load_limbs<WPL>(x, base, sb, col, L, lane);
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    tab[(WPL + k) * dds::kWarp] = x[k];
    acc[k] = x[k];
  }
  for (int d = 2; d < kTable; ++d) {
    dds::mont_mul_warp<WPL>(acc, acc, x, nw, n0, W, lane);
#pragma unroll
    for (int k = 0; k < WPL; ++k) tab[(d * WPL + k) * dds::kWarp] = acc[k];
  }

  // r = R mod N; per digit: 4 squarings, then one multiply by table[digit]
#pragma unroll
  for (int k = 0; k < WPL; ++k) acc[k] = tab[k * dds::kWarp];
  for (int e = 0; e < E; ++e) {
    for (int s = 0; s < 4; ++s) dds::mont_mul_warp<WPL>(acc, acc, acc, nw, n0, W, lane);
    const int d = __ldg(&digits[e * sd + col]) & (kTable - 1);
#pragma unroll
    for (int k = 0; k < WPL; ++k) x[k] = tab[(d * WPL + k) * dds::kWarp];
    dds::mont_mul_warp<WPL>(acc, acc, x, nw, n0, W, lane);
  }

  dds::store_limbs<WPL>(out, so, col, L, acc, lane);
}

template <int WPL>
void launch_mul(const int32_t* a, long long sa, const int32_t* b, long long sb,
                int32_t* out, long long so, const uint32_t* n, const uint32_t* n0inv,
                int L, int W, int B, cudaStream_t stream) {
  const int grid = (B + kCols - 1) / kCols;
  mont_mul_rowmod_kernel<WPL><<<grid, kMulThreads, 0, stream>>>(
      a, sa, b, sb, out, so, n, n0inv, L, W, B);
}

template <int WPL>
cudaError_t launch_exp(const int32_t* base, long long sb, int32_t* out, long long so,
                       const int32_t* digits, long long sd, int E, const uint32_t* n,
                       const uint32_t* n0inv, const int32_t* one_mont, long long s1,
                       int L, int W, int B, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(uint32_t) * kRows * kTableWords<WPL>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mont_exp_rowmod_kernel<WPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (B + kRows - 1) / kRows;
  mont_exp_rowmod_kernel<WPL><<<grid, kExpThreads, kSmem, stream>>>(
      base, sb, out, so, digits, sd, E, n, n0inv, one_mont, s1, L, W, B);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// a, b, out: limbs-major (L, B) int32 with row strides sa, sb, so; n: (B, W)
// little-endian 32-bit words, row i the modulus of column i, W = ceil(L/2);
// n0inv: (B,) -n_i^-1 mod 2^32; all on the device.
extern "C" int dds_mont_mul_rowmod(const int32_t* a, long long sa,
                                   const int32_t* b, long long sb,
                                   int32_t* out, long long so,
                                   const uint32_t* n, const uint32_t* n0inv,
                                   int L, int B, void* stream) {
  const int W = (L + 1) / 2;
  if (L < 1 || W > dds::kMaxWords || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (dds::words_per_lane(W)) {
    case 1: launch_mul<1>(a, sa, b, sb, out, so, n, n0inv, L, W, B, s); break;
    case 2: launch_mul<2>(a, sa, b, sb, out, so, n, n0inv, L, W, B, s); break;
    case 4: launch_mul<4>(a, sa, b, sb, out, so, n, n0inv, L, W, B, s); break;
    default: launch_mul<8>(a, sa, b, sb, out, so, n, n0inv, L, W, B, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// base, out: limbs-major (L, B) int32 (row strides sb, so), base in each
// column's Montgomery domain; digits: (E, B) int32 MSB-first 4-bit digits,
// row stride sd, column i the exponent of column i; n, n0inv as for
// dds_mont_mul_rowmod; one_mont: (L, B) int32 limbs of R mod n_i, row
// stride s1. out = base^exp in the Montgomery domain.
extern "C" int dds_mont_exp_rowmod(const int32_t* base, long long sb,
                                   int32_t* out, long long so,
                                   const int32_t* digits, long long sd, int E,
                                   const uint32_t* n, const uint32_t* n0inv,
                                   const int32_t* one_mont, long long s1,
                                   int L, int B, void* stream) {
  const int W = (L + 1) / 2;
  if (L < 1 || W > dds::kMaxWords || B < 1 || E < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dds::words_per_lane(W)) {
    case 1: err = launch_exp<1>(base, sb, out, so, digits, sd, E, n, n0inv, one_mont, s1, L, W, B, s); break;
    case 2: err = launch_exp<2>(base, sb, out, so, digits, sd, E, n, n0inv, one_mont, s1, L, W, B, s); break;
    case 4: err = launch_exp<4>(base, sb, out, so, digits, sd, E, n, n0inv, one_mont, s1, L, W, B, s); break;
    default: err = launch_exp<8>(base, sb, out, so, digits, sd, E, n, n0inv, one_mont, s1, L, W, B, s); break;
  }
  return static_cast<int>(err);
}
