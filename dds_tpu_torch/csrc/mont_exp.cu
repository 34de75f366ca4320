// Batched shared-exponent modular exponentiation on Hopper (sm_90a), in the
// Montgomery domain: out = base^exp for every column, one exponent for all.
//
// Replaces the TPU kernel dds_tpu/ops/pallas_mont.py::_make_exp_kernel
// (:152-199, called through _exp_call / exp_lm), and with the wrapper's two
// mont_mul launches around it computes pallas_mont.pow_mod and
// mont_mxu.pow_mod2: Paillier's obfuscators r^n mod n^2 for bulk
// encryption. The Pallas kernel kept a 16-entry window table and the
// accumulator in VMEM for a whole tile; here one thread walks one row's
// whole ladder:
//
//   table[0] = R mod n, table[1] = base, table[d] = table[d-1] * base
//   (14 products); then, from r = R mod n, for each MSB-first 4-bit digit
//   d: r = r^2 four times, r = r * table[d] (5 products per digit).
//
// The digits are a device array read at run time, never a compile-time
// constant, so one build serves every exponent. A digit is taken mod 16
// (the wrapper only passes digits in [0, 16)), so no digit can index past
// the table.
//
// Layout: base and out are limbs-major (L, B) int32 arrays of 16-bit
// little-endian limbs with a row stride, as in mont_mul.cu, so a warp reads
// neighbouring columns. The product is the same 32-bit-word CIOS as
// mont_mul.cu, W = ceil(L/2) words, R = 2^(32 W): at even L the R = 2^(16 L)
// of the TPU kernels, so Montgomery-domain outputs match exp_lm bit for bit.
//
// Memory: the table is 16 * W words per row (8 KiB at W = 128), too large
// for registers; it lives in a global scratch of (16, W, B) uint32 that the
// wrapper allocates, word-major, so thread j reads word i of entry d at
// (d * W + i) * B + j and a warp's reads coalesce. The entry a digit selects
// is copied into the thread's operand array once per digit. The accumulator
// and operand arrays live in local memory (L1-cached).
//
// Bound: every product is 2 W^2 + W word multiply-adds of about 2 IMADs;
// at W = 128 and 5 E + 14 products per row that is integer multiplies
// (operations), with the table traffic far below the memory bound. This
// first version is held back well above that bound by the serial carry
// chain of each thread's products through local memory: one launch takes
// about (5 E + 14) times one product's latency, whatever B is.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 256;  // moduli up to 8192 bits (Paillier-4096 n^2)
constexpr int kThreads = 128;
constexpr int kTable = 16;      // 4-bit window

// Pack column `col` of a limbs-major (L, *) array of 16-bit limbs with row
// stride `s` into W 32-bit words.
__device__ __forceinline__ void load_words(uint32_t* w, const int32_t* x,
                                           long long s, int col, int L, int W) {
  for (int j = 0; j < W; ++j) {
    uint32_t v = static_cast<uint32_t>(x[(2LL * j) * s + col]);
    if (2 * j + 1 < L) {
      v |= static_cast<uint32_t>(x[(2LL * j + 1) * s + col]) << 16;
    }
    w[j] = v;
  }
}

// r = a * b * R^-1 mod n (CIOS), canonical (< n) in and out. r may alias a
// and b: the result is written only after the last read of either.
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b,
                                         const uint32_t* __restrict__ n,
                                         uint32_t n0inv, int W) {
  uint32_t t[kMaxWords + 2];
  for (int j = 0; j < W + 2; ++j) t[j] = 0;

  for (int i = 0; i < W; ++i) {
    const uint32_t ai = a[i];
    // t += ai * b
    uint64_t c = 0;
#pragma unroll 4
    for (int j = 0; j < W; ++j) {
      const uint64_t s = static_cast<uint64_t>(ai) * b[j] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[W]) + c;
    t[W] = static_cast<uint32_t>(s);
    t[W + 1] = static_cast<uint32_t>(s >> 32);

    // t = (t + m*n) / 2^32 with m = t[0] * n0' mod 2^32 (low word cancels)
    const uint32_t m = t[0] * n0inv;
    s = static_cast<uint64_t>(m) * __ldg(&n[0]) + t[0];
    c = s >> 32;
#pragma unroll 4
    for (int j = 1; j < W; ++j) {
      s = static_cast<uint64_t>(m) * __ldg(&n[j]) + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[W]) + c;
    t[W - 1] = static_cast<uint32_t>(s);
    t[W] = t[W + 1] + static_cast<uint32_t>(s >> 32);
  }

  // t < 2n: subtract n once when t >= n
  uint32_t borrow = 0;
  for (int j = 0; j < W; ++j) {
    const uint64_t d = static_cast<uint64_t>(t[j]) - __ldg(&n[j]) - borrow;
    borrow = static_cast<uint32_t>(d >> 63);
  }
  const bool take_diff = (t[W] != 0) || (borrow == 0);
  borrow = 0;
  for (int j = 0; j < W; ++j) {
    uint32_t w = t[j];
    if (take_diff) {
      const uint64_t d = static_cast<uint64_t>(w) - __ldg(&n[j]) - borrow;
      w = static_cast<uint32_t>(d);
      borrow = static_cast<uint32_t>(d >> 63);
    }
    r[j] = w;
  }
}

__global__ void __launch_bounds__(kThreads)
mont_exp_kernel(const int32_t* __restrict__ base, long long sb,
                int32_t* __restrict__ out, long long so,
                uint32_t* __restrict__ table,
                const int32_t* __restrict__ digits, int E,
                const uint32_t* __restrict__ n,
                const int32_t* __restrict__ one_mont, uint32_t n0inv,
                int L, int W, int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;

  uint32_t acc[kMaxWords];
  uint32_t op[kMaxWords];
  const long long entry = static_cast<long long>(W) * B;  // words per entry
  uint32_t* tab = table + col;

  // table[0] = R mod n, table[1] = base, table[d] = table[d-1] * base
  load_words(op, one_mont, 1, 0, L, W);
  for (int j = 0; j < W; ++j) tab[static_cast<long long>(j) * B] = op[j];
  load_words(op, base, sb, col, L, W);
  for (int j = 0; j < W; ++j) {
    tab[entry + static_cast<long long>(j) * B] = op[j];
    acc[j] = op[j];
  }
  for (int d = 2; d < kTable; ++d) {
    mont_mul(acc, acc, op, n, n0inv, W);
    uint32_t* dst = tab + d * entry;
    for (int j = 0; j < W; ++j) dst[static_cast<long long>(j) * B] = acc[j];
  }

  // r = R mod n; per digit: 4 squarings, then one multiply by table[digit]
  load_words(acc, one_mont, 1, 0, L, W);
  for (int e = 0; e < E; ++e) {
    for (int k = 0; k < 4; ++k) mont_mul(acc, acc, acc, n, n0inv, W);
    const int d = __ldg(&digits[e]) & (kTable - 1);
    const uint32_t* src = tab + d * entry;
    for (int j = 0; j < W; ++j) op[j] = src[static_cast<long long>(j) * B];
    mont_mul(acc, acc, op, n, n0inv, W);
  }

  for (int j = 0; j < W; ++j) {
    out[(2LL * j) * so + col] = static_cast<int32_t>(acc[j] & 0xFFFFu);
    if (2 * j + 1 < L) {
      out[(2LL * j + 1) * so + col] = static_cast<int32_t>(acc[j] >> 16);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// base/out: limbs-major (L, B) int32 with row strides sb/so; table: device
// scratch of 16 * W * B uint32 (W = ceil(L/2)); digits: E device int32
// MSB-first 4-bit digits; n: W little-endian 32-bit words of the modulus;
// one_mont: (L,) int32 limbs of R mod n; n0inv: -n^-1 mod 2^32.
extern "C" int dds_mont_exp(const int32_t* base, long long sb,
                            int32_t* out, long long so, uint32_t* table,
                            const int32_t* digits, int E, const uint32_t* n,
                            const int32_t* one_mont, unsigned int n0inv,
                            int L, int B, void* stream) {
  const int W = (L + 1) / 2;
  if (L < 1 || W > kMaxWords || B < 1 || E < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (B + kThreads - 1) / kThreads;
  mont_exp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      base, sb, out, so, table, digits, E, n, one_mont, n0inv, L, W, B);
  return static_cast<int>(cudaGetLastError());
}
