// Three independent half-size products in one launch on Hopper (sm_90a):
// z0 = a0*b0, z2 = a1*b1, z1 = sa*sb, stacked as out = [z0 | z2 | z1].
//
// Replaces the TPU kernel dds_tpu/ops/mont_mxu.py::_make_prod3_kernel
// (:151-168, called through _prod3_call at :172), the product launch of the
// composed Karatsuba multiply prod_lm_k1 (DDS_KARATSUBA=1): the half sums'
// and the recombination's work stays outside, in ops/karatsuba.py.
//
// Layout: six limbs-major (h, B) int32 operands of canonical 16-bit
// little-endian limbs, each with its own row stride (a0 and a1 are row
// slices of one (L, B) operand), columns contiguous; out is (6h, B) int32
// with row stride `so`, three blocks of 2h canonical limbs. The Pallas
// kernel emitted redundant digits (its accumulator's own encoding); this
// one emits canonical limbs of the same values.
//
// One thread computes one column's three products: each operand packed into
// Wh = ceil(h/2) 32-bit words on load, a schoolbook product of Wh^2 word
// multiply-adds (64-bit accumulation) into 2 Wh words in local memory,
// then 2h limbs written out. At h = 128 that is 3 * 64^2 = 12,288 word
// products per column against 48 bytes of limbs moved per product row:
// at B = 4,096 the 25 MB of operands and results take longer at 3.35 TB/s
// than the products at the card's IMAD rate, so the bound is bytes. This
// first version is latency-bound instead, on each thread's serial carry
// chain through local memory, like mont_mul.cu.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHalfWords = 128;  // h up to 256 limbs (L up to 512)
constexpr int kThreads = 128;

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

// z = x * y for W-word x and y: 2W words.
__device__ __forceinline__ void mul_words(uint32_t* z, const uint32_t* x,
                                          const uint32_t* y, int W) {
  for (int k = 0; k < 2 * W; ++k) z[k] = 0;
  for (int i = 0; i < W; ++i) {
    const uint32_t xi = x[i];
    uint64_t c = 0;
    for (int j = 0; j < W; ++j) {
      const uint64_t s = static_cast<uint64_t>(xi) * y[j] + z[i + j] + c;
      z[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    z[i + W] = static_cast<uint32_t>(c);  // untouched until this step
  }
}

__global__ void __launch_bounds__(kThreads)
mont_prod3_kernel(const int32_t* __restrict__ a0, long long s_a0,
                  const int32_t* __restrict__ b0, long long s_b0,
                  const int32_t* __restrict__ a1, long long s_a1,
                  const int32_t* __restrict__ b1, long long s_b1,
                  const int32_t* __restrict__ sa, long long s_sa,
                  const int32_t* __restrict__ sb, long long s_sb,
                  int32_t* __restrict__ out, long long so,
                  int h, int Wh, int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;

  const int32_t* xs[3] = {a0, a1, sa};
  const int32_t* ys[3] = {b0, b1, sb};
  const long long sx[3] = {s_a0, s_a1, s_sa};
  const long long sy[3] = {s_b0, s_b1, s_sb};
  uint32_t x[kMaxHalfWords];
  uint32_t y[kMaxHalfWords];
  uint32_t z[2 * kMaxHalfWords];
  for (int p = 0; p < 3; ++p) {
    load_words(x, xs[p], sx[p], col, h, Wh);
    load_words(y, ys[p], sy[p], col, h, Wh);
    mul_words(z, x, y, Wh);
    int32_t* dst = out + static_cast<long long>(p) * 2 * h * so + col;
    for (int k = 0; k < 2 * h; ++k) {
      dst[k * so] = static_cast<int32_t>((z[k >> 1] >> (16 * (k & 1))) & 0xFFFFu);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// Each operand is limbs-major (h, B) int32 with its row stride; out is
// (6h, B) int32 with row stride so.
extern "C" int dds_mont_prod3(const int32_t* a0, long long s_a0,
                              const int32_t* b0, long long s_b0,
                              const int32_t* a1, long long s_a1,
                              const int32_t* b1, long long s_b1,
                              const int32_t* sa, long long s_sa,
                              const int32_t* sb, long long s_sb,
                              int32_t* out, long long so,
                              int h, int B, void* stream) {
  const int Wh = (h + 1) / 2;
  if (h < 1 || Wh > kMaxHalfWords || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (B + kThreads - 1) / kThreads;
  mont_prod3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a0, s_a0, b0, s_b0, a1, s_a1, b1, s_b1, sa, s_sa, sb, s_sb, out, so,
      h, Wh, B);
  return static_cast<int>(cudaGetLastError());
}
