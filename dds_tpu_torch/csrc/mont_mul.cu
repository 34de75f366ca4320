// Batched Montgomery product a*b*R^-1 mod n on Hopper (sm_90a).
//
// Replaces the TPU pair dds_tpu/ops/mont_mxu.py::_make_prod_kernel (the
// Pallas schoolbook product, :119-148) + its XLA reduction _redc
// (:543-571), and computes the same function as
// dds_tpu/ops/pallas_mont.py::_make_mul_kernel (fused CIOS, :131-149).
// The TPU split the product from the reduction because u32 multiplies are
// slow on its vector unit while int8 matmuls are nearly free; Hopper has a
// native 32x32->64 integer multiply-add, so one fused CIOS loop in 32-bit
// words is the simple design here.
//
// Layout: a, b and out are limbs-major (L, B) int32 arrays of 16-bit
// little-endian limbs. Row i of column j lives at i*stride + j, so a warp's
// threads read neighbouring words (coalesced), and a fold level passes the
// halves x[:, :h] and x[:, h:2h] as views (pointer offset, same stride).
// Limb pairs are packed into W = ceil(L/2) 32-bit words on load, so
// R = 2^(32 W): for even L the same R = 2^(16 L) the TPU kernels use.
//
// One thread computes one product. The accumulator t[W+2] and the packed
// b operand live in local memory (L1-cached): at W = 128 each thread does
// 2*W^2 + W word multiply-adds, about 2 IMAD instructions each, so the work
// is bound by integer multiplies (operations, not bytes) and this first
// version is further held back by its local-memory traffic, which a later
// version keeps in registers or shared memory.
//
// The result is canonical (< n): CIOS keeps t < 2n, and one conditional
// subtract of n finishes it. A second entry point, dds_mont_mul_nofinal,
// instantiates the same kernel without that subtraction (kFinalize).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 256;  // moduli up to 8192 bits (Paillier-4096 n^2)
constexpr int kThreads = 128;

// kFinalize = false is the probe of benchmarks/profile_kernel.py::
// make_nofinal_mul (:33-61), which runs pallas_mont._cios_loop without
// _finalize to measure the finalize's share of a multiply: the same loop,
// then t mod R (t < 2n) written out as it stands, no subtraction.
template <bool kFinalize>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int32_t* __restrict__ a, long long sa,
                const int32_t* __restrict__ b, long long sb,
                int32_t* __restrict__ out, long long so,
                const uint32_t* __restrict__ n, uint32_t n0inv,
                int L, int W, int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;

  uint32_t bw[kMaxWords];
  uint32_t t[kMaxWords + 2];
  for (int j = 0; j < W; ++j) {
    uint32_t w = static_cast<uint32_t>(b[(2LL * j) * sb + col]);
    if (2 * j + 1 < L) {
      w |= static_cast<uint32_t>(b[(2LL * j + 1) * sb + col]) << 16;
    }
    bw[j] = w;
    t[j] = 0;
  }
  t[W] = 0;
  t[W + 1] = 0;

  for (int i = 0; i < W; ++i) {
    uint32_t ai = static_cast<uint32_t>(a[(2LL * i) * sa + col]);
    if (2 * i + 1 < L) {
      ai |= static_cast<uint32_t>(a[(2LL * i + 1) * sa + col]) << 16;
    }
    // t += ai * b
    uint64_t c = 0;
    for (int j = 0; j < W; ++j) {
      const uint64_t s = static_cast<uint64_t>(ai) * bw[j] + t[j] + c;
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
    for (int j = 1; j < W; ++j) {
      s = static_cast<uint64_t>(m) * __ldg(&n[j]) + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[W]) + c;
    t[W - 1] = static_cast<uint32_t>(s);
    t[W] = t[W + 1] + static_cast<uint32_t>(s >> 32);
  }

  if constexpr (!kFinalize) {
    for (int j = 0; j < W; ++j) {
      out[(2LL * j) * so + col] = static_cast<int32_t>(t[j] & 0xFFFFu);
      if (2 * j + 1 < L) {
        out[(2LL * j + 1) * so + col] = static_cast<int32_t>(t[j] >> 16);
      }
    }
    return;
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
    out[(2LL * j) * so + col] = static_cast<int32_t>(w & 0xFFFFu);
    if (2 * j + 1 < L) {
      out[(2LL * j + 1) * so + col] = static_cast<int32_t>(w >> 16);
    }
  }
}

template <bool kFinalize>
int launch(const int32_t* a, long long sa, const int32_t* b, long long sb,
           int32_t* out, long long so, const uint32_t* n, unsigned int n0inv,
           int L, int B, void* stream) {
  const int W = (L + 1) / 2;
  if (L < 1 || W > kMaxWords || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (B + kThreads - 1) / kThreads;
  mont_mul_kernel<kFinalize>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          a, sa, b, sb, out, so, n, n0inv, L, W, B);
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
