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
//
//   for i < W: m = t_i * n0' mod 2^32; t += m * n * 2^(32 i)
//   (word i becomes 0); then t / R = words [W, 2W], below 2n, and one
//   conditional subtract of n.
//
// m is the unique m < R with T + m*n = 0 mod R, so for even L, where
// R = 2^(32 W) = 2^(16 L), the result equals _redc's bit for bit.
//
// Layout: T limbs-major (2L, B) int32 canonical 16-bit limbs with row
// stride st, columns contiguous; out (L, B) int32 canonical with row
// stride so; n the W = ceil(L/2) little-endian words of the modulus.
//
// One thread reduces one column: t (2W + 1 words) in local memory, W^2 + W
// word multiply-adds with 64-bit accumulation (16,512 at W = 128), so the
// bound is the card's IMAD rate (operations). This first version is
// latency-bound on each thread's serial carry chain, like mont_mul.cu.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 256;  // moduli up to 8192 bits (Paillier-4096 n^2)
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mont_redc_kernel(const int32_t* __restrict__ T, long long st,
                 int32_t* __restrict__ out, long long so,
                 const uint32_t* __restrict__ n, uint32_t n0inv,
                 int L, int W, int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;

  uint32_t t[2 * kMaxWords + 1];
  for (int j = 0; j < 2 * W; ++j) {
    uint32_t v = 0;
    if (2 * j < 2 * L) v = static_cast<uint32_t>(T[(2LL * j) * st + col]);
    if (2 * j + 1 < 2 * L) {
      v |= static_cast<uint32_t>(T[(2LL * j + 1) * st + col]) << 16;
    }
    t[j] = v;
  }

  // step i adds m*n at word offset i; its carry out of word i + W waits in
  // `top` and joins word i + W + 1 at step i + 1, the first step to add
  // there
  uint32_t top = 0;
  for (int i = 0; i < W; ++i) {
    const uint32_t m = t[i] * n0inv;
    uint64_t c = 0;
    for (int j = 0; j < W; ++j) {
      const uint64_t s = static_cast<uint64_t>(m) * __ldg(&n[j]) + t[i + j] + c;
      t[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    const uint64_t s = static_cast<uint64_t>(t[i + W]) + c + top;
    t[i + W] = static_cast<uint32_t>(s);
    top = static_cast<uint32_t>(s >> 32);
  }
  const uint32_t* r = t + W;  // (T + m*n) / R < 2n: r[0, W) and the bit `top`

  // subtract n once when r >= n
  uint32_t borrow = 0;
  for (int j = 0; j < W; ++j) {
    const uint64_t d = static_cast<uint64_t>(r[j]) - __ldg(&n[j]) - borrow;
    borrow = static_cast<uint32_t>(d >> 63);
  }
  const bool take_diff = (top != 0) || (borrow == 0);
  borrow = 0;
  for (int j = 0; j < W; ++j) {
    uint32_t w = r[j];
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
  if (L < 1 || W > kMaxWords || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (B + kThreads - 1) / kThreads;
  mont_redc_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      T, st, out, so, n, n0inv, L, W, B);
  return static_cast<int>(cudaGetLastError());
}
