// One Karatsuba level of a*b in one launch on Hopper (sm_90a): the half
// sums, the three half products and the recombination, out = a*b.
//
// Replaces the TPU kernel dds_tpu/ops/mont_mxu.py::_make_kfused_kernel
// (:218-254, called through _kfused_call at :258), the product of the
// fused Karatsuba multiply prod_lm_kf (DDS_KARATSUBA=2), whose reduction
// is csrc/mont_redc.cu.
//
// With X = 2^(16h), h = L/2, a = a0 + a1 X and b = b0 + b1 X:
//   sa = a0 + a1 and sb = b0 + b1, each h limbs plus a 0/1 overflow bit
//   (ca, cb); z0 = a0 b0, z2 = a1 b1, z1 = sa sb over the h-limb parts;
//   z1full = z1 + (ca sb + cb sa) X + ca cb X^2 = (a0 + a1)(b0 + b1);
//   a*b = z0 + (z1full - z0 - z2) X + z2 X^2.
// The TPU kernel formed the middle term as a complement add, because its
// u32 lanes have no borrow chain (:198-215); here it is a plain subtract
// with borrow in 32-bit words. The middle term a0 b1 + a1 b0 is below
// 2^(32 h + 1), so it fits 2H + 1 words (H = h/2 words per half).
//
// Layout: a, b limbs-major (L, B) int32 canonical 16-bit limbs with row
// strides, columns contiguous; out (2L, B) int32 canonical. L must be a
// multiple of 4 so that each half is a whole number of 32-bit words (the
// wrapper only launches at even L with (L/2) % 8 == 0, the reference's
// shape rule).
//
// One thread computes one column: a and b packed into W = L/2 words, z0
// and z2 written straight into the result's two halves, z1 beside them, all
// in local memory (5 KiB of stack at the 256-word maximum). 3 H^2 word
// multiply-adds with 64-bit accumulation, against 2 W^2 for the schoolbook
// product: at L = 256 that is 12,288 word products per column, bound by the
// card's IMAD rate (operations), the 12 MB of operands and results at
// B = 4,096 being faster at 3.35 TB/s. This first version is latency-bound
// on each thread's serial carry chains through local memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 256;  // L up to 512 limbs (Paillier-4096 n^2)
constexpr int kThreads = 128;

__device__ __forceinline__ void load_words(uint32_t* w, const int32_t* x,
                                           long long s, int col, int W) {
  for (int j = 0; j < W; ++j) {
    w[j] = static_cast<uint32_t>(x[(2LL * j) * s + col]) |
           (static_cast<uint32_t>(x[(2LL * j + 1) * s + col]) << 16);
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

// x[0, H) = x[0, H) + x[H, 2H); returns the carry out (0 or 1).
__device__ __forceinline__ uint32_t half_sum(uint32_t* x, int H) {
  uint64_t c = 0;
  for (int j = 0; j < H; ++j) {
    const uint64_t s = static_cast<uint64_t>(x[j]) + x[H + j] + c;
    x[j] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  return static_cast<uint32_t>(c);
}

// z[H, 2H] += (y[0, H) & mask), carrying into z[2H + 1]; mask is 0 or ~0.
__device__ __forceinline__ void add_masked(uint32_t* z, const uint32_t* y,
                                           uint32_t mask, int H) {
  uint64_t c = 0;
  for (int j = 0; j < H; ++j) {
    const uint64_t s = static_cast<uint64_t>(z[H + j]) + (y[j] & mask) + c;
    z[H + j] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  for (int k = 2 * H; k <= 2 * H + 1; ++k) {
    const uint64_t s = static_cast<uint64_t>(z[k]) + c;
    z[k] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
}

// z[0, 2H + 2) -= y[0, 2H), borrowing through the top words.
__device__ __forceinline__ void sub_words(uint32_t* z, const uint32_t* y, int H) {
  uint32_t borrow = 0;
  for (int k = 0; k < 2 * H + 2; ++k) {
    const uint64_t d = static_cast<uint64_t>(z[k]) - (k < 2 * H ? y[k] : 0u) - borrow;
    z[k] = static_cast<uint32_t>(d);
    borrow = static_cast<uint32_t>(d >> 63);
  }
}

__global__ void __launch_bounds__(kThreads)
mont_kfused_kernel(const int32_t* __restrict__ a, long long sa,
                   const int32_t* __restrict__ b, long long sb,
                   int32_t* __restrict__ out, long long so,
                   int L, int W, int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  const int H = W / 2;  // words per half

  uint32_t x[kMaxWords];
  uint32_t y[kMaxWords];
  uint32_t T[2 * kMaxWords];
  uint32_t z1[kMaxWords + 2];
  load_words(x, a, sa, col, W);
  load_words(y, b, sb, col, W);

  mul_words(T, x, y, H);                  // z0 = a0 b0 -> T[0, 2H)
  mul_words(T + 2 * H, x + H, y + H, H);  // z2 = a1 b1 -> T[2H, 4H)

  const uint32_t ca = half_sum(x, H);     // sa -> x[0, H)
  const uint32_t cb = half_sum(y, H);     // sb -> y[0, H)
  mul_words(z1, x, y, H);                 // z1 = sa sb, 2H words
  z1[2 * H] = ca & cb;
  z1[2 * H + 1] = 0;
  add_masked(z1, y, 0u - ca, H);          // + ca sb X
  add_masked(z1, x, 0u - cb, H);          // + cb sa X

  sub_words(z1, T, H);                    // - z0
  sub_words(z1, T + 2 * H, H);            // - z2: the middle term, >= 0

  // T += mid X: mid is 2H + 1 words at word offset H; the carry ends
  // inside T because a*b < 2^(32 * 4H)
  uint64_t c = 0;
  for (int k = 0; k < 2 * H + 1; ++k) {
    const uint64_t s = static_cast<uint64_t>(T[H + k]) + z1[k] + c;
    T[H + k] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  for (int k = 3 * H + 1; k < 4 * H; ++k) {
    const uint64_t s = static_cast<uint64_t>(T[k]) + c;
    T[k] = static_cast<uint32_t>(s);
    c = s >> 32;
  }

  for (int k = 0; k < 2 * W; ++k) {
    out[(2LL * k) * so + col] = static_cast<int32_t>(T[k] & 0xFFFFu);
    out[(2LL * k + 1) * so + col] = static_cast<int32_t>(T[k] >> 16);
  }
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
  if (L < 4 || L % 4 != 0 || W > kMaxWords || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (B + kThreads - 1) / kThreads;
  mont_kfused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, sa, b, sb, out, so, L, W, B);
  return static_cast<int>(cudaGetLastError());
}
