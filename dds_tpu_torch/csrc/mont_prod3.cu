// Three independent half-size products in one launch on Hopper (sm_90a):
// z0 = a0*b0, z2 = a1*b1, z1 = sa*sb, stacked as out = [z0 | z2 | z1].
//
// Replaces the TPU kernel dds_tpu/ops/mont_mxu.py::_make_prod3_kernel
// (:151-168, called through _prod3_call at :172), the product launch of the
// composed Karatsuba multiply prod_lm_k1 (DDS_KARATSUBA=1). The half sums
// before it and the recombination after it are the two launches of
// csrc/mont_k1.cu.
//
// Layout: six limbs-major (h, B) int32 operands of canonical 16-bit
// little-endian limbs, each with its own row stride (a0 and a1 are row
// slices of one (L, B) operand, sa and sb of the half sums' tensor; a
// column slice of a fold level is allowed), columns contiguous; out is
// (6h, B) int32 with row stride `so`, three blocks of 2h canonical limbs,
// for every h from 1 to 256. The Pallas kernel emitted redundant digits
// (its accumulator's own encoding); this one emits canonical limbs of the
// same values.
//
// Bound: 3 H^2 word multiply-adds a column, H = ceil(h/2) words (12,288 at
// h = 128, 6.0 us at B = 4,096 at the card's IMAD rate), against 12h int32
// rows in and out a column (25 MB at B = 4,096, 7.5 us at 3.35 TB/s): the
// bound is bytes. Design, as mont_kfused.cu builds B5's three products:
// - one warp a column, 8 columns a block. The six operands are staged
//   through shared memory (dds::stage_limbs: 8 adjacent columns of a limb
//   row are one 32-byte sector, packed into words), so every load from
//   device memory is a full sector and every store of the result too;
// - each product is one dds::mul_half_warp at HPL = words_per_lane(H)
//   words a lane (1, 2 or 4; 2 at h = 128): x and y go to registers with
//   load_lanes, then x_i is broadcast and x_i * y added lane-locally, the
//   word leaving lane 0 written to shared memory as product word i, one
//   lookahead at the end. Operands and accumulator stay in registers,
//   indexed only by compile-time constants;
// - a product overwrites the two staged operands it came from ([x | y],
//   2 * 32 HPL >= 2H words), which are in registers by then: a __syncwarp()
//   between the loads and the product keeps a lane's early dst writes off
//   words another lane has yet to read. So a column's row is 6 * 32 HPL + 4
//   words (24,704 bytes a block at HPL = 4), 4 mod 32 so that staging is
//   free of bank conflicts;
// - odd h: an operand's top word holds one limb, zero-padded on staging;
//   the product's 2h limbs are its low 2H words' limbs below 2h.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont_warp.cuh"

namespace {

constexpr int kCols = 8;  // warps (columns) per block
constexpr int kThreads = kCols * dds::kWarp;

struct Operands {
  const int32_t* p[6];  // a0, b0, a1, b1, sa, sb
  long long s[6];       // their row strides
};

template <int HPL>
__global__ void __launch_bounds__(kThreads)
mont_prod3_kernel(const Operands ops, int32_t* __restrict__ out, long long so, int h,
                  int B) {
  constexpr int kSlot = dds::kWarp * HPL;  // words an H-word operand can hold
  constexpr int kStride = 6 * kSlot + 4;   // words per staged column
  __shared__ uint32_t tile[kCols * kStride];
  const int warp = threadIdx.x / dds::kWarp;
  const int lane = threadIdx.x % dds::kWarp;
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;
  const int H = (h + 1) / 2;

  // slots [a0 | b0 | a1 | b1 | sa | sb]: product p reads slots 2p, 2p + 1
#pragma unroll
  for (int o = 0; o < 6; ++o) {
    dds::stage_limbs<kCols>(tile, kStride, o * kSlot, ops.p[o], ops.s[o], h, H, col0, B);
  }
  __syncthreads();

  uint32_t* row = tile + warp * kStride;
  uint32_t x[HPL], y[HPL];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    uint32_t* slot = row + 2 * p * kSlot;
    dds::load_lanes<HPL>(x, slot, H, lane);
    dds::load_lanes<HPL>(y, slot + kSlot, H, lane);
    __syncwarp();  // every lane holds its x and y: the product may overwrite them
    dds::mul_half_warp<HPL>(slot, x, y, H, lane);
  }
  __syncthreads();

#pragma unroll
  for (int p = 0; p < 3; ++p) {
    dds::unstage_limbs<kCols>(out + 2LL * p * h * so, so, 2 * h, tile, kStride,
                              2 * p * kSlot, col0, B);
  }
}

template <int HPL>
void launch_hpl(const Operands& ops, int32_t* out, long long so, int h, int B,
                cudaStream_t stream) {
  const int grid = (B + kCols - 1) / kCols;
  mont_prod3_kernel<HPL><<<grid, kThreads, 0, stream>>>(ops, out, so, h, B);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// Each operand is limbs-major (h, B) int32 with its row stride; out is
// (6h, B) int32 with row stride so; 1 <= h <= 256.
extern "C" int dds_mont_prod3(const int32_t* a0, long long s_a0,
                              const int32_t* b0, long long s_b0,
                              const int32_t* a1, long long s_a1,
                              const int32_t* b1, long long s_b1,
                              const int32_t* sa, long long s_sa,
                              const int32_t* sb, long long s_sb,
                              int32_t* out, long long so,
                              int h, int B, void* stream) {
  const int H = (h + 1) / 2;
  if (h < 1 || H > dds::kMaxWords / 2 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operands ops{{a0, b0, a1, b1, sa, sb}, {s_a0, s_b0, s_a1, s_b1, s_sa, s_sb}};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dds::words_per_lane(H)) {  // H <= 128 words: 1, 2 or 4
    case 1: launch_hpl<1>(ops, out, so, h, B, s); break;
    case 2: launch_hpl<2>(ops, out, so, h, B, s); break;
    default: launch_hpl<4>(ops, out, so, h, B, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
