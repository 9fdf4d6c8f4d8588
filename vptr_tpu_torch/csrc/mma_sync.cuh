// mma.sync building blocks shared by the two attention passes on the
// tensor cores: the window attention of kernels #1/#5
// (fused_window_attention.cuh, window_fwd_kernel) and the attention core's
// bf16 route, kernel #2 (attention_core.cu, attention_core_mma_kernel). The
// m16n8k16 bf16 product with f32 sums, the bf16 pair packing and the
// fragment loads from shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// d (16 x 8, f32) += A (16 x 16) B (16 x 8), bf16 fragments as PTX lays
// them out for m16n8k16: with g = lane / 4 and t = lane % 4, a[0..3] hold
// A[g][2t..], A[g + 8][2t..], A[g][2t + 8..], A[g + 8][2t + 8..]; b[0..1]
// B[2t..][g], B[2t + 8..][g] (two values each, the lower index in the low
// half); d[0..1] D[g][2t..], d[2..3] D[g + 8][2t..].
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Elements d and d + 1 of row p (zero past the head width hd, or when the
// row is not there): one 4-byte load where hd is even (PAIRS: a pair never
// straddles a head), two 2-byte loads otherwise.
template <bool PAIRS>
__device__ __forceinline__ uint32_t load_pair(const bf16* p, int d, int hd, bool row) {
  if constexpr (PAIRS) {
    return row && d < hd ? *reinterpret_cast<const uint32_t*>(p + d) : 0u;
  } else {
    const uint32_t lo = row && d < hd ? *reinterpret_cast<const uint16_t*>(p + d) : 0u;
    const uint32_t hi = row && d + 1 < hd ? *reinterpret_cast<const uint16_t*>(p + d + 1) : 0u;
    return lo | hi << 16;
  }
}

}  // namespace
