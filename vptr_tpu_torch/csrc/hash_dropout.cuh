// Counter-hash dropout shared by the attention kernels (device functions).
//
// The TPU kernels draw their attention-weight dropout from a counter hash
// (vptr_tpu/ops/attention_core.py::_hash_uniform, :65-116): a weight's keep
// decision is a pure function of (seed, element index), so a backward
// kernel regenerates its forward's mask from the seed with no saved state.
// This is the same arithmetic in uint32 (which wraps like jnp.uint32); its
// torch twin is vptr_tpu_torch/ops/dropout.py. The element index is
//     ((b * H + h) * Tq + r) * Tk + c
// with b the global batch or window index (the window kernels index their
// tokens by the padded count, see dropout.py::padded_tokens). A kernel that
// holds a subset of the heads (tensor parallelism: heads h0 .. h0 + Hl - 1
// of Hg) indexes by the global head: ((b * Hg + h0 + h) * Tq + r) * Tk + c
// (Params::index). The feed-forward kernels index their hidden by row * H
// + col (#7/#8: rows of x; #9/#10: (sample * HW + r), channels); one that
// holds hidden columns c0 .. c0 + Hl - 1 of Hg indexes row * Hg + c0 + col
// (Params::col_index).
#pragma once

#include <stdint.h>

namespace vptr_dropout {

// uniform [0, 1) from the element index and the seed: the murmur3-style
// finalizer, then the top 24 bits as the mantissa (exact in float).
__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t seed) {
  uint32_t x = idx + seed * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ uint32_t element_index(uint32_t b, uint32_t heads, uint32_t h,
                                                  uint32_t tq, uint32_t r, uint32_t tk,
                                                  uint32_t c) {
  return ((b * heads + h) * tq + r) * tk + c;
}

// Dropout parameters a kernel receives: the seed lives in device memory
// (an int32 the caller drew on the card, so drawing it needs no host
// synchronisation); rate and the divisor (float)(1 - rate) come from the
// host. active is false at rate 0, and then no weight is touched.
// mask_heads and head0: the global head count and the first head of a
// kernel that holds a subset of the heads (0, 0: the kernel's own heads);
// in the feed-forward kernels the global column count and the first
// column of a subset of the hidden columns.
struct Params {
  const int* seed;
  float rate;
  float keep_div;
  int mask_heads;
  int head0;
  __device__ __forceinline__ bool active() const { return rate > 0.f; }
  __device__ __forceinline__ uint32_t seed_u32() const {
    return static_cast<uint32_t>(*seed);
  }
  // element_index of head h of the kernel's `heads`, by the global head
  __device__ __forceinline__ uint32_t index(uint32_t b, uint32_t heads, uint32_t h,
                                            uint32_t tq, uint32_t r, uint32_t tk,
                                            uint32_t c) const {
    return element_index(b, mask_heads ? static_cast<uint32_t>(mask_heads) : heads,
                         static_cast<uint32_t>(head0) + h, tq, r, tk, c);
  }
  // row * cols + c of a kernel over `cols` hidden columns, by the global
  // column: row * Hg + c0 + c
  __device__ __forceinline__ uint32_t col_index(uint32_t row, uint32_t cols, uint32_t c) const {
    return row * (mask_heads ? static_cast<uint32_t>(mask_heads) : cols) +
           static_cast<uint32_t>(head0) + c;
  }
  __device__ __forceinline__ bool keep(uint32_t idx, uint32_t s) const {
    return hash_uniform(idx, s) >= rate;
  }
  // w / (1 - rate) where kept, else 0: a division, as the TPU kernels do
  // (a multiply by the reciprocal is not bit-equal)
  __device__ __forceinline__ float apply(float w, bool kept) const {
    return kept ? w / keep_div : 0.f;
  }
  // The same quotient without a division: q = w rcp with rcp = 1 / keep_div
  // (rounded once, by the caller), then one correction by the exact
  // remainder w - q keep_div (an fma): Markstein's step, which rounds to
  // the correctly rounded w / keep_div for w and quotients in the normal
  // range, with no slow-path branch.
  __device__ __forceinline__ float apply_rcp(float w, bool kept, float rcp) const {
    const float q = w * rcp;
    return kept ? fmaf(fmaf(-q, keep_div, w), rcp, q) : 0.f;
  }
};

}  // namespace vptr_dropout
