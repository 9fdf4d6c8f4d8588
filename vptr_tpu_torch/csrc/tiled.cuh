// What the "tiled" routes of the whole-sample LayerNorm kernels share
// (dw_tiled.cuh: #9/#10 fused_dw_chain; conv_ln_tiled.cuh: #11/#12
// conv_ln_gelu): a sample too large for one block or one cluster is cut
// into tiles of equal size, each tile's block writes its partial moments
// (or partial sums) into device memory, and a second kernel merges a
// sample's partials into its statistics (tiled_stats; where a
// tensor-parallel share of the dw chain's channels ends in a partial tile,
// dw_tiled.cuh's dwt_stats_uneven). Every sum is in a fixed order
// (a thread's own values in turn, lanes by a shuffle tree, warps in order,
// tiles in order; no atomics), so two calls give the same bits.
#pragma once

#include "tile_ops.cuh"

namespace {

constexpr int kTThreads = 256;                 // a block of the tiled kernels
constexpr int kTWarps = kTThreads / 32;

// v[i] <- the sum of v[i] over the block (NV values): lanes by shuffle,
// then the warps in order; every thread gets the same bits. red holds NV
// x kTWarps floats; the block may call again at once.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float (*red)[kTWarps]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) red[i][warp] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = 0.f;
    for (int w = 0; w < kTWarps; ++w) s += red[i][w];
    v[i] = s;
  }
  __syncthreads();                     // red is read before the next call writes it
}

// A sample's statistics from its T tiles' partials, part (N, T, 2), one
// block a sample, into out (N, 2):
//   kTMoments: part holds each tile's (mean, M2) of cnt values; out =
//     (mean, rstd) over the T cnt values: the mean of the tile means, then
//     M2 = sum_t M2_t + cnt (mean_t - mean)^2 (Chan's merge; here every
//     tile is of one size, cnt: dw_tiled.cuh's dwt_stats_uneven weighs
//     tiles of two sizes), rstd = rsqrt(M2 / (T cnt) + eps);
//   kTSums: part holds each tile's two plain sums; out = the two sums over
//     the sample divided by T cnt (the means).
enum TStats { kTMoments = 0, kTSums = 1 };

__global__ void __launch_bounds__(kTThreads)
tiled_stats_kernel(const float* __restrict__ part, float* __restrict__ out, int T, float cnt,
                   float eps, int mode) {
  __shared__ float red[2][kTWarps];
  const float* p = part + 2L * T * blockIdx.x;
  const float inv_n = 1.f / (static_cast<float>(T) * cnt);
  float v[2] = {0.f, 0.f};
  for (int t = threadIdx.x; t < T; t += kTThreads) {
    v[0] += p[2 * t];
    v[1] += p[2 * t + 1];
  }
  block_sum(v, red);
  if (mode == kTSums) {
    if (threadIdx.x == 0) {
      out[2 * blockIdx.x] = v[0] * inv_n;
      out[2 * blockIdx.x + 1] = v[1] * inv_n;
    }
    return;
  }
  const float mean = v[0] / static_cast<float>(T);
  float m2[1] = {0.f};
  for (int t = threadIdx.x; t < T; t += kTThreads) {
    const float d = p[2 * t] - mean;
    m2[0] += fmaf(cnt * d, d, p[2 * t + 1]);
  }
  block_sum(m2, red);
  if (threadIdx.x == 0) {
    out[2 * blockIdx.x] = mean;
    out[2 * blockIdx.x + 1] = rsqrtf(m2[0] * inv_n + eps);
  }
}

// Launches tiled_stats_kernel over N samples.
cudaError_t tiled_stats(const float* part, float* out, int N, int T, float cnt, float eps,
                        int mode, cudaStream_t s) {
  tiled_stats_kernel<<<N, kTThreads, 0, s>>>(part, out, T, cnt, eps, mode);
  return cudaGetLastError();
}

}  // namespace
