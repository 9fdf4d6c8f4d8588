// The conv feed-forward's fused 1x1 conv + whole-sample LayerNorm on Hopper
// (sm_90a), shared by the forward (conv_ln_gelu.cu, kernel #11) and the
// backward (conv_ln_gelu_bwd.cu, #12). Per sample of HW rows (positions) and
// x (HW, Cin), W (Cin, Cout) in T (float or bf16):
//     u    = x W + b                          f32 sums, b f32
//     zhat = (u - mean) rsqrt(var + eps)      statistics over all HW Cout,
//                                             two-pass variance
//     y    = gelu(zhat scale + bias2)         (HW, Cout) f32 affine, A&S GELU
//
// A sample's u (64 x 2112 f32 at far_mnist's fc1: 540 KB) does not fit one
// SM. A thread-block cluster of G blocks on neighbouring SMs takes a sample,
// each block a slab of SW = Cout / G columns (a whole number of 16-column
// tiles: 6 x 352 at fc1, 3 x 176 at fc2). The only cross-block work is the
// statistics, summed over the cluster through distributed shared memory in
// rank order (cluster.cuh), so the result is the same on every run.
//
// This header holds the shapes and the f32 route: the slab of u computed on
// the CUDA cores into shared memory (a thread owns one slab column for all
// HW rows, the x tile staged in shared memory) and its statistics. The bf16
// route keeps u in registers on wgmma (conv_ln_wg.cuh).
#pragma once

#include <type_traits>
#include <utility>

#include "cluster.cuh"
#include "gelu_as.cuh"
#include "tile_ops.cuh"

namespace {

constexpr int kClnMaxRows = 64;       // HW <= 64: four 16-row tiles
constexpr int kClnWarps = 11;         // 22 (fc1) and 11 (fc2) slab tiles at far_mnist
constexpr int kClnThreads = kClnWarps * 32;
constexpr int kClnMaxCt = 3;          // slabs of at most 33 column tiles
constexpr int kClnKStep = 32;         // K of a staged x tile
constexpr int kClnMaxCluster = 8;     // the portable cluster size
constexpr int kClnSlots = 3;          // cluster reductions per sample
constexpr long kClnSmemLimit = 232448 - 1024;   // less the static reduction scratch

// Reduction scratch of the cluster sums (cluster.cuh).
using ClnRed = ClusterRed<kClnWarps, kClnSlots>;

// Blocks per sample (the cluster size) for Cout: the smallest G <= 8 that
// splits Cout / 16 column tiles into slabs of at most 2 kClnWarps tiles,
// else of at most kClnMaxCt kClnWarps; 0 when none does.
int cln_split(int Cout) {
  const int nt = Cout / 16;
  for (int cap : {2 * kClnWarps, kClnMaxCt * kClnWarps})
    for (int g = 1; g <= kClnMaxCluster; ++g)
      if (nt % g == 0 && nt / g <= cap) return g;
  return 0;
}

// Dynamic shared memory of an f32 block: the slab (row stride SW + 4) and
// the staged x tile after it.
long cln_smem(int HW, int SW) {
  return static_cast<long>(sizeof(float)) * (HW * (SW + 4) + kClnMaxRows * kClnKStep);
}

// The shapes the kernels take.
bool cln_shape_ok(int N, int HW, int Cin, int Cout) {
  return N >= 1 && HW >= 16 && HW <= kClnMaxRows && HW % 16 == 0 && Cin >= 16 &&
         Cin % 16 == 0 && Cout >= 16 && Cout % 16 == 0 && cln_split(Cout) > 0;
}

// slab[r][c] = sum_k x[r][k] W[k][c0 + c] for r < HW, c < SW on the CUDA
// cores: thread c of a pass owns slab column c for all HW rows; the x tile
// of each K step is staged in xs_buf. Ends with a __syncthreads.
__device__ __forceinline__ void slab_gemm_fma(const float* __restrict__ xs,
                                              const float* __restrict__ W,
                                              int HW, int Cin, int Cout, int c0, int SW,
                                              float* xs_buf, float* slab, int lds) {
  for (int cb = 0; cb < SW; cb += kClnThreads) {
    const int c = cb + static_cast<int>(threadIdx.x);
    const bool active = c < SW;
    float acc[kClnMaxRows];
#pragma unroll
    for (int r = 0; r < kClnMaxRows; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < Cin; k0 += kClnKStep) {
      __syncthreads();
      for (int i = threadIdx.x; i < HW * kClnKStep; i += kClnThreads) {
        const int r = i / kClnKStep, kk = i - r * kClnKStep;
        xs_buf[i] = k0 + kk < Cin ? xs[static_cast<long>(r) * Cin + k0 + kk] : 0.f;
      }
      __syncthreads();
      if (active) {
        const int kn = Cin - k0 < kClnKStep ? Cin - k0 : kClnKStep;
        for (int kk = 0; kk < kn; ++kk) {
          const float w = W[static_cast<long>(k0 + kk) * Cout + c0 + c];
#pragma unroll
          for (int r = 0; r < kClnMaxRows; ++r)
            if (r < HW) acc[r] = fmaf(xs_buf[r * kClnKStep + kk], w, acc[r]);
        }
      }
    }
    if (active)
#pragma unroll
      for (int r = 0; r < kClnMaxRows; ++r)
        if (r < HW) slab[r * lds + c] = acc[r];
  }
  __syncthreads();
}

// The sample's u = x W + b into the block's slab, then its statistics over
// the cluster (slots 0 and 1): mean and rstd.
__device__ __forceinline__ void sample_u(const float* __restrict__ xs, const float* __restrict__ W,
                                         const float* __restrict__ b, int HW, int Cin, int Cout,
                                         int c0, int SW, float eps, unsigned char* smem,
                                         ClnRed& red, cg::cluster_group& cluster, float& mean,
                                         float& rstd) {
  float* slab = reinterpret_cast<float*>(smem);
  const int lds = SW + 4;
  slab_gemm_fma(xs, W, HW, Cin, Cout, c0, SW, slab + HW * lds, slab, lds);
  const float inv_n = 1.f / (static_cast<float>(HW) * Cout);
  float v[1] = {0.f};
  for (int e = threadIdx.x; e < HW * SW; e += kClnThreads) {
    const int r = e / SW, c = e - r * SW;
    const float u = slab[r * lds + c] + b[c0 + c];
    slab[r * lds + c] = u;
    v[0] += u;
  }
  cluster_sum(v, red, 0, cluster);
  mean = v[0] * inv_n;
  v[0] = 0.f;
  for (int e = threadIdx.x; e < HW * SW; e += kClnThreads) {
    const int r = e / SW, c = e - r * SW;
    const float d = slab[r * lds + c] - mean;
    v[0] = fmaf(d, d, v[0]);
  }
  cluster_sum(v, red, 1, cluster);
  rstd = rsqrtf(v[0] * inv_n + eps);
}

// Launches kernel with clusters of G blocks along x.
template <typename... Exp, typename... Act>
cudaError_t launch_clusters(void (*kernel)(Exp...), int blocks, int G, long smem,
                            cudaStream_t s, Act&&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(kClnThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(G);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
