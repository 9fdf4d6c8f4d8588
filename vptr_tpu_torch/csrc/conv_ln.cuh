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
// tiles: 6 x 352 at fc1, 3 x 176 at fc2), computed by the block's own GEMM
// into shared memory in f32 and kept there. The only cross-block work is the
// statistics, summed over the cluster through distributed shared memory in
// rank order (cluster.cuh), so the result is the same on every run.
//
// The slab GEMM (the backward's recomputed u, and the f32 forward; the bf16
// forward keeps u in registers on wgmma, conv_ln_gelu.cu): bf16 runs on
// the tensor cores (WMMA 16x16x16, f32 accumulators): K steps of 32 of the sample's x tile and the slab's W
// columns stream through a three-stage cp.async ring that shares its shared
// memory with the slab (the slab is written once the ring is drained); each
// of the 11 warps owns the column tiles warp + 11 j (at most kClnMaxCt) for
// every 16-row tile. f32 runs on the CUDA cores: a thread owns one slab
// column for all HW rows, the x tile staged in shared memory.
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
constexpr int kClnMaxCt = 3;          // column tiles a warp holds: slabs <= 33 tiles
constexpr int kClnKStep = 32;         // K of a ring stage (two 16-deep MMAs)
constexpr int kClnStages = 3;
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

// Column tiles a warp holds for slabs of SW columns.
int cln_ct(int SW) { return (SW / 16 + kClnWarps - 1) / kClnWarps; }

struct ClnRing {
  static constexpr int LA = kClnKStep + 8;              // A row stride (x 8)
  static constexpr int A_ELEMS = kClnMaxRows * LA;
  __host__ __device__ static int lb(int SW) { return SW + 8; }
  __host__ __device__ static int stage(int SW) {         // 128-byte slots
    return (A_ELEMS + kClnKStep * lb(SW) + 63) / 64 * 64;
  }
};

// Dynamic shared memory of a block: the f32 slab (row stride SW + 4) and,
// for bf16, the ring in the same memory; for f32, the staged x tile after it.
long cln_smem(int HW, int SW, int dtype) {
  const long slab = static_cast<long>(sizeof(float)) * HW * (SW + 4);
  if (dtype == 1) {
    const long ring = static_cast<long>(sizeof(bf16)) * kClnStages * ClnRing::stage(SW);
    return slab > ring ? slab : ring;
  }
  return slab + static_cast<long>(sizeof(float)) * kClnMaxRows * kClnKStep;
}

// The shapes the kernels take.
bool cln_shape_ok(int N, int HW, int Cin, int Cout) {
  return N >= 1 && HW >= 16 && HW <= kClnMaxRows && HW % 16 == 0 && Cin >= 16 &&
         Cin % 16 == 0 && Cout >= 16 && Cout % 16 == 0 && cln_split(Cout) > 0;
}

// slab[r][c] = sum_k x[r][k] W[k][c0 + c] for r < HW, c < SW, on the tensor
// cores (see the note at the top). Ends with a __syncthreads.
template <int CT>
__device__ __forceinline__ void slab_gemm_tc(const bf16* __restrict__ xs,
                                             const bf16* __restrict__ W, int HW, int Cin,
                                             int Cout, int c0, int SW, unsigned char* smem,
                                             float* slab, int lds) {
  using namespace nvcuda;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int LB = ClnRing::lb(SW), STAGE = ClnRing::stage(SW);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int nts = SW / 16, rt = HW / 16;
  const int steps = (Cin + kClnKStep - 1) / kClnKStep;
  const int bvec = SW / 8;                         // 16-byte pieces of a W row
  auto load = [&](int step) {
    if (step < steps) {
      const int k0 = step * kClnKStep;
      bf16* sa = ring + (step % kClnStages) * STAGE;
      bf16* sb = sa + ClnRing::A_ELEMS;
      for (int i = tid; i < HW * (kClnKStep / 8); i += kClnThreads) {
        const int r = i / (kClnKStep / 8), col = (i % (kClnKStep / 8)) * 8;
        const bool ok = k0 + col < Cin;
        __pipeline_memcpy_async(sa + r * ClnRing::LA + col,
                                xs + (ok ? static_cast<long>(r) * Cin + k0 + col : 0), 16,
                                ok ? 0 : 16);
      }
      for (int i = tid; i < kClnKStep * bvec; i += kClnThreads) {
        const int kk = i / bvec, col = (i - kk * bvec) * 8;
        const bool ok = k0 + kk < Cin;
        __pipeline_memcpy_async(sb + kk * LB + col,
                                W + (ok ? static_cast<long>(k0 + kk) * Cout + c0 + col : 0),
                                16, ok ? 0 : 16);
      }
    }
    __pipeline_commit();
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) wmma::fill_fragment(acc[j][t], 0.f);
  for (int s = 0; s < kClnStages - 1; ++s) load(s);
  for (int step = 0; step < steps; ++step) {
    load(step + kClnStages - 1);       // into the slot read at step - 1
    __pipeline_wait_prior(kClnStages - 1);
    __syncthreads();
    const bf16* sa = ring + (step % kClnStages) * STAGE;
    const bf16* sb = sa + ClnRing::A_ELEMS;
#pragma unroll
    for (int ks = 0; ks < kClnKStep; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (t < rt) wmma::load_matrix_sync(a[t], sa + t * 16 * ClnRing::LA + ks, ClnRing::LA);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int ct = warp + j * kClnWarps;
        if (ct >= nts) continue;
        wmma::load_matrix_sync(b, sb + ks * LB + ct * 16, LB);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (t < rt) wmma::mma_sync(acc[j][t], a[t], b, acc[j][t]);
      }
    }
    __syncthreads();
  }
  __pipeline_wait_prior(0);
  __syncthreads();                     // the ring is drained: the slab may overwrite it
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int ct = warp + j * kClnWarps;
    if (ct >= nts) continue;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (t < rt)
        wmma::store_matrix_sync(slab + t * 16 * lds + ct * 16, acc[j][t], lds,
                                wmma::mem_row_major);
  }
  __syncthreads();
}

// The same slab on the CUDA cores (f32): thread c of a pass owns slab
// column c for all HW rows; the x tile of each K step is staged in xs_buf.
// Ends with a __syncthreads.
template <typename T>
__device__ __forceinline__ void slab_gemm_fma(const T* __restrict__ xs, const T* __restrict__ W,
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
        xs_buf[i] = k0 + kk < Cin ? to_f32(xs[static_cast<long>(r) * Cin + k0 + kk]) : 0.f;
      }
      __syncthreads();
      if (active) {
        const int kn = Cin - k0 < kClnKStep ? Cin - k0 : kClnKStep;
        for (int kk = 0; kk < kn; ++kk) {
          const float w = to_f32(W[static_cast<long>(k0 + kk) * Cout + c0 + c]);
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
template <typename T, int CT>
__device__ __forceinline__ void sample_u(const T* __restrict__ xs, const T* __restrict__ W,
                                         const float* __restrict__ b, int HW, int Cin, int Cout,
                                         int c0, int SW, float eps, unsigned char* smem,
                                         ClnRed& red, cg::cluster_group& cluster, float& mean,
                                         float& rstd) {
  float* slab = reinterpret_cast<float*>(smem);
  const int lds = SW + 4;
  if constexpr (std::is_same<T, bf16>::value)
    slab_gemm_tc<CT>(xs, W, HW, Cin, Cout, c0, SW, smem, slab, lds);
  else
    slab_gemm_fma<T>(xs, W, HW, Cin, Cout, c0, SW, slab + HW * lds, slab, lds);
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
