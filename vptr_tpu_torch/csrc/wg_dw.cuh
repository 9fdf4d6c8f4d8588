// The weight-gradient product on Hopper's warpgroup MMA (sm_90a), shared by
// the bf16 backwards of the 1x1 conv + whole-sample LayerNorm
// (conv_ln_gelu_bwd.cu, kernel #12: dW = x^T du), of the fused
// feed-forward sublayer (fused_ffn_bwd.cu, #8: dW1 = xn^T da and dW2^T =
// g^T hd) and, four products a launch, of the window-attention sublayer
// (fused_window_attention_bwd.cuh, #3 and #6: dWq, dWk, dWv, dWo): out
// (M, Nc) = sum over K = rows of x^T b, both operands MN-major as they lie
// in memory (x (rows, M), b (rows, Nc), row-major), split over K in fixed
// chunks whose f32 partials the caller sums in chunk order.
#pragma once

#include "conv_ln_wg.cuh"

namespace {

// A block takes 64 MW rows of M (MW warpgroups, 64 each) by one 176-column
// group of Nc over one K chunk of rows [k0, k0 + kchunk) (kchunk a
// multiple of 64), and writes its f32 tile into the chunk's partial
// (out[chunk]). The product's transpose flags are set and its descriptors
// MN-major (wg_desc_mn). A ring stage holds MW TMA boxes of x (64 M values
// by 64 rows) and, for each of the T terms of b (#12's du and #8's da and
// hd reach it as their bf16 hi and lo halves), three boxes of 64 Nc values
// by 64 rows (the group's 176 columns and 16 more, left out); a feeder
// warp issues them. Rows past `rows` and columns past M or Nc read zero.
constexpr int kDwBox = 64 * 64 * 2;        // 8 KB: 64 MN values by 64 rows
constexpr int kDwMw = 3;                   // warpgroups along Cin a block

__host__ __device__ constexpr int dw_stage_bytes(int mw, int t) { return (mw + 3 * t) * kDwBox; }
int dw_stages(int mw, int t) {
  const int n = (232448 - 2048) / dw_stage_bytes(mw, t);
  return n > kWgMaxStages ? kWgMaxStages : n;
}
long dw_smem(int mw, int t) {
  return static_cast<long>(dw_stages(mw, t)) * dw_stage_bytes(mw, t) + 1024;
}

template <int MW, int T>
__global__ void __launch_bounds__(MW * 128 + 32, 1)
wg_dw_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap hmap,
             const __grid_constant__ CUtensorMap lmap, float* __restrict__ out, int M, int Nc,
             int rows, int kchunk, int stages) {
  constexpr int kStage = dw_stage_bytes(MW, T);
  extern __shared__ unsigned char smem_wg[];
  __shared__ WgRing ring;
  const int m0 = blockIdx.x * 64 * MW, n0 = blockIdx.y * kWgN, k0 = blockIdx.z * kchunk;
  const int k1 = min(rows, k0 + kchunk), steps = (k1 - k0 + kWgK - 1) / kWgK;
  if (threadIdx.x == 0) {
    wg_ring_init(ring, smem_wg, stages, 4 * MW);
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  if (warp == 4 * MW) {                // the feeder
    if (lane == 0)
      for (int g = 0; g < steps; ++g) {
        const int st = g % stages, k = k0 + g * kWgK;
        if (g >= stages) mbar_wait(&ring.empty[st], ((g / stages) & 1) ^ 1);
        unsigned char* a = ring.tiles + st * kStage;
        mbar_expect_tx(&ring.full[st], kStage, true);
        for (int w = 0; w < MW; ++w)
          tma_load_2d(a + w * kDwBox, &xmap, &ring.full[st], m0 + 64 * w, k, true);
        for (int t = 0; t < T; ++t)
          for (int i = 0; i < 3; ++i)
            tma_load_2d(a + (MW + 3 * t + i) * kDwBox, t ? &lmap : &hmap, &ring.full[st],
                        n0 + 64 * i, k, true);
      }
    return;
  }
  const int w = warp >> 2;
  float acc[kWgAcc];
#pragma unroll
  for (int i = 0; i < kWgAcc; ++i) acc[i] = 0.f;
  for (int g = 0; g < steps; ++g) {
    const int st = g % stages;
    mbar_wait(&ring.full[st], (g / stages) & 1);
    const unsigned char* a = ring.tiles + st * kStage;
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int q = 0; q < kWgK / 16; ++q)            // +16 rows, 2048 bytes, a slice
        wgmma_176<1, 1>(acc, wg_desc_mn(a + w * kDwBox + 2048 * q, kDwBox),
                        wg_desc_mn(a + (MW + 3 * t) * kDwBox + 2048 * q, kDwBox));
    }
    wg_commit();
    wg_fence_acc(acc);
    if (g > 0) {                       // the previous step's products are done
      wg_wait<1>();
      mbar_arrive(&ring.empty[(g - 1) % stages], lane == 0);
    }
  }
  wg_wait<0>();
  wg_fence_acc(acc);
  const int r = m0 + 64 * w + 16 * (warp & 3) + (lane >> 2), cb = n0 + 2 * (lane & 3);
  float* o = out + static_cast<long>(blockIdx.z) * M * Nc;
#pragma unroll
  for (int j = 0; j < kWgN / 8; ++j)
    if (cb + 8 * j < Nc)
#pragma unroll
      for (int h = 0; h < 2; ++h)                    // rows r and r + 8
        if (r + 8 * h < M)
          *reinterpret_cast<float2*>(o + static_cast<long>(r + 8 * h) * Nc + cb + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// J products of one shape in one launch (the window-attention backward's
// dWq, dWk, dWv, dWo), each block as wg_dw_kernel's: product j =
// blockIdx.z / ksplit takes x[j] and the first terms[j] (1 or 2) of h[j],
// l[j], K chunk blockIdx.z % ksplit, into out[j] + chunk M Nc.
template <int J>
struct DwJobs {
  CUtensorMap x[J], h[J], l[J];
  float* out[J];
  int terms[J];
};

template <int MW, int J>
__global__ void __launch_bounds__(MW * 128 + 32, 1)
wg_dw_jobs_kernel(const __grid_constant__ DwJobs<J> jobs, int M, int Nc, int rows, int kchunk,
                  int stages) {
  constexpr int kStage = dw_stage_bytes(MW, 2);
  extern __shared__ unsigned char smem_wg[];
  __shared__ WgRing ring;
  const int ksplit = gridDim.z / J, j = blockIdx.z / ksplit, chunk = blockIdx.z - j * ksplit;
  const int nt = jobs.terms[j];
  const int m0 = blockIdx.x * 64 * MW, n0 = blockIdx.y * kWgN, k0 = chunk * kchunk;
  const int k1 = min(rows, k0 + kchunk), steps = (k1 - k0 + kWgK - 1) / kWgK;
  if (threadIdx.x == 0) {
    wg_ring_init(ring, smem_wg, stages, 4 * MW);
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  if (warp == 4 * MW) {                // the feeder
    if (lane == 0)
      for (int g = 0; g < steps; ++g) {
        const int st = g % stages, k = k0 + g * kWgK;
        if (g >= stages) mbar_wait(&ring.empty[st], ((g / stages) & 1) ^ 1);
        unsigned char* a = ring.tiles + st * kStage;
        mbar_expect_tx(&ring.full[st], dw_stage_bytes(MW, nt), true);
        for (int w = 0; w < MW; ++w)
          tma_load_2d(a + w * kDwBox, &jobs.x[j], &ring.full[st], m0 + 64 * w, k, true);
        for (int t = 0; t < nt; ++t)
          for (int i = 0; i < 3; ++i)
            tma_load_2d(a + (MW + 3 * t + i) * kDwBox, t ? &jobs.l[j] : &jobs.h[j],
                        &ring.full[st], n0 + 64 * i, k, true);
      }
    return;
  }
  const int w = warp >> 2;
  float acc[kWgAcc];
#pragma unroll
  for (int i = 0; i < kWgAcc; ++i) acc[i] = 0.f;
  for (int g = 0; g < steps; ++g) {
    const int st = g % stages;
    mbar_wait(&ring.full[st], (g / stages) & 1);
    const unsigned char* a = ring.tiles + st * kStage;
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (t < nt)
#pragma unroll
        for (int q = 0; q < kWgK / 16; ++q)          // +16 rows, 2048 bytes, a slice
          wgmma_176<1, 1>(acc, wg_desc_mn(a + w * kDwBox + 2048 * q, kDwBox),
                          wg_desc_mn(a + (MW + 3 * t) * kDwBox + 2048 * q, kDwBox));
    wg_commit();
    wg_fence_acc(acc);
    if (g > 0) {                       // the previous step's products are done
      wg_wait<1>();
      mbar_arrive(&ring.empty[(g - 1) % stages], lane == 0);
    }
  }
  wg_wait<0>();
  wg_fence_acc(acc);
  const int r = m0 + 64 * w + 16 * (warp & 3) + (lane >> 2), cb = n0 + 2 * (lane & 3);
  float* o = jobs.out[j] + static_cast<long>(chunk) * M * Nc;
#pragma unroll
  for (int jj = 0; jj < kWgN / 8; ++jj)
    if (cb + 8 * jj < Nc)
#pragma unroll
      for (int h = 0; h < 2; ++h)                    // rows r and r + 8
        if (r + 8 * h < M)
          *reinterpret_cast<float2*>(o + static_cast<long>(r + 8 * h) * Nc + cb + 8 * jj) =
              make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
}

// The K chunk of the wgmma weight products: S / ksplit rounded up to 64.
int dw_kchunk(int rows, int ksplit) {
  return ((rows + ksplit - 1) / ksplit + kWgK - 1) / kWgK * kWgK;
}

// out[c] (M, Nc) f32 = sum over the T terms of x^T b_t over chunk c's rows,
// x (rows, M) and b_t (rows, Nc) bf16, for the ksplit chunks.
template <int T>
int launch_dw(const void* x, const void* b0, const void* b1, float* out, int rows, int M, int Nc,
              int ksplit, cudaStream_t s) {
  CUtensorMap xmap, hmap, lmap;
  const cuuint32_t box[2] = {64, 64};
  auto map = [&](CUtensorMap* m, const void* p, int cols) {
    const cuuint64_t d[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t st = static_cast<cuuint64_t>(cols) * 2;
    return bf16_map(m, p, 2, d, &st, box);
  };
  int err = map(&xmap, x, M);
  if (!err) err = map(&hmap, b0, Nc);
  if (!err) err = map(&lmap, b1, Nc);
  if (err) return err;
  auto kernel = wg_dw_kernel<kDwMw, T>;
  const long smem = dw_smem(kDwMw, T);
  VPTR_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem)));
  const dim3 grid((M + 64 * kDwMw - 1) / (64 * kDwMw), (Nc + kWgN - 1) / kWgN, ksplit);
  kernel<<<grid, kDwMw * 128 + 32, smem, s>>>(xmap, hmap, lmap, out, M, Nc, rows,
                                              dw_kchunk(rows, ksplit), dw_stages(kDwMw, T));
  return cudaGetLastError();
}

// The J products of `jobs` (each (M, Nc) over K = rows, both operands bf16)
// in ksplit K chunks into their partials.
template <int J>
int launch_dw_jobs(const DwJobs<J>& jobs, int rows, int M, int Nc, int ksplit, cudaStream_t s) {
  auto kernel = wg_dw_jobs_kernel<kDwMw, J>;
  const long smem = dw_smem(kDwMw, 2);
  VPTR_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem)));
  const dim3 grid((M + 64 * kDwMw - 1) / (64 * kDwMw), (Nc + kWgN - 1) / kWgN, J * ksplit);
  kernel<<<grid, kDwMw * 128 + 32, smem, s>>>(jobs, M, Nc, rows, dw_kchunk(rows, ksplit),
                                              dw_stages(kDwMw, 2));
  return cudaGetLastError();
}

}  // namespace
