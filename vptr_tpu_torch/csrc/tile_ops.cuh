// Building blocks shared by the port's multi-pass backward kernels
// (fused_window_attention_bwd.cuh, fused_ffn_bwd.cu): per-row LayerNorm
// statistics and its backward, tiled products with an epilogue on the CUDA
// cores (gemm: the FMA routes; the bf16 routes' products are wgmma,
// wg_rows.cuh and wg_dw.cuh), the fixed-order sum of split-K partials, and
// column sums in two fixed-order passes. No float atomics anywhere, so
// every result is the same on every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;            // rows per partial sum of the column sums

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// f16: round to nearest even (subnormals and overflow to inf included), as
// torch's and XLA's f32 -> f16 casts
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// LayerNorm rows: one warp per row, f32 statistics (as the forwards);
// xn = LN(x) * ls + lb and, when xqk is given, xqk = xn + pos[row % L],
// both rounded to T

template <typename T>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ ls,
               const float* __restrict__ lb, const float* __restrict__ pos,
               float* __restrict__ mean_out, float* __restrict__ rstd_out,
               T* __restrict__ xn, T* __restrict__ xqk, int rows, int L, int C, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<long>(row) * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / C;
  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    ss = fmaf(d, d, ss);
  }
  const float rstd = rsqrtf(warp_sum(ss) / C + eps);
  const float* pr = pos ? pos + static_cast<long>(row % L) * C : nullptr;
  for (int c = lane; c < C; c += 32) {
    const float n = round_t<T>((to_f32(xr[c]) - mean) * rstd * ls[c] + lb[c]);
    const float nq = pr ? round_t<T>(n + round_t<T>(pr[c])) : n;
    xn[static_cast<long>(row) * C + c] = from_f32<T>(n);
    if (xqk) xqk[static_cast<long>(row) * C + c] = from_f32<T>(nq);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// ---------------------------------------------------------------------------
// Tiled products out[M x N] = A[M x K] B[K x N] with an epilogue.
// A[m][k] is a[m * lda + k], or a[k * lda + m] when AT (transposed); B[k][n]
// is b[k * ldb + n], or b[n * ldb + k] when BT. Up to three products of one
// shape run in one launch (blockIdx.z picks the job).

constexpr int BM = 64, BN = 64, BK = 32, kGemmThreads = 256;
enum Epilogue { kProj = 0, kF32 = 1, kPartial = 2 };

struct GemmJob {
  const void* a;
  const void* b;
  void* out;
  const float* bias;    // kProj: + bias[n], rounded to T, then * mul, rounded
  float mul;
  const float* kscale;  // B[k][n] * kscale[k / group] (g * scale for dWo)
  const float* mscale;  // kF32: out[m][n] * mscale[m / group] (d(attn))
  int accumulate;       // kF32: out += result
};

// K may be split in ksplit chunks of kchunk (a multiple of BK): blockIdx.z
// = job * ksplit + chunk, and a kPartial epilogue writes chunk c's f32 sums
// to out + c * M * ldo, for a fixed-order sum over the chunks afterwards.
struct GemmBatch {
  GemmJob job[3];
  int M, N, K, lda, ldb, ldo, group, ksplit, kchunk;
};

template <typename TO, int EPI, typename Job, typename Batch>
__device__ __forceinline__ void epilogue(const Job& jb, const Batch& gb, int chunk, int m,
                                         int n, float acc) {
  if (m >= gb.M || n >= gb.N) return;
  TO* out = static_cast<TO*>(jb.out);
  const long o = (static_cast<long>(chunk) * gb.M + m) * gb.ldo + n;
  if constexpr (EPI == kProj) {
    float y = round_t<TO>(acc + jb.bias[n]);
    if (jb.mul != 1.f) y *= jb.mul;
    out[o] = from_f32<TO>(y);
  } else if constexpr (EPI == kF32) {
    float y = acc;
    if (jb.mscale) y *= jb.mscale[m / gb.group];
    if (jb.accumulate) y += to_f32(out[o]);
    out[o] = from_f32<TO>(y);
  } else {
    out[o] = acc;
  }
}

template <typename TA, bool AT, typename TB, bool BT, typename TO, int EPI>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmBatch gb) {
  __shared__ float af[BM * (BK + 1)];     // A tile, [BM][BK + 1]
  __shared__ float bf[BK * (BN + 1)];     // B tile, [BK][BN + 1]
  const int chunk = blockIdx.z % gb.ksplit;
  const GemmJob& jb = gb.job[blockIdx.z / gb.ksplit];
  const TA* A = static_cast<const TA*>(jb.a);
  const TB* B = static_cast<const TB*>(jb.b);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int M = gb.M, N = gb.N, K = gb.K;
  const int kbeg = chunk * gb.kchunk;
  const int kend = min(K, kbeg + gb.kchunk);

  auto a_at = [&](int m, int k) -> float {
    if (m >= M || k >= kend) return 0.f;
    return to_f32(AT ? A[static_cast<long>(k) * gb.lda + m] : A[static_cast<long>(m) * gb.lda + k]);
  };
  auto b_at = [&](int k, int n) -> float {
    if (k >= kend || n >= N) return 0.f;
    float v = to_f32(BT ? B[static_cast<long>(n) * gb.ldb + k] : B[static_cast<long>(k) * gb.ldb + n]);
    if (jb.kscale) v *= jb.kscale[k / gb.group];
    return v;
  };
  const int ty = tid >> 4, tx = tid & 15;         // rows ty + 16 i, cols tx + 16 j
  float acc[4][4] = {};
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();
    // element orders with consecutive threads on consecutive addresses
    for (int i = tid; i < BM * BK; i += kGemmThreads) {
      const int mm = AT ? i % BM : i / BK, kk = AT ? i / BM : i % BK;
      af[mm * (BK + 1) + kk] = a_at(m0 + mm, k0 + kk);
    }
    for (int i = tid; i < BK * BN; i += kGemmThreads) {
      const int kk = BT ? i % BK : i / BN, nn = BT ? i / BK : i % BN;
      bf[kk * (BN + 1) + nn] = b_at(k0 + kk, n0 + nn);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = af[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bf[kk * (BN + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      epilogue<TO, EPI>(jb, gb, chunk, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

template <typename TA, bool AT, typename TB, bool BT, typename TO, int EPI>
cudaError_t gemm(const GemmBatch& gb, int jobs, cudaStream_t s) {
  const dim3 grid((gb.N + BN - 1) / BN, (gb.M + BM - 1) / BM, jobs * gb.ksplit);
  gemm_kernel<TA, AT, TB, BT, TO, EPI><<<grid, kGemmThreads, 0, s>>>(gb);
  return cudaGetLastError();
}

// out_j[i] = sum over the chunks c of part_j[c][i], in chunk order (the
// split-K weight gradients), cast to T.
struct SplitSum {
  const float* part[4];
  void* out[4];
  int ksplit;
  long n;
};

template <typename T>
__global__ void split_sum_kernel(SplitSum ss) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= ss.n) return;
  const float* p = ss.part[blockIdx.y] + i;
  float acc = 0.f;
  for (int c = 0; c < ss.ksplit; ++c) acc += p[c * ss.n];
  static_cast<T*>(ss.out[blockIdx.y])[i] = from_f32<T>(acc);
}

// K chunks of the weight-gradient products for R rows: enough blocks to
// fill the card (the products have only (C / 64)^2 output tiles each).
int weight_splits(int rows) {
  const int s = (rows + 1023) / 1024;
  return s < 1 ? 1 : (s > 16 ? 16 : s);
}

// ---------------------------------------------------------------------------
// LayerNorm backward, one warp per row:
//    dx = (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd  (+ g for res)

template <typename T>
__global__ void __launch_bounds__(256)
ln_bwd_kernel(const float* __restrict__ dxn, const T* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ ls, const T* __restrict__ g, T* __restrict__ dx,
              int rows, int C, int res) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long o = static_cast<long>(row) * C;
  const float mu = mean[row], rs = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dxh = dxn[o + c] * ls[c];
    s1 += dxh;
    s2 = fmaf(dxh, (to_f32(x[o + c]) - mu) * rs, s2);
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  for (int c = lane; c < C; c += 32) {
    const float xhat = (to_f32(x[o + c]) - mu) * rs;
    float d = (dxn[o + c] * ls[c] - m1 - xhat * m2) * rs;
    if (res) d += to_f32(g[o + c]);
    dx[o + c] = from_f32<T>(d);
  }
}

// ---------------------------------------------------------------------------
// Column sums over the R rows in two fixed-order passes: chunk partials
//    (one thread per column, kChunk rows each), then the sum of the chunks.

struct ColJob {
  const void* src;       // R x C, f32 or T
  int src_is_t;
  const float* rowscale; // src * rowscale[row / group]
  int times_xhat;        // src * (x - mean) * rstd (the dls sum)
  float* out;            // C
};

struct ColBatch {
  ColJob job[6];
  const void* x;
  const float* mean;
  const float* rstd;
  float* partial;        // [6][parts][C]
  int rows, C, group, parts;
};

template <typename T>
__global__ void colsum_partial_kernel(ColBatch cb) {
  const ColJob& jb = cb.job[blockIdx.z];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int part = blockIdx.y;
  if (c >= cb.C) return;
  const int r1 = min(cb.rows, (part + 1) * kChunk);
  const T* xt = static_cast<const T*>(cb.x);
  float acc = 0.f;
  for (int r = part * kChunk; r < r1; ++r) {
    const long o = static_cast<long>(r) * cb.C + c;
    float v = jb.src_is_t ? to_f32(static_cast<const T*>(jb.src)[o])
                          : static_cast<const float*>(jb.src)[o];
    if (jb.rowscale) v *= jb.rowscale[r / cb.group];
    if (jb.times_xhat) v *= (to_f32(xt[o]) - cb.mean[r]) * cb.rstd[r];
    acc += v;
  }
  cb.partial[(static_cast<long>(blockIdx.z) * cb.parts + part) * cb.C + c] = acc;
}

__global__ void colsum_final_kernel(ColBatch cb) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cb.C) return;
  const float* p = cb.partial + static_cast<long>(blockIdx.y) * cb.parts * cb.C + c;
  float acc = 0.f;
  for (int i = 0; i < cb.parts; ++i) acc += p[static_cast<long>(i) * cb.C];
  cb.job[blockIdx.y].out[c] = acc;
}

int partials(int rows) { return (rows + kChunk - 1) / kChunk; }

#define VPTR_TRY(expr)                      \
  do {                                      \
    const cudaError_t err_ = (expr);        \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)

}  // namespace
