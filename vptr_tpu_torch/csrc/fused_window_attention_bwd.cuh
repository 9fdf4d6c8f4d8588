// Backward of the window self-attention sublayer on Hopper (sm_90a),
// shared by two libraries through the template flag LN. The forward
// (fused_window_attention.cuh) computes, over R = windows * L rows of C
// channels,
//   LN = true  (kernel #3, fused_window_attention_ln_bwd.cu):
//     xn  = LN(x) * ls + lb,  xqk = xn + pos
//   LN = false (kernel #6, fused_window_attention_bwd.cu):
//     xqk = x_qk,  xn = x_v
//   and for both
//     q,k = xqk Wq|Wk + bq|bk,  v = xn Wv + bv
//     a_h = dropout(softmax(q_h k_h^T * hd^-1/2 + bias_h)) v_h
//     out = [a_1 .. a_H] Wo + bo,  then * scale[window], + x when res (LN)
// Given the output cotangent g, the backward computes dWq/k/v/o,
// dbq/k/v/o, dbias and, for LN = true, dx, dls, dlb (dpos and dscale are
// zero: pos is a sine table, scale a DropPath mask); for LN = false,
// dx_qk = dq Wq^T + dk Wk^T and dx_v = dv Wv^T.
//
// The TPU kernels walked their grid in order and accumulated the weight,
// LayerNorm-affine and bias gradients in place across grid steps. Blocks
// on the card run in parallel, so the work is split into passes, each a
// kernel of this header, and every reduction over rows is either the K
// loop of one block or a fixed-order second pass; no float atomics, so the
// result is the same on every run:
//   1. ln_rows (LN only): per-row LayerNorm statistics, xn and xqk
//      (rounded to T); without LN the two inputs are xqk and xn;
//   2. q, k, v, rounded after the f32 bias add (q * scale in T);
//   3. d(attn) = (g Wo^T) * scale[window], f32;
//   4. window_bwd: one block per (window, head) recomputes the softmax and
//      the hash mask (dropout index over the padded token count) in shared
//      memory and writes dq, dk, dv (f32), the merged heads (T) and, for
//      the bias gradient, its logit gradients;
//   5. dW = X^T dY for q, k, v (X = xqk, xqk, xn) and o (X = the merged
//      heads, dY = g * scale). These have only (C / 64)^2 output tiles each,
//      so K = R is split in chunks of about 1024 rows (enough blocks to
//      fill the card); each chunk's f32 sums go to scratch and split_sum
//      adds them in chunk order and casts to T;
//   6. LN: d(xn) = dq Wq^T + dk Wk^T + dv Wv^T (f32);
//      no LN: dx_qk = dq Wq^T + dk Wk^T and dx_v = dv Wv^T (rounded to T);
//   7. ln_bwd (LN only): dx per row (+ g for res);
//   8. colsum: db* (and dls, dlb for LN) as per-chunk partial sums, then a
//      fixed-order sum of the chunks; dbias sums the logit gradients over
//      windows.
// Rounding points follow the plain versions
// (fused_window_attention.py::fused_attention_ln_backward_plain and
// fused_attention_backward_plain): dq, dk, dv and g * scale stay f32 into
// the dW and d(xn) / dx products.
//
// The products (2, 3, 5, 6) have two routes:
// * tensor cores (bf16, C and R multiples of 8 -- the training path): a
//   bf16 WMMA operand cannot hold an f32 value, so split_kernel writes
//   each f32 operand as hi = bf16(v) and lo = bf16(v - hi) (16 bits of
//   mantissa, relative error below 2^-16, far below the final rounding of
//   each dW to bf16) and a product becomes a sum of bf16 terms (d(xn): six;
//   dx_qk: four; dx_v: two).
//   tc_gemm runs 128 x 64 output tiles on eight warps of 2 x 2 WMMA
//   16x16x16 tiles with f32 accumulators, fed by a three-slot cp.async ring
//   of 16-byte copies that runs over the terms and K steps as one sequence;
//   transposed operands are staged as they lie and read with column-major
//   fragments.
// * FMA (f32, or a bf16 shape the first does not take): gemm, 64 x 64
//   tiles staged element by element, f32 products on the CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hash_dropout.cuh"

// Everything the backward needs; mirrored by _BwdArgs in
// vptr_tpu_torch/ops/fused_window_attention.py. Inputs, outputs, then the
// caller-allocated scratch (mean/rstd: R f32; xn, xqk, q, k, v, attn: R x C
// in T; dao, dq, dk, dv: R x C f32; dl: windows x heads x L x L f32 or
// null; partial: 6 x partials x C f32; wpart: 4 x ksplit x C x C f32;
// hilo: 8 x R x C bf16 when T is bf16). Without LN, x is x_qk, xv is x_v,
// dx is dx_qk and dxv dx_v, and mean, rstd, xn, xqk, ls, lb, pos, scale,
// dls and dlb are unused (null).
struct BwdArgs {
  const void *x, *xv, *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo, *ls, *lb, *pos, *bias, *scale,
      *seed, *g;
  void *dx, *dxv, *dwq, *dbq, *dwk, *dbk, *dwv, *dbv, *dwo, *dbo, *dls, *dlb, *dbias;
  void *mean, *rstd, *xn, *xqk, *q, *k, *v, *attn, *dao, *dq, *dk, *dv, *dl, *partial, *wpart,
      *hilo;
  int windows, tokens, channels, heads, bias_heads, res, mask_tokens, dtype, ksplit;
  float qscale, dscale, eps, rate, keep_div;
};

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxTokens = 32;
constexpr int kMaxHeadDim = 128;
constexpr int kChunk = 64;            // rows per partial sum of the column sums

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
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
// 1. LayerNorm rows: one warp per row, f32 statistics (as the forward)

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
    xqk[static_cast<long>(row) * C + c] = from_f32<T>(nq);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// ---------------------------------------------------------------------------
// 2/3/5/6. Tiled products out[M x N] = A[M x K] B[K x N] with an epilogue.
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

// ---------------------------------------------------------------------------
// The tensor-core route's products (bf16, every dimension a multiple of 8):
// every operand is a bf16 matrix in device memory, an f32 operand having
// been split into hi and lo matrices (split_kernel), so a product is a sum
// of up to six terms A_t B_t over one K range. 128 x 64 output tiles, eight
// warps of 32 x 32 (2 x 2 WMMA tiles), K steps of 32 staged through a
// three-slot cp.async ring (16-byte copies, zero-filled past an edge) that
// runs over the terms and K steps as one sequence. A transposed operand is
// staged as it lies in memory and read with a column-major fragment.

constexpr int TBM = 128, TBN = 64, TBK = 32, kTcStages = 3, kMaxTerms = 6;

struct TcJob {
  const bf16* a[kMaxTerms];
  const bf16* b[kMaxTerms];
  int nterms;
  void* out;
  const float* bias;
  float mul;
  const float* mscale;
  int accumulate;
};

struct TcBatch {
  TcJob job[4];
  int M, N, K, lda, ldb, ldo, group, ksplit, kchunk;
};

template <bool AT, bool BT> struct TcTiles {
  static constexpr int LA = AT ? TBM + 8 : TBK + 8;     // row strides (x 8)
  static constexpr int LB = BT ? TBK + 8 : TBN + 8;
  static constexpr int A_ELEMS = AT ? TBK * LA : TBM * LA;
  static constexpr int B_ELEMS = BT ? TBN * LB : TBK * LB;
  static constexpr int STAGE = (A_ELEMS + B_ELEMS + 63) / 64 * 64;   // 128-byte slots
  static constexpr int SMEM = kTcStages * STAGE * 2 + 8 * 256 * 4;
};

template <bool AT, bool BT, typename TO, int EPI>
__global__ void __launch_bounds__(256) tc_gemm_kernel(TcBatch gb) {
  using namespace nvcuda;
  using Tiles = TcTiles<AT, BT>;
  using LayA = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using LayB = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  extern __shared__ __align__(128) unsigned char tsmem[];
  const int chunk = blockIdx.z % gb.ksplit;
  const TcJob& jb = gb.job[blockIdx.z / gb.ksplit];
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kbeg = chunk * gb.kchunk;
  const int kend = min(gb.K, kbeg + gb.kchunk);
  const int ksteps = kend > kbeg ? (kend - kbeg + TBK - 1) / TBK : 0;
  const int steps = jb.nterms * ksteps;
  bf16* ring = reinterpret_cast<bf16*>(tsmem);
  float* stage = reinterpret_cast<float*>(ring + kTcStages * Tiles::STAGE) + warp * 256;

  auto load_stage = [&](int step) {
    if (step < steps) {
      const int term = step / ksteps;
      const int k0 = kbeg + (step - term * ksteps) * TBK;
      const bf16* A = jb.a[term];
      const bf16* B = jb.b[term];
      bf16* sa = ring + (step % kTcStages) * Tiles::STAGE;
      bf16* sb = sa + Tiles::A_ELEMS;
      for (int c = tid; c < TBM * TBK / 8; c += 256) {
        int r, col;
        long off;
        bool ok;
        if (AT) {          // rows of K, 8 m per copy
          r = c / (TBM / 8), col = (c % (TBM / 8)) * 8;
          ok = k0 + r < kend && m0 + col < gb.M;
          off = static_cast<long>(k0 + r) * gb.lda + m0 + col;
        } else {           // rows of M, 8 k per copy
          r = c / (TBK / 8), col = (c % (TBK / 8)) * 8;
          ok = m0 + r < gb.M && k0 + col < kend;
          off = static_cast<long>(m0 + r) * gb.lda + k0 + col;
        }
        __pipeline_memcpy_async(sa + r * Tiles::LA + col, A + (ok ? off : 0), 16, ok ? 0 : 16);
      }
      for (int c = tid; c < TBK * TBN / 8; c += 256) {
        int r, col;
        long off;
        bool ok;
        if (BT) {          // rows of N, 8 k per copy
          r = c / (TBK / 8), col = (c % (TBK / 8)) * 8;
          ok = n0 + r < gb.N && k0 + col < kend;
          off = static_cast<long>(n0 + r) * gb.ldb + k0 + col;
        } else {           // rows of K, 8 n per copy
          r = c / (TBN / 8), col = (c % (TBN / 8)) * 8;
          ok = k0 + r < kend && n0 + col < gb.N;
          off = static_cast<long>(k0 + r) * gb.ldb + n0 + col;
        }
        __pipeline_memcpy_async(sb + r * Tiles::LB + col, B + (ok ? off : 0), 16, ok ? 0 : 16);
      }
    }
    __pipeline_commit();
  };

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int st = 0; st < kTcStages - 1; ++st) load_stage(st);
  for (int step = 0; step < steps; ++step) {
    load_stage(step + kTcStages - 1);  // into the slot read at step - 1
    __pipeline_wait_prior(kTcStages - 1);
    __syncthreads();
    const bf16* sa = ring + (step % kTcStages) * Tiles::STAGE;
    const bf16* sb = sa + Tiles::A_ELEMS;
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayA> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayB> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], AT ? sa + ks * Tiles::LA + wm + 16 * i
                                         : sa + (wm + 16 * i) * Tiles::LA + ks, Tiles::LA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], BT ? sb + (wn + 16 * j) * Tiles::LB + ks
                                          : sb + ks * Tiles::LB + wn + 16 * j, Tiles::LB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
  __pipeline_wait_prior(0);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        epilogue<TO, EPI>(jb, gb, chunk, m0 + wm + 16 * i + (e >> 4),
                          n0 + wn + 16 * j + (e & 15), stage[e]);
      __syncwarp();
    }
}

template <bool AT, bool BT, typename TO, int EPI>
cudaError_t tc_gemm(const TcBatch& gb, int jobs, cudaStream_t s) {
  constexpr int smem = TcTiles<AT, BT>::SMEM;
  auto kernel = tc_gemm_kernel<AT, BT, TO, EPI>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((gb.N + TBN - 1) / TBN, (gb.M + TBM - 1) / TBM, jobs * gb.ksplit);
  kernel<<<grid, 256, smem, s>>>(gb);
  return cudaGetLastError();
}

TcJob tc_job(std::initializer_list<const void*> a, std::initializer_list<const void*> b,
             void* out, const void* bias = nullptr, float mul = 1.f,
             const float* mscale = nullptr) {
  TcJob j{};
  int t = 0;
  for (const void* p : a) j.a[t++] = static_cast<const bf16*>(p);
  t = 0;
  for (const void* p : b) j.b[t++] = static_cast<const bf16*>(p);
  j.nterms = t;
  j.out = out, j.bias = static_cast<const float*>(bias), j.mul = mul, j.mscale = mscale;
  return j;
}

// hi = bf16(v), lo = bf16(v - hi) of the f32 operands of the tensor-core
// products: dq, dk, dv and g * scale[window] (blockIdx.y picks which), into
// hilo[2 j] and hilo[2 j + 1].
__global__ void split_kernel(const float* __restrict__ dq, const float* __restrict__ dk,
                             const float* __restrict__ dv, const bf16* __restrict__ g,
                             const float* __restrict__ scale, bf16* __restrict__ hilo, long n,
                             int C, int L) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int j = blockIdx.y;
  float v;
  if (j == 3) {
    v = __bfloat162float(g[i]);
    if (scale) v *= scale[i / C / L];
  } else {
    v = (j == 0 ? dq : (j == 1 ? dk : dv))[i];
  }
  const bf16 hi = __float2bfloat16_rn(v);
  hilo[2 * j * n + i] = hi;
  hilo[(2 * j + 1) * n + i] = __float2bfloat16_rn(v - __bfloat162float(hi));
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
// 4. Attention backward of one (window, head), in shared memory

// Shared-memory row stride in floats: a multiple of 4 (rows read as
// float4) and 4 mod 8, so the float4 reads of eight consecutive rows hit
// eight different 16-byte bank groups.
inline __host__ __device__ int row_stride(int depth) {
  const int s = (depth + 3) & ~3;
  return s % 8 == 0 ? s + 4 : s;
}

template <typename T>
__global__ void __launch_bounds__(128)
window_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ dao, const float* __restrict__ bias,
                  T* __restrict__ attn, float* __restrict__ dq, float* __restrict__ dk,
                  float* __restrict__ dv, float* __restrict__ dl_out, int L, int C, int heads,
                  int bias_heads, int mask_tokens, float dscale, vptr_dropout::Params drop) {
  extern __shared__ float4 smem4[];
  const int hd = C / heads;
  const int stride = row_stride(hd);
  const int ws = kMaxTokens + 1;
  float* qs = reinterpret_cast<float*>(smem4);   // [L][stride] q * scale (rounded to T)
  float* ks = qs + L * stride;                    // [L][stride]
  float* vs = ks + L * stride;                    // [L][stride]
  float* das = vs + L * stride;                   // [L][stride] d(attn) of this head, f32
  float* wd = das + L * stride;                   // [L][ws] dropped weights, rounded to T
  float* dls = wd + L * ws;                       // [L][ws] logit gradients

  const int win = blockIdx.x / heads, h = blockIdx.x - win * heads;
  const long row0 = static_cast<long>(win) * L;
  const int col0 = h * hd;
  for (int i = threadIdx.x; i < L * stride; i += blockDim.x) {
    const int r = i / stride, d = i - r * stride;
    float a = 0.f, b = 0.f, c = 0.f, e = 0.f;
    if (d < hd) {
      const long o = (row0 + r) * C + col0 + d;
      a = to_f32(q[o]);
      b = to_f32(k[o]);
      c = to_f32(v[o]);
      e = dao[o];
    }
    qs[i] = a, ks[i] = b, vs[i] = c, das[i] = e;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  const float* bias_h =
      bias ? bias + static_cast<long>(bias_heads == 1 ? 0 : h) * L * L : nullptr;
  auto dot = [&](const float* a, const float* b) {
    float acc = 0.f;
    for (int d = 0; d < stride; d += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(a + d);
      const float4 y4 = *reinterpret_cast<const float4*>(b + d);
      acc = fmaf(x4.x, y4.x, acc);
      acc = fmaf(x4.y, y4.y, acc);
      acc = fmaf(x4.z, y4.z, acc);
      acc = fmaf(x4.w, y4.w, acc);
    }
    return acc;
  };
  for (int r = warp; r < L; r += 4) {
    const bool col = lane < L;
    float logit = -INFINITY;
    if (col) {
      logit = dot(qs + r * stride, ks + lane * stride);
      if (bias_h) logit += bias_h[r * L + lane];
    }
    const float m = warp_max(logit);
    const float e = col ? expf(logit - m) : 0.f;
    const float w = e / warp_sum(e);                  // pre-dropout, f32
    float dw = col ? dot(das + r * stride, vs + lane * stride) : 0.f;
    float w_drop = w;
    if (drop.active() && col) {
      const bool kept = drop.keep(
          vptr_dropout::element_index(win, heads, h, mask_tokens, r, mask_tokens, lane), seed);
      w_drop = drop.apply(w, kept);
      dw = drop.apply(dw, kept);
    }
    const float s = warp_sum(col ? dw * w : 0.f);
    if (col) {
      const float dl = w * (dw - s);
      wd[r * ws + lane] = round_t<T>(w_drop);
      dls[r * ws + lane] = dl;
      if (dl_out) dl_out[((static_cast<long>(win) * heads + h) * L + r) * L + lane] = dl;
    }
  }
  __syncthreads();

  // element (r, d): row r of attn and dq, key row r of dk and dv
  for (int i = threadIdx.x; i < L * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    float a = 0.f, aq = 0.f, ak = 0.f, av = 0.f;
    for (int c = 0; c < L; ++c) {
      a = fmaf(wd[r * ws + c], vs[c * stride + d], a);
      aq = fmaf(dls[r * ws + c], ks[c * stride + d], aq);
      ak = fmaf(dls[c * ws + r], qs[c * stride + d], ak);
      av = fmaf(wd[c * ws + r], das[c * stride + d], av);
    }
    const long o = (row0 + r) * C + col0 + d;
    attn[o] = from_f32<T>(a);
    dq[o] = aq * dscale;
    dk[o] = ak;
    dv[o] = av;
  }
}

// ---------------------------------------------------------------------------
// 7. LayerNorm backward, one warp per row:
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
// 8. Column sums over the R rows in two fixed-order passes: chunk partials
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

// dbias[hb][r][c] = sum over windows (and over heads for a one-head bias)
// of dl[w][h][r][c], in a fixed order.
__global__ void bias_grad_kernel(const float* __restrict__ dl, float* __restrict__ dbias,
                                 int windows, int heads, int L, int bias_heads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bias_heads * L * L) return;
  const int hb = i / (L * L), rc = i - hb * L * L;
  const int h0 = bias_heads == 1 ? 0 : hb, h1 = bias_heads == 1 ? heads : hb + 1;
  float acc = 0.f;
  for (int h = h0; h < h1; ++h)
    for (int w = 0; w < windows; ++w)
      acc += dl[(static_cast<long>(w) * heads + h) * L * L + rc];
  dbias[i] = acc;
}

int partials(int rows) { return (rows + kChunk - 1) / kChunk; }

#define VPTR_TRY(expr)                      \
  do {                                      \
    const cudaError_t err_ = (expr);        \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)

// The products of the tensor-core route (steps 2, 3, 5, 6; see tc_gemm);
// a.xqk and a.xn are the projections' inputs.
template <bool LN>
int tc_products(const BwdArgs& a, int step, cudaStream_t s) {
  const int L = a.tokens, C = a.channels, R = a.windows * a.tokens;
  const float* scale = static_cast<const float*>(a.scale);
  TcBatch tb{};
  tb.lda = C, tb.ldb = C, tb.ldo = C, tb.group = L, tb.ksplit = 1;
  if (step == 2) {           // q, k, v, then d(attn)
    tb.M = R, tb.N = C, tb.K = C, tb.kchunk = C;
    tb.job[0] = tc_job({a.xqk}, {a.wq}, a.q, a.bq, a.qscale);
    tb.job[1] = tc_job({a.xqk}, {a.wk}, a.k, a.bk);
    tb.job[2] = tc_job({a.xn}, {a.wv}, a.v, a.bv);
    VPTR_TRY((tc_gemm<false, false, bf16, kProj>(tb, 3, s)));
    tb.job[0] = tc_job({a.g}, {a.wo}, a.dao, nullptr, 1.f, scale);
    return tc_gemm<false, true, float, kF32>(tb, 1, s);
  }
  const long n = static_cast<long>(R) * C;
  const bf16* hl = static_cast<const bf16*>(a.hilo);
  split_kernel<<<dim3(static_cast<unsigned>((n + 255) / 256), 4), 256, 0, s>>>(
      static_cast<const float*>(a.dq), static_cast<const float*>(a.dk),
      static_cast<const float*>(a.dv), static_cast<const bf16*>(a.g), scale,
      static_cast<bf16*>(a.hilo), n, C, L);
  VPTR_TRY(cudaGetLastError());
  // weight gradients X^T dY, K = R in ksplit chunks into wpart
  tb.M = C, tb.N = C, tb.K = R, tb.ksplit = a.ksplit;
  tb.kchunk = ((R + a.ksplit - 1) / a.ksplit + TBK - 1) / TBK * TBK;
  const long cc = static_cast<long>(C) * C;
  float* wpart = static_cast<float*>(a.wpart);
  const void* xs[4] = {a.xqk, a.xqk, a.xn, a.attn};
  for (int j = 0; j < 4; ++j)
    tb.job[j] = tc_job({xs[j], xs[j]}, {hl + 2 * j * n, hl + (2 * j + 1) * n},
                       wpart + j * a.ksplit * cc);
  VPTR_TRY((tc_gemm<true, false, float, kPartial>(tb, 4, s)));
  tb.M = R, tb.N = C, tb.K = C, tb.ksplit = 1, tb.kchunk = C;
  if constexpr (LN) {
    // d(xn) = dq Wq^T + dk Wk^T + dv Wv^T, six terms, into dao's memory
    tb.job[0] = tc_job({hl, hl + n, hl + 2 * n, hl + 3 * n, hl + 4 * n, hl + 5 * n},
                       {a.wq, a.wq, a.wk, a.wk, a.wv, a.wv}, a.dao);
    return tc_gemm<false, true, float, kF32>(tb, 1, s);
  }
  // dx_qk = dq Wq^T + dk Wk^T (four terms) and dx_v = dv Wv^T (two), in T
  tb.job[0] = tc_job({hl, hl + n, hl + 2 * n, hl + 3 * n}, {a.wq, a.wq, a.wk, a.wk}, a.dx);
  tb.job[1] = tc_job({hl + 4 * n, hl + 5 * n}, {a.wv, a.wv}, a.dxv);
  return tc_gemm<false, true, bf16, kF32>(tb, 2, s);
}

template <typename T, bool LN>
int run(const BwdArgs& args, cudaStream_t s) {
  BwdArgs a = args;
  if constexpr (!LN) {   // the projections' inputs are the two streams
    a.xqk = const_cast<void*>(args.x);
    a.xn = const_cast<void*>(args.xv);
  }
  const int L = a.tokens, C = a.channels, R = a.windows * a.tokens;
  const bool tc_route = std::is_same<T, bf16>::value && C % 8 == 0 && R % 8 == 0;
  const float* scale = static_cast<const float*>(a.scale);
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };

  // 1. LayerNorm rows
  if constexpr (LN) {
    ln_rows_kernel<T><<<(R + 7) / 8, 256, 0, s>>>(
        static_cast<const T*>(a.x), cf(a.ls), cf(a.lb), cf(a.pos), f(a.mean), f(a.rstd),
        static_cast<T*>(a.xn), static_cast<T*>(a.xqk), R, L, C, a.eps);
    VPTR_TRY(cudaGetLastError());
  }

  // 2. q, k, v;  3. d(attn) = (g Wo^T) * scale[window]
  GemmBatch gb{};
  gb.M = R, gb.N = C, gb.K = C, gb.lda = C, gb.ldb = C, gb.ldo = C, gb.group = L;
  gb.ksplit = 1, gb.kchunk = C;
  if (tc_route) {
    VPTR_TRY(static_cast<cudaError_t>(tc_products<LN>(a, 2, s)));
  } else {
    gb.job[0] = {a.xqk, a.wq, a.q, cf(a.bq), a.qscale, nullptr, nullptr, 0};
    gb.job[1] = {a.xqk, a.wk, a.k, cf(a.bk), 1.f, nullptr, nullptr, 0};
    gb.job[2] = {a.xn, a.wv, a.v, cf(a.bv), 1.f, nullptr, nullptr, 0};
    VPTR_TRY((gemm<T, false, T, false, T, kProj>(gb, 3, s)));
    gb.job[0] = {a.g, a.wo, a.dao, nullptr, 1.f, nullptr, scale, 0};
    VPTR_TRY((gemm<T, false, T, true, float, kF32>(gb, 1, s)));
  }

  // 4. attention backward per (window, head)
  const int hd = C / a.heads;
  const size_t wsmem = sizeof(float) * (4 * L * row_stride(hd) + 2 * L * (kMaxTokens + 1));
  VPTR_TRY(cudaFuncSetAttribute(window_bwd_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(wsmem)));
  const vptr_dropout::Params drop{static_cast<const int*>(a.seed), a.rate, a.keep_div};
  window_bwd_kernel<T><<<a.windows * a.heads, 128, wsmem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      cf(a.dao), cf(a.bias), static_cast<T*>(a.attn), f(a.dq), f(a.dk), f(a.dv), f(a.dl), L,
      C, a.heads, a.bias_heads, a.mask_tokens, a.dscale, drop);
  VPTR_TRY(cudaGetLastError());

  // 5. weight gradients X^T dY: K = R rows in ksplit chunks, each chunk's
  //    f32 sums to wpart, then their sum in chunk order, cast to T;
  // 6. LN: d(xn) = dq Wq^T + dk Wk^T + dv Wv^T, into dao's memory (dao is
  //    done); no LN: dx_qk and dx_v
  const long cc = static_cast<long>(C) * C;
  float* wpart = f(a.wpart);
  void* dxn = a.dao;
  if (tc_route) {
    VPTR_TRY(static_cast<cudaError_t>(tc_products<LN>(a, 5, s)));
  } else {
    GemmBatch gw{};
    gw.M = C, gw.N = C, gw.K = R, gw.lda = C, gw.ldb = C, gw.ldo = C, gw.group = L;
    gw.ksplit = a.ksplit;
    gw.kchunk = ((R + a.ksplit - 1) / a.ksplit + BK - 1) / BK * BK;
    gw.job[0] = {a.xqk, a.dq, wpart, nullptr, 1.f, nullptr, nullptr, 0};
    gw.job[1] = {a.xqk, a.dk, wpart + a.ksplit * cc, nullptr, 1.f, nullptr, nullptr, 0};
    gw.job[2] = {a.xn, a.dv, wpart + 2 * a.ksplit * cc, nullptr, 1.f, nullptr, nullptr, 0};
    VPTR_TRY((gemm<T, true, float, false, float, kPartial>(gw, 3, s)));
    gw.job[0] = {a.attn, a.g, wpart + 3 * a.ksplit * cc, nullptr, 1.f, scale, nullptr, 0};
    VPTR_TRY((gemm<T, true, T, false, float, kPartial>(gw, 1, s)));
    // d(xn) (LN) or dx_qk (no LN) summed in f32 in dao's memory; dx_v
    // is one product, written in T
    const void* dys[3] = {a.dq, a.dk, a.dv};
    const void* ws[3] = {a.wq, a.wk, a.wv};
    for (int j = 0; j < (LN ? 3 : 2); ++j) {
      gb.job[0] = {dys[j], ws[j], dxn, nullptr, 1.f, nullptr, nullptr, j > 0};
      VPTR_TRY((gemm<float, false, T, true, float, kF32>(gb, 1, s)));
    }
    if constexpr (!LN) {
      gb.job[0] = {a.dv, a.wv, a.dxv, nullptr, 1.f, nullptr, nullptr, 0};
      VPTR_TRY((gemm<float, false, T, true, T, kF32>(gb, 1, s)));
      SplitSum cast{};   // dx_qk: the f32 sum cast to T
      cast.part[0] = cf(dxn), cast.out[0] = a.dx, cast.ksplit = 1;
      cast.n = static_cast<long>(R) * C;
      split_sum_kernel<T><<<dim3(static_cast<unsigned>((cast.n + 255) / 256), 1), 256, 0,
                            s>>>(cast);
      VPTR_TRY(cudaGetLastError());
    }
  }
  SplitSum ss{};
  void* dws[4] = {a.dwq, a.dwk, a.dwv, a.dwo};
  for (int j = 0; j < 4; ++j) ss.part[j] = wpart + j * a.ksplit * cc, ss.out[j] = dws[j];
  ss.ksplit = a.ksplit, ss.n = cc;
  split_sum_kernel<T><<<dim3(static_cast<unsigned>((cc + 255) / 256), 4), 256, 0, s>>>(ss);
  VPTR_TRY(cudaGetLastError());

  // 7. dx
  if constexpr (LN) {
    ln_bwd_kernel<T><<<(R + 7) / 8, 256, 0, s>>>(
        cf(dxn), static_cast<const T*>(a.x), cf(a.mean), cf(a.rstd), cf(a.ls),
        static_cast<const T*>(a.g), static_cast<T*>(a.dx), R, C, a.res);
    VPTR_TRY(cudaGetLastError());
  }

  // 8. bias and LayerNorm-affine gradients
  ColBatch cb{};
  cb.job[0] = {a.dq, 0, nullptr, 0, f(a.dbq)};
  cb.job[1] = {a.dk, 0, nullptr, 0, f(a.dbk)};
  cb.job[2] = {a.dv, 0, nullptr, 0, f(a.dbv)};
  cb.job[3] = {a.g, 1, scale, 0, f(a.dbo)};
  cb.job[4] = {dxn, 0, nullptr, 0, f(a.dlb)};
  cb.job[5] = {dxn, 0, nullptr, 1, f(a.dls)};
  cb.x = a.x, cb.mean = cf(a.mean), cb.rstd = cf(a.rstd), cb.partial = f(a.partial);
  cb.rows = R, cb.C = C, cb.group = L, cb.parts = partials(R);
  const int cols = LN ? 6 : 4;   // dbq, dbk, dbv, dbo (+ dlb, dls)
  colsum_partial_kernel<T><<<dim3((C + 127) / 128, cb.parts, cols), 128, 0, s>>>(cb);
  VPTR_TRY(cudaGetLastError());
  colsum_final_kernel<<<dim3((C + 127) / 128, cols), 128, 0, s>>>(cb);
  VPTR_TRY(cudaGetLastError());
  if (a.dl) {
    const int n = a.bias_heads * L * L;
    bias_grad_kernel<<<(n + 255) / 256, 256, 0, s>>>(cf(a.dl), f(a.dbias), a.windows,
                                                     a.heads, L, a.bias_heads);
    VPTR_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

// Checks the arguments, then runs the passes for T (dtype 0 = float32,
// 1 = bfloat16). Returns a cudaError_t (0 = every pass launched).
template <bool LN>
int run_backward(const BwdArgs* a, cudaStream_t s) {
  if (!a || a->windows < 1 || a->tokens < 1 || a->tokens > kMaxTokens || a->heads < 1 ||
      a->channels % a->heads != 0 || a->channels / a->heads > kMaxHeadDim ||
      (a->bias && a->bias_heads != 1 && a->bias_heads != a->heads) ||
      (a->dl && (!a->bias || !a->dbias)) || a->dtype < 0 || a->dtype > 1 ||
      (a->rate > 0.f && !a->seed) || a->rate >= 1.f || a->mask_tokens < a->tokens ||
      a->ksplit < 1 || !a->wpart || (a->dtype == 1 && !a->hilo) ||
      (LN && (!a->xn || !a->xqk || !a->mean || !a->rstd)) ||
      (!LN && (!a->xv || !a->dxv || a->res || a->scale)))
    return cudaErrorInvalidValue;
  return a->dtype == 0 ? run<float, LN>(*a, s) : run<bf16, LN>(*a, s);
}

}  // namespace
