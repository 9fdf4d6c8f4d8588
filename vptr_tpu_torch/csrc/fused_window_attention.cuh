// Window self-attention sublayer forward on Hopper (sm_90a), shared by two
// libraries through the template flag LN:
//   LN = true  (fused_window_attention_ln.cu, kernel #1):
//     xn  = LN(x) * ls + lb,  xqk = xn + pos          (both rounded to T)
//   LN = false (fused_window_attention.cu, kernel #5):
//     xqk = x_qk,  xn = x_v                            (two input streams)
// then, for both:
//     q,k = xqk Wq|Wk + bq|bk,  v = xn Wv + bv          (f32 sums, to T)
//     a_h = dropout(softmax(q_h k_h^T * hd^-1/2 + bias_h)) v_h  (per head)
//     out = [a_1 .. a_H] Wo + bo,  then * scale[window], + x when res (LN)
// Activations (B, L, C) with L <= 32 tokens per window; W*: (C, C) stored
// (in, out) like the JAX Dense kernels; biases, ls, lb, pos (L, C), bias
// (1|H, L, L) and scale (B,) are f32; T = float or bf16.
//
// Both routes keep every intermediate (xn, xqk, q/k/v, logits, weights,
// merged heads) in shared memory: device memory sees the activations once,
// the weights (L2-resident, shared by all blocks) and the output once.
//
// * Tensor-core route (bf16, C % 16 == 0 -- the serving path): one block
//   takes 48 rows, i.e. the whole windows that fit (three 16-token
//   windows), zero-padded to three 16-row tiles. Twelve warps share the
//   q/k column tiles (2 C/16 of them), then the v tiles, then the
//   out-projection tiles; each warp runs WMMA bf16 16x16x16 products with
//   f32 accumulators over the three row tiles, so every weight tile read
//   from L2 feeds three products, and streams its weight tiles through a
//   private 4-slot cp.async ring in shared memory. The weight traffic from
//   L2 (4 C^2 bf16 per block) is what the block count multiplies, so rows
//   per block are as many as shared memory allows: four 48-row bf16
//   activation buffers (xn, xqk, q, k; v and the merged heads reuse freed
//   ones). The two input streams of LN = false land in the same two
//   buffers LN = true fills with xn and xqk, so both take the same shared
//   memory. The accumulators go through a per-warp f32 staging tile where
//   the bias add and the rounding to bf16 happen, exactly as in the plain
//   version. Attention runs one warp per (window, head): two lanes per
//   query row hold its logits in registers (L <= 16; one lane for
//   L <= 32), softmax by one shuffle, then the row's lanes split the head
//   width for the weighted sum of v.
// * FMA route (f32, or a width the first cannot take): one block per
//   window, heads one at a time; each thread owns one output column of
//   q_h, k_h or v_h and keeps its L row sums in registers, reading the
//   activation rows as float4 broadcasts. The per-head tiles use an odd
//   row stride so column reads across rows are free of bank conflicts.
//
// Attention-weight dropout is the counter hash of hash_dropout.cuh,
// indexed by the padded token count mask_tokens, as the TPU kernels pad L.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cuda_pipeline.h>
#include <mma.h>

#include "hash_dropout.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTokens = 32;
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
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

// Everything a forward launch takes (pointers into device memory; ls, lb,
// pos, scale and res belong to LN = true, xv to LN = false).
struct FwdArgs {
  const void *x, *xv, *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo, *ls, *lb, *pos, *bias, *scale;
  void* out;
  int windows, L, C, heads, bias_heads, res;
  float qscale, eps;
  vptr_dropout::Params drop;
  int mask_tokens;
};

// acc[r] += sum_k A[r][k] * W[k][col] for r < rows. A lives in shared
// memory with row stride lda (a multiple of 4, zero-padded past C); W is a
// (C, C) row-major matrix in device memory.
template <typename T, int MAXL>
__device__ __forceinline__ void column_dot(const float* __restrict__ A, int lda,
                                           const T* __restrict__ W, int C, int col,
                                           int rows, float (&acc)[MAXL]) {
#pragma unroll
  for (int r = 0; r < MAXL; ++r) acc[r] = 0.f;
  for (int kk = 0; kk < lda; kk += 4) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = kk + i < C ? to_f32(W[static_cast<long>(kk + i) * C + col]) : 0.f;
#pragma unroll
    for (int r = 0; r < MAXL; ++r) {
      if (r < rows) {
        const float4 a = *reinterpret_cast<const float4*>(A + r * lda + kk);
        acc[r] = fmaf(a.x, w[0], acc[r]);
        acc[r] = fmaf(a.y, w[1], acc[r]);
        acc[r] = fmaf(a.z, w[2], acc[r]);
        acc[r] = fmaf(a.w, w[3], acc[r]);
      }
    }
  }
}

template <typename T, int MAXL, bool LN>
__global__ void __launch_bounds__(kThreads)
fused_window_attention_kernel(
    const T* __restrict__ x, const T* __restrict__ xv, const T* __restrict__ wq,
    const float* __restrict__ bq, const T* __restrict__ wk, const float* __restrict__ bk,
    const T* __restrict__ wv, const float* __restrict__ bv, const T* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ ls, const float* __restrict__ lb,
    const float* __restrict__ pos, const float* __restrict__ bias,
    const float* __restrict__ scale, T* __restrict__ out, int L, int C, int heads,
    int bias_heads, int res, float qscale, float eps, vptr_dropout::Params drop,
    int mask_tokens) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lda = (C + 3) & ~3;
  const int hd = C / heads;
  const int hs = hd | 1;
  float* xn = smem;                    // [L][lda]  LN(x) * ls + lb (or x_v), rounded to T
  float* xqk = xn + L * lda;           // [L][lda]  xn + pos (or x_qk), rounded to T
  float* att = xqk + L * lda;          // [L][lda]  merged head outputs, rounded to T
  float* qh = att + L * lda;           // [L][hs]   q_h * hd^-1/2, rounded to T
  float* kh = qh + L * hs;             // [L][hs]
  float* vh = kh + L * hs;             // [L][hs]

  const long win = blockIdx.x;
  const T* xw = x + win * L * C;
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if constexpr (LN) {
    // 1) LayerNorm, one warp per row, f32 statistics
    for (int r = warp; r < L; r += kWarps) {
      const T* xr = xw + r * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
      const float mean = warp_sum(s) / C;
      float ss = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f32(xr[c]) - mean;
        ss = fmaf(d, d, ss);
      }
      const float rstd = rsqrtf(warp_sum(ss) / C + eps);
      for (int c = lane; c < lda; c += 32) {
        float n = 0.f, nq = 0.f;
        if (c < C) {
          n = round_t<T>((to_f32(xr[c]) - mean) * rstd * ls[c] + lb[c]);
          nq = pos ? round_t<T>(n + round_t<T>(pos[r * C + c])) : n;
        }
        xn[r * lda + c] = n;
        xqk[r * lda + c] = nq;
        att[r * lda + c] = 0.f;
      }
    }
  } else {
    // 1) the two input streams as they are
    const T* xvw = xv + win * L * C;
    for (int i = threadIdx.x; i < L * lda; i += kThreads) {
      const int r = i / lda, c = i - r * lda;
      xqk[i] = c < C ? to_f32(xw[r * C + c]) : 0.f;
      xn[i] = c < C ? to_f32(xvw[r * C + c]) : 0.f;
      att[i] = 0.f;
    }
  }
  __syncthreads();

  // 2) one head at a time: project q_h, k_h, v_h, then attend
  for (int h = 0; h < heads; ++h) {
    for (int t = threadIdx.x; t < 3 * hd; t += kThreads) {
      const int m = t / hd;            // 0: q, 1: k, 2: v
      const int j = t - m * hd;
      const int col = h * hd + j;
      float acc[MAXL];
      column_dot<T, MAXL>(m == 2 ? xn : xqk, lda, m == 0 ? wq : (m == 1 ? wk : wv), C,
                          col, L, acc);
      const float b = (m == 0 ? bq : (m == 1 ? bk : bv))[col];
      float* dst = m == 0 ? qh : (m == 1 ? kh : vh);
#pragma unroll
      for (int r = 0; r < MAXL; ++r) {
        if (r < L) {
          float y = round_t<T>(acc[r] + b);
          if (m == 0) y = round_t<T>(y * qscale);
          dst[r * hs + j] = y;
        }
      }
    }
    __syncthreads();

    const float* bias_h =
        bias ? bias + static_cast<long>(bias_heads == 1 ? 0 : h) * L * L : nullptr;
    for (int r = warp; r < L; r += kWarps) {
      float logit = -INFINITY;
      if (lane < L) {
        const float* qr = qh + r * hs;
        const float* kr = kh + lane * hs;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
        logit = bias_h ? acc + bias_h[r * L + lane] : acc;
      }
      const float mx = warp_max(logit);
      const float e = lane < L ? expf(logit - mx) : 0.f;
      float w = e / warp_sum(e);
      if (drop.active() && lane < L)
        w = drop.apply(w, drop.keep(vptr_dropout::element_index(
                                        static_cast<uint32_t>(win), heads, h, mask_tokens,
                                        r, mask_tokens, lane),
                                    seed));
      w = round_t<T>(w);
      for (int d0 = 0; d0 < hd; d0 += 32) {
        const int d = d0 + lane;
        float acc = 0.f;
        for (int c = 0; c < L; ++c) {
          const float wc = __shfl_sync(0xffffffffu, w, c);
          if (d < hd) acc = fmaf(wc, vh[c * hs + d], acc);
        }
        if (d < hd) att[r * lda + h * hd + d] = round_t<T>(acc);
      }
    }
    __syncthreads();
  }

  // 3) output projection in f32 + bo, then the branch scale and residual
  T* ow = out + win * L * C;
  const float sc = scale ? scale[win] : 1.f;
  for (int j = threadIdx.x; j < C; j += kThreads) {
    float acc[MAXL];
    column_dot<T, MAXL>(att, lda, wo, C, j, L, acc);
#pragma unroll
    for (int r = 0; r < MAXL; ++r) {
      if (r < L) {
        float y = acc[r] + bo[j];
        if (scale) y *= sc;
        if (res) y += to_f32(xw[r * C + j]);
        ow[r * C + j] = from_f32<T>(y);
      }
    }
  }
}

template <typename T, int MAXL, bool LN>
int launch(const FwdArgs& a, size_t smem, cudaStream_t stream) {
  auto kernel = fused_window_attention_kernel<T, MAXL, LN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<a.windows, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.xv), static_cast<const T*>(a.wq),
      static_cast<const float*>(a.bq), static_cast<const T*>(a.wk),
      static_cast<const float*>(a.bk), static_cast<const T*>(a.wv),
      static_cast<const float*>(a.bv), static_cast<const T*>(a.wo),
      static_cast<const float*>(a.bo), static_cast<const float*>(a.ls),
      static_cast<const float*>(a.lb), static_cast<const float*>(a.pos),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.scale),
      static_cast<T*>(a.out), a.L, a.C, a.heads, a.bias_heads, a.res, a.qscale, a.eps, a.drop,
      a.mask_tokens);
  return cudaGetLastError();
}

template <typename T, bool LN>
int launch_rows(const FwdArgs& a, size_t smem, cudaStream_t s) {
  if (a.L <= 16) return launch<T, 16, LN>(a, smem, s);
  return launch<T, 32, LN>(a, smem, s);
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16)

using bf16 = __nv_bfloat16;
using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

constexpr int kTcWarps = 12;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 48;          // rows per block: three 16-row tiles
constexpr int kStages = 4;           // weight-tile ring slots per warp
constexpr long kSmemLimit = 232448;  // bytes a block may opt in to on sm_90

long tc_smem(int C) {
  return 4L * kTcRows * (C + 8) * sizeof(bf16)           // xn, xqk, q, k
         + kTcWarps * kStages * 256L * sizeof(bf16);     // rings (= staging)
}

long fma_smem(int L, int C, int heads) {
  const long lda = (C + 3) & ~3;
  const long hs = (C / heads) | 1;
  return static_cast<long>(sizeof(float)) * (3 * L * lda + 3 * L * hs);
}

bool use_tc(int L, int C, int dtype) {
  return dtype == 1 && C % 16 == 0 && L <= 32 && tc_smem(C) <= kSmemLimit;
}

// Dynamic shared memory of the route (L, C, heads, dtype) takes.
long window_smem(int L, int C, int heads, int dtype) {
  return use_tc(L, C, dtype) ? tc_smem(C) : fma_smem(L, C, heads);
}

// c_t = A[16t:16t+16, :] W[:, n0:n0+16] for the three row tiles t; A is
// (48, C) bf16 in shared memory with row stride lda, W (C, C) row-major in
// device memory. Each weight tile feeds three MMAs. The weight tiles come
// from L2, hundreds of cycles away, so the warp streams them through its
// own ring of kStages 16x16 tiles in shared memory with cp.async (16 bytes
// per lane per tile), keeping kStages - 1 tiles in flight.
__device__ __forceinline__ void tile_gemm(const bf16* A, int lda, const bf16* __restrict__ W,
                                          int C, int n0, bf16* ring, int lane, Acc& c0,
                                          Acc& c1, Acc& c2) {
  using namespace nvcuda;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
  const int nk = C / 16;
  const int row = lane >> 1;
  const int half = (lane & 1) * 8;
  auto fetch = [&](int kt) {
    if (kt < nk)
      __pipeline_memcpy_async(ring + (kt % kStages) * 256 + row * 16 + half,
                              W + static_cast<long>(kt * 16 + row) * C + n0 + half, 16);
    __pipeline_commit();
  };
  wmma::fill_fragment(c0, 0.f);
  wmma::fill_fragment(c1, 0.f);
  wmma::fill_fragment(c2, 0.f);
  for (int kt = 0; kt < kStages - 1; ++kt) fetch(kt);
  for (int kt = 0; kt < nk; ++kt) {
    fetch(kt + kStages - 1);           // into the slot read at kt - 1
    __pipeline_wait_prior(kStages - 1);
    __syncwarp();
    wmma::load_matrix_sync(b, ring + (kt % kStages) * 256, 16);
    wmma::load_matrix_sync(a, A + kt * 16, lda);
    wmma::mma_sync(c0, a, b, c0);
    wmma::load_matrix_sync(a, A + 16 * lda + kt * 16, lda);
    wmma::mma_sync(c1, a, b, c1);
    wmma::load_matrix_sync(a, A + 32 * lda + kt * 16, lda);
    wmma::mma_sync(c2, a, b, c2);
    __syncwarp();
  }
  __pipeline_wait_prior(0);
}

// Row tile t of the accumulators into the warp's f32 staging tile (the
// ring's memory, free once tile_gemm returns).
__device__ __forceinline__ void stage_tile(float* stage, int t, const Acc& c0, const Acc& c1,
                                           const Acc& c2) {
  using namespace nvcuda;
  wmma::store_matrix_sync(stage, t == 0 ? c0 : (t == 1 ? c1 : c2), 16, wmma::mem_row_major);
  __syncwarp();
}

// dst[0:48, n0:n0+16] = bf16(bf16(acc + bias) * mul): the plain version's
// rounding points.
__device__ __forceinline__ void store_projection(float* stage, const Acc& c0, const Acc& c1,
                                                 const Acc& c2, const float* __restrict__ bias,
                                                 float mul, bf16* dst, int ld, int n0,
                                                 int lane) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    stage_tile(stage, t, c0, c1, c2);
    for (int e = lane; e < 256; e += 32) {
      const int col = n0 + (e & 15);
      float y = round_t<bf16>(stage[e] + bias[col]);
      if (mul != 1.f) y *= mul;
      dst[(t * 16 + (e >> 4)) * ld + col] = __float2bfloat16_rn(y);
    }
    __syncwarp();
  }
}

// One warp attends one head of one window. P lanes share a query row
// (P = 2 for L <= 16, 1 for L <= 32), each holding MAXC key columns of its
// row's logits in registers: logits by f32 FMAs over the head width,
// softmax with one shuffle between the P lanes, then the lanes of a row
// split the head width for the weighted sum of v.
template <int P, int MAXC>
__device__ __forceinline__ void head_attention(const bf16* qb, const bf16* kb, const bf16* vb,
                                               bf16* ob, int ld, int L, int hd, int c0l,
                                               int wrow0, const float* bias_h, int lane,
                                               const vptr_dropout::Params& drop,
                                               uint32_t seed, uint32_t win, int heads,
                                               int h, int lp) {
  const int i = lane / P;              // query row
  const int part = lane % P;
  const int cpl = (L + P - 1) / P;     // key columns per lane
  const bool active = i < L;
  float lg[MAXC];
#pragma unroll
  for (int jj = 0; jj < MAXC; ++jj) lg[jj] = 0.f;
  if (active) {
    const bf16* qr = qb + (wrow0 + i) * ld + c0l;
    const bf16* kr = kb + (wrow0 + part * cpl) * ld + c0l;
    for (int d = 0; d < hd; ++d) {
      const float qd = __bfloat162float(qr[d]);
#pragma unroll
      for (int jj = 0; jj < MAXC; ++jj)
        if (jj < cpl && part * cpl + jj < L)
          lg[jj] = fmaf(qd, __bfloat162float(kr[jj * ld + d]), lg[jj]);
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < MAXC; ++jj) {
    const int j = part * cpl + jj;
    if (active && jj < cpl && j < L) {
      if (bias_h) lg[jj] += bias_h[i * L + j];
      m = fmaxf(m, lg[jj]);
    }
  }
  if (P == 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  float s = 0.f;
#pragma unroll
  for (int jj = 0; jj < MAXC; ++jj) {
    const bool ok = active && jj < cpl && part * cpl + jj < L;
    lg[jj] = ok ? expf(lg[jj] - m) : 0.f;
    s += lg[jj];
  }
  if (P == 2) s += __shfl_xor_sync(0xffffffffu, s, 1);
  float wp[MAXC];                      // the other lane's weights (P == 2)
#pragma unroll
  for (int jj = 0; jj < MAXC; ++jj) {
    float w = lg[jj] / s;
    const int j = part * cpl + jj;
    if (drop.active() && active && jj < cpl && j < L)
      w = drop.apply(w, drop.keep(vptr_dropout::element_index(win, heads, h, lp, i, lp, j),
                                  seed));
    lg[jj] = active ? round_t<bf16>(w) : 0.f;
    wp[jj] = P == 2 ? __shfl_xor_sync(0xffffffffu, lg[jj], 1) : 0.f;
  }
  if (!active) return;
  const int dh = (hd + P - 1) / P;
  const int dhi = min(hd, (part + 1) * dh);
  for (int d = part * dh; d < dhi; ++d) {
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < P; ++q) {
#pragma unroll
      for (int jj = 0; jj < MAXC; ++jj) {
        const int c = q * cpl + jj;
        if (jj < cpl && c < L) {
          const float wc = (P == 1 || q == part) ? lg[jj] : wp[jj];
          acc = fmaf(wc, __bfloat162float(vb[(wrow0 + c) * ld + c0l + d]), acc);
        }
      }
    }
    ob[(wrow0 + i) * ld + c0l + d] = __float2bfloat16_rn(acc);
  }
}

template <bool LN>
__global__ void __launch_bounds__(kTcThreads)
fused_window_attention_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ xv, const bf16* __restrict__ wq,
    const float* __restrict__ bq, const bf16* __restrict__ wk, const float* __restrict__ bk,
    const bf16* __restrict__ wv, const float* __restrict__ bv, const bf16* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ ls, const float* __restrict__ lb,
    const float* __restrict__ pos, const float* __restrict__ bias,
    const float* __restrict__ scale, bf16* __restrict__ out, int windows, int L, int C,
    int heads, int bias_heads, int res, float qscale, float eps, vptr_dropout::Params drop,
    int mask_tokens) {
  // wmma needs 256-bit aligned tiles: every buffer below is a multiple of
  // 512 bytes long and every tile offset a multiple of 32 bytes
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int ld = C + 8;                // row stride: a multiple of 8 elements
  bf16* xn = reinterpret_cast<bf16*>(smem_tc);  // [48][ld] LN(x)*ls+lb or x_v, then heads
  bf16* xqk = xn + kTcRows * ld;       // [48][ld] xn + pos or x_qk, then v
  bf16* qb = xqk + kTcRows * ld;       // [48][ld] q * hd^-1/2
  bf16* kb = qb + kTcRows * ld;        // [48][ld] k
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bf16* ring = kb + kTcRows * ld + warp * kStages * 256;
  float* stage = reinterpret_cast<float*>(ring);

  const int wpb = kTcRows / L;         // whole windows per block
  const long win0 = static_cast<long>(blockIdx.x) * wpb;
  const int nwin = windows - win0 < wpb ? static_cast<int>(windows - win0) : wpb;
  const int rows = nwin * L;
  const bf16* xb = x + win0 * L * C;

  if constexpr (LN) {
    // 1) LayerNorm, one warp per row, f32 statistics; padding rows are zero
    for (int r = warp; r < kTcRows; r += kTcWarps) {
      if (r < rows) {
        const bf16* xr = xb + static_cast<long>(r) * C;
        const float* pr = pos ? pos + static_cast<long>(r % L) * C : nullptr;
        float s = 0.f;
        for (int c = lane; c < C; c += 32) s += __bfloat162float(xr[c]);
        const float mean = warp_sum(s) / C;
        float ss = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float d = __bfloat162float(xr[c]) - mean;
          ss = fmaf(d, d, ss);
        }
        const float rstd = rsqrtf(warp_sum(ss) / C + eps);
        for (int c = lane; c < C; c += 32) {
          const bf16 n = __float2bfloat16_rn(
              (__bfloat162float(xr[c]) - mean) * rstd * ls[c] + lb[c]);
          xn[r * ld + c] = n;
          xqk[r * ld + c] = pr ? __float2bfloat16_rn(__bfloat162float(n) +
                                                     round_t<bf16>(pr[c]))
                               : n;
        }
      } else {
        for (int c = lane; c < C; c += 32) {
          xn[r * ld + c] = __float2bfloat16_rn(0.f);
          xqk[r * ld + c] = __float2bfloat16_rn(0.f);
        }
      }
    }
  } else {
    // 1) the two input streams as they are, 8 bf16 (16 bytes) per copy;
    //    padding rows are zero
    const bf16* xvb = xv + win0 * L * C;
    const int vecs = C / 8;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < kTcRows * vecs; i += kTcThreads) {
      const int r = i / vecs, c = (i - r * vecs) * 8;
      const long o = static_cast<long>(r) * C + c;
      const bool in = r < rows;
      *reinterpret_cast<uint4*>(xqk + r * ld + c) =
          in ? *reinterpret_cast<const uint4*>(xb + o) : zero;
      *reinterpret_cast<uint4*>(xn + r * ld + c) =
          in ? *reinterpret_cast<const uint4*>(xvb + o) : zero;
    }
  }
  __syncthreads();

  // 2) q and k from xqk (2 C/16 column tiles shared by the warps), then v
  //    from xn into xqk's place
  const int nt = C / 16;
  Acc c0, c1, c2;
  for (int t = warp; t < 2 * nt; t += kTcWarps) {
    const int is_k = t >= nt;
    const int n0 = (t - is_k * nt) * 16;
    tile_gemm(xqk, ld, is_k ? wk : wq, C, n0, ring, lane, c0, c1, c2);
    store_projection(stage, c0, c1, c2, is_k ? bk : bq, is_k ? 1.f : qscale,
                     is_k ? kb : qb, ld, n0, lane);
  }
  __syncthreads();
  bf16* vb = xqk;
  for (int t = warp; t < nt; t += kTcWarps) {
    tile_gemm(xn, ld, wv, C, t * 16, ring, lane, c0, c1, c2);
    store_projection(stage, c0, c1, c2, bv, 1.f, vb, ld, t * 16, lane);
  }
  __syncthreads();

  // 3) attention: one warp per (window, head); merged heads go to xn (its
  //    padding rows stay zero)
  const int hd = C / heads;
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  for (int task = warp; task < nwin * heads; task += kTcWarps) {
    const int h = task % heads;
    const int w = task / heads;
    const float* bias_h =
        bias ? bias + static_cast<long>(bias_heads == 1 ? 0 : h) * L * L : nullptr;
    const uint32_t wg = static_cast<uint32_t>(win0 + w);
    if (L <= 16)
      head_attention<2, 8>(qb, kb, vb, xn, ld, L, hd, h * hd, w * L, bias_h, lane, drop,
                           seed, wg, heads, h, mask_tokens);
    else
      head_attention<1, 32>(qb, kb, vb, xn, ld, L, hd, h * hd, w * L, bias_h, lane, drop,
                            seed, wg, heads, h, mask_tokens);
  }
  __syncthreads();

  // 4) output projection in f32 + bo, then the branch scale and residual
  bf16* ob = out + win0 * L * C;
  for (int t = warp; t < nt; t += kTcWarps) {
    const int n0 = t * 16;
    tile_gemm(xn, ld, wo, C, n0, ring, lane, c0, c1, c2);
#pragma unroll
    for (int rt = 0; rt < 3; ++rt) {
      stage_tile(stage, rt, c0, c1, c2);
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + (e >> 4);
        if (r < rows) {
          const int col = n0 + (e & 15);
          float y = stage[e] + bo[col];
          if (scale) y *= scale[win0 + r / L];
          if (res) y += __bfloat162float(xb[static_cast<long>(r) * C + col]);
          ob[static_cast<long>(r) * C + col] = __float2bfloat16_rn(y);
        }
      }
      __syncwarp();
    }
  }
}

template <bool LN>
int launch_tc(const FwdArgs& a, cudaStream_t stream) {
  const long smem = tc_smem(a.C);
  auto kernel = fused_window_attention_tc_kernel<LN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int wpb = kTcRows / a.L;
  const int blocks = (a.windows + wpb - 1) / wpb;
  kernel<<<blocks, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.xv),
      static_cast<const bf16*>(a.wq), static_cast<const float*>(a.bq),
      static_cast<const bf16*>(a.wk), static_cast<const float*>(a.bk),
      static_cast<const bf16*>(a.wv), static_cast<const float*>(a.bv),
      static_cast<const bf16*>(a.wo), static_cast<const float*>(a.bo),
      static_cast<const float*>(a.ls), static_cast<const float*>(a.lb),
      static_cast<const float*>(a.pos), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.scale), static_cast<bf16*>(a.out), a.windows, a.L, a.C,
      a.heads, a.bias_heads, a.res, a.qscale, a.eps, a.drop, a.mask_tokens);
  return cudaGetLastError();
}

// Checks the shape and the dropout arguments, then launches the route the
// shape takes (dtype: 0 = float32, 1 = bfloat16). Returns a cudaError_t.
template <bool LN>
int launch_window_attention(const FwdArgs& a, int dtype, cudaStream_t s) {
  if (a.windows < 1 || a.L < 1 || a.L > kMaxTokens || a.heads < 1 || a.C % a.heads != 0 ||
      a.C / a.heads > kMaxHeadDim ||
      (a.bias && a.bias_heads != 1 && a.bias_heads != a.heads) || dtype < 0 || dtype > 1 ||
      window_smem(a.L, a.C, a.heads, dtype) > kSmemLimit ||
      (a.drop.rate > 0.f && !a.drop.seed) || a.drop.rate >= 1.f || a.mask_tokens < a.L ||
      (!LN && !a.xv))
    return cudaErrorInvalidValue;
  if (use_tc(a.L, a.C, dtype)) return launch_tc<LN>(a, s);
  const size_t smem = fma_smem(a.L, a.C, a.heads);
  return dtype == 0 ? launch_rows<float, LN>(a, smem, s)
                    : launch_rows<__nv_bfloat16, LN>(a, smem, s);
}

}  // namespace
