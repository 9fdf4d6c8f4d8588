// Window self-attention sublayer forward on Hopper (sm_90a), shared by two
// libraries through the template flag LN. Over R = windows * L rows of C
// channels (L <= 32 tokens a window):
//   LN = true  (fused_window_attention_ln.cu, kernel #1):
//     xn  = LN(x) * ls + lb,  xqk = xn + pos          (both rounded to T)
//   LN = false (fused_window_attention.cu, kernel #5):
//     xqk = x_qk,  xn = x_v                            (two input streams)
// then, for both:
//     q,k = xqk Wq|Wk + bq|bk,  v = xn Wv + bv          (f32 sums, to T)
//     a_h = dropout(softmax(q_h k_h^T * hd^-1/2 + bias_h)) v_h  (per head)
//     out = [a_1 .. a_H] Wo + bo,  then * scale[window], + x when res (LN)
// W*: (C, C) stored (in, out) like the JAX Dense kernels; biases, ls, lb,
// pos (L, C), bias (1|H, L, L) and scale (windows,) are f32; T = float,
// bf16 or f16 (dtype 0, 1, 2). A head subset (tensor parallelism: heads
// h0 .. h0 + H - 1 of Hg, each hd wide): Wq, Wk, Wv are (C, Cl) and Wo
// (Cl, C) with Cl = H hd the inner width, so q, k, v and the merged heads
// are R x Cl and out is this subset's share of the sum over all heads (the
// caller sums the shares and passes bo = 0 or adds it once); the dropout
// index takes the global head. Rounding points are the plain versions'
// (ops/fused_window_attention.py): xn and xqk rounded, q/k/v rounded after
// the f32 bias add, q * scale rounded, f32 softmax, the weights rounded
// after dropout, the merged heads rounded, the out projection in f32
// rounded once. Attention-weight dropout is the counter hash of
// hash_dropout.cuh, indexed by the padded token count mask_tokens, as the
// TPU kernels pad L.
//
// What bounds it on an H100: operations. The four C x C projections are
// 8 L C^2 flops a window (28.5 GFLOP at far_rip's 800 windows of 16 x 528,
// 0.029 ms at 989 TFLOP/s), against 29 MB of device-memory traffic
// (0.009 ms at 3.35 TB/s). Two routes, chosen from (L, C, dtype) before
// any launch (kernel_route in ops/fused_window_attention.py names them):
//
// * wgmma (bf16, C a multiple of 8 so that TMA rows are 16-byte aligned,
//   any number of windows): four passes through device memory. The TPU
//   kernel kept a window in VMEM; a fused block here could hold only three
//   windows (48 rows) and streamed all four weights from L2 for each, with
//   the products on WMMA over part-filled tiles. As passes, each product
//   runs over all R rows in 128-row tiles, and the intermediates' round
//   trips (xn, xqk, q, k, v, the merged heads: 6 R C bf16, partly
//   L2-resident) cost less than the products gain:
//   1. LN only: tile_ops.cuh's ln_rows_kernel (one warp a row) writes xn
//      and, with pos, xqk (its mean and rstd go to scratch); bound by bytes;
//   2. q, k, v: one launch of three products on wg_rows.cuh's row-tiled
//      product (W read MN-major as stored; as two launches it read slower
//      on an H100), the bias, the rounding and q's scale in the register
//      epilogue (kRwProj); bound by the weights each 128-row tile streams
//      from L2;
//   3. window_fwd_kernel, the attention: a block stages the q, k, v rows of
//      a window in shared memory with cp.async (whole 16-byte chunks of a
//      row: a head of 66 columns starts only 4-byte aligned) and a warp
//      takes a head: q k^T on the tensor cores (mma.sync m16n8k16, bf16 in,
//      f32 sums: the products are exact, as in the plain version's f32
//      matmul of bf16 values), the bias, the f32 softmax over the quad of
//      lanes that holds a row, the hash dropout, the weights rounded to
//      bf16 straight into the A fragments of P v (the logits' accumulator
//      layout is the A operand's), P v on mma.sync, the merged heads
//      rounded and written back over the head's q columns, then the rows
//      stored whole. Any L <= 32: one 16-row query tile for L <= 16, two for
//      L <= 32, keys and rows past L read as zero. Bound by the bytes it
//      stages (a few hundred instructions a head);
//   4. the out projection on the same product with the kRwOutProj epilogue:
//      + bo, * scale[window], + x (res), rounded once. It has a third of
//      q/k/v's tiles, so its last wave is part-filled.
// * FMA (f32, f16, or bf16 with C not a multiple of 8): a block a window,
//   heads one at a time; each thread owns one output column of q_h, k_h or
//   v_h and keeps its L row sums in registers, reading the activation rows
//   as float4 broadcasts; the per-head tiles use an odd row stride so
//   column reads across rows are free of bank conflicts.
#pragma once

#include "hash_dropout.cuh"
#include "mma_sync.cuh"
#include "tile_ops.cuh"
#include "wg_rows.cuh"

// Everything a forward call takes; mirrored by _FwdArgs in
// vptr_tpu_torch/ops/fused_window_attention.py. Inputs (ls, lb, pos, scale,
// res belong to LN = true, xv to LN = false; pos, bias, scale and seed may
// be null), the output, then the wgmma route's scratch the caller
// allocates: mean, rstd (R f32) and xn, xqk (R x C in T; xqk only with
// pos) for LN; q, k, v and attn (the merged heads), R x C in T. The FMA
// route takes no scratch (null).
struct FwdArgs {
  const void *x, *xv, *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo, *ls, *lb, *pos, *bias, *scale,
      *seed;
  void* out;
  void *mean, *rstd, *xn, *xqk, *q, *k, *v, *attn;
  int windows, tokens, channels, heads, bias_heads, res, mask_tokens, dtype;
  int inner, mask_heads, head0;   // Cl = heads * hd; the global heads and the first
  float qscale, eps, rate, keep_div;
};

namespace {

constexpr int kMaxTokens = 32;
constexpr int kMaxHeadDim = 128;
constexpr long kSmemLimit = 232448;   // bytes a block may opt in to on sm_90

// ---------------------------------------------------------------------------
// FMA route

constexpr int kFmaThreads = 256;
constexpr int kFmaWarps = kFmaThreads / 32;

// acc[r] += sum_k A[r][k] * W[k][col] for r < rows. A lives in shared
// memory with row stride lda (a multiple of 4, zero-padded past K); W is a
// (K, N) row-major matrix in device memory.
template <typename T, int MAXL>
__device__ __forceinline__ void column_dot(const float* __restrict__ A, int lda,
                                           const T* __restrict__ W, int K, int N, int col,
                                           int rows, float (&acc)[MAXL]) {
#pragma unroll
  for (int r = 0; r < MAXL; ++r) acc[r] = 0.f;
  for (int kk = 0; kk < lda; kk += 4) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = kk + i < K ? to_f32(W[static_cast<long>(kk + i) * N + col]) : 0.f;
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
__global__ void __launch_bounds__(kFmaThreads)
fused_window_attention_kernel(
    const T* __restrict__ x, const T* __restrict__ xv, const T* __restrict__ wq,
    const float* __restrict__ bq, const T* __restrict__ wk, const float* __restrict__ bk,
    const T* __restrict__ wv, const float* __restrict__ bv, const T* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ ls, const float* __restrict__ lb,
    const float* __restrict__ pos, const float* __restrict__ bias,
    const float* __restrict__ scale, T* __restrict__ out, int L, int C, int Cl, int heads,
    int bias_heads, int res, float qscale, float eps, vptr_dropout::Params drop,
    int mask_tokens) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lda = (C + 3) & ~3;
  const int ldo = (Cl + 3) & ~3;
  const int hd = Cl / heads;
  const int hs = hd | 1;
  float* xn = smem;                    // [L][lda]  LN(x) * ls + lb (or x_v), rounded to T
  float* xqk = xn + L * lda;           // [L][lda]  xn + pos (or x_qk), rounded to T
  float* att = xqk + L * lda;          // [L][ldo]  merged head outputs, rounded to T
  float* qh = att + L * ldo;           // [L][hs]   q_h * hd^-1/2, rounded to T
  float* kh = qh + L * hs;             // [L][hs]
  float* vh = kh + L * hs;             // [L][hs]

  const long win = blockIdx.x;
  const T* xw = x + win * L * C;
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if constexpr (LN) {
    // 1) LayerNorm, one warp per row, f32 statistics
    for (int r = warp; r < L; r += kFmaWarps) {
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
      }
    }
  } else {
    // 1) the two input streams as they are
    const T* xvw = xv + win * L * C;
    for (int i = threadIdx.x; i < L * lda; i += kFmaThreads) {
      const int r = i / lda, c = i - r * lda;
      xqk[i] = c < C ? to_f32(xw[r * C + c]) : 0.f;
      xn[i] = c < C ? to_f32(xvw[r * C + c]) : 0.f;
    }
  }
  for (int i = threadIdx.x; i < L * ldo; i += kFmaThreads) att[i] = 0.f;
  __syncthreads();

  // 2) one head at a time: project q_h, k_h, v_h, then attend
  for (int h = 0; h < heads; ++h) {
    for (int t = threadIdx.x; t < 3 * hd; t += kFmaThreads) {
      const int m = t / hd;            // 0: q, 1: k, 2: v
      const int j = t - m * hd;
      const int col = h * hd + j;
      float acc[MAXL];
      column_dot<T, MAXL>(m == 2 ? xn : xqk, lda, m == 0 ? wq : (m == 1 ? wk : wv), C, Cl,
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
    for (int r = warp; r < L; r += kFmaWarps) {
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
        w = drop.apply(w, drop.keep(drop.index(static_cast<uint32_t>(win), heads, h,
                                               mask_tokens, r, mask_tokens, lane),
                                    seed));
      w = round_t<T>(w);
      for (int d0 = 0; d0 < hd; d0 += 32) {
        const int d = d0 + lane;
        float acc = 0.f;
        for (int c = 0; c < L; ++c) {
          const float wc = __shfl_sync(0xffffffffu, w, c);
          if (d < hd) acc = fmaf(wc, vh[c * hs + d], acc);
        }
        if (d < hd) att[r * ldo + h * hd + d] = round_t<T>(acc);
      }
    }
    __syncthreads();
  }

  // 3) output projection in f32 + bo, then the branch scale and residual
  T* ow = out + win * L * C;
  const float sc = scale ? scale[win] : 1.f;
  for (int j = threadIdx.x; j < C; j += kFmaThreads) {
    float acc[MAXL];
    column_dot<T, MAXL>(att, ldo, wo, Cl, C, j, L, acc);
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

long fma_smem(int L, int C, int Cl, int heads) {
  const long lda = (C + 3) & ~3, ldo = (Cl + 3) & ~3;
  const long hs = (Cl / heads) | 1;
  return static_cast<long>(sizeof(float)) * (2 * L * lda + L * ldo + 3 * L * hs);
}

template <typename T, int MAXL, bool LN>
int launch_fma(const FwdArgs& a, cudaStream_t stream) {
  const long smem = fma_smem(a.tokens, a.channels, a.inner, a.heads);
  auto kernel = fused_window_attention_kernel<T, MAXL, LN>;
  VPTR_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem)));
  const vptr_dropout::Params drop{static_cast<const int*>(a.seed), a.rate, a.keep_div,
                                  a.mask_heads, a.head0};
  kernel<<<a.windows, kFmaThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.xv), static_cast<const T*>(a.wq),
      static_cast<const float*>(a.bq), static_cast<const T*>(a.wk),
      static_cast<const float*>(a.bk), static_cast<const T*>(a.wv),
      static_cast<const float*>(a.bv), static_cast<const T*>(a.wo),
      static_cast<const float*>(a.bo), static_cast<const float*>(a.ls),
      static_cast<const float*>(a.lb), static_cast<const float*>(a.pos),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.scale),
      static_cast<T*>(a.out), a.tokens, a.channels, a.inner, a.heads, a.bias_heads, a.res,
      a.qscale,
      a.eps, drop, a.mask_tokens);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma route: 3. the attention pass

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;

// Row stride (elements) of the staged q, k, v rows: C, or C + 8 where C is
// a multiple of 16, so that it is 4 words mod 8 and the eight rows of a
// fragment load fall in eight different groups of four banks.
__host__ __device__ __forceinline__ int attn_ld(int C) { return C % 16 ? C : C + 8; }

// Shared memory of a window_fwd_kernel block: q, k, v of its window's rows.
long attn_smem(int L, int C) {
  return 3L * L * attn_ld(C) * static_cast<long>(sizeof(bf16));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// A block stages the q, k, v rows of one window (two windows a block read
// slower at L = 10 on an H100); warp w takes the heads w, w + 8, ... MT:
// 16-row query tiles (1 for L <= 16, 2 for L <= 32), so the logits are
// MT x 2 MT tiles of 16 x 8 and P v runs over MT 16-key steps.
template <int MT, bool PAIRS>
__global__ void __launch_bounds__(kAttnThreads, MT == 1 ? 4 : 3)
window_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  bf16* __restrict__ out, int L, int C, int heads, int bias_heads,
                  int mask_tokens, vptr_dropout::Params drop) {
  constexpr int NT = 2 * MT;
  extern __shared__ __align__(16) unsigned char smem_attn[];
  const int ld = attn_ld(C);
  bf16* qs = reinterpret_cast<bf16*>(smem_attn);  // [L][ld] q, then the merged heads
  bf16* ks = qs + L * ld;                         // [L][ld]
  bf16* vs = ks + L * ld;                         // [L][ld]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = C / 8;                        // 16-byte chunks a row
  const uint32_t win = blockIdx.x;
  const long base = static_cast<long>(win) * L * C;
  for (int r = warp; r < L; r += kAttnWarps)
    for (int c = lane; c < chunks; c += 32) {
      const long o = base + static_cast<long>(r) * C + 8 * c;
      cp_async16(qs + r * ld + 8 * c, q + o);
      cp_async16(ks + r * ld + 8 * c, k + o);
      cp_async16(vs + r * ld + 8 * c, v + o);
    }
  cp_async_wait_all();
  __syncthreads();

  const int hd = C / heads;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  for (int h = warp; h < heads; h += kAttnWarps) {
    bf16* qh = qs + h * hd;                        // the head's columns
    const bf16* kh = ks + h * hd;
    const bf16* vh = vs + h * hd;

    // logits s[mt][nt]: query rows 16 mt + g (+ 8), keys 8 nt + 2t (+ 1)
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
    for (int k0 = 0; k0 < hd; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int i0 = 16 * mt + g, i1 = i0 + 8;
        a[mt][0] = load_pair<PAIRS>(qh + i0 * ld, k0 + 2 * t, hd, i0 < L);
        a[mt][1] = load_pair<PAIRS>(qh + i1 * ld, k0 + 2 * t, hd, i1 < L);
        a[mt][2] = load_pair<PAIRS>(qh + i0 * ld, k0 + 2 * t + 8, hd, i0 < L);
        a[mt][3] = load_pair<PAIRS>(qh + i1 * ld, k0 + 2 * t + 8, hd, i1 < L);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (8 * nt >= L) break;                    // warp-uniform
        const int j = 8 * nt + g;
        const uint32_t b0 = load_pair<PAIRS>(kh + j * ld, k0 + 2 * t, hd, j < L);
        const uint32_t b1 = load_pair<PAIRS>(kh + j * ld, k0 + 2 * t + 8, hd, j < L);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_16816(s[mt][nt], a[mt], b0, b1);
      }
    }
    __syncwarp();                                  // q is read: its columns take the output

    // softmax over each row (the four lanes of a quad hold it), dropout,
    // the weights rounded to bf16 as P's A fragments: logit tiles 2 ks and
    // 2 ks + 1 are P's 16-key step ks
    const float* bias_h =
        bias ? bias + static_cast<long>(bias_heads == 1 ? 0 : h) * L * L : nullptr;
    uint32_t p[MT][MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * mt + g + 8 * hh;
        float m = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * nt + 2 * t + e;
            float x = -INFINITY;
            if (i < L && j < L) {
              x = s[mt][nt][2 * hh + e];
              if (bias_h) x += bias_h[i * L + j];
            }
            s[mt][nt][2 * hh + e] = x;
            m = fmaxf(m, x);
          }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * nt + 2 * t + e;
            const float x = i < L && j < L ? expf(s[mt][nt][2 * hh + e] - m) : 0.f;
            s[mt][nt][2 * hh + e] = x;
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const uint32_t row_idx = drop.index(win, heads, h, mask_tokens, i, mask_tokens, 0);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float wv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * nt + 2 * t + e;
            float x = 0.f;                         // rows and keys past L: weight 0
            if (i < L && j < L) {
              x = s[mt][nt][2 * hh + e] / sum;
              if (drop.active()) x = drop.apply(x, drop.keep(row_idx + j, seed));
            }
            wv[e] = x;
          }
          p[mt][nt >> 1][2 * (nt & 1) + hh] = pack_bf16(wv[0], wv[1]);
        }
      }

    // P v, eight columns of the head at a time, into the head's q columns
    for (int n0 = 0; n0 < hd; n0 += 8) {
      float o[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
      const int d = n0 + g;
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        uint32_t b[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * kk + 8 * half + 2 * t;
          const uint32_t lo =
              j < L && d < hd ? *reinterpret_cast<const uint16_t*>(vh + j * ld + d) : 0u;
          const uint32_t hi =
              j + 1 < L && d < hd ? *reinterpret_cast<const uint16_t*>(vh + (j + 1) * ld + d)
                                  : 0u;
          b[half] = lo | hi << 16;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_16816(o[mt], p[mt][kk], b[0], b[1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 16 * mt + g + 8 * hh, c = n0 + 2 * t;
          if (i >= L) continue;
          if constexpr (PAIRS) {
            if (c < hd)
              *reinterpret_cast<__nv_bfloat162*>(qh + i * ld + c) =
                  __floats2bfloat162_rn(o[mt][2 * hh], o[mt][2 * hh + 1]);
          } else {
            if (c < hd) qh[i * ld + c] = __float2bfloat16_rn(o[mt][2 * hh]);
            if (c + 1 < hd) qh[i * ld + c + 1] = __float2bfloat16_rn(o[mt][2 * hh + 1]);
          }
        }
    }
  }
  __syncthreads();
  for (int r = warp; r < L; r += kAttnWarps)
    for (int c = lane; c < chunks; c += 32)
      *reinterpret_cast<uint4*>(out + base + static_cast<long>(r) * C + 8 * c) =
          *reinterpret_cast<const uint4*>(qs + r * ld + 8 * c);
}

// The attention pass over q, k, v (R x C bf16, q already scaled) into attn.
int launch_attention(const void* q, const void* k, const void* v, const void* bias, void* attn,
                     int windows, int L, int C, int heads, int bias_heads, int mask_tokens,
                     const vptr_dropout::Params& drop, cudaStream_t s) {
  const long smem = attn_smem(L, C);
  const bool pairs = (C / heads) % 2 == 0;
  auto kernel = &window_fwd_kernel<1, true>;
  if (L > 16)
    kernel = pairs ? &window_fwd_kernel<2, true> : &window_fwd_kernel<2, false>;
  else if (!pairs)
    kernel = &window_fwd_kernel<1, false>;
  VPTR_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem)));
  kernel<<<windows, kAttnThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(attn), L, C, heads, bias_heads,
      mask_tokens, drop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma route: 2. and 4., the products

// 4. out = (a Wo + bo) * scale[row / L] (+ res), rounded once to bf16; a
// (rows, K), Wo (K, C).
int out_projection(const void* a, const void* wo, const void* bo, const void* scale,
                   const void* res, void* out, int rows, int L, int K, int C, cudaStream_t s) {
  RwMaps m;
  RwWork w{};
  if (int err = rw_amap(&m.a[0][0], a, rows, K, K)) return err;
  if (int err = rw_bmap(&m.b[0], wo, K, C, C, true)) return err;
  w.job[0] = {out, static_cast<const float*>(bo), 1.f, static_cast<const float*>(scale), K};
  w.job[kRwJobs - 1].out = const_cast<void*>(res);
  w.jobs = 1, w.rows = rows, w.cols = C, w.group = L;
  return launch_rows<1, true, kRwOutProj>(m, w, s);
}

// Shapes and the route: wgmma for bf16 with C and the inner width Cl
// multiples of 8 (TMA rows and the attention pass's 16-byte chunks) whose
// attention pass fits a block's shared memory; the FMA kernel otherwise
// (f32 and f16 always; Cl = 132, 2 of 8 heads of 66 at C = 528).
bool use_wg(int L, int C, int Cl, int dtype) {
  return dtype == 1 && C % 8 == 0 && Cl % 8 == 0 && attn_smem(L, Cl) <= kSmemLimit;
}

// Dynamic shared memory of the route (L, C, Cl, heads, dtype) takes: the
// attention pass's on the wgmma route.
long window_smem(int L, int C, int Cl, int heads, int dtype) {
  return use_wg(L, C, Cl, dtype) ? attn_smem(L, Cl) : fma_smem(L, C, Cl, heads);
}

template <bool LN>
int run_wg(const FwdArgs& a, cudaStream_t s) {
  const int L = a.tokens, C = a.channels, Cl = a.inner, R = a.windows * L;
  // the projections' inputs: xn, xqk (xn without pos) or the two streams
  const void* xqk = LN ? (a.pos ? a.xqk : a.xn) : a.x;
  const void* xv = LN ? a.xn : a.xv;

  // 1. LayerNorm rows
  if constexpr (LN) {
    ln_rows_kernel<bf16><<<(R + 7) / 8, 256, 0, s>>>(
        static_cast<const bf16*>(a.x), static_cast<const float*>(a.ls),
        static_cast<const float*>(a.lb), static_cast<const float*>(a.pos),
        static_cast<float*>(a.mean), static_cast<float*>(a.rstd), static_cast<bf16*>(a.xn),
        a.pos ? static_cast<bf16*>(a.xqk) : nullptr, R, L, C, a.eps);
    VPTR_TRY(cudaGetLastError());
  }

  // 2. q, k, v: one launch of three products
  RwMaps m;
  RwWork w{};
  const void* xs[3] = {xqk, xqk, xv};
  const void* ws[3] = {a.wq, a.wk, a.wv};
  void* outs[3] = {a.q, a.k, a.v};
  const void* bs[3] = {a.bq, a.bk, a.bv};
  for (int j = 0; j < 3; ++j) {
    if (int err = rw_amap(&m.a[j][0], xs[j], R, C, C)) return err;
    if (int err = rw_bmap(&m.b[j], ws[j], C, Cl, Cl, true)) return err;
    w.job[j] = {outs[j], static_cast<const float*>(bs[j]), j == 0 ? a.qscale : 1.f, nullptr,
                C};
  }
  w.jobs = 3, w.rows = R, w.cols = Cl, w.group = L;
  if (int err = launch_rows<1, true, kRwProj>(m, w, s)) return err;

  // 3. attention per (window, head) over the Cl columns of q, k, v
  const vptr_dropout::Params drop{static_cast<const int*>(a.seed), a.rate, a.keep_div,
                                  a.mask_heads, a.head0};
  if (int err = launch_attention(a.q, a.k, a.v, a.bias, a.attn, a.windows, L, Cl, a.heads,
                                 a.bias_heads, a.mask_tokens, drop, s))
    return err;

  // 4. the out projection (K = Cl), + bo, * scale, + x
  return out_projection(a.attn, a.wo, a.bo, a.scale, a.res ? a.x : nullptr, a.out, R, L, Cl, C,
                        s);
}

// Checks the arguments, then runs the route the shape takes (dtype 0 =
// float32, 1 = bfloat16, 2 = float16: FMA only). Returns a cudaError_t
// (0 = every pass launched), or kTmaEncodeError + a CUresult.
template <bool LN>
int run_forward(const FwdArgs* a, cudaStream_t s) {
  if (!a || a->windows < 1 || a->tokens < 1 || a->tokens > kMaxTokens || a->heads < 1 ||
      a->channels < 1 || a->inner < 1 || a->inner % a->heads != 0 ||
      a->inner / a->heads > kMaxHeadDim ||
      (a->mask_heads ? a->head0 < 0 || a->head0 + a->heads > a->mask_heads : a->head0 != 0) ||
      (a->bias && a->bias_heads != 1 && a->bias_heads != a->heads) || a->dtype < 0 ||
      a->dtype > 2 ||
      window_smem(a->tokens, a->channels, a->inner, a->heads, a->dtype) > kSmemLimit ||
      (a->rate > 0.f && !a->seed) || a->rate >= 1.f || a->mask_tokens < a->tokens ||
      (!LN && (!a->xv || a->res || a->scale)))
    return cudaErrorInvalidValue;
  if (use_wg(a->tokens, a->channels, a->inner, a->dtype)) {
    if (!a->q || !a->k || !a->v || !a->attn ||
        (LN && (!a->mean || !a->rstd || !a->xn || (a->pos && !a->xqk))))
      return cudaErrorInvalidValue;
    return run_wg<LN>(*a, s);
  }
  const bool short_l = a->tokens <= 16;
  switch (a->dtype) {
    case 0:
      return short_l ? launch_fma<float, 16, LN>(*a, s) : launch_fma<float, 32, LN>(*a, s);
    case 1:
      return short_l ? launch_fma<bf16, 16, LN>(*a, s) : launch_fma<bf16, 32, LN>(*a, s);
    case 2:
      return short_l ? launch_fma<__half, 16, LN>(*a, s) : launch_fma<__half, 32, LN>(*a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
