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
// kernel, and every reduction over rows is either the K loop of one block
// or a fixed-order second pass; no float atomics, so the result is the
// same on every run:
//   1. ln_rows (LN only): per-row LayerNorm statistics, xn and xqk
//      (rounded to T); without LN the two inputs are xqk and xn;
//   2. q, k, v, rounded after the f32 bias add (q * scale in T);
//   3. d(attn) = (g Wo^T) * scale[window], f32;
//   4. window_bwd: one block per (window, head) recomputes the softmax and
//      the hash mask (dropout index over the padded token count) in shared
//      memory and writes dq, dk, dv, the merged heads (T), the logit
//      gradients for the bias gradient, and its columns' sums of dq, dk,
//      dv and g * scale over the window's rows (for dbq, dbk, dbv, dbo);
//      a warp takes two softmax rows at L <= 16, and a thread two rows of
//      a column after, so each shared-memory read serves both;
//   5. dW = X^T dY for q, k, v (X = xqk, xqk, xn) and o (X = the merged
//      heads, dY = g * scale). These have few output tiles, so K = R is
//      split in chunks; each chunk's f32 sums go to scratch and split_sum
//      adds them in chunk order and casts to T;
//   6. LN: d(xn) = dq Wq^T + dk Wk^T + dv Wv^T (f32);
//      no LN: dx_qk = dq Wq^T + dk Wk^T and dx_v = dv Wv^T (rounded to T);
//   7. ln_bwd_sums (LN only): dx per row (+ g for res), and each block's
//      8-row sums of d(xn) and d(xn) xhat (for dlb, dls);
//   8. the column sums in fixed order: dbq, dbk, dbv, dbo over pass 4's
//      window sums (dlb, dls over pass 7's); dbias sums the logit
//      gradients over windows.
// A head subset (tensor parallelism; the forward's note): Wq, Wk, Wv are
// (C, Cl), Wo (Cl, C) and q, k, v, d(attn), the merged heads and dq, dk, dv
// R x Cl; dx (or dx_qk, dx_v), dls and dlb are this subset's share of the
// sum over all heads (the caller sums them over the ranks) and dbo is the
// column sum of g over all C columns (block (window, h) sums its C / H of
// them). The dropout index takes the global head; scale and res need every
// head (Cl = C).
// Rounding points follow the plain versions
// (fused_window_attention.py::fused_attention_ln_backward_plain and
// fused_attention_backward_plain): dq, dk, dv and g * scale stay f32 into
// the dW and d(xn) / dx products.
//
// What bounds it on an H100: operations. Eleven R x C x C products (the
// three recomputed projections, d(attn), four dW, three for d(xn)), 22 R
// C^2 flops, against tens of MB of traffic. The products have two routes:
// * wgmma (bf16, C a multiple of 8 so that TMA rows are 16-byte aligned;
//   any R, rows past R read zero and are never stored; backward_route in
//   ops/fused_window_attention.py names it): every product on Hopper's
//   warpgroup MMA fed by TMA. An f32 operand reaches the tensor cores as
//   its bf16 hi and lo halves (hi = bf16(v), lo = bf16(v - hi): relative
//   error below 2^-16, far below the bf16 rounding of every result), two
//   terms of each product that takes it; pass 4 writes the halves of dq,
//   dk, dv (and of g * scale when there is a scale) itself, into two
//   planes of R rows by 4C ([dq dk dv g*scale], hi and lo), so no pass
//   reads them in f32:
//   - 2 and 3 on wg_rows.cuh's row-tiled product (128-row tiles by 176
//     columns, persistent blocks): q, k, v one launch of three products,
//     W read MN-major as stored, the bias, rounding and q scale in the
//     register epilogue, stored in whole 16-byte chunks through shared
//     memory; d(attn) with Wo the K-major B^T as stored, the window's
//     scale in the epilogue;
//   - 5 on wg_dw.cuh's weight-gradient product, the four dW one launch
//     (both operands MN-major as they lie in memory, dY's halves two
//     terms, or g itself when there is no scale), K in as many chunks as
//     one wave of its blocks takes;
//   - 6 on the row-tiled product over K = 3C (2C for dx_qk): the planes'
//     dq | dk | dv columns are one operand, and the wrapper's [Wq Wk Wv]
//     (C, 3C), copied side by side, its B^T.
// * FMA (f32, f16, or bf16 with C not a multiple of 8): tile_ops.cuh's
//   gemm, 64 x 64 tiles staged element by element, f32 products on the CUDA
//   cores over dq, dk, dv in f32.
#pragma once

#include "hash_dropout.cuh"
#include "tile_ops.cuh"
#include "wg_dw.cuh"
#include "wg_rows.cuh"

// Everything the backward needs; mirrored by _BwdArgs in
// vptr_tpu_torch/ops/fused_window_attention.py. Inputs, outputs, then the
// caller-allocated scratch (mean/rstd: R f32; xn, xqk: R x C in T; q, k, v,
// attn: R x Cl in T; dao: R x C f32; dl: windows x heads x L x L f32 or
// null; colpart: 4 x windows x C f32; partial (LN): 2 x ln_parts(R) x C f32;
// wpart: 4 x ksplit x C x Cl f32; on the wgmma route planes: 2 x R x
// (3 Cl + C) bf16 and wcat: C x 3 Cl bf16, dq, dk, dv null; on the FMA
// route dq, dk, dv: R x Cl f32, planes and wcat null). Cl = inner (C for
// every head). Without LN, x is x_qk, xv is x_v, dx is dx_qk and dxv dx_v,
// and mean, rstd, xn, xqk, ls, lb, pos, scale, dls and dlb are unused
// (null).
struct BwdArgs {
  const void *x, *xv, *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo, *ls, *lb, *pos, *bias, *scale,
      *seed, *g;
  void *dx, *dxv, *dwq, *dbq, *dwk, *dbk, *dwv, *dbv, *dwo, *dbo, *dls, *dlb, *dbias;
  void *mean, *rstd, *xn, *xqk, *q, *k, *v, *attn, *dao, *dq, *dk, *dv, *dl, *colpart, *partial,
      *wpart, *planes, *wcat;
  int windows, tokens, channels, heads, bias_heads, res, mask_tokens, dtype, ksplit;
  int inner, mask_heads, head0;   // Cl = heads * hd; the global heads and the first
  float qscale, dscale, eps, rate, keep_div;
};

namespace {

constexpr int kMaxTokens = 32;
constexpr int kMaxHeadDim = 128;

// The wgmma route: bf16 only (f32 and f16 take the FMA route).
bool wg_route(int C, int Cl, int dtype) { return dtype == 1 && C % 8 == 0 && Cl % 8 == 0; }

// K chunks of the weight-gradient products (wpart). The wgmma route: one
// wave of the four products' blocks (a block an SM: its shared memory), at
// most one a 64 rows; the FMA route: tile_ops.cuh's split.
int ksplits(int R, int C, int Cl, int dtype) {
  if (!wg_route(C, Cl, dtype)) return weight_splits(R);
  auto tiles = [](int m, int n) {
    return ((m + 64 * kDwMw - 1) / (64 * kDwMw)) * ((n + kWgN - 1) / kWgN);
  };
  const int blocks = 3 * tiles(C, Cl) + tiles(Cl, C);
  const int k = sm_count() / blocks, most = (R + kWgK - 1) / kWgK;
  return k < 1 ? 1 : (k > most ? most : k);
}

// Row blocks of the LayerNorm backward (partial: 2 x ln_parts x C f32).
int ln_parts(int R) { return (R + 7) / 8; }

float* f32p(void* p) { return static_cast<float*>(p); }
const float* cf32p(const void* p) { return static_cast<const float*>(p); }

// ---------------------------------------------------------------------------
// 4. Attention backward of one (window, head), in shared memory

// Shared-memory row stride in floats: a multiple of 4 (rows read as
// float4) and 4 mod 8, so the float4 reads of eight consecutive rows hit
// eight different 16-byte bank groups.
inline __host__ __device__ int row_stride(int depth) {
  const int s = (depth + 3) & ~3;
  return s % 8 == 0 ? s + 4 : s;
}

// Row stride of the L x L tiles in shared memory: rows read as float4.
constexpr int kWs = kMaxTokens + 4;

// Threads of a window_bwd_kernel block: 256 (at most 64 registers, four
// blocks an SM) read 0.02 ms less than 128 at the far_mnist step on an
// H100, each block's latency-bound phases taking half as many rounds.
constexpr int kWinThreads = 256;

// Shared memory of window_bwd_kernel for L tokens and head width hd:
// q, k, v, d(attn) of the head (Lq = L rounded up to 4 rows, zero past L),
// the dropped weights and logit gradients and their transposes and the
// head's bias (Lq rows of kWs, zero past column L), and the column sums of
// each row pair (dq, dk, dv, g * scale).
size_t window_smem(int L, int hd) {
  const int Lq = (L + 3) & ~3;
  return sizeof(float) * (4 * Lq * row_stride(hd) + 5 * Lq * kWs + 4 * ((L + 1) / 2) * hd);
}

// Where pass 4 writes: attn (R x C, T); the FMA route's dq, dk, dv (R x C
// f32) or the wgmma route's planes (hi at `hi`, lo `plane` on; row stride
// 4C: dq, dk, dv, g * scale), g * scale's halves only when scale is
// given; the window sums colpart[j][window][column] of dq, dk, dv and g *
// scale (g, no scale given); the logit gradients dl (or null).
struct WinOut {
  void* attn;
  float *dq, *dk, *dv;
  bf16* hi;
  long plane;
  const void* g;
  const float* scale;
  float* colpart;
  float* dl;
};

__device__ __forceinline__ void store_halves(bf16* p, long plane, float v) {
  const bf16 hi = __float2bfloat16_rn(v);
  p[0] = hi;
  p[plane] = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__device__ __forceinline__ float dot4(const float4 a, const float (&b)[4], float acc) {
  acc = fmaf(a.x, b[0], acc);
  acc = fmaf(a.y, b[1], acc);
  acc = fmaf(a.z, b[2], acc);
  return fmaf(a.w, b[3], acc);
}

// The kernel is bound by the issue of its instructions and shared-memory
// reads (counted: about 80 and 100 us of the 0.2 ms it took at the
// far_mnist step on an H100), so the element phase (after the softmax
// rows) has each thread take a pair of rows of one column d: the column
// operands (v, k, q, d(attn) at d) are read once for both rows, and the
// L x L operands as float4 broadcasts along c (the transposed tiles wdT
// and dlsT serve the sums over the key row).
template <typename T, bool HILO>
__global__ void __launch_bounds__(kWinThreads, 4)
window_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ dao, const float* __restrict__ bias, WinOut out,
                  int windows, int L, int C, int Cl, int heads, int bias_heads, int mask_tokens,
                  float dscale, vptr_dropout::Params drop) {
  extern __shared__ float4 smem4[];
  const int hd = Cl / heads;
  const int stride = row_stride(hd);
  const int Lq = (L + 3) & ~3, pairs = (L + 1) / 2;
  float* qs = reinterpret_cast<float*>(smem4);   // [Lq][stride] q * scale (rounded to T)
  float* ks = qs + Lq * stride;                   // [Lq][stride]
  float* vs = ks + Lq * stride;                   // [Lq][stride]
  float* das = vs + Lq * stride;                  // [Lq][stride] d(attn) of this head, f32
  float* wd = das + Lq * stride;                  // [Lq][kWs] dropped weights, rounded to T
  float* wdT = wd + Lq * kWs;                     // [Lq][kWs] its transpose
  float* dls = wdT + Lq * kWs;                    // [Lq][kWs] logit gradients
  float* dlsT = dls + Lq * kWs;                   // [Lq][kWs] their transpose
  float* bs = dlsT + Lq * kWs;                    // [Lq][kWs] the head's bias
  float* sums = bs + Lq * kWs;                    // [4][pairs][hd] dq, dk, dv, g * scale

  const int win = blockIdx.x / heads, h = blockIdx.x - win * heads;
  const long row0 = static_cast<long>(win) * L;
  const int col0 = h * hd;
  const float* bias_h =
      bias ? bias + static_cast<long>(bias_heads == 1 ? 0 : h) * L * L : nullptr;
  for (int i = threadIdx.x; i < Lq * stride; i += kWinThreads) {
    const int r = i / stride, d = i - r * stride;
    float a = 0.f, b = 0.f, c = 0.f, e = 0.f;
    if (r < L && d < hd) {
      const long o = (row0 + r) * Cl + col0 + d;
      a = to_f32(q[o]);
      b = to_f32(k[o]);
      c = to_f32(v[o]);
      e = dao[o];
    }
    qs[i] = a, ks[i] = b, vs[i] = c, das[i] = e;
  }
  for (int i = threadIdx.x; i < 4 * Lq * kWs; i += kWinThreads) wd[i] = 0.f;
  if (bias_h)
    for (int i = threadIdx.x; i < L * L; i += kWinThreads) bs[i / L * kWs + i % L] = bias_h[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
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
  // the softmax rows: a warp takes 32 / Lp rows at once (Lp = L rounded up
  // to a power of two), lane c of segment g key column c of row r + g; the
  // segments' butterflies add the same values in the same order as a
  // whole warp's would
  int Lp = 1;
  while (Lp < L) Lp <<= 1;
  const int seg = lane / Lp, kc = lane - seg * Lp;
  auto seg_max = [&](float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < Lp) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
  };
  auto seg_sum = [&](float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < Lp) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  };
  for (int rb = warp * (32 / Lp); rb < L; rb += kWinThreads / Lp) {
    const int r = rb + seg;
    const bool col = kc < L && r < L;
    float logit = -INFINITY;
    if (col) {
      logit = dot(qs + r * stride, ks + kc * stride);
      if (bias_h) logit += bs[r * kWs + kc];
    }
    const float m = seg_max(logit);
    const float e = col ? expf(logit - m) : 0.f;
    const float w = e / seg_sum(e);                   // pre-dropout, f32
    float dw = col ? dot(das + r * stride, vs + kc * stride) : 0.f;
    float w_drop = w;
    if (drop.active() && col) {
      const bool kept = drop.keep(
          drop.index(win, heads, h, mask_tokens, r, mask_tokens, kc), seed);
      w_drop = drop.apply(w, kept);
      dw = drop.apply(dw, kept);
    }
    const float s = seg_sum(col ? dw * w : 0.f);
    if (col) {
      const float dl = w * (dw - s), wr = round_t<T>(w_drop);
      wd[r * kWs + kc] = wr, wdT[kc * kWs + r] = wr;
      dls[r * kWs + kc] = dl, dlsT[kc * kWs + r] = dl;
      if (out.dl) out.dl[((static_cast<long>(win) * heads + h) * L + r) * L + kc] = dl;
    }
  }
  __syncthreads();

  // rows r0 = 2 rp and r0 + 1 of column d: attn and dq (query rows), dk and
  // dv (key rows); the sums run over c in order, zero past L
  const long pw = 3L * Cl + C;                    // the planes' row stride
  for (int i = threadIdx.x; i < pairs * hd; i += kWinThreads) {
    const int rp = i / hd, d = i - rp * hd, r0 = 2 * rp;
    float a[2] = {0.f, 0.f}, aq[2] = {0.f, 0.f}, ak[2] = {0.f, 0.f}, av[2] = {0.f, 0.f};
    for (int c = 0; c < Lq; c += 4) {
      float cv[4], ck[4], cq[4], cd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = (c + j) * stride + d;
        cv[j] = vs[o], ck[j] = ks[o], cq[j] = qs[o], cd[j] = das[o];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = (r0 + hh) * kWs + c;
        a[hh] = dot4(*reinterpret_cast<const float4*>(wd + o), cv, a[hh]);
        aq[hh] = dot4(*reinterpret_cast<const float4*>(dls + o), ck, aq[hh]);
        ak[hh] = dot4(*reinterpret_cast<const float4*>(dlsT + o), cq, ak[hh]);
        av[hh] = dot4(*reinterpret_cast<const float4*>(wdT + o), cd, av[hh]);
      }
    }
    float sq = 0.f, sk = 0.f, sv = 0.f;
    const float gsc = out.scale ? out.scale[win] : 1.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + hh;
      if (r >= L) break;
      const float dq = aq[hh] * dscale;
      const long o = (row0 + r) * Cl + col0 + d;
      sq += dq, sk += ak[hh], sv += av[hh];
      static_cast<T*>(out.attn)[o] = from_f32<T>(a[hh]);
      if constexpr (HILO) {
        bf16* p = out.hi + (row0 + r) * pw + col0 + d;
        store_halves(p, out.plane, dq);
        store_halves(p + Cl, out.plane, ak[hh]);
        store_halves(p + 2 * Cl, out.plane, av[hh]);
        if (out.scale)   // every head (Cl = C): g's column is the head's
          store_halves(p + 3 * Cl, out.plane,
                       to_f32(static_cast<const T*>(out.g)[(row0 + r) * C + col0 + d]) * gsc);
      } else {
        out.dq[o] = dq;
        out.dk[o] = ak[hh];
        out.dv[o] = av[hh];
      }
    }
    sums[i] = sq, sums[pairs * hd + i] = sk, sums[2 * pairs * hd + i] = sv;
  }
  __syncthreads();
  // the window's sums of this head's columns of dq, dk, dv, row pairs in
  // order
  for (int t = threadIdx.x; t < 3 * hd; t += kWinThreads) {
    const int j = t / hd, d = t - j * hd;
    const float* sp = sums + j * pairs * hd + d;
    float acc = 0.f;
    for (int rp = 0; rp < pairs; ++rp) acc += sp[rp * hd];
    out.colpart[(static_cast<long>(j) * windows + win) * C + col0 + d] = acc;
  }
  // and of g * scale over the block's C / heads columns of g (the head's
  // columns when Cl = C), summed in row pairs as above
  const int gc = C / heads, g0 = h * gc;
  const float gsc = out.scale ? out.scale[win] : 1.f;
  for (int t = threadIdx.x; t < gc; t += kWinThreads) {
    const T* gp = static_cast<const T*>(out.g) + row0 * C + g0 + t;
    float acc = 0.f;
    for (int rp = 0; rp < pairs; ++rp) {
      float sg = 0.f;
      for (int hh = 0; hh < 2 && 2 * rp + hh < L; ++hh)
        sg += to_f32(gp[static_cast<long>(2 * rp + hh) * C]) * gsc;
      acc += sg;
    }
    out.colpart[(3L * windows + win) * C + g0 + t] = acc;
  }
}

template <typename T, bool HILO>
int launch_window_bwd(const BwdArgs& a, const WinOut& out, cudaStream_t s) {
  const int L = a.tokens, hd = a.inner / a.heads;
  const size_t smem = window_smem(L, hd);
  VPTR_TRY(cudaFuncSetAttribute(window_bwd_kernel<T, HILO>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem)));
  const vptr_dropout::Params drop{static_cast<const int*>(a.seed), a.rate, a.keep_div,
                                  a.mask_heads, a.head0};
  window_bwd_kernel<T, HILO><<<a.windows * a.heads, kWinThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      cf32p(a.dao), cf32p(a.bias), out, a.windows, L, a.channels, a.inner, a.heads,
      a.bias_heads, a.mask_tokens, a.dscale, drop);
  return cudaGetLastError();
}

// out[j][c] = sum over the n rows of part[j] (n x C f32 of row stride ld; j
// = blockIdx.y):
// pass 4's window sums (dbq, dbk, dbv, dbo), the LayerNorm backward's
// 8-row sums (dlb, dls) and dbias (the logit gradients dl, windows rows of
// heads L^2, or windows x heads rows of L^2 for a one-head bias). 32
// columns a block, warp i summing the rows i,
// i + 32, ... of its lane's column, then one thread a column the 32 warps'
// sums in order. Fixed order: the same bits on every run.
struct ColOut {
  float* out[4];
};

__global__ void __launch_bounds__(1024)
rows_sum_kernel(const float* __restrict__ part, ColOut co, int n, int C, int ld) {
  __shared__ float acc[32][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane, j = blockIdx.y;
  const float* p = part + static_cast<long>(j) * n * ld + c;
  float v = 0.f;
  if (c < C)
#pragma unroll 4
    for (int w = warp; w < n; w += 32) v += p[static_cast<long>(w) * ld];
  acc[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && c < C) {
    float t = 0.f;
    for (int i = 0; i < 32; ++i) t += acc[i][lane];
    co.out[j][c] = t;
  }
}

// 7. dx per row (+ g for res), as tile_ops.cuh's ln_bwd_kernel (one warp a
// row, eight a block), and the block's sums of d(xn) and d(xn) xhat (rows
// in order) into part[0][block] and part[1][block] for dlb and dls.
template <typename T>
__global__ void __launch_bounds__(256)
ln_bwd_sums_kernel(const float* __restrict__ dxn, const T* __restrict__ x,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const float* __restrict__ ls, const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ part, int rows, int C, int res) {
  extern __shared__ float red[];                    // [8][2][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  float* mine = red + warp * 2 * C;
  if (row < rows) {
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
      const float xhat = (to_f32(x[o + c]) - mu) * rs, dn = dxn[o + c];
      float d = (dn * ls[c] - m1 - xhat * m2) * rs;
      if (res) d += to_f32(g[o + c]);
      dx[o + c] = from_f32<T>(d);
      mine[c] = dn, mine[C + c] = dn * xhat;
    }
  } else {
    for (int c = lane; c < 2 * C; c += 32) mine[c] = 0.f;
  }
  __syncthreads();
  const long blocks = gridDim.x;
  for (int c = threadIdx.x; c < 2 * C; c += 256) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += red[w * 2 * C + c];
    const int j = c >= C;
    part[(j * blocks + blockIdx.x) * C + c - j * C] = t;
  }
}

// ---------------------------------------------------------------------------
// The wgmma route's products (see the note at the top)

// 2. q, k, v (one launch of three products) and 3. d(attn).
int projections_wg(const BwdArgs& a, cudaStream_t s) {
  const int L = a.tokens, C = a.channels, Cl = a.inner, R = a.windows * L;
  RwMaps m;
  RwWork w{};
  const void* xs[3] = {a.xqk, a.xqk, a.xn};
  const void* ws[3] = {a.wq, a.wk, a.wv};
  void* outs[3] = {a.q, a.k, a.v};
  const void* bs[3] = {a.bq, a.bk, a.bv};
  for (int j = 0; j < 3; ++j) {
    if (int err = rw_amap(&m.a[j][0], xs[j], R, C, C)) return err;
    if (int err = rw_bmap(&m.b[j], ws[j], C, Cl, Cl, true)) return err;
    w.job[j] = {outs[j], cf32p(bs[j]), j == 0 ? a.qscale : 1.f, nullptr, C};
  }
  w.jobs = 3, w.rows = R, w.cols = Cl, w.group = L;
  if (int err = launch_rows<1, true, kRwProj>(m, w, s)) return err;
  if (int err = rw_amap(&m.a[0][0], a.g, R, C, C)) return err;
  if (int err = rw_bmap(&m.b[0], a.wo, C, Cl, C, false)) return err;   // Wo (Cl, C) is B^T
  w.job[0] = {a.dao, nullptr, 1.f, cf32p(a.scale), C};
  w.jobs = 1;
  return launch_rows<1, false, kRwF32>(m, w, s);
}

// 5. dWq, dWk, dWv, dWo into their K chunks' partials (one launch).
// With a head subset (Cl < C) dWq, dWk, dWv are (C, Cl) and dWo (Cl, C):
// one launch of the three and one of dWo.
int weights_wg(const BwdArgs& a, cudaStream_t s) {
  const int C = a.channels, Cl = a.inner, R = a.windows * a.tokens;
  const long pw = 3L * Cl + C, plane = static_cast<long>(R) * pw, cc = static_cast<long>(C) * Cl;
  const bf16* hi = static_cast<const bf16*>(a.planes);
  DwJobs<4> jobs;
  const void* xs[4] = {a.xqk, a.xqk, a.xn, a.attn};
  for (int j = 0; j < 4; ++j) {
    const int xc = j < 3 ? C : Cl, yc = j < 3 ? Cl : C;
    int err = strided_map(&jobs.x[j], xs[j], R, xc, xc, 64, 64);
    if (j < 3 || a.scale) {            // dY's halves
      if (!err) err = strided_map(&jobs.h[j], hi + j * Cl, R, yc, pw, 64, 64);
      if (!err) err = strided_map(&jobs.l[j], hi + plane + j * Cl, R, yc, pw, 64, 64);
      jobs.terms[j] = 2;
    } else {                           // dY = g, exact in bf16
      if (!err) err = strided_map(&jobs.h[j], a.g, R, C, C, 64, 64);
      jobs.l[j] = jobs.h[j];
      jobs.terms[j] = 1;
    }
    if (err) return err;
    jobs.out[j] = f32p(a.wpart) + j * a.ksplit * cc;
  }
  if (Cl == C) return launch_dw_jobs<4>(jobs, R, C, C, a.ksplit, s);
  DwJobs<3> qkv;
  DwJobs<1> o;
  for (int j = 0; j < 3; ++j)
    qkv.x[j] = jobs.x[j], qkv.h[j] = jobs.h[j], qkv.l[j] = jobs.l[j], qkv.out[j] = jobs.out[j],
    qkv.terms[j] = jobs.terms[j];
  o.x[0] = jobs.x[3], o.h[0] = jobs.h[3], o.l[0] = jobs.l[3], o.out[0] = jobs.out[3];
  o.terms[0] = jobs.terms[3];
  if (int err = launch_dw_jobs<3>(qkv, R, C, Cl, a.ksplit, s)) return err;
  return launch_dw_jobs<1>(o, R, Cl, C, a.ksplit, s);
}

// 6. LN: d(xn) = [dq dk dv] [Wq Wk Wv]^T (f32, into dao's memory); no LN:
// dx_qk = [dq dk] [Wq Wk]^T and dx_v = dv Wv^T (in T), one launch.
template <bool LN>
int dxn_wg(const BwdArgs& a, cudaStream_t s) {
  const int C = a.channels, Cl = a.inner, R = a.windows * a.tokens;
  const long pw = 3L * Cl + C, plane = static_cast<long>(R) * pw;
  const bf16* hi = static_cast<const bf16*>(a.planes);
  bf16* wcat = static_cast<bf16*>(a.wcat);
  const void* ws[3] = {a.wq, a.wk, a.wv};
  for (int j = 0; j < (LN ? 3 : 2); ++j)    // [Wq Wk (Wv)] side by side: (C, 3 Cl)
    VPTR_TRY(cudaMemcpy2DAsync(wcat + j * Cl, 3L * Cl * 2, ws[j], Cl * 2L, Cl * 2L, C,
                               cudaMemcpyDeviceToDevice, s));
  RwMaps m;
  RwWork w{};
  w.rows = R, w.cols = C, w.group = a.tokens;
  const int kq = LN ? 3 * Cl : 2 * Cl;      // the first product's depth
  int err = rw_amap(&m.a[0][0], hi, R, kq, pw);
  if (!err) err = rw_amap(&m.a[0][1], hi + plane, R, kq, pw);
  if (!err) err = rw_bmap(&m.b[0], wcat, kq, C, 3L * Cl, false);
  if (err) return err;
  if constexpr (LN) {
    w.job[0] = {a.dao, nullptr, 1.f, nullptr, kq};
    w.jobs = 1;
    return launch_rows<2, false, kRwF32>(m, w, s);
  } else {
    err = rw_amap(&m.a[1][0], hi + 2 * Cl, R, Cl, pw);
    if (!err) err = rw_amap(&m.a[1][1], hi + plane + 2 * Cl, R, Cl, pw);
    if (!err) err = rw_bmap(&m.b[1], a.wv, Cl, C, Cl, false);
    if (err) return err;
    w.job[0] = {a.dx, nullptr, 1.f, nullptr, kq};
    w.job[1] = {a.dxv, nullptr, 1.f, nullptr, Cl};
    w.jobs = 2;
    return launch_rows<2, false, kRwBf16>(m, w, s);
  }
}

// ---------------------------------------------------------------------------
// The FMA route's products

// 2. q, k, v;  3. d(attn) = (g Wo^T) * scale[window]
template <typename T>
int projections_fma(const BwdArgs& a, cudaStream_t s) {
  const int L = a.tokens, C = a.channels, Cl = a.inner, R = a.windows * L;
  GemmBatch gb{};
  gb.M = R, gb.N = Cl, gb.K = C, gb.lda = C, gb.ldb = Cl, gb.ldo = Cl, gb.group = L;
  gb.ksplit = 1, gb.kchunk = C;
  gb.job[0] = {a.xqk, a.wq, a.q, cf32p(a.bq), a.qscale, nullptr, nullptr, 0};
  gb.job[1] = {a.xqk, a.wk, a.k, cf32p(a.bk), 1.f, nullptr, nullptr, 0};
  gb.job[2] = {a.xn, a.wv, a.v, cf32p(a.bv), 1.f, nullptr, nullptr, 0};
  VPTR_TRY((gemm<T, false, T, false, T, kProj>(gb, 3, s)));
  gb.ldb = C;                          // Wo (Cl, C) read transposed
  gb.job[0] = {a.g, a.wo, a.dao, nullptr, 1.f, nullptr, cf32p(a.scale), 0};
  return gemm<T, false, T, true, float, kF32>(gb, 1, s);
}

// 5. the weight gradients X^T dY: K = R rows in ksplit chunks into wpart;
// 6. LN: d(xn) = dq Wq^T + dk Wk^T + dv Wv^T summed in f32 into dao's
//    memory (dao is done); no LN: dx_qk summed there and cast to T, dx_v
//    one product written in T
template <typename T, bool LN>
int products_fma(const BwdArgs& a, cudaStream_t s) {
  const int L = a.tokens, C = a.channels, Cl = a.inner, R = a.windows * L;
  const long cc = static_cast<long>(C) * Cl;
  float* wpart = f32p(a.wpart);
  GemmBatch gw{};
  gw.M = C, gw.N = Cl, gw.K = R, gw.lda = C, gw.ldb = Cl, gw.ldo = Cl, gw.group = L;
  gw.ksplit = a.ksplit;
  gw.kchunk = ((R + a.ksplit - 1) / a.ksplit + BK - 1) / BK * BK;
  gw.job[0] = {a.xqk, a.dq, wpart, nullptr, 1.f, nullptr, nullptr, 0};
  gw.job[1] = {a.xqk, a.dk, wpart + a.ksplit * cc, nullptr, 1.f, nullptr, nullptr, 0};
  gw.job[2] = {a.xn, a.dv, wpart + 2 * a.ksplit * cc, nullptr, 1.f, nullptr, nullptr, 0};
  VPTR_TRY((gemm<T, true, float, false, float, kPartial>(gw, 3, s)));
  gw.M = Cl, gw.N = C, gw.lda = Cl, gw.ldb = C, gw.ldo = C;    // dWo (Cl, C)
  gw.job[0] = {a.attn, a.g, wpart + 3 * a.ksplit * cc, nullptr, 1.f, cf32p(a.scale), nullptr, 0};
  VPTR_TRY((gemm<T, true, T, false, float, kPartial>(gw, 1, s)));
  GemmBatch gb{};
  gb.M = R, gb.N = C, gb.K = Cl, gb.lda = Cl, gb.ldb = Cl, gb.ldo = C, gb.group = L;
  gb.ksplit = 1, gb.kchunk = Cl;
  const void* dys[3] = {a.dq, a.dk, a.dv};
  const void* ws[3] = {a.wq, a.wk, a.wv};
  for (int j = 0; j < (LN ? 3 : 2); ++j) {
    gb.job[0] = {dys[j], ws[j], a.dao, nullptr, 1.f, nullptr, nullptr, j > 0};
    VPTR_TRY((gemm<float, false, T, true, float, kF32>(gb, 1, s)));
  }
  if constexpr (!LN) {
    gb.job[0] = {a.dv, a.wv, a.dxv, nullptr, 1.f, nullptr, nullptr, 0};
    VPTR_TRY((gemm<float, false, T, true, T, kF32>(gb, 1, s)));
    SplitSum cast{};   // dx_qk: the f32 sum cast to T
    cast.part[0] = cf32p(a.dao), cast.out[0] = a.dx, cast.ksplit = 1;
    cast.n = static_cast<long>(R) * C;
    split_sum_kernel<T><<<dim3(static_cast<unsigned>((cast.n + 255) / 256), 1), 256, 0, s>>>(
        cast);
  }
  return cudaGetLastError();
}

template <typename T, bool LN>
int run(const BwdArgs& args, cudaStream_t s) {
  BwdArgs a = args;
  if constexpr (!LN) {   // the projections' inputs are the two streams
    a.xqk = const_cast<void*>(args.x);
    a.xn = const_cast<void*>(args.xv);
  }
  const int L = a.tokens, C = a.channels, Cl = a.inner, R = a.windows * a.tokens;
  const bool wg = wg_route(C, Cl, a.dtype);

  // 1. LayerNorm rows
  if constexpr (LN) {
    ln_rows_kernel<T><<<(R + 7) / 8, 256, 0, s>>>(
        static_cast<const T*>(a.x), cf32p(a.ls), cf32p(a.lb), cf32p(a.pos), f32p(a.mean),
        f32p(a.rstd), static_cast<T*>(a.xn), static_cast<T*>(a.xqk), R, L, C, a.eps);
    VPTR_TRY(cudaGetLastError());
  }

  // 2. q, k, v;  3. d(attn)
  if (int err = wg ? projections_wg(a, s) : projections_fma<T>(a, s)) return err;

  // 4. attention backward per (window, head)
  WinOut out{a.attn, f32p(a.dq), f32p(a.dk), f32p(a.dv), static_cast<bf16*>(a.planes),
             static_cast<long>(R) * (3L * Cl + C), a.g, cf32p(a.scale),
             f32p(a.colpart), f32p(a.dl)};
  if (int err = wg ? launch_window_bwd<bf16, true>(a, out, s)
                   : launch_window_bwd<T, false>(a, out, s))
    return err;

  // 5. weight gradients;  6. d(xn) (LN) or dx_qk, dx_v
  if (wg) {
    if (int err = weights_wg(a, s)) return err;
    if (int err = dxn_wg<LN>(a, s)) return err;
  } else if (int err = products_fma<T, LN>(a, s)) {
    return err;
  }
  const long cc = static_cast<long>(C) * Cl;
  SplitSum ss{};
  void* dws[4] = {a.dwq, a.dwk, a.dwv, a.dwo};
  for (int j = 0; j < 4; ++j) ss.part[j] = f32p(a.wpart) + j * a.ksplit * cc, ss.out[j] = dws[j];
  ss.ksplit = a.ksplit, ss.n = cc;
  split_sum_kernel<T><<<dim3(static_cast<unsigned>((cc + 255) / 256), 4), 256, 0, s>>>(ss);
  VPTR_TRY(cudaGetLastError());

  // 7. dx and the 8-row sums for dlb and dls (LN)
  if constexpr (LN) {
    const size_t smem = sizeof(float) * 16 * C;
    VPTR_TRY(cudaFuncSetAttribute(ln_bwd_sums_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem)));
    ln_bwd_sums_kernel<T><<<ln_parts(R), 256, smem, s>>>(
        cf32p(a.dao), static_cast<const T*>(a.x), cf32p(a.mean), cf32p(a.rstd), cf32p(a.ls),
        static_cast<const T*>(a.g), static_cast<T*>(a.dx), f32p(a.partial), R, C, a.res);
    VPTR_TRY(cudaGetLastError());
    const ColOut lo{{f32p(a.dlb), f32p(a.dls)}};
    rows_sum_kernel<<<dim3((C + 31) / 32, 2), 1024, 0, s>>>(cf32p(a.partial), lo, ln_parts(R),
                                                           C, C);
    VPTR_TRY(cudaGetLastError());
  }

  // 8. dbq, dbk, dbv (Cl columns), dbo (C) over pass 4's window sums
  if (Cl == C) {
    const ColOut db{{f32p(a.dbq), f32p(a.dbk), f32p(a.dbv), f32p(a.dbo)}};
    rows_sum_kernel<<<dim3((C + 31) / 32, 4), 1024, 0, s>>>(cf32p(a.colpart), db, a.windows, C,
                                                           C);
  } else {
    const ColOut db{{f32p(a.dbq), f32p(a.dbk), f32p(a.dbv)}};
    rows_sum_kernel<<<dim3((Cl + 31) / 32, 3), 1024, 0, s>>>(cf32p(a.colpart), db, a.windows,
                                                            Cl, C);
    VPTR_TRY(cudaGetLastError());
    const ColOut dbo{{f32p(a.dbo)}};
    rows_sum_kernel<<<dim3((C + 31) / 32, 1), 1024, 0, s>>>(
        cf32p(a.colpart) + 3L * a.windows * C, dbo, a.windows, C, C);
  }
  VPTR_TRY(cudaGetLastError());
  if (a.dl) {   // dbias: dl summed over the windows (and the heads for a one-head bias)
    const int one = a.bias_heads == 1, n = one ? a.windows * a.heads : a.windows;
    const int cols = (one ? 1 : a.heads) * L * L;
    const ColOut bo{{f32p(a.dbias)}};
    rows_sum_kernel<<<dim3((cols + 31) / 32, 1), 1024, 0, s>>>(cf32p(a.dl), bo, n, cols, cols);
    VPTR_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

// Checks the arguments, then runs the passes for T (dtype 0 = float32,
// 1 = bfloat16, 2 = float16). Returns a cudaError_t (0 = every pass
// launched), or kTmaEncodeError + a CUresult.
template <bool LN>
int run_backward(const BwdArgs* a, cudaStream_t s) {
  if (!a || a->windows < 1 || a->tokens < 1 || a->tokens > kMaxTokens || a->heads < 1 ||
      a->channels % a->heads != 0 || a->inner < 1 || a->inner % a->heads != 0 ||
      a->inner / a->heads > kMaxHeadDim ||
      (a->inner != a->channels && (a->scale || a->res)) ||
      (a->mask_heads ? a->head0 < 0 || a->head0 + a->heads > a->mask_heads : a->head0 != 0) ||
      (a->bias && a->bias_heads != 1 && a->bias_heads != a->heads) ||
      (a->dl && (!a->bias || !a->dbias)) || a->dtype < 0 || a->dtype > 2 ||
      (a->rate > 0.f && !a->seed) || a->rate >= 1.f || a->mask_tokens < a->tokens ||
      a->ksplit != ksplits(a->windows * a->tokens, a->channels, a->inner, a->dtype) ||
      !a->wpart || !a->colpart || (LN && !a->partial) || !a->dao ||
      (wg_route(a->channels, a->inner, a->dtype) ? !a->planes || !a->wcat
                                                 : !a->dq || !a->dk || !a->dv) ||
      (LN && (!a->xn || !a->xqk || !a->mean || !a->rstd)) ||
      (!LN && (!a->xv || !a->dxv || a->res || a->scale)))
    return cudaErrorInvalidValue;
  switch (a->dtype) {
    case 0:
      return run<float, LN>(*a, s);
    case 1:
      return run<bf16, LN>(*a, s);
    case 2:
      return run<__half, LN>(*a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
