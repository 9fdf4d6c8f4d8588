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
// The LayerNorm passes (1, 7), the products, the split-K sums and the
// column sums are tile_ops.cuh's building blocks, which the FFN backward
// (fused_ffn_bwd.cu) shares.
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

#include "hash_dropout.cuh"
#include "tile_ops.cuh"

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

constexpr int kMaxTokens = 32;
constexpr int kMaxHeadDim = 128;

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
