// Attention core for short sequences on Hopper (sm_90a), forward and
// backward:
//     w   = softmax(q k^T * D^-1/2 + bias)            (softmax in f32)
//     out = dropout(w) v
// q: (B, H, Tq, D), k/v: (B, H, Tk, D), bias: none, (1, Tq, Tk) or
// (H, Tq, Tk) f32, out: (B, H, Tq, D); T = float or bf16; Tq, Tk <= 32,
// D <= 128. Dropout is the counter hash of hash_dropout.cuh.
//
// Replaces the TPU kernels vptr_tpu/ops/attention_core.py::_core_forward
// (_kernel, pl.pallas_call at :188) and ::_core_backward (_bwd_kernel,
// pl.pallas_call at :317).
//
// What bounds them on an H100: bytes. Per (b, h) the forward reads
// (Tq + 2 Tk) D and writes Tq D elements and does about 4 Tq Tk D flops;
// the backward reads q, k, v, g and writes dq, dk, dv (about 90 MB at the
// FAR training shapes, 640 x 8 heads x 19 x 66 in bf16) and does about
// 10 Tq Tk D flops: both are far below the ~295 flops per byte at which the
// tensor cores would become the limit. The design keeps logits, weights,
// the mask and the logit gradients out of device memory: one block per
// (b, h) stages its rows in shared memory (read as 16-byte vectors where
// the (b, h) slice allows it), one warp per query row holds one key column
// per lane (Tk <= 32) and reads the q and k rows as float4 (row stride
// padded so those reads are free of bank conflicts), takes the row max and
// sum with shuffles. The forward accumulates the weighted values with each
// lane owning up to four columns of D, one weight shuffle per key feeding
// them all. The backward recomputes the softmax and the mask from the
// seed, keeps the dropped weights and the logit gradients (Tq x Tk f32) in
// shared memory, then forms dq, dk and dv one output element per thread.
// The bias gradient sums over the batch: each (b, h) block writes its
// Tq x Tk logit gradients and a second kernel sums them over b (and over
// heads for a (1, Tq, Tk) bias) in a fixed order, so the result is the same
// on every run (no float atomics).
//
// Rounding points follow the plain versions in attention_core.py: q * scale
// (the scale in T) is rounded to T, logits, softmax and dropout are f32,
// the forward rounds the weights to T before the value product, which
// accumulates in f32 and is rounded to T; the backward works in f32 on the
// unrounded weights and rounds dq, dk, dv to T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hash_dropout.cuh"

namespace {

constexpr int kMaxTokens = 32;
constexpr int kMaxDepth = 128;
constexpr int kWarps = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// value rounded to T and widened back to f32
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

// Shared-memory row stride in floats: a multiple of 4 (rows read as
// float4) and 4 mod 8, so that the eight lanes of each float4 phase, on
// eight consecutive rows, hit eight different 16-byte bank groups.
inline __host__ __device__ int row_stride(int depth) {
  const int s = (depth + 3) & ~3;
  return s % 8 == 0 ? s + 4 : s;
}

// dst[r * stride + d] = src[r * depth + d] (times scale and rounded to T
// when scaled) for the rows x depth elements of one (b, h) slice, and
// zeros in the padding columns [depth, stride). The slice is read in
// 16-byte vectors when it is a whole number of them (the caller checks
// alignment), else element by element; the row and column of each element
// advance incrementally, with one division per vector.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int rows, int depth,
                                           int stride, float scale, bool scaled,
                                           float* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  const int n = rows * depth;
  auto put = [&](int r, int d, T val) {
    const float f = to_f32(val);
    dst[r * stride + d] = scaled ? round_t<T>(f * scale) : f;
  };
  if (n % kVec == 0) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < n / kVec; i += blockDim.x) {
      const uint4 raw = src4[i];
      const T* vals = reinterpret_cast<const T*>(&raw);
      int r = i * kVec / depth;
      int d = i * kVec - r * depth;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        put(r, d, vals[j]);
        if (++d == depth) d = 0, ++r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) put(i / depth, i % depth, src[i]);
  }
  for (int i = threadIdx.x; i < rows * (stride - depth); i += blockDim.x) {
    const int r = i / (stride - depth);
    dst[r * stride + depth + (i - r * (stride - depth))] = 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      T* __restrict__ out, int heads, int tq, int tk, int depth,
                      int bias_heads, float scale, vptr_dropout::Params drop) {
  extern __shared__ float4 smem4[];
  const int stride = row_stride(depth);
  float* qs = reinterpret_cast<float*>(smem4);  // [tq][stride] q * scale, rounded to T
  float* ks = qs + tq * stride;                  // [tk][stride]
  float* vs = ks + tk * stride;                  // [tk][stride]

  const long bh = blockIdx.x;          // b * heads + h
  const int h = static_cast<int>(bh % heads);
  const uint32_t b = static_cast<uint32_t>(bh / heads);
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  stage_rows<T>(q + bh * tq * depth, tq, depth, stride, scale, true, qs);
  stage_rows<T>(k + bh * tk * depth, tk, depth, stride, 1.f, false, ks);
  stage_rows<T>(v + bh * tk * depth, tk, depth, stride, 1.f, false, vs);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* bias_h =
      bias ? bias + static_cast<long>(bias_heads == 1 ? 0 : h) * tq * tk : nullptr;
  T* og = out + bh * tq * depth;
  for (int r = warp; r < tq; r += kWarps) {
    // logits: lane c holds key column c; q and k rows read as float4
    float logit = -INFINITY;
    if (lane < tk) {
      const float* qr = qs + r * stride;
      const float* kr = ks + lane * stride;
      float acc = 0.f;
      for (int d = 0; d < stride; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr + d);
        const float4 b4 = *reinterpret_cast<const float4*>(kr + d);
        acc = fmaf(a.x, b4.x, acc);
        acc = fmaf(a.y, b4.y, acc);
        acc = fmaf(a.z, b4.z, acc);
        acc = fmaf(a.w, b4.w, acc);
      }
      logit = bias_h ? acc + bias_h[r * tk + lane] : acc;
    }
    const float m = warp_max(logit);
    const float e = lane < tk ? expf(logit - m) : 0.f;
    float w = e / warp_sum(e);
    if (drop.active() && lane < tk)
      w = drop.apply(w, drop.keep(vptr_dropout::element_index(b, heads, h, tq, r, tk, lane),
                                  seed));
    w = round_t<T>(w);
    // weighted sum of v: lane owns columns lane + 32 j, one weight shuffle
    // per key feeds all of them
    float acc[kMaxDepth / 32];
#pragma unroll
    for (int j = 0; j < kMaxDepth / 32; ++j) acc[j] = 0.f;
    for (int c = 0; c < tk; ++c) {
      const float wc = __shfl_sync(0xffffffffu, w, c);
      const float* vr = vs + c * stride;
#pragma unroll
      for (int j = 0; j < kMaxDepth / 32; ++j)
        if (lane + 32 * j < depth) acc[j] = fmaf(wc, vr[lane + 32 * j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kMaxDepth / 32; ++j)
      if (lane + 32 * j < depth) og[r * depth + lane + 32 * j] = from_f32<T>(acc[j]);
  }
}

// Backward of one (b, h): recompute the f32 softmax w and the keep mask,
//     dv = w_drop^T g,  dw = drop(g v^T),  dl = w (dw - rowsum(dw w)),
//     dq = dl k * dscale,  dk = dl^T (q * scale),
// and, when dl_out is given, write dl for the bias gradient.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_core_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ bias,
                          const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
                          T* __restrict__ dv, float* __restrict__ dl_out, int heads,
                          int tq, int tk, int depth, int bias_heads, float scale,
                          float dscale, vptr_dropout::Params drop) {
  extern __shared__ float4 smem4[];
  const int stride = row_stride(depth);
  const int ws = kMaxTokens + 1;       // row stride of the Tq x Tk tiles
  float* qs = reinterpret_cast<float*>(smem4);  // [tq][stride] q * scale, rounded to T
  float* ks = qs + tq * stride;                  // [tk][stride]
  float* vs = ks + tk * stride;                  // [tk][stride]
  float* gs = vs + tk * stride;                  // [tq][stride]
  float* wd = gs + tq * stride;                  // [tq][ws] dropped weights (f32)
  float* dls = wd + tq * ws;                     // [tq][ws] logit gradients

  const long bh = blockIdx.x;
  const int h = static_cast<int>(bh % heads);
  const uint32_t b = static_cast<uint32_t>(bh / heads);
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  stage_rows<T>(q + bh * tq * depth, tq, depth, stride, scale, true, qs);
  stage_rows<T>(k + bh * tk * depth, tk, depth, stride, 1.f, false, ks);
  stage_rows<T>(v + bh * tk * depth, tk, depth, stride, 1.f, false, vs);
  stage_rows<T>(g + bh * tq * depth, tq, depth, stride, 1.f, false, gs);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* bias_h =
      bias ? bias + static_cast<long>(bias_heads == 1 ? 0 : h) * tq * tk : nullptr;
  auto dot = [&](const float* a, const float* c) {
    float acc = 0.f;
    for (int d = 0; d < stride; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(a + d);
      const float4 y = *reinterpret_cast<const float4*>(c + d);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
    return acc;
  };
  for (int r = warp; r < tq; r += kWarps) {
    const bool col = lane < tk;
    float logit = -INFINITY;
    if (col) {
      logit = dot(qs + r * stride, ks + lane * stride);
      if (bias_h) logit += bias_h[r * tk + lane];
    }
    const float m = warp_max(logit);
    const float e = col ? expf(logit - m) : 0.f;
    const float w = e / warp_sum(e);                   // pre-dropout, f32
    float dw = col ? dot(gs + r * stride, vs + lane * stride) : 0.f;
    float w_drop = w;
    if (drop.active() && col) {
      const bool kept =
          drop.keep(vptr_dropout::element_index(b, heads, h, tq, r, tk, lane), seed);
      w_drop = drop.apply(w, kept);
      dw = drop.apply(dw, kept);
    }
    const float s = warp_sum(col ? dw * w : 0.f);
    const float dl = w * (dw - s);
    if (col) {
      wd[r * ws + lane] = w_drop;
      dls[r * ws + lane] = dl;
      if (dl_out) dl_out[(bh * tq + r) * tk + lane] = dl;
    }
  }
  __syncthreads();

  // one output element per thread, contiguous in d: dq over tq rows, then
  // dk and dv over tk rows
  const long qo = bh * tq * depth, ko = bh * tk * depth;
  for (int i = threadIdx.x; i < tq * depth; i += blockDim.x) {
    const int r = i / depth, d = i - r * depth;
    float acc = 0.f;
    for (int c = 0; c < tk; ++c) acc = fmaf(dls[r * ws + c], ks[c * stride + d], acc);
    dq[qo + i] = from_f32<T>(acc * dscale);
  }
  for (int i = threadIdx.x; i < tk * depth; i += blockDim.x) {
    const int c = i / depth, d = i - c * depth;
    float ak = 0.f, av = 0.f;
    for (int r = 0; r < tq; ++r) {
      ak = fmaf(dls[r * ws + c], qs[r * stride + d], ak);
      av = fmaf(wd[r * ws + c], gs[r * stride + d], av);
    }
    dk[ko + i] = from_f32<T>(ak);
    dv[ko + i] = from_f32<T>(av);
  }
}

// dbias[hb][r][c] = sum over b (and over heads when the bias has one head)
// of dl[b][h][r][c], in a fixed order.
__global__ void bias_grad_kernel(const float* __restrict__ dl, float* __restrict__ dbias,
                                 int batch, int heads, int tq, int tk, int bias_heads) {
  const int n = bias_heads * tq * tk;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int hb = i / (tq * tk), rc = i - hb * tq * tk;
  const int h0 = bias_heads == 1 ? 0 : hb, h1 = bias_heads == 1 ? heads : hb + 1;
  float acc = 0.f;
  for (int h = h0; h < h1; ++h)
    for (int b = 0; b < batch; ++b)
      acc += dl[(static_cast<long>(b) * heads + h) * tq * tk + rc];
  dbias[i] = acc;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out,
           int batch, int heads, int tq, int tk, int depth, int bias_heads,
           float scale, vptr_dropout::Params drop, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (tq + 2 * tk) * row_stride(depth);
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_core_kernel<T><<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), heads, tq, tk, depth,
      bias_heads, scale, drop);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* bias, const void* g,
               void* dq, void* dk, void* dv, void* dl, void* dbias, int batch, int heads,
               int tq, int tk, int depth, int bias_heads, float scale, float dscale,
               vptr_dropout::Params drop, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((2 * tq + 2 * tk) * row_stride(depth) +
                                       2 * tq * (kMaxTokens + 1));
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_core_bwd_kernel<T><<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(g), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dl), heads, tq, tk,
      depth, bias_heads, scale, dscale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dl) return err;
  const int n = bias_heads * tq * tk;
  bias_grad_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(dl), static_cast<float*>(dbias), batch, heads, tq, tk,
      bias_heads);
  return cudaGetLastError();
}

bool bad_shape(int batch, int heads, int tq, int tk, int depth, const void* bias,
               int bias_heads, int dtype, const void* seed, float rate) {
  return batch < 1 || heads < 1 || tq < 1 || tq > kMaxTokens || tk < 1 ||
         tk > kMaxTokens || depth < 1 || depth > kMaxDepth ||
         (bias && bias_heads != 1 && bias_heads != heads) || dtype < 0 || dtype > 1 ||
         (rate > 0.f && !seed) || rate >= 1.f;
}

}  // namespace

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. seed: device int32 (may be null when
// rate == 0); keep_div = (float)(1 - rate). Returns a cudaError_t (0 =
// launched).
int vptr_attention_core(const void* q, const void* k, const void* v, const void* bias,
                        void* out, int batch, int heads, int tq, int tk, int depth,
                        int bias_heads, float scale, const void* seed, float rate,
                        float keep_div, int dtype, void* stream) {
  if (bad_shape(batch, heads, tq, tk, depth, bias, bias_heads, dtype, seed, rate))
    return cudaErrorInvalidValue;
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, out, batch, heads, tq, tk, depth, bias_heads,
                         scale, drop, s);
  return launch<__nv_bfloat16>(q, k, v, bias, out, batch, heads, tq, tk, depth,
                               bias_heads, scale, drop, s);
}

// Backward: dq, dk, dv (T) and, when dl and dbias are given (dl: a
// (B, H, Tq, Tk) f32 scratch, dbias: (bias_heads, Tq, Tk) f32), the bias
// gradient. scale multiplies q (in T), dscale the dq sums (f32).
int vptr_attention_core_bwd(const void* q, const void* k, const void* v, const void* bias,
                            const void* g, void* dq, void* dk, void* dv, void* dl,
                            void* dbias, int batch, int heads, int tq, int tk, int depth,
                            int bias_heads, float scale, float dscale, const void* seed,
                            float rate, float keep_div, int dtype, void* stream) {
  if (bad_shape(batch, heads, tq, tk, depth, bias, bias_heads, dtype, seed, rate) ||
      (dl && (!bias || !dbias)))
    return cudaErrorInvalidValue;
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, bias, g, dq, dk, dv, dl, dbias, batch, heads, tq,
                             tk, depth, bias_heads, scale, dscale, drop, s);
  return launch_bwd<__nv_bfloat16>(q, k, v, bias, g, dq, dk, dv, dl, dbias, batch, heads,
                                   tq, tk, depth, bias_heads, scale, dscale, drop, s);
}

}  // extern "C"
