// Attention core on Hopper (sm_90a), forward and backward:
//     w   = softmax(q k^T * D^-1/2 + bias)            (softmax in f32)
//     out = dropout(w) v
// q: (B, H, Tq, D), k/v: (B, H, Tk, D), bias: none, (1, Tq, Tk) or
// (H, Tq, Tk) f32, out: (B, H, Tq, D); T = float, bf16 or f16; Tq, Tk <= 32
// and D <= 128 on the short routes (FMA, mma), Tq, Tk <= 160 and D <= 80 on
// the long route (TSLMA's space-time windows, at the end of this file). Dropout
// is the counter hash of hash_dropout.cuh.
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
// tensor cores would become the limit. Both keep logits, weights, the mask
// and the logit gradients out of device memory. Two forward routes, named
// by ops/attention_core.py::kernel_route from the shapes:
//
// * mma (bf16 where each batch element's q and k slices are whole 16-byte
//   vectors and fit a block's shared memory): attention_core_mma_kernel.
//   A block takes a batch element and all of its heads: the element's q,
//   k and v slices are contiguous in both layouts the route reads (the
//   contiguous (B, H, T, D), and the (B, H, T, D) view of the projections'
//   contiguous (B, T, H D), so the layer needs no copies), so one thread
//   stages each with one bulk copy completing on an mbarrier. A warp takes
//   a head as kernels #1/#5's window_fwd_kernel takes one (mma_sync.cuh's
//   helpers): q k^T on mma.sync m16n8k16 (bf16 in, f32 sums; q * scale
//   rounded as its A fragments are formed), the bias, the f32 softmax on a
//   quad of lanes, the hash dropout, the weights rounded into P's A
//   fragments, P v on mma.sync, the output written over the head's q; the
//   block stores the slice whole in 16-byte vectors, in q's layout.
// * FMA (f32, f16, and bf16 shapes mma does not take; contiguous
//   operands): attention_core_kernel, one block per (b, h) staging its
//   rows in shared memory as f32 (read as 16-byte vectors where the (b, h) slice allows
//   it), one warp per query row holding one key column per lane (Tk <=
//   32), the q and k rows read as float4 (row stride padded so those reads
//   are free of bank conflicts), the row max and sum by shuffles, and the
//   weighted values accumulated with each lane owning up to four columns
//   of D, one weight shuffle per key feeding them all.
//
// The backward recomputes the softmax and the mask from the seed. Two
// routes, named by ops/attention_core.py::backward_route from the shapes:
//
// * mma (bf16, the shapes the forward's mma route takes where q, k, v and
//   g of a batch element fit a block's shared memory):
//   attention_core_bwd_mma_kernel. A block takes a batch element and all
//   of its heads; one thread stages its q, k, v and g slices with four
//   bulk copies on two mbarriers (q and k; then v and g, which land while
//   S is formed), each operand in layout 0 or 1 of Slice, g too. A warp
//   takes a head: S = (q scale) k^T and dW = g v^T on mma.sync; the
//   softmax, the mask, the dropped weights and the logit gradients dS in
//   registers on the quads (the dropout quotient by a reciprocal and one
//   correction, no division); then dv = w_drop^T g, dq = dS k dscale and
//   dk = dS^T (q scale) on mma.sync. dS and w_drop are f32 and enter the
//   tensor cores as two bf16 terms (hi = bf16(x), lo = bf16(x - hi)).
//   Every transposed operand comes from movmatrix, the warp's 8 x 8
//   register transpose: dS^T and w_drop^T (the A operands of dk and dv)
//   from the accumulators, and the B operands of the three products (two
//   tokens a register, down a column of the staged rows) from 4-byte
//   loads along the rows. Each output is written over an input its head
//   has done reading (dv over v, dq over g, dk over k) and the block
//   stores the three slices whole, each in its input's layout (dq in q's).
// * FMA (f32, f16, and bf16 shapes mma does not take; contiguous
//   operands): attention_core_bwd_kernel keeps the dropped weights and the
//   logit gradients (Tq x Tk f32) in shared memory, then forms dq, dk and
//   dv one output element per thread.
//
// The bias gradient sums over the batch: each (b, h) writes its Tq x Tk
// logit gradients and a second kernel sums them over b (and over heads
// for a (1, Tq, Tk) bias) in a fixed order, so the result is the same on
// every run (no float atomics).
//
// A head subset (tensor parallelism): a call may hold heads h0 .. h0 + H - 1
// of Hg, its q, k, v (B, H, T, D) those heads' and a per-head bias those
// heads' rows. Every route takes it; only the dropout index changes, to
// the global head's (hash_dropout.cuh's Params::index, from the
// mask_heads and head0 of the C entry points). The gradient of a one-head
// (1, Tq, Tk) bias is then the sum over the call's heads, which the layer
// sums over the ranks.
//
// The long route ("long", Tq or Tk past 32): a block takes one head of one
// batch element (a batch element's q, k, v no longer fit a block), its
// rows staged with 4-byte loads into padded shared-memory rows. bf16 on
// mma.sync: attention_core_long_kernel (80 query rows a block, a 16-row
// strip a warp, the strip's whole row of logits in registers) and
// attention_core_long_bwd_kernel (a pass over query strips for dq and the
// softmax statistics, then a pass over key strips for dk and dv, w and dS
// formed again from the statistics); f32 on the FMA units:
// attention_core_long_fma_kernel and attention_core_long_bwd_fma_kernel,
// the same two passes a warp a row. No f16 kernel: the long route refuses
// dtype 2 (cudaErrorInvalidValue; ops/attention_core.py raises first).
//
// Rounding points follow the plain versions in attention_core.py: q * scale
// (the scale in T) is rounded to T, logits, softmax and dropout are f32,
// the forward rounds the weights to T before the value product, which
// accumulates in f32 and is rounded to T; the backward works in f32 on the
// unrounded weights and rounds dq, dk, dv to T (its mma route: the
// products of the f32 dS and w_drop as two bf16 terms each, f32 sums).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hash_dropout.cuh"
#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxTokens = 32;
constexpr int kMaxDepth = 128;
constexpr int kWarps = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// f16: round to nearest even, as torch's and XLA's f32 -> f16 casts
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
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
      w = drop.apply(w, drop.keep(drop.index(b, heads, h, tq, r, tk, lane),
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
          drop.keep(drop.index(b, heads, h, tq, r, tk, lane), seed);
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

int launch_bias_grad(const void* dl, void* dbias, int batch, int heads, int tq, int tk,
                     int bias_heads, cudaStream_t stream) {
  const int n = bias_heads * tq * tk;
  bias_grad_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(dl), static_cast<float*>(dbias), batch, heads, tq, tk,
      bias_heads);
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
  return launch_bias_grad(dl, dbias, batch, heads, tq, tk, bias_heads, stream);
}

// ---------------------------------------------------------------------------
// bf16 route ("mma"): a batch element a unit of work, every head of it

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaStages = 1;           // slices a block holds (2: a persistent ring)
constexpr long kMaxSmem = 232448;       // dynamic shared memory a block may use

// Where row r of head h lies in an operand's batch-element slice: element
// h * head + r * row. Layout 0, the contiguous (B, H, T, D): head = T D,
// row = D; layout 1, the (B, H, T, D) view of a contiguous (B, T, H D):
// head = D, row = H D. Either way the slice is H T D contiguous elements.
struct Slice {
  int head, row;
};

inline Slice slice_of(int layout, int heads, int tokens, int depth) {
  return layout == 0 ? Slice{tokens * depth, depth} : Slice{depth, heads * depth};
}

// Everything a launch of attention_core_mma_kernel takes; out has q's layout.
struct MmaArgs {
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;
  __nv_bfloat16* out;
  int batch, heads, tq, tk, depth, bias_heads;
  Slice qs, ks, vs;
  float scale;
  vptr_dropout::Params drop;
};

// Bytes of one stage: the q, k and v slices of a batch element.
inline long mma_stage_bytes(int heads, int tq, int tk, int depth) {
  return 2L * heads * (tq + 2L * tk) * depth;
}

// Whether the mma kernel takes the shape: bf16, each slice a whole number
// of 16-byte vectors (the bulk copies and the vector stores need it), the
// stages and their barriers within a block's shared memory.
bool mma_takes(int heads, int tq, int tk, int depth, int dtype) {
  return dtype == 1 && (static_cast<long>(heads) * tq * depth) % 8 == 0 &&
         (static_cast<long>(heads) * tk * depth) % 8 == 0 &&
         kMmaStages * (mma_stage_bytes(heads, tq, tk, depth) + 8) <= kMaxSmem;
}

// One 1-D bulk copy (the async proxy) of `bytes` from device memory into
// shared memory, completing on bar; both addresses 16-byte aligned, bytes
// a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A q pair times the scale in one bf16x2 multiply, correctly rounded as
// the plain version's q * scale in bf16 is.
__device__ __forceinline__ uint32_t scaled_pair(uint32_t pair, __nv_bfloat162 scale) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&pair), scale);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// A block walks the batch elements e = blockIdx.x, + gridDim.x, ...: one
// thread stages e's q, k and v slices with three bulk copies on the stage's
// mbarrier, warp w takes the heads w, w + 8, ... of the staged element as
// window_fwd_kernel takes a window's heads (q k^T on mma.sync, the softmax
// on the quads' accumulators, the weights rounded into P's A fragments, P v
// on mma.sync), writes the head's output over its q, and the block stores
// the slice whole in 16-byte vectors. MQ: 16-row query tiles (Tq <= 16 or
// <= 32), KS: 16-key steps of P v (Tk <= 16 or <= 32), so the logits are
// MQ x 2 KS tiles of 16 x 8. With kMmaStages = 2 (a design measured and
// not kept) the block is persistent and the next element's copies fly
// while this one computes.
template <int MQ, int KS, bool PAIRS>
__global__ void __launch_bounds__(kMmaThreads, MQ == 1 && KS == 1 ? 4 : 3)
attention_core_mma_kernel(const MmaArgs a) {
  constexpr int NT = 2 * KS;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const int tq = a.tq, tk = a.tk, hd = a.depth;
  const int qn = a.heads * tq * hd, kn = a.heads * tk * hd;  // slice elements
  const int stage = qn + 2 * kn;
  bf16* const stages = reinterpret_cast<bf16*>(smem_mma);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(stages + kMmaStages * stage);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t seed = a.drop.active() ? a.drop.seed_u32() : 0u;
  const __nv_bfloat162 scale = __float2bfloat162_rn(a.scale);  // exact: a bf16 value

  auto stage_in = [&](long e, int s) {           // thread 0
    bf16* dst = stages + s * stage;
    mbar_expect_tx(bars + s, 2u * stage, true);
    bulk_load(dst, a.q + e * qn, 2u * qn, bars + s);
    bulk_load(dst + qn, a.k + e * kn, 2u * kn, bars + s);
    bulk_load(dst + qn + kn, a.v + e * kn, 2u * kn, bars + s);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMmaStages; ++s) mbar_init(bars + s, 1);
    mbar_fence_init();
    for (int s = 0; s < kMmaStages; ++s) {
      const long e = blockIdx.x + static_cast<long>(s) * gridDim.x;
      if (e < a.batch) stage_in(e, s);
    }
  }
  __syncthreads();                               // the barriers are initialised

  int it = 0;
  for (long e = blockIdx.x; e < a.batch; e += gridDim.x, ++it) {
    const int s = it % kMmaStages;
    bf16* const qs = stages + s * stage;          // q, then the output
    const bf16* const ks = qs + qn;
    const bf16* const vs = ks + kn;
    mbar_wait(bars + s, (it / kMmaStages) & 1);

    for (int h = warp; h < a.heads; h += kMmaWarps) {
      bf16* const qh = qs + h * a.qs.head;
      const bf16* const kh = ks + h * a.ks.head;
      const bf16* const vh = vs + h * a.vs.head;
      const int qr = a.qs.row, kr = a.ks.row, vr = a.vs.row;

      // logits s[mt][nt]: query rows 16 mt + g (+ 8), keys 8 nt + 2t (+ 1)
      float sc[MQ][NT][4];
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) sc[mt][nt][x] = 0.f;
      for (int k0 = 0; k0 < hd; k0 += 16) {
        uint32_t af[MQ][4];
#pragma unroll
        for (int mt = 0; mt < MQ; ++mt) {
          const int i0 = 16 * mt + g, i1 = i0 + 8;
          af[mt][0] = scaled_pair(load_pair<PAIRS>(qh + i0 * qr, k0 + 2 * t, hd, i0 < tq), scale);
          af[mt][1] = scaled_pair(load_pair<PAIRS>(qh + i1 * qr, k0 + 2 * t, hd, i1 < tq), scale);
          af[mt][2] =
              scaled_pair(load_pair<PAIRS>(qh + i0 * qr, k0 + 2 * t + 8, hd, i0 < tq), scale);
          af[mt][3] =
              scaled_pair(load_pair<PAIRS>(qh + i1 * qr, k0 + 2 * t + 8, hd, i1 < tq), scale);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (8 * nt >= tk) break;                   // warp-uniform
          const int j = 8 * nt + g;
          const uint32_t b0 = load_pair<PAIRS>(kh + j * kr, k0 + 2 * t, hd, j < tk);
          const uint32_t b1 = load_pair<PAIRS>(kh + j * kr, k0 + 2 * t + 8, hd, j < tk);
#pragma unroll
          for (int mt = 0; mt < MQ; ++mt) mma_16816(sc[mt][nt], af[mt], b0, b1);
        }
      }
      __syncwarp();                                // q is read: the output takes its place

      // the bias, the softmax over each row (a quad of lanes holds it; the
      // exponential on the SFU, one reciprocal a row), the dropout, the
      // weights rounded to bf16 as P's A fragments: logit tiles 2 ks and
      // 2 ks + 1 are P's 16-key step ks
      const float* bias_h =
          a.bias ? a.bias + static_cast<long>(a.bias_heads == 1 ? 0 : h) * tq * tk : nullptr;
      uint32_t p[MQ][KS][4];
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (16 * mt + 8 * hh >= tq) {              // rows past Tq: weight 0 (warp-uniform)
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) p[mt][kk][hh] = p[mt][kk][2 + hh] = 0u;
            continue;
          }
          const int i = 16 * mt + g + 8 * hh;
          float m = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int j = 8 * nt + 2 * t + x;
              float l = -INFINITY;
              if (i < tq && j < tk) {
                l = sc[mt][nt][2 * hh + x];
                if (bias_h) l += __ldg(bias_h + i * tk + j);
              }
              sc[mt][nt][2 * hh + x] = l;
              m = fmaxf(m, l);
            }
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int j = 8 * nt + 2 * t + x;
              const float y = i < tq && j < tk ? __expf(sc[mt][nt][2 * hh + x] - m) : 0.f;
              sc[mt][nt][2 * hh + x] = y;
              sum += y;
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          const float rcp = 1.f / sum;
          const uint32_t row_idx = a.drop.index(
              static_cast<uint32_t>(e), a.heads, h, tq, i, tk, 0);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float wv[2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int j = 8 * nt + 2 * t + x;
              float w = 0.f;                         // rows and keys past Tq, Tk: weight 0
              if (i < tq && j < tk) {
                w = sc[mt][nt][2 * hh + x] * rcp;
                if (a.drop.active()) w = a.drop.apply(w, a.drop.keep(row_idx + j, seed));
              }
              wv[x] = w;
            }
            p[mt][nt >> 1][2 * (nt & 1) + hh] = pack_bf16(wv[0], wv[1]);
          }
        }

      // P v, eight columns of the head at a time, over the head's q
      for (int n0 = 0; n0 < hd; n0 += 8) {
        float o[MQ][4];
#pragma unroll
        for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
          for (int x = 0; x < 4; ++x) o[mt][x] = 0.f;
        const int d = n0 + g;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t b[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = 16 * kk + 8 * half + 2 * t;
            const uint32_t lo =
                j < tk && d < hd ? *reinterpret_cast<const uint16_t*>(vh + j * vr + d) : 0u;
            const uint32_t hi =
                j + 1 < tk && d < hd ? *reinterpret_cast<const uint16_t*>(vh + (j + 1) * vr + d)
                                     : 0u;
            b[half] = lo | hi << 16;
          }
#pragma unroll
          for (int mt = 0; mt < MQ; ++mt) mma_16816(o[mt], p[mt][kk], b[0], b[1]);
        }
#pragma unroll
        for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 16 * mt + g + 8 * hh, c = n0 + 2 * t;
            if (i >= tq) continue;
            bf16* const dst = qh + i * qr + c;
            if constexpr (PAIRS) {
              if (c < hd)
                *reinterpret_cast<__nv_bfloat162*>(dst) =
                    __floats2bfloat162_rn(o[mt][2 * hh], o[mt][2 * hh + 1]);
            } else {
              if (c < hd) dst[0] = __float2bfloat16_rn(o[mt][2 * hh]);
              if (c + 1 < hd) dst[1] = __float2bfloat16_rn(o[mt][2 * hh + 1]);
            }
          }
      }
    }
    __syncthreads();

    // the output slice, in q's layout, stored whole
    const uint4* src = reinterpret_cast<const uint4*>(qs);
    uint4* dst = reinterpret_cast<uint4*>(a.out + e * qn);
    for (int c = threadIdx.x; c < qn / 8; c += kMmaThreads) dst[c] = src[c];
    const long next = e + static_cast<long>(kMmaStages) * gridDim.x;
    if (next < a.batch) {                          // block-uniform: refill this stage
      fence_proxy_async();                         // generic accesses before the async copies
      __syncthreads();
      if (threadIdx.x == 0) stage_in(next, s);
    }
  }
}

int launch_mma(const MmaArgs& a, cudaStream_t stream) {
  using Kernel = void (*)(const MmaArgs);
  static const Kernel kernels[2][2][2] = {
      {{&attention_core_mma_kernel<1, 1, false>, &attention_core_mma_kernel<1, 1, true>},
       {&attention_core_mma_kernel<1, 2, false>, &attention_core_mma_kernel<1, 2, true>}},
      {{&attention_core_mma_kernel<2, 1, false>, &attention_core_mma_kernel<2, 1, true>},
       {&attention_core_mma_kernel<2, 2, false>, &attention_core_mma_kernel<2, 2, true>}}};
  const Kernel kernel = kernels[a.tq > 16][a.tk > 16][a.depth % 2 == 0];
  const int smem = static_cast<int>(
      kMmaStages * (mma_stage_bytes(a.heads, a.tq, a.tk, a.depth) + 8));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = a.batch;
  if (kMmaStages > 1) {                          // persistent: as many blocks as fit
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem);
    if (err != cudaSuccess) return err;
    blocks = per_sm * sms < blocks ? per_sm * sms : blocks;
  }
  kernel<<<blocks, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 backward route ("mma"): a batch element a block, every head of it

// Everything a launch of attention_core_bwd_mma_kernel takes; dq has q's
// layout, dk k's, dv v's.
struct MmaBwdArgs {
  const __nv_bfloat16 *q, *k, *v, *g;
  const float* bias;
  __nv_bfloat16 *dq, *dk, *dv;
  float* dl;                      // (B, H, Tq, Tk) f32 logit gradients, or null
  int batch, heads, tq, tk, depth, bias_heads;
  Slice qs, ks, vs, gs;
  float scale, dscale;
  vptr_dropout::Params drop;
};

// Bytes a block stages: the q, k, v and g slices of a batch element.
inline long mma_bwd_bytes(int heads, int tq, int tk, int depth) {
  return 4L * heads * (tq + tk) * depth;
}

// Whether the mma backward kernel takes the shape: bf16, each slice a whole
// number of 16-byte vectors, the four slices and two barriers within a
// block's shared memory (ops/attention_core.py::backward_route says the same).
bool mma_bwd_takes(int heads, int tq, int tk, int depth, int dtype) {
  return dtype == 1 && (static_cast<long>(heads) * tq * depth) % 8 == 0 &&
         (static_cast<long>(heads) * tk * depth) % 8 == 0 &&
         mma_bwd_bytes(heads, tq, tk, depth) + 16 <= kMaxSmem;
}

// The 8 x 8 bf16 block a warp holds one register a lane (lane l: row l / 4,
// elements 2 (l % 4) and + 1: an mma.sync A fragment register or a packed
// accumulator pair), transposed, in the same layout.
__device__ __forceinline__ uint32_t transpose_8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// The f32 pair (a, b) as two bf16 terms each, packed a pair a register:
// hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// acc[mt][nt] = x y^T over one head's width: x's rows 16 mt + g (+ 8) (those
// below rows_x), y's rows 8 nt + g (below rows_y), both read as pairs along
// the width as the forward reads q and k; x times the scale (SCALED) as its
// A fragments are formed.
template <int MQ, int NT, bool PAIRS, bool SCALED>
__device__ __forceinline__ void row_products(float (&acc)[MQ][NT][4], const bf16* x, int xr,
                                             int rows_x, const bf16* y, int yr, int rows_y,
                                             int hd, int g, int t, __nv_bfloat162 scale) {
#pragma unroll
  for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  for (int k0 = 0; k0 < hd; k0 += 16) {
    uint32_t af[MQ][4];
#pragma unroll
    for (int mt = 0; mt < MQ; ++mt) {
      const int i0 = 16 * mt + g, i1 = i0 + 8;
      af[mt][0] = load_pair<PAIRS>(x + i0 * xr, k0 + 2 * t, hd, i0 < rows_x);
      af[mt][1] = load_pair<PAIRS>(x + i1 * xr, k0 + 2 * t, hd, i1 < rows_x);
      af[mt][2] = load_pair<PAIRS>(x + i0 * xr, k0 + 2 * t + 8, hd, i0 < rows_x);
      af[mt][3] = load_pair<PAIRS>(x + i1 * xr, k0 + 2 * t + 8, hd, i1 < rows_x);
      if constexpr (SCALED) {
#pragma unroll
        for (int c = 0; c < 4; ++c) af[mt][c] = scaled_pair(af[mt][c], scale);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (8 * nt >= rows_y) break;                 // warp-uniform
      const int j = 8 * nt + g;
      const uint32_t b0 = load_pair<PAIRS>(y + j * yr, k0 + 2 * t, hd, j < rows_y);
      const uint32_t b1 = load_pair<PAIRS>(y + j * yr, k0 + 2 * t + 8, hd, j < rows_y);
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt) mma_16816(acc[mt][nt], af[mt], b0, b1);
    }
  }
}

// dst = factor (A B), rounded to bf16, eight columns of the head at a time:
// A as two bf16 terms (ah + al; MT 16-row tiles by KT 16-deep steps of A
// fragments), B's 16 x 8 tiles read from y's rows (those below rows_y;
// times the scale when SCALED) as two 8 x 8 blocks, each one 4-byte pair a
// lane along the row, transposed into B's fragment layout by movmatrix;
// the rows 16 mt + g (+ 8) below rows_out written to dst with row stride
// dr; two chunks an iteration. The two terms sum apart and meet in f32.
template <int MT, int KT, bool PAIRS, bool SCALED>
__device__ __forceinline__ void col_products(const uint32_t (&ah)[MT][KT][4],
                                             const uint32_t (&al)[MT][KT][4], const bf16* y,
                                             int yr, int rows_y, bf16* dst, int dr, int rows_out,
                                             int hd, float factor, int g, int t,
                                             __nv_bfloat162 scale) {
#pragma unroll 2
  for (int n0 = 0; n0 < hd; n0 += 8) {
    uint32_t b[KT][2];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 16 * kk + 8 * half + g;      // row g of the block, before its transpose
        const uint32_t p = load_pair<PAIRS>(y + j * yr, n0 + 2 * t, hd, j < rows_y);
        b[kk][half] = transpose_8x8(SCALED ? scaled_pair(p, scale) : p);
      }
    float oh[MT][4], ol[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) oh[mt][c] = ol[mt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(oh[mt], ah[mt][kk], b[kk][0], b[kk][1]);
        mma_16816(ol[mt], al[mt][kk], b[kk][0], b[kk][1]);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * mt + g + 8 * hh, c = n0 + 2 * t;
        if (i >= rows_out) continue;
        bf16* const p = dst + i * dr + c;
        const float v0 = (oh[mt][2 * hh] + ol[mt][2 * hh]) * factor;
        const float v1 = (oh[mt][2 * hh + 1] + ol[mt][2 * hh + 1]) * factor;
        if constexpr (PAIRS) {
          if (c < hd) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < hd) p[0] = __float2bfloat16_rn(v0);
          if (c + 1 < hd) p[1] = __float2bfloat16_rn(v1);
        }
      }
  }
}

// A Tq x Tk matrix's A fragments p[MQ][KS][4] (rows: queries, depth: keys)
// transposed into A fragments pt[KS][MQ][4] (rows: keys, depth: queries):
// register r of p[mt][kk] holds the 8 x 8 block (2 mt + r % 2, 2 kk + r / 2).
template <int MQ, int KS>
__device__ __forceinline__ void transpose_frags(const uint32_t (&p)[MQ][KS][4],
                                                uint32_t (&pt)[KS][MQ][4]) {
#pragma unroll
  for (int mk = 0; mk < KS; ++mk)
#pragma unroll
    for (int kq = 0; kq < MQ; ++kq) {
      pt[mk][kq][0] = transpose_8x8(p[kq][mk][0]);
      pt[mk][kq][1] = transpose_8x8(p[kq][mk][2]);
      pt[mk][kq][2] = transpose_8x8(p[kq][mk][1]);
      pt[mk][kq][3] = transpose_8x8(p[kq][mk][3]);
    }
}

// A block takes batch element blockIdx.x: one thread stages its q, k, v and
// g slices with four bulk copies on two mbarriers (q and k; v and g, awaited
// after S); warp w takes the heads w,
// w + 8, ...: S = (q scale) k^T and dW = g v^T on mma.sync, the softmax
// (as the forward: __expf, one reciprocal a row), the mask, w_drop, the
// dropped dW, the row sums of dW w by quad shuffles and dS = w (dW - sum)
// on the quads' accumulators; then dv = w_drop^T g over v, dq = dS k dscale
// over g (in g's layout), dk = dS^T (q scale) over k: each place is read
// for the last time by the head's earlier products before it is written.
// The block stores the three slices whole. MQ, KS as for
// attention_core_mma_kernel (Tq, Tk <= 16 or <= 32).
template <int MQ, int KS, bool PAIRS>
__global__ void __launch_bounds__(kMmaThreads, MQ == 1 && KS == 1 ? 4 : 2)
attention_core_bwd_mma_kernel(const MmaBwdArgs a) {
  constexpr int NT = 2 * KS;
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  const int tq = a.tq, tk = a.tk, hd = a.depth;
  const int qn = a.heads * tq * hd, kn = a.heads * tk * hd;  // slice elements
  bf16* const qs = reinterpret_cast<bf16*>(smem_bwd);        // q
  bf16* const ks = qs + qn;                                   // k, then dk
  bf16* const vs = ks + kn;                                   // v, then dv
  bf16* const gs = vs + kn;                                   // g, then dq (in g's layout)
  uint64_t* const bar = reinterpret_cast<uint64_t*>(gs + qn);  // [0]: q, k; [1]: v, g
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long e = blockIdx.x;
  const uint32_t seed = a.drop.active() ? a.drop.seed_u32() : 0u;
  const float keep_rcp = 1.f / a.drop.keep_div;
  const __nv_bfloat162 scale = __float2bfloat162_rn(a.scale);  // exact: a bf16 value

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, 2u * (qn + kn), true);
    bulk_load(qs, a.q + e * qn, 2u * qn, bar);
    bulk_load(ks, a.k + e * kn, 2u * kn, bar);
    mbar_expect_tx(bar + 1, 2u * (qn + kn), true);
    bulk_load(vs, a.v + e * kn, 2u * kn, bar + 1);
    bulk_load(gs, a.g + e * qn, 2u * qn, bar + 1);
  }
  __syncthreads();                                 // the barriers are initialised
  mbar_wait(bar, 0);

  for (int h = warp; h < a.heads; h += kMmaWarps) {
    const bf16* const qh = qs + h * a.qs.head;
    bf16* const kh = ks + h * a.ks.head;
    bf16* const vh = vs + h * a.vs.head;
    bf16* const gh = gs + h * a.gs.head;
    const int qr = a.qs.row, kr = a.ks.row, vr = a.vs.row, gr = a.gs.row;

    // S and dW: query rows 16 mt + g (+ 8), keys 8 nt + 2t (+ 1)
    float sc[MQ][NT][4], dw[MQ][NT][4];
    row_products<MQ, NT, PAIRS, true>(sc, qh, qr, tq, kh, kr, tk, hd, g, t, scale);
    mbar_wait(bar + 1, 0);                         // v and g: in flight under S
    row_products<MQ, NT, PAIRS, false>(dw, gh, gr, tq, vh, vr, tk, hd, g, t, scale);
    __syncwarp();                                  // v is read: dv takes its place

    // a row's softmax, mask, w_drop, dropped dW and dS on its quad of
    // lanes; dS and w_drop packed as A fragments of two bf16 terms (logit
    // tiles 2 kk and 2 kk + 1 are the 16-key step kk), dS also to dl
    const float* bias_h =
        a.bias ? a.bias + static_cast<long>(a.bias_heads == 1 ? 0 : h) * tq * tk : nullptr;
    float* const dl_h = a.dl ? a.dl + (e * a.heads + h) * tq * tk : nullptr;
    uint32_t dsh[MQ][KS][4], dsl[MQ][KS][4], wdh[MQ][KS][4], wdl[MQ][KS][4];
#pragma unroll
    for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (16 * mt + 8 * hh >= tq) {              // rows past Tq: 0 (warp-uniform)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
#pragma unroll
            for (int r = hh; r < 4; r += 2)
              dsh[mt][kk][r] = dsl[mt][kk][r] = wdh[mt][kk][r] = wdl[mt][kk][r] = 0u;
          continue;
        }
        const int i = 16 * mt + g + 8 * hh;
        float m = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int j = 8 * nt + 2 * t + x;
            float l = -INFINITY;
            if (i < tq && j < tk) {
              l = sc[mt][nt][2 * hh + x];
              if (bias_h) l += __ldg(bias_h + i * tk + j);
            }
            sc[mt][nt][2 * hh + x] = l;
            m = fmaxf(m, l);
          }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int j = 8 * nt + 2 * t + x;
            const float y = i < tq && j < tk ? __expf(sc[mt][nt][2 * hh + x] - m) : 0.f;
            sc[mt][nt][2 * hh + x] = y;
            sum += y;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float rcp = 1.f / sum;
        const uint32_t row_idx = a.drop.index(
            static_cast<uint32_t>(e), a.heads, h, tq, i, tk, 0);
        float dot = 0.f;                             // the row's sum of dW w
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float wv[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int j = 8 * nt + 2 * t + x;
            float w = 0.f, wd = 0.f, dwd = 0.f;      // rows and keys past Tq, Tk: 0
            if (i < tq && j < tk) {
              w = wd = sc[mt][nt][2 * hh + x] * rcp;
              dwd = dw[mt][nt][2 * hh + x];
              if (a.drop.active()) {
                const bool kept = a.drop.keep(row_idx + j, seed);
                wd = a.drop.apply_rcp(w, kept, keep_rcp);
                dwd = a.drop.apply_rcp(dwd, kept, keep_rcp);
              }
            }
            sc[mt][nt][2 * hh + x] = w;
            dw[mt][nt][2 * hh + x] = dwd;
            dot += dwd * w;
            wv[x] = wd;
          }
          split_pair(wv[0], wv[1], wdh[mt][nt >> 1][2 * (nt & 1) + hh],
                     wdl[mt][nt >> 1][2 * (nt & 1) + hh]);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float ds[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int j = 8 * nt + 2 * t + x;
            ds[x] = sc[mt][nt][2 * hh + x] * (dw[mt][nt][2 * hh + x] - dot);
            if (dl_h && i < tq && j < tk) dl_h[i * tk + j] = ds[x];
          }
          split_pair(ds[0], ds[1], dsh[mt][nt >> 1][2 * (nt & 1) + hh],
                     dsl[mt][nt >> 1][2 * (nt & 1) + hh]);
        }
      }

    // dv = w_drop^T g over v; dq = dS k dscale over g; dk = dS^T (q scale) over k
    {
      uint32_t th[KS][MQ][4], tl[KS][MQ][4];
      transpose_frags<MQ, KS>(wdh, th);
      transpose_frags<MQ, KS>(wdl, tl);
      col_products<KS, MQ, PAIRS, false>(th, tl, gh, gr, tq, vh, vr, tk, hd, 1.f, g, t, scale);
    }
    __syncwarp();                                  // g is read: dq takes its place
    col_products<MQ, KS, PAIRS, false>(dsh, dsl, kh, kr, tk, gh, gr, tq, hd, a.dscale, g, t,
                                       scale);
    __syncwarp();                                  // k is read: dk takes its place
    {
      uint32_t th[KS][MQ][4], tl[KS][MQ][4];
      transpose_frags<MQ, KS>(dsh, th);
      transpose_frags<MQ, KS>(dsl, tl);
      col_products<KS, MQ, PAIRS, true>(th, tl, qh, qr, tq, kh, kr, tk, hd, 1.f, g, t, scale);
    }
  }
  mbar_wait(bar + 1, 0);                           // a warp with no head waits here
  __syncthreads();

  // the three slices stored whole in 16-byte vectors, each in its input's
  // layout; dq from g's place, moved into q's layout where the two differ
  auto store = [&](bf16* dst, const bf16* src, int n) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int c = threadIdx.x; c < n / 8; c += kMmaThreads) d4[c] = s4[c];
  };
  store(a.dv + e * kn, vs, kn);
  store(a.dk + e * kn, ks, kn);
  if (a.qs.head == a.gs.head && a.qs.row == a.gs.row) {
    store(a.dq + e * qn, gs, qn);
  } else {
    bf16* const dst = a.dq + e * qn;
    for (int c = threadIdx.x; c < qn; c += kMmaThreads) {
      const int d = c % hd, r = c / hd % tq, hh = c / (tq * hd);
      dst[hh * a.qs.head + r * a.qs.row + d] = gs[hh * a.gs.head + r * a.gs.row + d];
    }
  }
}

int launch_bwd_mma(const MmaBwdArgs& a, void* dbias, cudaStream_t stream) {
  using Kernel = void (*)(const MmaBwdArgs);
  static const Kernel kernels[2][2][2] = {
      {{&attention_core_bwd_mma_kernel<1, 1, false>, &attention_core_bwd_mma_kernel<1, 1, true>},
       {&attention_core_bwd_mma_kernel<1, 2, false>, &attention_core_bwd_mma_kernel<1, 2, true>}},
      {{&attention_core_bwd_mma_kernel<2, 1, false>, &attention_core_bwd_mma_kernel<2, 1, true>},
       {&attention_core_bwd_mma_kernel<2, 2, false>,
        &attention_core_bwd_mma_kernel<2, 2, true>}}};
  const Kernel kernel = kernels[a.tq > 16][a.tk > 16][a.depth % 2 == 0];
  const int smem = static_cast<int>(mma_bwd_bytes(a.heads, a.tq, a.tk, a.depth) + 16);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.batch, kMmaThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !a.dl) return err;
  return launch_bias_grad(a.dl, dbias, a.batch, a.heads, a.tq, a.tk, a.bias_heads, stream);
}

// ---------------------------------------------------------------------------
// Long-sequence route ("long"): Tq, Tk <= 160, D <= 80 (TSLMA's space-time
// windows: 160 queries over 160 or 32 keys at D = 66). A batch element's
// q, k and v slices no longer fit a block's shared memory (3 x 160 x 1,056 B
// in the layer's layout), so a block takes one head of one element: its k
// and v rows (and in the backward its q and g rows) are staged row by row
// into shared memory with a padded row stride (4-byte loads: a head's row
// in the layer's layout starts on a 4-byte, not a 16-byte, boundary), and
// the q rows of the forward are read straight into the A fragments.

constexpr int kLongTokens = 160;
constexpr int kLongDepth = 80;
constexpr int kLongKd = (kLongDepth + 15) / 16;  // 16-wide steps over the head width
constexpr int kLongNd = (kLongDepth + 7) / 8;    // 8-wide column tiles of the head width
constexpr int kLongWarps = 5;                    // forward: a 16-row query strip a warp
constexpr int kLongRows = 16 * kLongWarps;       // forward: query rows a block (160 = 2 x 80)
constexpr int kLongBwdWarps = 10;                // backward: a 16-row strip a warp at 160 tokens
constexpr int kLongFmaRows = 32;                 // f32 forward: query rows a block

// Everything a launch of the long route takes. q, k, v and g each in layout
// 0 or 1 of Slice; out (forward) in q's layout, dq in q's, dk in k's, dv
// in v's; element (e, h, r, d) of an operand lies at e H T D + h head + r row + d.
struct LongArgs {
  const void *q, *k, *v, *g;
  const float* bias;
  void *out, *dq, *dk, *dv;
  float* dl;                      // (B, H, Tq, Tk) f32 logit gradients, or null
  int batch, heads, tq, tk, depth, bias_heads;
  Slice qs, ks, vs, gs;
  float scale, dscale;
  vptr_dropout::Params drop;
};

// Whether the long route takes the shape (either dtype; both routes of it
// fit a block's shared memory at the limits: ops/attention_core.py says
// the same).
bool long_takes(int tq, int tk, int depth) {
  return tq <= kLongTokens && tk <= kLongTokens && depth <= kLongDepth;
}

// Shared-memory row stride (bf16 elements) of the staged rows: an even
// number of 4-byte words that is 4 mod 8, so that the eight rows g = lane / 4
// of a fragment load, each read at word t = lane % 4, fall in 32 different
// banks.
inline __host__ __device__ int long_stride(int depth) {
  int words = ((depth + 1) / 2 + 3) & ~3;
  if (words % 8 == 0) words += 4;
  return 2 * words;
}

// One 4-byte asynchronous copy from device into shared memory; the block's
// copies complete at cp_async4_wait.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// rows x hd bf16 elements of one head (src: its row 0, row pitch sr) into
// dst with row stride st, a warp a row: 4-byte asynchronous copies where hd
// is even (all in flight at once; the caller waits with cp_async4_wait),
// element loads otherwise.
template <bool PAIRS>
__device__ __forceinline__ void stage_head(bf16* dst, int st, const bf16* src, long sr,
                                           int rows, int hd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    if constexpr (PAIRS) {
      for (int w = lane; 2 * w < hd; w += 32) cp_async4(dst + r * st + 2 * w, src + r * sr + 2 * w);
    } else {
      for (int d = lane; d < hd; d += 32) dst[r * st + d] = src[r * sr + d];
    }
  }
}

// The staged q rows times the scale in bf16, in place (as the plain
// version's q * scale), once they have landed.
template <bool PAIRS>
__device__ __forceinline__ void scale_rows(bf16* x, int st, int rows, int hd,
                                           __nv_bfloat162 scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    if constexpr (PAIRS) {
      for (int w = lane; 2 * w < hd; w += 32) {
        uint32_t* p = reinterpret_cast<uint32_t*>(x + r * st + 2 * w);
        *p = scaled_pair(*p, scale);
      }
    } else {
      for (int d = lane; d < hd; d += 32) x[r * st + d] = __hmul(x[r * st + d], scale.x);
    }
  }
}

// The A fragments of a 16-row strip (x: its row 0, row stride xr, rows_x rows
// there) over the whole head width, one 16-wide step each: as row_products
// forms them, zero past hd.
template <bool PAIRS>
__device__ __forceinline__ void strip_frags(uint32_t (&a)[kLongKd][4], const bf16* x, int xr,
                                            int rows_x, int hd, int g, int t) {
#pragma unroll
  for (int kd = 0; kd < kLongKd; ++kd) {
    const int k0 = 16 * kd;
    a[kd][0] = load_pair<PAIRS>(x + g * xr, k0 + 2 * t, hd, g < rows_x);
    a[kd][1] = load_pair<PAIRS>(x + (g + 8) * xr, k0 + 2 * t, hd, g + 8 < rows_x);
    a[kd][2] = load_pair<PAIRS>(x + g * xr, k0 + 2 * t + 8, hd, g < rows_x);
    a[kd][3] = load_pair<PAIRS>(x + (g + 8) * xr, k0 + 2 * t + 8, hd, g + 8 < rows_x);
  }
}

// One 16 x 8 tile of a x^T y^T-style product: acc = A (the strip's fragments)
// times rows j0 + g of y (those below rows_y) over the head width.
template <bool PAIRS>
__device__ __forceinline__ void strip_tile(float (&acc)[4], const uint32_t (&a)[kLongKd][4],
                                           const bf16* y, int yr, int j0, int rows_y, int hd,
                                           int g, int t) {
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = 0.f;
  const int j = j0 + g;
#pragma unroll
  for (int kd = 0; kd < kLongKd; ++kd) {
    if (16 * kd >= hd) break;                    // warp-uniform
    const uint32_t b0 = load_pair<PAIRS>(y + j * yr, 16 * kd + 2 * t, hd, j < rows_y);
    const uint32_t b1 = load_pair<PAIRS>(y + j * yr, 16 * kd + 2 * t + 8, hd, j < rows_y);
    mma_16816(acc, a[kd], b0, b1);
  }
}

// Rows 16 mt + g (+ 8) of a 16-row strip of the output, two f32 sums a lane
// for columns c, c + 1, stored as bf16 at dst (row stride dr) where the row
// is below rows and the column below hd.
template <bool PAIRS>
__device__ __forceinline__ void store_pair(bf16* dst, long dr, int i, int rows, int c, int hd,
                                           float v0, float v1) {
  if (i >= rows) return;
  bf16* const p = dst + i * dr + c;
  if constexpr (PAIRS) {
    if (c < hd) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < hd) p[0] = __float2bfloat16_rn(v0);
    if (c + 1 < hd) p[1] = __float2bfloat16_rn(v1);
  }
}

// o[n] (head columns 8 n + 2t (+ 1), the strip's rows g (+ 8)) = the sum over
// 16-row steps kk of A[kk] (plus the low term al[kk] with LO) times rows
// 16 kk .. + 15 of y (those below rows_y): every column tile accumulates at
// once, so the products of one step are independent; the B operands come
// from 4-byte pairs along y's rows, transposed by movmatrix.
template <int KS, bool PAIRS, bool LO>
__device__ __forceinline__ void strip_times_rows(float (&o)[kLongNd][4],
                                                 const uint32_t (&ah)[KS][4],
                                                 const uint32_t (&al)[KS][4], const bf16* y,
                                                 int yr, int rows_y, int hd, int g, int t) {
#pragma unroll
  for (int n = 0; n < kLongNd; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (16 * kk >= rows_y) break;                // warp-uniform
#pragma unroll
    for (int n = 0; n < kLongNd; ++n) {
      if (8 * n >= hd) break;                    // warp-uniform
      uint32_t b[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 16 * kk + 8 * half + g;    // row g of the block, before its transpose
        b[half] = transpose_8x8(load_pair<PAIRS>(y + j * yr, 8 * n + 2 * t, hd, j < rows_y));
      }
      mma_16816(o[n], ah[kk], b[0], b[1]);
      if constexpr (LO) mma_16816(o[n], al[kk], b[0], b[1]);
    }
  }
}

// The strip's output rows g (+ 8), o[n] as strip_times_rows leaves it,
// times factor, stored as bf16 at dst (row stride dr) below rows.
template <bool PAIRS>
__device__ __forceinline__ void store_strip(bf16* dst, long dr, int rows, int hd,
                                            const float (&o)[kLongNd][4], float factor,
                                            int g, int t) {
#pragma unroll
  for (int n = 0; n < kLongNd; ++n) {
    if (8 * n >= hd) break;
    store_pair<PAIRS>(dst, dr, g, rows, 8 * n + 2 * t, hd, o[n][0] * factor, o[n][1] * factor);
    store_pair<PAIRS>(dst, dr, g + 8, rows, 8 * n + 2 * t, hd, o[n][2] * factor,
                      o[n][3] * factor);
  }
}

// Forward, bf16: a block takes (batch element e, head h, 80 query rows), its
// grid (element x query tile, head). The head's k and v rows and the tile's
// q rows are staged (4-byte asynchronous copies); warp w takes query rows
// 16 w .. + 15 of the tile: S = (q scale) k^T on mma.sync (row_products, q
// scaled as its A fragments are formed), the bias, the f32 softmax on the
// quads (__expf, one reciprocal a row, as the mma route), the hash dropout,
// the weights rounded into P's A fragments, P v on mma.sync with every
// column tile at once (strip_times_rows), the output stored in q's layout.
// KS: 16-key steps (Tk <= 16 KS); the logits of a strip are 2 KS tiles of
// 16 x 8 in registers.
template <int KS, bool PAIRS>
__global__ void __launch_bounds__(kLongWarps * 32)
attention_core_long_kernel(const LongArgs a) {
  constexpr int NT = 2 * KS;
  extern __shared__ __align__(16) unsigned char smem_long[];
  const int tq = a.tq, tk = a.tk, hd = a.depth, st = long_stride(hd);
  const int tiles = (tq + kLongRows - 1) / kLongRows;
  const long e = blockIdx.x / tiles;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = static_cast<int>(blockIdx.x % tiles) * kLongRows, r0 = q0 + 16 * warp;
  const uint32_t seed = a.drop.active() ? a.drop.seed_u32() : 0u;
  const __nv_bfloat162 scale = __float2bfloat162_rn(a.scale);  // exact: a bf16 value
  const long qn = static_cast<long>(a.heads) * tq * hd, kn = static_cast<long>(a.heads) * tk * hd;
  const int qr = a.qs.row;
  bf16* const oh = static_cast<bf16*>(a.out) + e * qn + h * a.qs.head;
  bf16* const ks = reinterpret_cast<bf16*>(smem_long);          // [tk][st]
  bf16* const vs = ks + tk * st;                                 // [tk][st]
  bf16* const qsm = vs + tk * st;                                // [64][st] the tile's q
  stage_head<PAIRS>(ks, st, static_cast<const bf16*>(a.k) + e * kn + h * a.ks.head, a.ks.row,
                    tk, hd);
  stage_head<PAIRS>(vs, st, static_cast<const bf16*>(a.v) + e * kn + h * a.vs.head, a.vs.row,
                    tk, hd);
  stage_head<PAIRS>(qsm, st, static_cast<const bf16*>(a.q) + e * qn + h * a.qs.head +
                                 static_cast<long>(q0) * qr,
                    qr, min(kLongRows, tq - q0), hd);
  cp_async4_wait();
  __syncthreads();
  if (r0 >= tq) return;                          // warp-uniform; no barrier follows
  const int rows = tq - r0;

  float sc[1][NT][4];
  row_products<1, NT, PAIRS, true>(sc, qsm + (r0 - q0) * st, st, rows, ks, st, tk, hd, g, t,
                                   scale);
  const float* bias_h =
      a.bias ? a.bias + static_cast<long>(a.bias_heads == 1 ? 0 : h) * tq * tk : nullptr;
  uint32_t p[KS][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = g + 8 * hh;                    // row of the strip
    float m = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = 8 * nt + 2 * t + x;
        float l = -INFINITY;
        if (i < rows && j < tk) {
          l = sc[0][nt][2 * hh + x];
          if (bias_h) l += __ldg(bias_h + static_cast<long>(r0 + i) * tk + j);
        }
        sc[0][nt][2 * hh + x] = l;
        m = fmaxf(m, l);
      }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = 8 * nt + 2 * t + x;
        const float y = i < rows && j < tk ? __expf(sc[0][nt][2 * hh + x] - m) : 0.f;
        sc[0][nt][2 * hh + x] = y;
        sum += y;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float rcp = 1.f / sum;
    const uint32_t row_idx = a.drop.index(
        static_cast<uint32_t>(e), a.heads, h, tq, r0 + i, tk, 0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float wv[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = 8 * nt + 2 * t + x;
        float w = 0.f;                           // rows and keys past Tq, Tk: weight 0
        if (i < rows && j < tk) {
          w = sc[0][nt][2 * hh + x] * rcp;
          if (a.drop.active()) w = a.drop.apply(w, a.drop.keep(row_idx + j, seed));
        }
        wv[x] = w;
      }
      p[nt >> 1][2 * (nt & 1) + hh] = pack_bf16(wv[0], wv[1]);
    }
  }

  // P v, stored in q's layout
  float o[kLongNd][4];
  strip_times_rows<KS, PAIRS, false>(o, p, p, vs, st, tk, hd, g, t);
  store_strip<PAIRS>(oh + static_cast<long>(r0) * qr, qr, rows, hd, o, 1.f, g, t);
}

// The f32 operands of the long route's FMA kernels: rows x hd f32 elements
// of one head (src: its row 0, row pitch sr) into dst with row stride st
// (row_stride), a warp a row, by 4-byte asynchronous copies (the caller
// waits with cp_async4_wait); zeros in the padding columns (the float4 dot
// products read them).
__device__ __forceinline__ void stage_head_f32(float* dst, int st, const float* src, long sr,
                                               int rows, int hd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps)
    for (int d = lane; d < st; d += 32) {
      if (d < hd)
        cp_async4(dst + r * st + d, src + r * sr + d);
      else
        dst[r * st + d] = 0.f;
    }
}

// The staged f32 q rows times the scale, in place, once they have landed.
__device__ __forceinline__ void scale_rows_f32(float* x, int st, int rows, int hd, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps)
    for (int d = lane; d < hd; d += 32) x[r * st + d] *= scale;
}

__device__ __forceinline__ float dot_rows(const float* a, const float* c, int stride) {
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
}

constexpr int kLongLanes = (kLongTokens + 31) / 32;   // tokens a lane (a row's keys or queries)
constexpr int kLongCols = (kLongDepth + 31) / 32;     // head columns a lane

// Forward, f32: a block takes (element, head, 32 query rows); the q rows
// (scaled), the head's k and v rows are staged as f32; a warp takes a query
// row at a time, lane l the keys l + 32 j (as the FMA route: expf, the
// division by the sum), then the weighted sum of v with lane l owning the
// columns l + 32 c, one weight shuffle a key feeding them all.
__global__ void __launch_bounds__(kLongWarps * 32)
attention_core_long_fma_kernel(const LongArgs a) {
  extern __shared__ float4 smem_long4[];
  const int tq = a.tq, tk = a.tk, hd = a.depth, st = row_stride(hd);
  const int tiles = (tq + kLongFmaRows - 1) / kLongFmaRows;
  const long e = blockIdx.x / tiles;
  const int h = blockIdx.y;
  const int q0 = static_cast<int>(blockIdx.x % tiles) * kLongFmaRows;
  const int rows = min(kLongFmaRows, tq - q0);
  const long qn = static_cast<long>(a.heads) * tq * hd, kn = static_cast<long>(a.heads) * tk * hd;
  float* const qsm = reinterpret_cast<float*>(smem_long4);     // [32][st] q * scale
  float* const ksm = qsm + kLongFmaRows * st;                   // [tk][st]
  float* const vsm = ksm + tk * st;                             // [tk][st]
  const long qoff = e * qn + h * a.qs.head + static_cast<long>(q0) * a.qs.row;
  stage_head_f32(qsm, st, static_cast<const float*>(a.q) + qoff, a.qs.row, rows, hd);
  stage_head_f32(ksm, st, static_cast<const float*>(a.k) + e * kn + h * a.ks.head, a.ks.row, tk,
                 hd);
  stage_head_f32(vsm, st, static_cast<const float*>(a.v) + e * kn + h * a.vs.head, a.vs.row, tk,
                 hd);
  cp_async4_wait();
  __syncthreads();
  scale_rows_f32(qsm, st, rows, hd, a.scale);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t seed = a.drop.active() ? a.drop.seed_u32() : 0u;
  const float* bias_h =
      a.bias ? a.bias + static_cast<long>(a.bias_heads == 1 ? 0 : h) * tq * tk : nullptr;
  float* const out = static_cast<float*>(a.out) + qoff;
  for (int r = warp; r < rows; r += kLongWarps) {
    float w[kLongLanes];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kLongLanes; ++j) {
      const int c = lane + 32 * j;
      w[j] = -INFINITY;
      if (c < tk) {
        w[j] = dot_rows(qsm + r * st, ksm + c * st, st);
        if (bias_h) w[j] += bias_h[static_cast<long>(q0 + r) * tk + c];
      }
      m = fmaxf(m, w[j]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kLongLanes; ++j) {
      w[j] = lane + 32 * j < tk ? expf(w[j] - m) : 0.f;
      sum += w[j];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int j = 0; j < kLongLanes; ++j) {
      const int c = lane + 32 * j;
      w[j] /= sum;
      if (a.drop.active() && c < tk)
        w[j] = a.drop.apply(w[j], a.drop.keep(a.drop.index(
                                                  static_cast<uint32_t>(e), a.heads, h, tq,
                                                  q0 + r, tk, c), seed));
    }
    float acc[kLongCols];
#pragma unroll
    for (int c = 0; c < kLongCols; ++c) acc[c] = 0.f;
#pragma unroll
    for (int j = 0; j < kLongLanes; ++j) {
      for (int src = 0; src < 32; ++src) {
        const int c = 32 * j + src;
        if (c >= tk) break;                      // warp-uniform
        const float wc = __shfl_sync(0xffffffffu, w[j], src);
        const float* vr = vsm + c * st;
#pragma unroll
        for (int cc = 0; cc < kLongCols; ++cc)
          if (lane + 32 * cc < hd) acc[cc] = fmaf(wc, vr[lane + 32 * cc], acc[cc]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < kLongCols; ++cc)
      if (lane + 32 * cc < hd) out[r * a.qs.row + lane + 32 * cc] = acc[cc];
  }
}

int launch_long(const LongArgs& a, int dtype, cudaStream_t stream) {
  using Kernel = void (*)(const LongArgs);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;   // no f16 long kernel
  if (dtype == 0) {
    const int tiles = (a.tq + kLongFmaRows - 1) / kLongFmaRows;
    const int smem = static_cast<int>(sizeof(float) * (kLongFmaRows + 2 * a.tk) *
                                      row_stride(a.depth));
    cudaError_t err = cudaFuncSetAttribute(attention_core_long_fma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attention_core_long_fma_kernel<<<dim3(a.batch * tiles, a.heads), kLongWarps * 32, smem,
                                     stream>>>(a);
    return cudaGetLastError();
  }
  static const Kernel kernels[2][2] = {
      {&attention_core_long_kernel<2, false>, &attention_core_long_kernel<2, true>},
      {&attention_core_long_kernel<kLongTokens / 16, false>,
       &attention_core_long_kernel<kLongTokens / 16, true>}};
  const Kernel kernel = kernels[a.tk > 32][a.depth % 2 == 0];
  const int tiles = (a.tq + kLongRows - 1) / kLongRows;
  const int smem =
      static_cast<int>(sizeof(bf16) * (2 * a.tk + kLongRows) * long_stride(a.depth));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.batch * tiles, a.heads), kLongWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// Backward, bf16: a block takes (batch element e, head h), its grid the
// element x head pairs. q (times the scale), k, v and g of the head are
// staged; then two passes over 16-row strips, ten warps each (a strip a
// warp at 160 tokens):
//  * query strips: S = (q scale) k^T on mma.sync, the softmax as the
//    forward's (its max and reciprocal sum kept for the key pass); the row
//    sums of dW_drop w with dW = g v^T formed a 16 x 8 tile at a time from
//    g's A fragments held in registers (the keep decisions kept as bits),
//    then each tile formed again for dS = w (dW_drop - sum) (into dl where
//    the bias gradient is wanted) and packed as A fragments of two bf16
//    terms; dq = dS k dscale on mma.sync with every column tile at once
//    (strip_times_rows), stored in q's layout;
//  * key strips, after a barrier: S^T = k (q scale)^T and dW^T = v g^T a 16
//    x 16 step of queries at a time from k's and v's A fragments in
//    registers, the weights from the kept statistics, w_drop^T and dS^T
//    packed from the accumulators as A fragments (no transpose), dv +=
//    w_drop^T g and dk += dS^T (q scale) over the head width (the B
//    operands from the staged rows by movmatrix), stored in v's and k's
//    layouts.
// KS: 16-key steps of a query strip (Tk <= 16 KS).
template <int KS, bool PAIRS>
__global__ void __launch_bounds__(kLongBwdWarps * 32, 1)
attention_core_long_bwd_kernel(const LongArgs a) {
  constexpr int NT = 2 * KS;
  extern __shared__ __align__(16) unsigned char smem_long_bwd[];
  const int tq = a.tq, tk = a.tk, hd = a.depth, st = long_stride(hd);
  const long e = blockIdx.x / a.heads;
  const int h = static_cast<int>(blockIdx.x % a.heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t seed = a.drop.active() ? a.drop.seed_u32() : 0u;
  const float keep_rcp = 1.f / a.drop.keep_div;
  const __nv_bfloat162 scale = __float2bfloat162_rn(a.scale);  // exact: a bf16 value
  const long qn = static_cast<long>(a.heads) * tq * hd, kn = static_cast<long>(a.heads) * tk * hd;
  bf16* const qs = reinterpret_cast<bf16*>(smem_long_bwd);     // [tq][st] q * scale
  bf16* const gs = qs + tq * st;                               // [tq][st]
  bf16* const ks = gs + tq * st;                               // [tk][st]
  bf16* const vs = ks + tk * st;                               // [tk][st]
  float* const stats = reinterpret_cast<float*>(vs + tk * st);  // [tq][3]: max, 1 / sum, sum dW w
  stage_head<PAIRS>(qs, st, static_cast<const bf16*>(a.q) + e * qn + h * a.qs.head, a.qs.row,
                    tq, hd);
  stage_head<PAIRS>(gs, st, static_cast<const bf16*>(a.g) + e * qn + h * a.gs.head, a.gs.row,
                    tq, hd);
  stage_head<PAIRS>(ks, st, static_cast<const bf16*>(a.k) + e * kn + h * a.ks.head, a.ks.row,
                    tk, hd);
  stage_head<PAIRS>(vs, st, static_cast<const bf16*>(a.v) + e * kn + h * a.vs.head, a.vs.row,
                    tk, hd);
  cp_async4_wait();
  __syncthreads();
  scale_rows<PAIRS>(qs, st, tq, hd, scale);
  __syncthreads();
  const float* bias_h =
      a.bias ? a.bias + static_cast<long>(a.bias_heads == 1 ? 0 : h) * tq * tk : nullptr;
  float* const dl_h = a.dl ? a.dl + (e * a.heads + h) * tq * tk : nullptr;

  // query strips: dq, the statistics
  for (int r0 = 16 * warp; r0 < tq; r0 += 16 * kLongBwdWarps) {
    const int rows = tq - r0;
    float sc[1][NT][4];
    row_products<1, NT, PAIRS, false>(sc, qs + r0 * st, st, rows, ks, st, tk, hd, g, t, scale);
    uint32_t ga[kLongKd][4];
    strip_frags<PAIRS>(ga, gs + r0 * st, st, rows, hd, g, t);
    float dot[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = g + 8 * hh;
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int j = 8 * nt + 2 * t + x;
          float l = -INFINITY;
          if (i < rows && j < tk) {
            l = sc[0][nt][2 * hh + x];
            if (bias_h) l += __ldg(bias_h + (r0 + i) * tk + j);
          }
          sc[0][nt][2 * hh + x] = l;
          m = fmaxf(m, l);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int j = 8 * nt + 2 * t + x;
          const float y = i < rows && j < tk ? __expf(sc[0][nt][2 * hh + x] - m) : 0.f;
          sc[0][nt][2 * hh + x] = y;
          sum += y;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float rcp = 1.f / sum;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int x = 0; x < 2; ++x)                                   // w, 0 past Tq, Tk
          sc[0][nt][2 * hh + x] = i < rows && 8 * nt + 2 * t + x < tk ? sc[0][nt][2 * hh + x] * rcp
                                                                      : 0.f;
      if (t == 0 && i < rows) {
        stats[3 * (r0 + i)] = m;
        stats[3 * (r0 + i) + 1] = rcp;
      }
      dot[hh] = 0.f;
    }
    // the row sums of dW_drop w, dW a tile at a time; the keep decisions
    // of the lane's 4 NT elements kept as bits (4 nt + 2 hh + x) for the
    // second pass
    uint32_t kept[(4 * NT + 31) / 32];
#pragma unroll
    for (int b = 0; b < (4 * NT + 31) / 32; ++b) kept[b] = 0u;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (8 * nt >= tk) break;                   // warp-uniform
      float dw[4];
      strip_tile<PAIRS>(dw, ga, vs, st, 8 * nt, tk, hd, g, t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int i = g + 8 * hh, j = 8 * nt + 2 * t + x, bit = 4 * nt + 2 * hh + x;
          float d = dw[2 * hh + x];
          if (a.drop.active()) {
            const bool k = i < rows && j < tk &&
                           a.drop.keep(a.drop.index(static_cast<uint32_t>(e),
                                                                   a.heads, h, tq, r0 + i, tk,
                                                                   j), seed);
            if (k) kept[bit >> 5] |= 1u << (bit & 31);
            d = a.drop.apply_rcp(d, k, keep_rcp);
          }
          dot[hh] += d * sc[0][nt][2 * hh + x];
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 1);
      dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 2);
      if (t == 0 && g + 8 * hh < rows) stats[3 * (r0 + g + 8 * hh) + 2] = dot[hh];
    }
    // dS a tile at a time, packed as A fragments of two bf16 terms
    uint32_t dsh[1][KS][4], dsl[1][KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) dsh[0][kk][c] = dsl[0][kk][c] = 0u;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (8 * nt >= tk) break;                   // warp-uniform
      float dw[4];
      strip_tile<PAIRS>(dw, ga, vs, st, 8 * nt, tk, hd, g, t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = g + 8 * hh;
        float ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int j = 8 * nt + 2 * t + x, bit = 4 * nt + 2 * hh + x;
          float d = dw[2 * hh + x];
          if (a.drop.active()) d = a.drop.apply_rcp(d, (kept[bit >> 5] >> (bit & 31)) & 1u, keep_rcp);
          ds[x] = sc[0][nt][2 * hh + x] * (d - dot[hh]);
          if (dl_h && i < rows && j < tk) dl_h[(r0 + i) * tk + j] = ds[x];
        }
        split_pair(ds[0], ds[1], dsh[0][nt >> 1][2 * (nt & 1) + hh],
                   dsl[0][nt >> 1][2 * (nt & 1) + hh]);
      }
    }
    float o[kLongNd][4];
    strip_times_rows<KS, PAIRS, true>(o, dsh[0], dsl[0], ks, st, tk, hd, g, t);
    store_strip<PAIRS>(static_cast<bf16*>(a.dq) + e * qn + h * a.qs.head +
                           static_cast<long>(r0) * a.qs.row,
                       a.qs.row, rows, hd, o, a.dscale, g, t);
  }
  __syncthreads();                                 // the statistics are in

  // key strips: dk, dv
  for (int c0 = 16 * warp; c0 < tk; c0 += 16 * kLongBwdWarps) {
    const int keys = tk - c0;
    uint32_t ka[kLongKd][4], va[kLongKd][4];
    strip_frags<PAIRS>(ka, ks + c0 * st, st, keys, hd, g, t);
    strip_frags<PAIRS>(va, vs + c0 * st, st, keys, hd, g, t);
    float dk[kLongNd][4], dv[kLongNd][4];
#pragma unroll
    for (int n = 0; n < kLongNd; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;
    for (int i0 = 0; i0 < tq; i0 += 16) {
      // S^T and dW^T for keys c0 + g (+ 8) and queries i0 + 8 half + 2t (+ 1);
      // packed as A fragments (rows: keys, depth: the 16 queries)
      uint32_t wdh[4], wdl[4], dsh[4], dsl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s[4], dw[4];
        strip_tile<PAIRS>(s, ka, qs, st, i0 + 8 * half, tq, hd, g, t);
        strip_tile<PAIRS>(dw, va, gs, st, i0 + 8 * half, tq, hd, g, t);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = c0 + g + 8 * hh;
          float wd[2], ds[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int i = i0 + 8 * half + 2 * t + x;
            wd[x] = ds[x] = 0.f;
            if (i < tq && j < tk) {
              float l = s[2 * hh + x];
              if (bias_h) l += __ldg(bias_h + i * tk + j);
              const float w = __expf(l - stats[3 * i]) * stats[3 * i + 1];
              float d = dw[2 * hh + x];
              wd[x] = w;
              if (a.drop.active()) {
                const bool kept = a.drop.keep(a.drop.index(
                    static_cast<uint32_t>(e), a.heads, h, tq, i, tk, j), seed);
                wd[x] = a.drop.apply_rcp(w, kept, keep_rcp);
                d = a.drop.apply_rcp(d, kept, keep_rcp);
              }
              ds[x] = w * (d - stats[3 * i + 2]);
            }
          }
          split_pair(wd[0], wd[1], wdh[2 * half + hh], wdl[2 * half + hh]);
          split_pair(ds[0], ds[1], dsh[2 * half + hh], dsl[2 * half + hh]);
        }
      }
      // dv += w_drop^T g, dk += dS^T (q scale): the 16 query rows of g and q
      // as B operands, an 8 x 8 block a lane pair at a time by movmatrix
#pragma unroll
      for (int n = 0; n < kLongNd; ++n) {
        if (8 * n >= hd) break;                  // warp-uniform
        uint32_t bg[2], bq[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + 8 * half + g;
          bg[half] = transpose_8x8(load_pair<PAIRS>(gs + i * st, 8 * n + 2 * t, hd, i < tq));
          bq[half] = transpose_8x8(load_pair<PAIRS>(qs + i * st, 8 * n + 2 * t, hd, i < tq));
        }
        mma_16816(dv[n], wdh, bg[0], bg[1]);
        mma_16816(dv[n], wdl, bg[0], bg[1]);
        mma_16816(dk[n], dsh, bq[0], bq[1]);
        mma_16816(dk[n], dsl, bq[0], bq[1]);
      }
    }
    bf16* const dkh = static_cast<bf16*>(a.dk) + e * kn + h * a.ks.head +
                      static_cast<long>(c0) * a.ks.row;
    bf16* const dvh = static_cast<bf16*>(a.dv) + e * kn + h * a.vs.head +
                      static_cast<long>(c0) * a.vs.row;
#pragma unroll
    for (int n = 0; n < kLongNd; ++n) {
      if (8 * n >= hd) break;
      const int c = 8 * n + 2 * t;
      store_pair<PAIRS>(dkh, a.ks.row, g, keys, c, hd, dk[n][0], dk[n][1]);
      store_pair<PAIRS>(dkh, a.ks.row, g + 8, keys, c, hd, dk[n][2], dk[n][3]);
      store_pair<PAIRS>(dvh, a.vs.row, g, keys, c, hd, dv[n][0], dv[n][1]);
      store_pair<PAIRS>(dvh, a.vs.row, g + 8, keys, c, hd, dv[n][2], dv[n][3]);
    }
  }
}

// Backward, f32: a block takes (element, head); q (scaled), k, v and g of
// the head staged as f32. Query rows, a warp a row at a time, lane l the keys
// l + 32 j: the softmax as the f32 forward (expf, the division), dW = g v^T,
// the mask, the row sum of dW_drop w, dS (into dl where wanted), dq = dS k
// dscale with lane l owning columns l + 32 c; the row's max, sum and row sum
// kept. After a barrier, key rows, a warp a key at a time, lane l the
// queries l + 32 j: the weights again from the kept statistics (the same
// dot products in the same order, so the same values), dS and w_drop, then
// dk = dS^T (q scale) and dv = w_drop^T g.
__global__ void __launch_bounds__(kLongBwdWarps * 32, 1)
attention_core_long_bwd_fma_kernel(const LongArgs a) {
  extern __shared__ float4 smem_long_bwd4[];
  const int tq = a.tq, tk = a.tk, hd = a.depth, st = row_stride(hd);
  const long e = blockIdx.x / a.heads;
  const int h = static_cast<int>(blockIdx.x % a.heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t seed = a.drop.active() ? a.drop.seed_u32() : 0u;
  const long qn = static_cast<long>(a.heads) * tq * hd, kn = static_cast<long>(a.heads) * tk * hd;
  const long qoff = e * qn + h * a.qs.head, goff = e * qn + h * a.gs.head;
  const long koff = e * kn + h * a.ks.head, voff = e * kn + h * a.vs.head;
  float* const qsm = reinterpret_cast<float*>(smem_long_bwd4);  // [tq][st] q * scale
  float* const gsm = qsm + tq * st;                             // [tq][st]
  float* const ksm = gsm + tq * st;                             // [tk][st]
  float* const vsm = ksm + tk * st;                             // [tk][st]
  float* const stats = vsm + tk * st;                           // [tq][3]: max, sum, sum dW w
  stage_head_f32(qsm, st, static_cast<const float*>(a.q) + qoff, a.qs.row, tq, hd);
  stage_head_f32(gsm, st, static_cast<const float*>(a.g) + goff, a.gs.row, tq, hd);
  stage_head_f32(ksm, st, static_cast<const float*>(a.k) + koff, a.ks.row, tk, hd);
  stage_head_f32(vsm, st, static_cast<const float*>(a.v) + voff, a.vs.row, tk, hd);
  cp_async4_wait();
  __syncthreads();
  scale_rows_f32(qsm, st, tq, hd, a.scale);
  __syncthreads();
  const float* bias_h =
      a.bias ? a.bias + static_cast<long>(a.bias_heads == 1 ? 0 : h) * tq * tk : nullptr;
  float* const dl_h = a.dl ? a.dl + (e * a.heads + h) * tq * tk : nullptr;
  auto kept = [&](int i, int j) {
    return a.drop.keep(a.drop.index(static_cast<uint32_t>(e), a.heads, h, tq, i,
                                                   tk, j), seed);
  };
  // out[c] = sum over the tokens u of coef(u) rows[u][lane + 32 c]
  auto weighted_rows = [&](const float (&coef)[kLongLanes], int tokens, const float* rows,
                           float (&out)[kLongCols]) {
#pragma unroll
    for (int c = 0; c < kLongCols; ++c) out[c] = 0.f;
#pragma unroll
    for (int j = 0; j < kLongLanes; ++j)
      for (int src = 0; src < 32; ++src) {
        const int u = 32 * j + src;
        if (u >= tokens) break;                  // warp-uniform
        const float w = __shfl_sync(0xffffffffu, coef[j], src);
#pragma unroll
        for (int c = 0; c < kLongCols; ++c)
          if (lane + 32 * c < hd) out[c] = fmaf(w, rows[u * st + lane + 32 * c], out[c]);
      }
  };

  for (int r = warp; r < tq; r += kLongBwdWarps) {
    float w[kLongLanes], dw[kLongLanes];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kLongLanes; ++j) {
      const int c = lane + 32 * j;
      w[j] = -INFINITY;
      if (c < tk) {
        w[j] = dot_rows(qsm + r * st, ksm + c * st, st);
        if (bias_h) w[j] += bias_h[r * tk + c];
      }
      m = fmaxf(m, w[j]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kLongLanes; ++j) {
      w[j] = lane + 32 * j < tk ? expf(w[j] - m) : 0.f;
      sum += w[j];
    }
    sum = warp_sum(sum);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kLongLanes; ++j) {
      const int c = lane + 32 * j;
      w[j] /= sum;
      dw[j] = 0.f;
      if (c < tk) {
        dw[j] = dot_rows(gsm + r * st, vsm + c * st, st);
        if (a.drop.active()) dw[j] = a.drop.apply(dw[j], kept(r, c));
      }
      dot += dw[j] * w[j];
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int j = 0; j < kLongLanes; ++j) {
      const int c = lane + 32 * j;
      dw[j] = w[j] * (dw[j] - dot);              // dS
      if (dl_h && c < tk) dl_h[r * tk + c] = dw[j];
    }
    if (lane == 0) {
      stats[3 * r] = m;
      stats[3 * r + 1] = sum;
      stats[3 * r + 2] = dot;
    }
    float acc[kLongCols];
    weighted_rows(dw, tk, ksm, acc);
    float* const dq = static_cast<float*>(a.dq) + qoff + static_cast<long>(r) * a.qs.row;
#pragma unroll
    for (int c = 0; c < kLongCols; ++c)
      if (lane + 32 * c < hd) dq[lane + 32 * c] = acc[c] * a.dscale;
  }
  __syncthreads();                                 // the statistics are in

  for (int c = warp; c < tk; c += kLongBwdWarps) {
    float wd[kLongLanes], ds[kLongLanes];
#pragma unroll
    for (int j = 0; j < kLongLanes; ++j) {
      const int i = lane + 32 * j;
      wd[j] = ds[j] = 0.f;
      if (i < tq) {
        float l = dot_rows(qsm + i * st, ksm + c * st, st);
        if (bias_h) l += bias_h[i * tk + c];
        const float w = expf(l - stats[3 * i]) / stats[3 * i + 1];
        float d = dot_rows(gsm + i * st, vsm + c * st, st);
        wd[j] = w;
        if (a.drop.active()) {
          const bool k_ = kept(i, c);
          wd[j] = a.drop.apply(w, k_);
          d = a.drop.apply(d, k_);
        }
        ds[j] = w * (d - stats[3 * i + 2]);
      }
    }
    float dk[kLongCols], dv[kLongCols];
    weighted_rows(ds, tq, qsm, dk);
    weighted_rows(wd, tq, gsm, dv);
    float* const dkr = static_cast<float*>(a.dk) + koff + static_cast<long>(c) * a.ks.row;
    float* const dvr = static_cast<float*>(a.dv) + voff + static_cast<long>(c) * a.vs.row;
#pragma unroll
    for (int cc = 0; cc < kLongCols; ++cc)
      if (lane + 32 * cc < hd) {
        dkr[lane + 32 * cc] = dk[cc];
        dvr[lane + 32 * cc] = dv[cc];
      }
  }
}

// Dynamic shared memory of the long backward: q, g, k, v of a head and the
// statistics (ops/attention_core.py's limits keep it within a block's).
inline long long_bwd_bytes(int tq, int tk, int depth, int dtype) {
  const long rows = 2L * (tq + tk);
  return (dtype == 1 ? rows * long_stride(depth) * 2 : rows * row_stride(depth) * 4) +
         12L * tq;
}

int launch_long_bwd(const LongArgs& a, int dtype, void* dbias, cudaStream_t stream) {
  using Kernel = void (*)(const LongArgs);
  static const Kernel kernels[2][2] = {
      {&attention_core_long_bwd_kernel<2, false>, &attention_core_long_bwd_kernel<2, true>},
      {&attention_core_long_bwd_kernel<kLongTokens / 16, false>,
       &attention_core_long_bwd_kernel<kLongTokens / 16, true>}};
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;   // no f16 long kernel
  const Kernel kernel =
      dtype == 0 ? &attention_core_long_bwd_fma_kernel : kernels[a.tk > 32][a.depth % 2 == 0];
  const int smem = static_cast<int>(long_bwd_bytes(a.tq, a.tk, a.depth, dtype));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.batch * a.heads, kLongBwdWarps * 32, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !a.dl) return err;
  return launch_bias_grad(a.dl, dbias, a.batch, a.heads, a.tq, a.tk, a.bias_heads, stream);
}

// Whether the short routes (FMA, mma) take the token counts and the width.
bool short_takes(int tq, int tk, int depth) {
  return tq <= kMaxTokens && tk <= kMaxTokens && depth <= kMaxDepth;
}

// A shape or argument no route takes; route: 0 FMA, 1 mma, 2 long; dtype 0
// f32, 1 bf16, 2 f16 (the FMA route only: the mma and long routes have no
// f16 kernel). Each of q, k, v (and g) in layout 0 or 1; layout 1 on the mma
// and long routes only.
bool bad_shape(int batch, int heads, int tq, int tk, int depth, const void* bias,
               int bias_heads, int dtype, const void* seed, float rate, int route,
               const int* layouts, int n_layouts) {
  if (route < 0 || route > 2) return true;
  for (int i = 0; i < n_layouts; ++i)
    if (layouts[i] != 0 && (layouts[i] != 1 || route == 0)) return true;
  return batch < 1 || heads < 1 || tq < 1 || tk < 1 || depth < 1 ||
         !(route == 2 ? long_takes(tq, tk, depth) : short_takes(tq, tk, depth)) ||
         (bias && bias_heads != 1 && bias_heads != heads) || dtype < 0 || dtype > 2 ||
         (dtype == 2 && route != 0) ||
         (rate > 0.f && !seed) || rate >= 1.f;
}

// A head subset no mask index takes: heads h0 .. h0 + heads - 1 of
// mask_heads (0, 0: the call's own heads).
bool bad_heads(int heads, int mask_heads, int head0) {
  if (mask_heads == 0) return head0 != 0;
  return head0 < 0 || head0 + heads > mask_heads;
}

}  // namespace

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (route 0 only). seed:
// device int32 (may be null when rate == 0); keep_div = (float)(1 - rate).
// route: 0 = the FMA kernel (q, k, v and out contiguous), 1 = the mma
// kernel (bf16; each of q, k, v in layout 0 or 1 of Slice, out in q's), 2
// = the long route (Tq, Tk <= 160, D <= 80; bf16 on mma.sync, f32 on the
// FMA units; layouts as route 1).
// mask_heads, head0: a call over heads h0 .. h0 + heads - 1 of mask_heads
// (tensor parallelism) draws their dropout by the global head; 0, 0 for
// the call's own heads. Returns a cudaError_t (0 = launched); a route that
// does not take the shape is cudaErrorInvalidValue.
int vptr_attention_core(const void* q, const void* k, const void* v, const void* bias,
                        void* out, int batch, int heads, int tq, int tk, int depth,
                        int bias_heads, float scale, const void* seed, float rate,
                        float keep_div, int dtype, int route, int q_layout, int k_layout,
                        int v_layout, int mask_heads, int head0, void* stream) {
  const int layouts[3] = {q_layout, k_layout, v_layout};
  if (bad_shape(batch, heads, tq, tk, depth, bias, bias_heads, dtype, seed, rate, route,
                layouts, 3) ||
      bad_heads(heads, mask_heads, head0))
    return cudaErrorInvalidValue;
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div, mask_heads,
                                  head0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    const LongArgs a{q, k, v, nullptr, static_cast<const float*>(bias), out, nullptr, nullptr,
                     nullptr, nullptr, batch, heads, tq, tk, depth, bias_heads,
                     slice_of(q_layout, heads, tq, depth), slice_of(k_layout, heads, tk, depth),
                     slice_of(v_layout, heads, tk, depth), Slice{0, 0}, scale, 0.f, drop};
    return launch_long(a, dtype, s);
  }
  if (route == 1) {
    if (!mma_takes(heads, tq, tk, depth, dtype)) return cudaErrorInvalidValue;
    const MmaArgs a{static_cast<const __nv_bfloat16*>(q),
                    static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v),
                    static_cast<const float*>(bias),
                    static_cast<__nv_bfloat16*>(out),
                    batch, heads, tq, tk, depth, bias_heads,
                    slice_of(q_layout, heads, tq, depth),
                    slice_of(k_layout, heads, tk, depth),
                    slice_of(v_layout, heads, tk, depth),
                    scale, drop};
    return launch_mma(a, s);
  }
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, bias, out, batch, heads, tq, tk, depth, bias_heads,
                           scale, drop, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, bias, out, batch, heads, tq, tk, depth,
                                   bias_heads, scale, drop, s);
    case 2:
      return launch<__half>(q, k, v, bias, out, batch, heads, tq, tk, depth, bias_heads,
                            scale, drop, s);
  }
  return cudaErrorInvalidValue;
}

// Backward: dq, dk, dv (T) and, when dl and dbias are given (dl: a
// (B, H, Tq, Tk) f32 scratch, dbias: (bias_heads, Tq, Tk) f32), the bias
// gradient. scale multiplies q (in T), dscale the dq sums (f32). route: 0 =
// the FMA kernel (every operand contiguous), 1 = the mma kernel (bf16; each
// of q, k, v, g in layout 0 or 1 of Slice; dq in q's layout, dk in k's, dv
// in v's), 2 = the long route (layouts as route 1). mask_heads, head0 as
// the forward's. A route that does not take the shape is
// cudaErrorInvalidValue.
int vptr_attention_core_bwd(const void* q, const void* k, const void* v, const void* bias,
                            const void* g, void* dq, void* dk, void* dv, void* dl,
                            void* dbias, int batch, int heads, int tq, int tk, int depth,
                            int bias_heads, float scale, float dscale, const void* seed,
                            float rate, float keep_div, int dtype, int route, int q_layout,
                            int k_layout, int v_layout, int g_layout, int mask_heads, int head0,
                            void* stream) {
  const int layouts[4] = {q_layout, k_layout, v_layout, g_layout};
  if (bad_shape(batch, heads, tq, tk, depth, bias, bias_heads, dtype, seed, rate, route,
                layouts, 4) ||
      bad_heads(heads, mask_heads, head0) || (dl && (!bias || !dbias)))
    return cudaErrorInvalidValue;
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div, mask_heads,
                                  head0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    const LongArgs a{q, k, v, g, static_cast<const float*>(bias), nullptr, dq, dk, dv,
                     static_cast<float*>(dl), batch, heads, tq, tk, depth, bias_heads,
                     slice_of(q_layout, heads, tq, depth), slice_of(k_layout, heads, tk, depth),
                     slice_of(v_layout, heads, tk, depth), slice_of(g_layout, heads, tq, depth),
                     scale, dscale, drop};
    return launch_long_bwd(a, dtype, dbias, s);
  }
  if (route == 1) {
    if (!mma_bwd_takes(heads, tq, tk, depth, dtype)) return cudaErrorInvalidValue;
    const MmaBwdArgs a{static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(k),
                       static_cast<const __nv_bfloat16*>(v),
                       static_cast<const __nv_bfloat16*>(g),
                       static_cast<const float*>(bias),
                       static_cast<__nv_bfloat16*>(dq),
                       static_cast<__nv_bfloat16*>(dk),
                       static_cast<__nv_bfloat16*>(dv),
                       static_cast<float*>(dl),
                       batch, heads, tq, tk, depth, bias_heads,
                       slice_of(q_layout, heads, tq, depth),
                       slice_of(k_layout, heads, tk, depth),
                       slice_of(v_layout, heads, tk, depth),
                       slice_of(g_layout, heads, tq, depth),
                       scale, dscale, drop};
    return launch_bwd_mma(a, dbias, s);
  }
  switch (dtype) {
    case 0:
      return launch_bwd<float>(q, k, v, bias, g, dq, dk, dv, dl, dbias, batch, heads, tq,
                               tk, depth, bias_heads, scale, dscale, drop, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(q, k, v, bias, g, dq, dk, dv, dl, dbias, batch,
                                       heads, tq, tk, depth, bias_heads, scale, dscale, drop,
                                       s);
    case 2:
      return launch_bwd<__half>(q, k, v, bias, g, dq, dk, dv, dl, dbias, batch, heads, tq,
                                tk, depth, bias_heads, scale, dscale, drop, s);
  }
  return cudaErrorInvalidValue;
}

// The backward route the library takes for the shape: 1 = mma, 0 = FMA,
// 2 = long, -1 = none (f16 past 32 tokens too; what
// ops/attention_core.py::backward_route names, for the tests).
int vptr_attention_core_bwd_route(int heads, int tq, int tk, int depth, int dtype) {
  if (short_takes(tq, tk, depth)) return mma_bwd_takes(heads, tq, tk, depth, dtype) ? 1 : 0;
  return long_takes(tq, tk, depth) && dtype != 2 ? 2 : -1;
}

}  // extern "C"
