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
// * FMA (f32, and bf16 shapes mma does not take; contiguous operands):
//   attention_core_kernel, one block per (b, h) staging its rows in shared
//   memory as f32 (read as 16-byte vectors where the (b, h) slice allows
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
// * FMA (f32, and bf16 shapes mma does not take; contiguous operands):
//   attention_core_bwd_kernel keeps the dropped weights and the logit
//   gradients (Tq x Tk f32) in shared memory, then forms dq, dk and dv one
//   output element per thread.
//
// The bias gradient sums over the batch: each (b, h) writes its Tq x Tk
// logit gradients and a second kernel sums them over b (and over heads
// for a (1, Tq, Tk) bias) in a fixed order, so the result is the same on
// every run (no float atomics).
//
// Rounding points follow the plain versions in attention_core.py: q * scale
// (the scale in T) is rounded to T, logits, softmax and dropout are f32,
// the forward rounds the weights to T before the value product, which
// accumulates in f32 and is rounded to T; the backward works in f32 on the
// unrounded weights and rounds dq, dk, dv to T (its mma route: the
// products of the f32 dS and w_drop as two bf16 terms each, f32 sums).

#include <cuda_bf16.h>
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
          const uint32_t row_idx = vptr_dropout::element_index(
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
        const uint32_t row_idx = vptr_dropout::element_index(
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
// rate == 0); keep_div = (float)(1 - rate). route: 0 = the FMA kernel (q,
// k, v and out contiguous), 1 = the mma kernel (bf16; each of q, k, v in
// layout 0 or 1 of Slice, out in q's). Returns a cudaError_t (0 =
// launched); a route that does not take the shape is cudaErrorInvalidValue.
int vptr_attention_core(const void* q, const void* k, const void* v, const void* bias,
                        void* out, int batch, int heads, int tq, int tk, int depth,
                        int bias_heads, float scale, const void* seed, float rate,
                        float keep_div, int dtype, int route, int q_layout, int k_layout,
                        int v_layout, void* stream) {
  if (bad_shape(batch, heads, tq, tk, depth, bias, bias_heads, dtype, seed, rate))
    return cudaErrorInvalidValue;
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int layouts[3] = {q_layout, k_layout, v_layout};
  for (int l : layouts)
    if (l != 0 && (l != 1 || route != 1)) return cudaErrorInvalidValue;
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
  if (route != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, bias, out, batch, heads, tq, tk, depth, bias_heads,
                         scale, drop, s);
  return launch<__nv_bfloat16>(q, k, v, bias, out, batch, heads, tq, tk, depth,
                               bias_heads, scale, drop, s);
}

// Backward: dq, dk, dv (T) and, when dl and dbias are given (dl: a
// (B, H, Tq, Tk) f32 scratch, dbias: (bias_heads, Tq, Tk) f32), the bias
// gradient. scale multiplies q (in T), dscale the dq sums (f32). route: 0 =
// the FMA kernel (every operand contiguous), 1 = the mma kernel (bf16; each
// of q, k, v, g in layout 0 or 1 of Slice; dq in q's layout, dk in k's, dv
// in v's). A route that does not take the shape is cudaErrorInvalidValue.
int vptr_attention_core_bwd(const void* q, const void* k, const void* v, const void* bias,
                            const void* g, void* dq, void* dk, void* dv, void* dl,
                            void* dbias, int batch, int heads, int tq, int tk, int depth,
                            int bias_heads, float scale, float dscale, const void* seed,
                            float rate, float keep_div, int dtype, int route, int q_layout,
                            int k_layout, int v_layout, int g_layout, void* stream) {
  if (bad_shape(batch, heads, tq, tk, depth, bias, bias_heads, dtype, seed, rate) ||
      (dl && (!bias || !dbias)))
    return cudaErrorInvalidValue;
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int layouts[4] = {q_layout, k_layout, v_layout, g_layout};
  for (int l : layouts)
    if (l != 0 && (l != 1 || route != 1)) return cudaErrorInvalidValue;
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
  if (route != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, bias, g, dq, dk, dv, dl, dbias, batch, heads, tq,
                             tk, depth, bias_heads, scale, dscale, drop, s);
  return launch_bwd<__nv_bfloat16>(q, k, v, bias, g, dq, dk, dv, dl, dbias, batch, heads,
                                   tq, tk, depth, bias_heads, scale, dscale, drop, s);
}

// The backward route the library takes for the shape: 1 = mma, 0 = FMA
// (what ops/attention_core.py::backward_route names, for the tests).
int vptr_attention_core_bwd_route(int heads, int tq, int tk, int depth, int dtype) {
  return mma_bwd_takes(heads, tq, tk, depth, dtype) ? 1 : 0;
}

}  // extern "C"
