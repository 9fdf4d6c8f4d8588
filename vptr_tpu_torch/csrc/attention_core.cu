// Attention core for short sequences on Hopper (sm_90a):
//     out = softmax(q k^T * D^-1/2 + bias) v          (softmax in f32)
// q: (B, H, Tq, D), k/v: (B, H, Tk, D), bias: none, (1, Tq, Tk) or
// (H, Tq, Tk) f32, out: (B, H, Tq, D); T = float or bf16.
//
// Replaces the TPU kernel vptr_tpu/ops/attention_core.py::_core_forward
// (_kernel, pl.pallas_call at :188), forward only, without dropout.
//
// What bounds it on an H100: bytes. Per (b, h) it reads (Tq + 2 Tk) D and
// writes Tq D elements and does about 4 Tq Tk D flops, far below the ~295
// flops per byte at which the tensor cores would become the limit. The
// design keeps logits and weights out of device memory: one block per
// (b, h) stages q, k and v in shared memory (read as 16-byte vectors where
// the (b, h) slice allows it), one warp per query row holds one key column
// per lane (Tk <= 32) and reads the q and k rows as float4 (row stride
// padded so those reads are free of bank conflicts), takes the row max and
// sum with shuffles, and accumulates the weighted values with each lane
// owning up to four columns of D, one weight shuffle per key feeding them
// all. Only q, k, v and out touch device memory.
//
// Rounding points follow the plain version in attention_core.py: q * scale
// is rounded to T, logits and softmax are f32, the weights are rounded to T
// before the value product, which accumulates in f32 and is rounded to T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
                      int bias_heads, float scale) {
  extern __shared__ float4 smem4[];
  const int stride = row_stride(depth);
  float* qs = reinterpret_cast<float*>(smem4);  // [tq][stride] q * scale, rounded to T
  float* ks = qs + tq * stride;                  // [tk][stride]
  float* vs = ks + tk * stride;                  // [tk][stride]

  const long bh = blockIdx.x;          // b * heads + h
  const int h = static_cast<int>(bh % heads);
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
        const float4 b = *reinterpret_cast<const float4*>(kr + d);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
      logit = bias_h ? acc + bias_h[r * tk + lane] : acc;
    }
    const float m = warp_max(logit);
    const float e = lane < tk ? expf(logit - m) : 0.f;
    const float w = round_t<T>(e / warp_sum(e));
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out,
           int batch, int heads, int tq, int tk, int depth, int bias_heads,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (tq + 2 * tk) * row_stride(depth);
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_core_kernel<T><<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), heads, tq, tk, depth,
      bias_heads, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int vptr_attention_core(const void* q, const void* k, const void* v, const void* bias,
                        void* out, int batch, int heads, int tq, int tk, int depth,
                        int bias_heads, float scale, int dtype, void* stream) {
  if (batch < 1 || heads < 1 || tq < 1 || tq > kMaxTokens || tk < 1 ||
      tk > kMaxTokens || depth < 1 || depth > kMaxDepth ||
      (bias && bias_heads != 1 && bias_heads != heads) || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, out, batch, heads, tq, tk, depth, bias_heads,
                         scale, s);
  return launch<__nv_bfloat16>(q, k, v, bias, out, batch, heads, tq, tk, depth,
                               bias_heads, scale, s);
}

}  // extern "C"
