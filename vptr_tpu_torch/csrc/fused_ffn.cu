// Fused LayerNorm + linear feed-forward sublayer forward on Hopper (sm_90a),
// over S rows of C channels with a hidden width H:
//     xn = LN(x) * ls + lb                   (f32 statistics, rounded to T)
//     h  = gelu(xn w1 + b1)                  (f32 sums; A&S erf, gelu_as.cuh)
//     hd = dropout(h)                        (hash of row * H + col)
//     y  = T(hd) w2 + b2                     (f32 sums, rounded to T once)
// x, w1 (C, H), w2 (H, C) in T (float or bf16); b1, b2, ls, lb f32.
//
// Replaces the TPU kernel vptr_tpu/ops/fused_ffn.py::_forward (_fwd_kernel
// at :77, pl.pallas_call at :188). The backward is fused_ffn_bwd.cu.
//
// What bounds it on an H100: operations. The two products are 4 S C H
// flops (57.1 GFLOP at S = 12,800, C = 528, H = 2112: 0.058 ms at 989
// TFLOP/s in bf16) against ~31.5 MB that the function must move (0.0094
// ms). The hidden never reaches device memory: a 64-row tile's hidden is
// 270 KB in bf16, more than a block's 227 KB of shared memory, so the
// kernel walks the hidden in chunks of 192 columns and keeps the fc2 sums
// in registers across the chunks.
//
// * Tensor-core route (bf16, C and H multiples of 16, C <= 576 -- the
//   far_mnist path): one block of 12 warps takes 64 rows. The LayerNorm
//   writes the tile's xn (bf16) into shared memory. Then, per hidden chunk
//   of 12 16-column tiles: each warp computes one column tile of
//   xn w1[:, chunk] for the four 16-row tiles with WMMA bf16 16x16x16 (f32
//   accumulators; the w1 tiles stream from L2 through the warp's 4-slot
//   cp.async ring, each feeding four MMAs), adds b1, applies GELU and the
//   dropout and writes the chunk's hidden as bf16 into shared memory; then
//   each warp adds hidden_chunk w2[chunk, ct] into the accumulators of the
//   y column tiles ct = warp + 12 i it owns (all four row tiles), its
//   three w2 tiles of a k-step sharing each A fragment it loads. The
//   accumulators hold 12 fragments a warp for the whole kernel. Every
//   block reads all of w1 and w2 (4.5 MB at far_mnist) from L2. The
//   products run near 105 TFLOP/s (WMMA fragment loads from shared memory;
//   see PERF.md), GELU's f32 arithmetic is ~15% of the time.
// * FMA route (f32, or a shape the first does not take): one block of 256
//   threads takes 16 rows; per chunk of 256 hidden columns each thread
//   computes one hidden column for the 16 rows (f32 FMAs, the xn reads
//   broadcast from shared memory), then the threads add the chunk's fc2
//   terms into an f32 y tile in shared memory, one output column each.

#include "gelu_as.cuh"
#include "hash_dropout.cuh"
#include "tile_ops.cuh"

namespace {

namespace wmma = nvcuda::wmma;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr long kSmemLimit = 232448;   // bytes a block may opt in to on sm_90

// ---------------------------------------------------------------------------
// Tensor-core route

constexpr int kRows = 64;             // rows per block: four 16-row tiles
constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;
constexpr int kHc = kWarps * 16;      // hidden columns per chunk
constexpr int kColTiles = 3;          // y column tiles per warp (C <= 576)
constexpr int kStages = 4;            // w tiles in flight per warp

long tc_smem(int C) {
  return (static_cast<long>(kRows) * (C + 8) + kRows * (kHc + 8)) * sizeof(bf16) +
         kWarps * kStages * kColTiles * 256L * sizeof(bf16);
}

bool use_tc(int C, int H, int dtype) {
  return dtype == 1 && C % 16 == 0 && H % 16 == 0 && C <= kWarps * kColTiles * 16 &&
         tc_smem(C) <= kSmemLimit;
}

// c[j][t] += A[16 t : 16 t + 16, 0 : 16 nk] B_j[0 : 16 nk, 0 : 16] for the
// four row tiles t and each column tile j < NB with valid[j]. A is bf16 in
// shared memory (row stride lda, a multiple of 8); B[j] points at the first
// element of a 16-column tile of a row-major bf16 matrix in device memory
// (row stride ldb). A k-step's NB B tiles stream into one slot of the
// warp's ring of kStages slots with cp.async, kStages - 1 slots in flight;
// the four A fragments are loaded once a k-step and feed 4 NB MMAs.
template <int NB>
__device__ __forceinline__ void warp_gemm(const bf16* A, int lda, const bf16* const (&B)[NB],
                                          const bool (&valid)[NB], long ldb, int nk,
                                          bf16* ring, int lane, Acc (&c)[NB][4]) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
  const int row = lane >> 1;
  const int half = (lane & 1) * 8;
  auto fetch = [&](int kt) {
    if (kt < nk) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (valid[j])
          __pipeline_memcpy_async(ring + ((kt % kStages) * NB + j) * 256 + row * 16 + half,
                                  B[j] + static_cast<long>(kt * 16 + row) * ldb + half, 16);
    }
    __pipeline_commit();
  };
  for (int kt = 0; kt < kStages - 1; ++kt) fetch(kt);
  for (int kt = 0; kt < nk; ++kt) {
    fetch(kt + kStages - 1);           // into the slot read at kt - 1
    __pipeline_wait_prior(kStages - 1);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 4; ++t) wmma::load_matrix_sync(a[t], A + t * 16 * lda + kt * 16, lda);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (!valid[j]) continue;
      wmma::load_matrix_sync(b, ring + ((kt % kStages) * NB + j) * 256, 16);
#pragma unroll
      for (int t = 0; t < 4; ++t) wmma::mma_sync(c[j][t], a[t], b, c[j][t]);
    }
    __syncwarp();
  }
  __pipeline_wait_prior(0);
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ ls,
              const float* __restrict__ lb, bf16* __restrict__ out, int S, int C, int H,
              float eps, vptr_dropout::Params drop) {
  // wmma needs 256-bit aligned tiles: every buffer starts at a multiple of
  // 32 bytes and every tile offset is a multiple of 32 bytes
  extern __shared__ __align__(128) unsigned char smem_ffn[];
  const int ldx = C + 8, ldh = kHc + 8;
  bf16* xn = reinterpret_cast<bf16*>(smem_ffn);   // [64][ldx] LN(x) * ls + lb
  bf16* hc = xn + kRows * ldx;                     // [64][ldh] the chunk's hidden
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bf16* ring = hc + kRows * ldh + warp * kStages * kColTiles * 256;
  float* stage = reinterpret_cast<float*>(ring);   // the ring's memory between products
  const long row0 = static_cast<long>(blockIdx.x) * kRows;
  const int rows = S - row0 < kRows ? static_cast<int>(S - row0) : kRows;

  // 1) LayerNorm, one warp per row, two-pass f32 statistics; padding rows
  //    are zero
  for (int r = warp; r < kRows; r += kWarps) {
    bf16* dst = xn + r * ldx;
    if (r < rows) {
      const bf16* xr = x + (row0 + r) * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += __bfloat162float(xr[c]);
      const float mean = warp_sum(s) / C;
      float ss = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = __bfloat162float(xr[c]) - mean;
        ss = fmaf(d, d, ss);
      }
      const float rstd = rsqrtf(warp_sum(ss) / C + eps);
      for (int c = lane; c < C; c += 32)
        dst[c] = __float2bfloat16_rn((__bfloat162float(xr[c]) - mean) * rstd * ls[c] + lb[c]);
    } else {
      for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16_rn(0.f);
    }
  }
  __syncthreads();

  const int nct = C / 16;
  Acc y[kColTiles][4];
#pragma unroll
  for (int i = 0; i < kColTiles; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t) wmma::fill_fragment(y[i][t], 0.f);
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;

  for (int h0 = 0; h0 < H; h0 += kHc) {
    const int hw = H - h0 < kHc ? H - h0 : kHc;   // a multiple of 16
    // 2) fc1 column tile `warp` of the chunk, + b1, GELU, dropout -> bf16
    if (warp * 16 < hw) {
      Acc c[1][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) wmma::fill_fragment(c[0][t], 0.f);
      const bf16* const bt[1] = {w1 + h0 + warp * 16};
      const bool all[1] = {true};
      warp_gemm<1>(xn, ldx, bt, all, H, C / 16, ring, lane, c);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        wmma::store_matrix_sync(stage, c[0][t], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = t * 16 + (e >> 4);
          const int col = h0 + warp * 16 + (e & 15);
          float v = vptr_gelu::gelu(stage[e] + b1[col]);
          if (drop.active())
            v = drop.apply(v, drop.keep(static_cast<uint32_t>((row0 + r) * H + col), seed));
          hc[r * ldh + warp * 16 + (e & 15)] = __float2bfloat16_rn(v);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // 3) fc2: y[:, ct] += hidden_chunk w2[h0 : h0 + hw, ct] for the warp's
    //    column tiles ct = warp + 12 i
    const bf16* bt[kColTiles];
    bool owned[kColTiles];
#pragma unroll
    for (int i = 0; i < kColTiles; ++i) {
      const int ct = warp + kWarps * i;
      owned[i] = ct < nct;
      bt[i] = w2 + static_cast<long>(h0) * C + (owned[i] ? ct * 16 : 0);
    }
    warp_gemm<kColTiles>(hc, ldh, bt, owned, C, hw / 16, ring, lane, y);
    __syncthreads();                   // the next chunk rewrites hc
  }

  // 4) y + b2, rounded once
#pragma unroll
  for (int i = 0; i < kColTiles; ++i) {
    const int ct = warp + kWarps * i;
    if (ct >= nct) continue;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      wmma::store_matrix_sync(stage, y[i][t], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = t * 16 + (e >> 4);
        const int col = ct * 16 + (e & 15);
        if (r < rows) out[(row0 + r) * C + col] = __float2bfloat16_rn(stage[e] + b2[col]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// FMA route

constexpr int kFmaRows = 16;
constexpr int kFmaThreads = 256;
constexpr int kFmaHc = 256;           // hidden columns per chunk: one a thread

long fma_smem(int C) {
  return static_cast<long>(sizeof(float)) * (2L * kFmaRows * C + kFmaRows * kFmaHc);
}

template <typename T>
__global__ void __launch_bounds__(kFmaThreads)
ffn_fma_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
               const T* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ ls, const float* __restrict__ lb, T* __restrict__ out,
               int S, int C, int H, float eps, vptr_dropout::Params drop) {
  extern __shared__ float smem_fma[];
  float* xn = smem_fma;                // [16][C] LN(x) * ls + lb, rounded to T
  float* yb = xn + kFmaRows * C;       // [16][C] fc2 sums
  float* hb = yb + kFmaRows * C;       // [16][256] the chunk's hidden, rounded to T
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row0 = static_cast<long>(blockIdx.x) * kFmaRows;
  const int rows = S - row0 < kFmaRows ? static_cast<int>(S - row0) : kFmaRows;

  for (int r = warp; r < kFmaRows; r += kFmaThreads / 32) {
    float* dst = xn + r * C;
    if (r < rows) {
      const T* xr = x + (row0 + r) * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
      const float mean = warp_sum(s) / C;
      float ss = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f32(xr[c]) - mean;
        ss = fmaf(d, d, ss);
      }
      const float rstd = rsqrtf(warp_sum(ss) / C + eps);
      for (int c = lane; c < C; c += 32)
        dst[c] = round_t<T>((to_f32(xr[c]) - mean) * rstd * ls[c] + lb[c]);
    } else {
      for (int c = lane; c < C; c += 32) dst[c] = 0.f;
    }
  }
  for (int i = threadIdx.x; i < kFmaRows * C; i += kFmaThreads) yb[i] = 0.f;
  __syncthreads();

  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  for (int h0 = 0; h0 < H; h0 += kFmaHc) {
    const int hw = H - h0 < kFmaHc ? H - h0 : kFmaHc;
    const int j = threadIdx.x;
    if (j < hw) {
      const int col = h0 + j;
      float acc[kFmaRows];
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) acc[r] = 0.f;
      for (int k = 0; k < C; ++k) {
        const float w = to_f32(w1[static_cast<long>(k) * H + col]);
#pragma unroll
        for (int r = 0; r < kFmaRows; ++r) acc[r] = fmaf(xn[r * C + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        float v = vptr_gelu::gelu(acc[r] + b1[col]);
        if (drop.active())
          v = drop.apply(v, drop.keep(static_cast<uint32_t>((row0 + r) * H + col), seed));
        hb[r * kFmaHc + j] = round_t<T>(v);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kFmaThreads) {
      float acc[kFmaRows];
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) acc[r] = yb[r * C + c];
      for (int k = 0; k < hw; ++k) {
        const float w = to_f32(w2[static_cast<long>(h0 + k) * C + c]);
#pragma unroll
        for (int r = 0; r < kFmaRows; ++r) acc[r] = fmaf(hb[r * kFmaHc + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) yb[r * C + c] = acc[r];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows * C; i += kFmaThreads) {
    const int r = i / C, c = i - r * C;
    out[(row0 + r) * C + c] = from_f32<T>(yb[i] + b2[c]);
  }
}

long ffn_smem(int C, int H, int dtype) { return use_tc(C, H, dtype) ? tc_smem(C) : fma_smem(C); }

template <typename K>
cudaError_t set_smem(K kernel, long smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_fma(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* ls, const void* lb, void* out, int S, int C, int H, float eps,
               vptr_dropout::Params drop, cudaStream_t s) {
  const long smem = fma_smem(C);
  cudaError_t err = set_smem(ffn_fma_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ffn_fma_kernel<T><<<(S + kFmaRows - 1) / kFmaRows, kFmaThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<const float*>(ls),
      static_cast<const float*>(lb), static_cast<T*>(out), S, C, H, eps, drop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the route (C, H, dtype) takes, in bytes; more
// than 232448 means the shape is not supported.
long vptr_fused_ffn_smem(int C, int H, int dtype) { return ffn_smem(C, H, dtype); }

// 1 when (C, H, dtype) takes the tensor-core route, 0 for the FMA route.
int vptr_fused_ffn_route(int C, int H, int dtype) { return use_tc(C, H, dtype) ? 1 : 0; }

// dtype: 0 = float32, 1 = bfloat16. seed (device int32) may be null when
// rate == 0; keep_div = (float)(1 - rate). Returns a cudaError_t (0 =
// launched).
int vptr_fused_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* ls, const void* lb, void* out, int S, int C,
                   int H, float eps, const void* seed, float rate, float keep_div, int dtype,
                   void* stream) {
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || C < 1 || H < 1 || dtype < 0 || dtype > 1 || ffn_smem(C, H, dtype) > kSmemLimit ||
      (rate > 0.f && !seed) || rate >= 1.f)
    return cudaErrorInvalidValue;
  if (use_tc(C, H, dtype)) {
    const long smem = tc_smem(C);
    cudaError_t err = set_smem(ffn_tc_kernel, smem);
    if (err != cudaSuccess) return err;
    ffn_tc_kernel<<<(S + kRows - 1) / kRows, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2),
        static_cast<const float*>(ls), static_cast<const float*>(lb), static_cast<bf16*>(out),
        S, C, H, eps, drop);
    return cudaGetLastError();
  }
  return dtype == 0 ? launch_fma<float>(x, w1, b1, w2, b2, ls, lb, out, S, C, H, eps, drop, s)
                    : launch_fma<bf16>(x, w1, b1, w2, b2, ls, lb, out, S, C, H, eps, drop, s);
}

}  // extern "C"
