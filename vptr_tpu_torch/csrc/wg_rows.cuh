// The row-tiled product on Hopper's warpgroup MMA (sm_90a) of the bf16
// window-attention passes (fused_window_attention.cuh, the forwards #1 and
// #5; fused_window_attention_bwd.cuh, the backwards #3 and #6): out (R, N)
// = sum over the T terms of A_t (R, K) B (K, N), with an epilogue, for up
// to kRwJobs products of one launch (the projections q, k, v are three).
// A_t is K-major as it lies in memory (rows of K, any row
// stride: the hi and lo halves of dq | dk | dv are columns of one plane);
// B is either MN-major (BMN: W (K, N) as stored, N contiguous, the
// product's transpose flag) or given as B^T (N, K), K-major as stored.
//
// A tile is 128 rows by one 176-column group: two warpgroups of 64 rows on
// wgmma m64n176k16 (88 f32 accumulators a thread), fed by TMA through a ring
// of 64-deep K steps; a stage holds the T terms' boxes of 128 rows by 64 K
// and B's 176 columns by 64 K (one K-major box, or three MN-major boxes of
// 64 columns, the last 16 columns of the third left out). A feeder warp
// issues the loads. The blocks are persistent (one an SM: the ring takes
// its shared memory) over the units (job, row tile, column group), the
// ring running ahead into the next unit while the epilogue runs. Rows past
// R, K past the depth and columns past N read zero and are never stored.
#pragma once

#include <cstdio>

#include "conv_ln_wg.cuh"

namespace {

constexpr int kRwRows = 128;                    // rows a tile: two warpgroups of 64
constexpr int kRwBoxA = kRwRows * kWgK * 2;     // 16 KB: a term's 128 rows by 64 K
constexpr int kRwBoxMn = 64 * kWgK * 2;         // 8 KB: 64 columns of B by 64 K
constexpr int kRwBoxB = 3 * kRwBoxMn;           // a stage's room for B's 176 columns
constexpr int kRwOut = 16 * 64 * 2;             // a warp's 16 x 64 bf16 store buffer
constexpr int kRwWarps = 8;                     // the warpgroups' warps
constexpr int kRwThreads = kRwWarps * 32 + 32;  // and the feeder
constexpr int kRwJobs = 3;

// kRwProj: round(acc + bias[col]) * mul, rounded, in bf16 (the projections);
// kRwF32: acc (* rowscale[row / group]) in f32; kRwBf16: acc in bf16;
// kRwOutProj: acc + bias[col], * rowscale[row / group] when given, + the
// residual res[row][col] when given, rounded once to bf16 (the forwards'
// out projection). A kRwOutProj launch runs one job; its residual (R, N) bf16,
// or null, is the out of the spare last job (job[kRwJobs - 1]), so the
// parameter layout is that of every other launch.
enum RwEpi { kRwProj = 0, kRwF32 = 1, kRwBf16 = 2, kRwOutProj = 3 };

struct RwJob {
  void* out;                 // (R, N), row-major
  const float* bias;         // kRwProj, kRwOutProj
  float mul;                 // kRwProj
  const float* rowscale;     // kRwF32, kRwOutProj, or null
  int depth;                 // K
};

struct RwMaps {
  CUtensorMap a[kRwJobs][2];   // the terms of A: boxes of 64 K by 128 rows
  CUtensorMap b[kRwJobs];      // B (BMN: 64 columns by 64 K) or B^T (64 K by 176 rows)
};

// The units: `jobs` products of R rows by N columns, RT row tiles by NG
// column groups each, unit u = (job NG RT + row tile NG + column group).
struct RwWork {
  RwJob job[kRwJobs];
  int jobs, rows, cols, group, RT, NG;
  __device__ __forceinline__ int units() const { return jobs * RT * NG; }
  __device__ __forceinline__ void unit(int u, int& j, int& rt, int& cg) const {
    j = u / (RT * NG);
    const int rem = u - j * RT * NG;
    rt = rem / NG;
    cg = rem - rt * NG;
  }
};

__host__ __device__ constexpr int rw_stage_bytes(int t) { return t * kRwBoxA + kRwBoxB; }
int rw_stages(int t) {
  const int n = (232448 - 1024 - kRwWarps * kRwOut) / rw_stage_bytes(t);
  return n > kWgMaxStages ? kWgMaxStages : n;
}
// The ring (1024-aligned), then the warps' store buffers.
long rw_smem(int t) {
  return 1024L + static_cast<long>(rw_stages(t)) * rw_stage_bytes(t) + kRwWarps * kRwOut;
}

template <int T, bool BMN, int EPI>
__global__ void __launch_bounds__(kRwThreads, 1)
wg_rows_kernel(const __grid_constant__ RwMaps maps, const RwWork w, int stages) {
  constexpr int kStage = rw_stage_bytes(T);
  constexpr uint32_t kTx = T * kRwBoxA + (BMN ? kRwBoxB : kWgBBytes);
  extern __shared__ unsigned char smem_rw[];
  __shared__ WgRing ring;
  if (threadIdx.x == 0) {
    wg_ring_init(ring, smem_rw, stages, kRwWarps);
    mbar_fence_init();
  }
  __syncthreads();
  // the warp index broadcast from lane 0: the compiler then knows that the
  // roles are warp-uniform, and keeps the products asynchronous
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int units = w.units();
  if (warp == kRwWarps) {              // the feeder
    if (lane == 0) {
      int g = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int j, rt, cg;
        w.unit(u, j, rt, cg);
        const int steps = (w.job[j].depth + kWgK - 1) / kWgK;
        for (int k = 0; k < steps; ++k, ++g) {
          const int st = g % stages;
          if (g >= stages) mbar_wait(&ring.empty[st], ((g / stages) & 1) ^ 1);
          unsigned char* s = ring.tiles + st * kStage;
          mbar_expect_tx(&ring.full[st], kTx, true);
          for (int t = 0; t < T; ++t)
            tma_load_2d(s + t * kRwBoxA, &maps.a[j][t], &ring.full[st], k * kWgK,
                        rt * kRwRows, true);
          if (BMN) {
            for (int i = 0; i < 3; ++i)
              tma_load_2d(s + T * kRwBoxA + i * kRwBoxMn, &maps.b[j], &ring.full[st],
                          cg * kWgN + 64 * i, k * kWgK, true);
          } else {
            tma_load_2d(s + T * kRwBoxA, &maps.b[j], &ring.full[st], k * kWgK, cg * kWgN, true);
          }
        }
      }
    }
    return;
  }
  const int wg = warp >> 2, q = warp & 3;
  unsigned char* ob = ring.tiles + stages * kStage + warp * kRwOut;
  float acc[kWgAcc];
  int g = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int j, rt, cg;
    w.unit(u, j, rt, cg);
    const RwJob& jb = w.job[j];
    const int steps = (jb.depth + kWgK - 1) / kWgK;
#pragma unroll
    for (int i = 0; i < kWgAcc; ++i) acc[i] = 0.f;
    for (int k = 0; k < steps; ++k, ++g) {
      const int st = g % stages;
      mbar_wait(&ring.full[st], (g / stages) & 1);
      const unsigned char* s = ring.tiles + st * kStage;
      // 16-deep slices inside the depth (TMA reads zero past it)
      const int kk = (min(kWgK, jb.depth - k * kWgK) + 15) / 16;
      wg_fence_acc(acc);
      wg_fence();
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int qq = 0; qq < kWgK / 16; ++qq)
          if (qq < kk) {
            const uint64_t da = wg_desc(s + t * kRwBoxA + wg * (kRwBoxA / 2)) + 2 * qq;
            if constexpr (BMN)             // +16 K rows, 2048 bytes, a slice
              wgmma_176<0, 1>(acc, da, wg_desc_mn(s + T * kRwBoxA + 2048 * qq, kRwBoxMn));
            else                           // +32 bytes a slice
              wgmma_176<0, 0>(acc, da, wg_desc(s + T * kRwBoxA) + 2 * qq);
          }
      wg_commit();
      wg_fence_acc(acc);
      if (k > 0) {                     // the previous step's products are done
        wg_wait<1>();
        mbar_arrive(&ring.empty[(g - 1) % stages], lane == 0);
      }
    }
    wg_wait<0>();
    wg_fence_acc(acc);
    mbar_arrive(&ring.empty[(g - 1) % stages], lane == 0);

    // the epilogue: rows r0 and r0 + 8 of this warp, columns cb + 8 i (+ 1)
    const int row0 = rt * kRwRows + 64 * wg + 16 * q;
    const int r0 = row0 + (lane >> 2), cb = cg * kWgN + 2 * (lane & 3);
    if constexpr (EPI == kRwF32) {
      float* out = static_cast<float*>(jb.out);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= w.rows) continue;
        const float sc = jb.rowscale ? jb.rowscale[r / w.group] : 1.f;
#pragma unroll
        for (int i = 0; i < kWgN / 8; ++i)
          if (cb + 8 * i < w.cols)
            *reinterpret_cast<float2*>(out + static_cast<long>(r) * w.cols + cb + 8 * i) =
                make_float2(acc[4 * i + 2 * h] * sc, acc[4 * i + 2 * h + 1] * sc);
      }
    } else {
      if constexpr (EPI == kRwOutProj) {
        const __nv_bfloat162* res = static_cast<const __nv_bfloat162*>(w.job[kRwJobs - 1].out);
        float sc[2];
        bool in[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          in[h] = r0 + 8 * h < w.rows;
          sc[h] = in[h] && jb.rowscale ? jb.rowscale[(r0 + 8 * h) / w.group] : 1.f;
        }
#pragma unroll
        for (int i = 0; i < kWgN / 8; ++i) {
          const int col = cb + 8 * i;
          if (col >= w.cols) continue;
          const float2 b = *reinterpret_cast<const float2*>(jb.bias + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float y0 = (acc[4 * i + 2 * h] + b.x) * sc[h];
            float y1 = (acc[4 * i + 2 * h + 1] + b.y) * sc[h];
            if (res && in[h]) {
              const float2 x =
                  __bfloat1622float2(res[(static_cast<long>(r0 + 8 * h) * w.cols + col) / 2]);
              y0 += x.x, y1 += x.y;
            }
            acc[4 * i + 2 * h] = y0, acc[4 * i + 2 * h + 1] = y1;
          }
        }
      }
      if constexpr (EPI == kRwProj) {
#pragma unroll
        for (int i = 0; i < kWgN / 8; ++i) {
          const int col = cb + 8 * i;
          const float2 b = col < w.cols ? *reinterpret_cast<const float2*>(jb.bias + col)
                                        : make_float2(0.f, 0.f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float y0 = round_t<bf16>(acc[4 * i + 2 * h] + b.x);
            float y1 = round_t<bf16>(acc[4 * i + 2 * h + 1] + b.y);
            if (jb.mul != 1.f) y0 *= jb.mul, y1 *= jb.mul;
            acc[4 * i + 2 * h] = y0, acc[4 * i + 2 * h + 1] = y1;
          }
        }
      }
      // bf16 in three pieces of 64, 64 and 48 columns, each through the
      // warp's buffer (16 rows of 128 bytes, 16-byte chunk c of row r at
      // c ^ r % 8: no bank conflicts either way), then stored in whole
      // 16-byte chunks along the rows
      bf16* out = static_cast<bf16*>(jb.out);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = 8 * p + jj;
          if (i < kWgN / 8)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = (lane >> 2) + 8 * h;
              *reinterpret_cast<__nv_bfloat162*>(ob + r * 128 + ((jj ^ (r & 7)) << 4) +
                                                 4 * (lane & 3)) =
                  __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
            }
        }
        __syncwarp();
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const int r = 4 * i4 + (lane >> 3), c = lane & 7;
          const int col = cg * kWgN + 64 * p + 8 * c;
          if ((p < 2 || c < 6) && row0 + r < w.rows && col < w.cols)
            *reinterpret_cast<uint4*>(out + static_cast<long>(row0 + r) * w.cols + col) =
                *reinterpret_cast<const uint4*>(ob + r * 128 + ((c ^ (r & 7)) << 4));
        }
        __syncwarp();                  // the buffer is read before the next piece
      }
    }
  }
}

// A bf16 tensor map of the (rows, cols) matrix at p with a row stride of ld
// elements (a multiple of 8), in boxes of box_cols by box_rows, 128-byte
// swizzled; outside the matrix reads zero.
int strided_map(CUtensorMap* map, const void* p, int rows, int cols, long ld, int box_cols,
                int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride = static_cast<cuuint64_t>(ld) * 2;
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  return bf16_map(map, p, 2, dims, &stride, box);
}

// A term of A: rows (rows, depth) at p, row stride ld.
int rw_amap(CUtensorMap* map, const void* p, int rows, int depth, long ld) {
  return strided_map(map, p, rows, depth, ld, kWgK, kRwRows);
}

// B: W (depth, cols) as stored (BMN), or B^T (cols, depth) with row stride ld.
int rw_bmap(CUtensorMap* map, const void* p, int depth, int cols, long ld, bool bmn) {
  return bmn ? strided_map(map, p, depth, cols, ld, 64, kWgK)
             : strided_map(map, p, cols, depth, ld, kWgK, kWgN);
}

// Launches the products of w (its row tiles and column groups filled in
// here): a block an SM, at most one a unit.
template <int T, bool BMN, int EPI>
int launch_rows(const RwMaps& maps, RwWork w, cudaStream_t s) {
  w.RT = (w.rows + kRwRows - 1) / kRwRows, w.NG = (w.cols + kWgN - 1) / kWgN;
  const int units = w.jobs * w.RT * w.NG, sms = sm_count();
  if (!sms) return cudaErrorInvalidConfiguration;
  auto kernel = wg_rows_kernel<T, BMN, EPI>;
  const long smem = rw_smem(T);
  VPTR_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem)));
  kernel<<<units < sms ? units : sms, kRwThreads, smem, s>>>(maps, w, rw_stages(T));
  return cudaGetLastError();
}

// The error text of a cudaError_t or of kTmaEncodeError + a CUresult.
const char* error_string(int err) {
  if (err >= kTmaEncodeError) {
    static char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             err - kTmaEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace
