// The "tiled" route of the conv feed-forward's middle chain, forward
// (fused_dw_chain.cu, kernel #9) and backward (fused_dw_chain_bwd.cu, #10),
// for samples that fit neither a block nor a cluster: nar_kth_128's 16 x 16
// x 2112 is 2.2 MB a sample in f32, and its four (HW, C) f32 affines 8.7 MB,
// where the per-sample and persistent routes hold a sample's slice and the
// affines in shared memory. The arithmetic is dw_chain.cuh's (x (N, HW, C)
// channels last, row r the position (r / W, r % W) of an H x W grid):
//     z1 = gelu(LN(x) s1 + b1),  z2 = dw3x3(z1) + dwb,
//     z3 = dropout(gelu(LN(z2) s2 + b2))
// with f32 arithmetic, the A&S GELU (gelu_as.cuh), the dropout's counter
// hash at element (n HW + r) C + c (hash_dropout.cuh).
//
// The design: a few passes through device memory, each kernel's block a
// tile of one grid row by 32 channels (a warp's lanes: a thread keeps its
// channel, so its taps and dwb stay in registers, and every row of 32
// channels is one 128-byte line in f32). Each LayerNorm's statistics are
// per-(sample, tile) partial moments (the tile's mean and centred M2, two
// passes over the tile's values in registers), merged per sample by
// tiled.cuh's tiled_stats_kernel in tile order (Chan's formula). The
// depthwise conv reads a one-row halo: z1 (and in the backward dz2) of the
// grid rows above and below are recomputed from x into shared memory. The
// affines stream from device memory (L2: 8.7 MB). The forward:
//   1. moments of x;  2. z1 + dw3x3 into z2 (f32 scratch) and z2's moments;
//   3. norm2 + GELU + dropout.
// The backward recomputes 1 and 2, then
//   4. LN2's backward sums (sum dxh2, sum dxh2 xhat2) per tile, and the sums
//      of da2 xhat2 and da2 over the samples of a group (ds2, db2);
//   5. dz2 of the tile and its halo into shared memory, da1 = the
//      transposed conv times gelu'(a1) into f32 scratch, LN1's backward
//      sums, ds1 and db1 over the group's samples, the tap and dwb
//      gradients of the tile (9 + 1 a thread, then the warps in order);
//   6. dx from da1 and LN1's sums;  7. the groups' (and the tiles') partial
//      gradients summed in order.
// Sums over samples run in kTGroups sample groups (a group's samples in
// order in one thread) summed in group order: no atomics, the same bits on
// every run.
//
// Tensor parallelism: a call over channels c0 .. c0 + C - 1 of Cg (a model
// rank's share of the hidden) runs the same passes as steps with the
// LayerNorms' statistics merged between them over every share
// (fused_dw_chain.cu / fused_dw_chain_bwd.cu: vptr_*_tiled_step and
// vptr_fused_dw_chain_tiled_merge). Where a share is whole tiles of the
// whole call (C a multiple of 32), its partials are the whole call's, and
// merged in the whole call's tile order (within a grid row rank 0's tiles,
// then rank 1's, ...) the statistics are the whole call's bits. A share
// of C = 32 k + r channels (0 < r < 32: far_mnist's 2112 over mesh.model
// 4 is 528 = 16 tiles and 16 channels) ends each grid row in one partial
// tile of r channels: its lanes past the share load nothing and store
// nothing, its moments and LN backward sums count W r values, and the merge
// weighs each tile by its count (dwt_stats_uneven). Such a
// share's tiles are not the whole call's (a whole-call tile straddles two
// ranks: channels 512..543 of 2112 lie across ranks 0 and 1), so its
// statistics and output differ from the whole tiled call's by rounding.
// The dropout indexes by the global channel (TTile::drop_idx). What stays
// per channel (the conv, the taps', dwb's and the affines' gradients) needs
// no other share, and only the lanes inside the share write it.
//
// What bounds it on an H100: bytes. The forward moves x three times (its
// moments, the conv's three rows of z1, once more as the halo), z2 in f32
// twice and the output once; the backward also g twice, z2 and da1 in f32.
// Made right and simple first: its time stands in PERF.md beside its bound.
#pragma once

#include "gelu_as.cuh"
#include "hash_dropout.cuh"
#include "tiled.cuh"

namespace {

constexpr int kTCh = 32;                       // channels a tile: a warp's lanes
constexpr int kTMaxW = 32;                     // the widest grid the route takes
constexpr int kTPer = kTMaxW / kTWarps;        // a thread's positions in a tile, at most
constexpr int kTGroups = 8;                    // sample groups of the backward's sums
constexpr int kTMaxN = 65535;                  // samples: a grid dimension
constexpr long kDwRouteSmem = 231000;          // ops/fused_dw_chain.py::SMEM_LIMIT

// The shapes the tiled route takes (any dtype): W <= 32, HW a multiple of
// W, C a multiple of 32.
bool t_route_ok(int HW, int W, int C) {
  return HW >= 1 && W >= 1 && W <= kTMaxW && HW % W == 0 && C >= kTCh && C % kTCh == 0;
}

// The shapes its steps take on a share of the channels (tensor
// parallelism): any C >= 1, the last tile of a grid row partial where C is
// not a multiple of 32.
bool t_split_ok(int HW, int W, int C) {
  return HW >= 1 && W >= 1 && W <= kTMaxW && HW % W == 0 && C >= 1;
}

// Tiles of 32 channels across C channels (the last one partial where 32
// does not divide C).
int t_cols(int C) { return (C + kTCh - 1) / kTCh; }

int t_groups(int N) { return N < kTGroups ? N : kTGroups; }

// The block's tile: grid row `row` (blockIdx.y) of H, channels c0 .. c0 +
// width - 1 (blockIdx.x; width 32 but in a partial last tile); thread t
// holds channel c0 + t % 32 at the positions (row, t / 32 + 8 m), m <
// mine(), and touches memory only where `on` (its lane inside the tile);
// T tiles a sample.
struct TTile {
  int row, c0, lane, j0, H, W, HW, C, T, tile, width;
  bool on;
  __device__ TTile(int W_, int HW_, int C_)
      : row(static_cast<int>(blockIdx.y)), c0(static_cast<int>(blockIdx.x) * kTCh),
        lane(static_cast<int>(threadIdx.x) & 31), j0(static_cast<int>(threadIdx.x) >> 5),
        H(HW_ / W_), W(W_), HW(HW_), C(C_), T(static_cast<int>(gridDim.x * gridDim.y)),
        tile(static_cast<int>(blockIdx.y * gridDim.x + blockIdx.x)),
        width(C_ - c0 < kTCh ? C_ - c0 : kTCh), on(lane < width) {}
  __device__ int mine() const { return j0 < W ? (W - j0 + kTWarps - 1) / kTWarps : 0; }
  __device__ int j(int m) const { return j0 + kTWarps * m; }
  // (sample n, grid row r, column jj, this thread's channel) in (N, HW, C);
  // with n = 0, in an (HW, C) affine
  __device__ long off(long n, int r, int jj) const {
    return (n * HW + static_cast<long>(r) * W + jj) * C + c0 + lane;
  }
  __device__ float cnt() const { return static_cast<float>(W * width); }
  // the dropout's element index of (n, r, jj) at this thread's channel:
  // (n HW + r W + jj) C + c0 + lane, by the global channel for a share
  __device__ uint32_t drop_idx(const vptr_dropout::Params& d, long n, int r, int jj) const {
    return d.col_index(static_cast<uint32_t>(n * HW + static_cast<long>(r) * W + jj),
                       static_cast<uint32_t>(C), static_cast<uint32_t>(c0 + lane));
  }
  __device__ long part(long n) const { return 2 * (n * T + tile); }
};

// The tile's (mean, M2) of the thread's values v[m < mine()] into p (v 0
// in the lanes past a partial tile).
__device__ __forceinline__ void tile_moments(const TTile& tl, const float (&v)[kTPer],
                                             float (*red)[kTWarps], float* p) {
  const int nm = tl.on ? tl.mine() : 0;
  float s[1] = {0.f};
#pragma unroll
  for (int m = 0; m < kTPer; ++m)
    if (m < nm) s[0] += v[m];
  block_sum(s, red);
  const float mean = s[0] / tl.cnt();
  float q[1] = {0.f};
#pragma unroll
  for (int m = 0; m < kTPer; ++m)
    if (m < nm) {
      const float d = v[m] - mean;
      q[0] = fmaf(d, d, q[0]);
    }
  block_sum(q, red);
  if (threadIdx.x == 0) {
    p[0] = mean;
    p[1] = q[0];
  }
}

// z1 = gelu((x - mean) rstd s1 + b1) of grid rows row - 1 .. row + 1 of
// sample n into buf [3][W][32], zero outside the grid (the conv's padding).
template <typename T>
__device__ __forceinline__ void stage_z1(const TTile& tl, const T* __restrict__ x,
                                         const float* __restrict__ s1,
                                         const float* __restrict__ b1, long n, float mean,
                                         float rstd, float* buf) {
  for (int s = tl.j0; s < 3 * tl.W; s += kTWarps) {
    const int rr = s / tl.W, jj = s - rr * tl.W, r = tl.row + rr - 1;
    float z = 0.f;
    if (tl.on && r >= 0 && r < tl.H) {
      const long a = tl.off(0, r, jj);
      z = vptr_gelu::gelu((to_f32(x[tl.off(n, r, jj)]) - mean) * rstd * s1[a] + b1[a]);
    }
    buf[s * kTCh + tl.lane] = z;
  }
}

// 1. the tile's moments of x (grid: t_cols(C), H, N)
template <typename T>
__global__ void __launch_bounds__(kTThreads)
dwt_moments_kernel(const T* __restrict__ x, float* __restrict__ part, int HW, int W, int C) {
  __shared__ float red[1][kTWarps];
  const TTile tl(W, HW, C);
  const long n = blockIdx.z;
  float v[kTPer];
#pragma unroll
  for (int m = 0; m < kTPer; ++m)
    v[m] = tl.on && m < tl.mine() ? to_f32(x[tl.off(n, tl.row, tl.j(m))]) : 0.f;
  tile_moments(tl, v, red, part + tl.part(n));
}

// 2. z2 = dw3x3(z1) + dwb of the tile into z2 (f32) and its moments (grid:
// t_cols(C), H, N; dynamic shared memory 3 W 32 floats)
template <typename T>
__global__ void __launch_bounds__(kTThreads)
dwt_conv_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                const float* __restrict__ dwb, const float* __restrict__ s1,
                const float* __restrict__ b1, const float* __restrict__ st1,
                float* __restrict__ z2, float* __restrict__ part, int HW, int W, int C) {
  extern __shared__ float smem_t[];
  __shared__ float red[1][kTWarps];
  const TTile tl(W, HW, C);
  const long n = blockIdx.z;
  stage_z1(tl, x, s1, b1, n, st1[2 * n], st1[2 * n + 1], smem_t);
  float tp[9];
#pragma unroll
  for (int t = 0; t < 9; ++t)
    tp[t] = tl.on ? taps[static_cast<long>(t) * C + tl.c0 + tl.lane] : 0.f;
  const float bias = tl.on ? dwb[tl.c0 + tl.lane] : 0.f;
  __syncthreads();
  float v[kTPer];
#pragma unroll
  for (int m = 0; m < kTPer; ++m) {
    v[m] = 0.f;
    if (tl.on && m < tl.mine()) {
      const int jj = tl.j(m);
      float acc = bias;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int jc = jj + dx - 1;
          if (jc >= 0 && jc < W)
            acc = fmaf(smem_t[(dy * W + jc) * kTCh + tl.lane], tp[dy * 3 + dx], acc);
        }
      v[m] = acc;
      z2[tl.off(n, tl.row, jj)] = acc;
    }
  }
  tile_moments(tl, v, red, part + tl.part(n));
}

// 3. out = dropout(gelu((z2 - mean2) rstd2 s2 + b2)) (grid: t_cols(C), H, N)
template <typename T>
__global__ void __launch_bounds__(kTThreads)
dwt_out_kernel(const float* __restrict__ z2, const float* __restrict__ s2,
               const float* __restrict__ b2, const float* __restrict__ st2, T* __restrict__ out,
               int HW, int W, int C, vptr_dropout::Params drop) {
  const TTile tl(W, HW, C);
  if (!tl.on) return;
  const long n = blockIdx.z;
  const float mean = st2[2 * n], rstd = st2[2 * n + 1];
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  for (int m = 0; m < tl.mine(); ++m) {
    const int jj = tl.j(m);
    const long o = tl.off(n, tl.row, jj), a = tl.off(0, tl.row, jj);
    float y = vptr_gelu::gelu((z2[o] - mean) * rstd * s2[a] + b2[a]);
    if (drop.active()) y = drop.apply(y, drop.keep(tl.drop_idx(drop, n, tl.row, jj), seed));
    out[o] = from_f32<T>(y);
  }
}

// The cotangent of LN2's input at (sample n, grid row r, column jj) with
// the affine (sc, bi) there: da2 = dropout(g) gelu'(a2), dxh2 = da2 s2
// (xh: xhat2).
template <typename T>
__device__ __forceinline__ float dwt_da2(const TTile& tl, const float* __restrict__ z2,
                                         const T* __restrict__ g, float sc, float bi, long n,
                                         int r, int jj, float mean, float rstd,
                                         const vptr_dropout::Params& drop, uint32_t seed,
                                         float& xh) {
  const long o = tl.off(n, r, jj);
  xh = (z2[o] - mean) * rstd;
  float gs = to_f32(g[o]);
  if (drop.active()) gs = drop.apply(gs, drop.keep(tl.drop_idx(drop, n, r, jj), seed));
  return gs * vptr_gelu::gelu_grad(xh * sc + bi);
}

// 4. LN2's backward sums per (sample, tile) into part: (sum dxh2, sum dxh2
// xhat2); ds2 = sum da2 xhat2, db2 = sum da2 over the group's samples into
// gpart[group][2], [3] (grid: t_cols(C), H, groups; group z takes the
// samples z, z + groups, ...)
template <typename T>
__global__ void __launch_bounds__(kTThreads)
dwt_ln2_bwd_kernel(const float* __restrict__ z2, const T* __restrict__ g,
                   const float* __restrict__ s2, const float* __restrict__ b2,
                   const float* __restrict__ st2, float* __restrict__ part,
                   float* __restrict__ gpart, int N, int HW, int W, int C,
                   vptr_dropout::Params drop) {
  __shared__ float red[2][kTWarps];
  const TTile tl(W, HW, C);
  const int nm = tl.on ? tl.mine() : 0, G = static_cast<int>(gridDim.z);
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  float sc[kTPer], bi[kTPer], ds[kTPer], db[kTPer];
#pragma unroll
  for (int m = 0; m < kTPer; ++m) {
    const long a = m < nm ? tl.off(0, tl.row, tl.j(m)) : 0;
    sc[m] = m < nm ? s2[a] : 0.f;
    bi[m] = m < nm ? b2[a] : 0.f;
    ds[m] = db[m] = 0.f;
  }
  for (long n = blockIdx.z; n < N; n += G) {
    const float mean = st2[2 * n], rstd = st2[2 * n + 1];
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int m = 0; m < kTPer; ++m)
      if (m < nm) {
        float xh;
        const float da = dwt_da2(tl, z2, g, sc[m], bi[m], n, tl.row, tl.j(m), mean, rstd, drop,
                                 seed, xh);
        ds[m] = fmaf(da, xh, ds[m]);
        db[m] += da;
        const float dxh = da * sc[m];
        v[0] += dxh;
        v[1] = fmaf(dxh, xh, v[1]);
      }
    block_sum(v, red);
    if (threadIdx.x == 0) {
      part[tl.part(n)] = v[0];
      part[tl.part(n) + 1] = v[1];
    }
  }
  const long hwc = static_cast<long>(HW) * C;
  float* gp = gpart + static_cast<long>(blockIdx.z) * 4 * hwc;
#pragma unroll
  for (int m = 0; m < kTPer; ++m)
    if (m < nm) {
      const long a = tl.off(0, tl.row, tl.j(m));
      gp[2 * hwc + a] = ds[m];
      gp[3 * hwc + a] = db[m];
    }
}

// 5. the conv's backward (grid: t_cols(C), H, groups; dynamic shared memory 6
// W 32 floats): for each of the group's samples, z1 and dz2 of grid rows
// row - 1 .. row + 1 staged; da1 = (sum over the taps of dz2 at the
// mirrored offset times the tap) gelu'(a1) of the tile into da1 (f32);
// LN1's backward sums (sum dxh1, sum dxh1 xhat1) into part; ds1, db1 over
// the group's samples into gpart[group][0], [1]; the tile's sums of z1 dz2
// at each tap's offset and of dz2 into tpart[group][row] (10 x C)
template <typename T>
__global__ void __launch_bounds__(kTThreads)
dwt_conv_bwd_kernel(const T* __restrict__ x, const float* __restrict__ z2,
                    const T* __restrict__ g, const float* __restrict__ taps,
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const float* __restrict__ s2, const float* __restrict__ b2,
                    const float* __restrict__ stats, float* __restrict__ da1,
                    float* __restrict__ part, float* __restrict__ gpart,
                    float* __restrict__ tpart, int N, int HW, int W, int C,
                    vptr_dropout::Params drop) {
  extern __shared__ float smem_t[];
  __shared__ float red[2][kTWarps];
  __shared__ float tred[10][kTWarps][kTCh];
  float* z1s = smem_t;                 // [3][W][32]
  float* dzs = smem_t + 3 * W * kTCh;  // [3][W][32]
  const TTile tl(W, HW, C);
  const int nm = tl.on ? tl.mine() : 0, G = static_cast<int>(gridDim.z);
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  // stats: [0] LN1's (mean, rstd), [1] LN2's, [2] LN2's backward means
  const float *st1 = stats, *st2 = stats + 2 * N, *st3 = stats + 4 * N;
  float tp[9], tacc[10], sc1[kTPer], bi1[kTPer], ds[kTPer], db[kTPer];
#pragma unroll
  for (int t = 0; t < 9; ++t)
    tp[t] = tl.on ? taps[static_cast<long>(t) * C + tl.c0 + tl.lane] : 0.f;
#pragma unroll
  for (int t = 0; t < 10; ++t) tacc[t] = 0.f;
#pragma unroll
  for (int m = 0; m < kTPer; ++m) {
    const long a = m < nm ? tl.off(0, tl.row, tl.j(m)) : 0;
    sc1[m] = m < nm ? s1[a] : 0.f;
    bi1[m] = m < nm ? b1[a] : 0.f;
    ds[m] = db[m] = 0.f;
  }
  for (long n = blockIdx.z; n < N; n += G) {
    const float m1 = st1[2 * n], r1 = st1[2 * n + 1], m2 = st2[2 * n], r2 = st2[2 * n + 1];
    const float ma = st3[2 * n], mb = st3[2 * n + 1];
    stage_z1(tl, x, s1, b1, n, m1, r1, z1s);
    for (int s = tl.j0; s < 3 * W; s += kTWarps) {
      const int rr = s / W, jj = s - rr * W, r = tl.row + rr - 1;
      float d = 0.f;
      if (tl.on && r >= 0 && r < tl.H) {
        const long a = tl.off(0, r, jj);
        float xh;
        const float da = dwt_da2(tl, z2, g, s2[a], b2[a], n, r, jj, m2, r2, drop, seed, xh);
        d = (da * s2[a] - ma - xh * mb) * r2;
      }
      dzs[s * kTCh + tl.lane] = d;
    }
    __syncthreads();
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int m = 0; m < kTPer; ++m)
      if (m < nm) {
        const int jj = tl.j(m);
        const float dz = dzs[(W + jj) * kTCh + tl.lane];
        tacc[9] += dz;
        float t1 = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int jc = jj + dx - 1, jt = jj + 1 - dx;
            if (jc >= 0 && jc < W)
              tacc[dy * 3 + dx] = fmaf(z1s[(dy * W + jc) * kTCh + tl.lane], dz, tacc[dy * 3 + dx]);
            if (jt >= 0 && jt < W)
              t1 = fmaf(dzs[((2 - dy) * W + jt) * kTCh + tl.lane], tp[dy * 3 + dx], t1);
          }
        const long o = tl.off(n, tl.row, jj);
        const float xh = (to_f32(x[o]) - m1) * r1;
        const float d1 = t1 * vptr_gelu::gelu_grad(xh * sc1[m] + bi1[m]);
        da1[o] = d1;
        ds[m] = fmaf(d1, xh, ds[m]);
        db[m] += d1;
        const float dxh = d1 * sc1[m];
        v[0] += dxh;
        v[1] = fmaf(dxh, xh, v[1]);
      }
    block_sum(v, red);   // also: every read of the staged rows precedes the next sample's writes
    if (threadIdx.x == 0) {
      part[tl.part(n)] = v[0];
      part[tl.part(n) + 1] = v[1];
    }
  }
  const long hwc = static_cast<long>(HW) * C;
  float* gp = gpart + static_cast<long>(blockIdx.z) * 4 * hwc;
#pragma unroll
  for (int m = 0; m < kTPer; ++m)
    if (m < nm) {
      const long a = tl.off(0, tl.row, tl.j(m));
      gp[a] = ds[m];
      gp[hwc + a] = db[m];
    }
#pragma unroll
  for (int t = 0; t < 10; ++t) tred[t][tl.j0][tl.lane] = tacc[t];
  __syncthreads();
  if (tl.j0 == 0 && tl.on)
    for (int t = 0; t < 10; ++t) {
      float s = 0.f;
      for (int w = 0; w < kTWarps; ++w) s += tred[t][w][tl.lane];
      tpart[((static_cast<long>(blockIdx.z) * tl.H + tl.row) * 10 + t) * C + tl.c0 + tl.lane] = s;
    }
}

// 6. dx = (da1 s1 - mean(da1 s1) - xhat1 mean(da1 s1 xhat1)) rstd1 (grid:
// t_cols(C), H, N; st4: LN1's backward means)
template <typename T>
__global__ void __launch_bounds__(kTThreads)
dwt_dx_kernel(const T* __restrict__ x, const float* __restrict__ da1,
              const float* __restrict__ s1, const float* __restrict__ st1,
              const float* __restrict__ st4, T* __restrict__ dx, int HW, int W, int C) {
  const TTile tl(W, HW, C);
  if (!tl.on) return;
  const long n = blockIdx.z;
  const float m1 = st1[2 * n], r1 = st1[2 * n + 1], ma = st4[2 * n], mb = st4[2 * n + 1];
  for (int m = 0; m < tl.mine(); ++m) {
    const int jj = tl.j(m);
    const long o = tl.off(n, tl.row, jj);
    const float xh = (to_f32(x[o]) - m1) * r1;
    dx[o] = from_f32<T>((da1[o] * s1[tl.off(0, tl.row, jj)] - ma - xh * mb) * r1);
  }
}

// 7. ds1, db1, ds2, db2 (the groups' gpart (G, 4, HW, C) in group order);
// dtaps (9, C) and ddwb (C) (tpart (G, H, 10, C): groups in order, rows in
// order within each)
__global__ void dwt_sum_kernel(const float* __restrict__ gpart, const float* __restrict__ tpart,
                               float* __restrict__ ds1, float* __restrict__ db1,
                               float* __restrict__ ds2, float* __restrict__ db2,
                               float* __restrict__ dtaps, float* __restrict__ ddwb, int G, int H,
                               long hwc, int C) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < 4 * hwc) {
    const int k = static_cast<int>(i / hwc);
    const long e = i - k * hwc;
    float acc = 0.f;
    for (int gi = 0; gi < G; ++gi) acc += gpart[(static_cast<long>(gi) * 4 + k) * hwc + e];
    float* outs[4] = {ds1, db1, ds2, db2};
    outs[k][e] = acc;
  } else if (i < 4 * hwc + 10L * C) {
    const int kk = static_cast<int>(i - 4 * hwc), t = kk / C, c = kk - t * C;
    float acc = 0.f;
    for (int gi = 0; gi < G; ++gi)
      for (int r = 0; r < H; ++r) acc += tpart[((static_cast<long>(gi) * H + r) * 10 + t) * C + c];
    (t < 9 ? dtaps[kk] : ddwb[c]) = acc;
  }
}

// Steps 0 and 1 of either direction: 0, x's moments into part; 1 (st1:
// LN1's (mean, rstd) a sample), z2 and its moments into part.
template <typename T>
cudaError_t dwt_z2_step(int step, const T* x, const float* taps, const float* dwb,
                        const float* s1, const float* b1, const float* st1, float* z2,
                        float* part, int N, int HW, int W, int C, cudaStream_t s) {
  const dim3 grid(t_cols(C), HW / W, N);
  if (step == 0)
    dwt_moments_kernel<T><<<grid, kTThreads, 0, s>>>(x, part, HW, W, C);
  else
    dwt_conv_kernel<T><<<grid, kTThreads, 3 * W * kTCh * sizeof(float), s>>>(
        x, taps, dwb, s1, b1, st1, z2, part, HW, W, C);
  return cudaGetLastError();
}

// tiled.cuh's tiled_stats_kernel for tiles of two sizes (a tensor-parallel
// share's partial tile): the T tiles run in groups of `period`, each
// group's last tile holding `last` values and the others cnt. Chan's merge
// weighs each tile by its count n_t: mean = sum_t n_t mean_t / n, M2 =
// sum_t M2_t + n_t (mean_t - mean)^2 over the sample's n = sum_t n_t
// values; kTSums divides the sums by n. A separate kernel, so that the
// calls of equal tiles keep their bits.
__global__ void __launch_bounds__(kTThreads)
dwt_stats_uneven_kernel(const float* __restrict__ part, float* __restrict__ out, int T,
                        int period, float cnt, float last, float eps, int mode) {
  __shared__ float red[2][kTWarps];
  const float* p = part + 2L * T * blockIdx.x;
  const float n =
      static_cast<float>(T / period) * (static_cast<float>(period - 1) * cnt + last);
  auto count = [&](int t) { return t % period == period - 1 ? last : cnt; };
  float v[2] = {0.f, 0.f};
  for (int t = threadIdx.x; t < T; t += kTThreads) {
    if (mode == kTSums) {
      v[0] += p[2 * t];
      v[1] += p[2 * t + 1];
    } else {
      v[0] = fmaf(count(t), p[2 * t], v[0]);
    }
  }
  block_sum(v, red);
  if (mode == kTSums) {
    if (threadIdx.x == 0) {
      out[2 * blockIdx.x] = v[0] / n;
      out[2 * blockIdx.x + 1] = v[1] / n;
    }
    return;
  }
  const float mean = v[0] / n;
  float m2[1] = {0.f};
  for (int t = threadIdx.x; t < T; t += kTThreads) {
    const float d = p[2 * t] - mean;
    m2[0] += fmaf(count(t) * d, d, p[2 * t + 1]);
  }
  block_sum(m2, red);
  if (threadIdx.x == 0) {
    out[2 * blockIdx.x] = mean;
    out[2 * blockIdx.x + 1] = rsqrtf(m2[0] / n + eps);
  }
}

// Launches dwt_stats_uneven_kernel over N samples (T a multiple of period).
cudaError_t dwt_stats_uneven(const float* part, float* out, int N, int T, int period,
                             float cnt, float last, float eps, int mode, cudaStream_t s) {
  if (period < 1 || T % period) return cudaErrorInvalidValue;
  dwt_stats_uneven_kernel<<<N, kTThreads, 0, s>>>(part, out, T, period, cnt, last, eps,
                                                  mode);
  return cudaGetLastError();
}

// A sample's statistics (kTMoments) or sums' means (kTSums) into out (N, 2)
// from part (N, T, 2) of T tiles of W x 32 values; or, where the tiles
// are shares' of C channels each (C not a multiple of 32), of shares
// whose last tile of a grid row holds W (C mod 32) values: T is then grid
// rows x shares x t_cols(C), in that order.
cudaError_t dwt_merge(const float* part, float* out, int N, int T, int W, int C, float eps,
                      int mode, cudaStream_t s) {
  if (C % kTCh == 0)
    return tiled_stats(part, out, N, T, static_cast<float>(W * kTCh), eps, mode, s);
  return dwt_stats_uneven(part, out, N, T, t_cols(C), static_cast<float>(W * kTCh),
                          static_cast<float>(W * (C % kTCh)), eps, mode, s);
}

// The forward (steps 0-1, the statistics after each) into z2, part and
// stats (2 x N x 2: LN1's, LN2's (mean, rstd)) of the caller; shared with
// the backward, which recomputes it.
template <typename T>
cudaError_t dwt_to_z2(const T* x, const float* taps, const float* dwb, const float* s1,
                      const float* b1, float* z2, float* part, float* stats, int N, int HW,
                      int W, int C, float eps, cudaStream_t s) {
  const int T_ = t_cols(C) * (HW / W);
  VPTR_TRY(dwt_z2_step<T>(0, x, taps, dwb, s1, b1, stats, z2, part, N, HW, W, C, s));
  VPTR_TRY(dwt_merge(part, stats, N, T_, W, C, eps, kTMoments, s));
  VPTR_TRY(dwt_z2_step<T>(1, x, taps, dwb, s1, b1, stats, z2, part, N, HW, W, C, s));
  return dwt_merge(part, stats + 2 * N, N, T_, W, C, eps, kTMoments, s);
}

}  // namespace
