// The "tiled" route of the fused 1x1 conv + whole-sample LayerNorm +
// GELU, forward (conv_ln_gelu.cu, kernel #11) and backward
// (conv_ln_gelu_bwd.cu, #12), for samples past the cluster route's 64
// positions: nar_kth_128's 16 x 16 latents (HW = 256), whose u at fc1 is
// 256 x 2112 f32 (2.2 MB) a sample, where the cluster route keeps a
// sample's u in one cluster's registers. The arithmetic is conv_ln.cuh's.
//
// The design: u = x W goes to f32 scratch in device memory, R = N HW rows
// at once (bf16: wg_rows.cuh's wgmma row-tiled product with W MN-major as
// stored, the one #1/#3/#5/#6 run; f32: tile_ops.cuh's FMA gemm); then a
// block a (sample, position row) of Cout values writes that row's partial
// moments (mean and centred M2 of u + b, two passes over the row), which
// tiled.cuh's tiled_stats_kernel merges per sample in row order (Chan's
// formula); then a block a row again for the epilogue. The backward
// recomputes u and the statistics the same way, takes LN's two backward
// sums (dz, dz zhat) per row and merges them per sample, writes du (its
// bf16 hi and lo halves, or f32) and a sample's da zhat, da and du, and
// hands them to the cluster route's second and third passes (dx on the
// row-tiled product, dW = x^T du on wg_dw.cuh's, the sums over the samples
// in sample order). No atomics: the same bits on every run.
//
// Under tensor parallelism the route runs as separate steps with the
// model group's exchanges between them (conv_ln_gelu.cu's
// vptr_conv_ln_gelu_tiled_step / _merge, conv_ln_gelu_bwd.cu's
// vptr_conv_ln_gelu_bwd_tiled_step; ops/conv_ln_gelu.py drives them):
// fc1 column-parallel, each rank's per-row partials over its Cout / M
// channels gathered and merged as T = HW M partials of Cout / M values;
// fc2 row-parallel, each rank's partial u = x_m W_m gathered and summed in
// rank order by the moments kernel, the rest the whole call's on every
// rank.
//
// What bounds it on an H100: operations in the products (2 R Cin Cout
// flops each), bytes in the passes (u in f32 written once and read three
// times forward, five backward). Made right and simple first: its time
// stands in PERF.md beside its bound.
#pragma once

#include "tiled.cuh"
#include "wg_rows.cuh"

namespace {

constexpr int kClnTiledMaxHW = 4096;
constexpr int kClnTiledMaxN = 65535;   // samples: a grid dimension

// The shapes the tiled route takes: HW a multiple of 16 up to 4096, Cin
// and Cout multiples of 16.
bool cln_tiled_ok(int HW, int Cin, int Cout) {
  return HW >= 16 && HW <= kClnTiledMaxHW && HW % 16 == 0 && Cin >= 16 && Cin % 16 == 0 &&
         Cout >= 16 && Cout % 16 == 0;
}

// The route of (HW, Cin, Cout): 0 = cluster (HW <= 64, Cout split into at
// most eight slabs), 1 = tiled (every other shape cln_tiled_ok takes), -1
// = none.
int cln_route(int HW, int Cin, int Cout) {
  if (cln_shape_ok(1, HW, Cin, Cout)) return 0;
  return cln_tiled_ok(HW, Cin, Cout) ? 1 : -1;
}

// u (R, Cout) f32 = x (R, Cin) W (Cin, Cout) in T.
template <typename T>
int cln_u_product(const void* x, const void* w, float* u, int R, int Cin, int Cout,
                  cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    RwMaps m;
    RwWork wk{};
    if (int err = rw_amap(&m.a[0][0], x, R, Cin, Cin)) return err;
    if (int err = rw_bmap(&m.b[0], w, Cin, Cout, Cout, true)) return err;
    wk.job[0] = {u, nullptr, 1.f, nullptr, Cin};
    wk.jobs = 1, wk.rows = R, wk.cols = Cout, wk.group = 1;
    return launch_rows<1, true, kRwF32>(m, wk, s);
  } else {
    GemmBatch gb{};
    gb.M = R, gb.N = Cout, gb.K = Cin, gb.lda = Cin, gb.ldb = Cout, gb.ldo = Cout;
    gb.group = 1, gb.ksplit = 1, gb.kchunk = Cin;
    gb.job[0] = {x, w, u, nullptr, 1.f, nullptr, nullptr, 0};
    return gemm<float, false, float, false, float, kF32>(gb, 1, s);
  }
}

// The row's (mean, M2) of u + b (grid: HW, N; part (N, HW, 2)). With
// `parts` (M partial products of N HW x Cout, `plane` apart, in rank order:
// a row-parallel call's), u is first written as their sum, the planes
// added in rank order, so every rank that holds the same parts writes the
// same bits.
__global__ void __launch_bounds__(kTThreads)
clnt_moments_kernel(float* __restrict__ u, const float* __restrict__ parts, int M, long plane,
                    const float* __restrict__ b, float* __restrict__ part, int HW, int Cout) {
  __shared__ float red[1][kTWarps];
  const long row = static_cast<long>(blockIdx.y) * HW + blockIdx.x;
  float* ur = u + row * Cout;
  float s[1] = {0.f};
  for (int c = threadIdx.x; c < Cout; c += kTThreads) {
    float v;
    if (parts) {
      const float* p = parts + row * Cout + c;
      v = p[0];
      for (int m = 1; m < M; ++m) v += p[m * plane];
      ur[c] = v;
    } else {
      v = ur[c];
    }
    s[0] += v + b[c];
  }
  block_sum(s, red);
  const float mean = s[0] / static_cast<float>(Cout);
  float q[1] = {0.f};
  for (int c = threadIdx.x; c < Cout; c += kTThreads) {
    const float d = ur[c] + b[c] - mean;
    q[0] = fmaf(d, d, q[0]);
  }
  block_sum(q, red);
  if (threadIdx.x == 0) {
    part[2 * row] = mean;
    part[2 * row + 1] = q[0];
  }
}

// Launches clnt_moments_kernel over the N HW rows (parts: null, or M
// partial products to sum into u first).
cudaError_t clnt_moments(float* u, const float* parts, int M, const float* b, float* part, int N,
                         int HW, int Cout, cudaStream_t s) {
  clnt_moments_kernel<<<dim3(HW, N), kTThreads, 0, s>>>(
      u, parts, M, static_cast<long>(N) * HW * Cout, b, part, HW, Cout);
  return cudaGetLastError();
}

// The forward's epilogue: out = gelu((u + b - mean) rstd scale + bias2),
// rounded to T (grid: HW, N).
template <typename T>
__global__ void __launch_bounds__(kTThreads)
clnt_out_kernel(const float* __restrict__ u, const float* __restrict__ b,
                const float* __restrict__ scale, const float* __restrict__ bias2,
                const float* __restrict__ st, T* __restrict__ out, int HW, int Cout) {
  const long n = blockIdx.y, row = n * HW + blockIdx.x, a0 = static_cast<long>(blockIdx.x) * Cout;
  const float mean = st[2 * n], rstd = st[2 * n + 1];
  for (int c = threadIdx.x; c < Cout; c += kTThreads) {
    const float zh = (u[row * Cout + c] + b[c] - mean) * rstd;
    out[row * Cout + c] = from_f32<T>(vptr_gelu::gelu(zh * scale[a0 + c] + bias2[a0 + c]));
  }
}

// The backward's (zhat, da) at element c of the block's row.
template <typename T>
__device__ __forceinline__ float clnt_da(const float* __restrict__ u,
                                         const float* __restrict__ b,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias2,
                                         const T* __restrict__ g, long o, long a, int c,
                                         float mean, float rstd, float& zh) {
  zh = (u[o] + b[c] - mean) * rstd;
  return to_f32(g[o]) * vptr_gelu::gelu_grad(zh * scale[a] + bias2[a]);
}

// LN's backward sums of the row, (sum dz, sum dz zhat) with dz = da scale,
// into part (grid: HW, N).
template <typename T>
__global__ void __launch_bounds__(kTThreads)
clnt_dz_sums_kernel(const float* __restrict__ u, const float* __restrict__ b,
                    const float* __restrict__ scale, const float* __restrict__ bias2,
                    const T* __restrict__ g, const float* __restrict__ st,
                    float* __restrict__ part, int HW, int Cout) {
  __shared__ float red[2][kTWarps];
  const long n = blockIdx.y, row = n * HW + blockIdx.x, a0 = static_cast<long>(blockIdx.x) * Cout;
  const float mean = st[2 * n], rstd = st[2 * n + 1];
  float v[2] = {0.f, 0.f};
  for (int c = threadIdx.x; c < Cout; c += kTThreads) {
    float zh;
    const float dz =
        clnt_da(u, b, scale, bias2, g, row * Cout + c, a0 + c, c, mean, rstd, zh) * scale[a0 + c];
    v[0] += dz;
    v[1] = fmaf(dz, zh, v[1]);
  }
  block_sum(v, red);
  if (threadIdx.x == 0) {
    part[2 * row] = v[0];
    part[2 * row + 1] = v[1];
  }
}

// du = (dz - m1 - zhat m2) rstd (st2: the sample's (m1, m2)) into du (bf16:
// its hi and lo halves, `half` elements apart; f32: itself), and the
// sample's da zhat, da and du into pds, pdt, pdb (grid: HW, N).
template <typename T>
__global__ void __launch_bounds__(kTThreads)
clnt_du_kernel(const float* __restrict__ u, const float* __restrict__ b,
               const float* __restrict__ scale, const float* __restrict__ bias2,
               const T* __restrict__ g, const float* __restrict__ st,
               const float* __restrict__ st2, T* __restrict__ du, float* __restrict__ pds,
               float* __restrict__ pdt, float* __restrict__ pdb, int HW, int Cout, long half) {
  const long n = blockIdx.y, row = n * HW + blockIdx.x, a0 = static_cast<long>(blockIdx.x) * Cout;
  const float mean = st[2 * n], rstd = st[2 * n + 1], m1 = st2[2 * n], m2 = st2[2 * n + 1];
  for (int c = threadIdx.x; c < Cout; c += kTThreads) {
    const long o = row * Cout + c;
    float zh;
    const float da = clnt_da(u, b, scale, bias2, g, o, a0 + c, c, mean, rstd, zh);
    const float d = (da * scale[a0 + c] - m1 - zh * m2) * rstd;
    if constexpr (std::is_same<T, bf16>::value) {
      const bf16 hi = __float2bfloat16_rn(d);
      du[o] = hi;
      du[half + o] = __float2bfloat16_rn(d - __bfloat162float(hi));
    } else {
      du[o] = d;
    }
    pds[o] = da * zh;
    pdt[o] = da;
    pdb[o] = d;
  }
}

}  // namespace
