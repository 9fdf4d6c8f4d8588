// Backward of the fused 1x1 conv + whole-sample LayerNorm + GELU
// (conv_ln_gelu.cu) on Hopper (sm_90a). Given the output cotangent g (N, HW,
// Cout), recompute the forward and compute dx, dW, db, d(scale), d(bias2):
//     da = g gelu'(a),  a = zhat scale + bias2
//     ds = sum_n da zhat,  dt = sum_n da                       (HW, Cout)
//     du = (dz - mean(dz) - zhat mean(dz zhat)) rstd,  dz = da scale
//     dW = x^T du,  db = sum du,  dx = du W^T                 (f32 operands)
// dx in T, dW in W's dtype T (the JAX route's weight gradient is rounded to
// bf16 before it reaches the f32 parameter), db, ds, dt f32.
//
// Replaces the TPU kernel vptr_tpu/ops/fused_conv_ln.py::_backward
// (_bwd_kernel at :97, pl.pallas_call at :196).
//
// What bounds it on an H100: operations. Three S x Cin x Cout products (the
// recomputed u, dW, dx) are 6 S Cin Cout flops: 81.2 GFLOP at S = 12,160,
// 528 -> 2112 (0.082 ms at 989 TFLOP/s), against ~84 MB the result needs.
// du reaches the tensor cores as bf16 hi + lo halves (16 mantissa bits, as
// JAX computes both products in f32), so dx and dW take twice their flops.
//
// The TPU kernel walked its sample grid in order and summed dW, db, ds, dt
// in place across grid steps. Blocks on the card run in parallel, so the
// work is three passes (no float atomics: every sum over samples is a K
// loop or a fixed-order second pass, so the gradients are the same on every
// run):
//   1. the sample pass: du to device memory (f32, or for bf16 its hi and lo
//      halves) and da zhat, da, du into (HW, Cout) partials of sample
//      groups (f32: a group's samples added in place, each element by the
//      one thread that owns it, the first sample writing without reading;
//      bf16: a group a sample, stored);
//   2. dx = du W^T and dW = x^T du with K = S split in chunks of about 1024
//      rows, summed in chunk order and cast to T;
//   3. ds, dt and the per-position db summed over the groups in order, then
//      db over the HW positions.
//
// bf16, the design. Pass 1 is the forward's wgmma sample kernel
// (conv_ln_wg.cuh): persistent clusters of G blocks (6 x 352 columns at
// fc1, 3 x 176 at fc2), the recomputed u = x W + b of a sample by a column
// group in a warpgroup's registers (m64n176k16, both operands K-major: the
// wrapper passes W^T too), fed by a TMA ring that runs ahead into the next
// sample; then, on the 88 accumulators a thread: the bias, mean and rstd
// (two cluster sums); a sweep that turns u into zhat in place, stores the
// sample's da and sums dz and dz zhat (the third cluster sum); a sweep that
// reads da back (from L2), forms du and stores du's hi and lo halves and
// the sample's da zhat and du (f32): stores with no loads behind them (a
// group's partial sums, read and written back at every sample, keep the
// sweep waiting on L2), streaming where nothing reads them soon, so that W
// stays in L2; the sweeps' loads go kEpiJ column octets at a time. The
// sums go through distributed shared memory on mbarriers, in rank order,
// with no cluster barrier. dx = du W^T is the shared product kernel with
// du's hi and lo halves as two terms of the same accumulators: both
// operands K-major as stored (du rows are Cout-contiguous, W (Cin, Cout)
// too), tiles of a sample's 64 rows by up to two 176-column groups of Cin,
// persistent walkers. dW = x^T du has K = S, and both operands lie
// MN-major in memory (x rows are Cin-contiguous, du rows Cout-contiguous):
// its wgmma reads them so, with the transpose flags and MN-major
// descriptors (wg_dw_kernel, in wg_dw.cuh), split-K over S in fixed
// chunks summed in order.
//
// f32 runs on the CUDA cores: pass 1 is one cluster a sample group walking
// its samples with conv_ln.cuh's slab in shared memory, the products are
// tile_ops.cuh's FMA gemm.
//
// That is the "cluster" route, for HW <= 64. Past it (nar_kth_128's HW
// 256) the "tiled" route replaces pass 1 (conv_ln_tiled.cuh: u recomputed
// into f32 scratch, the statistics and LN's backward sums from per-row
// partials, then du, a group a sample in both dtypes) and runs passes 2
// and 3 as above, dx on wg_rows.cuh's row-tiled product in bf16; it is
// also exported step by step (vptr_conv_ln_gelu_bwd_tiled_step), for a
// tensor-parallel rank's share with the exchanges between the steps.

#include <cstdio>

#include "conv_ln_tiled.cuh"
#include "wg_dw.cuh"

// Everything the backward needs; mirrored by _BwdArgs in
// vptr_tpu_torch/ops/conv_ln_gelu.py. Inputs (wt: W^T (Cout, Cin), bf16
// on the cluster route only), outputs, then the caller-allocated scratch
// (du: S x Cout f32, or 2 x S x Cout bf16 [hi, lo] when T is bf16; pds,
// pdt, pdb: groups x HW x Cout f32, groups = N for bf16 and on the tiled
// route; dbfull: HW x Cout f32; wpart: ksplit x Cin x Cout f32; partial:
// parts(HW) x Cout f32; the tiled route's u: S x Cout, tpart: N x HW x 2,
// tstats: 2 x N x 2, f32).
struct ClnBwdArgs {
  const void *x, *w, *wt, *b, *scale, *bias2, *g;
  void *dx, *dw, *db, *ds, *dt;
  void *du, *pds, *pdt, *pdb, *dbfull, *wpart, *partial;
  void *u, *tpart, *tstats;
  int N, HW, Cin, Cout, dtype, groups, ksplit;
  float eps;
};

namespace {

// ---- the f32 route's pass 1

// Sample groups (clusters of pass 1) for N samples and G blocks a sample:
// about two resident blocks an SM (132 SMs), at most N.
int cln_groups(int N, int G) {
  const int g = 2 * 132 / G;
  return N < g ? N : g;
}

__global__ void __launch_bounds__(kClnThreads)
conv_ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, const float* __restrict__ scale,
                   const float* __restrict__ bias2, const float* __restrict__ g,
                   float* __restrict__ du, float* __restrict__ pds, float* __restrict__ pdt,
                   float* __restrict__ pdb, int N, int groups, int HW, int Cin, int Cout,
                   int SW, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem_cln[];
  __shared__ ClnRed red;
  const int G = static_cast<int>(cluster.num_blocks());
  const int c0 = static_cast<int>(cluster.block_rank()) * SW;
  const int grp = blockIdx.x / G;
  const float* slab = reinterpret_cast<const float*>(smem_cln);
  const int lds = SW + 4;
  const float inv_n = 1.f / (static_cast<float>(HW) * Cout);
  const long plane = static_cast<long>(HW) * Cout;
  float* ps = pds + grp * plane;
  float* pt = pdt + grp * plane;
  float* pb = pdb + grp * plane;
  for (int n = grp; n < N; n += groups) {
    const bool first = n == grp;
    float mean, rstd;
    sample_u(x + n * static_cast<long>(HW) * Cin, w, b, HW, Cin, Cout, c0, SW, eps, smem_cln,
             red, cluster, mean, rstd);
    const float* gn = g + n * plane;
    float v[2] = {0.f, 0.f};
    for (int e = threadIdx.x; e < HW * SW; e += kClnThreads) {
      const int r = e / SW, c = e - r * SW;
      const long o = static_cast<long>(r) * Cout + c0 + c;
      const float zh = (slab[r * lds + c] - mean) * rstd;
      const float sc = scale[o];
      const float dz = gn[o] * vptr_gelu::gelu_grad(zh * sc + bias2[o]) * sc;
      v[0] += dz;
      v[1] = fmaf(dz, zh, v[1]);
    }
    cluster_sum(v, red, 2, cluster);
    const float m1 = v[0] * inv_n, m2 = v[1] * inv_n;
    for (int e = threadIdx.x; e < HW * SW; e += kClnThreads) {
      const int r = e / SW, c = e - r * SW;
      const long o = static_cast<long>(r) * Cout + c0 + c;
      const float zh = (slab[r * lds + c] - mean) * rstd;
      const float sc = scale[o];
      const float da = gn[o] * vptr_gelu::gelu_grad(zh * sc + bias2[o]);
      const float d = (da * sc - m1 - zh * m2) * rstd;
      du[(n * static_cast<long>(HW) + r) * Cout + c0 + c] = d;
      ps[o] = (first ? 0.f : ps[o]) + da * zh;
      pt[o] = (first ? 0.f : pt[o]) + da;
      pb[o] = (first ? 0.f : pb[o]) + d;
    }
    __syncthreads();                   // the next sample's product overwrites the slab
  }
  cluster.sync();                      // the other blocks are done reading red
}

// ---- the bf16 route's pass 1 on wgmma

// Samples a block takes at once for CW column groups: two at fc2's one
// group (two warpgroups and a feeder), one at fc1's two (the sweeps' loads
// want more than the 128 registers four warpgroups leave). Only fc2's
// blocks have a feeder: with one at fc1 ptxas allows 168 registers and the
// sweeps spill, without one 255.
__host__ __device__ constexpr int bwd_samples(int cw) { return cw <= 1 ? 2 : 1; }
__host__ __device__ constexpr bool bwd_feeder(int cw) { return cw == 1; }

// Column octets (each two float pairs a thread, rows r and r + 8) whose
// loads the epilogue's sweeps issue together, and no more: the compiler
// would otherwise hoist many octets' loads at once and spill.
constexpr int kEpiJ = 2;

// Keeps the compiler from moving memory operations across this point.
__device__ __forceinline__ void compiler_fence() { asm volatile("" ::: "memory"); }

// v, opaque to the compiler: the addresses made from it are formed anew at
// every sample. (Otherwise the addresses of the affines, the same at every
// sample, are hoisted out of the sample loop, 44 pointers each, and the
// registers they hold spill.)
__device__ __forceinline__ long opaque(long v) {
  asm volatile("" : "+l"(v));
  return v;
}

// The sample kernel (see the note at the top); warpgroup w computes sample
// w / CW of the group at column group w % CW.
template <int CW, int S>
__global__ void __launch_bounds__(wg_threads(CW, S, bwd_feeder(CW)), 1)
conv_ln_bwd_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const float* __restrict__ b,
                      const float* __restrict__ scale, const float* __restrict__ bias2,
                      const bf16* __restrict__ g, bf16* __restrict__ du,
                      float* __restrict__ pds, float* __restrict__ pdt, float* __restrict__ pdb,
                      int N, int HW, int Cin, int Cout, int SW, int stages, float eps) {
  extern __shared__ unsigned char smem_wg[];
  __shared__ WgRing ring;
  __shared__ WgRed<4 * CW * S, 4> red;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank()), c0 = rank * SW;
  const long plane = static_cast<long>(HW) * Cout, half = static_cast<long>(N) * plane;
  const float inv_n = 1.f / static_cast<float>(plane);
  auto epilogue = [&](float (&acc)[kWgAcc], int n, const WgPlace& p, int& count) {
    const bool rows = 16 * p.q < HW && n + p.s < N;
    float mean, rstd;
    wg_stats(acc, b + opaque(0), p, rows, c0, SW, HW, Cout, eps, red, count, G, rank, mean, rstd);
    const long o = opaque(static_cast<long>(p.r) * Cout + c0 + p.cb);   // (r, c0 + cb)
    const long po = static_cast<long>(n + p.s) * plane + o;   // the sample's (r, c0 + cb)
    // Each sweep takes kEpiJ column octets at a time: their loads first,
    // all in flight together, then the arithmetic and the stores; the
    // compiler may not move the next octets' loads above the fence.
    auto live = [&](int j) { return j < kWgN / 8 && p.c * kWgN + 8 * j < SW; };
    auto at = [&](int j, int h) { return static_cast<long>(8 * h) * Cout + 8 * j; };
    // u -> zhat in place, da (stored: plain, so that it stays in L2 for the
    // next sweep), the sums of dz = da scale and dz zhat
    float s1 = 0.f, s2 = 0.f;
    if (rows) {
#pragma unroll
      for (int j0 = 0; j0 < kWgN / 8; j0 += kEpiJ) {
        float2 sc[kEpiJ][2], bs[kEpiJ][2], gg[kEpiJ][2];
#pragma unroll
        for (int jj = 0; jj < kEpiJ; ++jj)
          if (live(j0 + jj))
#pragma unroll
            for (int h = 0; h < 2; ++h) {                 // rows r and r + 8
              const long e = o + at(j0 + jj, h);
              sc[jj][h] = __ldg(reinterpret_cast<const float2*>(scale + e));
              bs[jj][h] = __ldg(reinterpret_cast<const float2*>(bias2 + e));
              gg[jj][h] = __bfloat1622float2(
                  __ldg(reinterpret_cast<const __nv_bfloat162*>(g + po + at(j0 + jj, h))));
            }
#pragma unroll
        for (int jj = 0; jj < kEpiJ; ++jj)
          if (live(j0 + jj))
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float& z0 = acc[4 * (j0 + jj) + 2 * h];
              float& z1 = acc[4 * (j0 + jj) + 2 * h + 1];
              z0 = (z0 - mean) * rstd;
              z1 = (z1 - mean) * rstd;
              const float2 c = sc[jj][h], a = bs[jj][h], d = gg[jj][h];
              const float da0 = d.x * vptr_gelu::gelu_grad(z0 * c.x + a.x);
              const float da1 = d.y * vptr_gelu::gelu_grad(z1 * c.y + a.y);
              *reinterpret_cast<float2*>(pdt + po + at(j0 + jj, h)) = make_float2(da0, da1);
              const float dz0 = da0 * c.x, dz1 = da1 * c.y;
              s1 += dz0 + dz1;
              s2 = fmaf(dz0, z0, fmaf(dz1, z1, s2));
            }
        compiler_fence();
      }
    }
    float t[4];
    t[0] = p.s ? 0.f : s1;
    t[1] = p.s ? 0.f : s2;
    t[2] = p.s ? s1 : 0.f;
    t[3] = p.s ? s2 : 0.f;
    wg_cluster_sum(t, red, count, G, rank);
    if (!rows) return;
    const float m1 = (p.s ? t[2] : t[0]) * inv_n, m2 = (p.s ? t[3] : t[1]) * inv_n;
    // du; its halves and the sample's da zhat and du stored, streaming
    // (evict-first: W, which every sample's product reads, stays in L2)
#pragma unroll
    for (int j0 = 0; j0 < kWgN / 8; j0 += kEpiJ) {
      float2 sc[kEpiJ][2], da[kEpiJ][2];
#pragma unroll
      for (int jj = 0; jj < kEpiJ; ++jj)
        if (live(j0 + jj))
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sc[jj][h] = __ldg(reinterpret_cast<const float2*>(scale + o + at(j0 + jj, h)));
            da[jj][h] = *reinterpret_cast<const float2*>(pdt + po + at(j0 + jj, h));
          }
#pragma unroll
      for (int jj = 0; jj < kEpiJ; ++jj)
        if (live(j0 + jj))
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long e = po + at(j0 + jj, h);
            const float z0 = acc[4 * (j0 + jj) + 2 * h], z1 = acc[4 * (j0 + jj) + 2 * h + 1];
            const float2 c = sc[jj][h], a = da[jj][h];
            const float d0 = (a.x * c.x - m1 - z0 * m2) * rstd;
            const float d1 = (a.y * c.y - m1 - z1 * m2) * rstd;
            const __nv_bfloat162 dh = __floats2bfloat162_rn(d0, d1);
            const float2 dhf = __bfloat1622float2(dh);
            __stcs(reinterpret_cast<__nv_bfloat162*>(du + e), dh);
            __stcs(reinterpret_cast<__nv_bfloat162*>(du + half + e),
                   __floats2bfloat162_rn(d0 - dhf.x, d1 - dhf.y));
            __stcs(reinterpret_cast<float2*>(pds + e), make_float2(a.x * z0, a.y * z1));
            __stcs(reinterpret_cast<float2*>(pdb + e), make_float2(d0, d1));
          }
      compiler_fence();
    }
  };
  wg_sample_loop<CW, S, bwd_feeder(CW)>(&xmap, &wmap, smem_wg, ring, red, N, Cin, SW, stages,
                                        epilogue);
}

// Clusters of the bf16 pass 1 for N samples: as many as the card holds, at
// most the sample groups.
template <int CW>
int pass1_clusters(int N, int Cout) {
  constexpr int S = bwd_samples(CW);
  const int G = cln_split(Cout);
  static int resident[kClnMaxCluster + 1];       // asked once for each cluster size
  if (!resident[G])
    resident[G] = resident_clusters(conv_ln_bwd_wg_kernel<CW, S>, G,
                                    wg_threads(CW, S, bwd_feeder(CW)), wg_smem(CW, S));
  const int groups = (N + S - 1) / S;
  return groups < resident[G] ? groups : resident[G];
}

template <int CW>
int launch_pass1_wg(const ClnBwdArgs& a, cudaStream_t s) {
  constexpr int S = bwd_samples(CW);
  CUtensorMap xmap, wmap;
  const int err = wg_maps(&xmap, &wmap, a.x, a.wt, a.N, a.HW, a.Cin, a.Cout, S);
  if (err) return err;
  const int G = cln_split(a.Cout), clusters = pass1_clusters<CW>(a.N, a.Cout);
  if (!clusters) return cudaErrorInvalidConfiguration;
  return launch_cluster_blocks(
      conv_ln_bwd_wg_kernel<CW, S>, clusters, G, wg_threads(CW, S, bwd_feeder(CW)),
      wg_smem(CW, S), s, xmap,
      wmap, static_cast<const float*>(a.b), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.bias2), static_cast<const bf16*>(a.g), static_cast<bf16*>(a.du),
      static_cast<float*>(a.pds), static_cast<float*>(a.pdt), static_cast<float*>(a.pdb), a.N,
      a.HW, a.Cin, a.Cout, a.Cout / G, wg_stages(CW, S), a.eps);
}

// dx = du W^T on wgmma: A = du's hi and lo halves (N, HW, Cout), B^T = W
// (Cin, Cout), up to two column groups of Cin a block (with three, each
// du box serves more columns, but far_mnist's 190 samples over 132 blocks
// leave the second round mostly empty).
template <int CW>
int launch_dx_wg(const ClnBwdArgs& a, cudaStream_t s) {
  const bf16* hi = static_cast<const bf16*>(a.du);
  const bf16* lo = hi + static_cast<long>(a.N) * a.HW * a.Cout;
  CUtensorMap hmap, lmap, wmap;
  int err = wg_amap(&hmap, hi, a.N, a.HW, a.Cout, 1);
  if (!err) err = wg_amap(&lmap, lo, a.N, a.HW, a.Cout, 1);
  if (!err) err = wg_bmap(&wmap, a.w, a.Cin, a.Cout);
  if (err) return err;
  return launch_product_walkers<CW, 2>(hmap, lmap, wmap, static_cast<bf16*>(a.dx), a.N, a.HW,
                                       a.Cout, a.Cin, s);
}

int pass1_wg(const ClnBwdArgs& a, cudaStream_t s) {
  switch (wg_groups(a.Cout / cln_split(a.Cout))) {
    case 1: return launch_pass1_wg<1>(a, s);
    case 2: return launch_pass1_wg<2>(a, s);
    default: return launch_pass1_wg<3>(a, s);
  }
}

int dx_wg(const ClnBwdArgs& a, cudaStream_t s) {
  return wg_groups(a.Cin) == 1 ? launch_dx_wg<1>(a, s) : launch_dx_wg<2>(a, s);
}

// dW = x^T du (Cin x Cout, K = S in ksplit chunks) on wgmma, du's hi and
// lo halves as two terms.
int dw_wg(const ClnBwdArgs& a, cudaStream_t s) {
  const bf16* hi = static_cast<const bf16*>(a.du);
  const long half = static_cast<long>(a.N) * a.HW * a.Cout;
  return launch_dw<2>(a.x, hi, hi + half, static_cast<float*>(a.wpart), a.N * a.HW, a.Cin,
                      a.Cout, a.ksplit, s);
}

int run_bf16_products(const ClnBwdArgs& a, cudaStream_t s) {
  if (int err = pass1_wg(a, s)) return err;      // 1. du and the partials
  if (int err = dx_wg(a, s)) return err;         // 2. dx = du W^T
  return dw_wg(a, s);                            //    dW = x^T du
}

// 2. on the CUDA cores: dx = du W^T (S x Cin, K = Cout);  dW = x^T du (Cin
//    x Cout, K = S in ksplit chunks)
int f32_products(const ClnBwdArgs& a, cudaStream_t s) {
  const int S = a.N * a.HW;
  GemmBatch gb{};
  gb.M = S, gb.N = a.Cin, gb.K = a.Cout, gb.lda = a.Cout, gb.ldb = a.Cout, gb.ldo = a.Cin;
  gb.group = 1, gb.ksplit = 1, gb.kchunk = a.Cout;
  gb.job[0] = {a.du, a.w, a.dx, nullptr, 1.f, nullptr, nullptr, 0};
  VPTR_TRY((gemm<float, false, float, true, float, kF32>(gb, 1, s)));
  gb.M = a.Cin, gb.N = a.Cout, gb.K = S, gb.lda = a.Cin, gb.ldb = a.Cout, gb.ldo = a.Cout;
  gb.ksplit = a.ksplit, gb.kchunk = ((S + a.ksplit - 1) / a.ksplit + BK - 1) / BK * BK;
  gb.job[0] = {a.x, a.du, a.wpart, nullptr, 1.f, nullptr, nullptr, 0};
  return gemm<float, true, float, false, float, kPartial>(gb, 1, s);
}

int run_f32_products(const ClnBwdArgs& a, cudaStream_t s) {
  const int G = cln_split(a.Cout), SW = a.Cout / G;
  VPTR_TRY(launch_clusters(conv_ln_bwd_kernel, a.groups * G, G, cln_smem(a.HW, SW), s,  // 1.
                           static_cast<const float*>(a.x), static_cast<const float*>(a.w),
                           static_cast<const float*>(a.b), static_cast<const float*>(a.scale),
                           static_cast<const float*>(a.bias2), static_cast<const float*>(a.g),
                           static_cast<float*>(a.du), static_cast<float*>(a.pds),
                           static_cast<float*>(a.pdt), static_cast<float*>(a.pdb), a.N,
                           a.groups, a.HW, a.Cin, a.Cout, SW, a.eps));
  return f32_products(a, s);
}

// The tiled route's products: dx and dW (bf16: dx on the row-tiled
// product, du's hi and lo halves as two terms, B^T = W (Cin, Cout) as
// stored; dW as the cluster route's).
template <typename T>
int tiled_products(const ClnBwdArgs& a, cudaStream_t s) {
  if constexpr (!std::is_same<T, bf16>::value) {
    return f32_products(a, s);
  } else {
    const int R = a.N * a.HW, Cout = a.Cout;
    const bf16* hi = static_cast<const bf16*>(a.du);
    RwMaps m;
    RwWork wk{};
    int err = rw_amap(&m.a[0][0], hi, R, Cout, Cout);
    if (!err) err = rw_amap(&m.a[0][1], hi + static_cast<long>(R) * Cout, R, Cout, Cout);
    if (!err) err = rw_bmap(&m.b[0], a.w, Cout, a.Cin, Cout, false);
    if (err) return err;
    wk.job[0] = {a.dx, nullptr, 1.f, nullptr, Cout};
    wk.jobs = 1, wk.rows = R, wk.cols = a.Cin, wk.group = 1;
    if ((err = launch_rows<2, false, kRwBf16>(m, wk, s))) return err;
    return dw_wg(a, s);
  }
}

template <typename T>
int sums(const ClnBwdArgs& a, cudaStream_t s);

// A step of the tiled route (tstats (2, N, 2): the forward's (mean, rstd),
// then LN's two backward means): 0, u = x W recomputed (f32, without b);
// 1, each row's partial moments of u + b into tpart; 2, each row's LN
// backward sums (dz, dz zhat) into tpart, from tstats[0]; 3, du and the
// samples' da zhat, da, du, from tstats[0] and [1]; 4, dx, dW and the sums
// over the samples. The merges (tiled_stats) fill tstats after steps 1
// and 2.
template <typename T>
int tiled_bwd_step(int step, const ClnBwdArgs& a, cudaStream_t s) {
  const int N = a.N, HW = a.HW, Cout = a.Cout;
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  float *u = f(a.u), *part = f(a.tpart), *st = f(a.tstats);
  const dim3 rows(HW, N);
  const T* g = static_cast<const T*>(a.g);
  switch (step) {
    case 0: return cln_u_product<T>(a.x, a.w, u, N * HW, a.Cin, Cout, s);
    case 1: return clnt_moments(u, nullptr, 1, cf(a.b), part, N, HW, Cout, s);
    case 2:
      clnt_dz_sums_kernel<T><<<rows, kTThreads, 0, s>>>(u, cf(a.b), cf(a.scale), cf(a.bias2), g,
                                                        st, part, HW, Cout);
      return cudaGetLastError();
    case 3:
      clnt_du_kernel<T><<<rows, kTThreads, 0, s>>>(
          u, cf(a.b), cf(a.scale), cf(a.bias2), g, st, st + 2 * N, static_cast<T*>(a.du),
          f(a.pds), f(a.pdt), f(a.pdb), HW, Cout, static_cast<long>(N) * HW * Cout);
      return cudaGetLastError();
    default:
      if (int err = tiled_products<T>(a, s)) return err;
      return sums<T>(a, s);
  }
}

// The merge after steps 1 and 2 (moments, then sums).
constexpr int kClntMerge[2] = {kTMoments, kTSums};

// The tiled route in one call: the steps, each merge over the call's own
// rows.
template <typename T>
int run_tiled(const ClnBwdArgs& a, cudaStream_t s) {
  float* st = static_cast<float*>(a.tstats);
  for (int step = 0; step < 4; ++step) {
    if (int err = tiled_bwd_step<T>(step, a, s)) return err;
    if (step == 1 || step == 2)
      VPTR_TRY(tiled_stats(static_cast<const float*>(a.tpart), st + 2 * (step - 1) * a.N, a.N,
                           a.HW, static_cast<float>(a.Cout), a.eps, kClntMerge[step - 1], s));
  }
  return tiled_bwd_step<T>(4, a, s);
}

// The weight gradient's chunks, then (3.) ds, dt and the per-position db
// summed over the groups in order, and db over HW.
template <typename T>
int sums(const ClnBwdArgs& a, cudaStream_t s) {
  const int Cin = a.Cin, Cout = a.Cout;
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  SplitSum ws{};
  ws.part[0] = cf(a.wpart), ws.out[0] = a.dw;
  ws.ksplit = a.ksplit, ws.n = static_cast<long>(Cin) * Cout;
  split_sum_kernel<T><<<dim3(static_cast<unsigned>((ws.n + 255) / 256), 1), 256, 0, s>>>(ws);
  VPTR_TRY(cudaGetLastError());
  SplitSum ps{};
  ps.part[0] = cf(a.pds), ps.out[0] = a.ds;
  ps.part[1] = cf(a.pdt), ps.out[1] = a.dt;
  ps.part[2] = cf(a.pdb), ps.out[2] = a.dbfull;
  ps.ksplit = a.groups, ps.n = static_cast<long>(a.HW) * Cout;
  split_sum_kernel<float><<<dim3(static_cast<unsigned>((ps.n + 255) / 256), 3), 256, 0, s>>>(ps);
  VPTR_TRY(cudaGetLastError());
  ColBatch cb{};
  cb.job[0] = {a.dbfull, 0, nullptr, 0, f(a.db)};
  cb.rows = a.HW, cb.C = Cout, cb.group = 1, cb.parts = partials(a.HW);
  cb.partial = f(a.partial);
  colsum_partial_kernel<float><<<dim3((Cout + 127) / 128, cb.parts, 1), 128, 0, s>>>(cb);
  VPTR_TRY(cudaGetLastError());
  colsum_final_kernel<<<dim3((Cout + 127) / 128, 1), 128, 0, s>>>(cb);
  return cudaGetLastError();
}

template <typename T>
int run(const ClnBwdArgs& a, cudaStream_t s) {
  if (cln_route(a.HW, a.Cin, a.Cout) == 1) return run_tiled<T>(a, s);
  const int err = std::is_same<T, bf16>::value ? run_bf16_products(a, s) : run_f32_products(a, s);
  if (err) return err;
  return sums<T>(a, s);
}

}  // namespace

extern "C" {

const char* vptr_error_string(int err) {
  if (err >= kTmaEncodeError) {
    static char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             err - kTmaEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sample groups of pass 1 (pds, pdt, pdb: groups x HW x Cout f32) for
// dtype 0 (f32: about two resident blocks an SM on the cluster route) or 1
// (bf16: one a sample), one a sample on the tiled route; 0: the shape is
// not taken.
int vptr_conv_ln_gelu_bwd_groups(int N, int HW, int Cout, int dtype) {
  const int route = N < 1 ? -1 : cln_route(HW, 16, Cout);
  if (route < 0) return 0;
  return dtype == 1 || route == 1 ? N : cln_groups(N, cln_split(Cout));
}

// K chunks of the weight-gradient product (wpart: ksplit x Cin x Cout f32).
int vptr_conv_ln_gelu_bwd_ksplit(int rows) { return weight_splits(rows); }

// Column-sum partials of db (partial: parts x Cout f32).
int vptr_conv_ln_gelu_bwd_partials(int HW) { return partials(HW); }

// The bare MN-major product of the weight gradient: out (M, Nc) f32 = a^T b,
// a (K, M) and b (K, Nc) bf16, M and Nc multiples of 8, one K chunk.
int vptr_wgmma_product_mn(const void* a, const void* b, void* out, int K, int M, int Nc,
                          void* stream) {
  if (K < 1 || M < 8 || M % 8 || Nc < 8 || Nc % 8) return cudaErrorInvalidValue;
  return launch_dw<1>(a, b, b, static_cast<float*>(out), K, M, Nc, 1,
                      static_cast<cudaStream_t>(stream));
}

// A step of the tiled route on any shape it takes (cln_tiled_ok; N <=
// 65535), with groups = N (a group a sample) and u, tpart, tstats (see
// tiled_bwd_step; tensor parallelism: a rank's share, its exchanges and
// the merges, vptr_conv_ln_gelu_tiled_merge in conv_ln_gelu.cu, between
// the steps). Returns as vptr_conv_ln_gelu_bwd.
int vptr_conv_ln_gelu_bwd_tiled_step(int step, const ClnBwdArgs* a, void* stream) {
  if (!a || step < 0 || step > 4 || a->N < 1 || a->N > kClnTiledMaxN ||
      !cln_tiled_ok(a->HW, a->Cin, a->Cout) || a->dtype < 0 || a->dtype > 1 ||
      a->groups != a->N || a->ksplit < 1 || !a->u || !a->tpart || !a->tstats || !a->du ||
      !a->pds || !a->pdt || !a->pdb || !a->dbfull || !a->wpart || !a->partial)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 0 ? tiled_bwd_step<float>(step, *a, s) : tiled_bwd_step<bf16>(step, *a, s);
}

// Returns a cudaError_t (0 = every pass launched), or kTmaEncodeError + a
// CUresult.
int vptr_conv_ln_gelu_bwd(const ClnBwdArgs* a, void* stream) {
  const int route = a && a->N >= 1 ? cln_route(a->HW, a->Cin, a->Cout) : -1;
  if (route < 0 || a->dtype < 0 || a->dtype > 1 || a->groups < 1 ||
      a->groups != vptr_conv_ln_gelu_bwd_groups(a->N, a->HW, a->Cout, a->dtype) ||
      a->ksplit < 1 || !a->du || !a->pds || !a->pdt || !a->pdb || !a->dbfull || !a->wpart ||
      !a->partial)
    return cudaErrorInvalidValue;
  if (route == 0 && ((a->dtype == 1 && !a->wt) ||
                     (a->dtype == 0 && cln_smem(a->HW, a->Cout / cln_split(a->Cout)) >
                                           kClnSmemLimit)))
    return cudaErrorInvalidValue;
  if (route == 1 && (a->N > kClnTiledMaxN || !a->u || !a->tpart || !a->tstats))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 0 ? run<float>(*a, s) : run<bf16>(*a, s);
}

}  // extern "C"
