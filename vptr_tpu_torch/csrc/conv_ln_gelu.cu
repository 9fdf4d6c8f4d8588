// Fused 1x1 conv + whole-sample LayerNorm + affine + GELU, forward, on
// Hopper (sm_90a), over x (N, HW, Cin) with the weight W (Cin, Cout): the
// arithmetic of conv_ln.cuh; x, W and the output in T (float or bf16), b
// (Cout) and the (HW, Cout) affines scale, bias2 f32; the result rounded to
// T once.
//
// Replaces the TPU kernel vptr_tpu/ops/fused_conv_ln.py::_forward
// (_fwd_kernel at :86, pl.pallas_call at :174). The backward is
// conv_ln_gelu_bwd.cu.
//
// What bounds it on an H100: operations. The product is 2 S Cin Cout flops
// (28.5 GFLOP at S = N HW = 12,800 rows, 528 -> 2112: 0.029 ms at 989
// TFLOP/s in bf16) against ~71 MB that the function must move (x read once,
// the output written once, W and the affines: 0.021 ms at 3.35 TB/s). What
// holds it back in practice is L2: every sample re-reads W and the (HW,
// Cout) f32 affines (~0.45 GB and ~0.22 GB a call at far_mnist's fc1 when
// each sample reads its own), and a block's product is only Cin / 64 steps
// deep against its fixed costs (the ring's fill, two cluster sums, the
// affine loads of the epilogue).
//
// bf16, the design: a thread-block cluster of G blocks (cln_split) splits
// Cout into slabs of SW = Cout / G columns (6 x 352 at fc1, 3 x 176 at fc2),
// each a whole number of column groups of 176. Since wgmma's M is 64 and a
// sample has HW <= 64 positions, one warpgroup's tile is a whole sample by
// one column group: wgmma.mma_async m64n176k16 (wgmma.cuh), both operands
// K-major (the sample's x rows and the rows of W^T: the wrapper passes W
// transposed, (Cout, Cin)), fed by TMA through a ring of 64-deep K steps
// with mbarriers. A block takes S = 2 samples at once while that is at most
// four warpgroups (fc1: 2 samples x 2 column groups; fc2: 2 x 1), so each
// W^T box serves two samples and W's L2 traffic halves. The clusters are
// persistent: as many as the card holds at once, each walking its sample
// groups, the ring's loads running ahead into the next group while this one
// finishes (the ring, the sample loop and the cluster sums are
// conv_ln_wg.cuh's, shared with the backward). A block of up to two
// warpgroups has a feeder warp that issues the loads; four warpgroups need
// all 128 registers a thread that 16 warps leave, so their first warpgroup
// refills the ring between its products. A row past HW, a sample past N
// or a K past Cin is outside the tensor map and reads zero; a column past
// the slab is computed and left out.
//
// The 64 x 176 f32 accumulators stay in registers (88 a thread) through the
// bias, the two statistics, the affine, the GELU and the bf16 store: no f32
// slab in shared memory. Each statistic is a warp shuffle tree, the warps
// in order, then the cluster in rank order: every block's sums are written
// into every block's distributed shared memory and signalled on an
// mbarrier, with no cluster-wide barrier, so the next group's loads stay
// in flight; fixed order, no atomics, the same bits on every run.
//
// f32 runs on the CUDA cores (conv_ln.cuh's slab_gemm_fma and sample_u), a
// thread a slab column, the slab in shared memory.
//
// Also exported: vptr_wgmma_product, the bare ring product (64 x cols x K)
// into f32 (conv_ln_wg.cuh's product kernel, which the backward's dx runs),
// so the building blocks can be checked on their own.
//
// Two routes, named from the shape before the launch
// (vptr_conv_ln_gelu_route; ops/conv_ln_gelu.py::kernel_route): the one
// above, "cluster", for HW <= 64; "tiled" past it (nar_kth_128's HW 256),
// in passes through device memory with per-row partial moments
// (conv_ln_tiled.cuh, whose note says what bounds it). That route is also
// exported step by step (vptr_conv_ln_gelu_tiled_step and _merge), for a
// tensor-parallel rank's share with the exchanges between the steps.

#include <cstdio>

#include "conv_ln_tiled.cuh"

namespace {

// ---- the f32 route

__global__ void __launch_bounds__(kClnThreads)
conv_ln_gelu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ scale,
                    const float* __restrict__ bias2, float* __restrict__ out, int HW, int Cin,
                    int Cout, int SW, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem_cln[];
  __shared__ ClnRed red;
  const int G = static_cast<int>(cluster.num_blocks());
  const int c0 = static_cast<int>(cluster.block_rank()) * SW;
  const long n = blockIdx.x / G;
  float mean, rstd;
  sample_u(x + n * HW * Cin, w, b, HW, Cin, Cout, c0, SW, eps, smem_cln, red, cluster,
           mean, rstd);
  const float* slab = reinterpret_cast<const float*>(smem_cln);
  const int lds = SW + 4;
  float* on = out + n * HW * Cout;
  for (int e = threadIdx.x; e < HW * SW; e += kClnThreads) {
    const int r = e / SW, c = e - r * SW;
    const long o = static_cast<long>(r) * Cout + c0 + c;
    const float zh = (slab[r * lds + c] - mean) * rstd;
    on[o] = vptr_gelu::gelu(zh * scale[o] + bias2[o]);
  }
  cluster.sync();                      // the other blocks are done reading red
}

// ---- the bf16 route (the ring product and the sample loop: conv_ln_wg.cuh)

// Samples a block takes at once for CW column groups: two (sharing every W^T
// box) while that is at most four warpgroups, else one.
constexpr int wg_samples(int cw) { return cw <= 2 ? 2 : 1; }

// The sample kernel (see the note at the top): for each sample group, the
// product, the two statistics and the epilogue; warpgroup w computes sample
// w / CW of the group at column group w % CW.
template <int CW, int S>
__global__ void __launch_bounds__(wg_threads(CW, S), 1)
conv_ln_gelu_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, const float* __restrict__ b,
                       const float* __restrict__ scale, const float* __restrict__ bias2,
                       bf16* __restrict__ out, int N, int HW, int Cin, int Cout, int SW,
                       int stages, float eps) {
  extern __shared__ unsigned char smem_wg[];
  __shared__ WgRing ring;
  __shared__ WgRed<4 * CW * S, 2> red;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank()), c0 = rank * SW;
  auto epilogue = [&](float (&acc)[kWgAcc], int n, const WgPlace& p, int& count) {
    const bool rows = 16 * p.q < HW && n + p.s < N;
    float mean, rstd;
    wg_stats(acc, b, p, rows, c0, SW, HW, Cout, eps, red, count, G, rank, mean, rstd);
    if (!rows) return;
    const long o = static_cast<long>(p.r) * Cout + c0 + p.cb;   // (r, c0 + cb) of (HW, Cout)
    bf16* on = out + static_cast<long>(n + p.s) * HW * Cout + o;
#pragma unroll
    for (int j = 0; j < kWgN / 8; ++j)
      if (p.c * kWgN + 8 * j < SW)
#pragma unroll
        for (int h = 0; h < 2; ++h) {                     // rows r and r + 8
          const long e = static_cast<long>(8 * h) * Cout + 8 * j;
          const float2 sc = *reinterpret_cast<const float2*>(scale + o + e);
          const float2 bs = *reinterpret_cast<const float2*>(bias2 + o + e);
          const float y0 = vptr_gelu::gelu((acc[4 * j + 2 * h] - mean) * rstd * sc.x + bs.x);
          const float y1 = vptr_gelu::gelu((acc[4 * j + 2 * h + 1] - mean) * rstd * sc.y + bs.y);
          *reinterpret_cast<__nv_bfloat162*>(on + e) = __floats2bfloat162_rn(y0, y1);
        }
  };
  wg_sample_loop<CW, S, wg_feeder(CW, S)>(&xmap, &wmap, smem_wg, ring, red, N, Cin, SW, stages,
                                          epilogue);
}

template <int CW>
int launch_wg(const void* x, const void* wt, const void* b, const void* scale,
              const void* bias2, void* out, int N, int HW, int Cin, int Cout, float eps,
              cudaStream_t s) {
  constexpr int S = wg_samples(CW), kThreads = wg_threads(CW, S);
  CUtensorMap xmap, wmap;
  const int err = wg_maps(&xmap, &wmap, x, wt, N, HW, Cin, Cout, S);
  if (err) return err;
  const int G = cln_split(Cout), groups = (N + S - 1) / S;
  const long smem = wg_smem(CW, S);
  static int resident[kClnMaxCluster + 1];       // asked once for each cluster size
  if (!resident[G])
    resident[G] = resident_clusters(conv_ln_gelu_wg_kernel<CW, S>, G, kThreads, smem);
  if (!resident[G]) return cudaErrorInvalidConfiguration;
  return launch_cluster_blocks(conv_ln_gelu_wg_kernel<CW, S>,
                               groups < resident[G] ? groups : resident[G], G, kThreads, smem,
                               s, xmap, wmap, static_cast<const float*>(b),
                               static_cast<const float*>(scale),
                               static_cast<const float*>(bias2), static_cast<bf16*>(out), N,
                               HW, Cin, Cout, Cout / G, wg_stages(CW, S), eps);
}

template <int CW>
int launch_product(const void* a, const void* bt, void* out, int K, int cols, cudaStream_t s) {
  CUtensorMap amap, bmap;
  const int err = wg_maps(&amap, &bmap, a, bt, 1, kClnMaxRows, K, cols, 1);
  if (err) return err;
  return launch_product_walkers<CW, 1>(amap, amap, bmap, static_cast<float*>(out), 1,
                                       kClnMaxRows, K, cols, s);
}

// A step of the tiled route: 0, u = x W (f32, without b); 1, each row's
// partial moments of u + b into part (with `parts`, M partial products in
// rank order, u first written as their sum); 2, the epilogue with the
// statistics `stats` (N x 2: mean, rstd).
template <typename T>
int tiled_step(int step, const void* x, const void* w, const void* b, const void* scale,
               const void* bias2, void* out, void* u, void* part, const void* stats,
               const void* parts, int M, int N, int HW, int Cin, int Cout, cudaStream_t s) {
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  float* uf = static_cast<float*>(u);
  if (step == 0) return cln_u_product<T>(x, w, uf, N * HW, Cin, Cout, s);
  if (step == 1)
    return clnt_moments(uf, cf(parts), M, cf(b), static_cast<float*>(part), N, HW, Cout, s);
  clnt_out_kernel<T><<<dim3(HW, N), kTThreads, 0, s>>>(uf, cf(b), cf(scale), cf(bias2),
                                                       cf(stats), static_cast<T*>(out), HW,
                                                       Cout);
  return cudaGetLastError();
}

// The tiled route: u = x W into u (f32), the statistics, the epilogue.
template <typename T>
int tiled_forward(const void* x, const void* w, const void* b, const void* scale,
                  const void* bias2, void* out, void* u, void* part, void* stats, int N, int HW,
                  int Cin, int Cout, float eps, cudaStream_t s) {
  for (int step = 0; step < 2; ++step)
    if (int err = tiled_step<T>(step, x, w, b, scale, bias2, out, u, part, stats, nullptr, 1, N,
                                HW, Cin, Cout, s))
      return err;
  VPTR_TRY(tiled_stats(static_cast<const float*>(part), static_cast<float*>(stats), N, HW,
                       static_cast<float>(Cout), eps, kTMoments, s));
  return tiled_step<T>(2, x, w, b, scale, bias2, out, u, part, stats, nullptr, 1, N, HW, Cin,
                       Cout, s);
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

// Blocks per sample (the cluster size) for Cout; 0: Cout is not taken.
int vptr_conv_ln_gelu_split(int Cout) { return Cout % 16 ? 0 : cln_split(Cout); }

// The route for (HW, Cin, Cout, dtype): 0 = cluster, 1 = tiled, -1 = none
// (the same in both dtypes).
int vptr_conv_ln_gelu_route(int HW, int Cin, int Cout, int dtype) {
  return dtype < 0 || dtype > 1 ? -1 : cln_route(HW, Cin, Cout);
}

// Dynamic shared memory a block takes for (HW, Cout, dtype), in bytes.
long vptr_conv_ln_gelu_smem(int HW, int Cout, int dtype) {
  const int G = vptr_conv_ln_gelu_split(Cout);
  if (!G) return -1;
  const int cw = wg_groups(Cout / G);
  return dtype == 1 ? wg_smem(cw, wg_samples(cw)) : cln_smem(HW, Cout / G);
}

// dtype: 0 = float32 with w (Cin, Cout); 1 = bfloat16 with w transposed,
// (Cout, Cin). Returns a cudaError_t (0 = launched), or kTmaEncodeError +
// a CUresult.
int vptr_conv_ln_gelu(const void* x, const void* w, const void* b, const void* scale,
                      const void* bias2, void* out, int N, int HW, int Cin, int Cout, float eps,
                      int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!cln_shape_ok(N, HW, Cin, Cout) || dtype < 0 || dtype > 1 ||
      vptr_conv_ln_gelu_smem(HW, Cout, dtype) > kClnSmemLimit)
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    const int G = cln_split(Cout), SW = Cout / G;
    return launch_clusters(conv_ln_gelu_kernel, N * G, G, cln_smem(HW, SW), s,
                           static_cast<const float*>(x), static_cast<const float*>(w),
                           static_cast<const float*>(b), static_cast<const float*>(scale),
                           static_cast<const float*>(bias2), static_cast<float*>(out), HW, Cin,
                           Cout, SW, eps);
  }
  switch (wg_groups(Cout / cln_split(Cout))) {
    case 1: return launch_wg<1>(x, w, b, scale, bias2, out, N, HW, Cin, Cout, eps, s);
    case 2: return launch_wg<2>(x, w, b, scale, bias2, out, N, HW, Cin, Cout, eps, s);
    default: return launch_wg<3>(x, w, b, scale, bias2, out, N, HW, Cin, Cout, eps, s);
  }
}

// The tiled route on any shape it takes (cln_tiled_ok; N <= 65535), in
// either dtype with w (Cin, Cout) as stored, and the caller's f32 scratch:
// u (N HW, Cout), part (N, HW, 2), stats (N, 2). Returns as
// vptr_conv_ln_gelu.
int vptr_conv_ln_gelu_tiled(const void* x, const void* w, const void* b, const void* scale,
                            const void* bias2, void* out, void* u, void* part, void* stats,
                            int N, int HW, int Cin, int Cout, float eps, int dtype,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kClnTiledMaxN || !cln_tiled_ok(HW, Cin, Cout) || dtype < 0 || dtype > 1 ||
      !u || !part || !stats)
    return cudaErrorInvalidValue;
  return dtype == 0 ? tiled_forward<float>(x, w, b, scale, bias2, out, u, part, stats, N, HW,
                                           Cin, Cout, eps, s)
                    : tiled_forward<bf16>(x, w, b, scale, bias2, out, u, part, stats, N, HW, Cin,
                                          Cout, eps, s);
}

// The tiled route as separate steps (tensor parallelism: a rank's share of
// a column- or row-parallel call, its exchanges between the steps; see
// tiled_step): step 0 writes u, step 1 part (N, HW, 2) (parts: null, or M
// planes of N HW x Cout partial products summed into u in rank order),
// step 2 the output from stats, which vptr_conv_ln_gelu_tiled_merge fills.
// The operands as vptr_conv_ln_gelu_tiled's; returns as it.
int vptr_conv_ln_gelu_tiled_step(int step, const void* x, const void* w, const void* b,
                                 const void* scale, const void* bias2, void* out, void* u,
                                 void* part, const void* stats, const void* parts, int M, int N,
                                 int HW, int Cin, int Cout, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (step < 0 || step > 2 || N < 1 || N > kClnTiledMaxN || !cln_tiled_ok(HW, Cin, Cout) ||
      dtype < 0 || dtype > 1 || !u || (step == 1 && (!part || (parts && M < 1))) ||
      (step == 2 && !stats))
    return cudaErrorInvalidValue;
  return dtype == 0 ? tiled_step<float>(step, x, w, b, scale, bias2, out, u, part, stats, parts,
                                        M, N, HW, Cin, Cout, s)
                    : tiled_step<bf16>(step, x, w, b, scale, bias2, out, u, part, stats, parts,
                                       M, N, HW, Cin, Cout, s);
}

// A split call's merge (forward and backward): out (N, 2) from part (N, T,
// 2), T partials of cnt values a sample in the whole call's order; mode 0:
// each partial's (mean, M2) merged into (mean, rstd), 1: the two sums'
// means over the sample's T cnt values.
int vptr_conv_ln_gelu_tiled_merge(const void* part, void* out, int N, int T, float cnt, float eps,
                                  int mode, void* stream) {
  if (N < 1 || T < 1 || !(cnt >= 1.f) || mode < 0 || mode > 1 || !part || !out)
    return cudaErrorInvalidValue;
  return tiled_stats(static_cast<const float*>(part), static_cast<float*>(out), N, T, cnt, eps,
                     mode, static_cast<cudaStream_t>(stream));
}

// The bare ring product: out (64, cols) f32 = a (64, K) bt^T, a and bt
// (cols, K) bf16; K a multiple of 16, cols a multiple of 16 up to 3 * 176.
int vptr_wgmma_product(const void* a, const void* bt, void* out, int K, int cols, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 16 || K % 16 || cols < 16 || cols % 16 || cols > 3 * kWgN)
    return cudaErrorInvalidValue;
  switch (wg_groups(cols)) {
    case 1: return launch_product<1>(a, bt, out, K, cols, s);
    case 2: return launch_product<2>(a, bt, out, K, cols, s);
    default: return launch_product<3>(a, bt, out, K, cols, s);
  }
}

}  // extern "C"
