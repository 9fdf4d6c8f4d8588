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
// finishes. A block of up to two warpgroups has a feeder warp that issues
// the loads; four warpgroups need all 128 registers a thread that 16 warps
// leave, so their first warpgroup refills the ring between its products.
// A row past HW, a sample past N or a K past Cin is outside the tensor map
// and reads zero; a column past the slab is computed and left out.
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
// into f32, so the building blocks can be checked on their own.

#include <cstdio>

#include "conv_ln.cuh"
#include "wgmma.cuh"

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
  sample_u<float, 1>(x + n * HW * Cin, w, b, HW, Cin, Cout, c0, SW, eps, smem_cln, red,
                     cluster, mean, rstd);
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

// ---- the bf16 route: the wgmma ring product

constexpr int kWgABytes = kClnMaxRows * kWgK * 2;   // a sample's x box, 8 KB
constexpr int kWgBBytes = kWgN * kWgK * 2;          // a column group's W^T box, 22 KB
constexpr int kWgMaxStages = 6;

// A ring stage: the x boxes of S samples, then the W^T boxes of CW column
// groups of 176.
__host__ __device__ constexpr int wg_stage_bytes(int cw, int s) {
  return s * kWgABytes + cw * kWgBBytes;
}

// Samples a block takes at once for CW column groups: two (sharing every W^T
// box) while that is at most four warpgroups, else one.
constexpr int wg_samples(int cw) { return cw <= 2 ? 2 : 1; }

// A block of CW x S warpgroups has a warp of its own that issues the loads
// (the feeder) when that leaves the warpgroups their registers: up to two
// (nine warps, at most three on each of the SM's four schedulers). Four
// need every register the SM has for 16 warps, and their first warpgroup
// refills the ring between its products instead.
__host__ __device__ constexpr bool wg_feeder(int cw, int s) { return cw * s <= 2; }
__host__ __device__ constexpr int wg_threads(int cw, int s) {
  return cw * s * 128 + (wg_feeder(cw, s) ? 32 : 0);
}

// Ring stages: as many as fit the shared memory of an SM (a block holds an
// SM alone: its registers leave no room for a second), at most
// kWgMaxStages; at least 3 for every block shape taken.
int wg_stages(int cw, int s) {
  const int n = (232448 - 2048) / wg_stage_bytes(cw, s);
  return n > kWgMaxStages ? kWgMaxStages : n;
}

// Dynamic shared memory of a block: the ring, and 1 KB to align it to 1024.
long wg_smem(int cw, int s) {
  return static_cast<long>(wg_stages(cw, s)) * wg_stage_bytes(cw, s) + 1024;
}

int wg_groups(int SW) { return (SW + kWgN - 1) / kWgN; }

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The ring's barriers: `full` completes when a stage's boxes have landed,
// `empty` when every warpgroup warp is done with it.
struct WgRing {
  unsigned char* tiles;                // stages x wg_stage_bytes, 1024-aligned
  uint64_t full[kWgMaxStages], empty[kWgMaxStages];
  int stages;
};

// Sets the ring up (one thread; mbar_fence_init and a block or cluster
// synchronisation follow).
__device__ __forceinline__ void wg_ring_init(WgRing& ring, unsigned char* smem, int stages,
                                             int mma_warps) {
  ring.tiles = align_1024(smem);
  ring.stages = stages;
  for (int s = 0; s < stages; ++s) {
    mbar_init(&ring.full[s], 1);
    mbar_init(&ring.empty[s], mma_warps);   // one arrival a warpgroup warp
  }
}

// What the ring is fed with: K steps of kWgK of the sample groups n0,
// n0 + dn, ... (S samples from n each; `total` steps in all), each one box
// of the S samples' 64 rows of x (xmap over x (N, HW, Cin); rows past HW,
// samples past N and K past Cin read zero) and, for each column group c,
// one box of rows c0 + 176 c .. of W^T (wmap over (Cout, Cin)).
struct WgFeed {
  const CUtensorMap* xmap;
  const CUtensorMap* wmap;
  int n0, dn, c0, steps, total;
};

// Issues step g's boxes into its stage (the thread with on = true).
template <int CW, int S>
__device__ __forceinline__ void wg_load(const WgFeed& f, WgRing& ring, int g, bool on) {
  constexpr int kStage = wg_stage_bytes(CW, S);
  const int st = g % ring.stages, k = g % f.steps;
  unsigned char* a = ring.tiles + st * kStage;
  mbar_expect_tx(&ring.full[st], kStage, on);
  tma_load_3d(a, f.xmap, &ring.full[st], k * kWgK, 0, f.n0 + g / f.steps * f.dn, on);
#pragma unroll
  for (int c = 0; c < CW; ++c)
    tma_load_2d(a + S * kWgABytes + c * kWgBBytes, f.wmap, &ring.full[st], k * kWgK,
                f.c0 + c * kWgN, on);
}

// The feeder (one thread): every step in turn, each once its stage is free.
template <int CW, int S>
__device__ __forceinline__ void wg_feed(const WgFeed& f, WgRing& ring) {
  for (int g = 0; g < f.total; ++g) {
    if (g >= ring.stages) mbar_wait(&ring.empty[g % ring.stages], ((g / ring.stages) & 1) ^ 1);
    wg_load<CW, S>(f, ring, g, true);
  }
}

// Frees step g's stage (lane 0 of each warp arrives). Without a feeder, the
// first warpgroup then waits until every warp has and thread 0 refills the
// stage with step g + stages, so the loads run `stages` steps ahead of the
// products, across sample groups; `wg0` is warpgroup-uniform and the single
// thread's work is predicated: no divergent path between the products.
template <int CW, int S>
__device__ __forceinline__ void wg_release(const WgFeed& f, WgRing& ring, int g, bool wg0) {
  const int st = g % ring.stages;
  mbar_arrive(&ring.empty[st], (threadIdx.x & 31) == 0);
  if constexpr (!wg_feeder(CW, S))
    if (wg0 && g + ring.stages < f.total) {
      mbar_wait(&ring.empty[st], (g / ring.stages) & 1);
      wg_load<CW, S>(f, ring, g + ring.stages, threadIdx.x == 0);
    }
}

// A warpgroup: acc <- its 64 x 176 product (sample s of the group, column
// group c) for the next group in the ring (K = Cin); g counts the ring
// steps consumed.
template <int CW, int S>
__device__ __forceinline__ void wg_consume(const WgFeed& f, int s, int c, int Cin, WgRing& ring,
                                           int& g, float (&acc)[kWgAcc]) {
  constexpr int kStage = wg_stage_bytes(CW, S);
  const bool wg0 = s == 0 && c == 0;
#pragma unroll
  for (int i = 0; i < kWgAcc; ++i) acc[i] = 0.f;
  for (int k = 0; k < f.steps; ++k, ++g) {
    const int st = g % ring.stages;
    mbar_wait(&ring.full[st], (g / ring.stages) & 1);
    const unsigned char* a = ring.tiles + st * kStage;
    const uint64_t da = wg_desc(a + s * kWgABytes);
    const uint64_t db = wg_desc(a + S * kWgABytes + c * kWgBBytes);
    const int kk = min(kWgK, Cin - k * kWgK) / 16;   // 16-deep slices inside Cin
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int q = 0; q < kWgK / 16; ++q)
      if (q < kk) wgmma_176(acc, da + 2 * q, db + 2 * q);   // +32 bytes a slice
    wg_commit();
    wg_fence_acc(acc);
    if (k > 0) {                       // the previous step's products are done
      wg_wait<1>();
      wg_release<CW, S>(f, ring, g - 1, wg0);
    }
  }
  wg_wait<0>();
  wg_fence_acc(acc);
  wg_release<CW, S>(f, ring, g - 1, wg0);
}

// Two sums (one a sample of the group) over the warpgroups' threads of the
// cluster, with no cluster-wide barrier (the loads of the next group stay
// in flight): lanes by shuffle, the block's Warps warpgroup warps in order
// (named barrier 1), then every block's thread 0 writes the block sums into
// slot [set][rank] of every block of the cluster and arrives on that
// block's barrier; each thread adds the G slots in rank order, so every
// block holds the same values, the same bits on every run. Two sets of
// slots and barriers, used in turn: a block cannot write a set again
// before every block has read it (it needs their sums of the reduction
// between).
template <int Warps>
struct WgRed {
  float2 warp[Warps];
  float2 slot[2][kClnMaxCluster];
  uint64_t bar[2];
};

template <int Warps>
__device__ __forceinline__ float2 wg_cluster_sum(float2 v, WgRed<Warps>& red, int& count, int G,
                                                 int rank) {
  const int set = count & 1;
  v = make_float2(warp_sum(v.x), warp_sum(v.y));
  if ((threadIdx.x & 31) == 0) red.warp[threadIdx.x >> 5] = v;
  bar_sync(1, Warps * 32);
  if (threadIdx.x == 0) {
    float2 b = make_float2(0.f, 0.f);
    for (int i = 0; i < Warps; ++i) b = make_float2(b.x + red.warp[i].x, b.y + red.warp[i].y);
    for (int r = 0; r < G; ++r) {
      const uint32_t slot = cluster_addr(&red.slot[set][rank], r);
      st_cluster(slot, b.x);
      st_cluster(slot + 4, b.y);
      mbar_arrive_remote(cluster_addr(&red.bar[set], r));
    }
  }
  mbar_wait_cluster(&red.bar[set], (count >> 1) & 1);
  ++count;
  float2 t = make_float2(0.f, 0.f);
  for (int r = 0; r < G; ++r) t = make_float2(t.x + red.slot[set][r].x, t.y + red.slot[set][r].y);
  return t;
}

// The warpgroups' part of the sample kernel: for each sample group, the
// product, the two statistics and the epilogue; warpgroup w computes
// sample w / CW of the group at column group w % CW.
template <int CW, int S>
__device__ __forceinline__ void wg_samples_out(const WgFeed& f, WgRing& ring,
                                               WgRed<4 * CW * S>& red, int warp,
                                               const float* __restrict__ b,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias2,
                                               bf16* __restrict__ out, int N, int HW, int Cin,
                                               int Cout, int SW, float eps, int G, int rank) {
  // this thread's sample s of the group, rows 16 q + lane / 4 (+ 8) and
  // slab columns cb + 8 j (+ 1)
  const int lane = threadIdx.x & 31, s = warp / (4 * CW), c = warp / 4 % CW, q = warp & 3;
  const int r = 16 * q + (lane >> 2), cb = c * kWgN + 2 * (lane & 3);
  const long o = static_cast<long>(r) * Cout + f.c0 + cb;   // (r, c0 + cb) of an (HW, Cout)
  const float inv_n = 1.f / (static_cast<float>(HW) * Cout);
  int g = 0, count = 0;
  float acc[kWgAcc];
  for (int n = f.n0; n < N; n += f.dn) {
    wg_consume<CW, S>(f, s, c, Cin, ring, g, acc);
    const bool rows = 16 * q < HW && n + s < N;
    float v = 0.f;
    if (rows) {
#pragma unroll
      for (int j = 0; j < kWgN / 8; ++j)
        if (c * kWgN + 8 * j < SW) {
          const float2 bb = *reinterpret_cast<const float2*>(b + f.c0 + cb + 8 * j);
          acc[4 * j] += bb.x;
          acc[4 * j + 1] += bb.y;
          acc[4 * j + 2] += bb.x;
          acc[4 * j + 3] += bb.y;
          v += (acc[4 * j] + acc[4 * j + 1]) + (acc[4 * j + 2] + acc[4 * j + 3]);
        }
    }
    float2 t = wg_cluster_sum(make_float2(s ? 0.f : v, s ? v : 0.f), red, count, G, rank);
    const float mean = (s ? t.y : t.x) * inv_n;
    v = 0.f;
    if (rows) {
#pragma unroll
      for (int j = 0; j < kWgN / 8; ++j)
        if (c * kWgN + 8 * j < SW)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float d = acc[4 * j + i] - mean;
            v = fmaf(d, d, v);
          }
    }
    t = wg_cluster_sum(make_float2(s ? 0.f : v, s ? v : 0.f), red, count, G, rank);
    const float rstd = rsqrtf((s ? t.y : t.x) * inv_n + eps);
    if (rows) {
      bf16* on = out + static_cast<long>(n + s) * HW * Cout + o;
#pragma unroll
      for (int j = 0; j < kWgN / 8; ++j)
        if (c * kWgN + 8 * j < SW)
#pragma unroll
          for (int h = 0; h < 2; ++h) {                     // rows r and r + 8
            const long e = static_cast<long>(8 * h) * Cout + 8 * j;
            const float2 sc = *reinterpret_cast<const float2*>(scale + o + e);
            const float2 bs = *reinterpret_cast<const float2*>(bias2 + o + e);
            const float y0 = vptr_gelu::gelu((acc[4 * j + 2 * h] - mean) * rstd * sc.x + bs.x);
            const float y1 =
                vptr_gelu::gelu((acc[4 * j + 2 * h + 1] - mean) * rstd * sc.y + bs.y);
            *reinterpret_cast<__nv_bfloat162*>(on + e) = __floats2bfloat162_rn(y0, y1);
          }
    }
  }
}

// The sample kernel (see the note at the top): persistent clusters, cluster
// i taking the sample groups S i, S (i + C), ... (C clusters in the grid);
// the loads of the next group are in flight while this one's statistics
// and epilogue run.
template <int CW, int S>
__global__ void __launch_bounds__(wg_threads(CW, S), 1)
conv_ln_gelu_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, const float* __restrict__ b,
                       const float* __restrict__ scale, const float* __restrict__ bias2,
                       bf16* __restrict__ out, int N, int HW, int Cin, int Cout, int SW,
                       int stages, float eps) {
  constexpr int kWarps = 4 * CW * S;   // the warpgroups' warps
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_wg[];
  __shared__ WgRing ring;
  __shared__ WgRed<kWarps> red;
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.x / G * S, dn = gridDim.x / G * S;
  const int steps = (Cin + kWgK - 1) / kWgK;
  const WgFeed f = {&xmap, &wmap, n0, dn, rank * SW, steps, (N - n0 + dn - 1) / dn * steps};
  if (threadIdx.x == 0) {
    wg_ring_init(ring, smem_wg, stages, kWarps);
    mbar_init(&red.bar[0], G);
    mbar_init(&red.bar[1], G);
    mbar_fence_init();
  }
  cluster.sync();                      // every block's barriers are set up
  // the warp index broadcast from lane 0: the compiler then knows that the
  // roles are warp-uniform, and keeps the products asynchronous
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  if (wg_feeder(CW, S) && warp == kWarps) {
    if ((threadIdx.x & 31) == 0) wg_feed<CW, S>(f, ring);
  } else {
    if (!wg_feeder(CW, S) && threadIdx.x == 0)
      for (int g = 0; g < stages && g < f.total; ++g) wg_load<CW, S>(f, ring, g, true);
    wg_samples_out<CW, S>(f, ring, red, warp, b, scale, bias2, out, N, HW, Cin, Cout, SW, eps,
                          G, rank);
  }
  cluster.sync();                      // no block leaves while another may write to it
}

// The bare product: out (64, cols) f32 = A (64, K) B^T with B (cols, K).
template <int CW>
__global__ void __launch_bounds__(wg_threads(CW, 1))
wg_product_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                  float* __restrict__ out, int K, int cols, int stages) {
  extern __shared__ unsigned char smem_wg[];
  __shared__ WgRing ring;
  const int steps = (K + kWgK - 1) / kWgK;
  const WgFeed f = {&xmap, &wmap, 0, 1, 0, steps, steps};
  if (threadIdx.x == 0) {
    wg_ring_init(ring, smem_wg, stages, 4 * CW);
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  if (wg_feeder(CW, 1) && warp == 4 * CW) {
    if (lane == 0) wg_feed<CW, 1>(f, ring);
    return;
  }
  if (!wg_feeder(CW, 1) && threadIdx.x == 0)
    for (int g = 0; g < stages && g < steps; ++g) wg_load<CW, 1>(f, ring, g, true);
  const int c = warp >> 2, r = 16 * (warp & 3) + (lane >> 2);
  float acc[kWgAcc];
  int g = 0;
  wg_consume<CW, 1>(f, 0, c, K, ring, g, acc);
#pragma unroll
  for (int j = 0; j < kWgN / 8; ++j) {
    const int col = c * kWgN + 8 * j + 2 * (lane & 3);
    if (c * kWgN + 8 * j < cols)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[(r + 8 * (i >> 1)) * cols + col + (i & 1)] = acc[4 * j + i];
  }
}

// The launch of kernel in clusters of G blocks of `threads` along x.
template <typename... Exp>
cudaLaunchConfig_t cluster_config(void (*kernel)(Exp...), int clusters, int G, int threads,
                                  long smem, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * G), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(G);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches kernel in `clusters` clusters of G blocks of `threads` along x.
template <typename... Exp, typename... Act>
cudaError_t launch_cluster_blocks(void (*kernel)(Exp...), int clusters, int G, int threads,
                                  long smem, cudaStream_t s, Act&&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(kernel, clusters, G, threads, smem, s, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of kernel the card holds at once (0 on an error).
template <typename... Exp>
int resident_clusters(void (*kernel)(Exp...), int G, int threads, long smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(kernel, 1, G, threads, smem, nullptr, &attr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : 0;
}

// Tensor maps of x (N, HW, Cin) (boxes of S samples' 64 rows by kWgK) and
// W^T (Cout, Cin) (boxes of kWgN rows by kWgK).
int wg_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x, const void* wt, int N, int HW,
            int Cin, int Cout, int S) {
  const cuuint64_t row = static_cast<cuuint64_t>(Cin) * 2;
  const cuuint64_t xd[3] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(HW),
                            static_cast<cuuint64_t>(N)};
  const cuuint64_t xs[2] = {row, row * HW};
  const cuuint32_t xb[3] = {kWgK, kClnMaxRows, static_cast<cuuint32_t>(S)};
  const int err = bf16_map(xmap, x, 3, xd, xs, xb);
  if (err) return err;
  const cuuint64_t wd[2] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(Cout)};
  const cuuint32_t wb[2] = {kWgK, kWgN};
  return bf16_map(wmap, wt, 2, wd, &row, wb);
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
  CUtensorMap xmap, wmap;
  const int err = wg_maps(&xmap, &wmap, a, bt, 1, kClnMaxRows, K, cols, 1);
  if (err) return err;
  return launch_cluster_blocks(wg_product_kernel<CW>, 1, 1, wg_threads(CW, 1), wg_smem(CW, 1), s,
                               xmap, wmap, static_cast<float*>(out), K, cols,
                               wg_stages(CW, 1));
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

// Dynamic shared memory a block takes for (HW, Cout, dtype), in bytes.
long vptr_conv_ln_gelu_smem(int HW, int Cout, int dtype) {
  const int G = vptr_conv_ln_gelu_split(Cout);
  if (!G) return -1;
  const int cw = wg_groups(Cout / G);
  return dtype == 1 ? wg_smem(cw, wg_samples(cw)) : cln_smem(HW, Cout / G, dtype);
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
    return launch_clusters(conv_ln_gelu_kernel, N * G, G, cln_smem(HW, SW, 0), s,
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
