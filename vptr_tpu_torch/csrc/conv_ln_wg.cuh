// The wgmma ring product of the fused 1x1 conv + whole-sample LayerNorm on
// Hopper (sm_90a), shared by the bf16 forward (conv_ln_gelu.cu, kernel #11)
// and backward (conv_ln_gelu_bwd.cu, #12): the TMA ring, the warpgroups'
// product into registers, the persistent sample loop of a thread-block
// cluster with its fixed-order cluster sums, and the launch helpers.
//
// A warpgroup's tile is 64 rows (a sample's HW <= 64 positions) by one
// column group of kWgN = 176: wgmma.mma_async m64n176k16 (wgmma.cuh), both
// operands K-major, fed by TMA through a ring of 64-deep K steps with
// mbarriers. A stage holds, for S samples and T terms, S T boxes of 64 rows
// of A (the terms are summed into the same accumulators: T = 2 takes the
// bf16 hi and lo halves of an f32 operand) and the boxes of CW column
// groups of B^T, which every sample and term of the stage shares. A block
// has a feeder warp that issues the loads, or its first warpgroup refills
// the ring between its products where registers are short (wg_feeder). A
// row past HW, a sample past N or a K past the depth is outside the tensor
// map and reads zero.
#pragma once

#include "conv_ln.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWgABytes = kClnMaxRows * kWgK * 2;   // a sample's A box, 8 KB
constexpr int kWgBBytes = kWgN * kWgK * 2;          // a column group's B^T box, 22 KB
constexpr int kWgMaxStages = 6;

// A ring stage: the A boxes of S samples for each of T terms, then the B^T
// boxes of CW column groups of 176.
__host__ __device__ constexpr int wg_stage_bytes(int cw, int s, int t = 1) {
  return s * t * kWgABytes + cw * kWgBBytes;
}

// A block of CW x S warpgroups has a warp of its own that issues the loads
// (the feeder) when that leaves the warpgroups their registers: by default
// up to two (nine warps, at most three on each of the SM's four schedulers;
// ptxas then allows 168 registers a thread). Four need every register the
// SM has for 16 warps, and without a feeder the first warpgroup refills the
// ring between its products instead. The template functions below take
// the choice as F.
__host__ __device__ constexpr bool wg_feeder(int cw, int s) { return cw * s <= 2; }
__host__ __device__ constexpr int wg_threads(int cw, int s, bool f) {
  return cw * s * 128 + (f ? 32 : 0);
}
__host__ __device__ constexpr int wg_threads(int cw, int s) {
  return wg_threads(cw, s, wg_feeder(cw, s));
}

// Ring stages: as many as fit the shared memory of an SM (a block holds an
// SM alone: its registers leave no room for a second), at most
// kWgMaxStages.
int wg_stages(int cw, int s, int t = 1) {
  const int n = (232448 - 2048) / wg_stage_bytes(cw, s, t);
  return n > kWgMaxStages ? kWgMaxStages : n;
}

// Dynamic shared memory of a block: the ring, and 1 KB to align it to 1024.
long wg_smem(int cw, int s, int t = 1) {
  return static_cast<long>(wg_stages(cw, s, t)) * wg_stage_bytes(cw, s, t) + 1024;
}

int wg_groups(int SW) { return (SW + kWgN - 1) / kWgN; }

// The card's SM count (asked once; 0 when it cannot be read).
int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

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
// of the S samples' 64 rows of A for each term t (amap[t] over A (N, HW,
// depth); rows past HW, samples past N and K past the depth read zero) and,
// for each column group c, one box of rows c0 + 176 c .. of B^T (bmap over
// (columns, depth)).
struct WgFeed {
  const CUtensorMap* amap[2];
  const CUtensorMap* bmap;
  int n0, dn, c0, steps, total;
};

// Issues step g's boxes into its stage (the thread with on = true).
template <int CW, int S, int T>
__device__ __forceinline__ void wg_load(const WgFeed& f, WgRing& ring, int g, bool on) {
  constexpr int kStage = wg_stage_bytes(CW, S, T);
  const int st = g % ring.stages, k = g % f.steps;
  unsigned char* a = ring.tiles + st * kStage;
  mbar_expect_tx(&ring.full[st], kStage, on);
#pragma unroll
  for (int t = 0; t < T; ++t)
    tma_load_3d(a + t * S * kWgABytes, f.amap[t], &ring.full[st], k * kWgK, 0,
                f.n0 + g / f.steps * f.dn, on);
#pragma unroll
  for (int c = 0; c < CW; ++c)
    tma_load_2d(a + S * T * kWgABytes + c * kWgBBytes, f.bmap, &ring.full[st], k * kWgK,
                f.c0 + c * kWgN, on);
}

// The feeder (one thread): every step in turn, each once its stage is free.
template <int CW, int S, int T>
__device__ __forceinline__ void wg_feed(const WgFeed& f, WgRing& ring) {
  for (int g = 0; g < f.total; ++g) {
    if (g >= ring.stages) mbar_wait(&ring.empty[g % ring.stages], ((g / ring.stages) & 1) ^ 1);
    wg_load<CW, S, T>(f, ring, g, true);
  }
}

// Frees step g's stage (lane 0 of each warp arrives). Without a feeder, the
// first warpgroup then waits until every warp has and thread 0 refills the
// stage with step g + stages, so the loads run `stages` steps ahead of the
// products, across sample groups; `wg0` is warpgroup-uniform and the single
// thread's work is predicated: no divergent path between the products.
template <int CW, int S, int T, bool F = wg_feeder(CW, S)>
__device__ __forceinline__ void wg_release(const WgFeed& f, WgRing& ring, int g, bool wg0) {
  const int st = g % ring.stages;
  mbar_arrive(&ring.empty[st], (threadIdx.x & 31) == 0);
  if constexpr (!F)
    if (wg0 && g + ring.stages < f.total) {
      mbar_wait(&ring.empty[st], (g / ring.stages) & 1);
      wg_load<CW, S, T>(f, ring, g + ring.stages, threadIdx.x == 0);
    }
}

// Starts the ring without a feeder: thread 0 issues the first stages.
template <int CW, int S, int T, bool F = wg_feeder(CW, S)>
__device__ __forceinline__ void wg_prime(const WgFeed& f, WgRing& ring) {
  if (!F && threadIdx.x == 0)
    for (int g = 0; g < ring.stages && g < f.total; ++g) wg_load<CW, S, T>(f, ring, g, true);
}

// A warpgroup: acc <- its 64 x 176 product (sample s of the group, column
// group c, the T terms summed) for the next group in the ring (K = depth);
// g counts the ring steps consumed.
template <int CW, int S, int T, bool F = wg_feeder(CW, S)>
__device__ __forceinline__ void wg_consume(const WgFeed& f, int s, int c, int depth,
                                           WgRing& ring, int& g, float (&acc)[kWgAcc]) {
  constexpr int kStage = wg_stage_bytes(CW, S, T);
  const bool wg0 = s == 0 && c == 0;
#pragma unroll
  for (int i = 0; i < kWgAcc; ++i) acc[i] = 0.f;
  for (int k = 0; k < f.steps; ++k, ++g) {
    const int st = g % ring.stages;
    mbar_wait(&ring.full[st], (g / ring.stages) & 1);
    const unsigned char* a = ring.tiles + st * kStage;
    uint64_t da[T];
#pragma unroll
    for (int t = 0; t < T; ++t) da[t] = wg_desc(a + (t * S + s) * kWgABytes);
    const uint64_t db = wg_desc(a + S * T * kWgABytes + c * kWgBBytes);
    const int kk = min(kWgK, depth - k * kWgK) / 16;   // 16-deep slices inside the depth
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int q = 0; q < kWgK / 16; ++q)
        if (q < kk) wgmma_176(acc, da[t] + 2 * q, db + 2 * q);   // +32 bytes a slice
    wg_commit();
    wg_fence_acc(acc);
    if (k > 0) {                       // the previous step's products are done
      wg_wait<1>();
      wg_release<CW, S, T, F>(f, ring, g - 1, wg0);
    }
  }
  wg_wait<0>();
  wg_fence_acc(acc);
  wg_release<CW, S, T, F>(f, ring, g - 1, wg0);
}

// NV sums over the warpgroups' threads of the cluster, with no
// cluster-wide barrier (the loads of the next group stay in flight): lanes
// by shuffle, the block's Warps warpgroup warps in order (named barrier 1),
// then every block's thread 0 writes the block sums into slot [set][rank]
// of every block of the cluster and arrives on that block's barrier; each
// thread adds the G slots in rank order, so every block holds the same
// values, the same bits on every run. Two sets of slots and barriers, used
// in turn: a block cannot write a set again before every block has read it
// (it needs their sums of the reduction between).
template <int NV> struct WgVec;             // NV floats moved as one
template <> struct WgVec<2> { using T = float2; };
template <> struct WgVec<4> { using T = float4; };
__device__ __forceinline__ float& wg_at(float2& x, int i) { return i ? x.y : x.x; }
__device__ __forceinline__ float& wg_at(float4& x, int i) {
  return i == 0 ? x.x : (i == 1 ? x.y : (i == 2 ? x.z : x.w));
}

template <int Warps, int NV>
struct WgRed {
  using V = typename WgVec<NV>::T;
  V warp[Warps];
  V slot[2][kClnMaxCluster];
  uint64_t bar[2];
};

template <int Warps, int NV>
__device__ __forceinline__ void wg_cluster_sum(float (&v)[NV], WgRed<Warps, NV>& red, int& count,
                                               int G, int rank) {
  using V = typename WgRed<Warps, NV>::V;
  const int set = count & 1;
  V x;
#pragma unroll
  for (int i = 0; i < NV; ++i) wg_at(x, i) = warp_sum(v[i]);
  if ((threadIdx.x & 31) == 0) red.warp[threadIdx.x >> 5] = x;
  bar_sync(1, Warps * 32);
  if (threadIdx.x == 0) {
    float b[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) b[i] = 0.f;
    for (int w = 0; w < Warps; ++w) {
      x = red.warp[w];
#pragma unroll
      for (int i = 0; i < NV; ++i) b[i] += wg_at(x, i);
    }
    for (int r = 0; r < G; ++r) {
      const uint32_t slot = cluster_addr(&red.slot[set][rank], r);
#pragma unroll
      for (int i = 0; i < NV; ++i) st_cluster(slot + 4 * i, b[i]);
      mbar_arrive_remote(cluster_addr(&red.bar[set], r));
    }
  }
  mbar_wait_cluster(&red.bar[set], (count >> 1) & 1);
  ++count;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = 0.f;
  for (int r = 0; r < G; ++r) {
    x = red.slot[set][r];
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += wg_at(x, i);
  }
}

// This thread's place in a sample group: sample s of the group, column
// group c, rows r and r + 8 (warp q of the warpgroup), columns cb + 8 j
// (+ 1) of the block's slab.
struct WgPlace {
  int s, c, q, r, cb;
};

__device__ __forceinline__ WgPlace wg_place(int warp, int cw) {
  const int lane = threadIdx.x & 31, c = warp / 4 % cw, q = warp & 3;
  return {warp / (4 * cw), c, q, 16 * q + (lane >> 2), c * kWgN + 2 * (lane & 3)};
}

// The sample's one value of this thread's sample slot s in a vector of
// the group's NV sums.
template <int NV>
__device__ __forceinline__ void wg_put(float (&v)[NV], int i, float x) {
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = j == i ? x : 0.f;
}

// acc += b, then the sample's mean and rstd over the cluster (two cluster
// sums; rows: this thread's rows hold a sample's positions).
template <int Warps, int NV>
__device__ __forceinline__ void wg_stats(float (&acc)[kWgAcc], const float* __restrict__ b,
                                         const WgPlace& p, bool rows, int c0, int SW, int HW,
                                         int Cout, float eps, WgRed<Warps, NV>& red, int& count,
                                         int G, int rank, float& mean, float& rstd) {
  const float inv_n = 1.f / (static_cast<float>(HW) * Cout);
  float v = 0.f, t[NV];
  if (rows) {
#pragma unroll
    for (int j = 0; j < kWgN / 8; ++j)
      if (p.c * kWgN + 8 * j < SW) {
        const float2 bb = *reinterpret_cast<const float2*>(b + c0 + p.cb + 8 * j);
        acc[4 * j] += bb.x;
        acc[4 * j + 1] += bb.y;
        acc[4 * j + 2] += bb.x;
        acc[4 * j + 3] += bb.y;
        v += (acc[4 * j] + acc[4 * j + 1]) + (acc[4 * j + 2] + acc[4 * j + 3]);
      }
  }
  wg_put(t, p.s, v);
  wg_cluster_sum(t, red, count, G, rank);
  mean = (p.s ? t[1] : t[0]) * inv_n;
  v = 0.f;
  if (rows) {
#pragma unroll
    for (int j = 0; j < kWgN / 8; ++j)
      if (p.c * kWgN + 8 * j < SW)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = acc[4 * j + i] - mean;
          v = fmaf(d, d, v);
        }
  }
  wg_put(t, p.s, v);
  wg_cluster_sum(t, red, count, G, rank);
  rstd = rsqrtf((p.s ? t[1] : t[0]) * inv_n + eps);
}

// The persistent sample kernel's body (both directions; a block of
// wg_threads(CW, S, F) threads): cluster i takes
// the sample groups S i, S (i + C), ... (C clusters in the grid); the
// loads of the next group are in flight while this one's statistics and
// epilogue run. For each group, the warpgroups take their product (x W +
// nothing; K = Cin) and call epi(acc, n, place, count): n the group's first
// sample, count the cluster sums taken so far.
template <int CW, int S, bool F, int NV, typename Epi>
__device__ __forceinline__ void wg_sample_loop(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                               unsigned char* smem, WgRing& ring,
                                               WgRed<4 * CW * S, NV>& red, int N, int Cin,
                                               int SW, int stages, Epi&& epi) {
  constexpr int kWarps = 4 * CW * S;   // the warpgroups' warps
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.x / G * S, dn = gridDim.x / G * S;
  const int steps = (Cin + kWgK - 1) / kWgK;
  const WgFeed f = {{xmap, xmap}, wmap, n0, dn, rank * SW, steps,
                    (N - n0 + dn - 1) / dn * steps};
  if (threadIdx.x == 0) {
    wg_ring_init(ring, smem, stages, kWarps);
    mbar_init(&red.bar[0], G);
    mbar_init(&red.bar[1], G);
    mbar_fence_init();
  }
  cluster.sync();                      // every block's barriers are set up
  // the warp index broadcast from lane 0: the compiler then knows that the
  // roles are warp-uniform, and keeps the products asynchronous
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  if (F && warp == kWarps) {
    if ((threadIdx.x & 31) == 0) wg_feed<CW, S, 1>(f, ring);
  } else {
    wg_prime<CW, S, 1, F>(f, ring);
    const WgPlace p = wg_place(warp, CW);
    int g = 0, count = 0;
    float acc[kWgAcc];
    for (int n = f.n0; n < N; n += f.dn) {
      wg_consume<CW, S, 1, F>(f, p.s, p.c, Cin, ring, g, acc);
      epi(acc, n, p, count);
    }
  }
  cluster.sync();                      // no block leaves while another may write to it
}

// The product kernel: out (N, HW, cols) in TO = the sum over the T terms of
// A_t (N, HW, depth) B (depth, cols), given B^T (cols, depth) (bmap), each
// sample's 64 x 176 CW tile a ring product (the bare product is N = 1, HW
// = 64, T = 1; the backward's dx = du W^T takes du's hi and lo halves as
// the two terms). Block b takes column chunk b % G (CW groups of 176 from
// 176 CW (b % G)) of the samples b / G, b / G + P, ... (P = gridDim / G
// walkers): persistent, its ring running ahead across samples.
template <int CW, int T, typename TO>
__global__ void __launch_bounds__(wg_threads(CW, 1), 1)
wg_product_kernel(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap a1,
                  const __grid_constant__ CUtensorMap bmap, TO* __restrict__ out, int N, int HW,
                  int depth, int cols, int G, int stages) {
  extern __shared__ unsigned char smem_wg[];
  __shared__ WgRing ring;
  const int n0 = blockIdx.x / G, dn = gridDim.x / G;
  const int steps = (depth + kWgK - 1) / kWgK;
  const WgFeed f = {{&a0, &a1}, &bmap, n0, dn, static_cast<int>(blockIdx.x % G) * CW * kWgN,
                    steps, (N - n0 + dn - 1) / dn * steps};
  if (threadIdx.x == 0) {
    wg_ring_init(ring, smem_wg, stages, 4 * CW);
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  if (wg_feeder(CW, 1) && warp == 4 * CW) {
    if (lane == 0) wg_feed<CW, 1, T>(f, ring);
    return;
  }
  wg_prime<CW, 1, T>(f, ring);
  const int c = warp >> 2, r = 16 * (warp & 3) + (lane >> 2);
  const int cb = f.c0 + c * kWgN + 2 * (lane & 3);
  float acc[kWgAcc];
  int g = 0;
  for (int n = f.n0; n < N; n += f.dn) {
    wg_consume<CW, 1, T>(f, 0, c, depth, ring, g, acc);
    if (16 * (warp & 3) >= HW) continue;
    TO* on = out + (static_cast<long>(n) * HW + r) * cols + cb;
#pragma unroll
    for (int j = 0; j < kWgN / 8; ++j)
      if (cb + 8 * j < cols)
#pragma unroll
        for (int h = 0; h < 2; ++h) {                     // rows r and r + 8
          TO* o = on + static_cast<long>(8 * h) * cols + 8 * j;
          if constexpr (std::is_same<TO, float>::value)
            *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          else
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
  }
}

// Launches wg_product_kernel: ceil(cols / 176 CW) column chunks, each with
// as many walkers as the card holds blocks for, at most N.
template <int CW, int T, typename TO>
int launch_product_walkers(const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& bmap,
                           TO* out, int N, int HW, int depth, int cols, cudaStream_t s) {
  auto kernel = wg_product_kernel<CW, T, TO>;
  constexpr int kThreads = wg_threads(CW, 1);
  const long smem = wg_smem(CW, 1, T);
  static int resident = 0;                       // asked once
  if (!resident) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) == cudaSuccess &&
        cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) ==
            cudaSuccess)
      resident = sms * per_sm;
    if (!resident) return cudaErrorInvalidConfiguration;
  }
  const int G = (cols + CW * kWgN - 1) / (CW * kWgN);
  int walkers = resident / G;
  walkers = walkers < 1 ? 1 : (walkers > N ? N : walkers);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<G * walkers, kThreads, smem, s>>>(a0, a1, bmap, out, N, HW, depth, cols, G,
                                             wg_stages(CW, 1, T));
  return cudaGetLastError();
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

// A tensor map of A (N, HW, depth) bf16 in boxes of S samples' 64 rows by
// kWgK.
int wg_amap(CUtensorMap* map, const void* a, int N, int HW, int depth, int S) {
  const cuuint64_t row = static_cast<cuuint64_t>(depth) * 2;
  const cuuint64_t d[3] = {static_cast<cuuint64_t>(depth), static_cast<cuuint64_t>(HW),
                           static_cast<cuuint64_t>(N)};
  const cuuint64_t st[2] = {row, row * HW};
  const cuuint32_t box[3] = {kWgK, kClnMaxRows, static_cast<cuuint32_t>(S)};
  return bf16_map(map, a, 3, d, st, box);
}

// A tensor map of B^T (cols, depth) bf16 in boxes of kWgN rows by kWgK.
int wg_bmap(CUtensorMap* map, const void* bt, int cols, int depth) {
  const cuuint64_t row = static_cast<cuuint64_t>(depth) * 2;
  const cuuint64_t d[2] = {static_cast<cuuint64_t>(depth), static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {kWgK, kWgN};
  return bf16_map(map, bt, 2, d, &row, box);
}

// Tensor maps of x (N, HW, Cin) (boxes of S samples' 64 rows by kWgK) and
// W^T (Cout, Cin) (boxes of kWgN rows by kWgK).
int wg_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x, const void* wt, int N, int HW,
            int Cin, int Cout, int S) {
  const int err = wg_amap(xmap, x, N, HW, Cin, S);
  return err ? err : wg_bmap(wmap, wt, Cout, Cin);
}

}  // namespace
