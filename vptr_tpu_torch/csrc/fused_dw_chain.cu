// The conv feed-forward's middle chain, forward, on Hopper (sm_90a):
// norm1 -> GELU -> dw3x3 -> norm2 -> GELU -> dropout over x (N, HW, C),
// the arithmetic of dw_chain.cuh; x and the output in T (float or bf16),
// taps (9, C), dwb (C) and the (HW, C) affines f32.
//
// Replaces the TPU kernel vptr_tpu/ops/fused_dw_chain.py::_forward
// (_fwd_kernel at :167, pl.pallas_call at :294). The backward is
// fused_dw_chain_bwd.cu.
//
// What bounds it on an H100: bytes. x read once and the output written
// once (2 x 54 MB in bf16 at N = 200, HW = 64, C = 2112) plus the
// parameters (2.2 MB) are ~110 MB, 0.033 ms at 3.35 TB/s; the f32
// arithmetic, ~80 flops an element, is 2.2 GFLOP (0.032 ms at 67 TFLOP/s).
//
// Two routes, chosen by the caller from the shape and dtype before the
// launch (vptr_fused_dw_chain_route; ops/fused_dw_chain.py::kernel_route):
// * "per_sample" (f32, and every shape the other refuses): one cluster of
//   kCluster blocks per sample, each block a 264-channel slice (at
//   far_mnist) in two f32 shared-memory buffers (x, then xhat1 and z1;
//   z2): device memory sees x once and the output once; the affines come
//   from L2 (every sample reads them).
// * "persistent" (bf16; p_route_ok says which shapes): as many clusters of
//   kPCluster = 16 blocks as the card holds (7 on an H100 SXM), each
//   walking the samples cluster id, + clusters, ... A block's rank fixes
//   its channel slice (132 channels at far_mnist) for the whole launch, so
//   its slice of the four affines, the taps and dwb go into shared memory
//   once, not once a sample. The next sample's x comes into a bf16 staging
//   buffer by TMA while this one computes. Each LayerNorm takes one cluster
//   exchange: every block's (sum, centred M2) is stored into every block
//   (st.async, completing on the receiver's barrier) and merged there in a
//   fixed order (Chan's formula), so the result is the same bits on every
//   run; a sample's exchanges are waited on after other work (the previous
//   sample's final pass, its own LN1 statistics). The conv walks a grid
//   column of a channel pair per thread with z1's three rows in registers
//   (z1 read three times, not nine; 8-row grids as straight-line code).
//   The GELUs are gelu_fast (gelu_as.cuh) in fewer operations (p_gelu).
//   What bounds it: the SMs' issue and shared-memory bandwidth (the
//   affines, z1, z2 and the staged x, ~450 KB a sample a block) and the
//   GELUs' two MUFU operations an element; device memory sees x and the
//   output once and the parameters once a cluster; 20 of the 132 SMs hold
//   no cluster.

#include <cstdio>

#include "dw_chain.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kFwdThreads = 32 * kDwWarps;   // loads in flight hide L2 latency

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kFwdThreads, 1)
dw_chain_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                const float* __restrict__ dwb, const float* __restrict__ s1,
                const float* __restrict__ b1, const float* __restrict__ s2,
                const float* __restrict__ b2, T* __restrict__ out, int HW, int W, int C,
                float eps, vptr_dropout::Params drop) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem_dw[];
  __shared__ Red red;
  const Slice sl(static_cast<int>(cluster.block_rank()), HW, W, C);
  const long n = blockIdx.x / kCluster;
  float* zb = smem_dw;                 // [HW][cw] x, then xhat1, then z1
  float* z2 = smem_dw + HW * sl.cw;    // [HW][cw]
  const long base = n * HW * C;
  const Stats st = chain_to_z2(x + base, taps, dwb, s1, b1, sl, zb, zb, z2, eps, red, cluster);
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  for (int q = threadIdx.x; q < sl.quads(); q += kFwdThreads) {
    int p, cl;
    sl.at(q, p, cl);
    const long o = sl.off(p, cl);
    const F4 z = ld4(z2 + sl.sm(p, cl)), sc = ld4(s2 + o), bi = ld4(b2 + o);
    F4 y;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      y.v[k] = vptr_gelu::gelu((z.v[k] - st.mean2) * st.rstd2 * sc.v[k] + bi.v[k]);
      if (drop.active())
        y.v[k] = drop.apply(y.v[k], drop.keep(static_cast<uint32_t>(base + o + k), seed));
    }
    st4(out + base + o, y);
  }
  cluster.sync();                      // the other blocks are done reading red
}

template <typename T>
int launch(const void* x, const void* taps, const void* dwb, const void* s1, const void* b1,
           const void* s2, const void* b2, void* out, int N, int HW, int W, int C, float eps,
           vptr_dropout::Params drop, cudaStream_t s) {
  const long smem = dw_smem(HW, C, 2);
  const cudaError_t err = cudaFuncSetAttribute(
      dw_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dw_chain_kernel<T><<<N * kCluster, kFwdThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps),
      static_cast<const float*>(dwb), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(out), HW, W, C, eps, drop);
  return cudaGetLastError();
}

// ---- the bf16 route: persistent clusters of kPCluster blocks

constexpr int kPCluster = 16;         // blocks a cluster (a non-portable size)
constexpr int kPWarps = 16;
constexpr int kPThreads = 32 * kPWarps;
constexpr int kPMaxQ = 5;             // channel quads of x a thread holds
constexpr int kPSets = 4;             // exchange slot sets, used in turn
constexpr long kPSmemLimit = 232448 - 1024 - 2048;   // less the reserve and PRed

// Static shared memory of the statistics: each warp's (sum, M2) in two
// sets (LN1, LN2), each warp's element count and its reciprocal, each
// rank's (sum, M2) of an exchange in kPSets sets used in turn with their
// barriers, and the staged x's barrier.
struct PRed {
  float2 warp[2][kPWarps];
  float count[kPWarps], inv_count[kPWarps];
  float2 slot[kPSets][kPCluster];
  uint64_t bar[kPSets];
  uint64_t xbar;
};
static_assert(sizeof(PRed) <= 2048, "PRed must fit in what kPSmemLimit leaves");

// Channels of a staged row (the TMA box's width). A box starts on a
// 16-byte boundary, eight channels: a slice of cw = 4 mod 8 channels
// starts 4 channels into a piece on every other rank, so the box takes the
// cw + 4 channels from that boundary (the channels outside the slice are
// read and not used; past C they read zero).
__host__ __device__ __forceinline__ int p_box_w(int cw) { return cw + cw % 8; }

// Dynamic shared memory of a persistent block for (HW, C), with cw = C /
// kPCluster and E = HW cw: 128 bytes to align the staged x, the staged bf16
// x (HW rows of p_box_w(cw)), the four affines, z1 and z2 in f32 (E each),
// taps and dwb (10 cw f32).
long p_smem(int HW, int C) {
  const long cw = C / kPCluster, e = static_cast<long>(HW) * cw;
  return 128 + 2L * HW * p_box_w(static_cast<int>(cw)) + 4 * (6 * e + 10 * cw);
}

// The shapes the persistent route takes (dtype 1 = bf16). The staged x is
// one TMA box (at most 256 rows and 256 channels); a thread holds x's
// quads of its share (at most kPMaxQ).
bool p_route_ok(int HW, int W, int C, int dtype) {
  return dtype == 1 && HW >= 1 && HW <= 256 && W >= 1 && HW % W == 0 &&
         C >= 4 * kPCluster && C % (4 * kPCluster) == 0 && p_box_w(C / kPCluster) <= 256 &&
         p_smem(HW, C) <= kPSmemLimit &&
         HW * (C / kPCluster / 4) <= kPMaxQ * kPThreads;
}

#ifdef VPTR_DW_STAMPS
// Probe builds only (scripts/torch_port_dw_probe.py): thread 0 of each
// block adds up the SM cycles of each phase over its samples, and keeps
// the global timer at its start and end.
constexpr int kStampSlots = 16;
__device__ long long g_dw_stamp[4096 * kStampSlots];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define VPTR_DW_STAMP_BEGIN                                   \
  const long long stamp_t0 = global_ns();                     \
  unsigned stamp_prev = static_cast<unsigned>(clock()), stamp_acc[kStampSlots - 2] = {};
#define VPTR_DW_STAMP(k)                                      \
  if (threadIdx.x == 0) {                                     \
    const unsigned t_ = static_cast<unsigned>(clock());       \
    stamp_acc[k] += t_ - stamp_prev;                          \
    stamp_prev = t_;                                          \
  }
#define VPTR_DW_STAMP_END                                                      \
  if (threadIdx.x == 0) {                                                      \
    long long* s_ = g_dw_stamp + blockIdx.x * kStampSlots;                     \
    for (int k_ = 0; k_ < kStampSlots - 2; ++k_) s_[k_] = stamp_acc[k_];       \
    s_[kStampSlots - 2] = stamp_t0;                                            \
    s_[kStampSlots - 1] = global_ns();                                         \
  }
#else
#define VPTR_DW_STAMP_BEGIN
#define VPTR_DW_STAMP(k)
#define VPTR_DW_STAMP_END
#endif

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// a[0] + ... + a[N - 1] as a tree of pairwise sums: a fixed order, and a
// short chain of dependent adds on the critical path.
template <int N>
__device__ __forceinline__ float tree_sum(float (&a)[N]) {
#pragma unroll
  for (int h = 1; h < N; h *= 2)
#pragma unroll
    for (int i = 0; i + h < N; i += 2 * h) a[i] += a[i + h];
  return a[0];
}

// A thread's sum s of its first nk quads of v, and their M2 q about their
// own mean (inv_t = 1 / (4 nk), or 0); a quad at a time, in a tree.
__device__ __forceinline__ void p_thread_stats(const F4 (&v)[kPMaxQ], int nk, float inv_t,
                                               float& s, float& q) {
  float a[kPMaxQ];
#pragma unroll
  for (int k = 0; k < kPMaxQ; ++k) a[k] = k < nk ? sum4(v[k]) : 0.f;
  s = tree_sum(a);
  const float mt = s * inv_t;
#pragma unroll
  for (int k = 0; k < kPMaxQ; ++k) {
    a[k] = 0.f;
    if (k < nk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = v[k].v[e] - mt;
        a[k] = fmaf(d, d, a[k]);
      }
  }
  q = tree_sum(a);
}

// The block's (sum, M2 about the block's mean) from each thread's (s, q)
// over its nt values (inv_t = 1 / nt or 0), in every thread: each warp
// merges its lanes and the block its warps (Chan: M2 = sum M2_i + n_i
// (mean_i - mean)^2) in a fixed order, with red.warp[set]; every thread
// gets the same bits. One __syncthreads.
__device__ __forceinline__ void p_block_stats(float s, float q, float nt, float inv_t,
                                              float inv_e, PRed& red, int set, float& sum,
                                              float& m2) {
  const int warp = threadIdx.x >> 5;
  const float sw = warp_sum(s);
  const float d = s * inv_t - sw * red.inv_count[warp];
  const float qw = warp_sum(fmaf(nt * d, d, q));
  if ((threadIdx.x & 31) == 0) red.warp[set][warp] = make_float2(sw, qw);
  __syncthreads();
  float a[kPWarps], b[kPWarps];
#pragma unroll
  for (int w = 0; w < kPWarps; ++w) a[w] = red.warp[set][w].x;
  sum = tree_sum(a);
  const float mb = sum * inv_e;
#pragma unroll
  for (int w = 0; w < kPWarps; ++w) {
    const float2 p = red.warp[set][w];
    const float dw = p.x * red.inv_count[w] - mb;
    b[w] = fmaf(red.count[w] * dw, dw, p.y);
  }
  m2 = tree_sum(b);
}

// Exchange k of the sample statistics over the cluster, in two halves.
// p_push: thread r stores this block's (sum, M2) into slot [k % kPSets]
// [rank] of the cluster's block r with st.async, which completes 8 bytes
// of that block's barrier's transaction (the storing thread does not wait);
// thread 0 expects the kPCluster pairs on this block's barrier.
// p_merge: waits for them and merges the pairs in a fixed tree over the
// ranks (Chan, n_r = E elements a block), so every block holds the same
// bits on every run.
// No cluster-wide barrier. Exchanges are pushed in order and merged in
// order, and a block pushes k only after merging k - 2: every block has
// then merged k - 4 (read its set and seen its phase end) before any block
// pushes k into the same set.
__device__ __forceinline__ void p_push(float sum, float m2, PRed& red, int k, int rank) {
  if (threadIdx.x < kPCluster) {
    const int r = static_cast<int>(threadIdx.x);
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];" ::"r"(
            cluster_addr(&red.slot[k % kPSets][rank], r)),
        "f"(sum), "f"(m2), "r"(cluster_addr(&red.bar[k % kPSets], r))
        : "memory");
  }
  mbar_expect_tx(&red.bar[k % kPSets], kPCluster * 8, threadIdx.x == 0);
}

__device__ __forceinline__ void p_merge(PRed& red, int k, float n_r, float inv_nr, float inv_n,
                                        float eps, float& mean, float& rstd) {
  const int set = k % kPSets;
  mbar_wait_cluster(&red.bar[set], (k / kPSets) & 1);
  float a[kPCluster], b[kPCluster];
#pragma unroll
  for (int r = 0; r < kPCluster; ++r) a[r] = red.slot[set][r].x;
  mean = tree_sum(a) * inv_n;
#pragma unroll
  for (int r = 0; r < kPCluster; ++r) {
    const float2 p = red.slot[set][r];
    const float d = p.x * inv_nr - mean;
    b[r] = fmaf(n_r * d, d, p.y);
  }
  rstd = rsqrtf(tree_sum(b) * inv_n + eps);
}

// A channel pair of f32 (8-byte shared-memory accesses).
struct F2 {
  float v[2];
};
__device__ __forceinline__ F2 ld2(const float* p) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  return {{t.x, t.y}};
}
__device__ __forceinline__ void st2(float* p, const F2& f) {
  *reinterpret_cast<float2*>(p) = make_float2(f.v[0], f.v[1]);
}

// The A&S GELU of gelu_as.cuh (gelu_fast) in fewer operations: with t =
// 1 / (1 + p |a| / sqrt 2) and h = a poly(t) exp(-a^2 / 2) / 2, gelu(a) =
// a - h for a >= 0 and h below (poly's coefficients halved, the constants
// folded, exp by ex2.approx): a few ulp of f32 from gelu_fast.
__device__ __forceinline__ float p_gelu(float a) {
  const float aa = fabsf(a);
  const float t = __fdividef(1.0f, fmaf(0.2316418882663604f, aa, 1.0f));
  const float poly =
      t * (0.127414796f +
           t * (-0.142248368f + t * (0.7107068705f + t * (-0.7265760135f + t * 0.5307027145f))));
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(aa * (aa * -0.7213475204444817f)));
  const float h = a * (poly * e);
  return a >= 0.f ? a - h : h;
}

// z2 down one grid column j for one channel pair (slice channels cl, cl +
// 1): dwb + the nine taps (row-major (dy, dx), in that order, zero
// padding) over z1, with the rows i - 1, i, i + 1 of the column and its two
// neighbours in registers (four sets turned round: each row of z1 is read
// once, and the next row's loads are in flight while a row is summed);
// written to z2. kH: the rows when known at compile time (the column is
// then straight-line code, its loads scheduled ahead), else 0 (H rows).
template <int kH>
__device__ __forceinline__ void p_conv_column(const float* z1, float* z2, const float* tp,
                                               int j, int cl, int cw, int W, int H) {
  if (kH) H = kH;
  F2 t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = ld2(tp + k * cw + cl);
  const F2 bias = ld2(tp + 9 * cw + cl);
  const bool left = j > 0, right = j + 1 < W;
  const int col = j * cw + cl, rs = W * cw;
  const F2 zero = {{0.f, 0.f}};
  auto load = [&](F2(&r)[3], int i) {
    const float* p = z1 + i * rs + col;
    const bool in = i < H;
    r[0] = in && left ? ld2(p - cw) : zero;
    r[1] = in ? ld2(p) : zero;
    r[2] = in && right ? ld2(p + cw) : zero;
  };
  auto emit = [&](int i, const F2(&a)[3], const F2(&b)[3], const F2(&c)[3]) {
    F2 acc;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = bias.v[e];
      v = fmaf(a[0].v[e], t[0].v[e], v);
      v = fmaf(a[1].v[e], t[1].v[e], v);
      v = fmaf(a[2].v[e], t[2].v[e], v);
      v = fmaf(b[0].v[e], t[3].v[e], v);
      v = fmaf(b[1].v[e], t[4].v[e], v);
      v = fmaf(b[2].v[e], t[5].v[e], v);
      v = fmaf(c[0].v[e], t[6].v[e], v);
      v = fmaf(c[1].v[e], t[7].v[e], v);
      v = fmaf(c[2].v[e], t[8].v[e], v);
      acc.v[e] = v;
    }
    st2(z2 + i * rs + col, acc);
  };
  if constexpr (kH > 0) {
    F2 up[3] = {zero, zero, zero}, mid[3], dn[3];
    load(mid, 0);
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      load(dn, i + 1);
      emit(i, up, mid, dn);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        up[d] = mid[d];
        mid[d] = dn[d];
      }
    }
  } else {
    F2 r0[3] = {zero, zero, zero}, r1[3], r2[3], r3[3];
    load(r1, 0);
    load(r2, 1);
    for (int i = 0; i < H; i += 4) {   // r0, r1, r2 hold rows i - 1, i, i + 1
      load(r3, i + 2);
      emit(i, r0, r1, r2);
      if (i + 1 == H) break;
      load(r0, i + 3);
      emit(i + 1, r1, r2, r3);
      if (i + 2 == H) break;
      load(r1, i + 4);
      emit(i + 2, r2, r3, r0);
      if (i + 3 == H) break;
      load(r2, i + 5);
      emit(i + 3, r3, r0, r1);
    }
  }
}

// z2 at row i of grid column j, channel pair cl (as p_conv_column, one row
// alone: the pair-columns past whole rounds of kPThreads are shared out by
// rows, so no thread takes one more column than the others); written to z2.
__device__ __forceinline__ void p_conv_point(const float* z1, float* z2, const float* tp, int i,
                                              int j, int cl, int cw, int W, int H) {
  const int col = j * cw + cl, rs = W * cw;
  F2 acc = ld2(tp + 9 * cw + cl);
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const bool in = i + dy >= 0 && i + dy < H && j + dx >= 0 && j + dx < W;
      const F2 z = in ? ld2(z1 + (i + dy) * rs + col + dx * cw) : F2{{0.f, 0.f}};
      const F2 t = ld2(tp + ((dy + 1) * 3 + dx + 1) * cw + cl);
#pragma unroll
      for (int e = 0; e < 2; ++e) acc.v[e] = fmaf(z.v[e], t.v[e], acc.v[e]);
    }
  st2(z2 + i * rs + col, acc);
}

// One persistent cluster walks the samples n = cluster id, + clusters, ...
// Two layouts of a block's slice: x, z1, z2's statistics and the final pass
// in quads, a thread's share in turn (quad threadIdx.x + k kPThreads); the
// conv in the grid's P = W cw / 2 pair-columns (thread t takes columns t,
// t + kPThreads, ... of the whole rounds, and points t, t + kPThreads, ...
// of the columns past them, one grid row each). A sample's steps, with
// the exchanges' waits put off behind other work:
//   LN1's block statistics of the staged x (TMA, waited on its barrier);
//   exchange 2 n pushed; the previous sample's final pass (its exchange
//   2 n - 1 merged; z2 read back from shared memory); exchange 2 n merged;
//   z1 from the staged x (read again: x is not held in registers across
//   the final pass) into shared memory; the next sample's x requested into
//   the staging buffer; the conv into z2; LN2's block statistics from z2;
//   exchange 2 n + 1 pushed.
// The last sample's final pass follows the loop.
__global__ void __launch_bounds__(kPThreads, 1)
dw_chain_persistent_kernel(const __grid_constant__ CUtensorMap xmap,
                           const float* __restrict__ taps, const float* __restrict__ dwb,
                           const float* __restrict__ s1, const float* __restrict__ b1,
                           const float* __restrict__ s2, const float* __restrict__ b2,
                           bf16* __restrict__ out, int N, int HW, int W, int C, float eps,
                           vptr_dropout::Params drop) {
  extern __shared__ float4 smem_p[];
  __shared__ PRed red;
  VPTR_DW_STAMP_BEGIN
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = static_cast<int>(blockIdx.x) / kPCluster;
  const int ncl = static_cast<int>(gridDim.x) / kPCluster;
  const int cw = C / kPCluster, c0 = rank * cw, nq = cw / 4, np = cw / 2, H = HW / W;
  const int bw = p_box_w(cw), lead = c0 % 8;   // lead: the slice's first channel in a staged row
  const int E = HW * cw, Q = HW * nq;
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_p);
  bf16* stage = reinterpret_cast<bf16*>(base + ((128 - (smem_u32(base) & 127)) & 127));
  float* aff = reinterpret_cast<float*>(stage + HW * bw);   // s1, b1, s2, b2: [4][HW][cw]
  float* z1 = aff + 4 * E;                                 // [HW][cw]
  float* z2 = z1 + E;                                      // [HW][cw]
  float* tp = z2 + E;                                      // taps [9][cw], then dwb [cw]
  const long sample = static_cast<long>(HW) * C;
  const int t = static_cast<int>(threadIdx.x);

  // the quad layout: this thread's quads k < nk, at ox[k] in the staged x,
  // os[k] in a [HW][cw] buffer and og[k] in a sample
  int ox[kPMaxQ], os[kPMaxQ], og[kPMaxQ];
#pragma unroll
  for (int k = 0; k < kPMaxQ; ++k) {
    const int q = t + k * kPThreads;
    const int p = q / nq, cl = (q - p * nq) * 4;
    ox[k] = p * bw + lead + cl;
    os[k] = p * cw + cl;
    og[k] = p * C + c0 + cl;
  }
  const int nk = (Q - t + kPThreads - 1) / kPThreads;
  const float nt = 4.f * nk, inv_t = nk > 0 ? 1.f / nt : 0.f;
  // the conv's layout: pair-columns whole below `whole`, by points above
  const int P = np * W, whole = P / kPThreads * kPThreads;

  // the block's slices of the affines, the taps and dwb, once a launch
  const float* affs[4] = {s1, b1, s2, b2};
#pragma unroll
  for (int a = 0; a < 4; ++a)
    for (int q = t; q < Q; q += kPThreads) {
      const int p = q / nq, cl = (q - p * nq) * 4;
      cp_async16(aff + a * E + p * cw + cl, affs[a] + static_cast<long>(p) * C + c0 + cl);
    }
  for (int q = t; q < 10 * nq; q += kPThreads) {
    const int r = q / nq, cl = (q - r * nq) * 4;
    cp_async16(tp + r * cw + cl, (r < 9 ? taps + static_cast<long>(r) * C : dwb) + c0 + cl);
  }
  const uint32_t box_bytes = 2u * HW * bw;
  if (t == 0) {
    for (int s = 0; s < kPSets; ++s) mbar_init(&red.bar[s], 1);
    mbar_init(&red.xbar, 1);
    mbar_fence_init();
    mbar_expect_tx(&red.xbar, box_bytes, true);
    tma_load_2d(stage, &xmap, &red.xbar, c0 - lead, cid * HW, true);
  }
  {
    const float nw = warp_sum(nt);
    if ((t & 31) == 0) {
      red.count[t >> 5] = nw;
      red.inv_count[t >> 5] = nw > 0.f ? 1.f / nw : 0.f;
    }
  }
  cluster.sync();                      // barriers and counts set up before any use
  VPTR_DW_STAMP(0)

  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  const float rcp = 1.f / drop.keep_div;
  const float n_r = static_cast<float>(E), inv_nr = 1.f / n_r;
  const float inv_n = 1.f / (static_cast<float>(HW) * C);

  // the block's statistics of the quads of buffer `src` (this thread's at
  // offsets off[k]), pushed as exchange k2 with set `set` of the warp sums
  auto stats = [&](const auto* src, const int (&off)[kPMaxQ], int set, int k2) {
    F4 v[kPMaxQ];
#pragma unroll
    for (int k = 0; k < kPMaxQ; ++k)
      if (k < nk) v[k] = ld4(src + off[k]);
    float s, q, sum, m2;
    p_thread_stats(v, nk, inv_t, s, q);
    p_block_stats(s, q, nt, inv_t, inv_nr, red, set, sum, m2);
    p_push(sum, m2, red, k2, rank);
  };
  // the final pass of sample n: z2 (shared memory) normalised with (mean,
  // rstd), the affine, the GELU, the dropout, stored
  auto final_pass = [&](int n, float mean, float rstd) {
    const float shift = -mean * rstd;  // (z - mean) rstd as one fma
    bf16* o = out + n * sample;
    const uint32_t at = static_cast<uint32_t>(n * sample);
#pragma unroll
    for (int k = 0; k < kPMaxQ; ++k)
      if (k < nk) {
        const F4 z = ld4(z2 + os[k]), sc = ld4(aff + 2 * E + os[k]),
                 bi = ld4(aff + 3 * E + os[k]);
        F4 y;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y.v[e] = p_gelu(fmaf(z.v[e], rstd, shift) * sc.v[e] + bi.v[e]);
          if (drop.active())
            y.v[e] = drop.apply_rcp(
                y.v[e], drop.keep(at + static_cast<uint32_t>(og[k] + e), seed), rcp);
        }
        st4(o + og[k], y);
      }
  };

  int it = 0, n = cid;
  for (; n < N; ++it, n += ncl) {
    mbar_wait(&red.xbar, it & 1);      // this sample's x is staged
    VPTR_DW_STAMP(1)
    stats(stage, ox, 0, 2 * it);
    VPTR_DW_STAMP(2)
    float mean, rstd;
    if (it > 0) {
      p_merge(red, 2 * it - 1, n_r, inv_nr, inv_n, eps, mean, rstd);
      VPTR_DW_STAMP(3)
      final_pass(n - ncl, mean, rstd);
      VPTR_DW_STAMP(4)
    }
    p_merge(red, 2 * it, n_r, inv_nr, inv_n, eps, mean, rstd);
    if (it == 0) {                     // the parameters are in
      cp_async_wait_all();
      __syncthreads();
    }
    const float shift = -mean * rstd;  // (x - mean) rstd as one fma
    VPTR_DW_STAMP(5)
#pragma unroll
    for (int k = 0; k < kPMaxQ; ++k)
      if (k < nk) {
        const F4 x = ld4(stage + ox[k]), sc = ld4(aff + os[k]), bi = ld4(aff + E + os[k]);
        F4 z;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          z.v[e] = p_gelu(fmaf(x.v[e], rstd, shift) * sc.v[e] + bi.v[e]);
        st4(z1 + os[k], z);
      }
    __syncthreads();                   // z1 is complete, the staged x and the final pass done
    if (t == 0 && n + ncl < N) {
      fence_proxy_async();
      mbar_expect_tx(&red.xbar, box_bytes, true);
      tma_load_2d(stage, &xmap, &red.xbar, c0 - lead, (n + ncl) * HW, true);
    }
    VPTR_DW_STAMP(6)
    for (int c = t; c < whole; c += kPThreads) {
      const int j = c / np;
      if (H == 8)
        p_conv_column<8>(z1, z2, tp, j, (c - j * np) * 2, cw, W, H);
      else
        p_conv_column<0>(z1, z2, tp, j, (c - j * np) * 2, cw, W, H);
    }
    for (int r = t; r < (P - whole) * H; r += kPThreads) {
      const int c = whole + r / H, j = c / np;
      p_conv_point(z1, z2, tp, r % H, j, (c - j * np) * 2, cw, W, H);
    }
    __syncthreads();                   // z2 is complete
    VPTR_DW_STAMP(7)
    stats(z2, os, 1, 2 * it + 1);
    VPTR_DW_STAMP(8)
  }
  if (it > 0) {
    float mean, rstd;
    p_merge(red, 2 * it - 1, n_r, inv_nr, inv_n, eps, mean, rstd);
    VPTR_DW_STAMP(3)
    final_pass(n - ncl, mean, rstd);
    VPTR_DW_STAMP(4)
  }
  cluster.sync();                      // no block leaves while a push into it may be on its way
  VPTR_DW_STAMP(9)
  VPTR_DW_STAMP_END
}

// How many kPCluster-block clusters of the persistent kernel the card
// holds at once with smem bytes of dynamic shared memory (0 on an error;
// asked once for each smem).
int p_resident(long smem) {
  static long asked = -1;
  static int resident = 0;
  if (smem == asked) return resident;
  const auto kernel = dw_chain_persistent_kernel;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kPCluster * 64, 1, 1);
  cfg.blockDim = dim3(kPThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kPCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  asked = smem;
  resident = n;
  return n;
}

int launch_persistent(const void* x, const void* taps, const void* dwb, const void* s1,
                      const void* b1, const void* s2, const void* b2, void* out, int N, int HW,
                      int W, int C, float eps, vptr_dropout::Params drop, cudaStream_t s) {
  const long smem = p_smem(HW, C);
  const int resident = p_resident(smem);
  if (resident < 1) return cudaErrorInvalidConfiguration;   // a cluster does not fit
  // x as (N HW rows, C) bf16; a box is one sample's rows of a block's
  // slice, p_box_w(C / kPCluster) channels wide from a 16-byte boundary
  // (zeros past C)
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(N) * HW};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(p_box_w(C / kPCluster)),
                             static_cast<cuuint32_t>(HW)};
  const cuuint32_t ones[2] = {1, 1};
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return kTmaEncodeError + CUDA_ERROR_NOT_FOUND;
  const CUresult r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
                            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kTmaEncodeError + static_cast<int>(r);
  const int clusters = N < resident ? N : resident;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kPCluster), 1, 1);
  cfg.blockDim = dim3(kPThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kPCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dw_chain_persistent_kernel, xmap, static_cast<const float*>(taps),
      static_cast<const float*>(dwb), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), N, HW, W, C, eps, drop);
  return err != cudaSuccess ? err : cudaGetLastError();
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

// Dynamic shared memory a block takes for (HW, C), in bytes; more than
// 231,000 or so (the limit less the static reduction scratch) means the
// shape is not supported. C must be a multiple of 32.
long vptr_fused_dw_chain_smem(int HW, int C) { return dw_smem(HW, C, 2); }

// Clusters (samples) of the per-sample kernel in bf16 the card runs at once
// for (HW, C).
int vptr_fused_dw_chain_clusters(int HW, int C) {
  return resident_clusters(dw_chain_kernel<bf16>, kFwdThreads, dw_smem(HW, C, 2));
}

// The persistent route's clusters of kPCluster blocks the card holds at
// once for (HW, W, C) (0: the route does not take the shape, or none fits).
int vptr_fused_dw_chain_persistent_clusters(int HW, int W, int C) {
  return p_route_ok(HW, W, C, 1) ? p_resident(p_smem(HW, C)) : 0;
}

// The route for (HW, W, C, dtype): 1 = persistent, 0 = per_sample.
int vptr_fused_dw_chain_route(int HW, int W, int C, int dtype) {
  return p_route_ok(HW, W, C, dtype);
}

// dtype: 0 = float32, 1 = bfloat16; W the row-grid width (HW = H * W);
// route as vptr_fused_dw_chain_route names it (a shape the route does not
// take is refused). seed (device int32) may be null when rate == 0;
// keep_div = (float)(1 - rate). Returns a cudaError_t (0 = launched).
int vptr_fused_dw_chain(const void* x, const void* taps, const void* dwb, const void* s1,
                        const void* b1, const void* s2, const void* b2, void* out, int N,
                        int HW, int W, int C, float eps, const void* seed, float rate,
                        float keep_div, int dtype, int route, void* stream) {
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || !dw_shape_ok(HW, W, C) || dtype < 0 || dtype > 1 || route < 0 || route > 1 ||
      (rate > 0.f && !seed) || rate >= 1.f)
    return cudaErrorInvalidValue;
  if (route == 1)
    return p_route_ok(HW, W, C, dtype)
               ? launch_persistent(x, taps, dwb, s1, b1, s2, b2, out, N, HW, W, C, eps, drop, s)
               : cudaErrorInvalidValue;
  if (dw_smem(HW, C, 2) > kDwSmemLimit) return cudaErrorInvalidValue;
  return dtype == 0 ? launch<float>(x, taps, dwb, s1, b1, s2, b2, out, N, HW, W, C, eps, drop, s)
                    : launch<bf16>(x, taps, dwb, s1, b1, s2, b2, out, N, HW, W, C, eps, drop, s);
}

}  // extern "C"
