// The building blocks of the dw chain's persistent routes on Hopper
// (sm_90a), shared by the forward (fused_dw_chain.cu, kernel #9) and the
// backward (fused_dw_chain_bwd.cu, #10) in bf16: as many thread-block
// clusters of kPCluster blocks as the card holds, each walking the samples,
// a block's rank fixing its channel slice for the whole launch. Here: the
// constants, the statistics' static shared memory (PRed), the staged x's
// box width, the probe stamps, the fixed-order sums, a LayerNorm's block
// statistics and the one-exchange cluster merge (p_push / p_merge), the
// rearranged A&S GELU and its derivative, the conv down a grid column, and
// the host side: the resident clusters, x's tensor map and the launch
// configuration.
#pragma once

#include "dw_chain.cuh"
#include "wgmma.cuh"

namespace {

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

#ifdef VPTR_DW_STAMPS
// Probe builds only (scripts/torch_port_dw_probe.py): thread 0 of each
// block adds up the SM cycles of each phase over its samples (in shared
// memory, so that the sums take no registers), and keeps the global timer
// at its start and end.
constexpr int kStampSlots = 16;
__device__ long long g_dw_stamp[4096 * kStampSlots];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define VPTR_DW_STAMP_BEGIN                                   \
  __shared__ unsigned stamp_acc[kStampSlots - 2];             \
  const long long stamp_t0 = global_ns();                     \
  unsigned stamp_prev = static_cast<unsigned>(clock());       \
  if (threadIdx.x == 0)                                       \
    for (int k_ = 0; k_ < kStampSlots - 2; ++k_) stamp_acc[k_] = 0;
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

// gelu'(a) of the same GELU (gelu_and_grad_fast's derivative in p_gelu's
// form): the cdf 1 - h for a >= 0 and h below, h = poly(t) exp(-a^2 / 2)
// with p_gelu's halved coefficients, plus a times the normal pdf, whose
// exponential is the same exp(-a^2 / 2): a few ulp of f32 from gelu_grad.
__device__ __forceinline__ float p_gelu_grad(float a) {
  const float aa = fabsf(a);
  const float t = __fdividef(1.0f, fmaf(0.2316418882663604f, aa, 1.0f));
  const float poly =
      t * (0.127414796f +
           t * (-0.142248368f + t * (0.7107068705f + t * (-0.7265760135f + t * 0.5307027145f))));
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(aa * (aa * -0.7213475204444817f)));
  const float h = poly * e;
  return fmaf(a * 0.398942280401432678f, e, a >= 0.f ? 1.f - h : h);
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

// ---- host side

// The launch configuration of `clusters` clusters of kPCluster blocks of
// kPThreads threads (a non-portable cluster size) with smem bytes of
// dynamic shared memory on stream s.
struct PLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  PLaunch(int clusters, long smem, cudaStream_t s) {
    cfg.gridDim = dim3(static_cast<unsigned>(clusters * kPCluster), 1, 1);
    cfg.blockDim = dim3(kPThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = s;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kPCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  PLaunch(const PLaunch&) = delete;
};

// How many kPCluster-block clusters of `kernel` (the one persistent kernel
// of the including source) the card holds at once with smem bytes of
// dynamic shared memory (0 on an error; asked once for each smem).
template <typename K>
int p_resident(K kernel, long smem) {
  static long asked = -1;
  static int resident = 0;
  if (smem == asked) return resident;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  const PLaunch launch(64, smem, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &launch.cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  asked = smem;
  resident = n;
  return n;
}

// x (N, HW, C) bf16 as a tensor map of N HW rows: a box is one sample's
// rows of a block's slice, p_box_w(C / kPCluster) channels wide from a
// 16-byte boundary (zeros past C). Returns 0, or kTmaEncodeError + a
// CUresult.
int p_xmap(CUtensorMap* map, const void* x, int N, int HW, int C) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(N) * HW};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(p_box_w(C / kPCluster)),
                             static_cast<cuuint32_t>(HW)};
  const cuuint32_t ones[2] = {1, 1};
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return kTmaEncodeError + CUDA_ERROR_NOT_FOUND;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
                            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaEncodeError + static_cast<int>(r);
}

}  // namespace
