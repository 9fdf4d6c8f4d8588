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
// Three routes, chosen by the caller from the shape and dtype before the
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
// * "tiled" (both dtypes, the shapes whose per-sample block does not fit;
//   t_route_ok says which): nar_kth_128's 16 x 16 x 2112 samples, in three
//   passes through device memory with per-tile partial moments
//   (dw_tiled.cuh, whose note says what bounds it).

#include <cstdio>

#include "dw_persistent.cuh"
#include "dw_tiled.cuh"

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

// ---- the bf16 route: persistent clusters of kPCluster blocks (dw_persistent.cuh)

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

int launch_persistent(const void* x, const void* taps, const void* dwb, const void* s1,
                      const void* b1, const void* s2, const void* b2, void* out, int N, int HW,
                      int W, int C, float eps, vptr_dropout::Params drop, cudaStream_t s) {
  const long smem = p_smem(HW, C);
  const int resident = p_resident(dw_chain_persistent_kernel, smem);
  if (resident < 1) return cudaErrorInvalidConfiguration;   // a cluster does not fit
  CUtensorMap xmap;
  const int r = p_xmap(&xmap, x, N, HW, C);
  if (r) return r;
  const PLaunch launch(N < resident ? N : resident, smem, s);
  const cudaError_t err = cudaLaunchKernelEx(
      &launch.cfg, dw_chain_persistent_kernel, xmap, static_cast<const float*>(taps),
      static_cast<const float*>(dwb), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), N, HW, W, C, eps, drop);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---- the tiled route (dw_tiled.cuh): x's moments, z2 and its moments,
// then the output

// Step 0: x's moments into part; 1 (stats[0] merged): z2 and its moments
// into part; 2 (stats[1] merged): the output.
template <typename T>
int tiled_step(int step, const void* x, const void* taps, const void* dwb, const void* s1,
               const void* b1, const void* s2, const void* b2, void* out, void* z2, void* part,
               void* stats, int N, int HW, int W, int C, vptr_dropout::Params drop,
               cudaStream_t s) {
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const float* st = cf(stats);
  if (step < 2)
    return dwt_z2_step<T>(step, static_cast<const T*>(x), cf(taps), cf(dwb), cf(s1), cf(b1),
                          st, static_cast<float*>(z2), static_cast<float*>(part), N, HW, W, C,
                          s);
  dwt_out_kernel<T><<<dim3(t_cols(C), HW / W, N), kTThreads, 0, s>>>(
      cf(z2), cf(s2), cf(b2), st + 2 * N, static_cast<T*>(out), HW, W, C, drop);
  return cudaGetLastError();
}

template <typename T>
int launch_tiled(const void* x, const void* taps, const void* dwb, const void* s1,
                 const void* b1, const void* s2, const void* b2, void* out, void* z2, void* part,
                 void* stats, int N, int HW, int W, int C, float eps, vptr_dropout::Params drop,
                 cudaStream_t s) {
  VPTR_TRY(dwt_to_z2<T>(static_cast<const T*>(x), static_cast<const float*>(taps),
                        static_cast<const float*>(dwb), static_cast<const float*>(s1),
                        static_cast<const float*>(b1), static_cast<float*>(z2),
                        static_cast<float*>(part), static_cast<float*>(stats), N, HW, W, C, eps,
                        s));
  return tiled_step<T>(2, x, taps, dwb, s1, b1, s2, b2, out, z2, part, stats, N, HW, W, C, drop,
                       s);
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
  return p_route_ok(HW, W, C, 1) ? p_resident(dw_chain_persistent_kernel, p_smem(HW, C)) : 0;
}

// The route for (HW, W, C, dtype): 1 = persistent, 2 = tiled (the shapes
// whose per-sample block needs more than kDwRouteSmem bytes), 0 =
// per_sample.
int vptr_fused_dw_chain_route(int HW, int W, int C, int dtype) {
  if (p_route_ok(HW, W, C, dtype)) return 1;
  return dw_smem(HW, C, 2) > kDwRouteSmem && t_route_ok(HW, W, C) ? 2 : 0;
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

// The tiled route on any shape it takes (t_route_ok; N <= 65535), with
// the caller's f32 scratch: z2 (N, HW, C), part (N, T, 2) and stats (2, N,
// 2), T = HW / W x C / 32. The other arguments as vptr_fused_dw_chain's.
int vptr_fused_dw_chain_tiled(const void* x, const void* taps, const void* dwb, const void* s1,
                              const void* b1, const void* s2, const void* b2, void* out,
                              void* z2, void* part, void* stats, int N, int HW, int W, int C,
                              float eps, const void* seed, float rate, float keep_div, int dtype,
                              void* stream) {
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kTMaxN || !t_route_ok(HW, W, C) || dtype < 0 || dtype > 1 ||
      (rate > 0.f && !seed) || rate >= 1.f || !z2 || !part || !stats)
    return cudaErrorInvalidValue;
  return dtype == 0
             ? launch_tiled<float>(x, taps, dwb, s1, b1, s2, b2, out, z2, part, stats, N, HW, W,
                                   C, eps, drop, s)
             : launch_tiled<bf16>(x, taps, dwb, s1, b1, s2, b2, out, z2, part, stats, N, HW, W,
                                  C, eps, drop, s);
}

// The tiled route split at its two LayerNorms' statistics, for a call over
// channels col0 .. col0 + C - 1 of mask_cols whose LayerNorms run over
// every share's channels (tensor parallelism; dw_tiled.cuh's note): step 0
// writes x's per-(sample, tile) moments into part (N, HW / W, ceil(C /
// 32), 2); the caller merges every share's, in the whole call's tile
// order, into stats[0] (vptr_fused_dw_chain_tiled_merge); step 1 writes z2
// and its moments into part, merged likewise into stats[1]; step 2 the
// output, its dropout at the global channel. C is any share (t_split_ok:
// where 32 does not divide it, each grid row ends in a partial tile). The
// operands as vptr_fused_dw_chain_tiled's.
int vptr_fused_dw_chain_tiled_step(int step, const void* x, const void* taps, const void* dwb,
                                   const void* s1, const void* b1, const void* s2,
                                   const void* b2, void* out, void* z2, void* part, void* stats,
                                   int N, int HW, int W, int C, const void* seed, float rate,
                                   float keep_div, int mask_cols, int col0, int dtype,
                                   void* stream) {
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div, mask_cols,
                                  col0};
  if (step < 0 || step > 2 || N < 1 || N > kTMaxN || !t_split_ok(HW, W, C) || dtype < 0 ||
      dtype > 1 || (rate > 0.f && !seed) || rate >= 1.f || col0 < 0 ||
      (mask_cols && col0 + C > mask_cols) || !z2 || !part || !stats)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? tiled_step<float>(step, x, taps, dwb, s1, b1, s2, b2, out, z2, part,
                                        stats, N, HW, W, C, drop, s)
                    : tiled_step<bf16>(step, x, taps, dwb, s1, b1, s2, b2, out, z2, part,
                                       stats, N, HW, W, C, drop, s);
}

// A split call's merge (forward and backward): out (N, 2) from part (N, T,
// 2) in the whole call's order: T = grid rows x shares x ceil(C / 32)
// tiles of a share of C channels (C a multiple of 32: whole tiles of W x
// 32 values; else each share's last tile of a grid row holds W (C mod 32)
// values and every tile is weighed by its count); mode 0: each tile's
// (mean, M2) merged into (mean, rstd), 1: the two sums' means over the
// sample.
int vptr_fused_dw_chain_tiled_merge(const void* part, void* out, int N, int T, int W, int C,
                                    float eps, int mode, void* stream) {
  if (N < 1 || T < 1 || W < 1 || W > kTMaxW || C < 1 || T % t_cols(C) || mode < 0 ||
      mode > 1 || !part || !out)
    return cudaErrorInvalidValue;
  return dwt_merge(static_cast<const float*>(part), static_cast<float*>(out), N, T, W, C, eps,
                   mode, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
