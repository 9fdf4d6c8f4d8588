// Backward of the conv feed-forward's middle chain (fused_dw_chain.cu) on
// Hopper (sm_90a). Given the output cotangent g (N, HW, C), recompute the
// forward per sample and compute dx, and the parameter gradients summed
// over the samples: dtaps (9, C), ddwb (C), ds1, db1, ds2, db2 (HW, C).
//
// Replaces the TPU kernel vptr_tpu/ops/fused_dw_chain.py::_backward
// (_bwd_kernel at :187, pl.pallas_call at :318). Per sample, as there:
//     da2 = g' gelu'(a2)  (g' = dropout(g)),  ds2 += da2 xhat2,  db2 += da2
//     dz2 = LN backward of dxh2 = da2 s2      (whole-sample means)
//     ddwb += sum_r dz2,  dtaps[t] += sum_r shift_t(z1) dz2
//     dz1 = dw3x3^T(dz2)  (flipped taps; masks on the forward's output rows)
//     da1 = dz1 gelu'(a1),  ds1 += da1 xhat1,  db1 += da1
//     dx  = LN backward of dxh1 = da1 s1
//
// What bounds it on an H100: the f32 arithmetic, ~210 flops an element
// (the forward recomputed to z2, two GELU derivatives, two LayerNorm
// backwards, the transposed conv, the tap and affine sums): 5.4 GFLOP at
// N = 190, 0.081 ms at 67 TFLOP/s. Bytes: x and g read, dx written (3 x 51
// MB in bf16) plus the parameters and their gradients (~5 MB), 0.047 ms at
// 3.35 TB/s.
//
// The TPU kernel walked its sample grid in order and summed the parameter
// gradients in place across grid steps. Three routes here, chosen by the
// caller from the shape and dtype before the launch
// (vptr_fused_dw_chain_bwd_route; ops/fused_dw_chain.py::backward_route):
// * "groups" (f32, and every shape the other refuses): a cluster of 8
//   blocks (dw_chain.cuh) takes a group of consecutive samples (at most
//   kGroups groups), one after the other; each block keeps its 264-channel
//   slice's dtaps and ddwb sums in shared memory and adds its (HW, C)
//   affine-gradient terms into the group's partial in device memory
//   (read-modify-write by the one thread that owns each element, in sample
//   order). Each block holds three f32 slices (xhat1; z1, then dz1; z2,
//   then dz2), 203 KB at far_mnist; da2 and da1 are recomputed where a
//   pass needs them again.
// * "persistent" (bf16; b_route_ok says which shapes): as many clusters of
//   kPCluster = 16 blocks as the card holds (dw_persistent.cuh), each
//   walking the samples cluster id, + clusters, ...; a block's rank fixes
//   its 132-channel slice (at far_mnist) for the whole launch. The block
//   keeps its slice of the four affine-gradient sums and of the ten tap and
//   bias sums in shared memory across its samples (each element owned by
//   one thread in every sample) and writes them once, at the end. A sample
//   takes four cluster exchanges (LN1's and LN2's (sum, M2) merged by
//   Chan's formula, then the two LayerNorm backwards' pairs of sums), each
//   one st.async push into every block and a merge in a fixed order; each
//   GELU derivative is taken once an element (p_gelu_grad), with dxh2 and
//   xhat1 held in registers across the exchange that follows; the taps'
//   gradients and the conv's transpose are two walks down each grid
//   column, their terms summed over a pair's columns by halving shuffles.
//   x and g are staged by TMA in one buffer in turn (x, g, x again).
// * "tiled" (both dtypes, the shapes whose group block does not fit;
//   t_route_ok says which): nar_kth_128's 16 x 16 x 2112 samples, in
//   passes through device memory with per-tile partial moments and sums
//   and sample groups for the sums over samples (dw_tiled.cuh, whose note
//   says what bounds it).
// A second pass sums the groups' or the clusters' partials in their order.
// No float atomics: the gradients are the same on every run.

#include <cstdio>

#include "dw_persistent.cuh"
#include "dw_tiled.cuh"

namespace {

constexpr int kGroups = 16;           // clusters (sample groups) at most
constexpr int kBwdThreads = 32 * kDwWarps;   // loads in flight hide L2 latency

__host__ __device__ int group_size(int N) { return (N + kGroups - 1) / kGroups; }
__host__ __device__ int groups(int N) {
  const int g = group_size(N);
  return (N + g - 1) / g;
}

// Dynamic shared memory: three slices plus the slice's ten tap sums.
long bwd_smem(int HW, int C) {
  return dw_smem(HW, C, 3) + static_cast<long>(sizeof(float)) * 10 * (C / kCluster);
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kBwdThreads, 1)
dw_chain_bwd_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                    const float* __restrict__ dwb, const float* __restrict__ s1,
                    const float* __restrict__ b1, const float* __restrict__ s2,
                    const float* __restrict__ b2, const T* __restrict__ g, T* __restrict__ dx,
                    float* __restrict__ part, float* __restrict__ tpart, int N, int HW, int W,
                    int C, float eps, vptr_dropout::Params drop) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem_dwb[];
  __shared__ Red red;
  const Slice sl(static_cast<int>(cluster.block_rank()), HW, W, C);
  const int grp = blockIdx.x / kCluster;
  const int nq = sl.quads(), cw = sl.cw, qpr = sl.qpr;
  float* xh1 = smem_dwb;               // [HW][cw] x, then xhat1
  float* z1 = xh1 + HW * cw;           // [HW][cw] z1, then dz1
  float* z2 = z1 + HW * cw;            // [HW][cw] z2, then dz2
  float* tacc = z2 + HW * cw;          // [10][cw] dtaps (9), ddwb
  const long hwc = static_cast<long>(HW) * C;
  float* pds1 = part + grp * 4 * hwc;  // the group's partial: ds1, db1, ds2, db2
  float* pdb1 = pds1 + hwc;
  float* pds2 = pdb1 + hwc;
  float* pdb2 = pds2 + hwc;
  const float inv_n = 1.f / static_cast<float>(hwc);
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  for (int i = threadIdx.x; i < 10 * cw; i += kBwdThreads) tacc[i] = 0.f;

  const int gs = group_size(N);
  const int n0 = grp * gs, n1 = n0 + gs < N ? n0 + gs : N;
  for (int n = n0; n < n1; ++n) {
    const bool first = n == n0;
    const long base = static_cast<long>(n) * hwc;
    const Stats st = chain_to_z2(x + base, taps, dwb, s1, b1, sl, xh1, z1, z2, eps, red, cluster);

    // xhat2 and da2 of a quad (z2 still in place): g', the mask, gelu'(a2)
    auto da2_at = [&](int p, int cl, long o, const F4& sc, F4& xhat2) {
      const F4 z = ld4(z2 + sl.sm(p, cl)), gv = ld4(g + base + o), bi = ld4(b2 + o);
      F4 da;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        xhat2.v[k] = (z.v[k] - st.mean2) * st.rstd2;
        float gk = gv.v[k];
        if (drop.active())
          gk = drop.apply(gk, drop.keep(static_cast<uint32_t>(base + o + k), seed));
        da.v[k] = gk * vptr_gelu::gelu_grad(xhat2.v[k] * sc.v[k] + bi.v[k]);
      }
      return da;
    };
    // 1) ds2, db2 and the two means of the norm2 backward
    float v[2] = {0.f, 0.f};
    for (int q = threadIdx.x; q < nq; q += kBwdThreads) {
      int p, cl;
      sl.at(q, p, cl);
      const long o = sl.off(p, cl);
      const F4 sc = ld4(s2 + o);
      F4 xhat2;
      const F4 da2 = da2_at(p, cl, o, sc, xhat2);
      F4 ps = {{0.f, 0.f, 0.f, 0.f}}, pb = ps;
      if (!first) {
        ps = ld4(pds2 + o);
        pb = ld4(pdb2 + o);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ps.v[k] += da2.v[k] * xhat2.v[k];
        pb.v[k] += da2.v[k];
        const float dxh = da2.v[k] * sc.v[k];
        v[0] += dxh;
        v[1] = fmaf(dxh, xhat2.v[k], v[1]);
      }
      st4(pds2 + o, ps);
      st4(pdb2 + o, pb);
    }
    cluster_sum(v, red, 4, cluster);
    const float m1 = v[0] * inv_n, m2 = v[1] * inv_n;
    // 2) dz2 in place of z2 (each quad reads only itself)
    for (int q = threadIdx.x; q < nq; q += kBwdThreads) {
      int p, cl;
      sl.at(q, p, cl);
      const long o = sl.off(p, cl);
      const F4 sc = ld4(s2 + o);
      F4 xhat2;
      const F4 da2 = da2_at(p, cl, o, sc, xhat2);
      F4 dz;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dz.v[k] = (da2.v[k] * sc.v[k] - m1 - xhat2.v[k] * m2) * st.rstd2;
      st4(z2 + sl.sm(p, cl), dz);
    }
    __syncthreads();
    // 3) ddwb and dtaps of the slice: task (tap t, channel quad), t = 9 the
    //    bias; a sum over the positions, then into tacc
    for (int task = threadIdx.x; task < 10 * qpr; task += kBwdThreads) {
      const int t = task / qpr, cl = (task - t * qpr) * 4;
      const int dy = t / 3 - 1, dxo = t % 3 - 1;
      F4 acc = {{0.f, 0.f, 0.f, 0.f}};
      for (int i = 0; i < sl.h; ++i)
        for (int j = 0; j < W; ++j) {
          const F4 d = ld4(z2 + sl.sm(i * W + j, cl));
          if (t == 9) {
#pragma unroll
            for (int k = 0; k < 4; ++k) acc.v[k] += d.v[k];
          } else if (i + dy >= 0 && i + dy < sl.h && j + dxo >= 0 && j + dxo < W) {
            const F4 z = ld4(z1 + sl.sm((i + dy) * W + j + dxo, cl));
#pragma unroll
            for (int k = 0; k < 4; ++k) acc.v[k] = fmaf(z.v[k], d.v[k], acc.v[k]);
          }
        }
      F4 tot = ld4(tacc + t * cw + cl);
#pragma unroll
      for (int k = 0; k < 4; ++k) tot.v[k] += acc.v[k];
      st4(tacc + t * cw + cl, tot);
    }
    __syncthreads();
    // 4) dz1 = dw3x3^T(dz2) into z1's place
    for (int q = threadIdx.x; q < nq; q += kBwdThreads) {
      int p, cl;
      sl.at(q, p, cl);
      const int c = sl.c0 + cl, i = p / W, j = p - i * W;
      F4 acc = {{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dxo = -1; dxo <= 1; ++dxo) {
          const int oi = i - dy, oj = j - dxo;   // the output row that read (i, j)
          if (oi >= 0 && oi < sl.h && oj >= 0 && oj < W) {
            const F4 t = ld4(taps + ((dy + 1) * 3 + dxo + 1) * C + c);
            const F4 d = ld4(z2 + sl.sm(oi * W + oj, cl));
#pragma unroll
            for (int k = 0; k < 4; ++k) acc.v[k] = fmaf(d.v[k], t.v[k], acc.v[k]);
          }
        }
      st4(z1 + sl.sm(p, cl), acc);
    }
    __syncthreads();
    // 5) ds1, db1 and the two means of the norm1 backward
    auto da1_at = [&](int p, int cl, long o, const F4& sc, F4& xh) {
      xh = ld4(xh1 + sl.sm(p, cl));
      const F4 dz = ld4(z1 + sl.sm(p, cl)), bi = ld4(b1 + o);
      F4 da;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        da.v[k] = dz.v[k] * vptr_gelu::gelu_grad(xh.v[k] * sc.v[k] + bi.v[k]);
      return da;
    };
    v[0] = v[1] = 0.f;
    for (int q = threadIdx.x; q < nq; q += kBwdThreads) {
      int p, cl;
      sl.at(q, p, cl);
      const long o = sl.off(p, cl);
      const F4 sc = ld4(s1 + o);
      F4 xh;
      const F4 da1 = da1_at(p, cl, o, sc, xh);
      F4 ps = {{0.f, 0.f, 0.f, 0.f}}, pb = ps;
      if (!first) {
        ps = ld4(pds1 + o);
        pb = ld4(pdb1 + o);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ps.v[k] += da1.v[k] * xh.v[k];
        pb.v[k] += da1.v[k];
        const float dxh = da1.v[k] * sc.v[k];
        v[0] += dxh;
        v[1] = fmaf(dxh, xh.v[k], v[1]);
      }
      st4(pds1 + o, ps);
      st4(pdb1 + o, pb);
    }
    cluster_sum(v, red, 5, cluster);
    const float k1 = v[0] * inv_n, k2 = v[1] * inv_n;
    // 6) dx
    for (int q = threadIdx.x; q < nq; q += kBwdThreads) {
      int p, cl;
      sl.at(q, p, cl);
      const long o = sl.off(p, cl);
      const F4 sc = ld4(s1 + o);
      F4 xh;
      const F4 da1 = da1_at(p, cl, o, sc, xh);
      F4 d;
#pragma unroll
      for (int k = 0; k < 4; ++k) d.v[k] = (da1.v[k] * sc.v[k] - k1 - xh.v[k] * k2) * st.rstd1;
      st4(dx + base + o, d);
    }
    __syncthreads();                   // the next sample overwrites the slices
  }
  for (int task = threadIdx.x; task < 10 * cw; task += kBwdThreads) {
    const int t = task / cw, cl = task - t * cw;
    tpart[(static_cast<long>(grp) * 10 + t) * C + sl.c0 + cl] = tacc[task];
  }
  cluster.sync();                      // the other blocks are done reading red
}

// The groups' partials summed in group order: part (groups x 4 x HW x C)
// into ds1, db1, ds2, db2; tpart (groups x 10 x C) into dtaps, ddwb.
__global__ void dw_chain_sum_kernel(const float* __restrict__ part,
                                    const float* __restrict__ tpart, float* __restrict__ ds1,
                                    float* __restrict__ db1, float* __restrict__ ds2,
                                    float* __restrict__ db2, float* __restrict__ dtaps,
                                    float* __restrict__ ddwb, int ngroups, long hwc, int C) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < 4 * hwc) {
    float acc = 0.f;
    for (int gi = 0; gi < ngroups; ++gi) acc += part[gi * 4 * hwc + i];
    const int which = static_cast<int>(i / hwc);
    float* out = which == 0 ? ds1 : (which == 1 ? db1 : (which == 2 ? ds2 : db2));
    out[i - which * hwc] = acc;
  } else if (i < 4 * hwc + 10L * C) {
    const long k = i - 4 * hwc;
    float acc = 0.f;
    for (int gi = 0; gi < ngroups; ++gi) acc += tpart[gi * 10L * C + k];
    if (k < 9L * C) dtaps[k] = acc;
    else ddwb[k - 9L * C] = acc;
  }
}

template <typename T>
int launch(const void* x, const void* taps, const void* dwb, const void* s1, const void* b1,
           const void* s2, const void* b2, const void* g, void* dx, void* dtaps, void* ddwb,
           void* ds1, void* db1, void* ds2, void* db2, void* part, void* tpart, int N, int HW,
           int W, int C, float eps, vptr_dropout::Params drop, cudaStream_t s) {
  const long smem = bwd_smem(HW, C);
  cudaError_t err = cudaFuncSetAttribute(dw_chain_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int ng = groups(N);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  dw_chain_bwd_kernel<T><<<ng * kCluster, kBwdThreads, smem, s>>>(
      static_cast<const T*>(x), cf(taps), cf(dwb), cf(s1), cf(b1), cf(s2), cf(b2),
      static_cast<const T*>(g), static_cast<T*>(dx), f(part), f(tpart), N, HW, W, C, eps, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long hwc = static_cast<long>(HW) * C;
  const long total = 4 * hwc + 10L * C;
  dw_chain_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      cf(part), cf(tpart), f(ds1), f(db1), f(ds2), f(db2), f(dtaps), f(ddwb), ng, hwc, C);
  return cudaGetLastError();
}

// ---- the bf16 route: persistent clusters of kPCluster blocks (dw_persistent.cuh)

// the opt-in maximum less the static statistics and the probe stamps' sums
constexpr long kBSmemLimit = 232448 - static_cast<long>(sizeof(PRed)) - 64;

// Bytes of the stage (HW rows of p_box_w(cw) bf16: x or g), rounded up to
// 128 bytes.
__host__ __device__ long b_stage_bytes(int HW, int cw) {
  return (2L * HW * p_box_w(cw) + 127) / 128 * 128;
}

// Dynamic shared memory of a persistent backward block for (HW, C), with
// cw = C / kPCluster and E = HW cw: 128 bytes to align the stage, the stage,
// z2 then dz2 (E f32), the sums of ds1, db1, ds2, db2 (E each), z1 then dz1
// (E), taps and dwb (10 cw) and the sums of their gradients (10 cw).
long b_smem(int HW, int C) {
  const long cw = C / kPCluster, e = static_cast<long>(HW) * cw;
  return 128 + b_stage_bytes(HW, static_cast<int>(cw)) + 4 * (6 * e + 20 * cw);
}

// The shapes the persistent backward takes (dtype 1 = bf16): the staged x
// one TMA box (at most 256 rows and 256 channels), a grid width W that
// divides 32 (a channel pair's W columns are lanes of one warp in the
// conv's transpose), the block within shared memory, and x's quads of a
// thread's share at most kPMaxQ.
bool b_route_ok(int HW, int W, int C, int dtype) {
  return dtype == 1 && HW >= 1 && HW <= 256 && W >= 1 && W <= 32 && 32 % W == 0 &&
         HW % W == 0 && C >= 4 * kPCluster && C % (4 * kPCluster) == 0 &&
         p_box_w(C / kPCluster) <= 256 && b_smem(HW, C) <= kBSmemLimit &&
         HW * (C / kPCluster / 4) <= kPMaxQ * kPThreads;
}

// The block's sums of every thread's (a, b), in every thread: each warp's
// by shuffles, the warps' in a fixed tree, through red.warp[set]. One
// __syncthreads.
__device__ __forceinline__ float2 b_block_sum(float a, float b, PRed& red, int set) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) red.warp[set][threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float x[kPWarps], y[kPWarps];
#pragma unroll
  for (int w = 0; w < kPWarps; ++w) {
    x[w] = red.warp[set][w].x;
    y[w] = red.warp[set][w].y;
  }
  return make_float2(tree_sum(x), tree_sum(y));
}

// Exchange k of a pair of block sums (pushed by p_push): waited for, and
// the ranks' pairs summed in a fixed tree, so every block holds the same
// bits on every run.
__device__ __forceinline__ float2 b_merge_sum(PRed& red, int k) {
  const int set = k % kPSets;
  mbar_wait_cluster(&red.bar[set], (k / kPSets) & 1);
  float x[kPCluster], y[kPCluster];
#pragma unroll
  for (int r = 0; r < kPCluster; ++r) {
    x[r] = red.slot[set][r].x;
    y[r] = red.slot[set][r].y;
  }
  return make_float2(tree_sum(x), tree_sum(y));
}

// Grid column j and its two neighbours for one channel pair: row i of buf
// (zeros past the grid) into r.
struct Column {
  const float* buf;
  int col, rs, cw, H;
  bool left, right;
  __device__ void load(F2 (&r)[3], int i) const {
    const F2 zero = {{0.f, 0.f}};
    const float* p = buf + i * rs + col;
    const bool in = i < H;
    r[0] = in && left ? ld2(p - cw) : zero;
    r[1] = in ? ld2(p) : zero;
    r[2] = in && right ? ld2(p + cw) : zero;
  }
};

__device__ __forceinline__ void roll(F2 (&up)[3], F2 (&mid)[3], const F2 (&dn)[3]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    up[b] = mid[b];
    mid[b] = dn[b];
  }
}

// The terms of the taps' and the bias's gradients down grid column j for
// one channel pair (slice channels cl, cl + 1), z1's rows i - 1, i, i + 1
// of the column and its neighbours in registers: tap t = (dy + 1) 3 + dx +
// 1 adds z1 at (i + dy, j + dx) times dz2 at (i, j) into acc[2 t + e]
// (channel cl + e), the bias dz2 at (i, j) into acc[18 + e]. kH: the rows
// when known at compile time (straight-line code), else 0.
template <int kH>
__device__ __forceinline__ void b_tap_column(const float* z1, const float* dz2, int j, int cl,
                                             int cw, int W, int H, float (&acc)[20]) {
  if (kH) H = kH;
  const Column z = {z1, j * cw + cl, W * cw, cw, H, j > 0, j + 1 < W};
  const F2 zero = {{0.f, 0.f}};
  F2 up[3] = {zero, zero, zero}, mid[3], dn[3];
  z.load(mid, 0);
  auto row = [&](int i) {
    z.load(dn, i + 1);
    const F2 d = ld2(dz2 + i * z.rs + z.col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        acc[2 * b + e] = fmaf(up[b].v[e], d.v[e], acc[2 * b + e]);
        acc[2 * (3 + b) + e] = fmaf(mid[b].v[e], d.v[e], acc[2 * (3 + b) + e]);
        acc[2 * (6 + b) + e] = fmaf(dn[b].v[e], d.v[e], acc[2 * (6 + b) + e]);
      }
      acc[18 + e] += d.v[e];
    }
    roll(up, mid, dn);
  };
  if constexpr (kH > 0) {
#pragma unroll
    for (int i = 0; i < kH; ++i) row(i);
  } else {
    for (int i = 0; i < H; ++i) row(i);
  }
}

// dz1 = dw3x3^T(dz2) down grid column j for one channel pair, dz2's rows
// i - 1, i, i + 1 of the column and its neighbours in registers: dz1 at (i,
// j) sums tap (dy, dx) times dz2 at (i - dy, j - dx) (the flipped taps, zero
// padding); written to out. kH as above.
template <int kH>
__device__ __forceinline__ void b_conv_t_column(const float* dz2, float* out, const float* tp,
                                                int j, int cl, int cw, int W, int H) {
  if (kH) H = kH;
  F2 t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = ld2(tp + k * cw + cl);
  const Column d = {dz2, j * cw + cl, W * cw, cw, H, j > 0, j + 1 < W};
  const F2 zero = {{0.f, 0.f}};
  F2 up[3] = {zero, zero, zero}, mid[3], dn[3];
  d.load(mid, 0);
  auto row = [&](int i) {
    d.load(dn, i + 1);
    F2 o;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = dn[2].v[e] * t[0].v[e];
      v = fmaf(dn[1].v[e], t[1].v[e], v);
      v = fmaf(dn[0].v[e], t[2].v[e], v);
      v = fmaf(mid[2].v[e], t[3].v[e], v);
      v = fmaf(mid[1].v[e], t[4].v[e], v);
      v = fmaf(mid[0].v[e], t[5].v[e], v);
      v = fmaf(up[2].v[e], t[6].v[e], v);
      v = fmaf(up[1].v[e], t[7].v[e], v);
      v = fmaf(up[0].v[e], t[8].v[e], v);
      o.v[e] = v;
    }
    st2(out + i * d.rs + d.col, o);
    roll(up, mid, dn);
  };
  if constexpr (kH > 0) {
#pragma unroll
    for (int i = 0; i < kH; ++i) row(i);
  } else {
    for (int i = 0; i < H; ++i) row(i);
  }
}

// acc summed over the gw lanes l = 0 .. gw - 1 of a group (gw a power of 2
// at most 32, its lanes consecutive in one warp, all in mask), scattered:
// at step Step (lanes l and l ^ gw / 2^(Step + 1)) a lane keeps half of the
// values it holds, adds its partner's terms of that half and sends it the
// other half, so each sum is added up once, in a fixed tree. The lane then
// holds values base .. base + held - 1 in acc[0 ..].
template <int Step>
__device__ __forceinline__ void b_halve(float (&acc)[20], int gw, int l, unsigned mask, int& base,
                                        int& held) {
  constexpr int kCount[6] = {20, 10, 5, 3, 2, 1};   // values held after each step (padded)
  if constexpr (Step < 5) {
    constexpr int c = kCount[Step], keep = kCount[Step + 1];
    const int o = gw >> (Step + 1);
    if (o >= 1) {
      const bool upper = l & o;        // keeps values keep .. of those held, its partner 0 ..
#pragma unroll
      for (int i = 0; i < keep; ++i) {
        const float lo = acc[i], hi = i + keep < c ? acc[i + keep] : 0.f;
        acc[i] = (upper ? hi : lo) + __shfl_xor_sync(mask, upper ? lo : hi, o);
      }
      if (upper) {
        base += keep;
        held = held > keep ? held - keep : 0;
      } else {
        held = held < keep ? held : keep;
      }
      b_halve<Step + 1>(acc, gw, l, mask, base, held);
    }
  }
}

// One persistent cluster walks the samples n = cluster id, + clusters, ...
// Two layouts of a block's slice: the element passes in quads, as in
// dw_chain_persistent_kernel (a thread's quad k is quad t + k kPThreads of
// the slice, the same elements in every sample, so each thread owns its
// elements of the four affine-gradient sums for the whole launch); the
// convs in the grid's pair-columns (the forward's as #9's; the transpose's
// and the tap gradients' a pair's W columns on consecutive lanes, a column
// a thread, the columns past the whole rounds of kPThreads a second round).
// The stage holds a sample's x (LN1, z1), then its g (the da2 pass), then
// its x again (the da1 pass), each box requested by TMA once the previous
// contents are read, so the element passes wait on no read of x or g from
// device memory. A sample's steps:
//   LN1's block statistics of the staged x, pushed as exchange 4 it,
//   merged; z1 = gelu(xhat1 s1 + b1) into shared memory; g requested; the
//   conv into z2; LN2's block statistics, exchange 4 it + 1 merged;
//   the da2 pass: xhat2, g' (the dropout, once), da2 = g' gelu'(a2) (once),
//   ds2 += da2 xhat2 and db2 += da2 in shared memory, dxh2 = da2 s2 held in
//   registers, the sums of dxh2 and dxh2 xhat2 pushed as exchange 4 it + 2;
//   x requested again; merged; dz2 over z2 (xhat2 read again from z2);
//   the tap and bias gradients' walk, then the conv's transpose: dz1 over
//   z1;
//   the da1 pass: xhat1 from the staged x (held in registers), da1 = dz1
//   gelu'(a1), ds1 and db1, dxh1 = da1 s1 over dz1, the pair of sums pushed
//   as exchange 4 it + 3; the next sample's x requested; merged; dx stored.
// After the last sample a block writes its slices of the four sums and the
// tap sums into the cluster's partial; dw_chain_sum_kernel adds the
// clusters' in cluster order.
__global__ void __launch_bounds__(kPThreads, 1)
dw_chain_bwd_persistent_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap gmap,
                               const float* __restrict__ taps, const float* __restrict__ dwb,
                               const float* __restrict__ s1, const float* __restrict__ b1,
                               const float* __restrict__ s2, const float* __restrict__ b2,
                               bf16* __restrict__ dx,
                               float* __restrict__ part, float* __restrict__ tpart, int N,
                               int HW, int W, int C, float eps, vptr_dropout::Params drop) {
  extern __shared__ float4 smem_b[];
  __shared__ PRed red;
  VPTR_DW_STAMP_BEGIN
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = static_cast<int>(blockIdx.x) / kPCluster;
  const int ncl = static_cast<int>(gridDim.x) / kPCluster;
  const int cw = C / kPCluster, c0 = rank * cw, nq = cw / 4, np = cw / 2, H = HW / W;
  const int bw = p_box_w(cw), lead = c0 % 8;   // lead: the slice's first channel in a staged row
  const int E = HW * cw, Q = HW * nq;
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_b);
  bf16* stage = reinterpret_cast<bf16*>(base + ((128 - (smem_u32(base) & 127)) & 127));
  float* z2 = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(stage) +
                                       b_stage_bytes(HW, cw));   // [HW][cw] z2, then dz2
  float* sums = z2 + E;                                     // ds1, db1, ds2, db2: [4][HW][cw]
  float* z1 = sums + 4 * E;                                 // [HW][cw] z1, then dz1
  float* tp = z1 + E;                                       // taps [9][cw], then dwb [cw]
  float* tacc = tp + 10 * cw;                               // their gradients' sums
  const long sample = static_cast<long>(HW) * C;
  const int t = static_cast<int>(threadIdx.x);

  // the quad layout: this thread's quads k < nk, quad q = t + k kPThreads
  // at position pk[k]: at os(k) = 4 q in a [HW][cw] buffer, og(k) in a
  // sample and ox(k) in the staged x
  int pk[kPMaxQ];
#pragma unroll
  for (int k = 0; k < kPMaxQ; ++k) pk[k] = (t + k * kPThreads) / nq;
  auto os = [&](int k) { return 4 * (t + k * kPThreads); };
  auto og = [&](int k) { return os(k) + pk[k] * (C - cw) + c0; };
  auto ox = [&](int k) { return os(k) + pk[k] * (bw - cw) + lead; };
  const int nk = (Q - t + kPThreads - 1) / kPThreads;
  const float nt = 4.f * nk, inv_t = nk > 0 ? 1.f / nt : 0.f;
  // the forward conv's layout (#9's): pair-columns whole below `whole`, by
  // points above; the transpose's: units u = (pair, column) with the
  // column fastest
  const int P = np * W, whole = P / kPThreads * kPThreads;

  for (int q = t; q < 10 * nq; q += kPThreads) {
    const int r = q / nq, cl = (q - r * nq) * 4;
    cp_async16(tp + r * cw + cl, (r < 9 ? taps + static_cast<long>(r) * C : dwb) + c0 + cl);
  }
  const F4 zero4 = {{0.f, 0.f, 0.f, 0.f}};
  for (int q = t; q < 4 * Q; q += kPThreads) st4(sums + 4 * q, zero4);
  for (int q = t; q < 10 * nq; q += kPThreads) st4(tacc + 4 * q, zero4);
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
  cp_async_wait_all();
  __syncthreads();
  cluster.sync();                      // barriers and counts set up before any use
  VPTR_DW_STAMP(0)

  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  const float rcp = 1.f / drop.keep_div;
  const float n_r = static_cast<float>(E), inv_nr = 1.f / n_r;
  const float inv_n = 1.f / (static_cast<float>(HW) * C);

  // the staged rows of a sample of x or g requested by thread 0 (once
  // every thread is done reading the stage) and waited for, in turn
  auto stage_load = [&](const CUtensorMap* map, int n) {
    if (t == 0) {
      fence_proxy_async();
      mbar_expect_tx(&red.xbar, box_bytes, true);
      tma_load_2d(stage, map, &red.xbar, c0 - lead, n * HW, true);
    }
  };
  uint32_t staged = 0;                 // loads into the stage waited for so far
  auto stage_wait = [&] { mbar_wait(&red.xbar, staged++ & 1); };

  int it = 0;
  for (int n = cid; n < N; ++it, n += ncl) {
    const long at = n * sample;
    stage_wait();                      // this sample's x is staged
    VPTR_DW_STAMP(1)
    {                                  // LN1's block statistics, pushed
      F4 v[kPMaxQ];
#pragma unroll
      for (int k = 0; k < kPMaxQ; ++k)
        if (k < nk) v[k] = ld4(stage + ox(k));
      float s, q, sum, m2;
      p_thread_stats(v, nk, inv_t, s, q);
      p_block_stats(s, q, nt, inv_t, inv_nr, red, 0, sum, m2);
      p_push(sum, m2, red, 4 * it, rank);
    }
    VPTR_DW_STAMP(2)
    float mean1, rstd1, mean2, rstd2;
    p_merge(red, 4 * it, n_r, inv_nr, inv_n, eps, mean1, rstd1);
    const float sh1 = -mean1 * rstd1;  // (x - mean) rstd as one fma
    VPTR_DW_STAMP(3)
#pragma unroll
    for (int k = 0; k < kPMaxQ; ++k)
      if (k < nk) {
        const F4 x = ld4(stage + ox(k)), sc = ld4(s1 + og(k)), bi = ld4(b1 + og(k));
        F4 z;
#pragma unroll
        for (int e = 0; e < 4; ++e) z.v[e] = p_gelu(fmaf(x.v[e], rstd1, sh1) * sc.v[e] + bi.v[e]);
        st4(z1 + os(k), z);
      }
    __syncthreads();                   // z1 is complete, the staged x read
    stage_load(&gmap, n);              // g, for the da2 pass
    VPTR_DW_STAMP(4)
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
    VPTR_DW_STAMP(5)
    {                                  // LN2's block statistics, pushed
      F4 v[kPMaxQ];
#pragma unroll
      for (int k = 0; k < kPMaxQ; ++k)
        if (k < nk) v[k] = ld4(z2 + os(k));
      float s, q, sum, m2;
      p_thread_stats(v, nk, inv_t, s, q);
      p_block_stats(s, q, nt, inv_t, inv_nr, red, 1, sum, m2);
      p_push(sum, m2, red, 4 * it + 1, rank);
    }
    p_merge(red, 4 * it + 1, n_r, inv_nr, inv_n, eps, mean2, rstd2);
    const float sh2 = -mean2 * rstd2;
    stage_wait();
    VPTR_DW_STAMP(6)
    // the da2 pass; dxh2 of this thread's elements is held until the
    // exchange is merged (xhat2 is read again from z2), as xhat1 is in the
    // da1 pass (dxh1 written over dz1)
    F4 hold[kPMaxQ];
    {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int k = 0; k < kPMaxQ; ++k)
        if (k < nk) {
          const F4 z = ld4(z2 + os(k)), sc = ld4(s2 + og(k)), bi = ld4(b2 + og(k)),
                   gv = ld4(stage + ox(k));
          F4 ps = ld4(sums + 2 * E + os(k)), pb = ld4(sums + 3 * E + os(k));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xh = fmaf(z.v[e], rstd2, sh2);
            float gk = gv.v[e];
            if (drop.active())
              gk = drop.apply_rcp(
                  gk, drop.keep(static_cast<uint32_t>(at + og(k) + e), seed), rcp);
            const float da = gk * p_gelu_grad(xh * sc.v[e] + bi.v[e]);
            ps.v[e] = fmaf(da, xh, ps.v[e]);
            pb.v[e] += da;
            hold[k].v[e] = da * sc.v[e];
            a += hold[k].v[e];
            b = fmaf(hold[k].v[e], xh, b);
          }
          st4(sums + 2 * E + os(k), ps);
          st4(sums + 3 * E + os(k), pb);
        }
      const float2 s = b_block_sum(a, b, red, 0);   // every thread is done with the staged g
      p_push(s.x, s.y, red, 4 * it + 2, rank);
    }
    stage_load(&xmap, n);              // x again, for the da1 pass
    VPTR_DW_STAMP(7)
    {
      const float2 m = b_merge_sum(red, 4 * it + 2);
      const float m1 = m.x * inv_n, m2 = m.y * inv_n;
#pragma unroll
      for (int k = 0; k < kPMaxQ; ++k)
        if (k < nk) {
          const F4 z = ld4(z2 + os(k));
          F4 dz;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dz.v[e] = (hold[k].v[e] - m1 - fmaf(z.v[e], rstd2, sh2) * m2) * rstd2;
          st4(z2 + os(k), dz);
        }
    }
    __syncthreads();                   // dz2 is complete
    VPTR_DW_STAMP(8)
    for (int u0 = 0; u0 < P; u0 += kPThreads) {
      const int u = u0 + t;
      const unsigned mask = __ballot_sync(0xffffffffu, u < P);
      if (u < P) {
        const int pr = u / W, j = u - pr * W, cl = 2 * pr;
        float acc[20];
#pragma unroll
        for (int v = 0; v < 20; ++v) acc[v] = 0.f;
        if (H == 8)
          b_tap_column<8>(z1, z2, j, cl, cw, W, H, acc);
        else
          b_tap_column<0>(z1, z2, j, cl, cw, W, H, acc);
        int base = 0, held = 20;       // the pair's sums over its W columns, scattered
        b_halve<0>(acc, W, j, mask, base, held);
#pragma unroll
        for (int i = 0; i < 20; ++i)
          if (i < held) tacc[((base + i) >> 1) * cw + cl + ((base + i) & 1)] += acc[i];
        __syncwarp(mask);              // the pair's W lanes are done reading its z1
        if (H == 8)
          b_conv_t_column<8>(z2, z1, tp, j, cl, cw, W, H);
        else
          b_conv_t_column<0>(z2, z1, tp, j, cl, cw, W, H);
      }
    }
    __syncthreads();                   // dz1 is complete
    stage_wait();
    VPTR_DW_STAMP(9)
    {                                  // the da1 pass
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int k = 0; k < kPMaxQ; ++k)
        if (k < nk) {
          const F4 x = ld4(stage + ox(k)), dz = ld4(z1 + os(k)), sc = ld4(s1 + og(k)),
                   bi = ld4(b1 + og(k));
          F4 ps = ld4(sums + os(k)), pb = ld4(sums + E + os(k));
          F4 dh;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hold[k].v[e] = fmaf(x.v[e], rstd1, sh1);
            const float da = dz.v[e] * p_gelu_grad(hold[k].v[e] * sc.v[e] + bi.v[e]);
            ps.v[e] = fmaf(da, hold[k].v[e], ps.v[e]);
            pb.v[e] += da;
            dh.v[e] = da * sc.v[e];
            a += dh.v[e];
            b = fmaf(dh.v[e], hold[k].v[e], b);
          }
          st4(sums + os(k), ps);
          st4(sums + E + os(k), pb);
          st4(z1 + os(k), dh);
        }
      const float2 s = b_block_sum(a, b, red, 1);   // every thread is done with the staged x
      p_push(s.x, s.y, red, 4 * it + 3, rank);
    }
    if (n + ncl < N) stage_load(&xmap, n + ncl);   // the next sample's x
    VPTR_DW_STAMP(10)
    {
      const float2 m = b_merge_sum(red, 4 * it + 3);
      const float k1 = m.x * inv_n, k2 = m.y * inv_n;
      VPTR_DW_STAMP(11)
#pragma unroll
      for (int k = 0; k < kPMaxQ; ++k)
        if (k < nk) {
          const F4 dh = ld4(z1 + os(k));
          F4 d;
#pragma unroll
          for (int e = 0; e < 4; ++e) d.v[e] = (dh.v[e] - k1 - hold[k].v[e] * k2) * rstd1;
          st4(dx + at + og(k), d);
        }
    }
    VPTR_DW_STAMP(12)
  }
  // this block's slices of the four sums (its own elements) and, once every
  // lane has added its tap sums, of tacc into the cluster's partial
  float* pc = part + static_cast<long>(cid) * 4 * sample;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < kPMaxQ; ++k)
      if (k < nk) st4(pc + a * sample + og(k), ld4(sums + a * E + os(k)));
  __syncthreads();
  for (int q = t; q < 10 * cw; q += kPThreads) {
    const int r = q / cw;
    tpart[(static_cast<long>(cid) * 10 + r) * C + c0 + q - r * cw] = tacc[q];
  }
  cluster.sync();                      // no block leaves while a push into it may be on its way
  VPTR_DW_STAMP(13)
  VPTR_DW_STAMP_END
}

int launch_persistent(const void* x, const void* taps, const void* dwb, const void* s1,
                      const void* b1, const void* s2, const void* b2, const void* g, void* dx,
                      void* dtaps, void* ddwb, void* ds1, void* db1, void* ds2, void* db2,
                      void* part, void* tpart, int N, int HW, int W, int C, float eps,
                      vptr_dropout::Params drop, cudaStream_t s) {
  const long smem = b_smem(HW, C);
  const int resident = p_resident(dw_chain_bwd_persistent_kernel, smem);
  if (resident < 1) return cudaErrorInvalidConfiguration;   // a cluster does not fit
  CUtensorMap xmap, gmap;   // g staged in x's boxes
  int r = p_xmap(&xmap, x, N, HW, C);
  if (!r) r = p_xmap(&gmap, g, N, HW, C);
  if (r) return r;
  const int clusters = N < resident ? N : resident;
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  const PLaunch launch(clusters, smem, s);
  cudaError_t err = cudaLaunchKernelEx(
      &launch.cfg, dw_chain_bwd_persistent_kernel, xmap, gmap, cf(taps), cf(dwb), cf(s1), cf(b1),
      cf(s2), cf(b2), static_cast<bf16*>(dx), f(part), f(tpart), N,
      HW, W, C, eps, drop);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long hwc = static_cast<long>(HW) * C;
  const long total = 4 * hwc + 10L * C;
  dw_chain_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      cf(part), cf(tpart), f(ds1), f(db1), f(ds2), f(db2), f(dtaps), f(ddwb), clusters, hwc, C);
  return cudaGetLastError();
}

// ---- the tiled route (dw_tiled.cuh)

// Its operands: the inputs, the outputs, then the caller's f32 scratch
// (z2, da1: N x HW x C; part: N x T x 2, T = HW / W x ceil(C / 32);
// stats: 4 x N x 2; gpart: groups x 4 x HW x C; tpart: groups x H x 10 x
// C).
struct TBwd {
  const void *x, *taps, *dwb, *s1, *b1, *s2, *b2, *g;
  void *dx, *dtaps, *ddwb, *ds1, *db1, *ds2, *db2;
  void *z2, *da1, *part, *stats, *gpart, *tpart;
};

// Step 0-1: the forward to z2 (x's moments into part; after stats[0], z2
// and its moments); 2 (stats[1]): LN2's backward sums into part, ds2 and
// db2 by group; 3 (stats[2]): the conv's backward, da1 and LN1's backward
// sums into part, ds1, db1 and the tap sums by group; 4 (stats[3]): dx and
// the gradients summed. stats (4, N, 2): LN1's, LN2's (mean, rstd), LN2's
// and LN1's backward means.
template <typename T>
int tiled_step(int step, const TBwd& a, int N, int HW, int W, int C,
               vptr_dropout::Params drop, cudaStream_t s) {
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  float *z2 = f(a.z2), *da1 = f(a.da1), *part = f(a.part), *st = f(a.stats);
  if (step < 2)
    return dwt_z2_step<T>(step, x, cf(a.taps), cf(a.dwb), cf(a.s1), cf(a.b1), st, z2, part, N,
                          HW, W, C, s);
  const int G = t_groups(N), H = HW / W;
  const dim3 by_group(t_cols(C), H, G), by_sample(t_cols(C), H, N);
  if (step == 2) {
    dwt_ln2_bwd_kernel<T><<<by_group, kTThreads, 0, s>>>(z2, g, cf(a.s2), cf(a.b2), st + 2 * N,
                                                       part, f(a.gpart), N, HW, W, C, drop);
  } else if (step == 3) {
    dwt_conv_bwd_kernel<T><<<by_group, kTThreads, 6 * W * kTCh * sizeof(float), s>>>(
        x, z2, g, cf(a.taps), cf(a.s1), cf(a.b1), cf(a.s2), cf(a.b2), st, da1, part,
        f(a.gpart), f(a.tpart), N, HW, W, C, drop);
  } else {
    dwt_dx_kernel<T><<<by_sample, kTThreads, 0, s>>>(x, da1, cf(a.s1), st, st + 6 * N,
                                                   static_cast<T*>(a.dx), HW, W, C);
    VPTR_TRY(cudaGetLastError());
    // the partial gradients in order
    const long hwc = static_cast<long>(HW) * C, total = 4 * hwc + 10L * C;
    dwt_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
        cf(a.gpart), cf(a.tpart), f(a.ds1), f(a.db1), f(a.ds2), f(a.db2), f(a.dtaps),
        f(a.ddwb), G, H, hwc, C);
  }
  return cudaGetLastError();
}

// The merge after each of steps 0-3 (0, 1: moments; 2, 3: sums).
constexpr int kTStepMode[4] = {kTMoments, kTMoments, kTSums, kTSums};

// In one call: the steps with each merge over the call's own tiles.
template <typename T>
int launch_tiled(const TBwd& a, int N, int HW, int W, int C, float eps,
                 vptr_dropout::Params drop, cudaStream_t s) {
  const int T_ = t_cols(C) * (HW / W);
  float* st = static_cast<float*>(a.stats);
  for (int k = 0; k < 4; ++k) {
    if (int err = tiled_step<T>(k, a, N, HW, W, C, drop, s)) return err;
    VPTR_TRY(dwt_merge(static_cast<const float*>(a.part), st + 2 * k * N, N, T_, W, C, eps,
                       kTStepMode[k], s));
  }
  return tiled_step<T>(4, a, N, HW, W, C, drop, s);
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

// Sample groups (clusters) of the group route for N samples: part is
// groups x 4 x HW x C f32, tpart groups x 10 x C f32.
int vptr_fused_dw_chain_bwd_groups(int N) { return groups(N); }

// Dynamic shared memory a block of the group route takes for (HW, C), in
// bytes.
long vptr_fused_dw_chain_bwd_smem(int HW, int C) { return bwd_smem(HW, C); }

// Clusters (sample groups) of the group route's kernel in bf16 the card
// runs at once.
int vptr_fused_dw_chain_bwd_clusters(int HW, int C) {
  return resident_clusters(dw_chain_bwd_kernel<bf16>, kBwdThreads, bwd_smem(HW, C));
}

// The persistent route's clusters of kPCluster blocks the card holds at
// once for (HW, W, C) (0: the route does not take the shape, or none
// fits). It launches min(N, this) of them: part is that many x 4 x HW x C
// f32, tpart that many x 10 x C.
int vptr_fused_dw_chain_bwd_persistent_clusters(int HW, int W, int C) {
  return b_route_ok(HW, W, C, 1) ? p_resident(dw_chain_bwd_persistent_kernel, b_smem(HW, C))
                                 : 0;
}

// The route for (HW, W, C, dtype): 1 = persistent, 2 = tiled (the shapes
// whose group block needs more than kDwRouteSmem bytes), 0 = groups.
int vptr_fused_dw_chain_bwd_route(int HW, int W, int C, int dtype) {
  if (b_route_ok(HW, W, C, dtype)) return 1;
  return bwd_smem(HW, C) > kDwRouteSmem && t_route_ok(HW, W, C) ? 2 : 0;
}

// Sample groups of the tiled route's sums over samples for N samples.
int vptr_fused_dw_chain_bwd_tiled_groups(int N) { return N < 1 ? 0 : t_groups(N); }

// dtype: 0 = float32, 1 = bfloat16; route as vptr_fused_dw_chain_bwd_route
// names it (a shape the route does not take is refused). Outputs: dx in T,
// the parameter gradients f32. Returns a cudaError_t (0 = both passes
// launched), or kTmaEncodeError + a CUresult.
int vptr_fused_dw_chain_bwd(const void* x, const void* taps, const void* dwb, const void* s1,
                            const void* b1, const void* s2, const void* b2, const void* g,
                            void* dx, void* dtaps, void* ddwb, void* ds1, void* db1, void* ds2,
                            void* db2, void* part, void* tpart, int N, int HW, int W, int C,
                            float eps, const void* seed, float rate, float keep_div, int dtype,
                            int route, void* stream) {
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || !dw_shape_ok(HW, W, C) || dtype < 0 || dtype > 1 || route < 0 || route > 1 ||
      (rate > 0.f && !seed) || rate >= 1.f || !part || !tpart)
    return cudaErrorInvalidValue;
  if (route == 1)
    return b_route_ok(HW, W, C, dtype)
               ? launch_persistent(x, taps, dwb, s1, b1, s2, b2, g, dx, dtaps, ddwb, ds1, db1,
                                   ds2, db2, part, tpart, N, HW, W, C, eps, drop, s)
               : cudaErrorInvalidValue;
  if (bwd_smem(HW, C) > kDwSmemLimit) return cudaErrorInvalidValue;
  return dtype == 0 ? launch<float>(x, taps, dwb, s1, b1, s2, b2, g, dx, dtaps, ddwb, ds1, db1,
                                    ds2, db2, part, tpart, N, HW, W, C, eps, drop, s)
                    : launch<bf16>(x, taps, dwb, s1, b1, s2, b2, g, dx, dtaps, ddwb, ds1, db1,
                                   ds2, db2, part, tpart, N, HW, W, C, eps, drop, s);
}

// The tiled route on any shape it takes (t_route_ok; N <= 65535): the
// inputs and outputs as vptr_fused_dw_chain_bwd's, then the caller's f32
// scratch (TBwd's note; groups = vptr_fused_dw_chain_bwd_tiled_groups(N)).
int vptr_fused_dw_chain_bwd_tiled(const void* x, const void* taps, const void* dwb,
                                  const void* s1, const void* b1, const void* s2, const void* b2,
                                  const void* g, void* dx, void* dtaps, void* ddwb, void* ds1,
                                  void* db1, void* ds2, void* db2, void* z2, void* da1,
                                  void* part, void* stats, void* gpart, void* tpart, int N,
                                  int HW, int W, int C, float eps, const void* seed, float rate,
                                  float keep_div, int dtype, void* stream) {
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kTMaxN || !t_route_ok(HW, W, C) || dtype < 0 || dtype > 1 ||
      (rate > 0.f && !seed) || rate >= 1.f || !z2 || !da1 || !part || !stats || !gpart ||
      !tpart)
    return cudaErrorInvalidValue;
  const TBwd a{x, taps, dwb, s1, b1, s2, b2, g, dx, dtaps, ddwb, ds1, db1, ds2, db2,
               z2, da1, part, stats, gpart, tpart};
  return dtype == 0 ? launch_tiled<float>(a, N, HW, W, C, eps, drop, s)
                    : launch_tiled<bf16>(a, N, HW, W, C, eps, drop, s);
}

// #10's tiled route split at its four statistics (tensor parallelism, as
// vptr_fused_dw_chain_tiled_step): steps 0-4 as tiled_step's note; after
// each of steps 0-3 the caller merges every share's part (N, HW / W,
// ceil(C / 32), 2), in the whole call's tile order, into stats[step]
// (vptr_fused_dw_chain_tiled_merge, mode 0 after steps 0-1, 1 after 2-3).
// C any share (t_split_ok; a partial last tile where 32 does not divide
// it, whose lanes past the share write no gradient). The dropout at the
// global channel (mask_cols, col0). The operands as
// vptr_fused_dw_chain_bwd_tiled's.
int vptr_fused_dw_chain_bwd_tiled_step(int step, const void* x, const void* taps,
                                       const void* dwb, const void* s1, const void* b1,
                                       const void* s2, const void* b2, const void* g, void* dx,
                                       void* dtaps, void* ddwb, void* ds1, void* db1, void* ds2,
                                       void* db2, void* z2, void* da1, void* part, void* stats,
                                       void* gpart, void* tpart, int N, int HW, int W, int C,
                                       const void* seed, float rate, float keep_div,
                                       int mask_cols, int col0, int dtype, void* stream) {
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div, mask_cols,
                                  col0};
  if (step < 0 || step > 4 || N < 1 || N > kTMaxN || !t_split_ok(HW, W, C) || dtype < 0 ||
      dtype > 1 || (rate > 0.f && !seed) || rate >= 1.f || col0 < 0 ||
      (mask_cols && col0 + C > mask_cols) || !z2 || !da1 || !part || !stats || !gpart ||
      !tpart)
    return cudaErrorInvalidValue;
  const TBwd a{x, taps, dwb, s1, b1, s2, b2, g, dx, dtaps, ddwb, ds1, db1, ds2, db2,
               z2, da1, part, stats, gpart, tpart};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? tiled_step<float>(step, a, N, HW, W, C, drop, s)
                    : tiled_step<bf16>(step, a, N, HW, W, C, drop, s);
}

}  // extern "C"
