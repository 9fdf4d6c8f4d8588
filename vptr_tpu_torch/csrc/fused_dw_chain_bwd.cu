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
// What bounds it on an H100: bytes. x and g read, dx written (3 x 51 MB
// in bf16 at N = 190) plus the parameters and their gradients (~5 MB):
// ~158 MB, 0.047 ms at 3.35 TB/s.
//
// The TPU kernel walked its sample grid in order and summed the parameter
// gradients in place across grid steps. Here a cluster (dw_chain.cuh)
// takes a group of consecutive samples, one after the other; each block
// keeps its channel slice's dtaps and ddwb sums in shared memory and adds
// its (HW, C) affine-gradient terms into the group's partial in device
// memory (read-modify-write by the one thread that owns each element, in
// sample order). A second pass sums the groups' partials in group order.
// No float atomics: the gradients are the same on every run. Each block
// holds three f32 slices in shared memory (xhat1; z1, then dz1; z2, then
// dz2), 203 KB at far_mnist; da2 and da1 are recomputed where a pass needs
// them again instead of being stored.

#include "dw_chain.cuh"

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

}  // namespace

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sample groups (clusters) for N samples: part is groups x 4 x HW x C f32,
// tpart groups x 10 x C f32.
int vptr_fused_dw_chain_bwd_groups(int N) { return groups(N); }

// Dynamic shared memory a block takes for (HW, C), in bytes.
long vptr_fused_dw_chain_bwd_smem(int HW, int C) { return bwd_smem(HW, C); }

// Clusters (sample groups) of the bf16 kernel the card runs at once.
int vptr_fused_dw_chain_bwd_clusters(int HW, int C) {
  return resident_clusters(dw_chain_bwd_kernel<bf16>, kBwdThreads, bwd_smem(HW, C));
}

// dtype: 0 = float32, 1 = bfloat16. Outputs: dx in T, the parameter
// gradients f32. Returns a cudaError_t (0 = both passes launched).
int vptr_fused_dw_chain_bwd(const void* x, const void* taps, const void* dwb, const void* s1,
                            const void* b1, const void* s2, const void* b2, const void* g,
                            void* dx, void* dtaps, void* ddwb, void* ds1, void* db1, void* ds2,
                            void* db2, void* part, void* tpart, int N, int HW, int W, int C,
                            float eps, const void* seed, float rate, float keep_div, int dtype,
                            void* stream) {
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || !dw_shape_ok(HW, W, C) || dtype < 0 || dtype > 1 ||
      bwd_smem(HW, C) > kDwSmemLimit || (rate > 0.f && !seed) || rate >= 1.f || !part || !tpart)
    return cudaErrorInvalidValue;
  return dtype == 0 ? launch<float>(x, taps, dwb, s1, b1, s2, b2, g, dx, dtaps, ddwb, ds1, db1,
                                    ds2, db2, part, tpart, N, HW, W, C, eps, drop, s)
                    : launch<bf16>(x, taps, dwb, s1, b1, s2, b2, g, dx, dtaps, ddwb, ds1, db1,
                                   ds2, db2, part, tpart, N, HW, W, C, eps, drop, s);
}

}  // extern "C"
