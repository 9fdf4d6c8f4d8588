// The conv feed-forward's middle chain on Hopper (sm_90a), shared by the
// forward (fused_dw_chain.cu, kernel #9) and the backward
// (fused_dw_chain_bwd.cu, #10). Per sample of HW = H * W positions and C
// channels (x: N x HW x C, channels last; row r is position (r / W, r % W)):
//     z1 = gelu(LN(x) * s1 + b1)             whole-sample LayerNorm over HW C
//     z2 = dw3x3(z1) + dwb                   per channel, zero padding
//     z3 = dropout(gelu(LN(z2) * s2 + b2))   hash of (sample HW + r) C + c
// with f32 arithmetic, two-pass variances, the A&S GELU (gelu_as.cuh) and
// (HW, C) affines s1, b1, s2, b2.
//
// A sample (64 x 2112 at far_mnist: 270 KB in bf16, 541 KB in f32) does
// not fit one SM, and the chain needs two whole-sample statistics in
// sequence. The depthwise conv never mixes channels, so a thread-block
// cluster of kCluster blocks on neighbouring SMs takes one sample, each
// block a slice of C / kCluster channels at every position, held in shared
// memory in f32. The only cross-block work is the statistics, summed over
// the cluster through distributed shared memory in rank order
// (cluster.cuh), so the result is the same on every run.
#pragma once

#include "cluster.cuh"
#include "gelu_as.cuh"
#include "hash_dropout.cuh"
#include "tile_ops.cuh"

namespace {

constexpr int kCluster = 8;           // blocks per sample (the portable maximum)
constexpr int kDwWarps = 32;          // a block's warps (1024 threads)
constexpr int kSlots = 6;             // cluster reductions per sample

// The block's channel slice of one sample: C / kCluster channels (C a
// multiple of 4 kCluster) at every position, walked in quads of four
// consecutive channels (16-byte f32 and 8-byte bf16 accesses, so each
// thread keeps several loads in flight).
struct Slice {
  int c0, cw, qpr, hw, w, h, C;
  __device__ Slice(int rank, int HW, int W, int C_) : hw(HW), w(W), C(C_) {
    cw = C_ / kCluster;
    c0 = rank * cw;
    qpr = cw / 4;
    h = HW / W;
  }
  __device__ int quads() const { return hw * qpr; }
  // quad q -> its position p and first slice channel cl
  __device__ void at(int q, int& p, int& cl) const {
    p = q / qpr;
    cl = (q - p * qpr) * 4;
  }
  // offset of (p, cl) in an HW x C array, and in a slice buffer
  __device__ long off(int p, int cl) const { return static_cast<long>(p) * C + c0 + cl; }
  __device__ int sm(int p, int cl) const { return p * cw + cl; }
};

struct F4 {
  float v[4];
};

__device__ __forceinline__ F4 ld4(const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  return {{t.x, t.y, t.z, t.w}};
}
__device__ __forceinline__ F4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return {{a.x, a.y, b.x, b.y}};
}
__device__ __forceinline__ void st4(float* p, const F4& f) {
  *reinterpret_cast<float4*>(p) = make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
}
__device__ __forceinline__ void st4(bf16* p, const F4& f) {
  __nv_bfloat162 a = __floats2bfloat162_rn(f.v[0], f.v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(f.v[2], f.v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Reduction scratch of the cluster sums (cluster.cuh).
using Red = ClusterRed<kDwWarps, kSlots>;

// z2 at the quad (p, cl) of the slice: dwb + the nine taps (row-major
// (dy, dx), cross-correlation, zero padding) over z1 in shared memory.
__device__ __forceinline__ F4 dw3x3_at(const float* z1, const Slice& sl, int p, int cl,
                                       const float* __restrict__ taps,
                                       const float* __restrict__ dwb) {
  const int c = sl.c0 + cl;
  const int i = p / sl.w, j = p - i * sl.w;
  F4 acc = ld4(dwb + c);
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int ii = i + dy, jj = j + dx;
      if (ii >= 0 && ii < sl.h && jj >= 0 && jj < sl.w) {
        const F4 t = ld4(taps + ((dy + 1) * 3 + dx + 1) * sl.C + c);
        const F4 z = ld4(z1 + sl.sm(ii * sl.w + jj, cl));
#pragma unroll
        for (int k = 0; k < 4; ++k) acc.v[k] = fmaf(z.v[k], t.v[k], acc.v[k]);
      }
    }
  return acc;
}

// Statistics of the chain's two LayerNorms for one sample.
struct Stats {
  float mean1, rstd1, mean2, rstd2;
};

__device__ __forceinline__ float sum4(const F4& f) {
  return (f.v[0] + f.v[1]) + (f.v[2] + f.v[3]);
}

// The forward up to z2 for sample xs (HW x C): the slice of x into xbuf,
// replaced there by xhat1 = (x - mean1) rstd1; z1 into z1buf (which may be
// xbuf: z1 then replaces xhat1); z2 into z2buf. Uses cluster slots 0-3.
template <typename T>
__device__ Stats chain_to_z2(const T* __restrict__ xs, const float* __restrict__ taps,
                             const float* __restrict__ dwb, const float* __restrict__ s1,
                             const float* __restrict__ b1, const Slice& sl, float* xbuf,
                             float* z1buf, float* z2buf, float eps, Red& red,
                             cg::cluster_group& cluster) {
  const int nq = sl.quads();
  const float inv_n = 1.f / (static_cast<float>(sl.hw) * sl.C);
  Stats st;
  float v[1] = {0.f};
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    int p, cl;
    sl.at(q, p, cl);
    const F4 x = ld4(xs + sl.off(p, cl));
    st4(xbuf + sl.sm(p, cl), x);
    v[0] += sum4(x);
  }
  cluster_sum(v, red, 0, cluster);
  st.mean1 = v[0] * inv_n;
  v[0] = 0.f;
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    int p, cl;
    sl.at(q, p, cl);
    const F4 x = ld4(xbuf + sl.sm(p, cl));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float d = x.v[k] - st.mean1;
      v[0] = fmaf(d, d, v[0]);
    }
  }
  cluster_sum(v, red, 1, cluster);
  st.rstd1 = rsqrtf(v[0] * inv_n + eps);
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    int p, cl;
    sl.at(q, p, cl);
    const long o = sl.off(p, cl);
    const F4 x = ld4(xbuf + sl.sm(p, cl)), sc = ld4(s1 + o), bi = ld4(b1 + o);
    F4 xh, z;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xh.v[k] = (x.v[k] - st.mean1) * st.rstd1;
      z.v[k] = vptr_gelu::gelu(xh.v[k] * sc.v[k] + bi.v[k]);
    }
    st4(xbuf + sl.sm(p, cl), xh);
    st4(z1buf + sl.sm(p, cl), z);
  }
  __syncthreads();
  v[0] = 0.f;
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    int p, cl;
    sl.at(q, p, cl);
    const F4 z = dw3x3_at(z1buf, sl, p, cl, taps, dwb);
    st4(z2buf + sl.sm(p, cl), z);
    v[0] += sum4(z);
  }
  cluster_sum(v, red, 2, cluster);
  st.mean2 = v[0] * inv_n;
  v[0] = 0.f;
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    int p, cl;
    sl.at(q, p, cl);
    const F4 z = ld4(z2buf + sl.sm(p, cl));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float d = z.v[k] - st.mean2;
      v[0] = fmaf(d, d, v[0]);
    }
  }
  cluster_sum(v, red, 3, cluster);
  st.rstd2 = rsqrtf(v[0] * inv_n + eps);
  return st;
}

// The shapes the kernels take: C a multiple of 4 kCluster (whole quads in
// every slice).
bool dw_shape_ok(int HW, int W, int C) {
  return HW >= 1 && W >= 1 && HW % W == 0 && C >= 4 * kCluster && C % (4 * kCluster) == 0;
}

// Dynamic shared memory of a block holding `buffers` f32 slices.
long dw_smem(int HW, int C, int buffers) {
  return static_cast<long>(sizeof(float)) * buffers * HW * (C / kCluster);
}

constexpr long kDwSmemLimit = 232448 - static_cast<long>(sizeof(Red)) - 1024;

// How many kCluster-block clusters of `kernel` (threads a block, smem bytes
// of dynamic shared memory) the card holds at once (0 on an error).
template <typename K>
int resident_clusters(K kernel, int threads, long smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 256, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : 0;
}

}  // namespace
