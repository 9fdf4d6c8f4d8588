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
// One cluster of kCluster blocks per sample, each block a 264-channel
// slice (at far_mnist) in two f32 shared-memory buffers (x, then xhat1 and
// z1; z2): device memory sees x once and the output once; the affines come
// from L2 (every sample reads them).

#include "dw_chain.cuh"

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

}  // namespace

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory a block takes for (HW, C), in bytes; more than
// 231,000 or so (the limit less the static reduction scratch) means the
// shape is not supported. C must be a multiple of 32.
long vptr_fused_dw_chain_smem(int HW, int C) { return dw_smem(HW, C, 2); }

// Clusters (samples) of the bf16 kernel the card runs at once for (HW, C).
int vptr_fused_dw_chain_clusters(int HW, int C) {
  return resident_clusters(dw_chain_kernel<bf16>, kFwdThreads, dw_smem(HW, C, 2));
}

// dtype: 0 = float32, 1 = bfloat16; W the row-grid width (HW = H * W).
// seed (device int32) may be null when rate == 0; keep_div = (float)(1 -
// rate). Returns a cudaError_t (0 = launched).
int vptr_fused_dw_chain(const void* x, const void* taps, const void* dwb, const void* s1,
                        const void* b1, const void* s2, const void* b2, void* out, int N,
                        int HW, int W, int C, float eps, const void* seed, float rate,
                        float keep_div, int dtype, void* stream) {
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || !dw_shape_ok(HW, W, C) || dtype < 0 || dtype > 1 ||
      dw_smem(HW, C, 2) > kDwSmemLimit || (rate > 0.f && !seed) || rate >= 1.f)
    return cudaErrorInvalidValue;
  return dtype == 0 ? launch<float>(x, taps, dwb, s1, b1, s2, b2, out, N, HW, W, C, eps, drop, s)
                    : launch<bf16>(x, taps, dwb, s1, b1, s2, b2, out, N, HW, W, C, eps, drop, s);
}

}  // extern "C"
