// Fused 1x1 conv + whole-sample LayerNorm + affine + GELU, forward, on
// Hopper (sm_90a), over x (N, HW, Cin) with W (Cin, Cout): the arithmetic of
// conv_ln.cuh; x, W and the output in T (float or bf16), b (Cout) and the
// (HW, Cout) affines scale, bias2 f32; the result rounded to T once.
//
// Replaces the TPU kernel vptr_tpu/ops/fused_conv_ln.py::_forward
// (_fwd_kernel at :86, pl.pallas_call at :174). The backward is
// conv_ln_gelu_bwd.cu.
//
// What bounds it on an H100: operations. The product is 2 S Cin Cout flops
// (28.5 GFLOP at S = N HW = 12,800 rows, 528 -> 2112: 0.029 ms at 989
// TFLOP/s in bf16) against ~71 MB that the function must move (x read once,
// the output written once, W and the affines: 0.021 ms at 3.35 TB/s). The
// GEMM output never reaches device memory: one cluster of G blocks per
// sample keeps it in shared memory in f32 through the statistics, the
// affine and the GELU (conv_ln.cuh), so device memory sees x once and the
// output once; W and the affines come from L2 (every sample reads them).
// The products are WMMA (the ceiling every WMMA product of the port shows,
// ~100-130 TFLOP/s; see PERF.md).

#include "conv_ln.cuh"

namespace {

template <typename T, int CT>
__global__ void __launch_bounds__(kClnThreads)
conv_ln_gelu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ scale,
                    const float* __restrict__ bias2, T* __restrict__ out, int HW, int Cin,
                    int Cout, int SW, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem_cln[];
  __shared__ ClnRed red;
  const int G = static_cast<int>(cluster.num_blocks());
  const int c0 = static_cast<int>(cluster.block_rank()) * SW;
  const long n = blockIdx.x / G;
  float mean, rstd;
  sample_u<T, CT>(x + n * HW * Cin, w, b, HW, Cin, Cout, c0, SW, eps, smem_cln, red, cluster,
                  mean, rstd);
  const float* slab = reinterpret_cast<const float*>(smem_cln);
  const int lds = SW + 4;
  T* on = out + n * HW * Cout;
  for (int e = threadIdx.x; e < HW * SW; e += kClnThreads) {
    const int r = e / SW, c = e - r * SW;
    const long o = static_cast<long>(r) * Cout + c0 + c;
    const float zh = (slab[r * lds + c] - mean) * rstd;
    on[o] = from_f32<T>(vptr_gelu::gelu(zh * scale[o] + bias2[o]));
  }
  cluster.sync();                      // the other blocks are done reading red
}

template <typename T, int CT>
int launch(const void* x, const void* w, const void* b, const void* scale, const void* bias2,
           void* out, int N, int HW, int Cin, int Cout, float eps, int dtype, cudaStream_t s) {
  const int G = cln_split(Cout), SW = Cout / G;
  return launch_clusters(conv_ln_gelu_kernel<T, CT>, N * G, G, cln_smem(HW, SW, dtype), s,
                         static_cast<const T*>(x), static_cast<const T*>(w),
                         static_cast<const float*>(b), static_cast<const float*>(scale),
                         static_cast<const float*>(bias2), static_cast<T*>(out), HW, Cin, Cout,
                         SW, eps);
}

}  // namespace

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks per sample (the cluster size) for Cout; 0: Cout is not taken.
int vptr_conv_ln_gelu_split(int Cout) { return Cout % 16 ? 0 : cln_split(Cout); }

// Dynamic shared memory a block takes for (HW, Cout, dtype), in bytes.
long vptr_conv_ln_gelu_smem(int HW, int Cout, int dtype) {
  const int G = vptr_conv_ln_gelu_split(Cout);
  return G ? cln_smem(HW, Cout / G, dtype) : -1;
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int vptr_conv_ln_gelu(const void* x, const void* w, const void* b, const void* scale,
                      const void* bias2, void* out, int N, int HW, int Cin, int Cout, float eps,
                      int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!cln_shape_ok(N, HW, Cin, Cout) || dtype < 0 || dtype > 1 ||
      vptr_conv_ln_gelu_smem(HW, Cout, dtype) > kClnSmemLimit)
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, 1>(x, w, b, scale, bias2, out, N, HW, Cin, Cout, eps, 0, s);
  switch (cln_ct(Cout / cln_split(Cout))) {
    case 1: return launch<bf16, 1>(x, w, b, scale, bias2, out, N, HW, Cin, Cout, eps, 1, s);
    case 2: return launch<bf16, 2>(x, w, b, scale, bias2, out, N, HW, Cin, Cout, eps, 1, s);
    default: return launch<bf16, 3>(x, w, b, scale, bias2, out, N, HW, Cin, Cout, eps, 1, s);
  }
}

}  // extern "C"
