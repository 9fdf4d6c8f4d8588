// Backward of the two-stream window attention sublayer on Hopper
// (sm_90a): the passes of fused_window_attention_bwd.cuh with LN = false
// (dx_qk, dx_v, dWq/k/v/o, dbq/k/v/o, dbias). On the NAR path it runs the
// decoder's window self-attention backward, with the (H, 16, 16)
// relative-position bias gradient summed over the windows in a fixed
// order.
//
// Replaces the TPU kernel vptr_tpu/ops/fused_window_attention.py::
// _fused_backward (_bwd_kernel at :260, pl.pallas_call at :386).
//
// What bounds it on an H100: operations. It recomputes the three input
// projections and forms d(attn) = g Wo^T, the four weight gradients
// X^T dY, dx_qk through two projections and dx_v through one: eleven
// R x C x C products, 22 R C^2 flops plus 12 windows L^2 C for the
// attention (63.8 GFLOP at R = 10,240 rows of C = 528, the nar_mnist
// training step; 0.065 ms at 989 TFLOP/s), against about 59 MB of
// device-memory traffic. Without the LayerNorm passes (1, 7 and the dlb,
// dls sums) the work is #3's less the LN; on the bf16 route the
// products take the same wgmma kernels (the header's note), dWo over g
// itself (no scale: one term), dx_qk over K = 2C (four hi/lo terms) and
// dx_v over C (two) in one launch, written in bf16.

#include "fused_window_attention_bwd.cuh"

extern "C" {

const char* vptr_error_string(int err) { return error_string(err); }

// 1 when (C, Cl, dtype) takes the wgmma route, 0 for the FMA route (Cl:
// the inner width, C for every head).
int vptr_fused_window_attention_bwd_route(int channels, int inner, int dtype) {
  return wg_route(channels, inner, dtype) ? 1 : 0;
}

// K chunks of the weight-gradient products (wpart: 4 x ksplit x C x Cl f32).
int vptr_fused_window_attention_bwd_ksplit(int rows, int channels, int inner, int dtype) {
  return ksplits(rows, channels, inner, dtype);
}

// Returns a cudaError_t (0 = every pass launched), or kTmaEncodeError + a
// CUresult.
int vptr_fused_window_attention_bwd(const BwdArgs* a, void* stream) {
  return run_backward<false>(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
