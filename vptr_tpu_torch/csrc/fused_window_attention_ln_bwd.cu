// Backward of the LayerNorm-folded window self-attention sublayer on
// Hopper (sm_90a): the passes of fused_window_attention_bwd.cuh with
// LN = true, for both fused_attention_ln and fused_attention_ln_res (dx,
// dWq/k/v/o, dbq/k/v/o, dls, dlb, dbias).
//
// Replaces the TPU kernel vptr_tpu/ops/fused_window_attention.py::
// _fused_ln_backward (_bwd_kernel_ln at :609, pl.pallas_call at :769).
//
// What bounds it on an H100: operations. It recomputes the three input
// projections and forms d(attn) = g Wo^T, the four weight gradients
// X^T dY and d(xn) through three projections: eleven R x C x C products,
// 22 R C^2 flops (7.5e10 at R = 12,160 rows of C = 528, the far_mnist
// training step; 0.075 ms at 989 TFLOP/s), against about 40 MB of
// device-memory traffic that the result needs. So the products belong on
// the tensor cores (the header's tc_gemm route).

#include "fused_window_attention_bwd.cuh"

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows per partial of the column sums -> number of partials the caller
// allocates (partial: 6 x partials x C f32).
int vptr_fused_window_attention_ln_bwd_partials(int rows) { return partials(rows); }

// K chunks of the weight-gradient products (wpart: 4 x ksplit x C x C f32).
int vptr_fused_window_attention_ln_bwd_ksplit(int rows) { return weight_splits(rows); }

// Returns a cudaError_t (0 = every pass launched).
int vptr_fused_window_attention_ln_bwd(const BwdArgs* a, void* stream) {
  return run_backward<true>(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
