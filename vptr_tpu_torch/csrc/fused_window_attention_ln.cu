// LayerNorm-folded window self-attention sublayer on Hopper (sm_90a):
//     xn  = LN(x) * ls + lb                 (f32 statistics, rounded to T)
//     q,k = (xn + pos) Wq|Wk + bq|bk,  v = xn Wv + bv     (f32 sums, to T)
//     a_h = dropout(softmax(q_h k_h^T * hd^-1/2 + bias_h)) v_h  (per head)
//     out = [a_1 .. a_H] Wo + bo,  then * scale[window], + x when res
// The kernels are fused_window_attention.cuh's with LN = true; that header
// describes the two routes (bf16 WMMA tensor cores, f32 FMAs).
//
// Replaces the TPU kernel vptr_tpu/ops/fused_window_attention.py::
// _fused_ln_forward (_kernel_ln at :479, pl.pallas_call at :586), with its
// attention-weight dropout (the counter hash of hash_dropout.cuh, indexed
// by the padded token count mask_tokens as the TPU kernel pads L); res and
// scale are the epilogue of _ln_res. The backward is
// fused_window_attention_ln_bwd.cu.
//
// What bounds it on an H100: operations. The four C x C projections are
// 8 L C^2 flops per window (28.5 GFLOP for 800 windows of 16 x 528),
// against ~29 MB of device-memory traffic, so the projections belong on
// the tensor cores.

#include "fused_window_attention.cuh"

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the route the kernel takes for (L, C, heads,
// dtype), in bytes; more than 232448 means the shape is not supported.
long vptr_fused_window_attention_ln_smem(int L, int C, int heads, int dtype) {
  return window_smem(L, C, heads, dtype);
}

// 1 when (L, C, dtype) takes the tensor-core route, 0 for the FMA route.
int vptr_fused_window_attention_ln_route(int L, int C, int dtype) {
  return use_tc(L, C, dtype) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. pos, bias and scale may be null; seed
// (device int32) may be null when rate == 0, keep_div = (float)(1 - rate),
// mask_tokens = the padded token count of the dropout index. Returns a
// cudaError_t (0 = launched).
int vptr_fused_window_attention_ln(const void* x, const void* wq, const void* bq,
                                   const void* wk, const void* bk, const void* wv,
                                   const void* bv, const void* wo, const void* bo,
                                   const void* ls, const void* lb, const void* pos,
                                   const void* bias, const void* scale, void* out,
                                   int windows, int L, int C, int heads, int bias_heads,
                                   int res, float qscale, float eps, const void* seed,
                                   float rate, float keep_div, int mask_tokens, int dtype,
                                   void* stream) {
  const FwdArgs a{x, nullptr, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, scale, out,
                  windows, L, C, heads, bias_heads, res, qscale, eps,
                  {static_cast<const int*>(seed), rate, keep_div}, mask_tokens};
  return launch_window_attention<true>(a, dtype, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
