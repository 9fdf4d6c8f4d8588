// Window attention sublayer with two input streams on Hopper (sm_90a):
//     q,k = x_qk Wq|Wk + bq|bk,  v = x_v Wv + bv           (f32 sums, to T)
//     a_h = dropout(softmax(q_h k_h^T * hd^-1/2 + bias_h)) v_h  (per head)
//     out = [a_1 .. a_H] Wo + bo
// x_qk, x_v, out: (B, L, C) with L <= 32; W*: (C, C) stored (in, out);
// biases and bias (1|H, L, L) f32; T = float or bf16. On the NAR path x_qk
// is LN(tgt) + query_pos and x_v is LN(tgt) (the decoder's window
// self-attention, reference VidHRFormer_modules.py:176-178), with the
// (H, 16, 16) relative-position bias.
//
// Replaces the TPU kernel vptr_tpu/ops/fused_window_attention.py::
// _fused_forward (_kernel at :138, pl.pallas_call at :239), with its
// attention-weight dropout (hash_dropout.cuh, indexed by the padded token
// count as the TPU kernel pads L in _pad_tokens). The backward is
// fused_window_attention_bwd.cu.
//
// What bounds it on an H100: operations. The four C x C projections are
// 8 L C^2 flops per window (23.2 GFLOP for 640 windows of 16 x 528, the
// nar_mnist decoder), against ~35 MB of device-memory traffic (two input
// streams, the output, four weights). The passes are
// fused_window_attention.cuh's with LN = false, the routes of the
// LayerNorm-folded kernel #1 without its LayerNorm pass: on the bf16
// wgmma route the two streams are the q/k and v products' A operands as
// they lie in memory, and the out projection's epilogue adds bo only.

#include "fused_window_attention.cuh"

extern "C" {

const char* vptr_error_string(int err) { return error_string(err); }

// Dynamic shared memory of the route the forward takes for (L, C, Cl,
// heads, dtype) (Cl: the inner width, C for every head), in bytes; more
// than 232448 means the shape is not supported.
long vptr_fused_window_attention_smem(int L, int C, int Cl, int heads, int dtype) {
  return window_smem(L, C, Cl, heads, dtype);
}

// 1 when (L, C, Cl, dtype) takes the wgmma route, 0 for the FMA route.
int vptr_fused_window_attention_route(int L, int C, int Cl, int dtype) {
  return use_wg(L, C, Cl, dtype) ? 1 : 0;
}

// Returns a cudaError_t (0 = every pass launched), or kTmaEncodeError + a
// CUresult. Without LN: x is x_qk, xv is x_v; ls, lb, pos, scale, res,
// mean, rstd, xn and xqk are unused (null, 0).
int vptr_fused_window_attention(const FwdArgs* a, void* stream) {
  return run_forward<false>(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
