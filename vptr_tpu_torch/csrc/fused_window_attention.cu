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
// streams, the output, four weights). The kernels are
// fused_window_attention.cuh's with LN = false: the same two routes as the
// LayerNorm-folded kernel #1, whose xn and xqk shared-memory buffers here
// receive x_v and x_qk as they are. The second input stream therefore
// costs no shared memory over #1 (4 x 48 x 536 bf16 + the rings = 230,400
// of 232,448 bytes on the tensor-core route, three 16-token windows per
// block).

#include "fused_window_attention.cuh"

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the route the kernel takes for (L, C, heads,
// dtype), in bytes; more than 232448 means the shape is not supported.
long vptr_fused_window_attention_smem(int L, int C, int heads, int dtype) {
  return window_smem(L, C, heads, dtype);
}

// 1 when (L, C, dtype) takes the tensor-core route, 0 for the FMA route.
int vptr_fused_window_attention_route(int L, int C, int dtype) {
  return use_tc(L, C, dtype) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. bias may be null; seed (device int32)
// may be null when rate == 0, keep_div = (float)(1 - rate), mask_tokens =
// the padded token count of the dropout index. Returns a cudaError_t
// (0 = launched).
int vptr_fused_window_attention(const void* xqk, const void* xv, const void* wq,
                                const void* bq, const void* wk, const void* bk,
                                const void* wv, const void* bv, const void* wo,
                                const void* bo, const void* bias, void* out, int windows,
                                int L, int C, int heads, int bias_heads, float qscale,
                                const void* seed, float rate, float keep_div,
                                int mask_tokens, int dtype, void* stream) {
  // no LayerNorm (ls, lb, pos, eps), no residual epilogue (scale, res)
  const FwdArgs a{xqk, xv, wq, bq, wk, bk, wv, bv, wo, bo, nullptr, nullptr, nullptr, bias,
                  nullptr, out, windows, L, C, heads, bias_heads, 0, qscale, 0.f,
                  {static_cast<const int*>(seed), rate, keep_div}, mask_tokens};
  return launch_window_attention<false>(a, dtype, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
