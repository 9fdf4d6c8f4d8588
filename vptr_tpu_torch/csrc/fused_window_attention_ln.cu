// LayerNorm-folded window self-attention sublayer on Hopper (sm_90a):
//     xn  = LN(x) * ls + lb                 (f32 statistics, rounded to T)
//     q,k = (xn + pos) Wq|Wk + bq|bk,  v = xn Wv + bv     (f32 sums, to T)
//     a_h = dropout(softmax(q_h k_h^T * hd^-1/2 + bias_h)) v_h  (per head)
//     out = [a_1 .. a_H] Wo + bo,  then * scale[window], + x when res
// The passes are fused_window_attention.cuh's with LN = true; that header
// describes the two routes: on the bf16 wgmma route LayerNorm rows, q/k/v
// (one launch of three wgmma products), the attention per (window, head)
// on mma.sync, and the out projection on wgmma with + bo, * scale, + x in
// its epilogue; f32 (or C not a multiple of 8) one FMA kernel.
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
// against ~29 MB of device-memory traffic; the bf16 route runs them on
// wgmma, and its passes' scratch round trips (6 R C bf16) cost bytes on
// top.

#include "fused_window_attention.cuh"

extern "C" {

const char* vptr_error_string(int err) { return error_string(err); }

// Dynamic shared memory of the route the forward takes for (L, C, Cl,
// heads, dtype) (Cl: the inner width, C for every head), in bytes; more
// than 232448 means the shape is not supported.
long vptr_fused_window_attention_ln_smem(int L, int C, int Cl, int heads, int dtype) {
  return window_smem(L, C, Cl, heads, dtype);
}

// 1 when (L, C, Cl, dtype) takes the wgmma route, 0 for the FMA route.
int vptr_fused_window_attention_ln_route(int L, int C, int Cl, int dtype) {
  return use_wg(L, C, Cl, dtype) ? 1 : 0;
}

// Returns a cudaError_t (0 = every pass launched), or kTmaEncodeError + a
// CUresult.
int vptr_fused_window_attention_ln(const FwdArgs* a, void* stream) {
  return run_forward<true>(a, static_cast<cudaStream_t>(stream));
}

// The wgmma route's passes alone, for the tests:
// the attention over q, k, v (windows * L rows of C bf16, q scaled and
// rounded) into attn (the merged heads, bf16), bias (1|heads, L, L) f32 or
// null, seed null when rate == 0; C a multiple of 8.
int vptr_window_attention_pass(const void* q, const void* k, const void* v, const void* bias,
                               void* attn, int windows, int L, int C, int heads,
                               int bias_heads, const void* seed, float rate, float keep_div,
                               int mask_tokens, void* stream) {
  if (windows < 1 || L < 1 || L > kMaxTokens || heads < 1 || C % heads != 0 || C % 8 != 0 ||
      C / heads > kMaxHeadDim || attn_smem(L, C) > kSmemLimit || mask_tokens < L ||
      (bias && bias_heads != 1 && bias_heads != heads) || (rate > 0.f && !seed) || rate >= 1.f)
    return cudaErrorInvalidValue;
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div};
  return launch_attention(q, k, v, bias, attn, windows, L, C, heads, bias_heads, mask_tokens,
                          drop, static_cast<cudaStream_t>(stream));
}

// out (rows, C) bf16 = (a Wo + bo) * scale[row / L] (+ res), rounded once;
// a, res (rows, C) and wo (C, C) bf16, bo (C,) and scale (rows / L,) f32;
// scale and res may be null; C a multiple of 8.
int vptr_window_out_projection(const void* a, const void* wo, const void* bo,
                               const void* scale, const void* res, void* out, int rows, int L,
                               int C, void* stream) {
  if (rows < 1 || L < 1 || C < 8 || C % 8 != 0) return cudaErrorInvalidValue;
  return out_projection(a, wo, bo, scale, res, out, rows, L, C, C,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
