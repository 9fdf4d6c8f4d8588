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
// device-memory traffic that the result needs. On the bf16 route every
// product runs on wgmma fed by TMA (the header's note): with dq, dk, dv
// and g * scale as hi + lo halves the products are 18 terms of 2 R C^2,
// 122 GFLOP at that shape.

#include "fused_window_attention_bwd.cuh"

extern "C" {

const char* vptr_error_string(int err) { return error_string(err); }

// 1 when (C, Cl, dtype) takes the wgmma route, 0 for the FMA route (Cl:
// the inner width, C for every head).
int vptr_fused_window_attention_ln_bwd_route(int channels, int inner, int dtype) {
  return wg_route(channels, inner, dtype) ? 1 : 0;
}

// Rows of the LayerNorm backward's column-sum partials the caller
// allocates (partial: 2 x rows x C f32).
int vptr_fused_window_attention_ln_bwd_partials(int rows) { return ln_parts(rows); }

// K chunks of the weight-gradient products (wpart: 4 x ksplit x C x Cl f32).
int vptr_fused_window_attention_ln_bwd_ksplit(int rows, int channels, int inner, int dtype) {
  return ksplits(rows, channels, inner, dtype);
}

// Returns a cudaError_t (0 = every pass launched), or kTmaEncodeError + a
// CUresult.
int vptr_fused_window_attention_ln_bwd(const BwdArgs* a, void* stream) {
  return run_backward<true>(a, static_cast<cudaStream_t>(stream));
}

// The wgmma route's products alone, in f32:
// out (rows, cols) = (a + a_lo) B over K = depth, a and a_lo (rows, depth)
// bf16 (a_lo null: one term), B = b (depth, cols) as stored when b_mn (the
// projections' operand; a_lo must then be null), else b is B^T (cols,
// depth) (d(attn)'s and d(xn)'s). depth and cols multiples of 8.
int vptr_window_rows_product(const void* a, const void* a_lo, const void* b, void* out,
                             int rows, int depth, int cols, int b_mn, void* stream) {
  if (rows < 1 || depth < 8 || depth % 8 || cols < 8 || cols % 8 || (b_mn && a_lo))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  RwMaps m;
  RwWork w{};
  int err = rw_amap(&m.a[0][0], a, rows, depth, depth);
  if (!err && a_lo) err = rw_amap(&m.a[0][1], a_lo, rows, depth, depth);
  if (!err) err = rw_bmap(&m.b[0], b, depth, cols, b_mn ? cols : depth, b_mn);
  if (err) return err;
  w.job[0] = {out, nullptr, 1.f, nullptr, depth};
  w.jobs = 1, w.rows = rows, w.cols = cols, w.group = 1;
  if (b_mn) return launch_rows<1, true, kRwF32>(m, w, s);
  return a_lo ? launch_rows<2, false, kRwF32>(m, w, s) : launch_rows<1, false, kRwF32>(m, w, s);
}

// The four weight products of one launch alone: out[j] (C, C) f32 = x_j^T
// (h_j + l_j) over K = rows (l_j null: one term), x_j, h_j, l_j (rows, C)
// bf16, C a multiple of 8; part: 4 x ksplit(rows, C, bf16) x C x C f32 of
// scratch; out: 4 x C x C f32.
int vptr_window_weight_products(const void* const* x, const void* const* h,
                                const void* const* l, void* part, void* out, int rows, int C,
                                void* stream) {
  if (rows < 1 || C < 8 || C % 8) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ksplit = ksplits(rows, C, C, 1);
  const long cc = static_cast<long>(C) * C;
  DwJobs<4> jobs;
  for (int j = 0; j < 4; ++j) {
    int err = strided_map(&jobs.x[j], x[j], rows, C, C, 64, 64);
    if (!err) err = strided_map(&jobs.h[j], h[j], rows, C, C, 64, 64);
    if (!err && l[j]) err = strided_map(&jobs.l[j], l[j], rows, C, C, 64, 64);
    if (err) return err;
    if (!l[j]) jobs.l[j] = jobs.h[j];
    jobs.terms[j] = l[j] ? 2 : 1;
    jobs.out[j] = static_cast<float*>(part) + j * ksplit * cc;
  }
  if (int err = launch_dw_jobs<4>(jobs, rows, C, C, ksplit, s)) return err;
  SplitSum ss{};
  for (int j = 0; j < 4; ++j)
    ss.part[j] = static_cast<const float*>(part) + j * ksplit * cc,
    ss.out[j] = static_cast<float*>(out) + j * cc;
  ss.ksplit = ksplit, ss.n = cc;
  split_sum_kernel<float><<<dim3(static_cast<unsigned>((cc + 255) / 256), 4), 256, 0, s>>>(ss);
  return cudaGetLastError();
}

}  // extern "C"
