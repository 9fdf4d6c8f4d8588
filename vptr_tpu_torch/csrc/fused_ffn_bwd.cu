// Backward of the fused LayerNorm + feed-forward sublayer (fused_ffn.cu) on
// Hopper (sm_90a). Given the output cotangent g (S, C), recompute the
// forward's hidden and compute dx, dW1, db1, dW2, db2, dls, dlb.
//
// Replaces the TPU kernel vptr_tpu/ops/fused_ffn.py::_backward (_bwd_kernel
// at :97, pl.pallas_call at :214). As there, every product takes f32
// operands: dW2 comes from the unrounded dropped hidden hd (the forward's
// fc2 took it rounded to T).
//
// What bounds it on an H100: operations. Five S x C x H products (the
// recomputed fc1, dhd = g W2^T, dW2 = hd^T g, dW1 = xn^T da, dxn = da W1^T)
// are 10 S C H flops: 135.6 GFLOP at S = 12,160, C = 528, H = 2112 (0.137
// ms at 989 TFLOP/s), against ~40 MB the result needs.
//
// The TPU kernel walked its row grid in order and summed the weight, bias
// and affine gradients in place across grid steps. Blocks on the card run
// in parallel, so the work is a sequence of passes built from tile_ops.cuh
// (no float atomics: every sum over rows is a K loop or a fixed-order
// second pass, so the gradients are the same on every run):
//   1. ln_rows: per-row mean and rstd, xn rounded to T;
//   2. act = xn W1 + b1 (f32);   3. dact = g W2^T (f32);
//   4. act_grad: h = gelu(act), the hash mask (row * H + col), in place
//      act <- hd = dropout(h) and dact <- da = dropout(dact) gelu'(act);
//      on the tensor-core route also their bf16 hi/lo halves;
//   5. dW2 = hd^T g and dW1 = xn^T da with K = S split in chunks of about
//      1024 rows, each chunk's f32 sums to scratch, then summed in chunk
//      order and cast to T;
//   6. dxn = da W1^T (f32);   7. ln_bwd: dx per row;
//   8. column sums in two fixed-order passes: db1 = sum da, db2 = sum g,
//      dlb = sum dxn, dls = sum dxn xhat.
// The hidden-width scratch (act, dact and the hi/lo halves) lives only for
// this call: the forward saved nothing but its inputs.
// The products run on the tensor cores for bf16 when S, C and H are
// multiples of 8 (tile_ops.cuh's tc_gemm; an f32 operand is the sum of its
// bf16 hi and lo halves, relative error below 2^-16, far below the bf16
// rounding of dx and the weight gradients), else as f32 FMAs (gemm).

#include <type_traits>

#include "gelu_as.cuh"
#include "hash_dropout.cuh"
#include "tile_ops.cuh"

// Everything the backward needs; mirrored by _BwdArgs in
// vptr_tpu_torch/ops/fused_ffn.py. Inputs, outputs, then the
// caller-allocated scratch (mean, rstd: S f32; xn: S x C in T; act, dact:
// S x H f32; hilo: 4 x S x H bf16 when T is bf16, else null; dxn: S x C
// f32; wpart1: ksplit x C x H f32; wpart2: ksplit x H x C f32; partial:
// parts x (H + 3 C) f32).
struct FfnBwdArgs {
  const void *x, *w1, *b1, *w2, *b2, *ls, *lb, *seed, *g;
  void *dx, *dw1, *db1, *dw2, *db2, *dls, *dlb;
  void *mean, *rstd, *xn, *act, *dact, *hilo, *dxn, *wpart1, *wpart2, *partial;
  int rows, channels, hidden, dtype, ksplit, parts;
  float eps, rate, keep_div;
};

namespace {

// 4. act <- dropout(gelu(act)), dact <- dropout(dact) * gelu'(act), element
//    i = row * H + col (the forward's dropout index); hilo (or null) gets
//    [hd hi, hd lo, da hi, da lo].
__global__ void act_grad_kernel(float* __restrict__ act, float* __restrict__ dact,
                                bf16* __restrict__ hilo, long n, vptr_dropout::Params drop) {
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const float a = act[i];
    float hd = vptr_gelu::gelu(a), dh = dact[i];
    if (drop.active()) {
      const bool kept = drop.keep(static_cast<uint32_t>(i), seed);
      hd = drop.apply(hd, kept);
      dh = drop.apply(dh, kept);
    }
    const float da = dh * vptr_gelu::gelu_grad(a);
    act[i] = hd;
    dact[i] = da;
    if (hilo) {
      const bf16 hh = __float2bfloat16_rn(hd), dhi = __float2bfloat16_rn(da);
      hilo[i] = hh;
      hilo[n + i] = __float2bfloat16_rn(hd - __bfloat162float(hh));
      hilo[2 * n + i] = dhi;
      hilo[3 * n + i] = __float2bfloat16_rn(da - __bfloat162float(dhi));
    }
  }
}

template <typename T>
int run(const FfnBwdArgs& a, cudaStream_t s) {
  const int S = a.rows, C = a.channels, H = a.hidden;
  const bool tc_route = std::is_same<T, bf16>::value && S % 8 == 0 && C % 8 == 0 && H % 8 == 0;
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const long n = static_cast<long>(S) * H;
  const bf16* hl = static_cast<const bf16*>(a.hilo);

  // 1. LayerNorm rows
  ln_rows_kernel<T><<<(S + 7) / 8, 256, 0, s>>>(
      static_cast<const T*>(a.x), cf(a.ls), cf(a.lb), nullptr, f(a.mean), f(a.rstd),
      static_cast<T*>(a.xn), nullptr, S, 1, C, a.eps);
  VPTR_TRY(cudaGetLastError());

  // 2. act = xn W1 + b1;  3. dact = g W2^T
  if (tc_route) {
    TcBatch tb{};
    tb.M = S, tb.N = H, tb.K = C, tb.lda = C, tb.ldb = H, tb.ldo = H, tb.group = 1;
    tb.ksplit = 1, tb.kchunk = C;
    tb.job[0] = tc_job({a.xn}, {a.w1}, a.act, a.b1);
    VPTR_TRY((tc_gemm<false, false, float, kProj>(tb, 1, s)));
    tb.ldb = C;
    tb.job[0] = tc_job({a.g}, {a.w2}, a.dact);
    VPTR_TRY((tc_gemm<false, true, float, kF32>(tb, 1, s)));
  } else {
    GemmBatch gb{};
    gb.M = S, gb.N = H, gb.K = C, gb.lda = C, gb.ldb = H, gb.ldo = H, gb.group = 1;
    gb.ksplit = 1, gb.kchunk = C;
    gb.job[0] = {a.xn, a.w1, a.act, cf(a.b1), 1.f, nullptr, nullptr, 0};
    VPTR_TRY((gemm<T, false, T, false, float, kProj>(gb, 1, s)));
    gb.ldb = C;
    gb.job[0] = {a.g, a.w2, a.dact, nullptr, 1.f, nullptr, nullptr, 0};
    VPTR_TRY((gemm<T, false, T, true, float, kF32>(gb, 1, s)));
  }

  // 4. the hidden and its gradient
  const vptr_dropout::Params drop{static_cast<const int*>(a.seed), a.rate, a.keep_div};
  act_grad_kernel<<<1056, 256, 0, s>>>(f(a.act), f(a.dact),
                                       tc_route ? static_cast<bf16*>(a.hilo) : nullptr, n, drop);
  VPTR_TRY(cudaGetLastError());

  // 5. dW2 = hd^T g (H x C) and dW1 = xn^T da (C x H), K = S in ksplit
  //    chunks;  6. dxn = da W1^T
  const int kchunk_tc = ((S + a.ksplit - 1) / a.ksplit + TBK - 1) / TBK * TBK;
  const int kchunk_fma = ((S + a.ksplit - 1) / a.ksplit + BK - 1) / BK * BK;
  if (tc_route) {
    TcBatch tb{};
    tb.M = H, tb.N = C, tb.K = S, tb.lda = H, tb.ldb = C, tb.ldo = C, tb.group = 1;
    tb.ksplit = a.ksplit, tb.kchunk = kchunk_tc;
    tb.job[0] = tc_job({hl, hl + n}, {a.g, a.g}, a.wpart2);
    VPTR_TRY((tc_gemm<true, false, float, kPartial>(tb, 1, s)));
    tb.M = C, tb.N = H, tb.lda = C, tb.ldb = H, tb.ldo = H;
    tb.job[0] = tc_job({a.xn, a.xn}, {hl + 2 * n, hl + 3 * n}, a.wpart1);
    VPTR_TRY((tc_gemm<true, false, float, kPartial>(tb, 1, s)));
    tb.M = S, tb.N = C, tb.K = H, tb.lda = H, tb.ldb = H, tb.ldo = C;
    tb.ksplit = 1, tb.kchunk = H;
    tb.job[0] = tc_job({hl + 2 * n, hl + 3 * n}, {a.w1, a.w1}, a.dxn);
    VPTR_TRY((tc_gemm<false, true, float, kF32>(tb, 1, s)));
  } else {
    GemmBatch gb{};
    gb.M = H, gb.N = C, gb.K = S, gb.lda = H, gb.ldb = C, gb.ldo = C, gb.group = 1;
    gb.ksplit = a.ksplit, gb.kchunk = kchunk_fma;
    gb.job[0] = {a.act, a.g, a.wpart2, nullptr, 1.f, nullptr, nullptr, 0};
    VPTR_TRY((gemm<float, true, T, false, float, kPartial>(gb, 1, s)));
    gb.M = C, gb.N = H, gb.lda = C, gb.ldb = H, gb.ldo = H;
    gb.job[0] = {a.xn, a.dact, a.wpart1, nullptr, 1.f, nullptr, nullptr, 0};
    VPTR_TRY((gemm<T, true, float, false, float, kPartial>(gb, 1, s)));
    gb.M = S, gb.N = C, gb.K = H, gb.lda = H, gb.ldb = H, gb.ldo = C;
    gb.ksplit = 1, gb.kchunk = H;
    gb.job[0] = {a.dact, a.w1, a.dxn, nullptr, 1.f, nullptr, nullptr, 0};
    VPTR_TRY((gemm<float, false, T, true, float, kF32>(gb, 1, s)));
  }
  SplitSum ss{};
  ss.part[0] = cf(a.wpart1), ss.out[0] = a.dw1;
  ss.part[1] = cf(a.wpart2), ss.out[1] = a.dw2;
  ss.ksplit = a.ksplit, ss.n = static_cast<long>(C) * H;
  split_sum_kernel<T><<<dim3(static_cast<unsigned>((ss.n + 255) / 256), 2), 256, 0, s>>>(ss);
  VPTR_TRY(cudaGetLastError());

  // 7. dx
  ln_bwd_kernel<T><<<(S + 7) / 8, 256, 0, s>>>(cf(a.dxn), static_cast<const T*>(a.x),
                                               cf(a.mean), cf(a.rstd), cf(a.ls), nullptr,
                                               static_cast<T*>(a.dx), S, C, 0);
  VPTR_TRY(cudaGetLastError());

  // 8. db1 over the H-wide da; db2, dlb, dls over the C-wide rows
  ColBatch hb{};
  hb.job[0] = {a.dact, 0, nullptr, 0, f(a.db1)};
  hb.rows = S, hb.C = H, hb.group = 1, hb.parts = a.parts, hb.partial = f(a.partial);
  colsum_partial_kernel<T><<<dim3((H + 127) / 128, a.parts, 1), 128, 0, s>>>(hb);
  VPTR_TRY(cudaGetLastError());
  colsum_final_kernel<<<dim3((H + 127) / 128, 1), 128, 0, s>>>(hb);
  VPTR_TRY(cudaGetLastError());
  ColBatch cb{};
  cb.job[0] = {a.g, 1, nullptr, 0, f(a.db2)};
  cb.job[1] = {a.dxn, 0, nullptr, 0, f(a.dlb)};
  cb.job[2] = {a.dxn, 0, nullptr, 1, f(a.dls)};
  cb.x = a.x, cb.mean = cf(a.mean), cb.rstd = cf(a.rstd);
  cb.partial = f(a.partial) + static_cast<long>(a.parts) * H;
  cb.rows = S, cb.C = C, cb.group = 1, cb.parts = a.parts;
  colsum_partial_kernel<T><<<dim3((C + 127) / 128, a.parts, 3), 128, 0, s>>>(cb);
  VPTR_TRY(cudaGetLastError());
  colsum_final_kernel<<<dim3((C + 127) / 128, 3), 128, 0, s>>>(cb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows per partial of the column sums -> number of partials the caller
// allocates (partial: parts x (H + 3 C) f32).
int vptr_fused_ffn_bwd_partials(int rows) { return partials(rows); }

// K chunks of the weight-gradient products (wpart1/2: ksplit x C x H f32).
int vptr_fused_ffn_bwd_ksplit(int rows) { return weight_splits(rows); }

// Returns a cudaError_t (0 = every pass launched).
int vptr_fused_ffn_bwd(const FfnBwdArgs* a, void* stream) {
  if (!a || a->rows < 1 || a->channels < 1 || a->hidden < 1 || a->dtype < 0 || a->dtype > 1 ||
      (a->rate > 0.f && !a->seed) || a->rate >= 1.f || a->ksplit < 1 ||
      a->parts != partials(a->rows) || !a->wpart1 || !a->wpart2 || !a->partial ||
      (a->dtype == 1 && !a->hilo))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 0 ? run<float>(*a, s) : run<bf16>(*a, s);
}

}  // extern "C"
