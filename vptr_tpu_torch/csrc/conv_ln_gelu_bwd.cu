// Backward of the fused 1x1 conv + whole-sample LayerNorm + GELU
// (conv_ln_gelu.cu) on Hopper (sm_90a). Given the output cotangent g (N, HW,
// Cout), recompute the forward and compute dx, dW, db, d(scale), d(bias2):
//     da = g gelu'(a),  a = zhat scale + bias2
//     ds = sum_n da zhat,  dt = sum_n da                       (HW, Cout)
//     du = (dz - mean(dz) - zhat mean(dz zhat)) rstd,  dz = da scale
//     dW = x^T du,  db = sum du,  dx = du W^T                 (f32 operands)
// dx in T, dW in W's dtype T (the JAX route's weight gradient is rounded to
// bf16 before it reaches the f32 parameter), db, ds, dt f32.
//
// Replaces the TPU kernel vptr_tpu/ops/fused_conv_ln.py::_backward
// (_bwd_kernel at :97, pl.pallas_call at :196).
//
// What bounds it on an H100: operations. Three S x Cin x Cout products (the
// recomputed u, dW, dx) are 6 S Cin Cout flops: 81.2 GFLOP at S = 12,160,
// 528 -> 2112 (0.082 ms at 989 TFLOP/s), against ~84 MB the result needs.
//
// The TPU kernel walked its sample grid in order and summed dW, db, ds, dt
// in place across grid steps. Blocks on the card run in parallel, so the
// work is three passes (no float atomics: every sum over samples is a K
// loop or a fixed-order second pass, so the gradients are the same on every
// run):
//   1. per group of samples, one cluster of G blocks (conv_ln.cuh) walks the
//      group's samples in order: the slab of u recomputed in shared memory,
//      mean and rstd, da and the two sums of the LayerNorm backward through
//      the cluster, then du to device memory (f32, or for bf16 its hi and
//      lo halves for the tensor cores) and da zhat, da, du added into the
//      group's (HW, Cout) partials, each element by the one thread that owns
//      it;
//   2. dx = du W^T and dW = x^T du with K = S split in chunks of about 1024
//      rows, summed in chunk order and cast to T (tile_ops.cuh; bf16 on the
//      tensor cores with du as hi + lo, relative error below 2^-16);
//   3. ds, dt and the per-position db summed over the groups in order, then
//      db over the HW positions.

#include "conv_ln.cuh"

// Everything the backward needs; mirrored by _BwdArgs in
// vptr_tpu_torch/ops/conv_ln_gelu.py. Inputs, outputs, then the
// caller-allocated scratch (du: S x Cout f32, or 2 x S x Cout bf16 [hi, lo]
// when T is bf16; pds, pdt, pdb: groups x HW x Cout f32; dbfull: HW x Cout
// f32; wpart: ksplit x Cin x Cout f32; partial: parts(HW) x Cout f32).
struct ClnBwdArgs {
  const void *x, *w, *b, *scale, *bias2, *g;
  void *dx, *dw, *db, *ds, *dt;
  void *du, *pds, *pdt, *pdb, *dbfull, *wpart, *partial;
  int N, HW, Cin, Cout, dtype, groups, ksplit;
  float eps;
};

namespace {

// Sample groups (clusters of pass 1) for N samples and G blocks a sample:
// about two resident blocks an SM (132 SMs), at most N.
int cln_groups(int N, int G) {
  const int g = 2 * 132 / G;
  return N < g ? N : g;
}

// 1. The per-sample pass: du and the groups' partials.
template <typename T, int CT>
__global__ void __launch_bounds__(kClnThreads)
conv_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ b, const float* __restrict__ scale,
                   const float* __restrict__ bias2, const T* __restrict__ g,
                   float* __restrict__ du, bf16* __restrict__ du_hilo,
                   float* __restrict__ pds, float* __restrict__ pdt, float* __restrict__ pdb,
                   int N, int groups, int HW, int Cin, int Cout, int SW, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem_cln[];
  __shared__ ClnRed red;
  const int G = static_cast<int>(cluster.num_blocks());
  const int c0 = static_cast<int>(cluster.block_rank()) * SW;
  const int grp = blockIdx.x / G;
  const float* slab = reinterpret_cast<const float*>(smem_cln);
  const int lds = SW + 4;
  const float inv_n = 1.f / (static_cast<float>(HW) * Cout);
  const long plane = static_cast<long>(HW) * Cout;
  const long S = static_cast<long>(N) * HW;
  float* ps = pds + grp * plane;
  float* pt = pdt + grp * plane;
  float* pb = pdb + grp * plane;
  for (int n = grp; n < N; n += groups) {
    const bool first = n == grp;
    float mean, rstd;
    sample_u<T, CT>(x + n * static_cast<long>(HW) * Cin, w, b, HW, Cin, Cout, c0, SW, eps,
                    smem_cln, red, cluster, mean, rstd);
    const T* gn = g + n * plane;
    float v[2] = {0.f, 0.f};
    for (int e = threadIdx.x; e < HW * SW; e += kClnThreads) {
      const int r = e / SW, c = e - r * SW;
      const long o = static_cast<long>(r) * Cout + c0 + c;
      const float zh = (slab[r * lds + c] - mean) * rstd;
      const float sc = scale[o];
      const float dz = to_f32(gn[o]) * vptr_gelu::gelu_grad(zh * sc + bias2[o]) * sc;
      v[0] += dz;
      v[1] = fmaf(dz, zh, v[1]);
    }
    cluster_sum(v, red, 2, cluster);
    const float m1 = v[0] * inv_n, m2 = v[1] * inv_n;
    for (int e = threadIdx.x; e < HW * SW; e += kClnThreads) {
      const int r = e / SW, c = e - r * SW;
      const long o = static_cast<long>(r) * Cout + c0 + c;
      const float zh = (slab[r * lds + c] - mean) * rstd;
      const float sc = scale[o];
      const float da = to_f32(gn[o]) * vptr_gelu::gelu_grad(zh * sc + bias2[o]);
      const float d = (da * sc - m1 - zh * m2) * rstd;
      const long row = n * static_cast<long>(HW) + r;
      if (du_hilo) {
        const bf16 hi = __float2bfloat16_rn(d);
        du_hilo[row * Cout + c0 + c] = hi;
        du_hilo[S * Cout + row * Cout + c0 + c] = __float2bfloat16_rn(d - __bfloat162float(hi));
      } else {
        du[row * Cout + c0 + c] = d;
      }
      ps[o] = (first ? 0.f : ps[o]) + da * zh;
      pt[o] = (first ? 0.f : pt[o]) + da;
      pb[o] = (first ? 0.f : pb[o]) + d;
    }
    __syncthreads();                   // the next sample's ring overwrites the slab
  }
  cluster.sync();                      // the other blocks are done reading red
}

template <typename T, int CT>
cudaError_t launch_pass1(const ClnBwdArgs& a, int G, cudaStream_t s) {
  const int SW = a.Cout / G;
  const bool hilo = std::is_same<T, bf16>::value;
  return launch_clusters(
      conv_ln_bwd_kernel<T, CT>, a.groups * G, G, cln_smem(a.HW, SW, a.dtype), s,
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), static_cast<const float*>(a.b),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.bias2),
      static_cast<const T*>(a.g), hilo ? nullptr : static_cast<float*>(a.du),
      hilo ? static_cast<bf16*>(a.du) : nullptr, static_cast<float*>(a.pds),
      static_cast<float*>(a.pdt), static_cast<float*>(a.pdb), a.N, a.groups, a.HW, a.Cin,
      a.Cout, SW, a.eps);
}

template <typename T>
int run(const ClnBwdArgs& a, cudaStream_t s) {
  const int G = cln_split(a.Cout);
  const int S = a.N * a.HW, Cin = a.Cin, Cout = a.Cout;
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };

  // 1. du and the partials
  if constexpr (std::is_same<T, bf16>::value) {
    switch (cln_ct(Cout / G)) {
      case 1: VPTR_TRY((launch_pass1<bf16, 1>(a, G, s))); break;
      case 2: VPTR_TRY((launch_pass1<bf16, 2>(a, G, s))); break;
      default: VPTR_TRY((launch_pass1<bf16, 3>(a, G, s))); break;
    }
  } else {
    VPTR_TRY((launch_pass1<T, 1>(a, G, s)));
  }

  // 2. dx = du W^T (S x Cin, K = Cout);  dW = x^T du (Cin x Cout, K = S in
  //    ksplit chunks), the chunks summed in order
  const int kchunk_tc = ((S + a.ksplit - 1) / a.ksplit + TBK - 1) / TBK * TBK;
  const int kchunk_fma = ((S + a.ksplit - 1) / a.ksplit + BK - 1) / BK * BK;
  if constexpr (std::is_same<T, bf16>::value) {
    const bf16* hi = static_cast<const bf16*>(a.du);
    const bf16* lo = hi + static_cast<long>(S) * Cout;
    TcBatch tb{};
    tb.M = S, tb.N = Cin, tb.K = Cout, tb.lda = Cout, tb.ldb = Cout, tb.ldo = Cin, tb.group = 1;
    tb.ksplit = 1, tb.kchunk = Cout;
    tb.job[0] = tc_job({hi, lo}, {a.w, a.w}, a.dx);
    VPTR_TRY((tc_gemm<false, true, bf16, kF32>(tb, 1, s)));
    tb.M = Cin, tb.N = Cout, tb.K = S, tb.lda = Cin, tb.ldb = Cout, tb.ldo = Cout;
    tb.ksplit = a.ksplit, tb.kchunk = kchunk_tc;
    tb.job[0] = tc_job({a.x, a.x}, {hi, lo}, a.wpart);
    VPTR_TRY((tc_gemm<true, false, float, kPartial>(tb, 1, s)));
  } else {
    GemmBatch gb{};
    gb.M = S, gb.N = Cin, gb.K = Cout, gb.lda = Cout, gb.ldb = Cout, gb.ldo = Cin, gb.group = 1;
    gb.ksplit = 1, gb.kchunk = Cout;
    gb.job[0] = {a.du, a.w, a.dx, nullptr, 1.f, nullptr, nullptr, 0};
    VPTR_TRY((gemm<float, false, T, true, T, kF32>(gb, 1, s)));
    gb.M = Cin, gb.N = Cout, gb.K = S, gb.lda = Cin, gb.ldb = Cout, gb.ldo = Cout;
    gb.ksplit = a.ksplit, gb.kchunk = kchunk_fma;
    gb.job[0] = {a.x, a.du, a.wpart, nullptr, 1.f, nullptr, nullptr, 0};
    VPTR_TRY((gemm<T, true, float, false, float, kPartial>(gb, 1, s)));
  }
  SplitSum ws{};
  ws.part[0] = cf(a.wpart), ws.out[0] = a.dw;
  ws.ksplit = a.ksplit, ws.n = static_cast<long>(Cin) * Cout;
  split_sum_kernel<T><<<dim3(static_cast<unsigned>((ws.n + 255) / 256), 1), 256, 0, s>>>(ws);
  VPTR_TRY(cudaGetLastError());

  // 3. ds, dt, the per-position db over the groups in order; db over HW
  SplitSum ps{};
  ps.part[0] = cf(a.pds), ps.out[0] = a.ds;
  ps.part[1] = cf(a.pdt), ps.out[1] = a.dt;
  ps.part[2] = cf(a.pdb), ps.out[2] = a.dbfull;
  ps.ksplit = a.groups, ps.n = static_cast<long>(a.HW) * Cout;
  split_sum_kernel<float><<<dim3(static_cast<unsigned>((ps.n + 255) / 256), 3), 256, 0, s>>>(ps);
  VPTR_TRY(cudaGetLastError());
  ColBatch cb{};
  cb.job[0] = {a.dbfull, 0, nullptr, 0, f(a.db)};
  cb.rows = a.HW, cb.C = Cout, cb.group = 1, cb.parts = partials(a.HW);
  cb.partial = f(a.partial);
  colsum_partial_kernel<float><<<dim3((Cout + 127) / 128, cb.parts, 1), 128, 0, s>>>(cb);
  VPTR_TRY(cudaGetLastError());
  colsum_final_kernel<<<dim3((Cout + 127) / 128, 1), 128, 0, s>>>(cb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vptr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sample groups of pass 1 (pds, pdt, pdb: groups x HW x Cout f32).
int vptr_conv_ln_gelu_bwd_groups(int N, int Cout) {
  const int G = Cout % 16 ? 0 : cln_split(Cout);
  return G ? cln_groups(N, G) : 0;
}

// K chunks of the weight-gradient product (wpart: ksplit x Cin x Cout f32).
int vptr_conv_ln_gelu_bwd_ksplit(int rows) { return weight_splits(rows); }

// Column-sum partials of db (partial: parts x Cout f32).
int vptr_conv_ln_gelu_bwd_partials(int HW) { return partials(HW); }

// Returns a cudaError_t (0 = every pass launched).
int vptr_conv_ln_gelu_bwd(const ClnBwdArgs* a, void* stream) {
  if (!a || !cln_shape_ok(a->N, a->HW, a->Cin, a->Cout) || a->dtype < 0 || a->dtype > 1 ||
      a->groups != cln_groups(a->N, cln_split(a->Cout)) || a->ksplit < 1 || !a->du ||
      !a->pds || !a->pdt || !a->pdb || !a->dbfull || !a->wpart || !a->partial ||
      cln_smem(a->HW, a->Cout / cln_split(a->Cout), a->dtype) > kClnSmemLimit)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 0 ? run<float>(*a, s) : run<bf16>(*a, s);
}

}  // extern "C"
