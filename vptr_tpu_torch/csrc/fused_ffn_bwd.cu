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
// in parallel, so the work is a sequence of passes (no float atomics: every
// sum over rows is a K loop or a fixed-order second pass, so the gradients
// are the same on every run):
//   1. ln_rows: per-row mean and rstd, xn rounded to T;
//   2. the hidden: a = xn W1 + b1, h = gelu(a), the hash mask (row * H +
//      col), hd = dropout(h), dhd = g W2^T, da = dropout(dhd) gelu'(a);
//   3. dW2 = hd^T g and dW1 = xn^T da with K = S split in chunks of about
//      1024 rows, each chunk's f32 sums to scratch, then summed in chunk
//      order and cast to T;   dxn = da W1^T (f32);
//   4. ln_bwd: dx per row;
//   5. column sums in two fixed-order passes: db1 = sum da, db2 = sum g,
//      dlb = sum dxn, dls = sum dxn xhat.
// The hidden-width scratch lives only for this call: the forward saved
// nothing but its inputs. Under tensor parallelism a call holds hidden
// columns col0 .. col0 + H - 1 of mask_cols (FfnBwdArgs) with b2 = 0: the
// mask is drawn at the global column, dW1, db1, dW2 are the rank's share,
// and dx, dls, dlb its partial sums (the caller adds them up over the
// ranks; db2, a sum of g, is the caller's, outside the kernel).
//
// * wgmma route (bf16, C and H multiples of 8, any S): every product on
//   Hopper's warpgroup MMA fed by TMA. An f32 operand reaches the tensor
//   cores as the sum of its bf16 hi and lo halves (relative error below
//   2^-16, far below the bf16 rounding of dx and the weight gradients), so
//   hd and da are stored as halves, each a term of the products that take
//   them:
//   - pass 2 (the hidden), one kernel (ffn_bwd_hidden_kernel): per tile
//     of 128 rows by 128 hidden columns, a = xn W1[:, tile] (w1 read
//     MN-major as stored, the transpose flag) and dhd = g W2[tile, :]^T
//     (w2's rows K-major as stored), four warpgroups each taking a 64 x 64
//     quarter of both on m64n64k16, all four operands streamed by TMA
//     through one ring of K steps. The epilogue, in registers: + b1, the GELU and its gradient (one
//     exponential for both, gelu_as.cuh), the hash mask drawn once for hd
//     and da (its scale a reciprocal with a remainder correction: the
//     division's bits without its slow path), the bf16 halves of hd and da
//     (planes of Sp = S rounded up to 64 rows, the product kernel's row
//     tiles; rows past S are never read into a result) staged through
//     shared memory and stored in whole 128-byte lines, and db1's f32 sums
//     of each warp's 16 rows (a fixed butterfly), summed over the row
//     partials in order after. The f32 hidden never reaches device
//     memory. A block an SM, persistent over the tiles, its ring running
//     ahead into the next tile while the epilogue runs;
//   - dW1 = xn^T (da_hi + da_lo) and dW2^T = g^T (hd_hi + hd_lo) on the
//     shared weight-gradient product (wg_dw.cuh: both operands MN-major as
//     they lie in memory, K = S in as many chunks as one wave of its blocks
//     takes, the partials summed in order after; dW2's sum is written
//     transposed, through a shared-memory tile);
//   - dxn = (da_hi + da_lo) W1^T on the shared product kernel
//     (conv_ln_wg.cuh: da's halves as two terms, W1 (C, H) the K-major B^T
//     as stored, persistent walkers over the 64-row tiles).
// * FMA route (f32, or bf16 with C or H not a multiple of 8): the products
//   as f32 FMAs on the CUDA cores (tile_ops.cuh's gemm) over the f32 act
//   and dact.

#include <cstdio>

#include "gelu_as.cuh"
#include "hash_dropout.cuh"
#include "wg_dw.cuh"

// Everything the backward needs; mirrored by _BwdArgs in
// vptr_tpu_torch/ops/fused_ffn.py. Inputs, outputs, then the
// caller-allocated scratch (vptr_fused_ffn_bwd_scratch gives the sizes):
// mean, rstd: S f32; xn: S x C in T; on the wgmma route hilo: 4 x Sp x H
// bf16 ([hd hi, hd lo, da hi, da lo]) and dbpart: p1_parts(S) x H f32, act
// and dact null; on the FMA route act, dact: S x H f32, hilo and dbpart
// null; dxn: Sp x C f32 (Sp = S on the FMA route); wpart1: ksplit x C x H
// f32; wpart2: ksplit x C x H f32 (the wgmma route's dW2^T) or ksplit x H x
// C (FMA); partial: parts x (H + 3 C) f32.
struct FfnBwdArgs {
  const void *x, *w1, *b1, *w2, *b2, *ls, *lb, *seed, *g;
  void *dx, *dw1, *db1, *dw2, *db2, *dls, *dlb;
  void *mean, *rstd, *xn, *act, *dact, *hilo, *dbpart, *dxn, *wpart1, *wpart2, *partial;
  int rows, channels, hidden, dtype, ksplit, parts;
  int mask_cols, col0;   // hidden columns col0 .. col0 + hidden - 1 of mask_cols (0, 0: all)
  float eps, rate, keep_div;
};

namespace {

bool wg_route(int C, int H, int dtype) { return dtype == 1 && C % 8 == 0 && H % 8 == 0; }

// Rows of the hidden's halves and of dxn on the wgmma route: whole 64-row
// tiles of the product kernel.
int pad_rows(int S) { return (S + kClnMaxRows - 1) / kClnMaxRows * kClnMaxRows; }

// K chunks of the weight-gradient products (wpart1/2). The wgmma route:
// one wave of the product's blocks (a block an SM: its shared memory), at
// most one a 64 rows; long chunks keep each block's ring streaming and
// leave few partials to sum (3 at the far_mnist step against 12 of 1024
// rows: 0.07 ms less, PERF.md). The FMA route: tile_ops.cuh's split.
int ksplits(int S, int C, int H, int dtype) {
  if (!wg_route(C, H, dtype)) return weight_splits(S);
  const int blocks = (C + 64 * kDwMw - 1) / (64 * kDwMw) * ((H + kWgN - 1) / kWgN);
  const int k = sm_count() / blocks, most = (S + kWgK - 1) / kWgK;
  return k < 1 ? 1 : (k > most ? most : k);
}

// The FMA route's hidden: act <- dropout(gelu(act)), dact <- dropout(dact)
// gelu'(act), element i = row * H + col (the forward's dropout index, by
// the global column).
__global__ void act_grad_kernel(float* __restrict__ act, float* __restrict__ dact, long n,
                                int H, vptr_dropout::Params drop) {
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const float a = act[i];
    float hd = vptr_gelu::gelu(a), dh = dact[i];
    if (drop.active()) {
      const bool kept = drop.keep(
          drop.col_index(static_cast<uint32_t>(i / H), H, static_cast<uint32_t>(i % H)), seed);
      hd = drop.apply(hd, kept);
      dh = drop.apply(dh, kept);
    }
    const float da = dh * vptr_gelu::gelu_grad(a);
    act[i] = hd;
    dact[i] = da;
  }
}

// out (H, C) in T = the transpose of the sum over the ksplit chunks of
// part[k] (C, H), in chunk order: 32 x 32 tiles through shared memory, so
// that both the reads and the writes go along rows.
template <typename T>
__global__ void __launch_bounds__(256)
split_sum_t_kernel(const float* __restrict__ part, T* __restrict__ out, int C, int H,
                   int ksplit) {
  __shared__ float tile[32][33];
  const int h0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const long n = static_cast<long>(C) * H;
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, h = h0 + tx;
    float acc = 0.f;
    if (c < C && h < H) {
      const float* p = part + static_cast<long>(c) * H + h;
      for (int k = 0; k < ksplit; ++k) acc += p[k * n];
    }
    tile[i][tx] = acc;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int h = h0 + i, c = c0 + tx;
    if (h < H && c < C) out[static_cast<long>(h) * C + c] = from_f32<T>(tile[tx][i]);
  }
}

float* f32p(void* p) { return static_cast<float*>(p); }
const float* cf32p(const void* p) { return static_cast<const float*>(p); }

// ---------------------------------------------------------------------------
// The wgmma route's pass 2: the hidden and its gradient (see the note at
// the top). A tile is 128 rows by 128 hidden columns; warpgroup w takes
// rows 64 (w % 2) .. + 63 by hidden columns 64 (w / 2) .. + 63 of both
// products, a = xn W1[:, tile] and dhd = g W2[tile, :]^T (m64n64k16: 32
// accumulators a thread each, 16 warps a block). K = C runs in steps
// of 64 through a ring of kP1Stages stages; a stage holds the step's boxes
// of xn and g (128 rows by 64 K, K-major, 128-byte swizzle), of w1 (two
// boxes of 64 hidden columns by 64 K rows: read MN-major as stored, the
// transpose flag set) and of w2 (128 hidden rows by 64 K: K-major as
// stored). No feeder warp: once every warp has released a stage, one
// warpgroup (the four in turn) refills it; the load cursor moves a step at
// a time with no division. Rows past S, K past C and hidden columns past H
// read zero.

constexpr int kP1Rows = 128;                    // rows a tile: two warpgroups of 64
constexpr int kP1Cols = 128;                    // hidden columns a tile: two of 64
constexpr int kP1Wgs = 4;
constexpr int kP1Threads = kP1Wgs * 128;
constexpr int kP1Stages = 3;
constexpr int kP1Box = 128 * kWgK * 2;          // 16 KB: 128 rows (or columns) by 64 K
constexpr int kP1Stage = 4 * kP1Box;            // xn, g, w1 (two boxes), w2
constexpr int kP1Out = 16 * 64 * 2;             // a warp's 16 x 64 bf16 of one half's plane

// The ring, the warps' store buffers and 1 KB to align: 230,400 of the
// 232,448 bytes a block may use.
long p1_smem() {
  return 1024L + static_cast<long>(kP1Stages) * kP1Stage + kP1Threads / 32 * kP1Out;
}

struct P1Bars {
  uint64_t full[kP1Stages], empty[kP1Stages];
};

// The tiles: RT row tiles by CT hidden-column tiles, tile rt CT + ct, K
// steps `steps` each; block b of the G in the grid takes tiles b, b + G,
// ..., and G is dr whole rows of tiles and dc tiles more.
struct P1Work {
  int RT, CT, steps, dr, dc;
  __device__ __forceinline__ void advance(int& rt, int& ct) const {
    int nc = ct + dc, nr = rt + dr;
    const bool carry = nc >= CT;
    ct = carry ? nc - CT : nc;
    rt = carry ? nr + 1 : nr;
  }
};

// The ring's next load: its stage, K step and tile. Advanced a step at a
// time, with selects and no division (the refill is on every step's
// critical path).
struct P1Cursor {
  int st, k, rt, ct;
  __device__ __forceinline__ void next(const P1Work& w) {
    st = st + 1 == kP1Stages ? 0 : st + 1;
    const bool wrap = k + 1 == w.steps;
    k = wrap ? 0 : k + 1;
    int nr = rt, nc = ct;
    w.advance(nr, nc);
    rt = wrap ? nr : rt;
    ct = wrap ? nc : ct;
  }
};

struct P1Maps {
  CUtensorMap x, g, w1, w2;
};

// Issues the cursor's boxes into its stage (the thread with on = true).
__device__ __forceinline__ void p1_load(const P1Maps& m, unsigned char* tiles, P1Bars& bars,
                                        const P1Cursor& c, bool on) {
  unsigned char* s = tiles + c.st * kP1Stage;
  uint64_t* bar = &bars.full[c.st];
  const int k = kWgK * c.k, r = kP1Rows * c.rt, h = kP1Cols * c.ct;
  mbar_expect_tx(bar, kP1Stage, on);
  tma_load_2d(s, &m.x, bar, k, r, on);
  tma_load_2d(s + kP1Box, &m.g, bar, k, r, on);
  tma_load_2d(s + 2 * kP1Box, &m.w1, bar, h, k, on);
  tma_load_2d(s + 2 * kP1Box + kP1Box / 2, &m.w1, bar, h + 64, k, on);
  tma_load_2d(s + 3 * kP1Box, &m.w2, bar, k, h, on);
}

__global__ void __launch_bounds__(kP1Threads, 1)
ffn_bwd_hidden_kernel(const __grid_constant__ P1Maps maps, const float* __restrict__ b1,
                      bf16* __restrict__ hilo, float* __restrict__ dbpart, P1Work work, int S,
                      int C, int H, long plane, vptr_dropout::Params drop) {
  extern __shared__ unsigned char smem_p1[];
  __shared__ P1Bars bars;
  unsigned char* tiles = align_1024(smem_p1);
  // the warp index broadcast from lane 0: the compiler then knows that the
  // roles are warp-uniform, and keeps the products asynchronous
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int wg = warp >> 2, q = warp & 3, rh = wg & 1, chalf = wg >> 1;
  const int G = gridDim.x, b = blockIdx.x, ntiles = work.RT * work.CT;
  const int mine = b < ntiles ? (ntiles - 1 - b) / G + 1 : 0;
  const int total = mine * work.steps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kP1Stages; ++s) {
      mbar_init(&bars.full[s], 1);
      mbar_init(&bars.empty[s], kP1Threads / 32);   // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  int rt = b / work.CT, ct = b - rt * work.CT;  // this block's first tile
  P1Cursor load = {0, 0, rt, ct};
  int loaded = 0;
  for (; loaded < kP1Stages && loaded < total; ++loaded) {
    p1_load(maps, tiles, bars, load, threadIdx.x == 0);
    load.next(work);
  }
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  const float rcp = 1.f / drop.keep_div;

  // The steps in the order they are consumed (as fused_ffn.cu's kernel):
  // wait_step waits for the next step's boxes; release frees the oldest
  // step's stage once its products are done and, once every warp has,
  // one warpgroup (the four in turn) refills it with the ring's next load.
  int cur_st = 0, cur_ph = 0;
  auto wait_step = [&]() {
    mbar_wait(&bars.full[cur_st], cur_ph);
    const unsigned char* s = tiles + cur_st * kP1Stage;
    cur_ph = cur_st + 1 == kP1Stages ? cur_ph ^ 1 : cur_ph;
    cur_st = cur_st + 1 == kP1Stages ? 0 : cur_st + 1;
    return s;
  };
  int free_st = 0, free_ph = 0, refiller = 0;
  auto release = [&]() {
    mbar_arrive(&bars.empty[free_st], lane == 0);
    if (loaded < total) {
      if (wg == refiller) {
        mbar_wait(&bars.empty[free_st], free_ph);
        p1_load(maps, tiles, bars, load, threadIdx.x == 128 * refiller);
      }
      load.next(work);
      ++loaded;
    }
    refiller = refiller + 1 == kP1Wgs ? 0 : refiller + 1;
    free_ph = free_st + 1 == kP1Stages ? free_ph ^ 1 : free_ph;
    free_st = free_st + 1 == kP1Stages ? 0 : free_st + 1;
  };

  float a[32], d[32];
  for (int i = 0; i < mine; ++i) {
#pragma unroll
    for (int e = 0; e < 32; ++e) a[e] = d[e] = 0.f;
    for (int k = 0; k < work.steps; ++k) {
      const unsigned char* s = wait_step();
      wg_fence_acc(a);
      wg_fence_acc(d);
      wg_fence();
#pragma unroll
      for (int qq = 0; qq < kWgK / 16; ++qq)       // the 16-deep slices inside C
        if (kWgK * k + 16 * qq < C) {
          wgmma_64<0, 1>(a, wg_desc(s + rh * (kP1Box / 2) + 32 * qq),
                         wg_desc_mn(s + (4 + chalf) * (kP1Box / 2) + 2048 * qq, kP1Box / 2));
          wgmma_64<0, 0>(d, wg_desc(s + kP1Box + rh * (kP1Box / 2) + 32 * qq),
                         wg_desc(s + (6 + chalf) * (kP1Box / 2) + 32 * qq));
        }
      wg_commit();
      wg_fence_acc(a);
      wg_fence_acc(d);
      if (k > 0) {                     // the previous step's products are done
        wg_wait<1>();
        release();
      }
    }
    wg_wait<0>();
    wg_fence_acc(a);
    wg_fence_acc(d);
    release();

    // + b1, the GELU and its gradient, the hash mask (drawn once for both):
    // a <- hd = dropout(h), d <- da = dropout(dhd) gelu'(a), zero past S or H
    const long r0 = static_cast<long>(rt) * kP1Rows + 64 * rh + 16 * q + (lane >> 2);
    const int cb = ct * kP1Cols + 64 * chalf + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cb + 8 * j;
      const bool cin = col < H;                   // H even: col + 1 < H too
      const float2 bb = *reinterpret_cast<const float2*>(b1 + (cin ? col : 0));
#pragma unroll
      for (int h = 0; h < 2; ++h) {               // rows r0 and r0 + 8
        const long row = r0 + 8 * h;
        const bool in = cin && row < S;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float gl, gr, dh = d[i];
          vptr_gelu::gelu_and_grad_fast(a[i] + (e ? bb.y : bb.x), gl, gr);
          if (drop.active()) {
            const bool kept =
                drop.keep(drop.col_index(static_cast<uint32_t>(row), H, col + e), seed);
            gl = drop.apply_rcp(gl, kept, rcp);
            dh = drop.apply_rcp(dh, kept, rcp);
          }
          a[i] = gl;
          d[i] = in ? dh * gr : 0.f;
        }
      }
    }
    // the bf16 halves [hd hi, hd lo, da hi, da lo], a plane at a time
    // through the warp's buffer (16 rows of 128 bytes, 16-byte chunk c of
    // row r at c ^ r % 8: no bank conflicts either way), then stored in
    // whole 128-byte lines, streaming (the weights and the next tiles' rows
    // stay in L2), for the rows below S
    unsigned char* ob = tiles + kP1Stages * kP1Stage + warp * kP1Out;
    const long orow = static_cast<long>(rt) * kP1Rows + 64 * rh + 16 * q;
    const int ocol = ct * kP1Cols + 64 * chalf;
#pragma unroll
    for (int pl = 0; pl < 4; ++pl) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (lane >> 2) + 8 * h, i = 4 * j + 2 * h;
          const float x0 = pl < 2 ? a[i] : d[i], x1 = pl < 2 ? a[i + 1] : d[i + 1];
          __nv_bfloat162 w = __floats2bfloat162_rn(x0, x1);
          if (pl & 1) {
            const float2 hf = __bfloat1622float2(w);
            w = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(ob + r * 128 + ((j ^ (r & 7)) << 4) +
                                             4 * (lane & 3)) = w;
        }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * i + (lane >> 3), c = lane & 7;
        const uint4 w = *reinterpret_cast<const uint4*>(ob + r * 128 + ((c ^ (r & 7)) << 4));
        if (orow + r < S && ocol + 8 * c < H)
          __stcs(reinterpret_cast<uint4*>(hilo + pl * plane + (orow + r) * H + ocol + 8 * c), w);
      }
      __syncwarp();                    // the buffer is read before the next plane
    }
    // db1's partial of the warp's 16 rows (a fixed butterfly over the rows'
    // lanes), row (tile 8 + 4 rh + q) of dbpart
    float* dp = dbpart + (static_cast<long>(rt) * 8 + 4 * rh + q) * H;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v0 = d[4 * j] + d[4 * j + 2], v1 = d[4 * j + 1] + d[4 * j + 3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, o);
        v1 += __shfl_xor_sync(0xffffffffu, v1, o);
      }
      const int col = cb + 8 * j;
      if (lane < 4 && col < H) *reinterpret_cast<float2*>(dp + col) = make_float2(v0, v1);
    }
    work.advance(rt, ct);
  }
}

// Row partials of db1 (dbpart: p1_parts(S) x H f32): 8 a 128-row tile.
int p1_parts(int S) { return (S + kP1Rows - 1) / kP1Rows * 8; }

// A bf16 tensor map of a row-major (rows, cols) matrix in boxes of 64
// columns by box_rows rows, 128-byte swizzled; outside reads zero.
int rows_map(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride = static_cast<cuuint64_t>(cols) * 2;
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return bf16_map(map, p, 2, dims, &stride, box);
}

// 2. the hidden on the wgmma route: hd's and da's halves and db1's row
// partials, a block an SM (its shared memory), at most one a tile.
int hidden_wg(const FfnBwdArgs& a, cudaStream_t s) {
  const int S = a.rows, C = a.channels, H = a.hidden, sms = sm_count();
  if (!sms) return cudaErrorInvalidConfiguration;
  P1Maps maps;
  int err = rows_map(&maps.x, a.xn, S, C, kP1Rows);
  if (!err) err = rows_map(&maps.g, a.g, S, C, kP1Rows);
  if (!err) err = rows_map(&maps.w1, a.w1, C, H, kWgK);
  if (!err) err = rows_map(&maps.w2, a.w2, H, C, kP1Cols);
  if (err) return err;
  P1Work w{};
  w.RT = (S + kP1Rows - 1) / kP1Rows, w.CT = (H + kP1Cols - 1) / kP1Cols;
  w.steps = (C + kWgK - 1) / kWgK;
  const int G = w.RT * w.CT < sms ? w.RT * w.CT : sms;
  w.dr = G / w.CT, w.dc = G % w.CT;
  const long smem = p1_smem();
  VPTR_TRY(cudaFuncSetAttribute(ffn_bwd_hidden_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem)));
  const vptr_dropout::Params drop{static_cast<const int*>(a.seed), a.rate, a.keep_div,
                                  a.mask_cols, a.col0};
  ffn_bwd_hidden_kernel<<<G, kP1Threads, smem, s>>>(
      maps, cf32p(a.b1), static_cast<bf16*>(a.hilo), f32p(a.dbpart), w, S, C, H,
      static_cast<long>(pad_rows(S)) * H, drop);
  return cudaGetLastError();
}

// 3. on the wgmma route: dW2^T = g^T hd and dW1 = xn^T da into their K
// chunks' partials, dxn = da W1^T.
int products_wg(const FfnBwdArgs& a, cudaStream_t s) {
  const int S = a.rows, C = a.channels, H = a.hidden, Sp = pad_rows(S);
  const bf16* hl = static_cast<const bf16*>(a.hilo);
  const long plane = static_cast<long>(Sp) * H;
  if (int err = launch_dw<2>(a.g, hl, hl + plane, f32p(a.wpart2), S, C, H, a.ksplit, s))
    return err;
  if (int err = launch_dw<2>(a.xn, hl + 2 * plane, hl + 3 * plane, f32p(a.wpart1), S, C, H,
                             a.ksplit, s))
    return err;
  CUtensorMap hmap, lmap, wmap;
  int err = wg_amap(&hmap, hl + 2 * plane, Sp / kClnMaxRows, kClnMaxRows, H, 1);
  if (!err) err = wg_amap(&lmap, hl + 3 * plane, Sp / kClnMaxRows, kClnMaxRows, H, 1);
  if (!err) err = wg_bmap(&wmap, a.w1, C, H);
  if (err) return err;
  // the depth rounded up to whole 16-deep slices: TMA reads zero past H
  const int depth = (H + 15) / 16 * 16;
  return wg_groups(C) == 1
             ? launch_product_walkers<1, 2>(hmap, lmap, wmap, f32p(a.dxn), Sp / kClnMaxRows,
                                            kClnMaxRows, depth, C, s)
             : launch_product_walkers<2, 2>(hmap, lmap, wmap, f32p(a.dxn), Sp / kClnMaxRows,
                                            kClnMaxRows, depth, C, s);
}

// 2.-3. on the FMA route: act = xn W1 + b1, dact = g W2^T, hd and da in
// place; dW2 = hd^T g (H x C) and dW1 = xn^T da (C x H) into their K
// chunks' partials, dxn = da W1^T.
template <typename T>
int products_fma(const FfnBwdArgs& a, cudaStream_t s) {
  const int S = a.rows, C = a.channels, H = a.hidden;
  GemmBatch gb{};
  gb.M = S, gb.N = H, gb.K = C, gb.lda = C, gb.ldb = H, gb.ldo = H, gb.group = 1;
  gb.ksplit = 1, gb.kchunk = C;
  gb.job[0] = {a.xn, a.w1, a.act, cf32p(a.b1), 1.f, nullptr, nullptr, 0};
  VPTR_TRY((gemm<T, false, T, false, float, kProj>(gb, 1, s)));
  gb.ldb = C;
  gb.job[0] = {a.g, a.w2, a.dact, nullptr, 1.f, nullptr, nullptr, 0};
  VPTR_TRY((gemm<T, false, T, true, float, kF32>(gb, 1, s)));
  const vptr_dropout::Params drop{static_cast<const int*>(a.seed), a.rate, a.keep_div,
                                  a.mask_cols, a.col0};
  const long n = static_cast<long>(S) * H;
  act_grad_kernel<<<1056, 256, 0, s>>>(f32p(a.act), f32p(a.dact), n, H, drop);
  VPTR_TRY(cudaGetLastError());
  gb = GemmBatch{};
  gb.M = H, gb.N = C, gb.K = S, gb.lda = H, gb.ldb = C, gb.ldo = C, gb.group = 1;
  gb.ksplit = a.ksplit, gb.kchunk = ((S + a.ksplit - 1) / a.ksplit + BK - 1) / BK * BK;
  gb.job[0] = {a.act, a.g, a.wpart2, nullptr, 1.f, nullptr, nullptr, 0};
  VPTR_TRY((gemm<float, true, T, false, float, kPartial>(gb, 1, s)));
  gb.M = C, gb.N = H, gb.lda = C, gb.ldb = H, gb.ldo = H;
  gb.job[0] = {a.xn, a.dact, a.wpart1, nullptr, 1.f, nullptr, nullptr, 0};
  VPTR_TRY((gemm<T, true, float, false, float, kPartial>(gb, 1, s)));
  gb.M = S, gb.N = C, gb.K = H, gb.lda = H, gb.ldb = H, gb.ldo = C;
  gb.ksplit = 1, gb.kchunk = H;
  gb.job[0] = {a.dact, a.w1, a.dxn, nullptr, 1.f, nullptr, nullptr, 0};
  return gemm<float, false, T, true, float, kF32>(gb, 1, s);
}

template <typename T>
int run(const FfnBwdArgs& a, cudaStream_t s) {
  const int S = a.rows, C = a.channels, H = a.hidden;
  const bool wg = wg_route(C, H, a.dtype);

  // 1. LayerNorm rows
  ln_rows_kernel<T><<<(S + 7) / 8, 256, 0, s>>>(
      static_cast<const T*>(a.x), cf32p(a.ls), cf32p(a.lb), nullptr, f32p(a.mean),
      f32p(a.rstd), static_cast<T*>(a.xn), nullptr, S, 1, C, a.eps);
  VPTR_TRY(cudaGetLastError());

  // 2.-3. the hidden and the products
  if (wg) {
    if (int err = hidden_wg(a, s)) return err;
    if (int err = products_wg(a, s)) return err;
  } else {
    if (int err = products_fma<T>(a, s)) return err;
  }
  SplitSum ss{};
  ss.part[0] = cf32p(a.wpart1), ss.out[0] = a.dw1;
  ss.part[1] = cf32p(a.wpart2), ss.out[1] = a.dw2;
  ss.ksplit = a.ksplit, ss.n = static_cast<long>(C) * H;
  split_sum_kernel<T><<<dim3(static_cast<unsigned>((ss.n + 255) / 256), wg ? 1 : 2), 256, 0,
                        s>>>(ss);
  VPTR_TRY(cudaGetLastError());
  if (wg) {
    split_sum_t_kernel<T><<<dim3((H + 31) / 32, (C + 31) / 32), 256, 0, s>>>(
        cf32p(a.wpart2), static_cast<T*>(a.dw2), C, H, a.ksplit);
    VPTR_TRY(cudaGetLastError());
  }

  // 4. dx
  ln_bwd_kernel<T><<<(S + 7) / 8, 256, 0, s>>>(cf32p(a.dxn), static_cast<const T*>(a.x),
                                               cf32p(a.mean), cf32p(a.rstd), cf32p(a.ls),
                                               nullptr, static_cast<T*>(a.dx), S, C, 0);
  VPTR_TRY(cudaGetLastError());

  // 5. db1 over the H-wide da (the wgmma route: over pass 2's row
  //    partials of the f32 da); db2, dlb, dls over the C-wide rows
  ColBatch hb{};
  hb.job[0] = {wg ? a.dbpart : a.dact, 0, nullptr, 0, f32p(a.db1)};
  hb.rows = wg ? p1_parts(S) : S, hb.C = H, hb.group = 1;
  hb.parts = partials(hb.rows), hb.partial = f32p(a.partial);
  colsum_partial_kernel<T><<<dim3((H + 127) / 128, hb.parts, 1), 128, 0, s>>>(hb);
  VPTR_TRY(cudaGetLastError());
  colsum_final_kernel<<<dim3((H + 127) / 128, 1), 128, 0, s>>>(hb);
  VPTR_TRY(cudaGetLastError());
  ColBatch cb{};
  cb.job[0] = {a.g, 1, nullptr, 0, f32p(a.db2)};
  cb.job[1] = {a.dxn, 0, nullptr, 0, f32p(a.dlb)};
  cb.job[2] = {a.dxn, 0, nullptr, 1, f32p(a.dls)};
  cb.x = a.x, cb.mean = cf32p(a.mean), cb.rstd = cf32p(a.rstd);
  cb.partial = f32p(a.partial) + static_cast<long>(a.parts) * H;
  cb.rows = S, cb.C = C, cb.group = 1, cb.parts = a.parts;
  colsum_partial_kernel<T><<<dim3((C + 127) / 128, a.parts, 3), 128, 0, s>>>(cb);
  VPTR_TRY(cudaGetLastError());
  colsum_final_kernel<<<dim3((C + 127) / 128, 3), 128, 0, s>>>(cb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vptr_error_string(int err) {
  if (err >= kTmaEncodeError) {
    static char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             err - kTmaEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 when (C, H, dtype) takes the wgmma route, 0 for the FMA route.
int vptr_fused_ffn_bwd_route(int C, int H, int dtype) { return wg_route(C, H, dtype) ? 1 : 0; }

// The scratch a call over (S, C, H, dtype) needs: sizes[0] the rows of
// hilo's planes and of dxn, sizes[1] the K chunks of the weight-gradient
// products (wpart1/2: ksplit x C x H f32), sizes[2] the column-sum partials
// (partial: parts x (H + 3 C) f32), sizes[3] the rows of db1's partials
// (dbpart: rows x H f32; 0 on the FMA route).
void vptr_fused_ffn_bwd_scratch(int S, int C, int H, int dtype, int* sizes) {
  const bool wg = wg_route(C, H, dtype);
  sizes[0] = wg ? pad_rows(S) : S;
  sizes[1] = ksplits(S, C, H, dtype);
  sizes[2] = partials(S);
  sizes[3] = wg ? p1_parts(S) : 0;
}

// The weight-gradient product alone: out = a^T (b0 + b1) over K = rows in
// f32, (M, Nc), or (Nc, M) when `transposed` (as dW1 and dW2 are written),
// in the K chunks the wgmma route takes; a (rows, M) and b0, b1 (rows, Nc)
// bf16, M and Nc multiples of 8; part: vptr_fused_ffn_bwd_scratch's
// sizes[1] (for rows, M, Nc, bf16) x M x Nc f32 of scratch.
int vptr_ffn_weight_product(const void* a, const void* b0, const void* b1, void* part, void* out,
                            int rows, int M, int Nc, int transposed, void* stream) {
  if (rows < 1 || M < 8 || M % 8 || Nc < 8 || Nc % 8) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ksplit = ksplits(rows, M, Nc, 1);
  if (int err = launch_dw<2>(a, b0, b1, f32p(part), rows, M, Nc, ksplit, s)) return err;
  if (transposed) {
    split_sum_t_kernel<float><<<dim3((Nc + 31) / 32, (M + 31) / 32), 256, 0, s>>>(
        cf32p(part), f32p(out), M, Nc, ksplit);
  } else {
    SplitSum ss{};
    ss.part[0] = cf32p(part), ss.out[0] = out;
    ss.ksplit = ksplit, ss.n = static_cast<long>(M) * Nc;
    split_sum_kernel<float><<<dim3(static_cast<unsigned>((ss.n + 255) / 256), 1), 256, 0, s>>>(
        ss);
  }
  return cudaGetLastError();
}

// Returns a cudaError_t (0 = every pass launched), or kTmaEncodeError + a
// CUresult.
int vptr_fused_ffn_bwd(const FfnBwdArgs* a, void* stream) {
  if (!a || a->rows < 1 || a->channels < 1 || a->hidden < 1 || a->dtype < 0 || a->dtype > 1 ||
      (a->rate > 0.f && !a->seed) || a->rate >= 1.f || a->col0 < 0 ||
      (a->mask_cols && a->col0 + a->hidden > a->mask_cols) ||
      a->ksplit != ksplits(a->rows, a->channels, a->hidden, a->dtype) ||
      a->parts != partials(a->rows) || !a->wpart1 || !a->wpart2 || !a->partial || !a->dxn ||
      (wg_route(a->channels, a->hidden, a->dtype) ? !a->hilo || !a->dbpart
                                                 : !a->act || !a->dact))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 0 ? run<float>(*a, s) : run<bf16>(*a, s);
}

}  // extern "C"
