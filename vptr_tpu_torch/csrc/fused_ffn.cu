// Fused LayerNorm + linear feed-forward sublayer forward on Hopper (sm_90a),
// over S rows of C channels with a hidden width H:
//     xn = LN(x) * ls + lb                   (f32 statistics, rounded to T)
//     h  = gelu(xn w1 + b1)                  (f32 sums; A&S erf, gelu_as.cuh)
//     hd = dropout(h)                        (hash of row * H + col)
//     y  = T(hd) w2 + b2                     (f32 sums, rounded to T once)
// x, w1 (C, H), w2 (H, C) in T (float or bf16); b1, b2, ls, lb f32.
// Under tensor parallelism a call holds hidden columns c0 .. c0 + H - 1 of
// Hg (w1's columns, w2's rows) and b2 = 0: y is the rank's partial sum,
// which the caller adds up over the ranks before b2; the dropout indexes
// row * Hg + c0 + col (hash_dropout.cuh's col_index), the whole call's mask.
//
// Replaces the TPU kernel vptr_tpu/ops/fused_ffn.py::_forward (_fwd_kernel
// at :77, pl.pallas_call at :188). The backward is fused_ffn_bwd.cu.
//
// What bounds it on an H100: operations. The two products are 4 S C H
// flops (57.1 GFLOP at S = 12,800, C = 528, H = 2112: 0.058 ms at 989
// TFLOP/s in bf16) against ~31.5 MB that the function must move (0.0094
// ms). The hidden never reaches device memory. What holds it back in
// practice is the weights' stream into each SM: a 64-row tile reads all of
// w1 and w2 (4.66 MB at far_mnist with w2's 576 columns, 932 MB a call at
// 200 tiles), and an SM's ring of TMA loads brings ~26 GB/s: a tile takes
// the same time whether 66 or 132 SMs run at once (PERF.md, #7's findings).
//
// * wgmma route (bf16, C and H multiples of 16, C <= 576 -- the far_mnist
//   path): a block of three warpgroups (384 threads, no feeder warp: a 13th
//   warp would cap ptxas at 128 registers) works on 64 rows, one wgmma M.
//   - Prologue of a tile: x's rows arrive by TMA in the K-major
//     128-byte-swizzled boxes of 64 columns that wgmma reads (rows past S
//     and columns past C read zero), and the LayerNorm runs in place, one
//     warp a row, two-pass f32 statistics, into bf16 xn.
//   - Then hidden chunks of 192 columns (11 at far_mnist). fc1: warpgroup w
//     computes the chunk's columns 64 w .. 64 w + 63 (wgmma m64n64k16, 32
//     f32 accumulators a thread), w1 read MN-major as it is stored (the
//     product's transpose flag). Its epilogue adds b1, applies the GELU
//     (gelu_fast: the A&S erf with its divisions on the special-function
//     unit) and the hash dropout, rounds to bf16 and stores the piece into
//     box w of the hidden chunk, 64 x 192 in shared memory, in the K-major
//     swizzled layout of fc2's A operand. fc2: warpgroup w adds
//     hidden_chunk w2[chunk, NY w .. NY w + NY - 1] into its y accumulators
//     (NY = 176 for C <= 528, m64n176k16, 88 registers a thread; else 192,
//     96), held across the chunks; w2 MN-major too. Two named barriers a
//     chunk: before the hidden is rewritten (every warpgroup's fc2 of the
//     last chunk is done) and after (the chunk is whole).
//   - The weights stream through one TMA ring of three 36 KB stages: for
//     fc1, three boxes of 64 hidden columns by 96 rows of w1 (one a
//     warpgroup); for fc2, nine boxes of 64 columns by 32 rows of w2 (three
//     a warpgroup). Once every warp has released a stage, one warpgroup
//     refills it, the three in turn; the load cursor advances a step at a
//     time with no division. The refill is on every step's critical path:
//     64-bit divisions there cost 0.044 ms a call, the first warpgroup
//     refilling every stage 0.008. The loads are PTX-predicated and the
//     roles warpgroup-uniform, so no divergent branch stands between the
//     products (C7520).
//   - The work is split evenly over the SMs (FfnWork): a block an SM, each
//     taking a contiguous run of (tile, chunk) units, so a call is 16.7
//     chunk-times long at 200 tiles on 132 SMs instead of two waves of 11.
//     A tile cut between two blocks has its two parts' f32 sums written to
//     scratch and added in a fixed order by ffn_join_kernel: the same bits
//     on every run.
//   - Epilogue: y + b2, rounded once, stored for the rows below S.
//   Shared memory: xn 73,728 B (nine boxes of 64 rows x 64 columns, C
//   padded to 576 by TMA's zero fill), the hidden chunk 24,576 B, the ring
//   3 x 36,864 = 110,592 B, 1,024 B to align: 209,920 of the 232,448 a
//   block may use, so one block an SM.
//   Measured and left out (scripts/torch_port_ffn_probe.py; PERF.md):
//   clusters of two blocks sharing each weight box by TMA multicast
//   (slower: the pair's stages are refilled in lock step), 16-deep steps
//   with 7 stages, a refill a step late, every block starting at another
//   chunk, 3D boxes of several 64-column blocks, the next tile's x loaded
//   during the last chunk.
// * FMA route (f32): one block of 256
//   threads takes 16 rows; per chunk of 256 hidden columns each thread
//   computes one hidden column for the 16 rows (f32 FMAs, the xn reads
//   broadcast from shared memory), then the threads add the chunk's fc2
//   terms into an f32 y tile in shared memory, one output column each.

#include <cstdio>

#include "gelu_as.cuh"
#include "hash_dropout.cuh"
#include "tile_ops.cuh"
#include "wgmma.cuh"

namespace {

constexpr long kSmemLimit = 232448;   // bytes a block may opt in to on sm_90

// ---------------------------------------------------------------------------
// wgmma route

constexpr int kFfnRows = 64;                    // rows a tile: one wgmma M
constexpr int kFfnWgs = 3;                      // consumer warpgroups
constexpr int kFfnThreads = kFfnWgs * 128;
constexpr int kMaxC = 576;                      // 9 boxes of 64 columns
constexpr int kHc = kFfnWgs * 64;               // hidden columns a chunk
constexpr int kDepth = 32;                      // w2 rows a fc2 step; w1 rows a fc1 step: 3x
constexpr int kQ1 = 3 * kDepth / 16;            // 16-deep slices a fc1 step
constexpr int kQ2 = kDepth / 16;                // and a fc2 step
constexpr int kSteps2 = kHc / kDepth;           // fc2 steps a chunk
constexpr int kXBox = 64 * 64 * 2;              // a K-major box: 64 rows x 64 K, bf16
constexpr int kBox1 = 64 * 3 * kDepth * 2;      // a w1 box: 64 hidden columns x 3 kDepth rows
constexpr int kBox2 = 64 * kDepth * 2;          // a w2 box: 64 columns x kDepth rows
constexpr int kStage = 3 * kBox1;               // = 9 kBox2
constexpr int kXBytes = kMaxC / 64 * kXBox;     // xn
constexpr int kHBytes = kHc / 64 * kXBox;       // the hidden chunk
// ring stages: what shared memory leaves (1 KB static, 1 KB to align), at most 8
constexpr int kStages = (kSmemLimit - 2048 - kXBytes - kHBytes) / kStage < 8
                            ? static_cast<int>((kSmemLimit - 2048 - kXBytes - kHBytes) / kStage)
                            : 8;

static_assert(kStage == 9 * kBox2, "a stage holds three w1 boxes or nine w2 boxes");
static_assert(kStages >= 2, "the ring runs a step ahead of the products");

long wg_ffn_smem() { return 1024L + kXBytes + kHBytes + static_cast<long>(kStages) * kStage; }

bool use_wg(int C, int H, int dtype) {
  return dtype == 1 && C % 16 == 0 && H % 16 == 0 && C <= kMaxC;
}

struct FfnBars {
  uint64_t full[kStages], empty[kStages], x;
};

// The work of a call: tiles of 64 rows, each nch hidden chunks of 192
// columns; a unit is one chunk of one tile, numbered tile-major. Block b
// of the G in the grid takes units [u0(b), u0(b + 1)): whole tiles when G
// is the tile count, else about units / G each, so the SMs finish together
// instead of in waves. A tile is then cut in at most two segments (G <=
// tiles: each block takes at least nch units): its head, chunks [0, c),
// at the end of block b - 1's range, and its tail at the start of block
// b's; each writes its f32 sums to partial slot (b, 0) or (b, 1), and
// ffn_join_kernel adds them.
struct FfnWork {
  int tiles, nch, G;
  __host__ __device__ int u0(int b) const {
    return static_cast<int>(static_cast<long>(b) * tiles * nch / G);
  }
};

// Where the ring's loads are: the next step's stage, and its place i in
// its unit's steps and its hidden chunk ch. Each unit takes n1 = ceil(C / 3
// kDepth) fc1 steps, then kSteps2 fc2 steps. Advanced a step at a time,
// with no division: the refill is on every step's critical path.
struct FfnCursor {
  int st, i, ch;
  __device__ __forceinline__ void next(int per, int nch) {
    st = st + 1 == kStages ? 0 : st + 1;
    const bool wrap = i + 1 == per;
    i = wrap ? 0 : i + 1;
    ch = wrap ? (ch + 1 == nch ? 0 : ch + 1) : ch;
  }
};

// Issues the boxes of the cursor's step into its stage (the threads with
// on = true; one a block): fc1 step i is w1 rows [3 kDepth i, + 3 kDepth)
// by the chunk's three 64-column blocks (box j for warpgroup j); fc2 step
// k = i - n1 is w2 rows [192 ch + kDepth k, + kDepth) by three 64-column
// blocks for each warpgroup w, from column NY w (box 3 w + j). Predicated,
// with no branch.
template <int NY>
__device__ __forceinline__ void ffn_load(const CUtensorMap* w1, const CUtensorMap* w2,
                                         unsigned char* tiles, FfnBars& bars, const FfnCursor& c,
                                         int n1, bool on) {
  const int st = c.st, i = c.i, ch = c.ch;
  const bool fc1 = i < n1;
  unsigned char* a = tiles + st * kStage;
  const int row = fc1 ? 3 * kDepth * i : kHc * ch + kDepth * (i - n1);
  mbar_expect_tx(&bars.full[st], kStage, on);
#pragma unroll
  for (int j = 0; j < 9; ++j)
    tma_load_2d(a + (fc1 ? kBox1 : kBox2) * j, fc1 ? w1 : w2, &bars.full[st],
                fc1 ? kHc * ch + 64 * j : NY * (j / 3) + 64 * (j % 3), row,
                on && (!fc1 || j < 3));
}

// a1 += xn[:, 3 kDepth k .. + 3 kDepth] b, b one w1 box in the ring (64
// hidden columns, MN-major); slices past C are left out.
__device__ __forceinline__ void fc1_step(float (&a1)[32], const unsigned char* xn,
                                         const unsigned char* b, int k, int C) {
#pragma unroll
  for (int q = 0; q < kQ1; ++q) {
    const int s = kQ1 * k + q;                   // the 16-deep slice of C
    if (16 * s < C)
      wgmma_64<0, 1>(a1, wg_desc(xn + (s >> 2) * kXBox + 32 * (s & 3)),
                     wg_desc_mn(b + 2048 * q, kBox1));
  }
}

// y += hidden[:, kDepth k .. + kDepth] b, b the warpgroup's three w2
// blocks in the ring (NY columns, MN-major, the next 64 columns kBox2 on).
template <int NY>
__device__ __forceinline__ void fc2_step(float (&y)[NY / 2], const unsigned char* hid,
                                         const unsigned char* b, int k) {
#pragma unroll
  for (int q = 0; q < kQ2; ++q) {
    const int s = kQ2 * k + q;
    if constexpr (NY == kWgN)
      wgmma_176<0, 1>(y, wg_desc(hid + (s >> 2) * kXBox + 32 * (s & 3)),
                      wg_desc_mn(b + 2048 * q, kBox2));
    else
      wgmma_192<0, 1>(y, wg_desc(hid + (s >> 2) * kXBox + 32 * (s & 3)),
                      wg_desc_mn(b + 2048 * q, kBox2));
  }
}

// The LayerNorm of the tile in place over xn's swizzled boxes, one warp a
// row: row r's 16-byte chunk c (8 columns) lies at box c / 8, chunk (c % 8)
// ^ (r % 8) of the box's row r.
__device__ __forceinline__ void ln_in_place(unsigned char* xn, const float* __restrict__ ls,
                                            const float* __restrict__ lb, int C, float eps,
                                            int warp, int lane) {
  const int nch = C / 8;
  for (int r = warp; r < kFfnRows; r += kFfnThreads / 32) {
    uint4 v[3];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int c = lane + 32 * i;
      if (c < nch) {
        v[i] = *reinterpret_cast<const uint4*>(xn + (c >> 3) * kXBox + r * 128 +
                                               (((c & 7) ^ (r & 7)) << 4));
        const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
        for (int t = 0; t < 8; ++t) s += __bfloat162float(e[t]);
      }
    }
    const float mean = warp_sum(s) / C;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (lane + 32 * i < nch) {
        const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float d = __bfloat162float(e[t]) - mean;
          ss = fmaf(d, d, ss);
        }
      }
    const float rstd = rsqrtf(warp_sum(ss) / C + eps);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int c = lane + 32 * i;
      if (c < nch) {
        const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
        const float4 s0 = *reinterpret_cast<const float4*>(ls + 8 * c);
        const float4 s1 = *reinterpret_cast<const float4*>(ls + 8 * c + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(lb + 8 * c);
        const float4 b1 = *reinterpret_cast<const float4*>(lb + 8 * c + 4);
        const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        uint4 o;
        __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          op[t] = __floats2bfloat162_rn(
              (__bfloat162float(e[2 * t]) - mean) * rstd * sc[2 * t] + bs[2 * t],
              (__bfloat162float(e[2 * t + 1]) - mean) * rstd * sc[2 * t + 1] + bs[2 * t + 1]);
        *reinterpret_cast<uint4*>(xn + (c >> 3) * kXBox + r * 128 + (((c & 7) ^ (r & 7)) << 4)) =
            o;
      }
    }
  }
}

template <int NY>
__global__ void __launch_bounds__(kFfnThreads, 1)
ffn_wg_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
              const __grid_constant__ CUtensorMap w2map, const float* __restrict__ b1,
              const float* __restrict__ b2, const float* __restrict__ ls,
              const float* __restrict__ lb, bf16* __restrict__ out, float* __restrict__ part,
              FfnWork work, int S, int C, int H, float eps,
              vptr_dropout::Params drop) {
  extern __shared__ unsigned char smem_ffn[];
  __shared__ FfnBars bars;
  unsigned char* xn = smem_ffn + ((1024 - (smem_u32(smem_ffn) & 1023)) & 1023);
  unsigned char* hid = xn + kXBytes;
  unsigned char* tiles = hid + kHBytes;
  const int n1 = (C + 3 * kDepth - 1) / (3 * kDepth), nch = work.nch;
  const int b = blockIdx.x;
  const int unit0 = work.u0(b), unit1 = work.u0(b + 1);
  const int total = (unit1 - unit0) * (n1 + kSteps2);
  // the warp index broadcast from lane 0: the compiler then knows that the
  // roles are warp-uniform, and keeps the products asynchronous
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int wg = warp >> 2, q = warp & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars.full[s], 1);
      mbar_init(&bars.empty[s], 4 * kFfnWgs);   // one arrival a warp
    }
    mbar_init(&bars.x, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int per = n1 + kSteps2;
  FfnCursor load = {0, 0, unit0 % nch};        // the ring's next load
  int loaded = 0;
  for (; loaded < kStages && loaded < total; ++loaded) {
    ffn_load<NY>(&w1map, &w2map, tiles, bars, load, n1, threadIdx.x == 0);
    load.next(per, nch);
  }
  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;

  // The ring's steps in the order they are consumed: wait_step waits for
  // the next step's boxes (stage cur_st, phase cur_ph); release frees the
  // oldest step's stage once its products are done: lane 0 of each warp
  // arrives on the stage's empty barrier, then one warpgroup (the three in
  // turn, so that each waits at every third step only) waits until every
  // warp has and its thread 0 refills the stage with the ring's next load.
  // Every warpgroup advances the load cursor.
  int cur_st = 0, cur_ph = 0;
  auto wait_step = [&]() {
    mbar_wait(&bars.full[cur_st], cur_ph);
    const unsigned char* a = tiles + cur_st * kStage;
    cur_ph = cur_st + 1 == kStages ? cur_ph ^ 1 : cur_ph;
    cur_st = cur_st + 1 == kStages ? 0 : cur_st + 1;
    return a;
  };
  int free_st = 0, free_ph = 0, refiller = 0;  // the stage release frees next
  auto release = [&]() {
    mbar_arrive(&bars.empty[free_st], lane == 0);
    if (loaded < total) {
      if (wg == refiller) {
        mbar_wait(&bars.empty[free_st], free_ph);
        ffn_load<NY>(&w1map, &w2map, tiles, bars, load, n1, threadIdx.x == 128 * refiller);
      }
      load.next(per, nch);
      ++loaded;
    }
    refiller = refiller + 1 == kFfnWgs ? 0 : refiller + 1;
    free_ph = free_st + 1 == kStages ? free_ph ^ 1 : free_ph;
    free_st = free_st + 1 == kStages ? 0 : free_st + 1;
  };

  const int r0 = 16 * q + (lane >> 2);         // this thread's rows r0 and r0 + 8
  float y[NY / 2], a1[32];
  for (int u = unit0, seg = 0; u < unit1; ++seg) {
    // a segment: chunks [c0, c1) of one tile
    const int tile = u / nch, c0 = u % nch, c1 = min(nch, c0 + unit1 - u);
    const long row0 = static_cast<long>(tile) * kFfnRows;
    u += c1 - c0;
    // x's rows by TMA into xn's boxes (K-major, 128-byte swizzle; rows past
    // S and columns past C read zero), then the LayerNorm in place
    __syncthreads();                   // the last segment's products are done with xn
    if (threadIdx.x == 0) {
      const int nbx = (C + 63) / 64;
      mbar_expect_tx(&bars.x, nbx * kXBox, true);
      for (int i = 0; i < nbx; ++i)
        tma_load_2d(xn + i * kXBox, &xmap, &bars.x, 64 * i, static_cast<int>(row0), true);
    }
    mbar_wait(&bars.x, seg & 1);
    ln_in_place(xn, ls, lb, C, eps, warp, lane);
    fence_proxy_async();               // xn's generic writes, before wgmma reads them
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NY / 2; ++i) y[i] = 0.f;
    for (int ch = c0; ch < c1; ++ch) {
      const int h0 = ch * kHc;
      // fc1: the chunk's columns 64 wg .. 64 wg + 63
#pragma unroll
      for (int i = 0; i < 32; ++i) a1[i] = 0.f;
      for (int k = 0; k < n1; ++k) {
        const unsigned char* a = wait_step();
        wg_fence_acc(a1);
        wg_fence();
        fc1_step(a1, xn, a + wg * kBox1, k, C);
        wg_commit();
        wg_fence_acc(a1);
        if (k > 0) {                   // the previous step's products are done
          wg_wait<1>();
          release();
        }
      }
      wg_wait<0>();
      wg_fence_acc(a1);
      release();
      bar_sync(1, kFfnThreads);        // every warpgroup's fc2 of the last chunk is done
      // + b1, GELU, dropout, bf16 into box wg of the hidden chunk (K-major,
      // swizzled: row r's 16-byte chunk j at (j ^ r % 8))
      {
        unsigned char* hrow = hid + wg * kXBox + r0 * 128 + 4 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = h0 + 64 * wg + 8 * j + 2 * (lane & 3);
          const float2 bb = *reinterpret_cast<const float2*>(b1 + min(col, H - 2));
#pragma unroll
          for (int h = 0; h < 2; ++h) {                  // rows r0 and r0 + 8
            float v0 = vptr_gelu::gelu_fast(a1[4 * j + 2 * h] + bb.x);
            float v1 = vptr_gelu::gelu_fast(a1[4 * j + 2 * h + 1] + bb.y);
            if (drop.active()) {
              const uint32_t e = drop.col_index(static_cast<uint32_t>(row0 + r0 + 8 * h), H, col);
              v0 = drop.apply(v0, drop.keep(e, seed));
              v1 = drop.apply(v1, drop.keep(e + 1, seed));
            }
            const bool in = col < H;                    // columns past H are zero
            *reinterpret_cast<__nv_bfloat162*>(hrow + 8 * h * 128 + ((j ^ (r0 & 7)) << 4)) =
                __floats2bfloat162_rn(in ? v0 : 0.f, in ? v1 : 0.f);
          }
        }
      }
      fence_proxy_async();             // the hidden's generic writes, before wgmma reads them
      bar_sync(1, kFfnThreads);        // the chunk is whole
      // fc2: y += hidden_chunk w2[chunk, NY wg .. NY wg + NY - 1]
      for (int k = 0; k < kSteps2; ++k) {
        const unsigned char* a = wait_step();
        wg_fence_acc(y);
        wg_fence();
        fc2_step<NY>(y, hid, a + 3 * wg * kBox2, k);
        wg_commit();
        wg_fence_acc(y);
        if (k > 0) {
          wg_wait<1>();
          release();
        }
      }
      wg_wait<0>();
      wg_fence_acc(y);
      release();
    }
    // a whole tile: y + b2, rounded once, for the rows below S; a head or a
    // tail: the f32 sums into its partial slot
    const bool whole = c0 == 0 && c1 == nch;
    float* pp = part + ((static_cast<long>(c0 == 0 ? b + 1 : b) * 2 + (c0 == 0 ? 0 : 1)) *
                        kFfnRows) * C;
#pragma unroll
    for (int j = 0; j < NY / 8; ++j) {
      const int col = NY * wg + 8 * j + 2 * (lane & 3);
      if (col < C) {
        const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const float v0 = y[4 * j + 2 * h], v1 = y[4 * j + 2 * h + 1];
          if (!whole)
            *reinterpret_cast<float2*>(pp + static_cast<long>(r) * C + col) = make_float2(v0, v1);
          else if (row0 + r < S)
            *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r) * C + col) =
                __floats2bfloat162_rn(v0 + bb.x, v1 + bb.y);
        }
      }
    }
  }
}

// The tiles cut in two segments: out = head + tail + b2, rounded once
// (the boundary b's tile, if block b's range starts inside a tile).
__global__ void __launch_bounds__(256)
ffn_join_kernel(const float* __restrict__ part, const float* __restrict__ b2,
                bf16* __restrict__ out, FfnWork work, int S, int C) {
  const int b = blockIdx.x + 1;
  const int u = work.u0(b);
  if (u % work.nch == 0) return;
  const long row0 = static_cast<long>(u / work.nch) * kFfnRows;
  const float* head = part + static_cast<long>(b) * 2 * kFfnRows * C;
  const float* tail = head + static_cast<long>(kFfnRows) * C;
  const int n = static_cast<int>(min(static_cast<long>(kFfnRows), S - row0)) * C / 2;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float2 h = reinterpret_cast<const float2*>(head)[e];
    const float2 t = reinterpret_cast<const float2*>(tail)[e];
    const float2 bb = reinterpret_cast<const float2*>(b2)[(2 * e) % C / 2];
    reinterpret_cast<__nv_bfloat162*>(out + row0 * C)[e] =
        __floats2bfloat162_rn(h.x + t.x + bb.x, h.y + t.y + bb.y);
  }
}

// The bare fc1 product: out (64, N) f32 = a (64, K) b (K, N), b read
// MN-major as w1 is (N contiguous): one warpgroup a block of 64 columns,
// a's boxes loaded once, b's one step at a time, fc1_step's wgmma.
__global__ void __launch_bounds__(128, 1)
ffn_fc1_product_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap, float* __restrict__ out, int K,
                       int N) {
  extern __shared__ unsigned char smem_ffn[];
  __shared__ uint64_t bar;
  unsigned char* a = smem_ffn + ((1024 - (smem_u32(smem_ffn) & 1023)) & 1023);
  unsigned char* b = a + kXBytes;
  const int lane = threadIdx.x & 31, warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int n0 = blockIdx.x * 64, steps = (K + 3 * kDepth - 1) / (3 * kDepth);
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int nbx = (K + 63) / 64;
  mbar_expect_tx(&bar, nbx * kXBox, threadIdx.x == 0);
  for (int i = 0; i < nbx; ++i) tma_load_2d(a + i * kXBox, &amap, &bar, 64 * i, 0, threadIdx.x == 0);
  mbar_wait(&bar, 0);
  __syncthreads();                     // every thread saw phase 0 before thread 0 starts phase 1
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int k = 0; k < steps; ++k) {
    mbar_expect_tx(&bar, kBox1, threadIdx.x == 0);
    tma_load_2d(b, &bmap, &bar, n0, 3 * kDepth * k, threadIdx.x == 0);
    mbar_wait(&bar, (k + 1) & 1);
    wg_fence_acc(acc);
    wg_fence();
    fc1_step(acc, a, b, k, K);
    wg_commit();
    wg_wait<0>();
    wg_fence_acc(acc);
    __syncthreads();                   // b is free for the next step
  }
  const int r = 16 * warp + (lane >> 2), cb = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (cb + 8 * j < N)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + static_cast<long>(r + 8 * h) * N + cb + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// A bf16 tensor map of a row-major (rows, cols) matrix in boxes of 64
// columns by `box_rows` rows, 128-byte swizzled; outside reads zero.
int ffn_map(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  const cuuint64_t d[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t st = static_cast<cuuint64_t>(cols) * 2;
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return bf16_map(map, p, 2, d, &st, box);
}

// The split of a call's work over the card: as many blocks as the card has
// SMs (one block an SM: its shared memory), at most one a tile; G = 0 when
// the SM count cannot be read.
FfnWork ffn_work(int S, int H) {
  static int sms = 0;                            // asked once
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  const int tiles = (S + kFfnRows - 1) / kFfnRows;
  return {tiles, (H + kHc - 1) / kHc, tiles < sms ? tiles : sms};
}

// f32 elements of the partial slots a call needs (0 when every tile is whole).
long ffn_partials(const FfnWork& w, int C) {
  return w.G < w.tiles ? static_cast<long>(w.G) * 2 * kFfnRows * C : 0;
}

template <int NY>
int launch_wg(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
              const void* ls, const void* lb, void* out, void* part, int S, int C, int H,
              float eps, vptr_dropout::Params drop, cudaStream_t s) {
  const FfnWork work = ffn_work(S, H);
  if (!work.G || (ffn_partials(work, C) && !part)) return cudaErrorInvalidValue;
  CUtensorMap xmap, w1map, w2map;
  int err = ffn_map(&xmap, x, S, C, kFfnRows);
  if (!err) err = ffn_map(&w1map, w1, C, H, 3 * kDepth);
  if (!err) err = ffn_map(&w2map, w2, H, C, kDepth);
  if (err) return err;
  const long smem = wg_ffn_smem();
  cudaError_t e = cudaFuncSetAttribute(ffn_wg_kernel<NY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  ffn_wg_kernel<NY><<<work.G, kFfnThreads, smem, s>>>(
      xmap, w1map, w2map, static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<const float*>(ls), static_cast<const float*>(lb), static_cast<bf16*>(out),
      static_cast<float*>(part), work, S, C, H, eps, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess || !ffn_partials(work, C) || work.G < 2) return e;
  ffn_join_kernel<<<work.G - 1, 256, 0, s>>>(static_cast<const float*>(part),
                                             static_cast<const float*>(b2),
                                             static_cast<bf16*>(out), work, S, C);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// FMA route

constexpr int kFmaRows = 16;
constexpr int kFmaThreads = 256;
constexpr int kFmaHc = 256;           // hidden columns per chunk: one a thread

long fma_smem(int C) {
  return static_cast<long>(sizeof(float)) * (2L * kFmaRows * C + kFmaRows * kFmaHc);
}

template <typename T>
__global__ void __launch_bounds__(kFmaThreads)
ffn_fma_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
               const T* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ ls, const float* __restrict__ lb, T* __restrict__ out,
               int S, int C, int H, float eps, vptr_dropout::Params drop) {
  extern __shared__ float smem_fma[];
  float* xn = smem_fma;                // [16][C] LN(x) * ls + lb, rounded to T
  float* yb = xn + kFmaRows * C;       // [16][C] fc2 sums
  float* hb = yb + kFmaRows * C;       // [16][256] the chunk's hidden, rounded to T
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row0 = static_cast<long>(blockIdx.x) * kFmaRows;
  const int rows = S - row0 < kFmaRows ? static_cast<int>(S - row0) : kFmaRows;

  for (int r = warp; r < kFmaRows; r += kFmaThreads / 32) {
    float* dst = xn + r * C;
    if (r < rows) {
      const T* xr = x + (row0 + r) * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
      const float mean = warp_sum(s) / C;
      float ss = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f32(xr[c]) - mean;
        ss = fmaf(d, d, ss);
      }
      const float rstd = rsqrtf(warp_sum(ss) / C + eps);
      for (int c = lane; c < C; c += 32)
        dst[c] = round_t<T>((to_f32(xr[c]) - mean) * rstd * ls[c] + lb[c]);
    } else {
      for (int c = lane; c < C; c += 32) dst[c] = 0.f;
    }
  }
  for (int i = threadIdx.x; i < kFmaRows * C; i += kFmaThreads) yb[i] = 0.f;
  __syncthreads();

  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;
  for (int h0 = 0; h0 < H; h0 += kFmaHc) {
    const int hw = H - h0 < kFmaHc ? H - h0 : kFmaHc;
    const int j = threadIdx.x;
    if (j < hw) {
      const int col = h0 + j;
      float acc[kFmaRows];
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) acc[r] = 0.f;
      for (int k = 0; k < C; ++k) {
        const float w = to_f32(w1[static_cast<long>(k) * H + col]);
#pragma unroll
        for (int r = 0; r < kFmaRows; ++r) acc[r] = fmaf(xn[r * C + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        float v = vptr_gelu::gelu(acc[r] + b1[col]);
        if (drop.active())
          v = drop.apply(
              v, drop.keep(drop.col_index(static_cast<uint32_t>(row0 + r), H, col), seed));
        hb[r * kFmaHc + j] = round_t<T>(v);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kFmaThreads) {
      float acc[kFmaRows];
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) acc[r] = yb[r * C + c];
      for (int k = 0; k < hw; ++k) {
        const float w = to_f32(w2[static_cast<long>(h0 + k) * C + c]);
#pragma unroll
        for (int r = 0; r < kFmaRows; ++r) acc[r] = fmaf(hb[r * kFmaHc + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) yb[r * C + c] = acc[r];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows * C; i += kFmaThreads) {
    const int r = i / C, c = i - r * C;
    out[(row0 + r) * C + c] = from_f32<T>(yb[i] + b2[c]);
  }
}

long ffn_smem(int C, int H, int dtype) { return use_wg(C, H, dtype) ? wg_ffn_smem() : fma_smem(C); }

template <typename K>
cudaError_t set_smem(K kernel, long smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_fma(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* ls, const void* lb, void* out, int S, int C, int H, float eps,
               vptr_dropout::Params drop, cudaStream_t s) {
  const long smem = fma_smem(C);
  cudaError_t err = set_smem(ffn_fma_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ffn_fma_kernel<T><<<(S + kFmaRows - 1) / kFmaRows, kFmaThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<const float*>(ls),
      static_cast<const float*>(lb), static_cast<T*>(out), S, C, H, eps, drop);
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

// Dynamic shared memory of the route (C, H, dtype) takes, in bytes; more
// than 232448 means the shape is not supported.
long vptr_fused_ffn_smem(int C, int H, int dtype) { return ffn_smem(C, H, dtype); }

// 1 when (C, H, dtype) takes the wgmma route, 0 for the FMA route.
int vptr_fused_ffn_route(int C, int H, int dtype) { return use_wg(C, H, dtype) ? 1 : 0; }

// f32 elements of the scratch `part` that vptr_fused_ffn needs for (S, C,
// H, dtype) on this card (0: none; -1: the card cannot be asked).
long vptr_fused_ffn_partials(int S, int C, int H, int dtype) {
  if (!use_wg(C, H, dtype)) return 0;
  const FfnWork w = ffn_work(S, H);
  return w.G ? ffn_partials(w, C) : -1;
}

// dtype: 0 = float32, 1 = bfloat16. seed (device int32) may be null when
// rate == 0; keep_div = (float)(1 - rate); mask_cols, col0: the H hidden
// columns are columns col0 .. col0 + H - 1 of mask_cols (tensor
// parallelism: the dropout indexes row * mask_cols + col0 + col; 0, 0: the
// call's own). part: vptr_fused_ffn_partials f32 elements of scratch (null
// when that is 0). Returns a cudaError_t (0 = launched), or
// kTmaEncodeError + a CUresult.
int vptr_fused_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* ls, const void* lb, void* out, void* part, int S,
                   int C, int H, float eps, const void* seed, float rate, float keep_div,
                   int mask_cols, int col0, int dtype, void* stream) {
  const vptr_dropout::Params drop{static_cast<const int*>(seed), rate, keep_div, mask_cols,
                                  col0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || C < 1 || H < 1 || dtype < 0 || dtype > 1 || ffn_smem(C, H, dtype) > kSmemLimit ||
      (rate > 0.f && !seed) || rate >= 1.f || col0 < 0 || (mask_cols && col0 + H > mask_cols))
    return cudaErrorInvalidValue;
  if (use_wg(C, H, dtype))
    return C <= 3 * kWgN   // y columns a warpgroup: 176 (88 registers) or 192 (96)
               ? launch_wg<kWgN>(x, w1, b1, w2, b2, ls, lb, out, part, S, C, H, eps, drop, s)
               : launch_wg<192>(x, w1, b1, w2, b2, ls, lb, out, part, S, C, H, eps, drop, s);
  return dtype == 0 ? launch_fma<float>(x, w1, b1, w2, b2, ls, lb, out, S, C, H, eps, drop, s)
                    : launch_fma<bf16>(x, w1, b1, w2, b2, ls, lb, out, S, C, H, eps, drop, s);
}

// The bare fc1 product: out (64, N) f32 = a (64, K) b (K, N), a and b bf16
// row-major; K and N multiples of 16, K <= 576.
int vptr_ffn_fc1_product(const void* a, const void* b, void* out, int K, int N, void* stream) {
  if (K < 16 || K % 16 || K > kMaxC || N < 16 || N % 16) return cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  int err = ffn_map(&amap, a, kFfnRows, K, kFfnRows);
  if (!err) err = ffn_map(&bmap, b, K, N, 3 * kDepth);
  if (err) return err;
  const long smem = 1024L + kXBytes + kBox1;
  cudaError_t e = set_smem(ffn_fc1_product_kernel, smem);
  if (e != cudaSuccess) return e;
  ffn_fc1_product_kernel<<<(N + 63) / 64, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      amap, bmap, static_cast<float*>(out), K, N);
  return cudaGetLastError();
}

}  // extern "C"
