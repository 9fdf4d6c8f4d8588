// Hopper (sm_90a) building blocks for products on the warpgroup MMA
// (wgmma.mma_async), fed by the Tensor Memory Accelerator (TMA), in inline
// PTX: shared-memory matrix descriptors, the m64n176k16 bf16 product (and
// m64n64k16, m64n192k16) with f32 accumulators in registers, its fences,
// mbarriers, TMA tile loads and the host-side tensor maps
// (cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so nothing links against libcuda).
//
// Layout: operands K-major (K contiguous), as TMA writes a box of 64
// bf16 along K (one 128-byte row) by R rows with the 128-byte swizzle: rows
// of 128 bytes, 8-row atoms of 1024 bytes, the 16-byte chunks of row r
// XOR-ed with r % 8. A tile starts on a 1024-byte boundary; the descriptor
// of its k-th 16-deep slice starts 32 k bytes in (the swizzle is applied to
// the address bits, so the slices of one atom need no other change). Or
// MN-major, the product's transpose flags set (wg_desc_mn).
//
// The accumulator of a 64 x N product (N / 2 floats a thread): warp q of the
// warpgroup holds rows 16 q + lane / 4 and 16 q + lane / 4 + 8; register
// 4 j + {0, 1} holds the first row's columns 8 j + 2 (lane % 4) + {0, 1},
// 4 j + {2, 3} the second row's.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWgN = 176;             // columns of a warpgroup's product
constexpr int kWgAcc = kWgN / 2;      // its f32 accumulators a thread
constexpr int kWgK = 64;              // K of a TMA box (one 128-byte swizzle row)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA) and the cluster.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The operations below that take `on` are predicated in PTX: a thread with
// on = false skips them without a branch, so code around warpgroup MMAs
// stays free of divergent paths (which would make the compiler serialise
// the products).

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}" ::"r"(smem_u32(bar)),
      "r"(static_cast<int>(on))
      : "memory");
}

// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}" ::"r"(smem_u32(bar)),
      "r"(bytes), "r"(static_cast<int>(on))
      : "memory");
}

// Waits until the phase of parity `parity` has completed. The loop is in
// PTX, so the compiler sees no divergence around the products that follow;
// a wait that never ends (a lost arrival or transaction) traps after 2^26
// tries, so the launch fails with an error instead of holding the card.
#define VPTR_MBAR_WAIT(SEM)                                                              \
  asm volatile(                                                                           \
      "{\n .reg .pred p;\n .reg .u32 n;\n mov.u32 n, 0;\n"                                 \
      "LAB_WAIT:\n"                                                                        \
      " mbarrier.try_wait.parity" SEM ".shared::cta.b64 p, [%0], %1;\n"                     \
      " @p bra.uni DONE;\n"                                                                \
      " add.u32 n, n, 1;\n"                                                                \
      " setp.lt.u32 p, n, 67108864;\n"                                                     \
      " @p bra.uni LAB_WAIT;\n"                                                            \
      " trap;\n"                                                                           \
      "DONE:\n}" ::"r"(smem_u32(bar)),                                                     \
      "r"(parity)                                                                         \
      : "memory")

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  VPTR_MBAR_WAIT("");
}

// The same, acquiring what the cluster's other blocks released with their
// arrivals (mbar_arrive_remote).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  VPTR_MBAR_WAIT(".acquire.cluster");
}

#undef VPTR_MBAR_WAIT

// ---- distributed shared memory: the cluster's blocks

// The shared::cluster address of `p`'s counterpart in the cluster's block `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

// Arrives on a barrier of another block (a cluster address), releasing this
// thread's earlier writes to it.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(addr)
               : "memory");
}

// ---- TMA tile loads into shared memory, completing on an mbarrier

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " @p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n}" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(static_cast<int>(on))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " @p cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n}" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(static_cast<int>(on))
      : "memory");
}

// Synchronises the first `threads` threads of the block (a multiple of 32)
// on named barrier `id` (1-15; __syncthreads is 0).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma

// Descriptor of a K-major tile with the 128-byte swizzle at `tile` (1024-byte
// aligned): leading offset 1 (unused for this layout), 8-row atoms 1024 bytes
// apart, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t wg_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// Descriptor of an MN-major tile with the 128-byte swizzle (the transposed
// operand: M or N contiguous), as TMA writes boxes of 64 bf16 along MN by 64
// rows along K: each row of 128 bytes holds 64 consecutive M (N) values of
// one k, 8-row atoms of 1024 bytes follow along K (the stride offset), and
// the next 64 M (N) values are `mn_stride` bytes on (the leading offset:
// the next box). The k-th 16-deep slice starts 16 rows, 2048 k bytes, in.
__device__ __forceinline__ uint64_t wg_desc_mn(const void* tile, uint32_t mn_stride) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(mn_stride >> 4) << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void wg_fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Orders this thread's generic-proxy writes to shared memory (st.shared)
// before later reads of the async proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

#define VPTR_WG8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 176, f32) += A (64 x 16) B (16 x 176), both bf16 in shared memory
// (descriptors a, b), K-major, or MN-major where TA (A) or TB (B) is 1.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_176(float (&d)[kWgAcc], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %90, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87"
      "}, %88, %89, p, 1, 1, %91, %92;\n}"
      : VPTR_WG8(0), VPTR_WG8(8), VPTR_WG8(16), VPTR_WG8(24), VPTR_WG8(32), VPTR_WG8(40),
        VPTR_WG8(48), VPTR_WG8(56), VPTR_WG8(64), VPTR_WG8(72), VPTR_WG8(80)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// The same products at N = 64 (32 accumulators a thread: the fused FFN's
// fc1 piece) and N = 192 (96: its fc2 column group).
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}"
      : VPTR_WG8(0), VPTR_WG8(8), VPTR_WG8(16), VPTR_WG8(24)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_192(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}"
      : VPTR_WG8(0), VPTR_WG8(8), VPTR_WG8(16), VPTR_WG8(24), VPTR_WG8(32), VPTR_WG8(40),
        VPTR_WG8(48), VPTR_WG8(56), VPTR_WG8(64), VPTR_WG8(72), VPTR_WG8(80), VPTR_WG8(88)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

#undef VPTR_WG8

// ---- host: tensor maps

constexpr int kTmaEncodeError = 100000;   // + CUresult: cuTensorMapEncodeTiled failed

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first) with the 128-byte
// swizzle; elements outside the tensor read as zero. Returns 0 or
// kTmaEncodeError + the CUresult.
int bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
             const cuuint64_t* strides_bytes, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return kTmaEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                        dims, strides_bytes, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaEncodeError + static_cast<int>(r);
}

}  // namespace
