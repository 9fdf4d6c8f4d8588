// A fixed-order sum over a thread-block cluster (sm_90a), shared by the
// kernels that split one sample over a cluster and need sample-wide
// statistics: the dw chain (dw_chain.cuh, #9/#10) and the conv LayerNorm
// (conv_ln.cuh, #11/#12). Each block's partial sum goes to its shared
// memory, the cluster synchronises, and every block adds the partial sums
// of all blocks through distributed shared memory in rank order, so every
// block holds the same value and the result is the same bits on every run.
#pragma once

#include <cooperative_groups.h>

#include "tile_ops.cuh"

namespace {

namespace cg = cooperative_groups;

// Reduction scratch in static shared memory: per-warp sums (a block of
// exactly Warps warps: a compile-time count keeps the kernels' registers
// down), then each slot's block sum, read by the cluster's other blocks.
template <int Warps, int Slots>
struct ClusterRed {
  float warp[Warps][2];
  float slot[Slots][2];
};

// v[i] <- the sum of v[i] over every thread of the cluster (NV <= 2), in a
// fixed order: lanes by shuffle, warps in order, blocks in rank order.
template <int NV, int Warps, int Slots>
__device__ __forceinline__ void cluster_sum(float (&v)[NV], ClusterRed<Warps, Slots>& red,
                                            int slot, cg::cluster_group& cluster) {
  static_assert(NV <= 2, "two values a reduction at most");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) red.warp[warp][i] = v[i];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float s = 0.f;
      for (int w = 0; w < Warps; ++w) s += red.warp[w][i];
      red.slot[slot][i] = s;
    }
  cluster.sync();
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = 0.f;
  const int blocks = static_cast<int>(cluster.num_blocks());
  for (int r = 0; r < blocks; ++r) {
    const ClusterRed<Warps, Slots>* other = cluster.map_shared_rank(&red, r);
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += other->slot[slot][i];
  }
}

}  // namespace
