// cluster_reduce.cuh — what fused_normal_eqs.cu and fused_hth.cu share:
// the shape of their one-cluster launch and the pieces of its fixed-order
// reduction.
//
// Each kernel runs as one thread-block cluster of kThreads-thread blocks
// (16 blocks where the card allows that non-portable size, else the
// portable 8); a thread takes kLanes consecutive lanes per trip.  A block
// reduces its per-thread sums with warp_reduce_scatter and then over its
// warps in warp order; every block stores its row into block 0's shared
// memory, and block 0 sums the rows in rank order.  Every order is fixed,
// so results are bit-identical from run to run.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace cluster_reduce {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 4;         // consecutive lanes per thread and trip
constexpr int kMaxCluster = 16;   // blocks per cluster: 16, or 8

// Butterfly reduce-scatter of P values per lane over the warp: at each
// step a lane sends half of its remaining values to its partner (lane ^
// MASK) and adds the partner's copy of the half it keeps.  After the step
// with MASK = 1, lane l holds in v[0, P/32) the warp sums of values
// [l * P/32, (l + 1) * P/32).  P - P/32 shuffles in all (5 per value would
// be 5 P); every sum is own + partner, in a fixed order.
template <int P, int MASK>
__device__ __forceinline__ void warp_reduce_scatter(float* v, int lane) {
  static_assert(P % (2 * MASK) == 0, "pad the values to a multiple of 32");
  constexpr int H = P / 2;
  const bool upper = (lane & MASK) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? v[k] : v[H + k];
    const float keep = upper ? v[H + k] : v[k];
    v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, MASK));
  }
  if constexpr (MASK > 1) warp_reduce_scatter<H, MASK / 2>(v, lane);
}

// The first phase of the cluster barrier, split: every thread arrives at
// the start of the kernel and waits just before its first store into
// another block's shared memory, which every block must have started for
// (CUDA programming guide, distributed shared memory).  By then the wait
// costs nothing.  The second phase is cluster.sync() (release/acquire),
// after which block 0 reads the rows stored into it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The launch of one cluster of cs blocks of kThreads threads on s; attr
// must outlive the launch call.
inline cudaLaunchConfig_t cluster_config(int cs, cudaLaunchAttribute* attr,
                                         cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of cs blocks of `kernel` that fit on the card at once (0 if it
// refuses the size).
template <class Kernel>
int active_clusters(Kernel* kernel, int cs) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cs, &attr, 0);
  int a = 0;
  if (cudaOccupancyMaxActiveClusters(&a, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a refused size is not an error of the caller's
    return 0;
  }
  return a;
}

// Allow the non-portable cluster size on every kernel (before its first
// launch), then take 16 blocks if the card can hold such a cluster of
// each, else the portable 8.  Writes the size and the least
// cudaOccupancyMaxActiveClusters over the kernels at that size.
template <class... Kernels>
cudaError_t pick_cluster(int* cluster, int* max_active, Kernels*... kernels) {
  for (cudaError_t e : {cudaFuncSetAttribute(
           kernels, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)...})
    if (e != cudaSuccess) return e;
  for (int cs : {kMaxCluster, 8}) {
    int least = 1 << 30;
    for (int a : {active_clusters(kernels, cs)...})
      least = a < least ? a : least;
    if (least >= 1) {
      *cluster = cs;
      *max_active = least;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

inline bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) % to) == 0;
}

}  // namespace cluster_reduce
