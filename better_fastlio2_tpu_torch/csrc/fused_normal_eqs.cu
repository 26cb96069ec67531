// fused_normal_eqs — the ESIKF normal equations of one solve pass, on
// Hopper.
//
// Replaces better_fastlio2_tpu/ops/pallas_kernels.py:fused_normal_eqs (the
// Pallas TPU kernel _neq_kernel).  For every lane of the (16, N) row-major
// SoA buffer packed by ops/kernels.pack_soa, under the pose in `params`
// (R row-major 9 | t 3 | voxel size | 0 0 0):
//
//   p_w  = R p_imu + t
//   pd2  = n . p_w + d
//   w    = ok * [ |pd2| * invb < 0.1 ]            (robust s-gate)
//   C    = R^T n,   A = p_imu x C
//   rows = [n, A, -pd2, 1] * w
//   G   += rows rows^T            (8x8, 36 unique entries)
//   mv  += valid * [ floor(p_w / vs) != assoc_ijk ]   (voxel-moved count)
//
// G[:6,:6] = H^T W H, G[:6,6] = H^T W h, G[7,7] = n_valid; n_moved drives
// the lazy re-association branch, so it must not depend on run order.
//
// Design: one launch of one thread-block cluster (16 blocks where the card
// allows that non-portable size, else the portable 8) reduces the whole
// call, with no scratch in device memory and no second kernel.
//   * Each thread takes 4 consecutive lanes per trip; the cluster covers
//     16 x 256 x 4 = 16384 lanes per trip and grid-strides beyond.  Each of
//     the 13 live channel rows gives those lanes as one 16-byte load: 13
//     independent vector loads in flight before any arithmetic.  Where the
//     buffer or its row stride is not 16-byte aligned (N not a multiple of
//     4, a view with a storage offset) or the 4 lanes cross N, the same
//     thread loads them one by one (out-of-range lanes read as 0); the
//     arithmetic after the load is one code path, so both branches give
//     the same bits.
//   * Each thread keeps the 36 Gram entries (fp32 FMA) and an integer moved
//     count in registers.
//   * Block reduction: a butterfly reduce-scatter across the warp (at each
//     of 5 steps a lane sends half of its remaining values to its partner
//     and keeps the other half), 62 shuffles for the 64 padded values
//     instead of 5 per value, and one integer warp reduction for the count;
//     then the 8 warps are summed in warp order in shared memory.
//   * Cluster reduction (csrc/cluster_reduce.cuh): every block stores its
//     row into block 0's shared memory through distributed shared memory
//     (remote stores, which do not wait; the start barrier they need was
//     arrived at when the kernel began); after one cluster.sync() block 0
//     sums the rows in
//     block-rank order from its own shared memory (the count in 64-bit
//     integers).
// No float atomics and a reduction order fixed by N and the cluster size:
// the result is bit-identical from run to run, and the call keeps no
// state between launches, so it is safe on any stream and under CUDA
// graph capture.  The products are written out (__fmul_rn, fmaf), so the
// contraction does not depend on the compiler.  The voxel test divides
// (floorf(p / vs)): a reciprocal multiply would flip voxel boundaries
// against the reference, so never build this file with --use_fast_math or
// -prec-div=false.  TMA is not used: a block's input is a few KB that one
// round of 16-byte loads already has in flight; TMA pays on multi-stage
// rings over large tiles, which this call never has.
//
// Bound.  Bytes: the kernel must read the 13 live channels of the buffer
// once, 13 x N x 4 B (832 KiB at N = 16384, ~0.25 us at 3.35 TB/s;
// channels 13-15 are padding it never reads); the ~140 flops per lane are
// far below the fp32 rate.  What bounds the call at this size is one
// launch and one round trip to memory, and the fixed cost of the cluster
// around them: on an H100 80GB HBM3 at 700 W, chip_smoke.py measures the
// launch floor (a graph-replayed one-element fill) at 0.88 us, this
// kernel at N = 1 at 3.1 us and at N = 16384 at 4.2 us.

#include "cluster_reduce.cuh"

namespace {

using namespace cluster_reduce;

constexpr int kGram = 36;         // unique entries of the symmetric 8x8
constexpr int kPad = 64;          // kGram padded to a multiple of 32
constexpr int kCh = 13;           // live SoA channels

// SoA channel indices (ops/kernels.py)
constexpr int PIX = 0, PIY = 1, PIZ = 2, NX = 3, NY = 4, NZ = 5, DD = 6,
              INVB = 7, OK = 8, AIX = 9, AIY = 10, AIZ = 11, VAL = 12;

struct Pose {
  float R00, R01, R02, R10, R11, R12, R20, R21, R22, tx, ty, tz, vs;
};

// a0 b0 + a1 b1 + a2 b2 as two fmas on the first product
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, __fmul_rn(a0, b0)));
}

// One lane: x[ch] is the lane's value of channel ch.
__device__ __forceinline__ void add_lane(float* acc, int& mv, const float* x,
                                         const Pose& P) {
  const float pix = x[PIX], piy = x[PIY], piz = x[PIZ];
  const float nx = x[NX], ny = x[NY], nz = x[NZ];
  const float pwx = __fadd_rn(dot3(P.R00, pix, P.R01, piy, P.R02, piz), P.tx);
  const float pwy = __fadd_rn(dot3(P.R10, pix, P.R11, piy, P.R12, piz), P.ty);
  const float pwz = __fadd_rn(dot3(P.R20, pix, P.R21, piy, P.R22, piz), P.tz);
  const float pd2 = __fadd_rn(dot3(nx, pwx, ny, pwy, nz, pwz), x[DD]);
  const float w = (__fmul_rn(fabsf(pd2), x[INVB]) < 0.1f) ? x[OK] : 0.f;

  const float cx = dot3(P.R00, nx, P.R10, ny, P.R20, nz);
  const float cy = dot3(P.R01, nx, P.R11, ny, P.R21, nz);
  const float cz = dot3(P.R02, nx, P.R12, ny, P.R22, nz);
  float r[8];
  r[0] = __fmul_rn(nx, w);
  r[1] = __fmul_rn(ny, w);
  r[2] = __fmul_rn(nz, w);
  r[3] = __fmul_rn(fmaf(piy, cz, -__fmul_rn(piz, cy)), w);
  r[4] = __fmul_rn(fmaf(piz, cx, -__fmul_rn(pix, cz)), w);
  r[5] = __fmul_rn(fmaf(pix, cy, -__fmul_rn(piy, cx)), w);
  r[6] = __fmul_rn(-pd2, w);
  r[7] = w;
  int k = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int b = a; b < 8; ++b) {
      acc[k] = fmaf(r[a], r[b], acc[k]);
      ++k;
    }
  }

  const bool moved = (floorf(__fdiv_rn(pwx, P.vs)) != x[AIX]) ||
                     (floorf(__fdiv_rn(pwy, P.vs)) != x[AIY]) ||
                     (floorf(__fdiv_rn(pwz, P.vs)) != x[AIZ]);
  mv += (x[VAL] != 0.f && moved) ? 1 : 0;
}

// out: G (64, row-major) then n_moved (1).
__global__ void __launch_bounds__(kThreads, 1)
neq_cluster_kernel(const float* __restrict__ soa, int stride,
                   const float* __restrict__ params, int n, int vec,
                   float* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nb = (int)cluster.num_blocks();
  cluster_arrive_relaxed();

  Pose P;
  P.R00 = __ldg(params + 0);
  P.R01 = __ldg(params + 1);
  P.R02 = __ldg(params + 2);
  P.R10 = __ldg(params + 3);
  P.R11 = __ldg(params + 4);
  P.R12 = __ldg(params + 5);
  P.R20 = __ldg(params + 6);
  P.R21 = __ldg(params + 7);
  P.R22 = __ldg(params + 8);
  P.tx = __ldg(params + 9);
  P.ty = __ldg(params + 10);
  P.tz = __ldg(params + 11);
  P.vs = __ldg(params + 12);

  float acc[kPad];
#pragma unroll
  for (int k = 0; k < kPad; ++k) acc[k] = 0.f;
  int mv = 0;

  const size_t rs = (size_t)stride;
  const int step = kLanes * kThreads * nb;
  for (int base = kLanes * (rank * kThreads + (int)threadIdx.x); base < n;
       base += step) {
    float x[kLanes][kCh];  // x[j][ch]: lane base + j, channel ch
    if (vec && base + kLanes <= n) {
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) {
        const float4 f =
            __ldg(reinterpret_cast<const float4*>(soa + ch * rs + base));
        x[0][ch] = f.x;
        x[1][ch] = f.y;
        x[2][ch] = f.z;
        x[3][ch] = f.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const int i = base + j;
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch)
          x[j][ch] = i < n ? soa[ch * rs + i] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) add_lane(acc, mv, x[j], P);
  }

  // block: reduce-scatter in each warp, then the warps in order
  __shared__ float s_warp[kWarps][kPad];
  __shared__ int s_mv_warp[kWarps];
  __shared__ float s_all[kMaxCluster][kGram];  // block 0's: by rank
  __shared__ int s_mv_all[kMaxCluster];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce_scatter<kPad, 16>(acc, lane);
  constexpr int M = kPad / 32;
#pragma unroll
  for (int j = 0; j < M; ++j) s_warp[warp][lane * M + j] = acc[j];
  mv = __reduce_add_sync(0xffffffffu, mv);
  if (lane == 0) s_mv_warp[warp] = mv;
  __syncthreads();
  cluster_wait();  // every block has started: block 0 may be stored into
  // push the block's row into block 0's shared memory (a remote store
  // does not wait; block 0 then reads locally)
  if (threadIdx.x < kGram) {
    float s = s_warp[0][threadIdx.x];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi)
      s = __fadd_rn(s, s_warp[wi][threadIdx.x]);
    *cluster.map_shared_rank(&s_all[rank][threadIdx.x], 0) = s;
  } else if (threadIdx.x == kGram) {
    int s = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += s_mv_warp[wi];
    *cluster.map_shared_rank(&s_mv_all[rank], 0) = s;
  }

  // cluster: the barrier (release/acquire) makes every row visible to
  // block 0, which sums them in rank order; nothing reads the other
  // blocks' shared memory, so they may leave
  cluster.sync();
  if (rank == 0 && threadIdx.x < 64) {
    const int t = threadIdx.x;
    int a = t / 8, b = t % 8;
    if (a > b) {
      const int s = a;
      a = b;
      b = s;
    }
    // packed row-major upper-triangle index of (a, b); (a, b) and (b, a)
    // sum the same values in the same order: G is exactly symmetric
    const int k = a * 8 - a * (a - 1) / 2 + (b - a);
    float s = s_all[0][k];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < nb) s = __fadd_rn(s, s_all[r][k]);
    out[t] = s;
  } else if (rank == 0 && threadIdx.x == 64) {
    long long s = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < nb) s += s_mv_all[r];
    out[64] = (float)s;
  }
}

int g_cluster = 0;      // cluster size taken (16 or 8), 0 before setup
int g_max_active = 0;   // cudaOccupancyMaxActiveClusters at that size

}  // namespace

extern "C" {

// Pick the cluster size once per process: 16 blocks (non-portable, allowed
// first) if the card can hold such a cluster, else the portable 8.  Writes
// the size and cudaOccupancyMaxActiveClusters at that size.  Returns a
// cudaError_t (0 on success).
int fused_normal_eqs_setup(int* cluster, int* max_active) {
  if (g_cluster == 0) {
    const cudaError_t e =
        pick_cluster(&g_cluster, &g_max_active, neq_cluster_kernel);
    if (e != cudaSuccess) return (int)e;
  }
  *cluster = g_cluster;
  *max_active = g_max_active;
  return 0;
}

// soa (16, n) f32 with row stride `stride` floats, params (16,) f32, both
// on the device.  out f32 receives G (8x8 row-major) in its first 64
// floats and n_moved in the 65th.
// One cluster launch on `stream`; fused_normal_eqs_setup must have run.
// Returns the launch's error or else cudaGetLastError().
int fused_normal_eqs_launch(const float* soa, int stride,
                            const float* params, int n, float* out,
                            void* stream) {
  if (g_cluster == 0) return (int)cudaErrorNotReady;
  const int vec = aligned(soa, 16) && stride % 4 == 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(g_cluster, &attr, static_cast<cudaStream_t>(stream));
  const cudaError_t e = cudaLaunchKernelEx(&cfg, neq_cluster_kernel, soa,
                                           stride, params, n, vec, out);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// The kernel's handles as a captured CUDA graph's kernel nodes may name it:
// its function in the current context (a CUfunction) and its
// context-independent kernel (a CUkernel).  Returns a cudaError_t.
int fused_normal_eqs_handles(void** func, void** kern) {
  const void* sym = reinterpret_cast<const void*>(neq_cluster_kernel);
  cudaFunction_t f = nullptr;
  cudaKernel_t k = nullptr;
  cudaError_t e = cudaGetFuncBySymbol(&f, sym);
  if (e == cudaSuccess) e = cudaGetKernel(&k, sym);
  *func = reinterpret_cast<void*>(f);
  *kern = reinterpret_cast<void*>(k);
  return (int)e;
}

}  // extern "C"
