// fused_hth — the masked point-to-plane normal equations of the ESIKF row
// path, on Hopper.
//
// Replaces better_fastlio2_tpu/ops/pallas_kernels.py:262 (fused_hth, the
// Pallas TPU kernel _kernel).  For every lane i < N of six AoS/flat inputs
//
//   pts (N,3) f32   p_imu (N,3) f32   n (N,3) f32   C (N,3) f32
//   pd2 (N,)  f32   sel (N,) u8 (0/1)
//
// it forms, with w = sel,
//
//   rows = [n | p_imu x C | pts x C | C] * w     (the last six columns are
//                                                 zero unless EXTRINSIC)
//   HTH += rows^T rows          (12x12, 78 unique entries; 21 live without
//                                EXTRINSIC)
//   HTh += rows * (-pd2 * w)    (12; 6 live without EXTRINSIC)
//
// The ESIKF row path feeds pts = R_il p_body, so the third block is
// (R_il p_body) x C; ops/kernels.py documents the congruence that turns it
// into the reference's p_body x (R_il^T C) block.
//
// Design: one launch of one thread-block cluster (16 blocks where the card
// allows that non-portable size, else the portable 8) reduces the whole
// call, with no scratch in device memory and no second kernel.
//   * Each thread takes 4 consecutive lanes per trip; the cluster covers
//     16 x 256 x 4 = 16384 lanes per trip and grid-strides beyond.  For
//     each (N,3) array those lanes are 48 contiguous bytes, three 16-byte
//     loads; pd2 is one 16-byte load and sel one 32-bit word: 14 (11
//     without EXTRINSIC) independent vector loads in flight before any
//     arithmetic.  Where a pointer is not 16-byte aligned (a view with a
//     storage offset) or the 4 lanes cross N, the same thread loads them
//     one by one (out-of-range lanes read as 0); the arithmetic after the
//     load is one code path, so both branches give the same bits.
//   * Each thread keeps the live sums in registers: 78 + 12 = 90 floats
//     with EXTRINSIC, 21 + 6 = 27 without (pts is then never read).
//   * Block reduction: a butterfly reduce-scatter across the warp (at each
//     of 5 steps a lane sends half of its remaining values to its partner
//     and keeps the other half), 93 shuffles for the 96 padded values
//     instead of 5 per value; then the 8 warps are summed in warp order in
//     shared memory.
//   * Cluster reduction (csrc/cluster_reduce.cuh): every block stores its
//     row into block 0's shared memory through distributed shared memory
//     (remote stores, which do not wait; the start barrier they need was
//     arrived at when the kernel began); after one cluster.sync() block 0
//     sums the rows in
//     block-rank order from its own shared memory.
// No float atomics and a reduction order fixed by N and the cluster size:
// the result is bit-identical from run to run, and the call keeps no
// state between launches, so it is safe on any stream and under CUDA
// graph capture.  The sums are plain fmaf chains with the products written
// out (__fmul_rn), never a tensor-core product (TF32 keeps ~3 digits; the
// reference records that bf16 made the filter diverge).  Never build this
// file with --use_fast_math.  TMA is not used: a block's input is a few KB
// that one round of 16-byte loads already has in flight; TMA pays on
// multi-stage rings over large tiles, which this call never has.
//
// Bound.  Bytes: at N = 16384, 53 B/lane with EXTRINSIC (four (N,3) f32,
// pd2 f32, sel u8): 0.869 MB, 0.26 us at 3.35 TB/s; without it 41 B/lane,
// 0.67 MB, 0.20 us.  Operations: about 220 flop/lane with EXTRINSIC, 0.05 us
// at 67 TFLOP/s f32.  What bounds the call at this size is one launch and
// one round trip to memory, and the fixed cost of the cluster around them:
// on an H100 80GB HBM3 at 700 W, chip_smoke.py measures the launch floor
// (a graph-replayed one-element fill) at 0.88 us, this kernel at N = 1 at
// 3.3 us (2.6 without EXTRINSIC) and at N = 16384 at 4.6 us (3.4).

#include "cluster_reduce.cuh"

namespace {

using namespace cluster_reduce;


template <bool EXT>
struct Dims {
  static constexpr int K = EXT ? 12 : 6;         // live columns
  static constexpr int kTri = K * (K + 1) / 2;   // unique HTH entries
  static constexpr int kVals = kTri + K;         // + HTh
  static constexpr int kPad = (kVals + 31) / 32 * 32;
};

// Load lanes [base, base + 4) of an (N,3) array as three float4 (12 floats).
__device__ __forceinline__ void load3_vec(const float* a, int base,
                                          float* x) {
  const float4* p = reinterpret_cast<const float4*>(a + 3 * (size_t)base);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float4 f = __ldg(p + q);
    x[4 * q] = f.x;
    x[4 * q + 1] = f.y;
    x[4 * q + 2] = f.z;
    x[4 * q + 3] = f.w;
  }
}

// a x b, component c, as a*b - a*b with the first product fused.
__device__ __forceinline__ float cross_c(float a1, float b2, float a2,
                                         float b1) {
  return fmaf(a1, b2, -__fmul_rn(a2, b1));
}

template <bool EXT>
__device__ __forceinline__ void add_lane(float* acc, const float* p,
                                         const float* nv, const float* c,
                                         const float* q, float pd, bool on) {
  using D = Dims<EXT>;
  const float w = on ? 1.f : 0.f;
  float r[D::K];
  r[0] = __fmul_rn(nv[0], w);
  r[1] = __fmul_rn(nv[1], w);
  r[2] = __fmul_rn(nv[2], w);
  r[3] = __fmul_rn(cross_c(p[1], c[2], p[2], c[1]), w);
  r[4] = __fmul_rn(cross_c(p[2], c[0], p[0], c[2]), w);
  r[5] = __fmul_rn(cross_c(p[0], c[1], p[1], c[0]), w);
  if constexpr (EXT) {
    r[6] = __fmul_rn(cross_c(q[1], c[2], q[2], c[1]), w);
    r[7] = __fmul_rn(cross_c(q[2], c[0], q[0], c[2]), w);
    r[8] = __fmul_rn(cross_c(q[0], c[1], q[1], c[0]), w);
    r[9] = __fmul_rn(c[0], w);
    r[10] = __fmul_rn(c[1], w);
    r[11] = __fmul_rn(c[2], w);
  }
  const float hv = __fmul_rn(-pd, w);
  int k = 0;
#pragma unroll
  for (int a = 0; a < D::K; ++a) {
#pragma unroll
    for (int b = a; b < D::K; ++b) {
      acc[k] = fmaf(r[a], r[b], acc[k]);
      ++k;
    }
  }
#pragma unroll
  for (int a = 0; a < D::K; ++a)
    acc[D::kTri + a] = fmaf(r[a], hv, acc[D::kTri + a]);
}

// out: HTH (144, row-major) then HTh (12).
template <bool EXT>
__global__ void __launch_bounds__(kThreads, 1)
hth_cluster_kernel(const float* __restrict__ pts,
                   const float* __restrict__ pimu,
                   const float* __restrict__ nrm,
                   const float* __restrict__ cvec,
                   const float* __restrict__ pd2,
                   const uint8_t* __restrict__ sel, int n, int vec,
                   float* __restrict__ out) {
  using D = Dims<EXT>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nb = (int)cluster.num_blocks();
  cluster_arrive_relaxed();

  float acc[D::kPad];
#pragma unroll
  for (int k = 0; k < D::kPad; ++k) acc[k] = 0.f;

  const int stride = kLanes * kThreads * nb;
  for (int base = kLanes * (rank * kThreads + (int)threadIdx.x); base < n;
       base += stride) {
    float p[3 * kLanes], nv[3 * kLanes], c[3 * kLanes], q[3 * kLanes],
        h[kLanes];
    uint32_t s4 = 0;  // byte j: sel of lane base + j
    if (vec && base + kLanes <= n) {
      load3_vec(pimu, base, p);
      load3_vec(nrm, base, nv);
      load3_vec(cvec, base, c);
      if constexpr (EXT) load3_vec(pts, base, q);
      const float4 f = __ldg(reinterpret_cast<const float4*>(pd2 + base));
      h[0] = f.x;
      h[1] = f.y;
      h[2] = f.z;
      h[3] = f.w;
      s4 = __ldg(reinterpret_cast<const unsigned int*>(sel + base));
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const int i = base + j;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          p[3 * j + a] = 0.f;
          nv[3 * j + a] = 0.f;
          c[3 * j + a] = 0.f;
          q[3 * j + a] = 0.f;
        }
        h[j] = 0.f;
        if (i < n) {
          const size_t o = 3 * (size_t)i;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            p[3 * j + a] = pimu[o + a];
            nv[3 * j + a] = nrm[o + a];
            c[3 * j + a] = cvec[o + a];
            if constexpr (EXT) q[3 * j + a] = pts[o + a];
          }
          h[j] = pd2[i];
          if (sel[i]) s4 |= 1u << (8 * j);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      add_lane<EXT>(acc, p + 3 * j, nv + 3 * j, c + 3 * j, q + 3 * j, h[j],
                    ((s4 >> (8 * j)) & 0xffu) != 0);
  }

  // block: reduce-scatter in each warp, then the warps in order
  __shared__ float s_warp[kWarps][D::kPad];
  __shared__ float s_all[kMaxCluster][D::kVals];  // block 0's: by rank
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce_scatter<D::kPad, 16>(acc, lane);
  constexpr int M = D::kPad / 32;
#pragma unroll
  for (int j = 0; j < M; ++j) s_warp[warp][lane * M + j] = acc[j];
  __syncthreads();
  cluster_wait();  // every block has started: block 0 may be stored into
  if (threadIdx.x < D::kVals) {
    float s = s_warp[0][threadIdx.x];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi)
      s = __fadd_rn(s, s_warp[wi][threadIdx.x]);
    // push the block's row into block 0's shared memory (a remote store
    // does not wait; block 0 then reads locally)
    *cluster.map_shared_rank(&s_all[rank][threadIdx.x], 0) = s;
  }

  // cluster: the barrier (release/acquire) makes every row visible to
  // block 0, which sums them in rank order; nothing reads the other
  // blocks' shared memory, so they may leave
  cluster.sync();
  if (rank == 0 && threadIdx.x < 156) {
    const int t = threadIdx.x;
    int k = -1;
    if (t < 144) {
      int a = t / 12, b = t % 12;
      if (a > b) {
        const int s = a;
        a = b;
        b = s;
      }
      // packed row-major upper-triangle index of (a, b) in a K x K matrix
      if (b < D::K) k = a * D::K - a * (a - 1) / 2 + (b - a);
    } else if (t - 144 < D::K) {
      k = D::kTri + (t - 144);
    }
    // (a, b) and (b, a) sum the same values in the same order: HTH is
    // exactly symmetric
    float s = 0.f;
    if (k >= 0) {
      s = s_all[0][k];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < nb) s = __fadd_rn(s, s_all[r][k]);
    }
    out[t] = s;
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
int fused_hth_setup(int* cluster, int* max_active) {
  if (g_cluster == 0) {
    const cudaError_t e =
        pick_cluster(&g_cluster, &g_max_active, hth_cluster_kernel<true>,
                     hth_cluster_kernel<false>);
    if (e != cudaSuccess) return (int)e;
  }
  *cluster = g_cluster;
  *max_active = g_max_active;
  return 0;
}

// pts, p_imu, n, C (n, 3) f32 row-major; pd2 (n,) f32; sel (n,) u8 0/1;
// all on the device.  out (13, 12) f32 row-major receives HTH (12x12) in
// rows 0-11 and HTh in row 12.  pts is read only when extrinsic != 0.  One
// cluster launch on `stream`; fused_hth_setup must have run.  Returns the
// launch's error or else cudaGetLastError().
int fused_hth_launch(const float* pts, const float* pimu, const float* nrm,
                     const float* cvec, const float* pd2, const uint8_t* sel,
                     int n, int extrinsic, float* out, void* stream) {
  if (g_cluster == 0) return (int)cudaErrorNotReady;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = aligned(pimu, 16) && aligned(nrm, 16) &&
                  aligned(cvec, 16) && aligned(pd2, 16) && aligned(sel, 4) &&
                  (!extrinsic || aligned(pts, 16));
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(g_cluster, &attr, s);
  const cudaError_t e =
      extrinsic ? cudaLaunchKernelEx(&cfg, hth_cluster_kernel<true>, pts,
                                     pimu, nrm, cvec, pd2, sel, n, vec, out)
                : cudaLaunchKernelEx(&cfg, hth_cluster_kernel<false>, pts,
                                     pimu, nrm, cvec, pd2, sel, n, vec, out);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // extern "C"
