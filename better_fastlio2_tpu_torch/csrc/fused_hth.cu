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
// Design.  Stage 1: a fixed grid (a function of N only); each thread
// grid-strides over lanes, reads each lane's 12-byte AoS records (a warp's
// reads of one array are contiguous) and its u8 mask, and keeps the live
// sums in registers: with EXTRINSIC 78 + 12 = 90 floats, without it 21 + 6
// = 27 (pts is then never read).  The ragged edge is masked in the loop;
// there is no padding to tiles.  Each block reduces its sums in a fixed
// order (warp shuffles, then shared memory) into one partial row.  Stage 2:
// one block sums the partials in block-index order and writes the
// symmetric 12x12 (zeros outside the live block) and the 12-vector.  No
// float atomics anywhere: the result is bit-identical from run to run.  The
// sums are plain fmaf chains, never a tensor-core product (TF32 keeps ~3
// digits; the reference records that bf16 made the filter diverge).  Never
// build this file with --use_fast_math.
//
// Bound.  Bytes: at N = 16384, 53 B/lane with EXTRINSIC (four (N,3) f32,
// pd2 f32, sel u8): 0.869 MB, 0.26 us at 3.35 TB/s; without it 41 B/lane,
// 0.67 MB, 0.20 us.  Operations: about 220 flop/lane with EXTRINSIC, 0.05 us
// at 67 TFLOP/s f32.  At this size the two launches dominate; making the
// kernel fast (one stage, graph capture) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVals = 78 + 12;  // partial row width (EXTRINSIC)

template <bool EXT>
struct Dims {
  static constexpr int K = EXT ? 12 : 6;         // live columns
  static constexpr int kTri = K * (K + 1) / 2;   // unique HTH entries
  static constexpr int kVals = kTri + K;         // + HTh
};

template <bool EXT>
__global__ void __launch_bounds__(kThreads)
hth_stage1(const float* __restrict__ pts, const float* __restrict__ pimu,
           const float* __restrict__ nrm, const float* __restrict__ cvec,
           const float* __restrict__ pd2, const uint8_t* __restrict__ sel,
           int n, float* __restrict__ part) {
  using D = Dims<EXT>;
  float acc[D::kVals];
#pragma unroll
  for (int k = 0; k < D::kVals; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const size_t b = 3 * (size_t)i;
    const float w = sel[i] ? 1.f : 0.f;
    const float nx = nrm[b], ny = nrm[b + 1], nz = nrm[b + 2];
    const float cx = cvec[b], cy = cvec[b + 1], cz = cvec[b + 2];
    const float px = pimu[b], py = pimu[b + 1], pz = pimu[b + 2];
    float r[D::K];
    r[0] = nx * w;
    r[1] = ny * w;
    r[2] = nz * w;
    r[3] = (py * cz - pz * cy) * w;
    r[4] = (pz * cx - px * cz) * w;
    r[5] = (px * cy - py * cx) * w;
    if constexpr (EXT) {
      const float qx = pts[b], qy = pts[b + 1], qz = pts[b + 2];
      r[6] = (qy * cz - qz * cy) * w;
      r[7] = (qz * cx - qx * cz) * w;
      r[8] = (qx * cy - qy * cx) * w;
      r[9] = cx * w;
      r[10] = cy * w;
      r[11] = cz * w;
    }
    const float hv = -pd2[i] * w;
    int k = 0;
#pragma unroll
    for (int a = 0; a < D::K; ++a) {
#pragma unroll
      for (int c = a; c < D::K; ++c) {
        acc[k] = fmaf(r[a], r[c], acc[k]);
        ++k;
      }
    }
#pragma unroll
    for (int a = 0; a < D::K; ++a)
      acc[D::kTri + a] = fmaf(r[a], hv, acc[D::kTri + a]);
  }

  // block reduce in a fixed order: warp shuffles, then over warps in order
  __shared__ float sv[kWarps][D::kVals];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < D::kVals; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sv[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < D::kVals) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += sv[wi][threadIdx.x];
    part[blockIdx.x * D::kVals + threadIdx.x] = s;
  }
}

// One thread per output: HTH entry t < 144 (row-major), HTh entry
// t - 144 < 12.  (a, c) and (c, a) sum the same partials in the same
// order, so HTH is exactly symmetric.
template <bool EXT>
__global__ void hth_stage2(const float* __restrict__ part, int nblocks,
                           float* __restrict__ hth, float* __restrict__ hthv) {
  using D = Dims<EXT>;
  const int t = threadIdx.x;
  int k = -1;
  if (t < 144) {
    int a = t / 12, c = t % 12;
    if (a > c) {
      const int s = a;
      a = c;
      c = s;
    }
    // packed row-major upper-triangle index of (a, c) in a K x K matrix
    if (c < D::K) k = a * D::K - a * (a - 1) / 2 + (c - a);
  } else if (t < 156) {
    const int a = t - 144;
    if (a < D::K) k = D::kTri + a;
  } else {
    return;
  }
  float s = 0.f;
  if (k >= 0)
    for (int b = 0; b < nblocks; ++b) s += part[b * D::kVals + k];
  if (t < 144)
    hth[t] = s;
  else
    hthv[t - 144] = s;
}

}  // namespace

extern "C" {

// Number of stage-1 blocks for n lanes (a function of n only, so the
// reduction order, and the result, is fixed for a given n).
int fused_hth_blocks(int n) {
  int b = (n + kThreads * 4 - 1) / (kThreads * 4);
  if (b < 1) b = 1;
  if (b > 264) b = 264;
  return b;
}

// Width of one stage-1 partial row (the scratch is (nblocks, this)).
int fused_hth_partial_width() { return kMaxVals; }

// pts, p_imu, n, C (n, 3) f32 row-major; pd2 (n,) f32; sel (n,) u8 0/1;
// all on the device.  part (nblocks, 90) f32 is scratch; hth (12, 12) and
// hthv (12,) f32 are written.  pts is read only when extrinsic != 0.
// Returns cudaGetLastError().
int fused_hth_launch(const float* pts, const float* pimu, const float* nrm,
                     const float* cvec, const float* pd2, const uint8_t* sel,
                     int n, int extrinsic, float* part, int nblocks,
                     float* hth, float* hthv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (extrinsic) {
    hth_stage1<true><<<nblocks, kThreads, 0, s>>>(pts, pimu, nrm, cvec, pd2,
                                                  sel, n, part);
  } else {
    hth_stage1<false><<<nblocks, kThreads, 0, s>>>(pts, pimu, nrm, cvec,
                                                   pd2, sel, n, part);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (extrinsic)
    hth_stage2<true><<<1, 160, 0, s>>>(part, nblocks, hth, hthv);
  else
    hth_stage2<false><<<1, 160, 0, s>>>(part, nblocks, hth, hthv);
  return (int)cudaGetLastError();
}

}  // extern "C"
