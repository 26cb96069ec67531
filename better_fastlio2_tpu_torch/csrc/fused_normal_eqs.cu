// fused_normal_eqs — the ESIKF normal equations of one solve pass, on Hopper.
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
// Design.  Stage 1: a fixed grid (a function of N only); each thread
// grid-strides over lanes, reading each of the 13 live channels with
// coalesced loads, and keeps the 36 Gram entries (fp32 FMA) and an integer
// moved count in registers.  Each block reduces them in a fixed order (warp
// shuffles, then shared memory) into one partial row.  Stage 2: one block
// sums the partials in block-index order and writes the symmetric G and
// n_moved.  No float atomics anywhere: the result is bit-identical from run
// to run.  The ragged edge is masked in the loop (no padding to tiles).
// The voxel test divides (floorf(p / vs)): a reciprocal multiply would flip
// voxel boundaries against the reference, so never build this file with
// --use_fast_math or -prec-div=false.
//
// Bound.  Bytes: the kernel must read the 13 live channels of the buffer
// once, 13 x N x 4 B (832 KiB at N = 16384, ~0.25 us at 3.35 TB/s;
// channels 13-15 are padding it never reads); the ~140 flops per lane are
// far below the fp32 rate.  At that size the two launches dominate: the kernel is
// launch-latency-bound.  Fusing the stages and graph-capturing the solve
// loop is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGram = 36;           // unique entries of the symmetric 8x8
constexpr int kVals = kGram + 1;    // + moved count

// SoA channel indices (ops/kernels.py)
constexpr int PIX = 0, PIY = 1, PIZ = 2, NX = 3, NY = 4, NZ = 5, DD = 6,
              INVB = 7, OK = 8, AIX = 9, AIY = 10, AIZ = 11, VAL = 12;

__global__ void __launch_bounds__(kThreads)
neq_stage1(const float* __restrict__ soa, const float* __restrict__ params,
           int n, float* __restrict__ part_g, int* __restrict__ part_mv) {
  const float R00 = params[0], R01 = params[1], R02 = params[2];
  const float R10 = params[3], R11 = params[4], R12 = params[5];
  const float R20 = params[6], R21 = params[7], R22 = params[8];
  const float tx = params[9], ty = params[10], tz = params[11];
  const float vs = params[12];

  float acc[kGram];
#pragma unroll
  for (int k = 0; k < kGram; ++k) acc[k] = 0.f;
  int mv = 0;

  const size_t stride = (size_t)n;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float pix = soa[PIX * stride + i], piy = soa[PIY * stride + i],
                piz = soa[PIZ * stride + i];
    const float nx = soa[NX * stride + i], ny = soa[NY * stride + i],
                nz = soa[NZ * stride + i];
    const float d = soa[DD * stride + i], invb = soa[INVB * stride + i];
    const float ok = soa[OK * stride + i];
    const float aix = soa[AIX * stride + i], aiy = soa[AIY * stride + i],
                aiz = soa[AIZ * stride + i];
    const float val = soa[VAL * stride + i];

    const float pwx = R00 * pix + R01 * piy + R02 * piz + tx;
    const float pwy = R10 * pix + R11 * piy + R12 * piz + ty;
    const float pwz = R20 * pix + R21 * piy + R22 * piz + tz;
    const float pd2 = nx * pwx + ny * pwy + nz * pwz + d;
    const float w = (fabsf(pd2) * invb < 0.1f) ? ok : 0.f;

    const float cx = R00 * nx + R10 * ny + R20 * nz;
    const float cy = R01 * nx + R11 * ny + R21 * nz;
    const float cz = R02 * nx + R12 * ny + R22 * nz;
    float r[8];
    r[0] = nx * w;
    r[1] = ny * w;
    r[2] = nz * w;
    r[3] = (piy * cz - piz * cy) * w;
    r[4] = (piz * cx - pix * cz) * w;
    r[5] = (pix * cy - piy * cx) * w;
    r[6] = -pd2 * w;
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

    const bool moved = (floorf(pwx / vs) != aix) || (floorf(pwy / vs) != aiy)
                       || (floorf(pwz / vs) != aiz);
    mv += (val != 0.f && moved) ? 1 : 0;
  }

  // block reduce in a fixed order: warp shuffles, then warp 0 over warps
  __shared__ float sg[kWarps][kGram];
  __shared__ int smv[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kGram; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sg[warp][k] = v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mv += __shfl_down_sync(0xffffffffu, mv, off);
  if (lane == 0) smv[warp] = mv;
  __syncthreads();
  if (threadIdx.x < kGram) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += sg[wi][threadIdx.x];
    part_g[blockIdx.x * kGram + threadIdx.x] = s;
  } else if (threadIdx.x == kGram) {
    int s = 0;
    for (int wi = 0; wi < kWarps; ++wi) s += smv[wi];
    part_mv[blockIdx.x] = s;
  }
}

__global__ void neq_stage2(const float* __restrict__ part_g,
                           const int* __restrict__ part_mv, int nblocks,
                           float* __restrict__ G, float* __restrict__ n_moved) {
  const int k = threadIdx.x;
  if (k < kGram) {
    float s = 0.f;
    for (int b = 0; b < nblocks; ++b) s += part_g[b * kGram + k];
    // k -> (a, b) of the upper triangle, row-major
    int a = 0, rem = k;
    while (rem >= 8 - a) {
      rem -= 8 - a;
      ++a;
    }
    const int c = a + rem;
    G[a * 8 + c] = s;
    G[c * 8 + a] = s;
  } else if (k == kGram) {
    long long s = 0;
    for (int b = 0; b < nblocks; ++b) s += part_mv[b];
    *n_moved = (float)s;
  }
}

}  // namespace

extern "C" {

// Number of stage-1 blocks for n lanes (a function of n only, so the
// reduction order — and the result — is fixed for a given n).
int fused_normal_eqs_blocks(int n) {
  int b = (n + kThreads * 4 - 1) / (kThreads * 4);
  if (b < 1) b = 1;
  if (b > 264) b = 264;
  return b;
}

// soa (16, n) f32 row-major, params (16,) f32, both on the device.
// part_g (nblocks, 36) f32 and part_mv (nblocks,) i32 are scratch;
// G (8, 8) f32 and n_moved () f32 are written.  Returns cudaGetLastError().
int fused_normal_eqs_launch(const float* soa, const float* params, int n,
                            float* part_g, int* part_mv, int nblocks,
                            float* G, float* n_moved, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  neq_stage1<<<nblocks, kThreads, 0, s>>>(soa, params, n, part_g, part_mv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  neq_stage2<<<1, 64, 0, s>>>(part_g, part_mv, nblocks, G, n_moved);
  return (int)cudaGetLastError();
}

}  // extern "C"
