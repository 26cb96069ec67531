// imu_stage — the IMU stage of one scan (forward propagation, covariance
// composition and point undistortion) in one launch, on Hopper.
//
// It replaces no TPU kernel: the JAX package's core/imu.py is plain XLA
// (IMU_Processing.hpp's UndistortPcl).  It was added because the stage's
// plain PyTorch version (better_fastlio2_tpu_torch/core/imu.py: propagate
// and undistort, which stay as the CPU path and the tests' reference) is
// ~2.9k small launches a scan, ~1.2 us a node in a replayed CUDA graph,
// against a few tens of microseconds of work.
//
// Inputs: the filter state (pos, rot, off_r, off_t, vel, bg, ba, grav), P
// (23x23), Q (12x12), acc_norm, last_scan_end_t, scan_end_t, the previous
// scan's recorded rates last_acc_w / last_gyr_b, one scan's M IMU rows
// (acc, gyr: (M,3) with any row stride; t, mask: (M,) with any stride;
// sample 0 is the previous scan's last) and n lidar rows (pts (n,3),
// pt_t (n,)).  All floating inputs are one type T (float or double).
// Outputs: P_fin (529), x_fin (26), the IMU-rate poses (t, pos, vel, rot,
// acc_w, gyr_b: 17 M values) in `out`, and the undistorted rows in
// `pts_out`.  The arithmetic is the plain version's, formula by formula
// (utils/so3.py, utils/s2.py, core/esikf.py:predict_jacobians, predict):
// _cos_sinc_sqrt's Taylor branch below 1e-6, quaternions normalised by a
// division by their norm, the same clamps (a NaN passes a clamp as in
// torch.clamp), searchsorted(right=True) - 1 as torch's binary search.
// Padding rows (mask false, t = inf) have dt = 0.
//
// It also rounds where the plain version rounds on the card: this file
// builds with -fmad=false (ops/_build.py), so an elementwise a * b + c is
// a product and a sum, as PyTorch's separate kernels compute it; a
// division by a constant is a product with its reciprocal rounded from
// double, as PyTorch's CUDA division by a Python scalar is (and 9.809 / x
// a reciprocal times 9.809, as Tensor.__rtruediv__ is); sums of squares
// take torch.sum's order over 3 and 4 entries, (0 + 2) + 1 and (0 + 2) +
// (1 + 3); and each matrix product takes cuBLAS's order for its shape as
// PyTorch 2.11 calls it on the H100 (`dot`: fused multiply-add chains over
// k, whole or in chunks of 2, 4 or 8 summed in order; each order measured
// against torch.matmul on the card).  So on the card the stage's outputs
// equal the plain version's bit for bit (tests/test_torch_cuda.py,
// chip_smoke.py phase `imu`), and the filter downstream takes the plain
// version's path: the f32 filter's start on a near-empty map turns
// one-ulp differences of P into centimetres.  Another PyTorch or cuBLAS
// may order its products otherwise; the results then differ by rounding.
// The CPU rounds otherwise and is held to tolerances.
//
// Design: one launch, 1 + ceil(n / 512) blocks of 512 threads.
//   * Every block first computes the scan's mean chain in shared memory:
//     the midpoint rates, the quaternion prefix product in the plain
//     version's log-step order, the velocity and position sums (one
//     thread a column, in order, as torch's cumsum over the outer
//     dimension), the recorded rates' forward fill and the final hop to
//     the scan end.  It is ~M intervals of arithmetic, and the same code on
//     the same inputs gives the same bits in every block: no grid-wide
//     barrier and no second launch hands the poses to the undistortion.
//   * Blocks 1.. undistort 512 rows each against the poses in shared
//     memory.
//   * Block 0 (scheduled first) builds the blocks of each interval's
//     transition F and noise map Fw as predict_jacobians does, one thread
//     an interval, and composes the covariance as the plain version does:
//     each interval's (F, G = Fw Q Fw^T) a leaf of a binary tree of
//     (F2, G2) o (F1, G1) = (F2 F1, F2 G1 F2^T + G2), identity-padded to a
//     power of two (a pad is an exact no-op, so the tree is built as a
//     binary counter over the leaves: a stack of open subtrees, joined at
//     the end latest first), then P_end = F P F^T + G and the final hop's
//     step as predict does.  23x23 tiles in shared memory, one entry a
//     thread, a barrier after each product.  Then it writes P, the final
//     state and the poses.
// The kernel allocates nothing and keeps no state between launches: it
// sits in a captured CUDA graph as one kernel node.  No atomics, so two
// runs give the same bits.  Never build this file with --use_fast_math.
//
// Bound.  Bytes: at n = 32768, 16 B a row in (point, time) and 12 B out:
// 0.92 MB, 0.27 us at 3.35 TB/s.  Operations: ~0.07 MFLOP a leaf and
// ~0.05 MFLOP a join as dense products (~2 M of them) and ~150 flop a row,
// under 0.1 us at 67 TFLOP/s f32.  What bounds the call is the
// covariance's serial latency: ~4 M dependent 23x23 products, each behind
// a block barrier, in the one block that composes P, after the mean chain.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kErr = 23;       // error-state dimension
constexpr int kErr2 = kErr * kErr;
constexpr int kNoise = 12;     // [ng, na, nbg, nba]
constexpr int kFw = kErr * kNoise;
constexpr int kMaxM = 128;     // most IMU rows a scan the kernel takes
constexpr int kLevels = 8;     // open subtrees of the tree at K < 2^8 leaves
constexpr int kPool = 2 * kLevels + 6;  // 23x23 tiles of the tree and hop
constexpr int kStateOut = 26;  // pos 3 rot 4 off_r 4 off_t 3 vel bg ba grav
constexpr int kXs = 40;        // x_fin and the final hop's inputs
constexpr int kBlk = 44;       // a covariance step's blocks (step_blocks)
constexpr int kS2 = 10;        // Mx (3x2) and NM (2x2) of the gravity chart
constexpr double kGravity = 9.809;       // utils/s2.py GRAVITY
constexpr double kSmallSq = 1e-6;        // utils/so3.py _SMALL_SQ
constexpr double kS2Tol = 1e-7;          // utils/s2.py _TOL

// Shared-memory T values of a block at M IMU rows: 42 M of chain and
// poses, x_fin, then block 0's covariance: M steps' blocks, P, F P, Fw Q,
// Q, the gravity chart's blocks (batched and 2D orders) and the tiles.
__host__ __device__ constexpr int smem_values(int M) {
  return 42 * M + kXs + kBlk * M + 2 * kErr2 + kFw + kNoise * kNoise
         + 2 * kS2 + kPool * kErr2;
}

template <typename T>
struct Args {
  const T* pos; const T* rot; const T* off_r; const T* off_t;
  const T* vel; const T* bg; const T* ba; const T* grav;
  const T* P; const T* Q;
  const T* acc_norm; const T* last_end; const T* scan_end;
  const T* last_acc_w; const T* last_gyr_b;
  const T* acc; const T* gyr; const T* t; const uint8_t* mask;
  const T* pts; const T* pt_t;
  T* out; T* pts_out;
  int M, n, s_acc, s_gyr, s_t, s_mask;
};

constexpr int kPtrs = 23;  // pointers of Args, in order

// ---- so3 / s2 (utils/so3.py, utils/s2.py), one element -----------------

// the accurate libm functions of each type (no intrinsics: no fast math)
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double m_fma(double a, double b, double c) {
  return fma(a, b, c);
}

// x / c for a constant c, as PyTorch divides a CUDA tensor by a Python
// scalar: a product with the reciprocal, taken in double and rounded to T
template <typename T>
__device__ __forceinline__ T div_c(T x, double c) {
  return x * T(1.0 / c);
}

// v0^2 + v1^2 + v2^2 in torch.sum's order over the last axis
template <typename T>
__device__ __forceinline__ T sumsq3(const T* v) {
  return (v[0] * v[0] + v[2] * v[2]) + v[1] * v[1];
}

// Sum over m < k of x(m) y(m) in the order cuBLAS takes for the product
// this stands for: fused multiply-add chains over `chunk` consecutive m
// (chunk >= k: one chain), the chains summed in order.
constexpr int kWhole = 1 << 20;  // one chain: the batched products

template <typename T, typename X, typename Y>
__device__ __forceinline__ T dot(X x, Y y, int k, int chunk) {
  T acc = T(0);
  for (int c0 = 0; c0 < k; c0 += chunk) {
    const int c1 = k - c0 < chunk ? k : c0 + chunk;
    T p = x(c0) * y(c0);
    for (int m = c0 + 1; m < c1; ++m) p = m_fma(x(m), y(m), p);
    acc = c0 == 0 ? p : acc + p;
  }
  return acc;
}

// dot with k and the chunk known at compile time (0: one chain), unrolled
template <int K, int CHUNK, typename T, typename X, typename Y>
__device__ __forceinline__ T dotk(X x, Y y) {
  constexpr int C = CHUNK == 0 ? K : CHUNK;
  T acc = T(0);
#pragma unroll
  for (int c0 = 0; c0 < K; c0 += C) {
    T p = x(c0) * y(c0);
#pragma unroll
    for (int m = c0 + 1; m < (K - c0 < C ? K : c0 + C); ++m)
      p = m_fma(x(m), y(m), p);
    acc = c0 == 0 ? p : acc + p;
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;  // a NaN stays NaN, as torch.clamp
}

template <typename T>
__device__ __forceinline__ void cos_sinc_sqrt(T x2, T& c, T& s) {
  const T small = T(kSmallSq);
  const T x = m_sqrt(clamp_min(x2, small));
  if (x2 < small) {
    c = T(1) - div_c(x2, 2.0) + div_c(x2 * x2, 24.0);
    s = T(1) - div_c(x2, 6.0) + div_c(x2 * x2, 120.0);
  } else {
    c = m_cos(x);
    s = m_sin(x) / x;
  }
}

// quat_exp(v, scale): [cos, sinc * half * v] with half = 0.5 * scale
template <typename T>
__device__ __forceinline__ void quat_exp(const T* v, T half, T* q) {
  const T n2 = sumsq3(v);
  T c, s;
  cos_sinc_sqrt(half * half * n2, c, s);
  const T sh = s * half;
  q[0] = c;
  q[1] = sh * v[0];
  q[2] = sh * v[1];
  q[3] = sh * v[2];
}

template <typename T>
__device__ __forceinline__ void quat_mul(const T* q, const T* p, T* o) {
  const T w = q[0] * p[0] - q[1] * p[1] - q[2] * p[2] - q[3] * p[3];
  const T x = q[0] * p[1] + q[1] * p[0] + q[2] * p[3] - q[3] * p[2];
  const T y = q[0] * p[2] - q[1] * p[3] + q[2] * p[0] + q[3] * p[1];
  const T z = q[0] * p[3] + q[1] * p[2] - q[2] * p[1] + q[3] * p[0];
  o[0] = w;
  o[1] = x;
  o[2] = y;
  o[3] = z;
}

template <typename T>
__device__ __forceinline__ void quat_normalize(T* q) {
  const T nrm = m_sqrt((q[0] * q[0] + q[2] * q[2])
                       + (q[1] * q[1] + q[3] * q[3]));
  q[0] = q[0] / nrm;
  q[1] = q[1] / nrm;
  q[2] = q[2] / nrm;
  q[3] = q[3] / nrm;
}

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// R(q) v, or R(q)^T v with `inv` (the conjugate's rotation)
template <typename T>
__device__ __forceinline__ void quat_rotate(const T* q, const T* v, T* o,
                                            bool inv = false) {
  const T s = inv ? T(-1) : T(1);
  const T qv[3] = {s * q[1], s * q[2], s * q[3]};
  T t[3], c[3];
  cross(qv, v, t);
  t[0] = T(2) * t[0];
  t[1] = T(2) * t[1];
  t[2] = T(2) * t[2];
  cross(qv, t, c);
  o[0] = v[0] + q[0] * t[0] + c[0];
  o[1] = v[1] + q[0] * t[1] + c[1];
  o[2] = v[2] + q[0] * t[2] + c[2];
}

template <typename T>
__device__ __forceinline__ void hat(const T* v, T* K) {
  K[0] = T(0);  K[1] = -v[2]; K[2] = v[1];
  K[3] = v[2];  K[4] = T(0);  K[5] = -v[0];
  K[6] = -v[1]; K[7] = v[0];  K[8] = T(0);
}

// C (r x c) = A (r x k) B (k x c), row-major, in the order `chunk`
// (dot); A is read transposed, a (k x r) array, with `at`
template <typename T>
__device__ __forceinline__ void matmul(const T* A, const T* B, T* C, int r,
                                       int k, int c, int chunk,
                                       bool at = false) {
  for (int i = 0; i < r; ++i)
    for (int j = 0; j < c; ++j)
      C[i * c + j] = dot<T>(
          [&](int m) { return at ? A[m * r + i] : A[i * k + m]; },
          [&](int m) { return B[m * c + j]; }, k, chunk);
}

// so3_exp_matrix (a_matrix false) or A_matrix (true) of v; K K in the
// order `chunk`
template <typename T>
__device__ void so3_matrix(const T* v, bool a_matrix, T* out, int chunk) {
  const T small = T(kSmallSq);
  const T n2 = sumsq3(v);
  T K[9], KK[9];
  hat(v, K);
  matmul(K, K, KK, 3, 3, 3, chunk);
  T c, s;
  cos_sinc_sqrt(n2, c, s);
  const T omc = n2 < small ? T(0.5) - div_c(n2, 24.0)
                           : (T(1) - c) / clamp_min(n2, small);
  T k1, k2;
  if (a_matrix) {
    k1 = omc;
    k2 = n2 < small ? T(1.0 / 6.0) - div_c(n2, 120.0)
                    : (T(1) - s) / clamp_min(n2, small);
  } else {
    k1 = s;
    k2 = omc;
  }
  for (int i = 0; i < 9; ++i)
    out[i] = ((i % 4 == 0) ? T(1) : T(0)) + k1 * K[i] + k2 * KK[i];
}

template <typename T>
__device__ void quat_to_matrix(const T* q, T* R) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  R[0] = ww + xx - yy - zz; R[1] = T(2) * (xy - wz); R[2] = T(2) * (xz + wy);
  R[3] = T(2) * (xy + wz); R[4] = ww - xx + yy - zz; R[5] = T(2) * (yz - wx);
  R[6] = T(2) * (xz - wy); R[7] = T(2) * (yz + wx); R[8] = ww - xx - yy + zz;
}

// Mx = s2_mx(grav, 0) (3x2) and NM = s2_nx_yy(grav) @ Mx (2x2): the
// gravity chart's blocks of F, the same in every step of a scan; in the
// orders of the batched products of the intervals (`batched`) or of the
// final hop's 2D ones
template <typename T>
__device__ void s2_blocks(const T* g, T* Mx, T* NM, bool batched) {
  const T L = T(kGravity), tol = T(kS2Tol);
  const T x = g[0], y = g[1], z = g[2];
  T Bx[6];
  if (x + L <= tol) {
    Bx[0] = T(0); Bx[1] = T(0);
    Bx[2] = T(0); Bx[3] = T(-1);
    Bx[4] = T(1); Bx[5] = T(0);
  } else {
    const T den = m_abs(x + L) < tol ? T(1) : x + L;
    Bx[0] = div_c(-y, kGravity);
    Bx[1] = div_c(-z, kGravity);
    Bx[2] = div_c(L - y * y / den, kGravity);
    Bx[3] = div_c(-z * y / den, kGravity);
    Bx[4] = div_c(-z * y / den, kGravity);
    Bx[5] = div_c(L - z * z / den, kGravity);
  }
  const int chunk = batched ? kWhole : 2;
  T H[9], HB[6], BtH[6];
  hat(g, H);
  matmul(H, Bx, HB, 3, 3, 2, chunk);
  for (int i = 0; i < 6; ++i) Mx[i] = -HB[i];
  matmul(Bx, H, BtH, 2, 3, 3, kWhole, true);  // Bx^T H: one chain
  for (int i = 0; i < 6; ++i) BtH[i] = div_c(BtH[i], kGravity * kGravity);
  matmul(BtH, Mx, NM, 2, 3, 2, chunk);
}

// The blocks of one covariance step's F and Fw (predict_jacobians; the
// step starts at rotation `rot` with rates acc, gyr over dt), into b:
// E = Exp(seg) 0:9, (-A(seg)) dt 9:18, ((-R) hat(acc - ba)) dt 18:27,
// (-R) dt 27:36, Mx dt 36:42, dt 42, with seg = -(gyr - bg) dt.  F is the
// identity but for rows 0:3 (dt at 12:15), 3:6 (E at 3:6, (-A) dt at
// 15:18), 12:15 (the third, fourth and fifth blocks at 3:6, 18:21,
// 21:23) and 21:23 (NM at 21:23); Fw is zero but for (-A) dt at rows 3:6,
// cols 0:3, (-R) dt at 12:15, 3:6, and dt on the diagonals of rows 15:18,
// cols 6:9 and rows 18:21, cols 9:12.
// The 3x3 products take `chunk`'s order (the intervals' batched products,
// or the final hop's 2D ones).
template <typename T>
__device__ void step_blocks(const T* rot, const T* acc, const T* gyr, T dt,
                            const T* bg, const T* ba, const T* Mx, T* b,
                            int chunk) {
  T seg[3], ab[3], H[9], R[9], A[9], RH[9];
  for (int c = 0; c < 3; ++c) {
    seg[c] = -(gyr[c] - bg[c]) * dt;
    ab[c] = acc[c] - ba[c];
  }
  so3_matrix(seg, false, b, chunk);
  so3_matrix(seg, true, A, chunk);
  quat_to_matrix(rot, R);
  for (int i = 0; i < 9; ++i) R[i] = -R[i];
  hat(ab, H);
  matmul(R, H, RH, 3, 3, 3, chunk);
  for (int i = 0; i < 9; ++i) {
    b[9 + i] = -A[i] * dt;
    b[18 + i] = RH[i] * dt;
    b[27 + i] = R[i] * dt;
  }
  for (int i = 0; i < 6; ++i) b[36 + i] = Mx[i] * dt;
  b[42] = dt;
}

// F[r][c] of a step (F_x1 + fx_err dt) from its blocks and NM
template <typename T>
__device__ __forceinline__ T f_entry(const T* b, const T* NM, int r, int c) {
  if (r < 3) return c == 12 + r ? b[42] : T(r == c ? 1 : 0);
  if (r < 6) {
    if (c >= 3 && c < 6) return b[(r - 3) * 3 + c - 3];
    if (c >= 15 && c < 18) return b[9 + (r - 3) * 3 + c - 15];
    return T(0);
  }
  if (r >= 12 && r < 15) {
    if (c >= 3 && c < 6) return b[18 + (r - 12) * 3 + c - 3];
    if (c >= 18 && c < 21) return b[27 + (r - 12) * 3 + c - 18];
    if (c >= 21) return b[36 + (r - 12) * 2 + c - 21];
  }
  if (r >= 21) return c >= 21 ? NM[(r - 21) * 2 + c - 21] : T(0);
  return T(r == c ? 1 : 0);
}

// Fw[r][j] of a step (fw_err dt) from its blocks
template <typename T>
__device__ __forceinline__ T fw_entry(const T* b, int r, int j) {
  if (r >= 3 && r < 6) return j < 3 ? b[9 + 3 * (r - 3) + j] : T(0);
  if (r >= 12 && r < 15)
    return j >= 3 && j < 6 ? b[27 + 3 * (r - 12) + j - 3] : T(0);
  if (r >= 15 && r < 21) return j == r - 9 ? b[42] : T(0);
  return T(0);
}

// ---- the kernel -----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
imu_stage_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int M = a.M, K = M - 1, tid = threadIdx.x;
  // poses, in the order of the output: t, pos, vel, rot, acc_w, gyr_b
  T* const pt = sm;
  T* const pp = pt + M;
  T* const pv = pp + 3 * M;
  T* const pq = pv + 3 * M;
  T* const paw = pq + 4 * M;
  T* const pgb = paw + 3 * M;
  // per interval
  T* const dts = pgb + 3 * M;
  T* const accs = dts + M;    // scaled midpoint accel (acc_all)
  T* const gyrs = accs + 3 * M;  // midpoint gyro (gyr_all)
  T* const qa = gyrs + 3 * M;
  T* const qb = qa + 4 * M;
  T* const ws = qb + 4 * M;   // world accel at the interval start * dt
  T* const awall = ws + 3 * M;
  T* const gball = awall + 3 * M;
  T* const okf = gball + 3 * M;
  T* const xs = okf + M;      // x_fin 0:26, dt_tail 26, acc 27:30, gyr 30:33
  // block 0's covariance
  T* const blk = xs + kXs;    // step k's blocks at kBlk k (step_blocks)
  T* const Pm = blk + kBlk * M;
  T* const Tm = Pm + kErr2;   // F P
  T* const FwQ = Tm + kErr2;
  T* const Qs = FwQ + kFw;
  T* const s2 = Qs + kNoise * kNoise;  // Mx 0:6, NM 6:10, intervals'
  T* const s2h = s2 + kS2;             // and the final hop's
  T* const tiles = s2h + kS2;          // kPool tiles
  const bool cov_block = blockIdx.x == 0;

  T xrot[4], xpos[3], xvel[3], bg[3], ba[3], grav[3];
  for (int c = 0; c < 3; ++c) {
    xpos[c] = a.pos[c];
    xvel[c] = a.vel[c];
    bg[c] = a.bg[c];
    ba[c] = a.ba[c];
    grav[c] = a.grav[c];
  }
  for (int c = 0; c < 4; ++c) xrot[c] = a.rot[c];
  const T an = *a.acc_norm;
  // GRAVITY / tensor: Tensor.__rtruediv__, a reciprocal times 9.809
  const T g_scale = (T(1) / clamp_min(an, T(1e-6))) * T(kGravity);
  const T last_end = *a.last_end;
  const T zero = T(0);

  // 1. each interval's rates, dt and rotation increment
  for (int i = tid; i < K; i += blockDim.x) {
    const bool ok = a.mask[i * a.s_mask] && a.mask[(i + 1) * a.s_mask];
    const T* a0 = a.acc + i * a.s_acc;
    const T* a1 = a0 + a.s_acc;
    const T* g0 = a.gyr + i * a.s_gyr;
    const T* g1 = g0 + a.s_gyr;
    T om[3];
    for (int c = 0; c < 3; ++c) {
      accs[3 * i + c] = (T(0.5) * (a0[c] + a1[c])) * g_scale;
      gyrs[3 * i + c] = T(0.5) * (g0[c] + g1[c]);
      om[c] = gyrs[3 * i + c] - bg[c];
    }
    const T ti = a.t[i * a.s_t], tn = a.t[(i + 1) * a.s_t];
    const T t0 = clamp_min(ti, last_end);
    const T tt_safe = ok ? tn : zero, t0_safe = ok ? t0 : zero;
    const T dt = (ok && tt_safe > t0_safe) ? tt_safe - t0_safe : zero;
    dts[i] = dt;
    okf[i] = ok ? T(1) : zero;
    quat_exp(om, T(0.5) * dt, qa + 4 * i);
  }
  if (cov_block) {
    if (tid == 0) {
      s2_blocks(grav, s2, s2 + 6, true);
      s2_blocks(grav, s2h, s2h + 6, false);
    }
    for (int e = tid; e < kErr2; e += blockDim.x) Pm[e] = a.P[e];
    for (int e = tid; e < kNoise * kNoise; e += blockDim.x) Qs[e] = a.Q[e];
  }
  __syncthreads();

  // 2. inclusive prefix product, log-step as _prefix_quat_product
  T* src = qa;
  T* dst = qb;
  for (int step = 1; step < K; step *= 2) {
    for (int i = tid; i < K; i += blockDim.x) {
      if (i >= step) {
        quat_mul(src + 4 * (i - step), src + 4 * i, dst + 4 * i);
      } else {
        for (int c = 0; c < 4; ++c) dst[4 * i + c] = src[4 * i + c];
      }
    }
    __syncthreads();
    T* const tmp = src;
    src = dst;
    dst = tmp;
  }

  // 3. rotations after each interval; pose 0 is the incoming state
  for (int i = tid; i < K; i += blockDim.x) {
    T* q = pq + 4 * (i + 1);
    quat_mul(xrot, src + 4 * i, q);
    quat_normalize(q);
  }
  if (tid == 0) {
    pt[0] = zero;
    for (int c = 0; c < 3; ++c) {
      pp[c] = xpos[c];
      pv[c] = xvel[c];
      paw[c] = a.last_acc_w[c];
      pgb[c] = a.last_gyr_b[c];
    }
    for (int c = 0; c < 4; ++c) pq[c] = xrot[c];
  }
  __syncthreads();

  // 4. world accelerations at each interval's start (integrated) and end
  // (recorded), body rates, pose times
  for (int i = tid; i < K; i += blockDim.x) {
    T ab[3], w[3];
    for (int c = 0; c < 3; ++c) ab[c] = accs[3 * i + c] - ba[c];
    quat_rotate(pq + 4 * i, ab, w);
    for (int c = 0; c < 3; ++c) ws[3 * i + c] = (w[c] + grav[c]) * dts[i];
    quat_rotate(pq + 4 * (i + 1), ab, w);
    for (int c = 0; c < 3; ++c) {
      awall[3 * i + c] = w[c] + grav[c];
      gball[3 * i + c] = gyrs[3 * i + c] - bg[c];
    }
    pt[i + 1] = okf[i] != zero ? a.t[(i + 1) * a.s_t] : T(INFINITY);
    if (cov_block)  // the interval's step starts at its start rotation
      step_blocks(pq + 4 * i, accs + 3 * i, gyrs + 3 * i, dts[i], bg, ba,
                  s2, blk + kBlk * i, kWhole);
  }
  __syncthreads();

  // 5. velocity and position sums, one column a thread, in order;
  // recorded rates forward-filled from the preceding valid interval
  for (int c = tid; c < 3; c += blockDim.x) {
    T s = zero;
    for (int i = 0; i < K; ++i) {
      s = s + ws[3 * i + c];
      pv[3 * (i + 1) + c] = xvel[c] + s;
    }
    s = zero;
    for (int i = 0; i < K; ++i) {
      s = s + pv[3 * i + c] * dts[i];
      pp[3 * (i + 1) + c] = xpos[c] + s;
    }
  }
  for (int i = tid; i < K; i += blockDim.x) {
    int f = i;
    while (f >= 0 && okf[f] == zero) --f;
    for (int c = 0; c < 3; ++c) {
      paw[3 * (i + 1) + c] = f >= 0 ? awall[3 * f + c] : a.last_acc_w[c];
      pgb[3 * (i + 1) + c] = f >= 0 ? gball[3 * f + c] : a.last_gyr_b[c];
    }
  }
  __syncthreads();

  // 6. the final hop to the scan end (predict's mean) with the last
  // sample's rates
  if (tid == 0) {
    int count = 0;
    for (int i = 0; i < M; ++i) count += a.mask[i * a.s_mask] ? 1 : 0;
    const int last = count - 1;
    const int li = last < 0 ? last + M : last;
    const int pi = last - 1 < 0 ? 0 : last - 1;
    T last_t = zero;  // pose 0's time, then the valid poses'
    for (int i = 0; i < K; ++i)
      if (okf[i] != zero && pt[i + 1] > last_t) last_t = pt[i + 1];
    const T d = *a.scan_end - last_t;
    const T dt = d < zero ? zero : d;
    T acc_l[3], gyr_l[3], om[3], ab[3], ain[3], e[4], q[4];
    for (int c = 0; c < 3; ++c) {
      acc_l[c] = (T(0.5) * (a.acc[pi * a.s_acc + c] + a.acc[li * a.s_acc + c]))
                 * g_scale;
      gyr_l[c] = T(0.5) * (a.gyr[pi * a.s_gyr + c] + a.gyr[li * a.s_gyr + c]);
      om[c] = gyr_l[c] - bg[c];
      ab[c] = acc_l[c] - ba[c];
    }
    const T* erot = pq + 4 * K;
    const T* epos = pp + 3 * K;
    const T* evel = pv + 3 * K;
    quat_rotate(erot, ab, ain);
    for (int c = 0; c < 3; ++c) {
      xs[c] = epos[c] + dt * evel[c];                    // pos
      xs[14 + c] = evel[c] + dt * (ain[c] + grav[c]);    // vel
      xs[11 + c] = a.off_t[c] + dt * zero;               // off_t
      xs[17 + c] = bg[c] + dt * zero;                    // bg
      xs[20 + c] = ba[c] + dt * zero;                    // ba
    }
    quat_exp(om, T(0.5) * dt, e);
    quat_mul(erot, e, q);
    quat_normalize(q);
    for (int c = 0; c < 4; ++c) xs[3 + c] = q[c];        // rot
    const T z3[3] = {zero, zero, zero};
    quat_exp(z3, T(0.5) * dt, e);
    T off_r[4];
    for (int c = 0; c < 4; ++c) off_r[c] = a.off_r[c];
    quat_mul(off_r, e, q);
    quat_normalize(q);
    for (int c = 0; c < 4; ++c) xs[7 + c] = q[c];        // off_r
    quat_rotate(e, grav, xs + 23);                       // grav
    xs[26] = dt;
    for (int c = 0; c < 3; ++c) {
      xs[27 + c] = acc_l[c];
      xs[30 + c] = gyr_l[c];
    }
    if (cov_block)  // the final hop starts at the last pose's rotation
      step_blocks(erot, acc_l, gyr_l, dt, bg, ba, s2h, blk + kBlk * K, 2);
  }
  __syncthreads();

  if (blockIdx.x > 0) {
    // 7. undistortion of this block's rows to the scan-end lidar frame
    const int r = (blockIdx.x - 1) * blockDim.x + tid;
    if (r >= a.n) return;
    const T tp = a.pt_t[r];
    int lo = 0, hi = M;  // torch.searchsorted(right=True)
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(pt[mid] > tp)) lo = mid + 1;
      else hi = mid;
    }
    int idx = lo - 1;
    idx = idx < 0 ? 0 : (idx > M - 2 ? M - 2 : idx);
    const T dd = tp - pt[idx];
    const T dt = dd < zero ? zero : dd;
    T v[3], e[4], qi[4], p[3], pi[3], pw[3], u[3];
    for (int c = 0; c < 3; ++c) v[c] = pgb[3 * (idx + 1) + c] * dt;
    quat_exp(v, T(0.5), e);
    quat_mul(pq + 4 * idx, e, qi);
    for (int c = 0; c < 3; ++c) p[c] = a.pts[3 * (size_t)r + c];
    quat_rotate(xs + 7, p, pi);
    for (int c = 0; c < 3; ++c) pi[c] = pi[c] + xs[11 + c];
    quat_rotate(qi, pi, pw);
    for (int c = 0; c < 3; ++c)
      u[c] = pw[c] + pp[3 * idx + c] + pv[3 * idx + c] * dt
             + T(0.5) * paw[3 * (idx + 1) + c] * dt * dt - xs[c];
    quat_rotate(xs + 3, u, pw, true);
    for (int c = 0; c < 3; ++c) u[c] = pw[c] - xs[11 + c];
    quat_rotate(xs + 7, u, pw, true);
    for (int c = 0; c < 3; ++c) a.pts_out[3 * (size_t)r + c] = pw[c];
    return;
  }

  // 8. block 0: the covariance as the plain version composes it (the
  // header), every product in cuBLAS's order for the plain version's call:
  // the intervals' leaves and the tree's levels are batched (one chain),
  // its root a 2D product of one (chunks of 8, then 4 for the transposed
  // right operand), P_end and the final hop 2D; Fw Q folds the batch into
  // a 2D product (chunks of 4).
  int pool[kPool], n_free = kPool;  // free tiles (the same in every thread)
  for (int i = 0; i < kPool; ++i) pool[i] = i;
  auto take = [&]() { return tiles + kErr2 * pool[--n_free]; };
  auto give = [&](T* t) {
    pool[n_free++] = static_cast<int>((t - tiles) / kErr2);
  };
  T* stF[kLevels];
  T* stG[kLevels];
  int stL[kLevels], top = 0, joins = 0;
  T *cF = nullptr, *cG = nullptr;
  // (cF, cG) <- (Fa, Ga) o (cF, cG): the current subtree is the later one
  auto join = [&](T* Fa, T* Ga) {
    const bool root = ++joins == K - 1;
    T* const F1 = take();
    T* const T2 = take();
    for (int e = tid; e < 2 * kErr2; e += blockDim.x) {
      const int f = e % kErr2;
      const T* const Ar = cF + (f / kErr) * kErr;
      const T* const Bc = (e < kErr2 ? Fa : Ga) + f % kErr;
      auto x = [&](int m) { return Ar[m]; };
      auto y = [&](int m) { return Bc[m * kErr]; };
      (e < kErr2 ? F1 : T2)[f] = root ? dotk<kErr, 8, T>(x, y)
                                      : dotk<kErr, 0, T>(x, y);
    }
    __syncthreads();
    for (int e = tid; e < kErr2; e += blockDim.x) {
      const T* const Ar = T2 + (e / kErr) * kErr;
      const T* const Br = cF + (e % kErr) * kErr;
      auto x = [&](int m) { return Ar[m]; };
      auto y = [&](int m) { return Br[m]; };
      cG[e] = (root ? dotk<kErr, 4, T>(x, y) : dotk<kErr, 0, T>(x, y))
              + cG[e];
    }
    __syncthreads();
    give(T2);
    give(cF);
    give(Fa);
    give(Ga);
    cF = F1;
  };
  for (int k = 0; k < K; ++k) {  // the leaves
    const T* b = blk + kBlk * k;
    cF = take();
    cG = take();
    for (int e = tid; e < kErr2 + kFw; e += blockDim.x) {
      if (e < kErr2) {
        cF[e] = f_entry(b, s2 + 6, e / kErr, e % kErr);
      } else {  // Fw Q
        const int f = e - kErr2, r = f / kNoise, c = f % kNoise;
        FwQ[f] = dotk<kNoise, 4, T>([&](int j) { return fw_entry(b, r, j); },
                                    [&](int j) { return Qs[j * kNoise + c]; });
      }
    }
    __syncthreads();
    for (int e = tid; e < kErr2; e += blockDim.x) {  // (Fw Q) Fw^T
      const int r = e / kErr, c = e % kErr;
      cG[e] = dotk<kNoise, 0, T>([&](int j) { return FwQ[r * kNoise + j]; },
                                 [&](int j) { return fw_entry(b, c, j); });
    }
    __syncthreads();
    int lvl = 0;
    for (; top > 0 && stL[top - 1] == lvl; ++lvl) {
      --top;
      join(stF[top], stG[top]);
    }
    stF[top] = cF;
    stG[top] = cG;
    stL[top++] = lvl;
  }
  cF = stF[--top];
  cG = stG[top];
  while (top > 0) {
    --top;
    join(stF[top], stG[top]);
  }
  // P_end = (F P) F^T + G
  for (int e = tid; e < kErr2; e += blockDim.x) {
    const int r = e / kErr, c = e % kErr;
    Tm[e] = dotk<kErr, 8, T>([&](int m) { return cF[r * kErr + m]; },
                             [&](int m) { return Pm[m * kErr + c]; });
  }
  __syncthreads();
  for (int e = tid; e < kErr2; e += blockDim.x) {
    const int r = e / kErr, c = e % kErr;
    Pm[e] = dotk<kErr, 4, T>([&](int m) { return Tm[r * kErr + m]; },
                             [&](int m) { return cF[c * kErr + m]; })
            + cG[e];
  }
  __syncthreads();
  {  // the final hop: ((F P) F^T) + ((Fw Q) Fw^T), 2D products
    const T* b = blk + kBlk * K;
    T* const hF = take();
    T* const hG = take();
    for (int e = tid; e < kErr2 + kFw; e += blockDim.x) {
      if (e < kErr2) {
        hF[e] = f_entry(b, s2h + 6, e / kErr, e % kErr);
      } else {
        const int f = e - kErr2, r = f / kNoise, c = f % kNoise;
        FwQ[f] = dotk<kNoise, 4, T>([&](int j) { return fw_entry(b, r, j); },
                                    [&](int j) { return Qs[j * kNoise + c]; });
      }
    }
    __syncthreads();
    for (int e = tid; e < 2 * kErr2; e += blockDim.x) {
      const int f = e % kErr2, r = f / kErr, c = f % kErr;
      if (e < kErr2) {
        Tm[f] = dotk<kErr, 8, T>([&](int m) { return hF[r * kErr + m]; },
                                 [&](int m) { return Pm[m * kErr + c]; });
      } else {
        hG[f] = dotk<kNoise, 4, T>(
            [&](int j) { return FwQ[r * kNoise + j]; },
            [&](int j) { return fw_entry(b, c, j); });
      }
    }
    __syncthreads();
    for (int e = tid; e < kErr2; e += blockDim.x) {
      const int r = e / kErr, c = e % kErr;
      Pm[e] = dotk<kErr, 4, T>([&](int m) { return Tm[r * kErr + m]; },
                               [&](int m) { return hF[c * kErr + m]; })
              + hG[e];
    }
    __syncthreads();
  }
  for (int e = tid; e < kErr2; e += blockDim.x) a.out[e] = Pm[e];
  for (int e = tid; e < kStateOut; e += blockDim.x) a.out[kErr2 + e] = xs[e];
  for (int e = tid; e < 17 * M; e += blockDim.x)
    a.out[kErr2 + kStateOut + e] = sm[e];
}

template <typename T>
Args<T> make_args(void* const* p, int M, int n, int s_acc, int s_gyr,
                  int s_t, int s_mask) {
  Args<T> a;
  a.pos = static_cast<const T*>(p[0]);
  a.rot = static_cast<const T*>(p[1]);
  a.off_r = static_cast<const T*>(p[2]);
  a.off_t = static_cast<const T*>(p[3]);
  a.vel = static_cast<const T*>(p[4]);
  a.bg = static_cast<const T*>(p[5]);
  a.ba = static_cast<const T*>(p[6]);
  a.grav = static_cast<const T*>(p[7]);
  a.P = static_cast<const T*>(p[8]);
  a.Q = static_cast<const T*>(p[9]);
  a.acc_norm = static_cast<const T*>(p[10]);
  a.last_end = static_cast<const T*>(p[11]);
  a.scan_end = static_cast<const T*>(p[12]);
  a.last_acc_w = static_cast<const T*>(p[13]);
  a.last_gyr_b = static_cast<const T*>(p[14]);
  a.acc = static_cast<const T*>(p[15]);
  a.gyr = static_cast<const T*>(p[16]);
  a.t = static_cast<const T*>(p[17]);
  a.mask = static_cast<const uint8_t*>(p[18]);
  a.pts = static_cast<const T*>(p[19]);
  a.pt_t = static_cast<const T*>(p[20]);
  a.out = static_cast<T*>(p[21]);
  a.pts_out = static_cast<T*>(p[22]);
  a.M = M;
  a.n = n;
  a.s_acc = s_acc;
  a.s_gyr = s_gyr;
  a.s_t = s_t;
  a.s_mask = s_mask;
  return a;
}

int blocks_for(int n) { return 1 + (n + kThreads - 1) / kThreads; }

template <typename T>
cudaError_t launch(void* const* p, int M, int n, int s_acc, int s_gyr,
                   int s_t, int s_mask, cudaStream_t stream) {
  Args<T> a = make_args<T>(p, M, n, s_acc, s_gyr, s_t, s_mask);
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernel(
      reinterpret_cast<const void*>(imu_stage_kernel<T>),
      dim3(blocks_for(n)), dim3(kThreads), args,
      sizeof(T) * (size_t)smem_values(M), stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

bool g_setup = false;

}  // namespace

extern "C" {

// Allow each instance the dynamic shared memory of kMaxM rows (above the
// default 48 KB for double).  Writes the block size and that many bytes
// (double's).  Returns a cudaError_t.
int imu_stage_setup(int* threads, int* max_smem) {
  const int f = (int)(sizeof(float) * smem_values(kMaxM));
  const int d = (int)(sizeof(double) * smem_values(kMaxM));
  if (!g_setup) {
    cudaError_t e = cudaFuncSetAttribute(
        imu_stage_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        f);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(imu_stage_kernel<double>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d);
    if (e != cudaSuccess) return (int)e;
    g_setup = true;
  }
  *threads = kThreads;
  *max_smem = d;
  return 0;
}

int imu_stage_max_rows() { return kMaxM; }

int imu_stage_pointers() { return kPtrs; }

// ptrs: kPtrs device pointers in the order of Args (every floating one of
// the instance's type; mask bytes 0/1); M IMU rows (2..kMaxM), n point
// rows, the element strides of the IMU rows.  One launch on `stream`;
// imu_stage_setup must have run.  Returns cudaGetLastError() after it.
int imu_stage_launch(void* const* ptrs, int dbl, int M, int n, int s_acc,
                     int s_gyr, int s_t, int s_mask, void* stream) {
  if (!g_setup) return (int)cudaErrorNotReady;
  if (M < 2 || M > kMaxM || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dbl ? launch<double>(ptrs, M, n, s_acc, s_gyr, s_t, s_mask, s)
                   : launch<float>(ptrs, M, n, s_acc, s_gyr, s_t, s_mask, s));
}

// The kernel's handles as a captured CUDA graph's kernel nodes may name it:
// for each instance (float, then double) its function in the current
// context and its context-independent kernel, in func[2] and kern[2].
int imu_stage_handles(void** func, void** kern) {
  const void* syms[2] = {
      reinterpret_cast<const void*>(imu_stage_kernel<float>),
      reinterpret_cast<const void*>(imu_stage_kernel<double>)};
  for (int i = 0; i < 2; ++i) {
    cudaFunction_t f = nullptr;
    cudaKernel_t k = nullptr;
    cudaError_t e = cudaGetFuncBySymbol(&f, syms[i]);
    if (e == cudaSuccess) e = cudaGetKernel(&k, syms[i]);
    func[i] = reinterpret_cast<void*>(f);
    kern[i] = reinterpret_cast<void*>(k);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
