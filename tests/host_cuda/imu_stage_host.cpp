// Host build of better_fastlio2_tpu_torch/csrc/imu_stage.cu for the CPU
// tests (tests/test_torch_imu_stage.py), against the stand-in
// cuda_runtime.h beside this file, built as
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I tests/host_cuda
//       -DIMU_STAGE_SOURCE='"<path of imu_stage.cu>"'
//       tests/host_cuda/imu_stage_host.cpp -o libimu_stage_host.so
//
// imu_stage_host takes imu_stage_launch's arguments (host pointers) and
// runs every block of the launch's grid in turn with one thread, shared
// memory filled with NaN bytes before each block, so a value read before
// it is written shows in the results.

#include <string.h>

#include "cuda_runtime.h"
#include IMU_STAGE_SOURCE

namespace {

alignas(16) unsigned char smem_raw[1 << 20];

template <typename T>
void run_grid(void* const* ptrs, int M, int n, int s_acc, int s_gyr,
              int s_t, int s_mask) {
  const Args<T> a = make_args<T>(ptrs, M, n, s_acc, s_gyr, s_t, s_mask);
  blockDim = dim3(1, 1, 1);
  threadIdx = {0, 0, 0};
  for (int b = 0; b < 1 + n; ++b) {  // blockDim 1: block b >= 1 is row b-1
    blockIdx = {(unsigned)b, 0, 0};
    memset(smem_raw, 0xff, sizeof(T) * smem_values(M));
    imu_stage_kernel<T>(a);
  }
}

}  // namespace

extern "C" int imu_stage_host(void* const* ptrs, int dbl, int M, int n,
                              int s_acc, int s_gyr, int s_t, int s_mask) {
  if (M < 2 || M > kMaxM || n < 0 || sizeof(double) * smem_values(M) >
                                         sizeof(smem_raw))
    return 1;
  if (dbl)
    run_grid<double>(ptrs, M, n, s_acc, s_gyr, s_t, s_mask);
  else
    run_grid<float>(ptrs, M, n, s_acc, s_gyr, s_t, s_mask);
  return 0;
}
