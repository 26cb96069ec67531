// A host stand-in for the CUDA runtime header, for the CPU tests only
// (tests/test_torch_imu_stage.py): with it g++ compiles a kernel source of
// better_fastlio2_tpu_torch/csrc as plain C++, and a harness runs each
// block of the grid in turn with one thread (blockDim 1), barriers as
// no-ops.  That holds the kernel's arithmetic against the plain PyTorch
// version without a GPU; it says nothing of the kernel's speed or of its
// threads' interplay, which the cuda-marked tests check on the card.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};

static uint3 threadIdx = {0, 0, 0};
static uint3 blockIdx = {0, 0, 0};
static dim3 blockDim(1, 1, 1);

inline void __syncthreads() {}

typedef int cudaError_t;
typedef void* cudaStream_t;
typedef void* cudaFunction_t;
typedef void* cudaKernel_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotReady = 600 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t,
                                    cudaStream_t) {
  return cudaErrorNotReady;  // the harness calls the kernel itself
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetFuncBySymbol(cudaFunction_t*, const void*) {
  return cudaErrorNotReady;
}
inline cudaError_t cudaGetKernel(cudaKernel_t*, const void*) {
  return cudaErrorNotReady;
}
