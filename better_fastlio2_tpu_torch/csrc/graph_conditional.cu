// Condition of a CUDA-graph conditional (IF) node, set on the device.
//
// The JAX reference's lax.cond / lax.while_loop compile to device-side
// Conditional and While ops: the device reads the predicate and runs the
// branch it picks.  Their counterpart in a captured CUDA graph is a
// conditional node, whose condition a kernel inside the graph sets right
// before the node from a device scalar (utils/device.py:if_node captures
// this kernel, the node and the body through the driver API).  One thread
// reads one bool and calls cudaGraphSetConditional: the launch is the
// whole cost (no bytes or operations to speak of).

#include <cuda_runtime.h>

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred, int negate) {
  cudaGraphSetConditional(handle, (*pred) != (negate != 0) ? 1u : 0u);
}

extern "C" int graph_conditional_set(unsigned long long handle,
                                     const void* pred, int negate,
                                     void* stream) {
  set_condition_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const bool*>(pred), negate);
  return static_cast<int>(cudaGetLastError());
}
