// Condition of a CUDA-graph conditional (IF) node, set on the device.
//
// The JAX reference's lax.cond / lax.while_loop compile to device-side
// Conditional and While ops: the device reads the predicate and runs the
// branch it picks.  Their counterpart in a captured CUDA graph is a
// conditional node, whose condition a kernel inside the graph sets right
// before the node from a device scalar (utils/device.py:if_node captures
// this kernel, the node and the body through the driver API).  One thread
// reads one bool and calls cudaGraphSetConditional: the launch is the
// whole cost (no bytes or operations to speak of).  With the step's trace
// on (utils/trace.py), `counter` (else null) is the node's count of bodies
// taken: the kernel adds the condition it sets, so the count costs no node
// of its own.

#include <cuda_runtime.h>

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred, int negate,
                                     long long* counter) {
  const unsigned int take = (*pred) != (negate != 0) ? 1u : 0u;
  cudaGraphSetConditional(handle, take);
  if (counter != nullptr) *counter += take;
}

extern "C" int graph_conditional_set(unsigned long long handle,
                                     const void* pred, int negate,
                                     void* counter, void* stream) {
  set_condition_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const bool*>(pred), negate,
      static_cast<long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}
