// Device stamps and the trace row of one scan (utils/trace.py).
//
// A span of the step (lio.scan, lio.imu, ..., lio.update.pass) starts and
// ends at a stamp: a one-thread kernel that writes %globaltimer (ns) into
// its slot of the scan's stamp row.  A kernel, and not a CUDA event, so
// that a stamp can sit inside the body of a CUDA-graph conditional node,
// which takes kernel nodes but no event-record node; a body that does not
// run leaves its stamps unwritten.  Each slot is its own template
// instance, so that a profiler names every stamp's record by its slot
// (`trace_stamp<5>`).  The scan's first stamp (`reset` > 0) also clears
// the row (0 reads as "absent") and snapshots the trace's counters, so
// that a scan reads its own counts.  `pred` (may be null) guards the stamp
// on a device bool: the select form of a gate (eager ticks, the CPU)
// stamps only where the conditional node would have run.
//
// trace_mark stamps one place outside the graph: the pipeline launches it
// right before a scan's input copy and graph launch, so that the scan's
// record shows when the device could start on the scan.
//
// trace_readout turns the row into the f32 values the scan's one readback
// carries: the first stamp as three exact 21-bit pieces, every stamp in
// microseconds from the first (NaN where absent), each counter's count
// since the first stamp, and the mark in microseconds from the first
// stamp.

#include <cuda_runtime.h>

#include <array>
#include <utility>

namespace {

constexpr int kSlots = 64;
constexpr int kReadoutThreads = 128;

template <int S>
__global__ void trace_stamp(unsigned long long* row, const bool* pred,
                            int reset, const long long* counters,
                            long long* start, int n_counters) {
  if (reset > 0) {
    for (int i = 0; i < reset; ++i) row[i] = 0ull;
    for (int i = 0; i < n_counters; ++i) start[i] = counters[i];
  }
  if (pred != nullptr && !*pred) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  row[S] = t;
}

using StampFn = void (*)(unsigned long long*, const bool*, int,
                         const long long*, long long*, int);

template <int... S>
constexpr std::array<StampFn, sizeof...(S)> stamp_table(
    std::integer_sequence<int, S...>) {
  return {{&trace_stamp<S>...}};
}

const std::array<StampFn, kSlots> kStamps =
    stamp_table(std::make_integer_sequence<int, kSlots>{});

__global__ void trace_mark(unsigned long long* at) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *at = t;
}

__device__ float us_from(unsigned long long t, unsigned long long t0) {
  return t != 0ull ? static_cast<float>(static_cast<long long>(t - t0)) * 1e-3f
                   : __int_as_float(0x7fc00000);
}

__global__ void trace_readout(const unsigned long long* row, int n_stamps,
                              const long long* counters,
                              const long long* start, int n_counters,
                              const unsigned long long* mark, float* out) {
  const int i = threadIdx.x;
  const unsigned long long t0 = row[0];
  const unsigned long long piece = (1ull << 21) - 1ull;
  if (i < 3) out[i] = static_cast<float>((t0 >> (21 * (2 - i))) & piece);
  for (int s = i; s < n_stamps; s += blockDim.x)
    out[3 + s] = us_from(row[s], t0);
  for (int c = i; c < n_counters; c += blockDim.x)
    out[3 + n_stamps + c] = static_cast<float>(counters[c] - start[c]);
  if (i == 0) out[3 + n_stamps + n_counters] = us_from(*mark, t0);
}

}  // namespace

extern "C" int trace_stamp_slots() { return kSlots; }

extern "C" int trace_stamp_launch(void* row, int slot, const void* pred,
                                  int reset, const void* counters,
                                  void* start, int n_counters, void* stream) {
  if (slot < 0 || slot >= kSlots || reset > kSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* r = static_cast<unsigned long long*>(row);
  auto* p = static_cast<const bool*>(pred);
  auto* c = static_cast<const long long*>(counters);
  auto* s = static_cast<long long*>(start);
  void* args[] = {&r, &p, &reset, &c, &s, &n_counters};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(kStamps[slot]), dim3(1), dim3(1), args,
      0, static_cast<cudaStream_t>(stream)));
}

extern "C" int trace_mark_launch(void* at, void* stream) {
  trace_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(at));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trace_readout_launch(const void* row, int n_stamps,
                                    const void* counters, const void* start,
                                    int n_counters, const void* mark,
                                    void* out, void* stream) {
  trace_readout<<<1, kReadoutThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(row), n_stamps,
      static_cast<const long long*>(counters),
      static_cast<const long long*>(start), n_counters,
      static_cast<const unsigned long long*>(mark),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
