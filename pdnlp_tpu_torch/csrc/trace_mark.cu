// Device span marks for the obs tracer (pdnlp_tpu_torch/obs/device.py),
// hand-written CUDA C++.
//
// Replaces no TPU kernel: the JAX package reads its device time from the
// XLA profiler, which splits a jitted step by op.  A captured CUDA graph
// runs no host code at replay, so a host span cannot say where a replay's
// device time goes.  A mark is one kernel of one thread, launched on the
// stream between two pieces of work (and so captured into a graph between
// them): it claims the next slot of a device ring with an atomicAdd on a
// device counter and writes the card's %globaltimer (nanoseconds) and the
// mark's code there.  The slot is claimed on the device, so every replay
// of a captured mark writes a fresh entry; nothing is synchronized to
// write or to read it (the host copies the ring out behind an event).
//
// What bounds it: latency alone.  One thread, one atomic and two 8-byte
// stores; what it costs is the gap a kernel launch leaves between its
// neighbours in the stream (a graph node: a few microseconds).
//
// The ring holds `capacity` entries (a power of two) of two 64-bit words:
// [time_ns, code].  The counter counts every mark ever written; entry n
// sits in slot n & (capacity - 1), so the host, which knows how many marks
// it enqueued, can tell which entries a later mark overwrote.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void trace_mark_kernel(unsigned long long* ring,
                                  unsigned long long* counter,
                                  unsigned long long mask, long long code) {
  const unsigned long long now = global_ns();
  const unsigned long long slot = atomicAdd(counter, 1ULL) & mask;
  ring[2 * slot] = now;
  ring[2 * slot + 1] = static_cast<unsigned long long>(code);
}

__global__ void trace_clock_kernel(unsigned long long* out) { *out = global_ns(); }

}  // namespace

extern "C" {

const char* pdnlp_trace_mark_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One mark on `stream`: ring [capacity, 2] and counter [1] are 64-bit
// device words; capacity a power of two.  Returns cudaGetLastError().
int pdnlp_trace_mark(void* ring, void* counter, long long capacity, long long code,
                     void* stream) {
  if (capacity <= 0 || (capacity & (capacity - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  trace_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring), static_cast<unsigned long long*>(counter),
      static_cast<unsigned long long>(capacity - 1), code);
  return static_cast<int>(cudaGetLastError());
}

// The card's %globaltimer into out [1] (a 64-bit device word), on
// `stream`: how the host relates the marks' clock to its own.
int pdnlp_trace_clock(void* out, void* stream) {
  trace_clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
