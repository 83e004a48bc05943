// One stamp of the device's stage clocks (smallvcm_tpu_torch/trace.py).
//
// Replaces no TPU kernel: the JAX package has no clock inside its compiled
// iteration. It was added so that a CUDA graph replay of a whole iteration
// can say where its time went: one thread reads the device's nanosecond
// %globaltimer when the work queued before it on the stream has finished
// and writes it, less the clock's base (its reading when the clock was
// fitted), into the stage's slot of the iteration's row of a small float64
// ring, and the bounce's live lanes beside it: float64 holds those
// nanoseconds exactly for 104 days, and the ring joins the block's one
// float64 host read as it is, with no kernel of its own. The stamp that
// starts an iteration reads the iteration from device memory, a graph's
// 0-dim input buffer, and leaves the row for the stamps after it, so every
// replay stamps its own row without new launch arguments.
//
// Bound: one launch, three 8-byte reads and writes; its cost is the
// launch (a kernel node of a graph, ~2 us), which is why an iteration holds
// a few dozen stamps and not one a kernel.

#include <cuda_runtime.h>

namespace {

__global__ void trace_stamp_kernel(double* times, double* lanes,
                                   long long* row,
                                   const long long* iteration,
                                   const long long* count, long long base,
                                   int rows, int slots, int slot) {
  long long r;
  if (iteration != nullptr) {
    r = *iteration % rows;
    if (r < 0) r += rows;
    *row = r;
  } else {
    r = *row;
  }
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  times[r * slots + slot] = (double)((long long)now - base);
  lanes[r * slots + slot] = count != nullptr ? (double)*count : -1.0;
}

}  // namespace

extern "C" int svcm_trace_stamp(double* times, double* lanes, long long* row,
                                const long long* iteration,
                                const long long* count, long long base,
                                int rows, int slots, int slot, void* stream) {
  trace_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      times, lanes, row, iteration, count, base, rows, slots, slot);
  return (int)cudaGetLastError();
}
