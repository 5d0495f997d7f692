// Stage marks: the device half of the stage counters of
// multigrid_tpu_torch/utils/profiling.py.
//
// A mark is one thread. It reads the device's nanosecond clock
// (%globaltimer), adds the nanoseconds since the previous mark to the slot
// of the stage it closes and counts the mark there, so the table holds each
// stage's self time. It may also add a count to another slot: an integer
// passed by value, plus one read from the device.
//
// The table is int64 (slots, 2): slot 0 holds the time of the last mark,
// slot s > 0 a stage's (nanoseconds, marks) or a count's (total, 0). Marks
// run in stream order, inside CUDA graphs as well as eagerly, so a mark's
// clock reading is when the work launched before it has finished.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ int64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<int64_t>(t);
}

// With `reset` the table is cleared and the clock's reading becomes the
// previous mark. Otherwise `close` (> 0) takes the time since the previous
// mark, and the mark counts where `counted`; `count_slot` (> 0) adds
// `count_add` and, where `count_ptr` is given, the int64 it points at.
__global__ void stage_mark_kernel(int64_t* table, int slots, int close, int counted,
                                  int count_slot, const int64_t* count_ptr,
                                  int64_t count_add, int reset) {
  const int64_t now = global_ns();
  if (reset) {
    for (int i = 1; i < 2 * slots; ++i) table[i] = 0;
    table[0] = now;
    return;
  }
  if (close > 0) {
    table[2 * close] += now - table[0];
    table[2 * close + 1] += counted;
    table[0] = now;
  }
  if (count_slot > 0) {
    table[2 * count_slot] += count_add + (count_ptr != nullptr ? *count_ptr : 0);
  }
}

// The clock's smallest step: the least positive difference between two
// successive readings, over `changes` changes of the reading.
__global__ void stage_tick_kernel(int64_t* out, int changes) {
  int64_t prev = global_ns();
  int64_t least = INT64_MAX;
  for (int seen = 0; seen < changes;) {
    const int64_t now = global_ns();
    if (now != prev) {
      least = now - prev < least ? now - prev : least;
      prev = now;
      ++seen;
    }
  }
  out[0] = least;
}

}  // namespace

extern "C" int mgt_stage_mark(void* table, int slots, int close, int counted, int count_slot,
                              const void* count_ptr, long long count_add, int reset,
                              void* stream) {
  stage_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(table), slots, close, counted, count_slot,
      static_cast<const int64_t*>(count_ptr), count_add, reset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mgt_stage_tick(void* out, int changes, void* stream) {
  stage_tick_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(out), changes);
  return static_cast<int>(cudaGetLastError());
}
