// M1, the auto-reset's reset merge: the fresh episodes written into the
// stepped state in place, only for the envs that finished.
//
// Replaces no Pallas kernel. The JAX package consumes the reserve pool (a
// gather of every slot, then the unpack of its packed grid) or makes an
// exact reset of every env, and merges with a select of every field
// (multigrid_tpu/parallel/vector.py:392-411), which XLA fuses; on the card
// the same steps were about 60 library launches a step (BlockedUnlockPickup
// with the pool) or 10 (Empty, exact reset), each over whole-batch tensors,
// though a step finishes about 8 of 4,096 envs.
//
// What bounds it on this card: the launch. The useful bytes are the
// finished envs' rows (about 1.7 KB an env at BlockedUnlockPickup), read
// from the fresh source and written once to each state that holds them;
// at a few finished envs a step that is well under a microsecond of HBM
// time, below what any launch costs. The design against it: one launch for
// every field and both states, and a block that finds none of its envs
// finished returns after one load of their flags.
//
// A block takes a chunk of 32 envs: each warp loads the chunk's 32 done
// flags (one a lane) and ballots them, then walks the fields k ≡ warp (mod
// warps) for each finished env of the chunk, its lanes along the row, so
// that one env's fields are copied by several warps at once (a field is a
// chain of dependent loads and stores). A kept field (below) is copied for
// every env of the chunk while the flags load, then overwritten where done. The fields come in one table in the
// kernel's parameters (at most kMaxFields, read through the constant
// cache): a destination's rows, the fresh rows and where the env finds its
// own (kCopy: at its slot (i + g) mod slots of the reserve, g the pool's
// step read on the device, or at the env where there is no step; kKey: at
// the env; kUnpack: the packed reserve's cells, type<<8 | color<<4 | state
// from bit `shift`, as VectorEnv.pool_unpack unpacks them), and, for a
// destination the step did not make (a tensor it passed through from its
// input, which is never written), the rows each running env keeps: that
// destination is a new tensor, written for every env.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 48;
constexpr int kWarps = 16;
constexpr int kChunk = 32;  // envs a block: one a lane of each warp's flags

enum Kind { kCopy = 0, kKey = 1, kUnpack = 2 };

// One destination's rows (ops/merge_cuda.py::Field holds the same fields).
struct Field {
  const void* src;        // fresh rows (e or slots rows, or one for every env)
  const void* keep;       // null, or the rows a running env keeps
  void* dst;              // (e, bytes) dense rows
  long long src_stride;   // bytes between fresh rows (0: one row for all)
  long long keep_stride;  // bytes between kept rows
  int bytes;              // a destination row's bytes
  int kind;
  int shift;              // kUnpack: the bit of the cell's lowest lane
  int unit;               // 16, 4 or 1: the bytes a lane copies at a time
};

struct Table {
  Field f[kMaxFields];
  int count;
  int keeps;  // whether any field has rows to keep
};

template <typename T>
__device__ __forceinline__ void copy_units(char* __restrict__ dst, const char* __restrict__ src,
                                           int bytes, int lane) {
  auto* d = reinterpret_cast<T*>(dst);
  const auto* s = reinterpret_cast<const T*>(src);
#pragma unroll 4
  for (int k = lane; k < bytes / static_cast<int>(sizeof(T)); k += 32) d[k] = s[k];
}

__device__ __forceinline__ void copy_row(char* dst, const char* src, int bytes, int unit,
                                         int lane) {
  if (unit == 16) {
    copy_units<int4>(dst, src, bytes, lane);
  } else if (unit == 4) {
    copy_units<int32_t>(dst, src, bytes, lane);
  } else {
    copy_units<char>(dst, src, bytes, lane);
  }
}

// A finished env's row of one field, from its slot (or its own row).
__device__ __forceinline__ void fresh_row(const Field& f, long long env, long long slot,
                                          int lane) {
  char* dst = static_cast<char*>(f.dst) + env * f.bytes;
  const char* src =
      static_cast<const char*>(f.src) + (f.kind == kKey ? env : slot) * f.src_stride;
  if (f.kind == kUnpack) {
    auto* d = reinterpret_cast<int32_t*>(dst);
    const auto* p = reinterpret_cast<const int32_t*>(src);
    // Output k is lane j = k mod 3 (type, color, state) of cell k / 3.
#pragma unroll 4
    for (int k = lane; k < f.bytes / 4; k += 32) {
      const int c = k / 3;
      d[k] = (p[c] >> (f.shift + 8 - 4 * (k - 3 * c))) & 15;
    }
  } else {
    copy_row(dst, src, f.bytes, f.unit, lane);
  }
}

// A kept field's rows over the chunk [base, base + n), every env's: the
// chunk's rows are dense in the destination, so the warp walks them as one
// span. The finished envs' are written again after, with their fresh rows.
__device__ __forceinline__ void keep_rows(const Field& f, long long base, int n, int lane) {
  const int per = f.bytes / f.unit;
  for (int k = lane; k < n * per; k += 32) {
    const int r = k / per;
    const int c = k - r * per;
    const char* src = static_cast<const char*>(f.keep) + (base + r) * f.keep_stride;
    char* dst = static_cast<char*>(f.dst) + (base + r) * f.bytes;
    if (f.unit == 16) {
      reinterpret_cast<int4*>(dst)[c] = reinterpret_cast<const int4*>(src)[c];
    } else if (f.unit == 4) {
      reinterpret_cast<int32_t*>(dst)[c] = reinterpret_cast<const int32_t*>(src)[c];
    } else {
      dst[c] = src[c];
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32, 1)
    reset_merge_kernel(const __grid_constant__ Table t, const bool* __restrict__ done,
                       const long long* __restrict__ step, long long e, long long slots) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  const int n = static_cast<int>(e - base < kChunk ? e - base : kChunk);
  const bool mine = lane < n && done[base + lane];
  if (t.keeps) {
    // Copied before the flags are known, so that the two loads' latencies
    // overlap; a warp owns its fields, so its fresh rows land after.
    for (int k = warp; k < t.count; k += kWarps) {
      if (t.f[k].keep != nullptr) keep_rows(t.f[k], base, n, lane);
    }
  }
  const unsigned finished = __ballot_sync(0xffffffffu, mine);
  if (!finished) return;
  __syncwarp();
  const long long g = step != nullptr ? *step % slots : 0;
  for (int k = warp; k < t.count; k += kWarps) {
    const Field& f = t.f[k];
    for (unsigned left = finished; left; left &= left - 1) {
      const long long env = base + __ffs(left) - 1;
      fresh_row(f, env, step != nullptr ? (env + g) % slots : env, lane);
    }
  }
}

}  // namespace

// M1: `count` fields (a host array of Field, copied into the launch's
// parameters), done (e,) bool; step null or the pool's global step (a
// device int64), slots the reserve's rows. Returns the launch's CUDA error
// code (cudaErrorInvalidValue for more than kMaxFields fields).
extern "C" int mgt_reset_merge_launch(const void* fields, int count, const void* done,
                                      const void* step, long long e, long long slots,
                                      void* stream) {
  if (count < 0 || count > kMaxFields || (step != nullptr && slots <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e <= 0 || count == 0) return 0;
  Table t;
  t.count = count;
  t.keeps = 0;
  for (int k = 0; k < count; ++k) {
    t.f[k] = static_cast<const Field*>(fields)[k];
    t.keeps |= t.f[k].keep != nullptr;
  }
  const long long blocks = (e + kChunk - 1) / kChunk;
  reset_merge_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const bool*>(done), static_cast<const long long*>(step), e, slots);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's limits and the table's layout, for the wrapper's checks:
// out[0..2] = kMaxFields, sizeof(Field), kChunk.
extern "C" int mgt_reset_merge_info(long long* out) {
  out[0] = kMaxFields;
  out[1] = sizeof(Field);
  out[2] = kChunk;
  return 0;
}
