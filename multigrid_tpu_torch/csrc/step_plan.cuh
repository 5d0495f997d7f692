// The step kernel's plan: which of csrc/step.cu's two kernels runs, and how
// the staged one cuts the env batch into chunks and lays a chunk's rows out
// in shared memory.
//
// The staged kernel moves each field of a chunk (its envs' rows, contiguous
// in every tensor) by one 1-D bulk copy each way. A bulk copy needs 16-byte
// aligned addresses and a size that is a multiple of 16, so a chunk is a
// multiple of `chunk_unit` envs: then every full chunk starts and ends on a
// 16-byte boundary in every field. Only the batch's last chunk may be short;
// its tails under 16 bytes go by threads (ChunkCopy::rem).
//
// Like step_core.cuh, this compiles as CUDA and as plain C++:
// tests/test_torch_step_kernel.py builds it with g++ to check the plan's
// coverage and alignment, and steps envs through a stage laid out as the
// kernel lays it out, without a card.

#pragma once

#include <stdint.h>

#include "step_core.cuh"

#if defined(__CUDACC__)
#define MGT_PLAN_FN __host__ __device__ __forceinline__
#else
#define MGT_PLAN_FN inline
#endif

namespace mgt_step {

// The fields a stage holds, in their order there.
enum Field {
  kGrid, kBox, kPos, kDir, kCarrying, kContents, kTerminated,  // read and written
  kActions, kOrder, kMask, kStepCount,                          // read only
  kRewards,                                                     // written only
  kFields
};

MGT_PLAN_FN bool loaded(int f) { return f != kRewards; }
MGT_PLAN_FN bool stored(int f) { return f <= kTerminated || f == kRewards; }

constexpr int64_t kBlockSmem = 232448;  // shared memory a block can have (227 KB)
constexpr int64_t kBarrierBytes = 256;  // the stages' mbarriers, before the stages
constexpr int kMaxStages = kBarrierBytes / 8;
constexpr int kMaxWarps = 16;           // warps a staged block at most
constexpr int kMaxChunk = 32;           // envs a chunk at most: one a lane
constexpr int64_t kChunkBytes = 32768;  // stage bytes the plan aims a chunk at
constexpr int kMaxGroup = 32;           // envs a block of the global kernel

// A staged launch is one block an SM. Its warps are independent pipelines:
// warp g of the grid's G takes chunks g, g + G, g + 2G, ... through its own
// `depth` stages (stage warp * depth + i % depth for its i-th chunk).
struct StepPlan {
  int staged;   // 1: the staged kernel, 0: the global one
  int chunk;    // staged: envs a chunk; global: envs a block
  int warps;    // staged: warps a block
  int depth;    // staged: stages a warp
  int blocks;
  int threads;
  int64_t e;
  int64_t chunks;           // staged: chunks in the batch
  int64_t stage_bytes;      // staged: one stage
  int64_t smem_bytes;       // staged: dynamic shared memory a block
  int64_t row[kFields];     // bytes of a field for one env (0: absent)
  int64_t offset[kFields];  // where a field's rows start in a stage
};

MGT_PLAN_FN int64_t round16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// Bytes each field holds for one env.
MGT_PLAN_FN void field_rows(int n, int w, int h, bool box, bool mask, int64_t* row) {
  const int64_t grid = static_cast<int64_t>(w) * h * 3 * 4;
  row[kGrid] = grid;
  row[kBox] = box ? grid : 0;
  row[kPos] = n * 8;
  row[kDir] = n * 4;
  row[kCarrying] = n * 12;
  row[kContents] = n * 12;
  row[kTerminated] = n;
  row[kActions] = n * 4;
  row[kOrder] = n * 4;
  row[kMask] = mask ? n : 0;
  row[kStepCount] = 4;
  row[kRewards] = n * 4;
}

// The fewest envs whose rows are a multiple of 16 bytes in every field.
MGT_PLAN_FN int64_t chunk_unit(const int64_t* row) {
  int64_t unit = 1;
  for (int f = 0; f < kFields; ++f) {
    int64_t u = 1;
    while ((u * row[f]) % 16) u *= 2;
    unit = u > unit ? u : unit;
  }
  return unit;
}

MGT_PLAN_FN int64_t stage_bytes(const int64_t* row, int64_t chunk) {
  int64_t bytes = 0;
  for (int f = 0; f < kFields; ++f) bytes += round16(chunk * row[f]);
  return bytes;
}

MGT_PLAN_FN int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The plan for `e` envs on `sms` SMs. The staged kernel runs where two
// stages of the least chunk fit a block (so that a warp's next chunk can
// load while it steps one) and every tensor's address is a multiple of 16
// (`aligned`); else the global kernel.
MGT_PLAN_FN StepPlan plan_step(int64_t e, int n, int w, int h, bool box, bool mask, bool aligned,
                               int sms) {
  StepPlan p{};
  p.e = e;
  field_rows(n, w, h, box, mask, p.row);
  const int64_t unit = chunk_unit(p.row);
  const int64_t room = kBlockSmem - kBarrierBytes;
  p.staged = aligned && e > 0 && 2 * stage_bytes(p.row, unit) <= room;
  if (!p.staged) {
    // As many envs a block as give two blocks an SM, 1 to kMaxGroup.
    const int64_t g = e / (2 * static_cast<int64_t>(sms));
    p.chunk = g < 1 ? 1 : g > kMaxGroup ? kMaxGroup : static_cast<int>(g);
    p.blocks = static_cast<int>((e + p.chunk - 1) / p.chunk);
    p.threads = 256;
    return p;
  }
  // The chunk: near kChunkBytes a stage, at most kMaxChunk envs and a
  // whole SM's share of the batch, and two stages in the room.
  int64_t c = unit * (kChunkBytes / stage_bytes(p.row, unit));
  c = min64(c, kMaxChunk / unit * unit);
  c = min64(c, (e + sms - 1) / sms / unit * unit);
  if (c < unit) c = unit;
  while (c > unit && 2 * stage_bytes(p.row, c) > room) c -= unit;
  p.chunk = static_cast<int>(c);
  p.chunks = (e + c - 1) / c;
  p.stage_bytes = stage_bytes(p.row, c);
  const int64_t fit = room / p.stage_bytes;  // stages that fit a block, 2 or more
  // Depth 1 where every chunk has a stage of its own at once (all loads in
  // flight from the start); else 2, so that a warp's next chunk loads
  // while it steps one.
  const int64_t d = p.chunks <= min64(fit, kMaxWarps) * sms ? 1 : 2;
  int64_t wp = min64(min64(fit / d, kMaxWarps), kMaxStages / d);
  wp = min64(wp, (p.chunks + static_cast<int64_t>(sms) * d - 1) / (static_cast<int64_t>(sms) * d));
  if (wp < 1) wp = 1;
  p.depth = static_cast<int>(d);
  p.warps = static_cast<int>(wp);
  p.blocks = static_cast<int>(min64(sms, (p.chunks + wp - 1) / wp));
  p.threads = 32 * p.warps;
  p.smem_bytes = kBarrierBytes + wp * d * p.stage_bytes;
  int64_t at = 0;
  for (int f = 0; f < kFields; ++f) {
    p.offset[f] = at;
    at += round16(c * p.row[f]);
  }
  return p;
}

// Chunks of the grid's warp g: g, g + G, ... below `chunks`.
MGT_PLAN_FN int64_t warp_chunks(const StepPlan& p, int64_t g) {
  const int64_t all = static_cast<int64_t>(p.blocks) * p.warps;
  return g < p.chunks ? (p.chunks - g + all - 1) / all : 0;
}

// The envs of chunk q: [q * chunk, q * chunk + chunk_count).
MGT_PLAN_FN int64_t chunk_count(const StepPlan& p, int64_t q) {
  const int64_t left = p.e - q * p.chunk;
  return left < p.chunk ? left : p.chunk;
}

// Chunk q's rows of field f: `global` bytes past the tensor's address and
// `shared` past the stage's; the first `bulk` bytes (a multiple of 16) by
// one bulk copy, the `rem` (< 16) after them by threads.
struct ChunkCopy {
  int64_t global, shared, bulk, rem;
};

MGT_PLAN_FN ChunkCopy chunk_copy(const StepPlan& p, int64_t q, int f) {
  const int64_t bytes = chunk_count(p, q) * p.row[f];
  return ChunkCopy{q * p.chunk * p.row[f], p.offset[f], bytes / 16 * 16, bytes % 16};
}

// Env t's row of field f in a stage.
MGT_PLAN_FN unsigned char* stage_row(const StepPlan& p, unsigned char* stage, int f, int64_t t) {
  return p.row[f] ? stage + p.offset[f] + t * p.row[f] : nullptr;
}

// Env t of a chunk, in its stage.
MGT_PLAN_FN EnvRows stage_rows(const StepPlan& p, unsigned char* stage, int64_t t) {
  return EnvRows{reinterpret_cast<int32_t*>(stage_row(p, stage, kGrid, t)),
                 reinterpret_cast<int32_t*>(stage_row(p, stage, kBox, t)),
                 reinterpret_cast<int32_t*>(stage_row(p, stage, kPos, t)),
                 reinterpret_cast<int32_t*>(stage_row(p, stage, kDir, t)),
                 reinterpret_cast<int32_t*>(stage_row(p, stage, kCarrying, t)),
                 reinterpret_cast<int32_t*>(stage_row(p, stage, kContents, t)),
                 stage_row(p, stage, kTerminated, t),
                 reinterpret_cast<float*>(stage_row(p, stage, kRewards, t)),
                 reinterpret_cast<const int32_t*>(stage_row(p, stage, kActions, t)),
                 reinterpret_cast<const int32_t*>(stage_row(p, stage, kOrder, t)),
                 stage_row(p, stage, kMask, t),
                 *reinterpret_cast<const int32_t*>(stage_row(p, stage, kStepCount, t))};
}

}  // namespace mgt_step
