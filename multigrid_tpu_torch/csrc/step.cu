// The env step's action loop for a batch of MultiGrid environments.
//
// Replaces multigrid_tpu/ops/step.py::handle_actions, which has no Pallas
// kernel: XLA fuses its one-hot selects into a few elementwise passes over
// the env batch. Every agent's action is applied in its env's order, and
// the new state and the rewards are written to fresh tensors (the input
// state is read only). The per-env semantics are step_core.cuh's step_rows,
// bit-equal to ops/step.py::handle_actions_plain.
//
// What bounds it on this card: bytes. The state has to be read once and
// written once (the flagship's 4096 grids of 16x16x3 int32 are 12.6 MB each
// way); the action loop itself touches at most N cells of an env, but its
// sub-steps are chains of dependent loads (a position, then a cell, then
// the occupancy test over N agents).
//
// step_kernel_staged, the design for Hopper: one block an SM, whose warps
// are independent pipelines. A warp walks its chunks of envs (a chunk is
// up to 32 envs, one a lane) through stages of its own in shared memory: its
// first lane issues a chunk's loads as 1-D bulk copies (TMA, one a field,
// completing on the stage's mbarrier) ahead of the step, so the whole
// batch's first chunks, tens of KB an SM, are in flight at once; when a
// chunk has landed, each lane runs its env's sub-steps on the staged rows,
// whose dependent loads then hit shared memory; then bulk copies store the
// chunk back to the output tensors and the stage takes the warp's next
// chunk. A sub-step is a chain of dependent instructions, latency-bound in
// one warp (a flagship env's 4 sub-steps take microseconds), so the design
// keeps many warps stepping at once, each beside the others' copies, and
// issues every chunk's loads at the start where the batch fits the SMs'
// stages (PERF.md has the design's measurements).
// step_plan.cuh holds the plan (chunk, warps, stages a warp) and the
// stage's layout.
//
// step_kernel_global, for shapes where two stages of the least chunk do not
// fit a block (a 250x250 grid is 750 KB an env) or tensors not 16-byte
// aligned: a block copies its group of envs' state global to global
// (16-byte vectors where source and destination share their alignment),
// then, after one barrier, one thread an env runs its sub-steps on the copy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

#include "step_core.cuh"
#include "step_plan.cuh"

namespace {

using mgt_step::kFields;
using mgt_step::StepPlan;

// ------------------------------------------------------------ the staged kernel

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// The staged kernel's arguments: the plan, the step's shape and flags, and
// each field's input (loaded fields) and output (stored fields) tensor.
struct Staged {
  StepPlan plan;
  mgt_step::StepConfig cfg;
  const unsigned char* src[kFields];
  unsigned char* dst[kFields];
};

// Chunk q's loads into `stage`, by one thread: the bytes it expects, then
// one bulk copy a field.
__device__ __forceinline__ void load_chunk(const Staged& s, int64_t q, unsigned char* stage,
                                           uint64_t* bar) {
  uint32_t bytes = 0;
#pragma unroll
  for (int f = 0; f < kFields; ++f)
    if (mgt_step::loaded(f)) bytes += static_cast<uint32_t>(mgt_step::chunk_copy(s.plan, q, f).bulk);
  mbar_expect(bar, bytes);
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    if (!mgt_step::loaded(f)) continue;
    const mgt_step::ChunkCopy c = mgt_step::chunk_copy(s.plan, q, f);
    if (c.bulk) bulk_load(stage + c.shared, s.src[f] + c.global, static_cast<uint32_t>(c.bulk), bar);
  }
}

__global__ void __launch_bounds__(32 * mgt_step::kMaxWarps)
    step_kernel_staged(const __grid_constant__ Staged s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StepPlan& p = s.plan;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.warps * p.depth; ++i) mbar_init(reinterpret_cast<uint64_t*>(smem) + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // This warp's pipeline: its chunks g, g + G, ... and its `depth` stages.
  const int64_t g = static_cast<int64_t>(blockIdx.x) * p.warps + warp;
  const int64_t all = static_cast<int64_t>(gridDim.x) * p.warps;
  const int64_t mine = mgt_step::warp_chunks(p, g);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem) + warp * p.depth;
  unsigned char* stages = smem + mgt_step::kBarrierBytes + warp * p.depth * p.stage_bytes;
  if (lane == 0)
    for (int64_t i = 0; i < mine && i < p.depth; ++i)
      load_chunk(s, g + i * all, stages + i * p.stage_bytes, full + i);

  for (int64_t i = 0; i < mine; ++i) {
    const int64_t q = g + i * all;
    const int64_t count = mgt_step::chunk_count(p, q);
    const int st = static_cast<int>(i % p.depth);
    unsigned char* stage = stages + st * p.stage_bytes;
    mbar_wait(full + st, static_cast<uint32_t>((i / p.depth) & 1));
    // Only the batch's last chunk can be short; the tails its bulk copies
    // leave (under 16 bytes a field) go by the warp's lanes.
    const bool ragged = count < p.chunk;
    if (ragged) {
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        if (!mgt_step::loaded(f)) continue;
        const mgt_step::ChunkCopy c = mgt_step::chunk_copy(p, q, f);
        for (int64_t b = lane; b < c.rem; b += 32)
          stage[c.shared + c.bulk + b] = s.src[f][c.global + c.bulk + b];
      }
      __syncwarp();
    }
    if (lane < count) mgt_step::step_rows(s.cfg, mgt_step::stage_rows(p, stage, lane));
    // The steps' writes to the stage, ordered before the bulk stores read it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (ragged) {
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        if (!mgt_step::stored(f)) continue;
        const mgt_step::ChunkCopy c = mgt_step::chunk_copy(p, q, f);
        for (int64_t b = lane; b < c.rem; b += 32)
          s.dst[f][c.global + c.bulk + b] = stage[c.shared + c.bulk + b];
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        if (!mgt_step::stored(f)) continue;
        const mgt_step::ChunkCopy c = mgt_step::chunk_copy(p, q, f);
        if (c.bulk) bulk_store(s.dst[f] + c.global, stage + c.shared, static_cast<uint32_t>(c.bulk));
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // The stage's next chunk, once the store has read the stage.
      if (i + p.depth < mine) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        load_chunk(s, q + p.depth * all, stage, full + st);
      }
    }
    __syncwarp();
  }
  // The stores have to finish reading shared memory before the block ends.
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------ the global kernel

// The block's threads copy `bytes` bytes from src to dst: 16-byte vectors
// where both share their address mod 16, else 4-byte words where they share
// it mod 4, else bytes; the head and tail around the aligned body by bytes.
__device__ void copy_rows(void* dst_, const void* src_, int64_t bytes) {
  char* dst = static_cast<char*>(dst_);
  const char* src = static_cast<const char*>(src_);
  const uintptr_t skew = reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(src);
  const int unit = (skew & 15) == 0 ? 16 : (skew & 3) == 0 ? 4 : 1;
  int64_t head = (unit - static_cast<int64_t>(reinterpret_cast<uintptr_t>(dst) % unit)) % unit;
  if (head > bytes) head = bytes;
  const int64_t body = (bytes - head) / unit;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  if (unit == 16) {
    const int4* s = reinterpret_cast<const int4*>(src + head);
    int4* d = reinterpret_cast<int4*>(dst + head);
    for (int64_t i = threadIdx.x; i < body; i += blockDim.x) d[i] = __ldg(s + i);
  } else if (unit == 4) {
    const int* s = reinterpret_cast<const int*>(src + head);
    int* d = reinterpret_cast<int*>(dst + head);
    for (int64_t i = threadIdx.x; i < body; i += blockDim.x) d[i] = __ldg(s + i);
  } else {
    for (int64_t i = head + threadIdx.x; i < bytes; i += blockDim.x) dst[i] = src[i];
    return;
  }
  for (int64_t i = head + body * unit + threadIdx.x; i < bytes; i += blockDim.x) dst[i] = src[i];
}

// The input state's fields, read only.
struct StepInputs {
  const int32_t* grid;
  const int32_t* box;
  const int32_t* pos;
  const int32_t* dir;
  const int32_t* carrying;
  const int32_t* contents;
  const uint8_t* terminated;
};

__global__ void __launch_bounds__(256)
    step_kernel_global(StepInputs in, mgt_step::StepArgs a, int64_t e, int group) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * group;
  const int64_t count = e - first < group ? e - first : group;
  const int64_t n = a.cfg.n, cells = static_cast<int64_t>(a.cfg.w) * a.cfg.h * 3;
  copy_rows(a.grid + first * cells, in.grid + first * cells, count * cells * 4);
  if (a.box) copy_rows(a.box + first * cells, in.box + first * cells, count * cells * 4);
  copy_rows(a.pos + first * n * 2, in.pos + first * n * 2, count * n * 8);
  copy_rows(a.dir + first * n, in.dir + first * n, count * n * 4);
  copy_rows(a.carrying + first * n * 3, in.carrying + first * n * 3, count * n * 12);
  copy_rows(a.contents + first * n * 3, in.contents + first * n * 3, count * n * 12);
  copy_rows(a.terminated + first * n, in.terminated + first * n, count * n);
  __syncthreads();
  if (threadIdx.x < count) mgt_step::step_env(a, first + threadIdx.x);
}

// ------------------------------------------------------------ the launcher

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        sms < 1)
      sms = 132;
  }
  return sms;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch(const void* const* in, void* const* out, void* rewards, const void* actions,
           const void* order, const void* mask, const void* step_count, long long e, int n, int w,
           int h, int allow_agent_overlap, int success_any, int failure_any, int joint_reward,
           double k, void* stream) {
  if (e <= 0) return static_cast<int>(cudaSuccess);
  if (n < 0 || w < 1 || h < 1 || (in[1] == nullptr) != (out[1] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const mgt_step::StepConfig cfg{n, w, h, allow_agent_overlap, success_any, failure_any,
                                 joint_reward, k};
  bool aligned = aligned16(rewards) && aligned16(actions) && aligned16(order) &&
                 aligned16(mask) && aligned16(step_count);
  for (int f = 0; f < 7; ++f) aligned = aligned && aligned16(in[f]) && aligned16(out[f]);
  const StepPlan plan = mgt_step::plan_step(e, n, w, h, in[1] != nullptr, mask != nullptr,
                                            aligned, sm_count());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.staged) {
    static bool opted_in = false;  // shared memory past 48 KB a block
    if (!opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          step_kernel_staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(mgt_step::kBlockSmem));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted_in = true;
    }
    Staged args{};
    args.plan = plan;
    args.cfg = cfg;
    for (int f = 0; f < 7; ++f) {
      args.src[f] = static_cast<const unsigned char*>(in[f]);
      args.dst[f] = static_cast<unsigned char*>(out[f]);
    }
    args.src[mgt_step::kActions] = static_cast<const unsigned char*>(actions);
    args.src[mgt_step::kOrder] = static_cast<const unsigned char*>(order);
    args.src[mgt_step::kMask] = static_cast<const unsigned char*>(mask);
    args.src[mgt_step::kStepCount] = static_cast<const unsigned char*>(step_count);
    args.dst[mgt_step::kRewards] = static_cast<unsigned char*>(rewards);
    step_kernel_staged<<<plan.blocks, plan.threads, plan.smem_bytes, s>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
  const StepInputs inputs{
      static_cast<const int32_t*>(in[0]), static_cast<const int32_t*>(in[1]),
      static_cast<const int32_t*>(in[2]), static_cast<const int32_t*>(in[3]),
      static_cast<const int32_t*>(in[4]), static_cast<const int32_t*>(in[5]),
      static_cast<const uint8_t*>(in[6])};
  const mgt_step::StepArgs a{static_cast<int32_t*>(out[0]),
                             static_cast<int32_t*>(out[1]),
                             static_cast<int32_t*>(out[2]),
                             static_cast<int32_t*>(out[3]),
                             static_cast<int32_t*>(out[4]),
                             static_cast<int32_t*>(out[5]),
                             static_cast<uint8_t*>(out[6]),
                             static_cast<float*>(rewards),
                             static_cast<const int32_t*>(actions),
                             static_cast<const int32_t*>(order),
                             static_cast<const uint8_t*>(mask),
                             static_cast<const int32_t*>(step_count),
                             cfg};
  step_kernel_global<<<plan.blocks, plan.threads, 0, s>>>(inputs, a, e, plan.chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the action loop on `stream`: the input state (in_*), the output
// state and rewards (out_*, fresh tensors of the same shapes), actions and
// order (int32), the mask (bool, or null: every agent acts), the step
// counts (int32, already incremented). `box` pointers are null where the
// env has no box table. Returns a cudaError_t.
extern "C" int mgt_step_launch(
    const void* in_grid, const void* in_box, const void* in_pos, const void* in_dir,
    const void* in_carrying, const void* in_contents, const void* in_terminated,
    void* out_grid, void* out_box, void* out_pos, void* out_dir, void* out_carrying,
    void* out_contents, void* out_terminated, void* rewards, const void* actions,
    const void* order, const void* mask, const void* step_count, long long e, int n, int w,
    int h, int allow_agent_overlap, int success_any, int failure_any, int joint_reward,
    double k, void* stream) {
  const void* in[7] = {in_grid, in_box, in_pos, in_dir, in_carrying, in_contents, in_terminated};
  void* out[7] = {out_grid, out_box, out_pos, out_dir, out_carrying, out_contents, out_terminated};
  return launch(in, out, rewards, actions, order, mask, step_count, e, n, w, h,
                allow_agent_overlap, success_any, failure_any, joint_reward, k, stream);
}

// The plan a launch takes on this device: out[0..8] = staged, chunk (the
// global kernel's envs a block), warps, depth, blocks, threads, chunks,
// stage bytes, shared memory a block.
extern "C" int mgt_step_plan(long long e, int n, int w, int h, int box, int mask, int aligned,
                             long long* out) {
  const StepPlan p = mgt_step::plan_step(e, n, w, h, box != 0, mask != 0, aligned != 0,
                                         sm_count());
  const long long v[9] = {p.staged, p.chunk, p.warps, p.depth, p.blocks, p.threads, p.chunks,
                          p.stage_bytes, p.smem_bytes};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}
