// The env step's action loop for a batch of MultiGrid environments.
//
// Replaces multigrid_tpu/ops/step.py::handle_actions, which has no Pallas
// kernel: XLA fuses its one-hot selects into a few elementwise passes over
// the env batch. Every agent's action is applied in its env's order, and
// the new state and the rewards are written to fresh tensors (the input
// state is read only). The per-env semantics are step_core.cuh's step_env,
// bit-equal to ops/step.py::handle_actions_plain.
//
// What bounds it on this card: bytes. The state has to be read once and
// written once (the flagship's 4096 grids of 16x16x3 int32 are 12.6 MB each
// way); the action loop itself touches at most N cells of an env. So a
// block takes a group of envs: its threads first copy the group's rows of
// every state field (contiguous, 16-byte vectors where source and
// destination share their alignment), then, after one barrier, one thread
// an env runs its N sub-steps on the copy. The group is sized so that the
// card gets at least two blocks an SM where there are envs enough.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

#include "step_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 32;

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

__global__ void __launch_bounds__(kThreads)
    step_kernel(StepInputs in, mgt_step::StepArgs a, int64_t e, int group) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * group;
  const int64_t count = e - first < group ? e - first : group;
  const int64_t n = a.n, cells = static_cast<int64_t>(a.w) * a.h * 3;
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

// Envs a block: at least two blocks an SM where there are envs enough, at
// most kMaxGroup.
int group_size(int64_t e) {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        sms < 1)
      sms = 132;
  }
  const int64_t g = e / (2 * static_cast<int64_t>(sms));
  return g < 1 ? 1 : g > kMaxGroup ? kMaxGroup : static_cast<int>(g);
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
  if (e <= 0) return static_cast<int>(cudaSuccess);
  if (n < 0 || w < 1 || h < 1 || (in_box == nullptr) != (out_box == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const StepInputs in{static_cast<const int32_t*>(in_grid), static_cast<const int32_t*>(in_box),
                      static_cast<const int32_t*>(in_pos), static_cast<const int32_t*>(in_dir),
                      static_cast<const int32_t*>(in_carrying),
                      static_cast<const int32_t*>(in_contents),
                      static_cast<const uint8_t*>(in_terminated)};
  mgt_step::StepArgs a;
  a.grid = static_cast<int32_t*>(out_grid);
  a.box = static_cast<int32_t*>(out_box);
  a.pos = static_cast<int32_t*>(out_pos);
  a.dir = static_cast<int32_t*>(out_dir);
  a.carrying = static_cast<int32_t*>(out_carrying);
  a.contents = static_cast<int32_t*>(out_contents);
  a.terminated = static_cast<uint8_t*>(out_terminated);
  a.rewards = static_cast<float*>(rewards);
  a.actions = static_cast<const int32_t*>(actions);
  a.order = static_cast<const int32_t*>(order);
  a.mask = static_cast<const uint8_t*>(mask);
  a.step_count = static_cast<const int32_t*>(step_count);
  a.n = n;
  a.w = w;
  a.h = h;
  a.allow_agent_overlap = allow_agent_overlap;
  a.success_any = success_any;
  a.failure_any = failure_any;
  a.joint_reward = joint_reward;
  a.k = k;
  const int group = group_size(e);
  const int64_t blocks = (e + group - 1) / group;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, a, e, group);
  return static_cast<int>(cudaGetLastError());
}
