// The port's random draws: threefry2x32 keyed draws, as jax.random makes
// them, on the card.
//
// The JAX package keeps a key per env in its state and draws everything
// from keys; XLA computes threefry2x32 inline (no Pallas kernel), fused into
// the step. Here two kernels do it:
//
// threefry_bits_kernel (R1): a batched draw, K keys by a range of flat
// indices [offset, offset + count) of one draw's shape (a process's rows of
// a global draw start at its first row's index), one thread an element in
// a grid-stride loop. Its epilogue writes both words (split, fold_in), the
// bits (random_bits), a uniform float, Gumbel noise or randint, by mode.
// The offset may also be read from the device (fold_in by the pool's step,
// which lives there), so a CUDA graph holds the launch. With a split
// prologue (``keys_out``) the launch makes ``k', sub = split(k)`` and the
// draw from ``sub`` together: the path's ``split`` then draw is one launch.
//
// step_draws_kernel<N> (R2): every env's step draws in one launch, one
// thread an env: split the env's key, rank its agents by the uniforms of
// the order key (a stable argsort), and the fresh episode's keys for the
// auto-reset.
//
// What bounds them on this card: not bytes (R1 reads 16 bytes a key and
// writes 4 to 16 an element; R2 reads 16 bytes an env and writes 4 an agent
// and 16 to 48 an env) and not the integer rate, but the launch and the
// chain of dependent hashes in a thread (a threefry hash is ~80 dependent
// integer instructions). At the port's sizes (thousands of envs) the
// bound by bytes or operations is well under a microsecond, below what any
// launch costs, so their yardstick is the launch floor: an empty kernel
// (launch_floor_kernel) launched the same way. The design against that:
// fewer launches (the split goes into the launch of the draw that uses
// it) and, in each, few hashes one after another. R1 runs one element a
// thread on blocks of 128 (16,384 elements on 128 SMs), its index
// arithmetic in 32 bits where it fits (a 64-bit division is a long
// software routine); a split-first randint is three hashes deep (the split
// beside its carried key, randint's split, the element's two bits). R2
// unrolls teams of up to 8 agents (a template on N): the order's N hashes
// and the reset key's run as independent chains in registers, three hashes
// deep where the generic body (teams of 9 to 64) runs 2 + n + 3 one after
// another. R2 keeps blocks of 128 threads: blocks of 32 and 64, which put
// 4,096 envs on every SM, and of 256 timed slower on the card (the floor
// rises with the blocks a launch dispatches).
//
// prng_core.cuh holds the per-element and per-env code, which a host
// compiler builds too. Build: nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -shared -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does
// this).

#include <cuda_runtime.h>
#include <stdint.h>

#include "prng_core.cuh"

namespace {

constexpr int kDrawThreads = 128;
constexpr int kDrawBlocksPerSm = 16;  // 2,048 threads: a full SM
constexpr int kStepThreads = 128;

__global__ void threefry_bits_kernel(mgt_prng::DrawArgs args,
                                     const int64_t* __restrict__ offset_dev) {
  if (offset_dev != nullptr) args.offset += static_cast<uint64_t>(*offset_dev);
  mgt_prng::draw_strided(args, blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x,
                         static_cast<int64_t>(gridDim.x) * blockDim.x);
}

template <int N>
__global__ void step_draws_kernel(const int64_t* __restrict__ rng, int64_t e, int n, int mode,
                                  int32_t* __restrict__ order, int64_t* __restrict__ rng_out,
                                  int64_t* __restrict__ gen_out,
                                  int64_t* __restrict__ fresh_out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= e) return;
  uint32_t r[2], g[2], f[2];
  mgt_prng::step_draws_env<N>(static_cast<uint32_t>(rng[2 * i]),
                              static_cast<uint32_t>(rng[2 * i + 1]), n, mode, order + i * n, r,
                              g, f);
  rng_out[2 * i] = r[0];
  rng_out[2 * i + 1] = r[1];
  if (mode == mgt_prng::kStepExact) {
    gen_out[2 * i] = g[0];
    gen_out[2 * i + 1] = g[1];
  }
  if (mode != mgt_prng::kStepOnly) {
    fresh_out[2 * i] = f[0];
    fresh_out[2 * i + 1] = f[1];
  }
}

// The launch floor: a kernel that does nothing, timed as R1 and R2 are.
__global__ void launch_floor_kernel() {}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

// R2's instances by team size: the generic body at 0, the unrolled ones
// at 1..kMaxUnrolledAgents.
using StepDrawsKernel = void (*)(const int64_t*, int64_t, int, int, int32_t*, int64_t*,
                                 int64_t*, int64_t*);
const StepDrawsKernel kStepDrawsKernels[] = {
    step_draws_kernel<0>, step_draws_kernel<1>, step_draws_kernel<2>,
    step_draws_kernel<3>, step_draws_kernel<4>, step_draws_kernel<5>,
    step_draws_kernel<6>, step_draws_kernel<7>, step_draws_kernel<8>};
static_assert(sizeof(kStepDrawsKernels) / sizeof(kStepDrawsKernels[0]) ==
                  mgt_prng::kMaxUnrolledAgents + 1,
              "an R2 instance for each unrolled team size");

// R1's blocks (of kDrawThreads) for ``total`` elements: one element a
// thread, at most kDrawBlocksPerSm blocks an SM (the loop strides past).
int draw_blocks(long long total) {
  const long long want = (total + kDrawThreads - 1) / kDrawThreads;
  const long long cap = static_cast<long long>(kDrawBlocksPerSm) * sm_count();
  return static_cast<int>(want < cap ? want : cap);
}

}  // namespace

// R1: keys (num_keys, 2) int64, each drawing ``count`` elements from flat
// index offset (+ *offset_dev where it is not null); out by mode (see
// prng_core.cuh::Mode). Where keys_out (num_keys, 2) is not null, each key
// is split first: the draw comes from element 1 and element 0 is written
// to keys_out. Returns the launch's CUDA error code.
extern "C" int mgt_threefry_launch(const void* keys, long long num_keys, long long count,
                                   long long offset, const void* offset_dev, int mode,
                                   const void* spans, int span_len, int minval, float fmin,
                                   float fmax, void* out, void* keys_out, void* stream) {
  const long long total = num_keys * (keys_out != nullptr && count == 0 ? 1 : count);
  if (total <= 0) return 0;
  mgt_prng::DrawArgs args;
  args.keys = static_cast<const int64_t*>(keys);
  args.keys_out = static_cast<int64_t*>(keys_out);
  args.num_keys = num_keys;
  args.count = count;
  args.offset = static_cast<uint64_t>(offset);
  args.mode = mode;
  args.spans = static_cast<const int64_t*>(spans);
  args.span_len = span_len;
  args.minval = minval;
  args.fmin = fmin;
  args.fmax = fmax;
  args.out = out;
  threefry_bits_kernel<<<draw_blocks(total), kDrawThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<const int64_t*>(offset_dev));
  return static_cast<int>(cudaGetLastError());
}

// R2: rng (e, 2) int64; order (e, n) int32, rng_out (e, 2); gen_out (e, 2)
// for the exact mode, fresh_out (e, 2) for the exact and pool modes (null
// where unused). n is at most kMaxStepAgents; teams of up to
// kMaxUnrolledAgents take the unrolled instance.
extern "C" int mgt_step_draws_launch(const void* rng, long long e, int n, int mode, void* order,
                                     void* rng_out, void* gen_out, void* fresh_out,
                                     void* stream) {
  if (e <= 0) return 0;
  if (n < 1 || n > mgt_prng::kMaxStepAgents) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((e + kStepThreads - 1) / kStepThreads);
  const StepDrawsKernel kernel = kStepDrawsKernels[n <= mgt_prng::kMaxUnrolledAgents ? n : 0];
  kernel<<<blocks, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rng), e, n, mode, static_cast<int32_t*>(order),
      static_cast<int64_t*>(rng_out), static_cast<int64_t*>(gen_out),
      static_cast<int64_t*>(fresh_out));
  return static_cast<int>(cudaGetLastError());
}

// The launch floor: an empty kernel on R1's grid for ``size`` elements
// (``kernel`` 1) or R2's for ``size`` envs (``kernel`` 2), on ``stream``.
// Returns the launch's CUDA error code.
extern "C" int mgt_launch_floor(int kernel, long long size, void* stream) {
  if (size <= 0 || (kernel != 1 && kernel != 2)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 1) {
    launch_floor_kernel<<<draw_blocks(size), kDrawThreads, 0, s>>>();
  } else {
    launch_floor_kernel<<<static_cast<int>((size + kStepThreads - 1) / kStepThreads),
                          kStepThreads, 0, s>>>();
  }
  return static_cast<int>(cudaGetLastError());
}
