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
// which lives there), so a CUDA graph holds the launch.
//
// step_draws_kernel (R2): every env's step draws in one launch, one thread
// an env: split the env's key, rank its agents by the uniforms of the
// order key (a stable argsort in registers), and the fresh episode's keys
// for the auto-reset.
//
// What bounds them: neither moves many bytes (R1 reads 16 bytes a key and
// writes 4 to 16 an element; R2 reads 16 bytes an env and writes 4 an agent
// and 16 to 48 an env), and each element costs one to four threefry hashes
// of about 100 integer instructions; at the port's sizes (thousands of
// envs) a launch is short, and its time is the launch's.
//
// prng_core.cuh holds the per-element code, which a host compiler builds
// too. Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

#include "prng_core.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void threefry_bits_kernel(const int64_t* __restrict__ keys, int64_t total,
                                     int64_t count, int64_t offset,
                                     const int64_t* __restrict__ offset_dev, int mode,
                                     const int64_t* __restrict__ spans, int span_len,
                                     int32_t minval, float fmin, float fmax, void* out) {
  const uint64_t base = static_cast<uint64_t>(offset) +
                        (offset_dev != nullptr ? static_cast<uint64_t>(*offset_dev) : 0ull);
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    mgt_prng::draw_element(keys, t, count, base, mode, spans, span_len, minval, fmin, fmax,
                           out);
  }
}

__global__ void step_draws_kernel(const int64_t* __restrict__ rng, int64_t e, int n, int mode,
                                  int32_t* __restrict__ order, int64_t* __restrict__ rng_out,
                                  int64_t* __restrict__ gen_out,
                                  int64_t* __restrict__ fresh_out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= e) return;
  uint32_t r[2], g[2], f[2];
  mgt_prng::step_draws(static_cast<uint32_t>(rng[2 * i]), static_cast<uint32_t>(rng[2 * i + 1]),
                       n, mode, order + i * n, r, g, f);
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

}  // namespace

// R1: keys (num_keys, 2) int64, each drawing ``count`` elements from flat
// index offset (+ *offset_dev where it is not null); out by mode (see
// prng_core.cuh::Mode). Returns the launch's CUDA error code.
extern "C" int mgt_threefry_launch(const void* keys, long long num_keys, long long count,
                                   long long offset, const void* offset_dev, int mode,
                                   const void* spans, int span_len, int minval, float fmin,
                                   float fmax, void* out, void* stream) {
  const long long total = num_keys * count;
  if (total <= 0) return 0;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 32LL * sm_count() ? want : 32LL * sm_count());
  threefry_bits_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), total, count, offset,
      static_cast<const int64_t*>(offset_dev), mode, static_cast<const int64_t*>(spans),
      span_len, minval, fmin, fmax, out);
  return static_cast<int>(cudaGetLastError());
}

// R2: rng (e, 2) int64; order (e, n) int32, rng_out (e, 2); gen_out (e, 2)
// for the exact mode, fresh_out (e, 2) for the exact and pool modes (null
// where unused). n is at most kMaxStepAgents.
extern "C" int mgt_step_draws_launch(const void* rng, long long e, int n, int mode, void* order,
                                     void* rng_out, void* gen_out, void* fresh_out,
                                     void* stream) {
  if (e <= 0) return 0;
  if (n < 1 || n > mgt_prng::kMaxStepAgents) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((e + 127) / 128);
  step_draws_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rng), e, n, mode, static_cast<int32_t*>(order),
      static_cast<int64_t*>(rng_out), static_cast<int64_t*>(gen_out),
      static_cast<int64_t*>(fresh_out));
  return static_cast<int>(cudaGetLastError());
}
