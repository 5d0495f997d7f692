// The rollout's whole policy step for the mlp ActorCritic on packed cells:
// each sample's action, log-prob and value in one launch.
//
// Replaces the TPU kernel multigrid_tpu/ops/fused_policy.py::_kernel. For
// each sample: h = one_hot(packed) @ W_img + [bf16(dirf), 1] @ [W0; b0];
// x1 = bf16(relu(h)); x2 = bf16(relu(x1 @ W1 + b1)); logits = x2 @ Wa + ba
// and value = x2 @ wv + bv, both kept in f32; action = the first index of
// the largest logits + gumbel over the valid actions (jnp.argmax's
// tie-break, so jax.random.categorical's sample given its Gumbel noise);
// log_prob = logits[action] - max - log(sum(exp(logits - max))). Numerics
// follow the TPU kernel: bf16 matrix operands, f32 sums, f32 biases of the
// trunk and heads.
//
// What bounds it on this card: operations. At B = 16384, C = 49, H = 128
// the first layer is 3.1e8 adds as the embedding-bag it is (4.6 us on the
// CUDA cores) or 4.3 GFLOP as the dense one-hot product (4.4 us on the
// tensor cores); the trunk and heads are 2*(H*H + 16*H) flops a sample
// (0.6 GFLOP, 0.6 us); the compulsory bytes (packed cells, features,
// noise, weights, 12 bytes out a sample) are about 4.3 MB (1.3 us).
//
// Redesigned for Hopper's tensor cores: the forward is the routine of
// mlp_forward.cuh, the one the PPO loss kernel (fused_ppo.cu) runs. A
// block of 8 warps takes tiles of 64 samples; the first layer is the
// one-hot product of onehot_mma.cuh (W_img streamed through a cp.async
// ring of 3 stages of 7 channels, as in the loss kernel, the A fragments
// built from the cells in registers, one more K step for the direction
// features and the bias row), x2 = x1 @ W1 and [logits | value] = x2 @
// [Wa | wv] are mma.sync m16n8k16 products on bf16 tiles in shared
// memory, with W1 loaded once a block by cp.async beside the ring's first
// stages. Then one thread a sample takes the masked Gumbel-max (the
// largest perturbed logit first, then the lowest index that equals it),
// the log-sum-exp and the value from the f32 [logits | value] tile, and
// writes 12 bytes. Nothing of (B, H) or (B, A) reaches device memory. x2
// overwrites x1's tile. At H 256, W1 alone takes 135 KB of shared memory,
// so the ring holds one channel a stage. From H 128 a block takes an SM
// (at H 128, two blocks an SM with 3-channel stages and at most 128
// registers a thread spilled registers and were no faster in a scratch
// comparison on the H100); at H 32 and 64 two blocks share one.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_forward.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // shared memory a block may use on Hopper

template <int H>
struct Layout {
  static constexpr int kLd = H + 8;                      // bf16 row stride of H-wide tiles
  static constexpr int kStages = 3;                      // W_img stages in the ring
  static constexpr int kGroup = H >= 256 ? 1 : 7;        // channels a stage
  static constexpr int kBlocksPerSm = H >= 128 ? 1 : 2;  // at most 255 or 128 registers
  // Byte offsets in shared memory.
  static constexpr int kW1 = 0;                                   // (H, kLd) bf16
  static constexpr int kWd = kW1 + align16(H * kLd * 2);          // (16, kLd) bf16
  static constexpr int kRing = kWd + align16(16 * kLd * 2);       // kStages x (16 kGroup, kLd)
  static constexpr int kX = kRing + align16(kStages * 16 * kGroup * kLd * 2);  // x1, then x2
  static constexpr int kWh = kX + align16(kTM * kLd * 2);         // (H, kHeadLd) bf16
  static constexpr int kLg = kWh + align16(H * kHeadLd * 2);      // (kTM, 16) f32
  static constexpr int kDirs = kLg + kTM * 16 * 4;                // (kTM, kF1) f32
  static constexpr int kGum = kDirs + kTM * kF1 * 4;              // (kTM, kA) f32
  static constexpr int kB1 = kGum + kTM * kA * 4;                 // (H,) f32
  static constexpr int kBa = kB1 + H * 4;                         // ba (kA), bv
  static constexpr size_t kSmem = kBa + 16 * 4;
  static_assert(kSmem <= kMaxSmem, "a block's shared memory");
};

template <int H>
__global__ void __launch_bounds__(kThreads, Layout<H>::kBlocksPerSm) policy_sample_kernel(
    const int32_t* __restrict__ packed,       // (B, C)
    const float* __restrict__ dirf,           // (B, F)
    const float* __restrict__ gumbel,         // (B, A)
    const __nv_bfloat16* __restrict__ w_img,  // (C*21, H)
    const __nv_bfloat16* __restrict__ wd,     // (F+1, H): [W0; b0]
    const __nv_bfloat16* __restrict__ w1,     // (H, H) (in, out)
    const float* __restrict__ b1,             // (H,)
    const __nv_bfloat16* __restrict__ wa,     // (H, A)
    const float* __restrict__ ba,             // (A,)
    const __nv_bfloat16* __restrict__ wv,     // (H, 1)
    const float* __restrict__ bv,             // (1,)
    int32_t* __restrict__ action_out,         // (B,)
    float* __restrict__ logp_out,             // (B,)
    float* __restrict__ value_out,            // (B,)
    int b, int c, int f, int na) {
  using L = Layout<H>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kW1);
  __nv_bfloat16* wds = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kWd);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kRing);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kX);
  __nv_bfloat16* whs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kWh);  // [Wa | wv | 0]
  float* lgs = reinterpret_cast<float*>(smem_raw + L::kLg);  // [logits | value]
  float* dirs = reinterpret_cast<float*>(smem_raw + L::kDirs);  // bf16(dirf), 1, 0...
  float* gums = reinterpret_cast<float*>(smem_raw + L::kGum);
  float* b1s = reinterpret_cast<float*>(smem_raw + L::kB1);
  float* bas = reinterpret_cast<float*>(smem_raw + L::kBa);  // ba, then bv at kA

  const int tid = threadIdx.x;
  mlp_load_weights<H>(w1, wd, b1, wa, ba, wv, bv, f + 1, na, w1s, wds, whs, b1s, bas);
  const int ntiles = (b + kTM - 1) / kTM;
  if (blockIdx.x < ntiles)
    onehot_prime<H, kThreads, L::kStages, L::kGroup>(c, w_img, H, 0, H, ring);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int s0 = tile * kTM;
    __syncthreads();  // the previous tile's readers are done
    mlp_load_dirs(dirf, b, f, s0, dirs);
    for (int i = tid; i < kTM * kA; i += kThreads) {
      const int s = i / kA, a = i % kA;
      gums[i] = s0 + s < b && a < na ? gumbel[static_cast<size_t>(s0 + s) * na + a] : 0.f;
    }
    const int warp = tid / 32, lane = tid % 32, grp = lane >> 2, tig = lane & 3;
    const int wm = warp & 3, r0 = 16 * wm + grp, n0 = (warp >> 2) * (H / 2);
    mlp_forward<H, L::kStages, L::kGroup, true>(
        packed, b, c, s0, tile + gridDim.x < ntiles, w_img, ring, wds, dirs, w1s, b1s, xs, xs,
        whs, lgs, warp, lane, grp, tig, wm, r0, n0);

    // Gumbel-max with the first index on ties, the log-softmax and the
    // value: one thread a sample.
    if (tid < kTM && s0 + tid < b) {
      const int s = tid, n = s0 + tid;
      const float neg_inf = __int_as_float(0xff800000);
      float lg[kA], z[kA], zmax = neg_inf, lmax = neg_inf;
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        lg[a] = lgs[s * 16 + a] + bas[a];
        z[a] = lg[a] + gums[s * kA + a];
        if (a < na) {
          zmax = fmaxf(zmax, z[a]);
          lmax = fmaxf(lmax, lg[a]);
        }
      }
      int act = 0;
#pragma unroll
      for (int a = kA - 1; a >= 0; --a)
        if (a < na && z[a] == zmax) act = a;
      float sez = 0.f, la = 0.f;
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        if (a < na) sez += expf(lg[a] - lmax);
        if (a == act) la = lg[a];
      }
      action_out[n] = act;
      logp_out[n] = la - lmax - logf(sez);
      value_out[n] = lgs[s * 16 + kA] + bas[kA];
    }
  }
}

template <int H>
int launch(const void* packed, const void* dirf, const void* gumbel,
           const void* w_img, const void* wd, const void* w1, const void* b1,
           const void* wa, const void* ba, const void* wv, const void* bv,
           void* action, void* logp, void* value, int b, int c, int f, int na,
           cudaStream_t st) {
  constexpr size_t smem = Layout<H>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      policy_sample_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, policy_sample_kernel<H>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (b + kTM - 1) / kTM;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = tiles < resident ? tiles : resident;
  policy_sample_kernel<H><<<blocks, kThreads, smem, st>>>(
      static_cast<const int32_t*>(packed), static_cast<const float*>(dirf),
      static_cast<const float*>(gumbel),
      static_cast<const __nv_bfloat16*>(w_img),
      static_cast<const __nv_bfloat16*>(wd),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(wa), static_cast<const float*>(ba),
      static_cast<const __nv_bfloat16*>(wv), static_cast<const float*>(bv),
      static_cast<int32_t*>(action), static_cast<float*>(logp),
      static_cast<float*>(value), b, c, f, na);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or -1
// for a hidden width the kernel is not built for.
extern "C" int mgt_policy_sample_launch(
    const void* packed, const void* dirf, const void* gumbel, const void* w_img,
    const void* wd, const void* w1, const void* b1, const void* wa,
    const void* ba, const void* wv, const void* bv, void* action, void* logp,
    void* value, int b, int c, int f, int na, int h, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MGT_POLICY_CASE(HH)                                                  \
  case HH:                                                                   \
    return launch<HH>(packed, dirf, gumbel, w_img, wd, w1, b1, wa, ba, wv,   \
                      bv, action, logp, value, b, c, f, na, st);
  switch (h) {
    MGT_POLICY_CASE(32)
    MGT_POLICY_CASE(64)
    MGT_POLICY_CASE(128)
    MGT_POLICY_CASE(256)
    default:
      return -1;
  }
#undef MGT_POLICY_CASE
}
