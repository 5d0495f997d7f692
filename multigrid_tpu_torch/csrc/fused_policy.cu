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
// What bounds it on this card: operations. Per sample the first layer adds
// 3*C weight rows of H (3.1e8 f32 adds at B = 16384, C = 49, H = 128: 4.6 us
// on the CUDA cores), the dense products are 2*(H*H + (F+1)*H + 9*H) flops
// (0.6 us on the tensor cores), and the compulsory bytes (packed cells,
// features, noise, weights, 12 bytes out a sample) are about 4.3 MB (1.3
// us). In practice the gather of 3*C rows of the 263 KB bf16 W_img from L2
// (0.6 GB at the flagship) limits it, as it does the first-layer kernel of
// csrc/fused_linear.cu. The design: one warp per sample, with the first
// layer's gather of csrc/onehot_rows.cuh (lane l owning columns l, l+32,
// ..., so each weight-row read is coalesced; the sample's cells read once,
// 32 at a time, and broadcast with shuffles). W1,
// [W0; b0] (bf16), Wa, wv and the biases (f32) sit in shared memory, loaded
// once per block, and blocks sized to the card's occupancy walk the batch.
// x1 goes through the warp's own row of shared memory; x2, the logits and the
// value stay in registers: warp shuffles sum the heads, lane 0 takes the
// arg-max and the log-sum-exp and writes 12 bytes. Nothing of (B, H) or
// (B, A) reaches device memory. The trunk and heads are FMA loops on the
// CUDA cores, not tensor cores: later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kA = 8;    // actions at most
constexpr int kF1 = 16;  // direction features + the bias row, at most

// Shared memory: bf16 W1 (H, H) and [W0; b0] (kF1, H); f32 Wa^T (kA, H), wv,
// b1, ba (kA), bv (padded to 4) and one x1 row per warp.
template <int H>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (H * H + kF1 * H) +
         sizeof(float) * (kA * H + 2 * H + kA + 4 + kWarps * H);
}

template <int H>
__global__ void __launch_bounds__(kThreads) policy_sample_kernel(
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
  constexpr int kCols = H / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wds = w1s + H * H;
  float* was = reinterpret_cast<float*>(wds + kF1 * H);  // (kA, H)
  float* wvs = was + kA * H;
  float* b1s = wvs + H;
  float* bas = b1s + H;
  float* bvs = bas + kA;
  float* x1s = bvs + 4;  // (kWarps, H)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int f1 = f + 1;
  for (int i = tid; i < H * H; i += kThreads) w1s[i] = w1[i];
  for (int i = tid; i < f1 * H; i += kThreads) wds[i] = wd[i];
  for (int i = tid; i < kA * H; i += kThreads) {
    const int a = i / H, j = i % H;
    was[i] = a < na ? __bfloat162float(wa[j * na + a]) : 0.f;
  }
  for (int i = tid; i < H; i += kThreads) {
    wvs[i] = __bfloat162float(wv[i]);
    b1s[i] = b1[i];
  }
  if (tid < kA) bas[tid] = tid < na ? ba[tid] : 0.f;
  if (tid == 0) bvs[0] = bv[0];
  __syncthreads();

  float* x1w = x1s + warp * H;
  for (int n = blockIdx.x * kWarps + warp; n < b; n += gridDim.x * kWarps) {
    // x1, the first layer (onehot_rows.cuh), into the warp's row.
    float x1[kCols];
    first_layer_x1<H>(packed + static_cast<size_t>(n) * c, c, dirf + static_cast<size_t>(n) * f,
                      f, w_img, wds, lane, x1);
#pragma unroll
    for (int i = 0; i < kCols; ++i) x1w[lane + 32 * i] = x1[i];
    __syncwarp();

    // x2 = bf16(relu(x1 @ W1 + b1)), then each lane's share of the heads.
    float acc2[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc2[i] = 0.f;
    for (int k = 0; k < H; ++k) {
      const float x = x1w[k];
      const __nv_bfloat16* wr = w1s + k * H + lane;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc2[i] += x * __bfloat162float(wr[32 * i]);
    }
    __syncwarp();  // every lane has read x1w before the next sample writes it
    float lg[kA], pv = 0.f;
#pragma unroll
    for (int a = 0; a < kA; ++a) lg[a] = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int j = lane + 32 * i;
      const float x2 = bf(fmaxf(acc2[i] + b1s[j], 0.f));
#pragma unroll
      for (int a = 0; a < kA; ++a) lg[a] += x2 * was[a * H + j];
      pv += x2 * wvs[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int a = 0; a < kA; ++a) lg[a] += __shfl_xor_sync(0xffffffffu, lg[a], off);
      pv += __shfl_xor_sync(0xffffffffu, pv, off);
    }

    // Gumbel-max with the first index on ties, and the log-softmax.
    if (lane == 0) {
      const float neg_inf = __int_as_float(0xff800000);
      float zbest = neg_inf, zmax = neg_inf;
      int act = 0;
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        if (a < na) {
          lg[a] += bas[a];
          const float z = lg[a] + gumbel[static_cast<size_t>(n) * na + a];
          if (z > zbest) {
            zbest = z;
            act = a;
          }
          zmax = fmaxf(zmax, lg[a]);
        }
      }
      float sez = 0.f, la = 0.f;
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        if (a < na) sez += expf(lg[a] - zmax);
        if (a == act) la = lg[a];
      }
      action_out[n] = act;
      logp_out[n] = la - zmax - logf(sez);
      value_out[n] = pv + bvs[0];
    }
  }
}

template <int H>
int launch(const void* packed, const void* dirf, const void* gumbel,
           const void* w_img, const void* wd, const void* w1, const void* b1,
           const void* wa, const void* ba, const void* wv, const void* bv,
           void* action, void* logp, void* value, int b, int c, int f, int na,
           cudaStream_t st) {
  constexpr size_t smem = smem_bytes<H>();
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
  const int wanted = (b + kWarps - 1) / kWarps;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = wanted < resident ? wanted : resident;
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
