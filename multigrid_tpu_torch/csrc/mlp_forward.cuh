// The mlp ActorCritic's forward on the tensor cores, a tile of 64 samples
// at a time: the routine shared by the PPO loss kernel (fused_ppo.cu,
// whose backward follows it) and the rollout policy kernel
// (fused_policy.cu, whose sampling follows it).
//
// h = one_hot(packed) @ W_img + [bf16(dirf), 1] @ [W0; b0];
// x1 = bf16(relu(h)); x2 = bf16(relu(x1 @ W1 + b1));
// [logits | value] = x2 @ [Wa | wv] in f32, the heads' biases left to the
// caller. A block of 8 warps takes the tile, warp (wm, wn) owning rows
// 16*wm.. and columns wn*H/2.. of x1 and x2. The first layer is the one-hot
// product of onehot_mma.cuh (W_img streamed through a cp.async ring, the A
// fragments built from the cells in registers) plus one more K step for
// the direction features and the bias row; x2 = x1 @ W1 and the heads are
// mma.sync m16n8k16 products on bf16 tiles in shared memory (W1 and x1,
// rows padded by 16 bytes against bank conflicts; [Wa | wv] 16 columns
// wide). Numerics follow the TPU kernels: bf16 matrix operands, f32 sums,
// f32 biases of the trunk.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "onehot_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 row tiles of 16 x 2 column halves
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 64;        // samples per tile
constexpr int kA = 8;          // actions at most
constexpr int kF1 = 16;        // direction features + the bias column, at most
constexpr int kHeadLd = 24;    // bf16 row stride of 16-wide tiles such as [Wa | wv]
                               // (no bank conflicts)

constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

__device__ __forceinline__ float bf(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
}

// The forward's weights into shared memory, by every thread of the block:
// W1 (H, H) into rows of stride H + 8 by 16-byte cp.async (one committed
// group, which the first tile's ring waits on before its first stage: w1
// must be 16-byte aligned); [W0; b0] (f1 rows) as 16 rows, zero past f1;
// [Wa | wv | 0] as (H, kHeadLd), Wa's na columns then wv at column kA;
// b1; ba (zero past na) with bv at bas[kA].
template <int H>
__device__ __forceinline__ void mlp_load_weights(
    const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ wd,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ wa,
    const float* __restrict__ ba, const __nv_bfloat16* __restrict__ wv,
    const float* __restrict__ bv, int f1, int na, __nv_bfloat16* w1s, __nv_bfloat16* wds,
    __nv_bfloat16* whs, float* b1s, float* bas) {
  constexpr int kLd = H + 8;
  const int tid = threadIdx.x;
  for (int i = tid; i < H * H / 8; i += kThreads) {
    const int r = i / (H / 8), q = (i % (H / 8)) * 8;
    cp_async16(w1s + r * kLd + q, w1 + r * H + q, true);
  }
  cp_async_commit();
  for (int i = tid; i < 16 * H; i += kThreads) {
    const int r = i / H;
    wds[r * kLd + i % H] = r < f1 ? wd[i] : __float2bfloat16(0.f);
  }
  for (int i = tid; i < H * kHeadLd; i += kThreads) {
    const int r = i / kHeadLd, a = i % kHeadLd;
    whs[i] = a < na ? wa[r * na + a] : a == kA ? wv[r] : __float2bfloat16(0.f);
  }
  for (int i = tid; i < H; i += kThreads) b1s[i] = b1[i];
  if (tid < kA) bas[tid] = tid < na ? ba[tid] : 0.f;
  if (tid == kA) bas[kA] = bv[0];
}

// The tile's direction features as the first layer's last K step: row s
// holds bf16(dirf[s0 + s]) (f of them), then 1 for the bias row, then 0;
// rows past the batch are 0.
__device__ __forceinline__ void mlp_load_dirs(const float* __restrict__ dirf, int b, int f,
                                              int s0, float* dirs) {
  for (int i = threadIdx.x; i < kTM * kF1; i += kThreads) {
    const int s = i / kF1, q = i % kF1;
    float v = 0.f;
    if (s0 + s < b) {
      if (q < f) v = bf(dirf[static_cast<size_t>(s0 + s) * f + q]);
      else if (q == f) v = 1.f;
    }
    dirs[i] = v;
  }
}

// The forward of the tile of rows s0 .. s0 + 64 (every thread of the block
// calls it). The ring must be primed (onehot_prime) for this tile; the
// first layer's barriers also publish the caller's per-tile inputs (dirs
// and its own); with `prime_next` the ring is primed for the next tile as
// soon as the first layer is done. Writes x1 to x1s, x2 to x2s (rows past
// the batch 0) and [logits | value] without their biases to lgs, (kTM,
// 16) f32. With kSharedX, x2s is x1s: a barrier parts the x2 product from
// its stores. Ends with a barrier. The thread's place in the tile comes
// from the caller (warp, lane, grp = lane / 4, tig = lane % 4, wm = warp %
// 4, r0 = 16 wm + grp, n0 = (warp / 4) H / 2): recomputed here, the loss
// kernel's copies and these stayed live side by side (more registers,
// and spills at H 128).
template <int H, int kStages, int kGroup, bool kSharedX>
__device__ __forceinline__ void mlp_forward(
    const int32_t* __restrict__ packed, int b, int c, int s0, bool prime_next,
    const __nv_bfloat16* __restrict__ w_img, __nv_bfloat16* ring, const __nv_bfloat16* wds,
    const float* dirs, const __nv_bfloat16* w1s, const float* b1s, __nv_bfloat16* x1s,
    __nv_bfloat16* x2s, const __nv_bfloat16* whs, float* lgs, int warp, int lane, int grp,
    int tig, int wm, int r0, int n0) {
  constexpr int kLd = H + 8;
  constexpr int kNT = H / 16;  // n8 tiles of a warp: half of H
  // The K loops of x1 @ W1 and of the heads unroll fully up to H 128; at
  // H 256 by 4 (fully unrolled, their early fragment loads took the last
  // registers and spilled).
  constexpr int kKK = H > 128 ? 4 : H / 16;

  // h = one_hot(packed) @ W_img, then one more K step for [bf16(dirf), 1]
  // @ [W0; b0]; x1 = bf16(relu(h)).
  float acc[kNT][4];
  zero(acc);
  onehot_mma_primed<H, kNT, kThreads, kStages, kGroup>(packed, b, c, s0, r0, w_img, H, 0, H,
                                                       ring, n0, acc);
  if (prime_next) onehot_prime<H, kThreads, kStages, kGroup>(c, w_img, H, 0, H, ring);
  {
    uint32_t a[4];
    const float* d0 = dirs + r0 * kF1 + 2 * tig;
    const float* d1 = d0 + 8 * kF1;
    a[0] = pack_bf16(d0[0], d0[1]);
    a[1] = pack_bf16(d1[0], d1[1]);
    a[2] = pack_bf16(d0[8], d0[9]);
    a[3] = pack_bf16(d1[8], d1[9]);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bb[4];
      load_b2(bb, wds, kLd, 0, n0 + 16 * np, lane);
      mma_16816(acc[2 * np], a, bb[0], bb[1]);
      mma_16816(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + nt * 8 + 2 * tig;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<__nv_bfloat162*>(x1s + (r0 + 8 * i) * kLd + col) =
          __floats2bfloat162_rn(fmaxf(acc[nt][2 * i], 0.f), fmaxf(acc[nt][2 * i + 1], 0.f));
  }
  __syncthreads();

  // x2 = bf16(relu(x1 @ W1 + b1)); rows past the batch 0.
  zero(acc);
#pragma unroll (kKK)
  for (int kk = 0; kk < H / 16; ++kk) {
    uint32_t a[4];
    load_a(a, x1s, kLd, 16 * wm, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bb[4];
      load_b2(bb, w1s, kLd, 16 * kk, n0 + 16 * np, lane);
      mma_16816(acc[2 * np], a, bb[0], bb[1]);
      mma_16816(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
  if (kSharedX) __syncthreads();  // every warp has read x1
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + nt * 8 + 2 * tig;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = s0 + r0 + 8 * i < b;
      *reinterpret_cast<__nv_bfloat162*>(x2s + (r0 + 8 * i) * kLd + col) =
          __floats2bfloat162_rn(in ? fmaxf(acc[nt][2 * i] + b1s[col], 0.f) : 0.f,
                                in ? fmaxf(acc[nt][2 * i + 1] + b1s[col + 1], 0.f) : 0.f);
    }
  }
  __syncthreads();

  // The heads, [logits | value] = x2 @ [Wa | wv] (f32 sums), warps 0-3 a
  // 16-row tile each.
  if (warp < 4) {
    float hacc[2][4];
    zero(hacc);
#pragma unroll (kKK)
    for (int kk = 0; kk < H / 16; ++kk) {
      uint32_t a[4], bb[4];
      load_a(a, x2s, kLd, 16 * warp, 16 * kk, lane);
      load_b2(bb, whs, kHeadLd, 16 * kk, 0, lane);
      mma_16816(hacc[0], a, bb[0], bb[1]);
      mma_16816(hacc[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* row = lgs + (16 * warp + grp + 8 * i) * 16 + nt * 8 + 2 * tig;
        row[0] = hacc[nt][2 * i];
        row[1] = hacc[nt][2 * i + 1];
      }
  }
  __syncthreads();
}

}  // namespace
