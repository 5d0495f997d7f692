// The first layer's gather on packed observation cells, for the rollout
// policy kernel of fused_policy.cu (its x1), and the one-hot channel
// constants that onehot_mma.cuh (the first-layer and loss kernels'
// tensor-core product) shares.
//
// A packed cell t<<8|c<<4|s has exactly three ones in its 21 channels (type
// t, color 11+c, state 17+s; a field out of its channel's range has none),
// so one_hot(packed) @ W, W the flax layout (C*21, H) with feature index
// cell*21 + ch, is the sum of 3*C weight rows. One warp computes one
// sample's row: lane l owns columns l, l+32, ..., so each weight-row read is
// coalesced; the sample's cells are read 32 at a time and broadcast with
// shuffles. Every lane of the warp must take part. Numerics follow the TPU
// kernels: bf16 weights, f32 sums in cell order (type, color, state).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kNch = 21;  // one-hot channels: 11 types, 6 colors, 4 states
constexpr int kTypes = 11;
constexpr int kColors = 6;
constexpr int kStates = 4;

__device__ __forceinline__ float bf(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16(x));
}

// acc[i] += column lane + 32*i of one_hot(p[0..c)) @ w, for the columns
// below h; w is (c*21, h).
template <int kCols>
__device__ __forceinline__ void gather_onehot_rows(
    const int32_t* __restrict__ p, int c, const __nv_bfloat16* __restrict__ w,
    int h, int lane, float acc[kCols]) {
  for (int c0 = 0; c0 < c; c0 += 32) {
    const int mine = c0 + lane < c ? p[c0 + lane] : 0;
    const int cnt = min(32, c - c0);
    for (int k = 0; k < cnt; ++k) {
      const int v = __shfl_sync(0xffffffffu, mine, k);
      const int t = v >> 8, col = (v >> 4) & 15, st = v & 15;
      const __nv_bfloat16* wc = w + static_cast<size_t>(c0 + k) * kNch * h + lane;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if (lane + 32 * i >= h) break;
        if (t >= 0 && t < kTypes) acc[i] += __bfloat162float(wc[t * h + 32 * i]);
        if (col < kColors) acc[i] += __bfloat162float(wc[(kTypes + col) * h + 32 * i]);
        if (st < kStates)
          acc[i] += __bfloat162float(wc[(kTypes + kColors + st) * h + 32 * i]);
      }
    }
  }
}

// The mlp ActorCritic's first layer for one sample, x1 = bf16(relu(
// one_hot(p) @ W_img + [bf16(dirf), 1] @ [W0; b0])), the lane's H/32
// columns as floats. dirf is the sample's f <= 31 features; wd is (f+1, H),
// its last row the bias.
template <int H>
__device__ __forceinline__ void first_layer_x1(
    const int32_t* __restrict__ p, int c, const float* __restrict__ dirf, int f,
    const __nv_bfloat16* __restrict__ w_img, const __nv_bfloat16* wd, int lane,
    float x1[H / 32]) {
  constexpr int kCols = H / 32;
  float acc[kCols], d[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = d[i] = 0.f;
  gather_onehot_rows<kCols>(p, c, w_img, H, lane, acc);
  const float mine = lane < f ? bf(dirf[lane]) : (lane == f ? 1.f : 0.f);
  for (int q = 0; q <= f; ++q) {
    const float x = __shfl_sync(0xffffffffu, mine, q);
#pragma unroll
    for (int i = 0; i < kCols; ++i) d[i] += x * __bfloat162float(wd[q * H + lane + 32 * i]);
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) x1[i] = bf(fmaxf(acc[i] + d[i], 0.f));
}

}  // namespace
