// The whole clipped-PPO loss of the mlp ActorCritic, forward and backward.
//
// Replaces the TPU kernel multigrid_tpu/ops/fused_ppo.py::_kernel. For each
// sample: h = one_hot(packed) @ W_img + [dirf, 1] @ [W0; b0]; x1 = relu(h);
// x2 = relu(x1 @ W1 + b1); logits = x2 @ Wa + ba, value = x2 @ wv + bv;
// log-softmax, ratio, clipped surrogate, value error and entropy; then the
// backward: dlogits (the gradient goes through the unclipped branch where
// u1 <= u2, dH/dz = -p (log p + H)), dx2 and dx1 through the relu masks, and
// every weight gradient summed over the batch, with the pg/vf/entropy sums.
// Numerics follow the TPU kernel: bf16 matrix operands (weights,
// activations, dlogits, dx), f32 sums, f32 softmax and loss.
//
// What bounds it on this card: operations. Per sample it does the first
// layer's one-hot product (3*C weight rows as adds, or 2*C*21*H as a dense
// product; 70 GFLOP at B = 262144, C = 49, H = 128, padded to whole cell
// blocks), three HxH products (x2, dx1 and dW1, 3*2*H*H), the heads and a
// few hundred more; the compulsory bytes are the packed cells and the
// per-sample inputs (about 70 MB at the flagship) and dx1 out.
//
// Redesigned for Hopper's tensor cores. A block of 8 warps walks tiles of
// 64 samples and keeps every (sample, H) activation on chip. The forward
// is the routine of mlp_forward.cuh, shared with the rollout policy kernel
// (fused_policy.cu): the first layer is the one-hot product of
// onehot_mma.cuh (W_img streamed through a cp.async ring, the A fragments
// built from the cells in registers) plus one more K step for
// [bf16(dirf), 1] @ [W0; b0]; x2 = x1 @ W1, dx1 = dx2 @ W1^T, dW1 +=
// x1^T dx2, the heads [logits | value] = x2 @ [Wa | wv]
// and [dWa | dWv] += x2^T [dlogits | dv] are mma.sync m16n8k16 products on
// bf16 tiles in shared memory (W1, rows padded by 16 bytes against bank
// conflicts; the tile's x1, x2, dx2), with dW1 and dWa in registers across
// all the block's tiles. The loss and dlogits take one thread a sample,
// dx2 (K <= 9) one thread a column, on the CUDA cores. A stage of the
// W_img ring holds 7 channels' steps (3 stages): fewer, larger stages beat
// a deeper ring of small ones. Blocks write per-block partials that a second
// pass sums in a fixed order, so the gradients are the same from run to
// run. mma.sync rather than wgmma: see onehot_mma.cuh.
//
// Per-agent policies take the kernel with an agent axis (kAgents), the
// batched instance that jax.vmap makes of the TPU kernel over stacked
// per-agent weights: blockIdx.y is the agent, each agent's per-sample
// inputs, weights, dx1 and partials follow its predecessors' contiguously,
// every agent gets gridDim.x persistent blocks, and the second pass sums
// each agent's partials apart. The single-agent instance keeps its code
// (kAgents false: the offsets fold to 0), since at H 128 it sits at the
// register cap; the agent instance addresses its samples by row (agent * B
// + sample), its weights by pointer.
//
// One (sample, H) tensor leaves the chip: dx1, bf16 (67 MB at the
// flagship), because dW_img, the (C*21, H) f32 gradient of the first layer,
// does not fit a block's shared memory: the wrapper runs the gradient
// kernel of csrc/fused_linear.cu on it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_forward.cuh"

namespace {

constexpr int kStages = 3;   // W_img stages in the ring
constexpr int kGroup = 7;    // channels a stage: 112 W_img rows
constexpr int kDlLd = kHeadLd;  // bf16 row stride of the 16-wide [Wa | wv] and
                                // [dlogits | dv] tiles
constexpr int kTailWarp = 12;  // per-warp sums: dba (8), dbv, pg, vf, entropy

struct Coefs {
  float inv_b, c_ent, c_vf, lo, hi;
};

template <int H>
struct Layout {
  static constexpr int kLd = H + 8;              // bf16 row stride of H-wide tiles
  static constexpr int kNg = kThreads / H;       // threads sharing a column
  static constexpr int kPer = kTM / kNg;         // samples of a thread
  static constexpr int kNT = H / 16;             // n8 tiles of a warp: half of H
  static constexpr int kRT = H / 16;             // dW1: 16-row tiles
  static constexpr int kCS = kWarps / kRT < H / 16 ? kWarps / kRT : H / 16;  // column splits
  static constexpr int kWNT = H / kCS / 8;       // dW1: n8 tiles of a warp
  static constexpr int kW1Warps = kRT * kCS;
  static constexpr int kTail = 9 * H + 12;       // dWa, dWv, dba, dbv, sums
  // Byte offsets in shared memory.
  static constexpr int kW1 = 0;                                        // (H, kLd) bf16
  static constexpr int kWd = kW1 + align16(H * kLd * 2);               // (16, kLd) bf16
  static constexpr int kRing = kWd + align16(16 * kLd * 2);  // kStages x (16 kGroup, kLd)
  static constexpr int kBig = kRing + align16(kStages * 16 * kGroup * kLd * 2);
  static constexpr int kBigBytes = 3 * kTM * kLd * 2 > kThreads * (kF1 + 1) * 4
                                       ? 3 * kTM * kLd * 2 : kThreads * (kF1 + 1) * 4;
  static constexpr int kDl = kBig + align16(kBigBytes);                // (kTM, kDlLd) bf16
  static constexpr int kDirs = kDl + align16(kTM * kDlLd * 2);         // (kTM, kF1) f32
  static constexpr int kWh = kDirs + kTM * kF1 * 4;                    // (H, kDlLd) bf16
  static constexpr int kLg = kWh + align16(H * kDlLd * 2);             // (kTM, 16) f32
  static constexpr int kB1 = kLg + kTM * 16 * 4;                       // (H,) f32
  static constexpr int kBa = kB1 + H * 4;                              // ba (kA), bv
  static constexpr int kSmp = kBa + 16 * 4;                            // (4, kTM): the tile's
                                                                       // action, old_logp, adv, target
  static constexpr int kRed = kSmp + 4 * kTM * 4;                      // (kWarps, kTailWarp)
  static constexpr size_t kSmem = kRed + kWarps * kTailWarp * 4;
};

// The whole loss, forward and backward, a tile of 64 samples at a time; a
// block walks tiles tile = blockIdx.x, + gridDim.x, ... and writes its
// partial sums once. With kAgents, of agent blockIdx.y's arrays (shapes
// below are an agent's).
template <int H, bool kAgents>
__global__ void __launch_bounds__(kThreads, 1) ppo_loss_kernel(
    const int32_t* __restrict__ packed,        // (B, C)
    const float* __restrict__ dirf,            // (B, F)
    const int32_t* __restrict__ action,        // (B,)
    const float* __restrict__ old_logp,        // (B,)
    const float* __restrict__ adv,             // (B,)
    const float* __restrict__ target,          // (B,)
    const __nv_bfloat16* __restrict__ w_img,   // (C*21, H)
    const __nv_bfloat16* __restrict__ wd,      // (F+1, H): [W0; b0]
    const __nv_bfloat16* __restrict__ w1,      // (H, H) (in, out)
    const float* __restrict__ b1,              // (H,)
    const __nv_bfloat16* __restrict__ wa,      // (H, A)
    const float* __restrict__ ba,              // (A,)
    const __nv_bfloat16* __restrict__ wv,      // (H,)
    const float* __restrict__ bv,              // (1,)
    __nv_bfloat16* __restrict__ dx1_out,       // (B, H)
    float* __restrict__ partial,               // (gridDim.x, P)
    int b, int c, int f, int na, Coefs k) {
  using L = Layout<H>;
  constexpr int kLd = L::kLd;
  // The agent's samples are rows base .. end of the (N * B)-row arrays: an
  // index rather than seven pointers kept live in registers.
  const int base = kAgents ? static_cast<int>(blockIdx.y) * b : 0, end = base + b;
  if (kAgents) {
    const size_t agent = blockIdx.y;
    w_img += agent * c * kNch * H;
    wd += agent * (f + 1) * H;
    w1 += agent * H * H;
    b1 += agent * H;
    wa += agent * H * na;
    ba += agent * na;
    wv += agent * H;
    bv += agent;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kW1);
  __nv_bfloat16* wds = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kWd);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kRing);
  __nv_bfloat16* x1s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kBig);  // (kTM, kLd)
  __nv_bfloat16* x2s = x1s + kTM * kLd;     // (kTM, kLd); dx1 once x2 is spent
  __nv_bfloat16* dx2s = x2s + kTM * kLd;    // (kTM, kLd)
  __nv_bfloat16* dlv = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kDl);   // [dl | dv]
  float* dirs = reinterpret_cast<float*>(smem_raw + L::kDirs);  // bf16(dirf), 1, 0...
  __nv_bfloat16* whs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kWh);  // [Wa | wv | 0]
  float* lgs = reinterpret_cast<float*>(smem_raw + L::kLg);     // [logits | value]
  float* b1s = reinterpret_cast<float*>(smem_raw + L::kB1);
  float* bas = reinterpret_cast<float*>(smem_raw + L::kBa);    // ba, then bv at kA
  int32_t* acts = reinterpret_cast<int32_t*>(smem_raw + L::kSmp);
  float* olps = reinterpret_cast<float*>(acts + kTM);
  float* advs = olps + kTM;
  float* tgts = advs + kTM;
  float* wred = reinterpret_cast<float*>(smem_raw + L::kRed);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int f1 = f + 1;
  mlp_load_weights<H>(w1, wd, b1, wa, ba, wv, bv, f1, na, w1s, wds, whs, b1s, bas);
  for (int i = tid; i < kTM * kDlLd; i += kThreads) dlv[i] = __float2bfloat16(0.f);
  const int ntiles = (b + kTM - 1) / kTM;
  if (blockIdx.x < ntiles) onehot_prime<H, kThreads, kStages, kGroup>(c, w_img, H, 0, H, ring);

  // Forward products: warp (wm, wn) owns rows 16*wm.. and columns wn*H/2...
  const int wm = warp & 3, r0 = 16 * wm + grp, n0 = (warp >> 2) * (H / 2);
  // Column-owner mapping of the H-wide CUDA-core phases: column j, samples
  // g + kNg*i.
  const int j = tid % H;
  const int g0 = tid / H;
  // dW1 block of this warp: rows 16*rt.., columns cs*H/kCS...
  const int rt = warp % L::kRT, cs = warp / L::kRT;

  float acc_w1[L::kWNT][4], acc_wa[2][4];
  zero(acc_w1);
  zero(acc_wa);
  float acc_wd[kF1];
#pragma unroll
  for (int q = 0; q < kF1; ++q) acc_wd[q] = 0.f;
  float acc_ba[kA];
#pragma unroll
  for (int a = 0; a < kA; ++a) acc_ba[a] = 0.f;
  float acc_b1 = 0.f, acc_bv = 0.f, sum_pg = 0.f, sum_vf = 0.f, sum_ent = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int s0 = base + tile * kTM;
    __syncthreads();  // the previous tile's readers are done
    mlp_load_dirs(dirf, end, f, s0, dirs);
    if (tid < kTM && s0 + tid < end) {
      const int n = s0 + tid;
      acts[tid] = action[n];
      olps[tid] = old_logp[n];
      advs[tid] = adv[n];
      tgts[tid] = target[n];
    }

    // The forward (mlp_forward.cuh): x1, x2 and [logits | value] of the
    // tile in shared memory; the ring, free again, primed for the next tile.
    mlp_forward<H, kStages, kGroup, false>(packed, end, c, s0, tile + gridDim.x < ntiles, w_img,
                                          ring, wds, dirs, w1s, b1s, x1s, x2s, whs, lgs, warp, lane, grp, tig,
                                          wm, r0, n0);

    // The loss and dlogits: one thread a sample.
    if (tid < kTM) {
      const int s = tid;
      if (s0 + s >= end) {
#pragma unroll
        for (int a = 0; a <= kA; ++a) dlv[s * kDlLd + a] = __float2bfloat16(0.f);
      } else {
        float lg[kA];
        float zmax = __int_as_float(0xff800000);  // -inf
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          lg[a] = lgs[s * 16 + a];
          if (a < na) {
            lg[a] += bas[a];
            zmax = fmaxf(zmax, lg[a]);
          }
        }
        float ez[kA], sez = 0.f;
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          ez[a] = a < na ? expf(lg[a] - zmax) : 0.f;
          sez += ez[a];
        }
        const float lse = logf(sez);
        const int act = acts[s];
        float logp[kA], prob[kA], lp = 0.f, ent = 0.f;
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          logp[a] = a < na ? lg[a] - zmax - lse : 0.f;
          prob[a] = a < na ? ez[a] / sez : 0.f;
          if (a == act) lp = logp[a];
          ent += prob[a] * logp[a];
        }
        ent = -ent;
        const float av = advs[s];
        const float ratio = expf(lp - olps[s]);
        const float u1 = ratio * av;
        const float u2 = fminf(fmaxf(ratio, k.lo), k.hi) * av;
        const float verr = (lgs[s * 16 + kA] + bas[kA]) - tgts[s];
        const float coef = u1 <= u2 ? (-k.inv_b * av) * ratio : 0.f;
        const float dv = k.c_vf * verr;
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          const float dl = a < na ? coef * ((a == act ? 1.f : 0.f) - prob[a])
                                        + k.c_ent * prob[a] * (logp[a] + ent)
                                  : 0.f;
          acc_ba[a] += dl;
          dlv[s * kDlLd + a] = __float2bfloat16(dl);
        }
        acc_bv += dv;
        sum_pg += -fminf(u1, u2);
        sum_vf += 0.5f * verr * verr;
        sum_ent += ent;
        dlv[s * kDlLd + kA] = __float2bfloat16(dv);
      }
    }
    __syncthreads();

    // dx2 = dlogits @ Wa^T + dv wv^T, through the relu: bf16.
    float waj[kA + 1];
#pragma unroll
    for (int a = 0; a <= kA; ++a) waj[a] = __bfloat162float(whs[j * kDlLd + a]);
#pragma unroll 1
    for (int i = 0; i < L::kPer; ++i) {
      const int s = g0 + L::kNg * i;
      float d = 0.f;
#pragma unroll
      for (int a = 0; a <= kA; ++a) d += waj[a] * __bfloat162float(dlv[s * kDlLd + a]);
      const float g = __bfloat162float(x2s[s * kLd + j]) > 0.f ? bf(d) : 0.f;
      dx2s[s * kLd + j] = __float2bfloat16(g);
      acc_b1 += g;
    }
    __syncthreads();

    // dWa, dWv += x2^T @ [dlogits | dv]: warp w owns rows 16w...
    if (warp < H / 16) {
#pragma unroll
      for (int kk = 0; kk < kTM / 16; ++kk) {
        uint32_t a[4], bb[4];
        load_a_t(a, x2s, kLd, 16 * warp, 16 * kk, lane);
        load_b2(bb, dlv, kDlLd, 16 * kk, 0, lane);
        mma_16816(acc_wa[0], a, bb[0], bb[1]);
        mma_16816(acc_wa[1], a, bb[2], bb[3]);
      }
    }
    // dW1 += x1^T @ dx2.
    if (warp < L::kW1Warps) {
#pragma unroll
      for (int kk = 0; kk < kTM / 16; ++kk) {
        uint32_t a[4];
        load_a_t(a, x1s, kLd, 16 * rt, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < L::kWNT / 2; ++np) {
          uint32_t bb[4];
          load_b2(bb, dx2s, kLd, 16 * kk, cs * (H / L::kCS) + 16 * np, lane);
          mma_16816(acc_w1[2 * np], a, bb[0], bb[1]);
          mma_16816(acc_w1[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    // dx1 = dx2 @ W1^T, through the relu: bf16, into x2's tile once every
    // reader of x2 is done.
    float acc[L::kNT][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      uint32_t a[4];
      load_a(a, dx2s, kLd, 16 * wm, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < L::kNT / 2; ++np) {
        uint32_t bb[4];
        load_b2_t(bb, w1s, kLd, 16 * kk, n0 + 16 * np, lane);
        mma_16816(acc[2 * np], a, bb[0], bb[1]);
        mma_16816(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();
    __nv_bfloat16* dx1s = x2s;
#pragma unroll
    for (int nt = 0; nt < L::kNT; ++nt) {
      const int col = n0 + nt * 8 + 2 * tig;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(x1s + r * kLd + col);
        *reinterpret_cast<__nv_bfloat162*>(dx1s + r * kLd + col) = __floats2bfloat162_rn(
            __bfloat162float(x.x) > 0.f ? acc[nt][2 * i] : 0.f,
            __bfloat162float(x.y) > 0.f ? acc[nt][2 * i + 1] : 0.f);
      }
    }
    __syncthreads();

    // dx1 out to memory for dW_img; dWd += [dirf, 1]^T dx1.
    for (int i = tid; i < kTM * H / 8; i += kThreads) {
      const int s = i / (H / 8), q = (i % (H / 8)) * 8;
      if (s0 + s < end)
        *reinterpret_cast<uint4*>(dx1_out + static_cast<size_t>(s0 + s) * H + q) =
            *reinterpret_cast<const uint4*>(dx1s + s * kLd + q);
    }
#pragma unroll 1
    for (int i = 0; i < L::kPer; ++i) {
      const int s = g0 + L::kNg * i;
      const float g = __bfloat162float(dx1s[s * kLd + j]);
#pragma unroll
      for (int q = 0; q < kF1; ++q) acc_wd[q] += g * dirs[s * kF1 + q];
    }
  }
  __syncthreads();

  // Per-block partial: [dW1 H*H][db1 H][dWd (F+1)*H][tail 9H+12], the tail
  // dWa (H, kA) at kk*kA + a, dWv at kA*H + kk, then dba, dbv and the three
  // sums at 9H.
  const int p_len = H * H + H + f1 * H + L::kTail;
  float* out = partial + ((kAgents ? static_cast<size_t>(blockIdx.y) * gridDim.x : 0)
                          + blockIdx.x) * p_len;
  float* tail = out + H * H + H + f1 * H;
  if (warp < L::kW1Warps) {
#pragma unroll
    for (int nt = 0; nt < L::kWNT; ++nt) {
      const int col = cs * (H / L::kCS) + nt * 8 + 2 * tig;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * rt + grp + 8 * i;
        out[row * H + col] = acc_w1[nt][2 * i];
        out[row * H + col + 1] = acc_w1[nt][2 * i + 1];
      }
    }
  }
  if (warp < H / 16) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * warp + grp + 8 * i;
      tail[row * kA + 2 * tig] = acc_wa[0][2 * i];
      tail[row * kA + 2 * tig + 1] = acc_wa[0][2 * i + 1];
      if (tig == 0) tail[kA * H + row] = acc_wa[1][2 * i];  // column 8: dv
    }
  }

  float* red = reinterpret_cast<float*>(x1s);
#pragma unroll
  for (int q = 0; q < kF1; ++q) red[(g0 * (kF1 + 1) + q) * H + j] = acc_wd[q];
  red[(g0 * (kF1 + 1) + kF1) * H + j] = acc_b1;
  // The per-sample sums, over the warp's lanes (a fixed tree), then the
  // warps in order.
  float tv[kTailWarp];
#pragma unroll
  for (int a = 0; a < kA; ++a) tv[a] = acc_ba[a];
  tv[8] = acc_bv;
  tv[9] = sum_pg;
  tv[10] = sum_vf;
  tv[11] = sum_ent;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int v = 0; v < kTailWarp; ++v) tv[v] += __shfl_xor_sync(0xffffffffu, tv[v], off);
  if (lane == 0) {
#pragma unroll
    for (int v = 0; v < kTailWarp; ++v) wred[warp * kTailWarp + v] = tv[v];
  }
  __syncthreads();
  if (tid < H) {
    float s = 0.f;
    for (int g = 0; g < L::kNg; ++g) s += red[(g * (kF1 + 1) + kF1) * H + tid];
    out[H * H + tid] = s;
    for (int q = 0; q < f1; ++q) {
      s = 0.f;
      for (int g = 0; g < L::kNg; ++g) s += red[(g * (kF1 + 1) + q) * H + tid];
      out[H * H + H + q * H + tid] = s;
    }
  }
  if (tid < kTailWarp) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wred[w * kTailWarp + tid];
    tail[9 * H + tid] = s;
  }
}

// out[a][i] = sum over r of partial[a][r][i], r in order, for each of
// `agents` agents' `rows` partials of n entries.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int rows, int n, int agents) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * agents) return;
  const int a = i / n, j = i - a * n;
  const float* p = partial + static_cast<size_t>(a) * rows * n + j;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += p[static_cast<size_t>(r) * n];
  out[i] = s;
}

template <int H, bool kAgents>
int launch(const void* packed, const void* dirf, const void* action,
           const void* old_logp, const void* adv, const void* target,
           const void* w_img, const void* wd, const void* w1, const void* b1,
           const void* wa, const void* ba, const void* wv, const void* bv,
           void* dx1, void* partial, void* out, int agents, int b, int c, int f, int na,
           int blocks, Coefs k, cudaStream_t st) {
  const size_t smem = Layout<H>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      ppo_loss_kernel<H, kAgents>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ppo_loss_kernel<H, kAgents><<<dim3(blocks, agents), kThreads, smem, st>>>(
      static_cast<const int32_t*>(packed), static_cast<const float*>(dirf),
      static_cast<const int32_t*>(action), static_cast<const float*>(old_logp),
      static_cast<const float*>(adv), static_cast<const float*>(target),
      static_cast<const __nv_bfloat16*>(w_img), static_cast<const __nv_bfloat16*>(wd),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(wa), static_cast<const float*>(ba),
      static_cast<const __nv_bfloat16*>(wv), static_cast<const float*>(bv),
      static_cast<__nv_bfloat16*>(dx1), static_cast<float*>(partial), b, c, f, na, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * H + H + (f + 1) * H + Layout<H>::kTail;
  sum_partials_kernel<<<(n * agents + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks, n, agents);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAgents>
int launch_width(const void* packed, const void* dirf, const void* action,
                 const void* old_logp, const void* adv, const void* target,
                 const void* w_img, const void* wd, const void* w1, const void* b1,
                 const void* wa, const void* ba, const void* wv, const void* bv,
                 void* dx1, void* partial, void* out, int agents, int b, int c, int f,
                 int na, int h, int blocks, Coefs k, cudaStream_t st) {
#define MGT_PPO_CASE(HH)                                                          \
  case HH:                                                                        \
    return launch<HH, kAgents>(packed, dirf, action, old_logp, adv, target, w_img, \
                               wd, w1, b1, wa, ba, wv, bv, dx1, partial, out,      \
                               agents, b, c, f, na, blocks, k, st);
  switch (h) {
    MGT_PPO_CASE(32)
    MGT_PPO_CASE(64)
    MGT_PPO_CASE(128)
    default:
      return -1;
  }
#undef MGT_PPO_CASE
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or -1
// for a hidden width the kernel is not built for.
extern "C" int mgt_ppo_loss_launch(
    const void* packed, const void* dirf, const void* action,
    const void* old_logp, const void* adv, const void* target,
    const void* w_img, const void* wd, const void* w1, const void* b1,
    const void* wa, const void* ba, const void* wv, const void* bv,
    void* dx1, void* partial, void* out, int b, int c, int f, int na, int h,
    int blocks,
    float inv_b, float c_ent, float c_vf, float lo, float hi, void* stream) {
  return launch_width<false>(packed, dirf, action, old_logp, adv, target, w_img, wd, w1, b1,
                             wa, ba, wv, bv, dx1, partial, out, 1, b, c, f, na, h, blocks,
                             Coefs{inv_b, c_ent, c_vf, lo, hi},
                             static_cast<cudaStream_t>(stream));
}

// The loss of `agents` agents in one launch: every array (N, ...) with the
// shape of mgt_ppo_loss_launch's for each agent (B samples an agent), each
// agent on `blocks` blocks, its partials (N, blocks, P) summed into out (N,
// P); inv_b is 1/B, each agent's loss a mean over its own samples.
extern "C" int mgt_ppo_loss_agents_launch(
    const void* packed, const void* dirf, const void* action,
    const void* old_logp, const void* adv, const void* target,
    const void* w_img, const void* wd, const void* w1, const void* b1,
    const void* wa, const void* ba, const void* wv, const void* bv,
    void* dx1, void* partial, void* out, int agents, int b, int c, int f, int na, int h,
    int blocks,
    float inv_b, float c_ent, float c_vf, float lo, float hi, void* stream) {
  return launch_width<true>(packed, dirf, action, old_logp, adv, target, w_img, wd, w1, b1,
                            wa, ba, wv, bv, dx1, partial, out, agents, b, c, f, na, h, blocks,
                            Coefs{inv_b, c_ent, c_vf, lo, hi},
                            static_cast<cudaStream_t>(stream));
}
