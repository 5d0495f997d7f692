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
// What bounds it on this card: operations. Per sample it does three HxH
// products (x2, dx1 and the dW1 outer product, 3*2*H*H flops), the two
// embedding-bag passes over 3*C weight rows (forward h, and dW_img), and a
// few hundred more; the compulsory bytes are the packed cells and the
// per-sample inputs (about 70 MB at B = 262144, C = 49). The design keeps
// the (sample, H) activations of the loss on chip: a block walks tiles of
// 32 samples, with W1 (bf16, 32 KB at H = 128, rows padded against bank
// conflicts) and the tile's x1, x2 and dx2 in shared memory, and the small
// weight gradients in registers across all its tiles. Blocks write
// per-block partials that a second pass sums in a fixed order, so the
// gradients are the same from run to run. The products are plain FMA loops
// on the CUDA cores, not tensor cores: that is the gap to the bound a later
// version closes (mma/wgmma on bf16 tiles).
//
// Two (sample, H) tensors leave the chip, bf16, 67 MB each at the flagship:
// x1, which a first pass computes at one warp a sample (the first layer's
// gather of 3*C weight rows from L2 needs many warps in flight to hide its
// latency, and the loss kernel, at 248 registers a thread, runs 8 warps an
// SM); and dx1, because
// dW_img, the (C*21, H) f32 gradient of the first layer, does not fit a
// block's shared memory: the wrapper runs the gradient kernel of
// csrc/fused_linear.cu on it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNch = 21;
constexpr int kTypes = 11;
constexpr int kColors = 6;
constexpr int kStates = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kS = 32;       // samples per tile
constexpr int kA = 8;        // actions at most
constexpr int kF1 = 16;      // direction features + the bias column, at most

__device__ __forceinline__ float bf(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16(x));
}

struct Coefs {
  float inv_b, c_ent, c_vf, lo, hi;
};

template <int H>
struct Layout {
  static constexpr int kNg = kThreads / H;       // threads sharing a column
  static constexpr int kPer = kS / kNg;          // samples of a thread
  static constexpr int kR = H / 16;              // dW1 tile side per thread
  static constexpr int kW1Stride = H + 2;        // bf16 row stride of W1
  static constexpr int kTail = 9 * H + 12;       // dWa, dWv, dba, dbv, sums
  static constexpr int kRed = kNg * (kF1 + 1) * H > kWarps * kTail
                                  ? kNg * (kF1 + 1) * H
                                  : kWarps * kTail;
  static constexpr int kBig = 3 * kS * H > kRed ? 3 * kS * H : kRed;
  // floats after W1: big (x1, x2, dx2 | reductions), dirf, wa, wv, b1, dl,
  // dv
  static constexpr int kFloats = kBig + kS * kF1 + H * kA + H + H + kS * kA + kS;
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * H * kW1Stride + sizeof(float) * kFloats;
};

// The first layer, h = one_hot(packed) @ W_img + [dirf, 1] @ [W0; b0], and
// x1 = bf16(relu(h)), one warp per sample: the gather of 3*C weight rows
// from L2 needs many warps in flight, which the loss kernel (one block of
// 8 warps an SM) does not have.
template <int H>
__global__ void __launch_bounds__(kThreads) first_layer_kernel(
    const int32_t* __restrict__ packed,        // (B, C)
    const float* __restrict__ dirf,            // (B, F)
    const __nv_bfloat16* __restrict__ w_img,   // (C*21, H)
    const __nv_bfloat16* __restrict__ wd,      // (F+1, H): [W0; b0]
    __nv_bfloat16* __restrict__ x1_out,        // (B, H)
    int b, int c, int f) {
  constexpr int kCols = H / 32;
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= b) return;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  const int32_t* p = packed + static_cast<size_t>(n) * c;
  for (int cell = 0; cell < c; ++cell) {
    const int v = p[cell];
    const int t = v >> 8, col = (v >> 4) & 15, st = v & 15;
    const __nv_bfloat16* wc = w_img + static_cast<size_t>(cell) * kNch * H + lane;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      if (t >= 0 && t < kTypes) acc[i] += __bfloat162float(wc[t * H + 32 * i]);
      if (col < kColors) acc[i] += __bfloat162float(wc[(kTypes + col) * H + 32 * i]);
      if (st < kStates)
        acc[i] += __bfloat162float(wc[(kTypes + kColors + st) * H + 32 * i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int j = lane + 32 * i;
    float d = 0.f;
    for (int q = 0; q <= f; ++q) {
      const float x = q < f ? bf(dirf[static_cast<size_t>(n) * f + q]) : 1.f;
      d += x * __bfloat162float(wd[q * H + j]);
    }
    x1_out[static_cast<size_t>(n) * H + j] = __float2bfloat16(fmaxf(acc[i] + d, 0.f));
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1) ppo_loss_kernel(
    const __nv_bfloat16* __restrict__ x1_in,   // (B, H) from first_layer_kernel
    const float* __restrict__ dirf,            // (B, F)
    const int32_t* __restrict__ action,        // (B,)
    const float* __restrict__ old_logp,        // (B,)
    const float* __restrict__ adv,             // (B,)
    const float* __restrict__ target,          // (B,)
    const __nv_bfloat16* __restrict__ w1,      // (H, H) (in, out)
    const float* __restrict__ b1,              // (H,)
    const __nv_bfloat16* __restrict__ wa,      // (H, A)
    const float* __restrict__ ba,              // (A,)
    const __nv_bfloat16* __restrict__ wv,      // (H,)
    const float* __restrict__ bv,              // (1,)
    __nv_bfloat16* __restrict__ dx1_out,       // (B, H)
    float* __restrict__ partial,               // (gridDim.x, P)
    int b, int f, int na, Coefs k) {
  using L = Layout<H>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* big = reinterpret_cast<float*>(w1s + H * L::kW1Stride);
  float* x1s = big;                 // (S, H)
  float* x2s = x1s + kS * H;        // (S, H)
  float* dx2s = x2s + kS * H;       // (S, H)
  float* dirs = big + L::kBig;      // (S, kF1): bf16(dirf), 1, 0...
  float* was = dirs + kS * kF1;     // (H, kA)
  float* wvs = was + H * kA;        // (H,)
  float* b1s = wvs + H;             // (H,)
  float* dls = b1s + H;             // (S, kA) bf16(dlogits)
  float* dvs = dls + kS * kA;       // (S,) bf16(dvalue)

  const int tid = threadIdx.x;
  const int f1 = f + 1;
  for (int i = tid; i < H * H; i += kThreads)
    w1s[(i / H) * L::kW1Stride + i % H] = w1[i];
  for (int i = tid; i < H * kA; i += kThreads) {
    const int a = i % kA;
    was[i] = a < na ? __bfloat162float(wa[(i / kA) * na + a]) : 0.f;
  }
  for (int i = tid; i < H; i += kThreads) {
    wvs[i] = __bfloat162float(wv[i]);
    b1s[i] = b1[i];
  }

  // Column-owner mapping of the H-wide phases: column j, samples g + kNg*i.
  const int j = tid % H;
  const int grp = tid / H;
  // dW1 tile of this thread: rows r0.., columns q0..
  const int r0 = (tid / 16) * L::kR;
  const int q0 = (tid % 16) * L::kR;
  const int warp = tid / 32, lane = tid % 32;

  float acc_w1[L::kR][L::kR];
#pragma unroll
  for (int u = 0; u < L::kR; ++u)
#pragma unroll
    for (int v = 0; v < L::kR; ++v) acc_w1[u][v] = 0.f;
  float acc_wd[kF1];
#pragma unroll
  for (int q = 0; q < kF1; ++q) acc_wd[q] = 0.f;
  float acc_b1 = 0.f;
  float acc_wa[H / 32][kA], acc_wv[H / 32];
#pragma unroll
  for (int i = 0; i < H / 32; ++i) {
    acc_wv[i] = 0.f;
#pragma unroll
    for (int a = 0; a < kA; ++a) acc_wa[i][a] = 0.f;
  }
  float acc_ba[kA];
#pragma unroll
  for (int a = 0; a < kA; ++a) acc_ba[a] = 0.f;
  float acc_bv = 0.f, sum_pg = 0.f, sum_vf = 0.f, sum_ent = 0.f;

  const int ntiles = (b + kS - 1) / kS;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int s0 = tile * kS;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kS * kF1; i += kThreads) {
      const int s = i / kF1, q = i % kF1;
      float v = 0.f;
      if (s0 + s < b) {
        if (q < f) v = bf(dirf[static_cast<size_t>(s0 + s) * f + q]);
        else if (q == f) v = 1.f;
      }
      dirs[i] = v;
    }
    __syncthreads();

    // x1 from the first-layer pass.
#pragma unroll
    for (int i = 0; i < L::kPer; ++i) {
      const int s = grp + L::kNg * i;
      x1s[s * H + j] = s0 + s < b
          ? __bfloat162float(x1_in[static_cast<size_t>(s0 + s) * H + j]) : 0.f;
    }
    __syncthreads();

    // x2 = bf16(relu(x1 @ W1 + b1)).
    {
      float acc[L::kPer];
#pragma unroll
      for (int i = 0; i < L::kPer; ++i) acc[i] = 0.f;
      for (int kk = 0; kk < H; ++kk) {
        const float w = __bfloat162float(w1s[kk * L::kW1Stride + j]);
#pragma unroll
        for (int i = 0; i < L::kPer; ++i)
          acc[i] += x1s[(grp + L::kNg * i) * H + kk] * w;
      }
#pragma unroll
      for (int i = 0; i < L::kPer; ++i) {
        const int s = grp + L::kNg * i;
        x2s[s * H + j] = s0 + s < b ? bf(fmaxf(acc[i] + b1s[j], 0.f)) : 0.f;
      }
    }
    __syncthreads();

    // Heads, loss and dlogits: one warp per sample.
    for (int s = warp; s < kS; s += kWarps) {
      const int n = s0 + s;
      if (n >= b) {
        if (lane < kA) dls[s * kA + lane] = 0.f;
        if (lane == 0) dvs[s] = 0.f;
        continue;
      }
      float lg[kA], pv = 0.f;
#pragma unroll
      for (int a = 0; a < kA; ++a) lg[a] = 0.f;
#pragma unroll
      for (int i = 0; i < H / 32; ++i) {
        const int kk = lane + 32 * i;
        const float x = x2s[s * H + kk];
#pragma unroll
        for (int a = 0; a < kA; ++a) lg[a] += x * was[kk * kA + a];
        pv += x * wvs[kk];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int a = 0; a < kA; ++a) lg[a] += __shfl_xor_sync(0xffffffffu, lg[a], off);
        pv += __shfl_xor_sync(0xffffffffu, pv, off);
      }
      float zmax = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        if (a < na) {
          lg[a] += ba[a];
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
      const int act = action[n];
      float logp[kA], prob[kA], lp = 0.f, ent = 0.f;
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        logp[a] = a < na ? lg[a] - zmax - lse : 0.f;
        prob[a] = a < na ? ez[a] / sez : 0.f;
        if (a == act) lp = logp[a];
        ent += prob[a] * logp[a];
      }
      ent = -ent;
      const float av = adv[n];
      const float ratio = expf(lp - old_logp[n]);
      const float u1 = ratio * av;
      const float u2 = fminf(fmaxf(ratio, k.lo), k.hi) * av;
      const float verr = (pv + bv[0]) - target[n];
      const float coef = u1 <= u2 ? (-k.inv_b * av) * ratio : 0.f;
      const float dv = k.c_vf * verr;
      const float dv16 = bf(dv);
      float dl[kA];
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        const float g = a < na ? coef * ((a == act ? 1.f : 0.f) - prob[a])
                                     + k.c_ent * prob[a] * (logp[a] + ent)
                               : 0.f;
        dl[a] = bf(g);
        acc_ba[a] += g;
      }
      acc_bv += dv;
      if (lane == 0) {
        sum_pg += -fminf(u1, u2);
        sum_vf += 0.5f * verr * verr;
        sum_ent += ent;
        dvs[s] = dv16;
#pragma unroll
        for (int a = 0; a < kA; ++a) dls[s * kA + a] = dl[a];
      }
#pragma unroll
      for (int i = 0; i < H / 32; ++i) {
        const float x = x2s[s * H + lane + 32 * i];
#pragma unroll
        for (int a = 0; a < kA; ++a) acc_wa[i][a] += dl[a] * x;
        acc_wv[i] += dv16 * x;
      }
    }
    __syncthreads();

    // dx2 = dlogits @ Wa^T + dv wv^T, through the relu: bf16.
#pragma unroll 1
    for (int i = 0; i < L::kPer; ++i) {
      const int s = grp + L::kNg * i;
      float d = 0.f;
#pragma unroll
      for (int a = 0; a < kA; ++a) d += was[j * kA + a] * dls[s * kA + a];
      d += wvs[j] * dvs[s];
      const float g = x2s[s * H + j] > 0.f ? bf(d) : 0.f;
      dx2s[s * H + j] = g;
      acc_b1 += g;
    }
    __syncthreads();

    // dx1 = dx2 @ W1^T, through the relu: bf16, out to memory for dW_img;
    // dWd gets dx1 (x) [dirf, 1].
    {
      float acc[L::kPer];
#pragma unroll
      for (int i = 0; i < L::kPer; ++i) acc[i] = 0.f;
      for (int q = 0; q < H; ++q) {
        const float w = __bfloat162float(w1s[j * L::kW1Stride + q]);
#pragma unroll
        for (int i = 0; i < L::kPer; ++i)
          acc[i] += w * dx2s[(grp + L::kNg * i) * H + q];
      }
#pragma unroll
      for (int i = 0; i < L::kPer; ++i) {
        const int s = grp + L::kNg * i;
        if (s0 + s >= b) continue;
        const float g = x1s[s * H + j] > 0.f ? bf(acc[i]) : 0.f;
        dx1_out[static_cast<size_t>(s0 + s) * H + j] = __float2bfloat16(g);
#pragma unroll
        for (int q = 0; q < kF1; ++q) acc_wd[q] += g * dirs[s * kF1 + q];
      }
    }

    // dW1 += x1^T dx2 over the tile.
    for (int s = 0; s < kS; ++s) {
      float xr[L::kR], gr[L::kR];
#pragma unroll
      for (int u = 0; u < L::kR; ++u) {
        xr[u] = x1s[s * H + r0 + u];
        gr[u] = dx2s[s * H + q0 + u];
      }
#pragma unroll
      for (int u = 0; u < L::kR; ++u)
#pragma unroll
        for (int v = 0; v < L::kR; ++v) acc_w1[u][v] += xr[u] * gr[v];
    }
  }
  __syncthreads();

  // Per-block partial: [dW1 H*H][db1 H][dWd (F+1)*H][tail 9H+12].
  const int p_len = H * H + H + f1 * H + L::kTail;
  float* out = partial + static_cast<size_t>(blockIdx.x) * p_len;
#pragma unroll
  for (int u = 0; u < L::kR; ++u)
#pragma unroll
    for (int v = 0; v < L::kR; ++v) out[(r0 + u) * H + q0 + v] = acc_w1[u][v];

  float* red = big;
#pragma unroll
  for (int q = 0; q < kF1; ++q) red[(grp * (kF1 + 1) + q) * H + j] = acc_wd[q];
  red[(grp * (kF1 + 1) + kF1) * H + j] = acc_b1;
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
  __syncthreads();

  // Tail, per warp: dWa (H, kA) at kk*kA + a, dWv at kA*H + kk, then dba,
  // dbv and the three sums at 9H.
  float* rw = red + warp * L::kTail;
#pragma unroll
  for (int i = 0; i < H / 32; ++i) {
    const int kk = lane + 32 * i;
#pragma unroll
    for (int a = 0; a < kA; ++a) rw[kk * kA + a] = acc_wa[i][a];
    rw[kA * H + kk] = acc_wv[i];
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < kA; ++a) rw[9 * H + a] = acc_ba[a];
    rw[9 * H + 8] = acc_bv;
    rw[9 * H + 9] = sum_pg;
    rw[9 * H + 10] = sum_vf;
    rw[9 * H + 11] = sum_ent;
  }
  __syncthreads();
  float* tail = out + H * H + H + f1 * H;
  for (int i = tid; i < L::kTail; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * L::kTail + i];
    tail[i] = s;
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int rows, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += partial[static_cast<size_t>(r) * n + i];
  out[i] = s;
}

template <int H>
int launch(const void* packed, const void* dirf, const void* action,
           const void* old_logp, const void* adv, const void* target,
           const void* w_img, const void* wd, const void* w1, const void* b1,
           const void* wa, const void* ba, const void* wv, const void* bv,
           void* x1, void* dx1, void* partial, void* out, int b, int c, int f,
           int na, int blocks, Coefs k, cudaStream_t st) {
  first_layer_kernel<H><<<(b + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const int32_t*>(packed), static_cast<const float*>(dirf),
      static_cast<const __nv_bfloat16*>(w_img),
      static_cast<const __nv_bfloat16*>(wd), static_cast<__nv_bfloat16*>(x1),
      b, c, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = Layout<H>::kSmem;
  err = cudaFuncSetAttribute(
      ppo_loss_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ppo_loss_kernel<H><<<blocks, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x1), static_cast<const float*>(dirf),
      static_cast<const int32_t*>(action), static_cast<const float*>(old_logp),
      static_cast<const float*>(adv), static_cast<const float*>(target),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(wa), static_cast<const float*>(ba),
      static_cast<const __nv_bfloat16*>(wv), static_cast<const float*>(bv),
      static_cast<__nv_bfloat16*>(dx1), static_cast<float*>(partial), b, f,
      na, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * H + H + (f + 1) * H + Layout<H>::kTail;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or -1
// for a hidden width the kernel is not built for.
extern "C" int mgt_ppo_loss_launch(
    const void* packed, const void* dirf, const void* action,
    const void* old_logp, const void* adv, const void* target,
    const void* w_img, const void* wd, const void* w1, const void* b1,
    const void* wa, const void* ba, const void* wv, const void* bv, void* x1,
    void* dx1, void* partial, void* out, int b, int c, int f, int na, int h,
    int blocks,
    float inv_b, float c_ent, float c_vf, float lo, float hi, void* stream) {
  const Coefs k{inv_b, c_ent, c_vf, lo, hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MGT_PPO_CASE(HH)                                                     \
  case HH:                                                                   \
    return launch<HH>(packed, dirf, action, old_logp, adv, target, w_img, wd, \
                      w1, b1, wa, ba, wv, bv, x1, dx1, partial, out, b, c, f, \
                      na, blocks, k, st);
  switch (h) {
    MGT_PPO_CASE(32)
    MGT_PPO_CASE(64)
    MGT_PPO_CASE(128)
    default:
      return -1;
  }
#undef MGT_PPO_CASE
}
