// The policy's first layer on packed observation cells, and its weight
// gradient, without the 21-channel one-hot ever existing in memory.
//
// Replaces the TPU kernels multigrid_tpu/ops/fused_linear.py::_kernel
// (forward, out = one_hot(packed) @ W) and ::_grad_kernel (dW =
// one_hot(packed)^T @ g). A packed cell t<<8|c<<4|s has exactly three ones
// in its 21 channels (type t, color 11+c, state 17+s; a field out of its
// channel's range has none), so the product is an embedding-bag: each
// sample's output row is the sum of 3*C weight rows, and dW gets each
// sample's g row added into 3*C of its rows. Weights, feature index
// cell*21 + ch, are the flax layout (C*21, H).
//
// Numerics follow the TPU kernels: bf16 weights (forward) and bf16 g
// (gradient), f32 sums, bf16 output (forward) or f32 output (gradient).
//
// What bounds them on this card: operations, as the dense products the
// tensor cores run them. The forward at (B, C, H) = (16384, 49, 128) is
// 4.3 GFLOP as one_hot @ W (4.4 us at 989 TFLOP/s), or 3.1e8 adds on the
// CUDA cores as the embedding-bag it is (4.6 us at 67 TFLOP/s), against
// 7.7 MB of compulsory traffic (2.3 us). Its first design gathered 3*C
// weight rows a sample from L2 (0.6 GB at B = 16384) and was bound by
// that. Redesigned for Hopper, it is the tensor-core product of
// onehot_mma.cuh: a block takes 64 samples and BN columns, builds the
// one-hot A fragments in registers from the cells, and streams W's rows
// through a cp.async ring once per block (34-67 MB of L2 reads at the
// flagship); mma.sync rather than wgmma, for the reasons that header
// gives. The gradient, written as the dense product one_hot^T @ g, is
// 2*B*C*21*H operations (69 GFLOP at B=262144), of which the sparse
// one-hot needs only 3*C*H adds a sample; it too runs on the tensor cores:
// the one-hot A tile is built in registers from the packed cells (it never
// exists in memory), g is staged through shared memory, and mma.sync
// m16n8k16 sums in f32. A block holds 6 cells' rows of dW in registers over
// a chunk of the batch and writes them to a per-chunk partial (no atomics);
// a second pass sums the partials in a fixed order, so dW is the same from
// run to run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFwdThreads = 128;  // forward: 4 warps of 16 samples
constexpr int kFwdRows = 64;
constexpr int kFwdStages = 3;     // W stages in the ring
constexpr int kFwdGroup = 3;      // channels a stage: 48 W rows

// out[s0 .. s0 + 64, col0 .. col0 + BN) = bf16(one_hot(packed) @ W): the
// block's 64 x BN tile on the tensor cores (onehot_mma.cuh). W is (C*21,
// ldw) with ldw >= h a multiple of 8 (zero columns past h).
template <int BN>
__global__ void __launch_bounds__(kFwdThreads) onehot_linear_kernel(
    const int32_t* __restrict__ packed,     // (B, C)
    const __nv_bfloat16* __restrict__ w,    // (C*21, ldw)
    __nv_bfloat16* __restrict__ out,        // (B, H)
    int b, int c, int h, int ldw) {
  constexpr int kNT = BN / 8;
  __shared__ __align__(16) __nv_bfloat16 ring[kFwdStages * 16 * kFwdGroup * (BN + 8)];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int s0 = blockIdx.x * kFwdRows, col0 = blockIdx.y * BN;
  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
  onehot_mma<BN, kNT, kFwdThreads, kFwdStages, kFwdGroup>(packed, b, c, s0, 16 * warp + grp, w, ldw, col0,
                                               ldw, ring, 0, acc);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = s0 + 16 * warp + grp + 8 * i;
    if (row >= b) continue;
    __nv_bfloat16* o = out + static_cast<size_t>(row) * h;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = col0 + nt * 8 + 2 * tig;
      if ((h & 1) == 0 && col + 1 < h) {
        *reinterpret_cast<__nv_bfloat162*>(o + col) =
            __floats2bfloat162_rn(acc[nt][2 * i], acc[nt][2 * i + 1]);
      } else {
        if (col < h) o[col] = __float2bfloat16(acc[nt][2 * i]);
        if (col + 1 < h) o[col + 1] = __float2bfloat16(acc[nt][2 * i + 1]);
      }
    }
  }
}

constexpr int kCellsPerTile = 6;   // a tile's 128 rows hold 6 cells (126 rows)
constexpr int kKStep = 16;         // samples per mma k-step
constexpr int kGStride = kKStep + 8;  // bf16 row stride of the g^T tile (no bank conflicts)

// dW = one_hot(packed)^T @ g as a tensor-core product: block (row tile,
// batch chunk) holds the f32 sums of 6 cells' 126 rows x H columns in
// registers, 16 rows a warp. Each k-step stages 16 samples' g rows
// (transposed, bf16) and packed cells in shared memory, double-buffered with
// the next step's loads in flight, and each warp builds its one-hot A
// fragment from the cells and runs H/8 mma.sync m16n8k16.
template <int H>
__global__ void __launch_bounds__(kThreads) onehot_grad_kernel(
    const int32_t* __restrict__ packed,     // (B, C)
    const __nv_bfloat16* __restrict__ g,    // (B, H)
    float* __restrict__ out,                // (chunks, C*21, H) or (C*21, H)
    int b, int c, int chunk) {
  constexpr int kNT = H / 8;
  constexpr int kWords = kKStep * H / 2 / kThreads;  // g words a thread stages
  __shared__ __align__(16) uint16_t gs[2][H][kGStride];
  __shared__ int32_t ps[2][kKStep][kCellsPerTile];

  const int cell0 = blockIdx.x * kCellsPerTile;
  const int ncell = min(kCellsPerTile, c - cell0);
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(b, s_begin + chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;

  // The field test of this thread's two A rows, 16*warp + grp (+ 8).
  int cl[2], shift[2], mask[2], val[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + grp + 8 * i;
    const int cell = r / kNch, ch = r % kNch;
    cl[i] = cell < ncell ? cell : 0;
    if (cell >= ncell) {
      shift[i] = 0; mask[i] = 0; val[i] = -1;  // matches nothing
    } else if (ch < kTypes) {
      shift[i] = 8; mask[i] = -1; val[i] = ch;
    } else if (ch < kTypes + kColors) {
      shift[i] = 4; mask[i] = 15; val[i] = ch - kTypes;
    } else {
      shift[i] = 0; mask[i] = 15; val[i] = ch - kTypes - kColors;
    }
  }

  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

  const uint32_t* g32 = reinterpret_cast<const uint32_t*>(g);
  uint32_t greg[kWords];
  int preg = kPadCell;
  auto load = [&](int s0) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int w = threadIdx.x + kThreads * i;
      const int s = s0 + w / (H / 2);
      greg[i] = s < s_end ? g32[static_cast<size_t>(s) * (H / 2) + w % (H / 2)] : 0u;
    }
    if (threadIdx.x < kKStep * kCellsPerTile) {
      const int s = s0 + threadIdx.x / kCellsPerTile;
      const int cc = threadIdx.x % kCellsPerTile;
      preg = (s < s_end && cc < ncell)
                 ? packed[static_cast<size_t>(s) * c + cell0 + cc] : kPadCell;
    }
  };

  int buf = 0;
  load(s_begin);
  for (int s0 = s_begin; s0 < s_end; s0 += kKStep) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int w = threadIdx.x + kThreads * i;
      const int k = w / (H / 2), n = 2 * (w % (H / 2));
      gs[buf][n][k] = static_cast<uint16_t>(greg[i] & 0xFFFFu);
      gs[buf][n + 1][k] = static_cast<uint16_t>(greg[i] >> 16);
    }
    if (threadIdx.x < kKStep * kCellsPerTile)
      ps[buf][threadIdx.x / kCellsPerTile][threadIdx.x % kCellsPerTile] = preg;
    __syncthreads();
    if (s0 + kKStep < s_end) load(s0 + kKStep);

    // A fragment: a0 (row grp, k 2t..2t+1), a1 (row grp+8), a2/a3 (k + 8).
    uint32_t a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = q & 1;
      const int k = 2 * tig + (q >> 1) * 8;
      const int p0 = ps[buf][k][cl[i]], p1 = ps[buf][k + 1][cl[i]];
      const uint32_t lo = ((p0 >> shift[i]) & mask[i]) == val[i] ? 0x3F80u : 0u;
      const uint32_t hi = ((p1 >> shift[i]) & mask[i]) == val[i] ? 0x3F80u : 0u;
      a[q] = lo | (hi << 16);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const uint16_t* col = &gs[buf][nt * 8 + grp][2 * tig];
      mma_16816(acc[nt], a, *reinterpret_cast<const uint32_t*>(col),
               *reinterpret_cast<const uint32_t*>(col + 8));
    }
    buf ^= 1;
  }

  float* o = out + static_cast<size_t>(blockIdx.y) * c * kNch * H;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + grp + 8 * i;
    if (r / kNch >= ncell) continue;
    float* row = o + static_cast<size_t>(cell0 * kNch + r) * H + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      *reinterpret_cast<float2*>(row + nt * 8) = make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
  }
}

// out[i] = sum over k of partial[k][i], k in order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int chunks,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += partial[static_cast<size_t>(k) * n + i];
  out[i] = s;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). W is
// (C*21, ldw), ldw a multiple of 8 and 16-byte aligned rows. A block takes
// 64 samples and BN columns: BN the smallest of 32, 64, 128 that covers
// ldw, halved while the blocks would fill under half the SMs.
extern "C" int mgt_onehot_linear_launch(const void* packed, const void* w,
                                        void* out, int b, int c, int h,
                                        int ldw, void* stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int rows = (b + kFwdRows - 1) / kFwdRows;
  int bn = ldw <= 32 ? 32 : ldw <= 64 ? 64 : 128;
  while (bn > 32 && 2 * rows * ((ldw + bn - 1) / bn) <= sms) bn /= 2;
  const dim3 grid(rows, (ldw + bn - 1) / bn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int32_t*>(packed);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* o = static_cast<__nv_bfloat16*>(out);
  switch (bn) {
    case 32: onehot_linear_kernel<32><<<grid, kFwdThreads, 0, st>>>(p, wb, o, b, c, h, ldw); break;
    case 64: onehot_linear_kernel<64><<<grid, kFwdThreads, 0, st>>>(p, wb, o, b, c, h, ldw); break;
    default: onehot_linear_kernel<128><<<grid, kFwdThreads, 0, st>>>(p, wb, o, b, c, h, ldw); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_grad(const void* packed, const void* g, float* dst, int b, int c,
                int chunks, cudaStream_t st) {
  const int chunk = ((b + chunks - 1) / chunks + kKStep - 1) / kKStep * kKStep;
  dim3 grid((c + kCellsPerTile - 1) / kCellsPerTile, chunks);
  onehot_grad_kernel<H><<<grid, kThreads, 0, st>>>(
      static_cast<const int32_t*>(packed), static_cast<const __nv_bfloat16*>(g),
      dst, b, c, chunk);
  return static_cast<int>(cudaGetLastError());
}

// dW into `out` (C*21, H) f32. With chunks > 1 the blocks write per-chunk
// partials into `partial` (chunks, C*21, H) and a second pass sums them.
// Returns -1 for a hidden width the kernel is not built for.
extern "C" int mgt_onehot_grad_launch(const void* packed, const void* g,
                                      void* partial, void* out, int b, int c,
                                      int h, int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = chunks > 1 ? static_cast<float*>(partial) : static_cast<float*>(out);
  int err;
  switch (h) {
    case 32: err = launch_grad<32>(packed, g, dst, b, c, chunks, st); break;
    case 64: err = launch_grad<64>(packed, g, dst, b, c, chunks, st); break;
    case 128: err = launch_grad<128>(packed, g, dst, b, c, chunks, st); break;
    case 256: err = launch_grad<256>(packed, g, dst, b, c, chunks, st); break;
    default: return -1;
  }
  if (err != 0 || chunks == 1) return err;
  const int n = c * kNch * h;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), chunks, n);
  return static_cast<int>(cudaGetLastError());
}
