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
// What bounds them on this card: the forward reads 3*C weight rows for
// every sample (C=49, H=128: 37 KB a sample, 0.6 GB at B=16384) against
// 7.7 MB of compulsory traffic; the 263 KB bf16 weight matrix does not fit a
// block's shared memory but stays in the 50 MB L2, so the kernel is bound
// by L2 bandwidth. The design answers with one warp per sample, lanes on
// neighbouring columns so each row read is coalesced, and f32 sums in
// registers. The gradient, written as the dense product one_hot^T @ g, is
// 2*B*C*21*H operations (69 GFLOP at B=262144), of which the sparse
// one-hot needs only 3*C*H adds a sample; the design takes the dense form
// to the tensor cores, where it is cheaper than the adds on the CUDA cores:
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

namespace {

constexpr int kNch = 21;  // one-hot channels: 11 types, 6 colors, 4 states
constexpr int kTypes = 11;
constexpr int kColors = 6;
constexpr int kStates = 4;
constexpr int kThreads = 256;
constexpr int kMaxCols = 8;  // columns per lane: H <= 256

// The three weight rows a packed cell selects, -1 where a field is out of
// its channel's range.
__device__ __forceinline__ void cell_rows(int p, int cell, int rows[3]) {
  const int t = p >> 8, col = (p >> 4) & 15, st = p & 15;
  const int base = cell * kNch;
  rows[0] = (t >= 0 && t < kTypes) ? base + t : -1;
  rows[1] = col < kColors ? base + kTypes + col : -1;
  rows[2] = st < kStates ? base + kTypes + kColors + st : -1;
}

// One warp per sample; lane l owns columns l, l+32, ...
__global__ void __launch_bounds__(kThreads) onehot_linear_kernel(
    const int32_t* __restrict__ packed,     // (B, C)
    const __nv_bfloat16* __restrict__ w,    // (C*21, H)
    __nv_bfloat16* __restrict__ out,        // (B, H)
    int b, int c, int h) {
  const int sample = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (sample >= b) return;
  float acc[kMaxCols];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) acc[i] = 0.f;
  const int32_t* p = packed + static_cast<size_t>(sample) * c;
  for (int cell = 0; cell < c; ++cell) {
    int rows[3];
    cell_rows(p[cell], cell, rows);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (rows[k] < 0) continue;
      const __nv_bfloat16* wr = w + static_cast<size_t>(rows[k]) * h;
#pragma unroll
      for (int i = 0; i < kMaxCols; ++i) {
        const int j = lane + 32 * i;
        if (j < h) acc[i] += __bfloat162float(wr[j]);
      }
    }
  }
  __nv_bfloat16* o = out + static_cast<size_t>(sample) * h;
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) {
    const int j = lane + 32 * i;
    if (j < h) o[j] = __float2bfloat16(acc[i]);
  }
}

constexpr int kCellsPerTile = 6;   // a tile's 128 rows hold 6 cells (126 rows)
constexpr int kKStep = 16;         // samples per mma k-step
constexpr int kGStride = kKStep + 8;  // bf16 row stride of the g^T tile (no bank conflicts)
constexpr int kPad = (0x7FF << 8) | (15 << 4) | 15;  // a cell matching no channel

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
  int preg = kPad;
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
                 ? packed[static_cast<size_t>(s) * c + cell0 + cc] : kPad;
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
      mma_bf16(acc[nt], a, *reinterpret_cast<const uint32_t*>(col),
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

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int mgt_onehot_linear_launch(const void* packed, const void* w,
                                        void* out, int b, int c, int h,
                                        void* stream) {
  const int warps = kThreads / 32;
  onehot_linear_kernel<<<(b + warps - 1) / warps, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      b, c, h);
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
