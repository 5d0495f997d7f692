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
// one-hot needs only 3*C*H adds a sample; it too runs on the tensor cores,
// the one-hot A tile built in registers from the cells' channel masks (it
// never exists in memory). A block holds 12 cells' rows of dW in
// registers (2 m-tiles a warp, so g is read 5 times at C = 49), streams
// 128-sample stages of g in their row-major layout and the cells through
// a 4-deep cp.async ring with one barrier a stage, reads the B fragments
// with ldmatrix.trans, and builds A from channel masks made once a stage
// (one load and three operations a register). Measured, its time is
// mostly the stages' movement from L2 (g read 5 times is 0.34 GB at the
// flagship), then the fragments' loads, then the products, so mma.sync
// stays. The grid is one wave: the wrapper splits the batch into as many
// chunks as fit beside the cell tiles on the SMs; each block writes its
// chunk's partial (no atomics) and a second pass sums the partials in a
// fixed order, so dW is the same from run to run.
//
// Per-agent policies (the JAX package vmaps the TPU kernels over stacked
// per-agent weights, and Pallas's batching rule adds a leading grid axis
// over the agents) take both kernels with an agent axis, one launch for
// all agents: the forward's blockIdx.z is the agent, and the gradient's
// blockIdx.z is agent * chunks + chunk, the agents sharing the SMs' wave.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_mma.cuh"

namespace {

constexpr int kFwdThreads = 128;  // forward: 4 warps of 16 samples
constexpr int kFwdRows = 64;
constexpr int kFwdStages = 3;     // W stages in the ring
constexpr int kFwdGroup = 3;      // channels a stage: 48 W rows

// out[s0 .. s0 + 64, col0 .. col0 + BN) = bf16(one_hot(packed) @ W): the
// block's 64 x BN tile on the tensor cores (onehot_mma.cuh). W is (C*21,
// ldw) with ldw >= h a multiple of 8 (zero columns past h). With kAgents,
// blockIdx.z is the agent: agent a's cells, weights and output follow a's
// predecessors contiguously ((N, B, C), (N, C*21, ldw), (N, B, H)), and
// each of its rows is computed as a launch of that agent alone computes it.
// Its cells and output rows are addressed by row (agent * B + sample), its
// weights by pointer; the single-agent instance keeps its code.
template <int BN, bool kAgents>
__global__ void __launch_bounds__(kFwdThreads) onehot_linear_kernel(
    const int32_t* __restrict__ packed,     // (N, B, C)
    const __nv_bfloat16* __restrict__ w,    // (N, C*21, ldw)
    __nv_bfloat16* __restrict__ out,        // (N, B, H)
    int b, int c, int h, int ldw) {
  constexpr int kNT = BN / 8;
  __shared__ __align__(16) __nv_bfloat16 ring[kFwdStages * 16 * kFwdGroup * (BN + 8)];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int base = kAgents ? static_cast<int>(blockIdx.z) * b : 0, end = base + b;
  if (kAgents) w += static_cast<size_t>(blockIdx.z) * c * kNch * ldw;
  const int s0 = base + blockIdx.x * kFwdRows, col0 = blockIdx.y * BN;
  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
  onehot_mma<BN, kNT, kFwdThreads, kFwdStages, kFwdGroup>(packed, end, c, s0, 16 * warp + grp, w, ldw,
                                               col0, ldw, ring, 0, acc);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = s0 + 16 * warp + grp + 8 * i;
    if (row >= end) continue;
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

// The gradient kernel's shape. A block holds 256 rows of dW (12 cells,
// 252 rows, in flax's order) x BN columns in registers, 2 m-tiles of 16
// rows a warp, so g is read ceil(C / 12) times (5 at C = 49). The batch
// chunk streams through a ring of stages of 128 samples: g's rows as they
// lie in memory and the block's 12 cells of each sample, by cp.async.
constexpr int kGradWarps = 8;
constexpr int kGradThreads = 32 * kGradWarps;
constexpr int kGradMT = 2;                                   // m-tiles a warp
constexpr int kGradCells = 16 * kGradMT * kGradWarps / kNch;  // 12 cells a block
constexpr int kGradSamples = 128;                            // samples a stage
constexpr int kGradStages = 4;                               // stages in the ring
constexpr int kPairLd = kGradSamples / 2 + 4;  // words: a warp's mask rows in other banks

template <int BN>
struct GradSmem {
  __nv_bfloat16 g[kGradStages][kGradSamples][BN + 8];  // rows padded 16 bytes
  int32_t raw[kGradStages][kGradSamples][kGradCells];  // the stage's packed cells
  // Their channel masks by sample pair: [cell][half][pair] holds channels
  // 16*half .. 16*half + 15 of samples 2*pair (low 16 bits) and 2*pair + 1.
  uint32_t mask[2][kGradCells][2][kPairLd];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// dW = one_hot(packed)^T @ g as a tensor-core product. Block (cell tile,
// column tile, agent * chunks + batch chunk) sums its 12 cells' rows x BN
// columns over its agent's chunk in f32 registers and writes them to that
// chunk's partial (agent a's cells and g follow a's predecessors
// contiguously, (N, B, C) and (N, B, H); its partials are slabs a * chunks
// .. a * chunks + chunks - 1, or slab a of dW with one chunk). A stage
// takes one barrier: with stage q + 1 landed, the block turns its cells
// into 21-bit channel masks (channel_bits) while the warps multiply stage
// q. The A fragment of row cell*21 + ch is bit ch of the cells' masks,
// kept by sample pair and 16-channel half so that one load, shift, mask
// and multiply give a register; the B fragments come from the [sample][h]
// tile by ldmatrix.trans; mma.sync m16n8k16 sums in f32. Samples past the
// chunk read g as 0 and cells past C are never written.
template <int BN>
__global__ void __launch_bounds__(kGradThreads, 1) onehot_grad_kernel(
    const int32_t* __restrict__ packed,     // (N, B, C)
    const __nv_bfloat16* __restrict__ g,    // (N, B, H)
    float* __restrict__ out,                // (N * chunks, C*21, H) or (N, C*21, H)
    int b, int c, int h, int chunks, int chunk) {
  constexpr int kNT = BN / 8;
  constexpr int kLd = BN + 8;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  GradSmem<BN>& sm = *reinterpret_cast<GradSmem<BN>*>(smem_bytes);

  const int cell0 = blockIdx.x * kGradCells;
  const int ncell = min(kGradCells, c - cell0);
  const int col0 = blockIdx.y * BN;
  const size_t agent = blockIdx.z / chunks;
  packed += agent * b * c;
  g += agent * b * h;
  const int s_begin = static_cast<int>(blockIdx.z - agent * chunks) * chunk;
  const int s_end = min(b, s_begin + chunk);
  const int stages = max(0, (s_end - s_begin + kGradSamples - 1) / kGradSamples);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;

  // Stage q's g rows (16-byte pieces, zero past the chunk) and cells (4
  // bytes each: a sample's 12 cells are not 16-byte aligned, and staging
  // the aligned pieces around them measured no faster), one group.
  auto issue = [&](int q) {
    if (q < stages) {
      const int s0 = s_begin + q * kGradSamples, slot = q % kGradStages;
      for (int i = threadIdx.x; i < kGradSamples * BN / 8; i += kGradThreads) {
        const int k = i / (BN / 8), col = (i % (BN / 8)) * 8;
        const bool valid = s0 + k < s_end && col0 + col < h;
        cp_async16(&sm.g[slot][k][col],
                   valid ? g + static_cast<size_t>(s0 + k) * h + col0 + col : g, valid);
      }
      for (int i = threadIdx.x; i < kGradSamples * kGradCells; i += kGradThreads) {
        const int k = i / kGradCells, cc = i % kGradCells;
        const bool valid = s0 + k < s_end && cc < ncell;
        cp_async4(&sm.raw[slot][k][cc],
                  valid ? packed + static_cast<size_t>(s0 + k) * c + cell0 + cc : packed, valid);
      }
    }
    cp_async_commit();
  };
  // Stage q's cells into channel masks by sample pair, in buffer q & 1.
  auto convert = [&](int q) {
    const int s0 = s_begin + q * kGradSamples, slot = q % kGradStages;
    for (int i = threadIdx.x; i < kGradSamples / 2 * kGradCells; i += kGradThreads) {
      const int cc = i / (kGradSamples / 2), k = 2 * (i % (kGradSamples / 2));
      const bool live = cc < ncell;
      const uint32_t lo = live && s0 + k < s_end ? channel_bits(sm.raw[slot][k][cc]) : 0u;
      const uint32_t hi = live && s0 + k + 1 < s_end ? channel_bits(sm.raw[slot][k + 1][cc]) : 0u;
      sm.mask[q & 1][cc][0][k / 2] = (lo & 0xFFFFu) | (hi << 16);
      sm.mask[q & 1][cc][1][k / 2] = (lo >> 16) | (hi & 0xFFFF0000u);
    }
  };

  // The thread's A rows: 16*(2*warp + mt) + grp (+ 8), row cell*21 + ch,
  // as the offset of its mask row (cell, ch / 16) in a buffer, the shift
  // ch % 16 and the two bits kept (none for a row past the block's cells).
  int moff[kGradMT][2], msh[kGradMT][2];
  uint32_t mkeep[kGradMT][2];
#pragma unroll
  for (int mt = 0; mt < kGradMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * (kGradMT * warp + mt) + grp + 8 * i;
      const int cell = r / kNch, ch = r % kNch;
      const bool live = cell < ncell;
      moff[mt][i] = live ? (2 * cell + ch / 16) * kPairLd : 0;
      msh[mt][i] = ch % 16;
      mkeep[mt][i] = live ? 0x10001u : 0u;
    }

  float acc[kGradMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kGradMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int q = 0; q < kGradStages - 1; ++q) issue(q);
  cp_async_wait<kGradStages - 2>();  // stage 0 has landed
  __syncthreads();
  convert(0);

  for (int q = 0; q < stages; ++q) {
    cp_async_wait<kGradStages - 3>();  // stage q + 1 has landed
    __syncthreads();  // ... for every thread; stage q's masks are written; q - 1's slot is free
    issue(q + kGradStages - 1);
    if (q + 1 < stages) convert(q + 1);
    const __nv_bfloat16* st = &sm.g[q % kGradStages][0][0];
    const uint32_t* msk = &sm.mask[q & 1][0][0][0];
#pragma unroll
    for (int k0 = 0; k0 < kGradSamples; k0 += 16) {
      uint32_t a[kGradMT][4];
#pragma unroll
      for (int mt = 0; mt < kGradMT; ++mt) {
        // a0: row grp, samples 2t, 2t+1 (pair k0/2 + t); a1: row grp + 8;
        // a2, a3: samples + 8 (pair + 4). Bit ch of both samples, as bf16 1s.
        const int p = k0 / 2 + tig;
        a[mt][0] = ((msk[moff[mt][0] + p] >> msh[mt][0]) & mkeep[mt][0]) * 0x3F80u;
        a[mt][1] = ((msk[moff[mt][1] + p] >> msh[mt][1]) & mkeep[mt][1]) * 0x3F80u;
        a[mt][2] = ((msk[moff[mt][0] + p + 4] >> msh[mt][0]) & mkeep[mt][0]) * 0x3F80u;
        a[mt][3] = ((msk[moff[mt][1] + p + 4] >> msh[mt][1]) & mkeep[mt][1]) * 0x3F80u;
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bb[4];
        load_b2(bb, st, kLd, k0, 16 * np, lane);
#pragma unroll
        for (int mt = 0; mt < kGradMT; ++mt) {
          mma_16816(acc[mt][2 * np], a[mt], bb[0], bb[1]);
          mma_16816(acc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* o = out + static_cast<size_t>(blockIdx.z) * c * kNch * h;
#pragma unroll
  for (int mt = 0; mt < kGradMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * (kGradMT * warp + mt) + grp + 8 * i;
      if (r / kNch >= ncell) continue;
      float* row = o + static_cast<size_t>(cell0 * kNch + r) * h + col0 + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<float2*>(row + nt * 8) =
            make_float2(acc[mt][nt][2 * i], acc[mt][nt][2 * i + 1]);
    }
}

// out[a][i] = sum over k of partial[a][k][i], k in order, for each of
// `agents` slabs of n entries.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int chunks,
                                    int n, int agents) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(n) * agents) return;
  const size_t a = i / n, j = i - a * n;
  const float* p = partial + a * chunks * n + j;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += p[static_cast<size_t>(k) * n];
  out[i] = s;
}

template <int BN>
int launch_grad(const void* packed, const void* g, float* dst, int agents, int b, int c,
                int h, int chunks, int chunk, cudaStream_t st) {
  static bool sized = false;  // the kernel's shared memory is past the 48 KB default
  // (internal linkage: one flag for this library's kernel)
  const int smem = static_cast<int>(sizeof(GradSmem<BN>));
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        onehot_grad_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid((c + kGradCells - 1) / kGradCells, (h + BN - 1) / BN, agents * chunks);
  onehot_grad_kernel<BN><<<grid, kGradThreads, smem, st>>>(
      static_cast<const int32_t*>(packed), static_cast<const __nv_bfloat16*>(g), dst, b, c,
      h, chunks, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
void launch_forward_bn(bool agents, dim3 grid, cudaStream_t st, const int32_t* p,
                       const __nv_bfloat16* w, __nv_bfloat16* o, int b, int c, int h, int ldw) {
  if (agents)
    onehot_linear_kernel<BN, true><<<grid, kFwdThreads, 0, st>>>(p, w, o, b, c, h, ldw);
  else
    onehot_linear_kernel<BN, false><<<grid, kFwdThreads, 0, st>>>(p, w, o, b, c, h, ldw);
}

// The forward over `agents` agents, blockIdx.z the agent. A block takes 64
// samples and BN columns: BN the smallest of 32, 64, 128 that covers ldw,
// halved while the blocks of all agents would fill under half the SMs (BN
// changes which block computes a row, not its sums).
int launch_forward(const void* packed, const void* w, void* out, int agents, int b, int c,
                   int h, int ldw, cudaStream_t st) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int rows = (b + kFwdRows - 1) / kFwdRows;
  int bn = ldw <= 32 ? 32 : ldw <= 64 ? 64 : 128;
  while (bn > 32 && 2 * agents * rows * ((ldw + bn - 1) / bn) <= sms) bn /= 2;
  const dim3 grid(rows, (ldw + bn - 1) / bn, agents);
  const auto* p = static_cast<const int32_t*>(packed);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* o = static_cast<__nv_bfloat16*>(out);
  switch (bn) {
    case 32: launch_forward_bn<32>(agents > 1, grid, st, p, wb, o, b, c, h, ldw); break;
    case 64: launch_forward_bn<64>(agents > 1, grid, st, p, wb, o, b, c, h, ldw); break;
    default: launch_forward_bn<128>(agents > 1, grid, st, p, wb, o, b, c, h, ldw); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// dW of `agents` agents: the product, then (chunks > 1) the partials' sum.
int launch_grad_all(const void* packed, const void* g, void* partial, void* out, int agents,
                    int b, int c, int h, int chunks, int chunk, cudaStream_t st) {
  float* dst = chunks > 1 ? static_cast<float*>(partial) : static_cast<float*>(out);
  int err;
  switch (h) {
    case 32: err = launch_grad<32>(packed, g, dst, agents, b, c, h, chunks, chunk, st); break;
    case 64: err = launch_grad<64>(packed, g, dst, agents, b, c, h, chunks, chunk, st); break;
    case 128:
    case 256: err = launch_grad<128>(packed, g, dst, agents, b, c, h, chunks, chunk, st); break;
    default: return -1;
  }
  if (err != 0 || chunks == 1) return err;
  const int n = c * kNch * h;
  const size_t total = static_cast<size_t>(n) * agents;
  sum_partials_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), chunks, n, agents);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). W is
// (C*21, ldw), ldw a multiple of 8 and 16-byte aligned rows.
extern "C" int mgt_onehot_linear_launch(const void* packed, const void* w,
                                        void* out, int b, int c, int h,
                                        int ldw, void* stream) {
  return launch_forward(packed, w, out, 1, b, c, h, ldw, static_cast<cudaStream_t>(stream));
}

// The forward of `agents` agents in one launch, the batched instance of
// the TPU kernel that jax.vmap makes over per-agent policies: packed (N, B,
// C), W (N, C*21, ldw), out (N, B, H), each agent's rows as its own launch
// computes them.
extern "C" int mgt_onehot_linear_agents_launch(const void* packed, const void* w,
                                               void* out, int agents, int b, int c,
                                               int h, int ldw, void* stream) {
  return launch_forward(packed, w, out, agents, b, c, h, ldw,
                        static_cast<cudaStream_t>(stream));
}

// dW into `out` (C*21, H) f32, H one of 32, 64, 128, 256. Blocks take 12
// cells x min(H, 128) columns x `chunk` samples (a multiple of 128; the
// wrapper plans the chunks, ops/fused_linear.py::grad_plan). With chunks >
// 1 the blocks write per-chunk partials into `partial` (chunks, C*21, H)
// and a second pass sums them in chunk order. Returns -1 for a hidden
// width the kernel is not built for.
extern "C" int mgt_onehot_grad_launch(const void* packed, const void* g,
                                      void* partial, void* out, int b, int c,
                                      int h, int chunks, int chunk, void* stream) {
  return launch_grad_all(packed, g, partial, out, 1, b, c, h, chunks, chunk,
                         static_cast<cudaStream_t>(stream));
}

// dW of `agents` agents in one launch (and one sum of partials): packed (N,
// B, C), g (N, B, H), `partial` (N * chunks, C*21, H), `out` (N, C*21, H);
// every agent's batch split into the same chunks, each agent's partials
// summed in chunk order, as its own launch sums them.
extern "C" int mgt_onehot_grad_agents_launch(const void* packed, const void* g,
                                             void* partial, void* out, int agents, int b,
                                             int c, int h, int chunks, int chunk,
                                             void* stream) {
  return launch_grad_all(packed, g, partial, out, agents, b, c, h, chunks, chunk,
                         static_cast<cudaStream_t>(stream));
}
