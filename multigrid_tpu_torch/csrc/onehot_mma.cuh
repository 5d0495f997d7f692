// one_hot(packed) @ W on the tensor cores, the one-hot never in memory:
// the routine shared by the first-layer kernel (fused_linear.cu, replacing
// the TPU kernel multigrid_tpu/ops/fused_linear.py::_kernel) and the mlp
// forward of the PPO loss and rollout policy kernels (mlp_forward.cuh, for
// fused_ppo.cu and fused_policy.cu).
//
// A packed cell t<<8|c<<4|s has exactly three ones in its 21 channels (type
// t, color 11+c, state 17+s; a field out of its channel's range has none);
// W is the flax layout (C*21, H) with feature index cell*21 + ch.
//
// A block owns a tile of samples, 16 rows a warp, and walks K, the C*21
// one-hot features, in 16-deep steps in channel-major order (as the TPU
// kernel does, fused_linear.py:179-189): cells are taken 16 at a time (a
// cell block, padded past C with cells that match no channel) and, for each
// of the 21 channels, one step covers that channel of the block's 16 cells.
// The A fragment is then one bit test per cell against a constant: each
// thread turns its 8 cells of a block into 21-bit channel masks once and
// reads bit `ch` for every channel (the loop over channels is unrolled).
// W keeps flax's (C*21, H) layout: a step's 16 B rows are W rows
// cell*21 + ch, each contiguous, staged by 16-byte cp.async into a ring of
// shared-memory stages, each holding several channels' steps (one barrier
// a stage: a 16-deep step alone is too little work to hide L2's latency),
// issued stages ahead of the products (rows past C and columns past the
// valid ones are zero-filled, with no read); the products
// are mma.sync m16n8k16 (bf16 in, f32 sums), the B fragments loaded with
// ldmatrix.trans from rows padded by 16 bytes against bank conflicts.
//
// Why mma.sync and not wgmma: the A operand is built in registers from the
// cells at every step, and B3 (fused_linear.cu) already runs this fragment
// layout; mma.sync needs no warpgroup-wide descriptors or fences, so one
// routine serves every caller's warp layout (B2: 4 warps of 16 rows x the
// block's columns; the mlp forward: 4 x 2 warps over 64 rows x H).
// Measured on the H100, B2 runs its padded product at about a sixth of the
// tensor cores' dense rate, so the instruction is not what bounds it.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kNch = 21;  // one-hot channels: 11 types, 6 colors, 4 states
constexpr int kTypes = 11;
constexpr int kColors = 6;
constexpr int kStates = 4;
constexpr int kCellBlock = 16;  // cells per K step (one channel each)
constexpr int kPadCell = (0x7FF << 8) | (15 << 4) | 15;  // a cell matching no channel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x16, row) @ b (16x8, col), bf16 in, f32 sums.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lane l gives the address of row l%8 of matrix l/8.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The A fragment of a 16x16 tile from a row-major (m, k) bf16 array of row
// stride ld: rows m0.., columns k0...
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s, int ld, int m0,
                                       int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4(a, s + (m0 + (i & 1) * 8 + r) * ld + k0 + (i >> 1) * 8);
}

// The A fragment of a 16x16 tile of the transpose of a row-major (k, m)
// array: A[m][k] = s[k][m].
__device__ __forceinline__ void load_a_t(uint32_t a[4], const __nv_bfloat16* s, int ld, int m0,
                                         int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4_t(a, s + (k0 + (i >> 1) * 8 + r) * ld + m0 + (i & 1) * 8);
}

// B fragments of two neighbouring 16x8 tiles (columns n0.. and n0+8..) from
// a row-major (k, n) array: b[0], b[1] for the first, b[2], b[3] for the
// second.
__device__ __forceinline__ void load_b2(uint32_t b[4], const __nv_bfloat16* s, int ld, int k0,
                                        int n0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4_t(b, s + (k0 + (i & 1) * 8 + r) * ld + n0 + (i >> 1) * 8);
}

// The same from a row-major (n, k) array, B[k][n] = s[n][k].
__device__ __forceinline__ void load_b2_t(uint32_t b[4], const __nv_bfloat16* s, int ld, int k0,
                                          int n0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4(b, s + (n0 + (i >> 1) * 8 + r) * ld + k0 + (i & 1) * 8);
}

// The channels a packed cell t<<8|c<<4|s sets, as bits 0..20.
__device__ __forceinline__ uint32_t channel_bits(int32_t p) {
  const uint32_t t = static_cast<uint32_t>(p) >> 8, c = (p >> 4) & 15, s = p & 15;
  return (t < kTypes ? 1u << t : 0u) | (c < kColors ? 1u << (kTypes + c) : 0u)
         | (s < kStates ? 1u << (kTypes + kColors + s) : 0u);
}

// Two bf16 one-hot entries (bit ch of lo and hi) packed into one register.
__device__ __forceinline__ uint32_t onehot_pair(uint32_t lo, uint32_t hi, int ch) {
  return ((lo >> ch) & 1u) * 0x3F80u | ((hi >> ch) & 1u) * 0x3F800000u;
}

// Stage q of W (cell block q / (21 / kGroup), its kGroup channels) into its
// slot of the ring, by 16-byte cp.async from every thread (no commit).
template <int BN, int kThreads, int kStages, int kGroup>
__device__ __forceinline__ void onehot_issue(int q, int c, const __nv_bfloat16* __restrict__ w,
                                             int ldw, int col0, int cols, __nv_bfloat16* ring) {
  constexpr int kLd = BN + 8;
  constexpr int kRows = 16 * kGroup;        // W rows a stage
  constexpr int kChunks = kRows * BN / 8;   // 16-byte pieces of a stage
  constexpr int kPerBlock = kNch / kGroup;  // stages a cell block
  const int cb = q / kPerBlock, ch0 = (q - cb * kPerBlock) * kGroup;
  __nv_bfloat16* st = ring + (q % kStages) * kRows * kLd;
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const int row = i / (BN / 8), col = (i % (BN / 8)) * 8;
    const int cell = cb * kCellBlock + row % 16;
    const bool valid = cell < c && col0 + col < cols;
    const __nv_bfloat16* src =
        valid ? w + static_cast<size_t>(cell * kNch + ch0 + row / 16) * ldw + col0 + col : w;
    cp_async16(st + row * kLd + col, src, valid);
  }
}

// The ring's first kStages - 1 stages, each its own group. W's stages do
// not depend on the samples, so a block that walks several tiles primes
// the next tile's ring while it finishes the current one.
template <int BN, int kThreads, int kStages, int kGroup>
__device__ __forceinline__ void onehot_prime(int c, const __nv_bfloat16* __restrict__ w,
                                             int ldw, int col0, int cols, __nv_bfloat16* ring) {
  const int stages = (c + kCellBlock - 1) / kCellBlock * (kNch / kGroup);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) onehot_issue<BN, kThreads, kStages, kGroup>(s, c, w, ldw, col0, cols, ring);
    cp_async_commit();
  }
}

// onehot_mma (below) on a ring that onehot_prime has primed.
template <int BN, int NT, int kThreads, int kStages, int kGroup>
__device__ __forceinline__ void onehot_mma_primed(const int32_t* __restrict__ packed, int b,
                                                  int c, int s0, int r0,
                                                  const __nv_bfloat16* __restrict__ w, int ldw,
                                                  int col0, int cols, __nv_bfloat16* ring,
                                                  int wcol, float (&acc)[NT][4]) {
  static_assert(NT % 2 == 0 && BN % 16 == 0, "column tiles come in pairs");
  static_assert(kNch % kGroup == 0, "a cell block's channels fill whole stages");
  constexpr int kLd = BN + 8;
  constexpr int kRows = 16 * kGroup;        // W rows a stage
  constexpr int kPerBlock = kNch / kGroup;  // stages a cell block
  const int lane = threadIdx.x & 31, tig = lane & 3;
  const int nb = (c + kCellBlock - 1) / kCellBlock;
  const int stages = nb * kPerBlock;

  // The thread's cells of a block: rows r0, r0 + 8; cells 2t, 2t+1, 2t+8, 2t+9.
  int32_t cells[8];
  auto load_cells = [&](int cb) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int row = s0 + r0 + (e >> 2) * 8;
      const int cell = cb * kCellBlock + 2 * tig + (e & 1) + ((e >> 1) & 1) * 8;
      cells[e] = row < b && cell < c ? packed[static_cast<size_t>(row) * c + cell] : kPadCell;
    }
  };
  load_cells(0);

  for (int cb = 0; cb < nb; ++cb) {
    uint32_t bits[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) bits[e] = channel_bits(cells[e]);
    if (cb + 1 < nb) load_cells(cb + 1);  // in flight over the block's stages
#pragma unroll
    for (int g = 0; g < kPerBlock; ++g) {
      const int q = cb * kPerBlock + g;
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage q has landed; stage q - 1's slot is free
      if (q + kStages - 1 < stages)
        onehot_issue<BN, kThreads, kStages, kGroup>(q + kStages - 1, c, w, ldw, col0, cols, ring);
      cp_async_commit();
      const __nv_bfloat16* st = ring + (q % kStages) * kRows * kLd;
#pragma unroll
      for (int cc = 0; cc < kGroup; ++cc) {
        const int ch = g * kGroup + cc;
        uint32_t a[4];
        a[0] = onehot_pair(bits[0], bits[1], ch);  // row r0, cells 2t, 2t+1
        a[1] = onehot_pair(bits[4], bits[5], ch);  // row r0 + 8
        a[2] = onehot_pair(bits[2], bits[3], ch);  // row r0, cells 2t+8, 2t+9
        a[3] = onehot_pair(bits[6], bits[7], ch);  // row r0 + 8
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          load_b2(bb, st, kLd, 16 * cc, wcol + 16 * np, lane);
          mma_16816(acc[2 * np], a, bb[0], bb[1]);
          mma_16816(acc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// acc += one_hot(packed[s0 .. s0 + tile rows)) @ W[:, col0 .. col0 + BN),
// for the thread's fragment: rows r0 and r0 + 8 of the tile (r0 = 16 *
// warp row + lane / 4) and columns wcol .. wcol + 8 * NT of the block's BN.
// W is (c*21, ldw) bf16, 16-byte aligned, ldw a multiple of 8; its columns
// at or past `cols` read as 0. A stage holds kGroup channels' 16-row steps
// (one barrier a stage); `ring` is kStages x 16*kGroup x (BN + 8) bf16 of
// shared memory. Every thread of the block (kThreads) must call it; the
// ring is free again when it returns.
template <int BN, int NT, int kThreads, int kStages, int kGroup>
__device__ __forceinline__ void onehot_mma(const int32_t* __restrict__ packed, int b, int c,
                                           int s0, int r0, const __nv_bfloat16* __restrict__ w,
                                           int ldw, int col0, int cols, __nv_bfloat16* ring,
                                           int wcol, float (&acc)[NT][4]) {
  onehot_prime<BN, kThreads, kStages, kGroup>(c, w, ldw, col0, cols, ring);
  onehot_mma_primed<BN, NT, kThreads, kStages, kGroup>(packed, b, c, s0, r0, w, ldw, col0, cols,
                                                       ring, wcol, acc);
}

}  // namespace
