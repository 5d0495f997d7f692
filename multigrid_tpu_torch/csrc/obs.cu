// Egocentric partial observations for a batch of MultiGrid environments.
//
// Replaces the TPU kernel multigrid_tpu/ops/obs_pallas.py::_obs_kernel (with
// the XLA prologue of gen_obs_batched_pallas that overlays the agents).
// For each (env, agent) it computes the agent's view: agents drawn onto the
// grid, the view_size x view_size window cropped with off-grid cells read
// as walls, rotated so the agent faces up, the carried object written at
// the agent's own cell, and (unless see_through_walls) the two-pass
// flood-fill visibility with unseen cells set to 0 (the packed unseen
// encoding).
//
// What bounds it on this card: bytes. The work per output cell is a few
// integer operations; the kernel has to read each env's grid (W*H*3 int32)
// once and write its observations (N*vs*vs int32 packed, or x3 as images):
// 22.7 MB at the flagship as images, 6.8 us at 3.35 TB/s. The work of an
// env is small and serial (the flood fill is ~130 dependent steps an agent
// when written as the reference's loops), so one warp takes one env,
// several envs a block, with no block barrier (the warp's steps are
// ordered by __syncwarp), and the serial parts become bit operations:
//
// - the grid is read as 16-byte vectors, three a lane for four cells, and
//   packed t<<8|c<<4|s into one int32 a cell in shared memory;
// - lanes 0..N-1 load one agent each; an agent is drawn unless terminated,
//   off the grid, or on the cell of a later live agent (shuffles compare
//   the positions), so the later agent wins with no serial thread;
// - each lane crops and rotates view cells from the agent's view extents,
//   kept once in shared memory;
// - the visibility is bit-parallel: a column's see-through mask comes from
//   one __ballot_sync over lanes (agent, row), and each column's forward
//   and backward spreads and its spill into column j-1 are a few shifts and
//   masks on a vs-bit word (an occluded fill, Kogge-Stone style; the same
//   algebra is ops/obs.py::vis_column_bits, held against the loop form);
// - outputs are written by consecutive lanes to consecutive words.
//
// The TPU kernel's roll chains, permutation matmuls and hi/lo byte split
// have no counterpart here: a lane reads its rotated source cell directly.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTypeWall = 2;
constexpr int kTypeDoor = 4;
constexpr int kTypeAgent = 10;
constexpr int kStateOpen = 0;
constexpr int kColorGrey = 5;
constexpr int kWallPacked = (kTypeWall << 8) | (kColorGrey << 4);
constexpr int kMaxEnvsPerBlock = 4;  // warps a block, one env each
constexpr int kMaxSmem = 232448;     // shared memory a block may use on Hopper
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int pack(int t, int c, int s) {
  return (t << 8) | (c << 4) | s;
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// One env's shared memory, in int32 words: per agent (top-left x, y of its
// view, rotation, carried object) as an int4, the packed grid, the views
// and the visibility columns; every part starts 16-byte aligned.
__host__ __device__ __forceinline__ int env_words(int n, int w, int h, int vs) {
  return 4 * n + round4(w * h) + round4(n * vs * vs) + round4(n * vs);
}

// Forward then backward spread of one view column (bit i = row i; the
// agent's row is vs/2) from its lit seeds `x` through its see-through cells
// `see`; returns the column's visible cells and sets `next` to the cells of
// column j-1 lit from it. This is the in-place sweep of the reference
// (multigrid/utils/obs.py:235-273) as occluded fills: the forward pass
// checks rows 0..vs-2 and lights i+1, the backward rows 1..vs-1 and lights
// i-1, and a checked lit see-through row lights rows i and i±1 of column
// j-1. Four doubling steps reach 15 rows, past the largest view (13).
template <int VS>
__device__ __forceinline__ uint32_t vis_column(uint32_t x, uint32_t see, uint32_t& next) {
  const uint32_t sf = see & ((1u << (VS - 1)) - 1u);  // rows the forward pass checks
  uint32_t q = x & sf, p = sf;
  q |= p & (q << 1); p &= p << 1;
  q |= p & (q << 2); p &= p << 2;
  q |= p & (q << 4); p &= p << 4;
  q |= p & (q << 8);
  const uint32_t col = x | (q << 1);
  const uint32_t sb = see & ~1u;  // rows the backward pass checks
  uint32_t r = col & sb;
  p = sb;
  r |= p & (r >> 1); p &= p >> 1;
  r |= p & (r >> 2); p &= p >> 2;
  r |= p & (r >> 4); p &= p >> 4;
  r |= p & (r >> 8);
  next = q | (q << 1) | r | (r >> 1);
  return col | (r >> 1);
}

template <int VS>
__global__ void obs_kernel(
    const int32_t* __restrict__ grid,         // (E, W, H, 3)
    const int32_t* __restrict__ agent_pos,    // (E, N, 2)
    const int32_t* __restrict__ agent_dir,    // (E, N)
    const int32_t* __restrict__ agent_color,  // (E, N)
    const uint8_t* __restrict__ agent_term,   // (E, N) bool
    const int32_t* __restrict__ carrying,     // (E, N, 3)
    int32_t* __restrict__ out,  // (E, N, vs*vs) packed or (E, N, vs*vs, 3)
    int num_envs, int n, int w, int h, int see_through_walls, int packed) {
  constexpr int kV2 = VS * VS;
  constexpr int kHalf = VS / 2;
  constexpr int kR = VS - 1;
  constexpr int kGroup = 32 / VS;  // agents a ballot covers
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * (blockDim.x / 32) + warp;
  if (e >= num_envs) return;  // the whole warp: nothing below waits on other warps
  const int wh = w * h;
  const int nv = n * kV2;
  int4* ag = reinterpret_cast<int4*>(smem + warp * env_words(n, w, h, VS));
  int32_t* cells = reinterpret_cast<int32_t*>(ag + n);  // (W*H) packed
  int32_t* view = cells + round4(wh);                   // (N, vs*vs) packed
  uint32_t* vis = reinterpret_cast<uint32_t*>(view + round4(nv));  // (N, vs) columns

  // Agents first, so their loads are in flight beside the grid's.
  int ax = 0, ay = 0, ad = 0, acol = 0, aterm = 1, acarry = 0;
  if (lane < n) {
    const int idx = e * n + lane;
    ax = agent_pos[2 * idx];
    ay = agent_pos[2 * idx + 1];
    ad = agent_dir[idx];
    acol = agent_color[idx];
    aterm = agent_term[idx];
    acarry = pack(carrying[3 * idx], carrying[3 * idx + 1], carrying[3 * idx + 2]);
  }

  // The grid: four cells (twelve int32) a lane as three 16-byte loads where
  // the env's grid is 16-byte aligned, one cell a lane otherwise.
  const int32_t* g = grid + static_cast<size_t>(e) * wh * 3;
  if ((wh & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int4* g4 = reinterpret_cast<const int4*>(g);
    for (int i = lane; i < wh / 4; i += 32) {
      const int4 p = __ldg(g4 + 3 * i), q = __ldg(g4 + 3 * i + 1), r = __ldg(g4 + 3 * i + 2);
      reinterpret_cast<int4*>(cells)[i] =
          make_int4(pack(p.x, p.y, p.z), pack(p.w, q.x, q.y), pack(q.z, q.w, r.x),
                    pack(r.y, r.z, r.w));
    }
  } else {
    for (int c = lane; c < wh; c += 32) cells[c] = pack(g[3 * c], g[3 * c + 1], g[3 * c + 2]);
  }

  // Each agent's view extents (get_view_exts) and rotation k = (dir + 1) & 3.
  if (lane < n) {
    const int tx = ad == 0 ? ax : ad == 1 ? ax - kHalf : ad == 2 ? ax - kR : ax - kHalf;
    const int ty = ad == 0 ? ay - kHalf : ad == 1 ? ay : ad == 2 ? ay - kHalf : ay - kR;
    ag[lane] = make_int4(tx, ty, (ad + 1) & 3, acarry);
  }
  __syncwarp();

  // Agents in index order, so a later agent wins a shared cell; terminated
  // agents are not drawn. One agent sees no other, so N = 1 skips this.
  if (n > 1) {
    const bool live = lane < n && !aterm && ax >= 0 && ax < w && ay >= 0 && ay < h;
    const int key = live ? ax * h + ay : -1 - lane;
    bool covered = false;
#pragma unroll
    for (int d = 1; d < 8; ++d) {
      const int later = __shfl_down_sync(kFull, key, d);
      covered |= lane + d < n && later == key;
    }
    if (live && !covered) cells[key] = pack(kTypeAgent, acol, ad);
    __syncwarp();
  }

  // Crop and rotate: one lane a view cell, out = rot90(window, k=-k).
  for (int q = lane; q < nv; q += 32) {
    const int a = q / kV2, cell = q - a * kV2;
    const int i = cell / VS, j = cell - i * VS;
    const int4 x = ag[a];
    int val;
    if (cell == kHalf * VS + kR) {
      val = x.w;  // the carried object at the agent's own cell
    } else {
      int u, v;
      switch (x.z) {
        case 0: u = i;      v = j;      break;
        case 1: u = kR - j; v = i;      break;
        case 2: u = kR - i; v = kR - j; break;
        default: u = j;     v = kR - i; break;
      }
      const int wx = x.x + u, wy = x.y + v;
      val = (wx >= 0 && wx < w && wy >= 0 && wy < h) ? cells[wx * h + wy] : kWallPacked;
    }
    view[q] = val;
  }
  __syncwarp();

  if (!see_through_walls) {
    // See-through masks: lane (agent a of a group, row i) tests cell (i, j)
    // of every column j; lane a keeps its agent's columns.
    uint32_t see[VS];
#pragma unroll
    for (int j = 0; j < VS; ++j) see[j] = 0u;
    for (int a0 = 0; a0 < n; a0 += kGroup) {
      const int a = a0 + lane / VS, i = lane % VS;
      const bool row = lane < kGroup * VS && a < n;
      const int32_t* va = view + (row ? a : 0) * kV2 + i * VS;
#pragma unroll
      for (int j = 0; j < VS; ++j) {
        const int c = row ? va[j] : 0;
        const int t = c >> 8, s = c & 15;
        const bool clear = row && !(t == kTypeWall || (t == kTypeDoor && s != kStateOpen));
        const uint32_t bits = __ballot_sync(kFull, clear);
        if (lane >= a0 && lane < a0 + kGroup)
          see[j] = (bits >> ((lane - a0) * VS)) & ((1u << VS) - 1u);
      }
    }
    // Columns from the agent's (vs-1) to 0, lane a for agent a.
    if (lane < n) {
      uint32_t lit = 1u << kHalf;
#pragma unroll
      for (int j = kR; j >= 0; --j) {
        uint32_t next;
        vis[lane * VS + j] = vis_column<VS>(lit, see[j], next);
        lit = next;
      }
    }
    __syncwarp();
    // Unseen cells read 0.
    for (int q = lane; q < nv; q += 32) {
      const int a = q / kV2, cell = q - a * kV2;
      const int i = cell / VS, j = cell - i * VS;
      if (!((vis[a * VS + j] >> i) & 1u)) view[q] = 0;
    }
    __syncwarp();
  }

  if (packed) {
    int32_t* o = out + static_cast<size_t>(e) * nv;
    for (int q = lane; q < nv; q += 32) o[q] = view[q];
  } else {
    int32_t* o = out + static_cast<size_t>(e) * nv * 3;
    for (int k = lane; k < 3 * nv; k += 32) {
      const int q = k / 3, f = k - 3 * q;
      const int val = view[q];
      o[k] = f == 0 ? val >> 8 : f == 1 ? (val >> 4) & 15 : val & 15;
    }
  }
}

template <int VS>
int launch(const void* grid, const void* agent_pos, const void* agent_dir,
           const void* agent_color, const void* agent_term, const void* carrying, void* out,
           int e, int n, int w, int h, int see_through_walls, int packed, cudaStream_t st) {
  const int per_env = 4 * env_words(n, w, h, VS);
  const int envs = std::max(1, std::min(kMaxEnvsPerBlock, kMaxSmem / per_env));
  const int smem = envs * per_env;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(obs_kernel<VS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  obs_kernel<VS><<<(e + envs - 1) / envs, 32 * envs, smem, st>>>(
      static_cast<const int32_t*>(grid), static_cast<const int32_t*>(agent_pos),
      static_cast<const int32_t*>(agent_dir), static_cast<const int32_t*>(agent_color),
      static_cast<const uint8_t*>(agent_term), static_cast<const int32_t*>(carrying),
      static_cast<int32_t*>(out), e, n, w, h, see_through_walls, packed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a view size the kernel is not built for.
extern "C" int mgt_obs_launch(
    const void* grid, const void* agent_pos, const void* agent_dir,
    const void* agent_color, const void* agent_term, const void* carrying,
    void* out, int e, int n, int w, int h, int vs, int see_through_walls,
    int packed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MGT_OBS_CASE(V)                                                                    \
  case V:                                                                                 \
    return launch<V>(grid, agent_pos, agent_dir, agent_color, agent_term, carrying, out, e, \
                     n, w, h, see_through_walls, packed, st);
  switch (vs) {
    MGT_OBS_CASE(3)
    MGT_OBS_CASE(5)
    MGT_OBS_CASE(7)
    MGT_OBS_CASE(9)
    MGT_OBS_CASE(11)
    MGT_OBS_CASE(13)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MGT_OBS_CASE
}
