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
// - agents go in rounds of 32, one a lane; an agent is drawn unless
//   terminated, off the grid, or on the cell of a later live agent of its
//   round (shuffles compare the positions), and the rounds draw in order,
//   so the later agent wins with no serial thread, for any team size
//   (teams of at most 8 take a kernel of one round and 7 unrolled
//   shuffles, the form built for them alone);
// - each lane crops and rotates view cells from the agent's view extents,
//   kept once in shared memory;
// - the visibility is bit-parallel: a column's see-through mask comes from
//   one __ballot_sync over lanes (agent, row), and each column's forward
//   and backward spreads and its spill into column j-1 are a few shifts and
//   masks on a vs-bit word (an occluded fill, Kogge-Stone style; the same
//   algebra is ops/obs.py::vis_column_bits, held against the loop form);
//   a lane sweeps one agent's columns, 32 agents a round;
// - outputs are written by consecutive lanes to consecutive words.
//
// The TPU kernel's roll chains, permutation matmuls and hi/lo byte split
// have no counterpart here: a lane reads its rotated source cell directly.
//
// obs_general_kernel (below) computes the same function for the shapes
// obs_kernel does not take: views of 33 and more, and envs whose grid and
// views do not fit a block's shared memory.
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
// j-1. Four doubling steps reach 15 rows; views past 15 take a fifth,
// which reaches 31, the largest view (a column is one 32-bit word).
template <int VS>
__device__ __forceinline__ uint32_t vis_column(uint32_t x, uint32_t see, uint32_t& next) {
  const uint32_t sf = see & ((1u << (VS - 1)) - 1u);  // rows the forward pass checks
  uint32_t q = x & sf, p = sf;
  q |= p & (q << 1); p &= p << 1;
  q |= p & (q << 2); p &= p << 2;
  q |= p & (q << 4); p &= p << 4;
  q |= p & (q << 8);
  if (VS > 15) {
    p &= p << 8;
    q |= p & (q << 16);
  }
  const uint32_t col = x | (q << 1);
  const uint32_t sb = see & ~1u;  // rows the backward pass checks
  uint32_t r = col & sb;
  p = sb;
  r |= p & (r >> 1); p &= p >> 1;
  r |= p & (r >> 2); p &= p >> 2;
  r |= p & (r >> 4); p &= p >> 4;
  r |= p & (r >> 8);
  if (VS > 15) {
    p &= p >> 8;
    r |= p & (r >> 16);
  }
  next = q | (q << 1) | r | (r >> 1);
  return col | (r >> 1);
}

// kFew: at most 8 agents, one round whose overlay takes 7 unrolled
// shuffles (the time of the kernel built for 1..8 agents only).
template <int VS, bool kFew>
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

  // The first 32 agents first, so their loads are in flight beside the
  // grid's (later rounds load theirs below; written out twice, as a
  // lambda this cost the few-agent kernel time).
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

  // Agents in rounds of 32, lane l taking agent a0 + l: its view extents
  // (get_view_exts) and rotation k = (dir + 1) & 3, then the overlay. The
  // rounds draw in index order, and within a round an agent on the cell of
  // a later live agent is not drawn, so a later agent wins a shared cell;
  // terminated agents are not drawn. One agent sees no other, so N = 1
  // skips the overlay.
  const int nr = kFew ? 1 : n;  // a0 < nr: one round, or a round for every 32 agents
  for (int a0 = 0; a0 < nr; a0 += 32) {
    const int rn = kFew ? n : min(32, n - a0);
    if (a0 > 0 && lane < rn) {
      const int idx = e * n + a0 + lane;
      ax = agent_pos[2 * idx];
      ay = agent_pos[2 * idx + 1];
      ad = agent_dir[idx];
      acol = agent_color[idx];
      aterm = agent_term[idx];
      acarry = pack(carrying[3 * idx], carrying[3 * idx + 1], carrying[3 * idx + 2]);
    }
    if (lane < rn) {
      const int tx = ad == 0 ? ax : ad == 1 ? ax - kHalf : ad == 2 ? ax - kR : ax - kHalf;
      const int ty = ad == 0 ? ay - kHalf : ad == 1 ? ay : ad == 2 ? ay - kHalf : ay - kR;
      ag[a0 + lane] = make_int4(tx, ty, (ad + 1) & 3, acarry);
    }
    __syncwarp();  // the grid (and the previous round's agents) are in place
    if (n > 1) {
      const bool live = lane < rn && !aterm && ax >= 0 && ax < w && ay >= 0 && ay < h;
      const int key = live ? ax * h + ay : -1 - lane;
      bool covered = false;
      if (kFew) {
#pragma unroll
        for (int d = 1; d < 8; ++d) {
          const int later = __shfl_down_sync(kFull, key, d);
          covered |= lane + d < rn && later == key;
        }
      } else {
        for (int d = 1; d < rn; ++d) {
          const int later = __shfl_down_sync(kFull, key, d);
          covered |= lane + d < rn && later == key;
        }
      }
      if (live && !covered) cells[key] = pack(kTypeAgent, acol, ad);
    }
  }
  __syncwarp();

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
    // In rounds of 32 agents: see-through masks, lane (agent a of a group,
    // row i) testing cell (i, j) of every column j, lane a keeping agent
    // a0 + a's columns; then columns from the agent's (vs-1) to 0, lane a
    // sweeping agent a0 + a.
    for (int a0 = 0; a0 < nr; a0 += 32) {
      const int rn = kFew ? n : min(32, n - a0);
      uint32_t see[VS];
#pragma unroll
      for (int j = 0; j < VS; ++j) see[j] = 0u;
      for (int g0 = 0; g0 < rn; g0 += kGroup) {
        const int a = g0 + lane / VS, i = lane % VS;
        const bool row = lane < kGroup * VS && a < rn;
        const int32_t* va = view + (row ? a0 + a : 0) * kV2 + i * VS;
#pragma unroll
        for (int j = 0; j < VS; ++j) {
          const int c = row ? va[j] : 0;
          const int t = c >> 8, s = c & 15;
          const bool clear = row && !(t == kTypeWall || (t == kTypeDoor && s != kStateOpen));
          const uint32_t bits = __ballot_sync(kFull, clear);
          if (lane >= g0 && lane < g0 + kGroup)
            see[j] = (bits >> ((lane - g0) * VS)) & ((1u << VS) - 1u);
        }
      }
      if (lane < rn) {
        uint32_t lit = 1u << kHalf;
#pragma unroll
        for (int j = kR; j >= 0; --j) {
          uint32_t next;
          vis[(a0 + lane) * VS + j] = vis_column<VS>(lit, see[j], next);
          lit = next;
        }
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
  auto kernel = n <= 8 ? obs_kernel<VS, true> : obs_kernel<VS, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(e + envs - 1) / envs, 32 * envs, smem, st>>>(
      static_cast<const int32_t*>(grid), static_cast<const int32_t*>(agent_pos),
      static_cast<const int32_t*>(agent_dir), static_cast<const int32_t*>(agent_color),
      static_cast<const uint8_t*>(agent_term), static_cast<const int32_t*>(carrying),
      static_cast<int32_t*>(out), e, n, w, h, see_through_walls, packed);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// obs_general_kernel: the same function for every shape obs_kernel does not
// take: any odd view (a view column of any number of 32-bit words) and any
// grid and team, with no part of the env staged in shared memory.
//
// One block an env, a warp an agent at a time. The grid is read from global
// memory (L2 holds it; each view cell is read twice, for the see-through
// mask and for the output). The overlay is an open-addressing hash table in
// global scratch, (E, T) slots of (cell, agent), T a power of two >= 2N:
// the block clears its env's slots, then every live agent claims its
// cell's slot (atomicCAS) and raises the slot's agent to its own index
// (atomicMax), so the last live agent in index order wins a shared cell, as
// the reference's in-order drawing gives. Visibility is the reference's
// column sweep on columns of ceil(vs/32) words: the lanes ballot a column's
// see-through mask, one lane runs the forward and the backward spread word
// by word (the doubling fill of vis_column within a word, a carry between
// words), and the lanes write the column, unseen cells as 0. A warp's
// shared memory is four columns: see-through (then visible), lit, and the
// two spreads.

constexpr int kGeneralWarps = 4;

// Bytes of shared memory obs_general_kernel takes for `warps` warps at view
// `vs`: four columns of ceil(vs/32) words a warp.
int general_smem(int vs, int warps) { return warps * 16 * ((vs + 31) / 32); }

__device__ __forceinline__ unsigned hash_slot(int key, int mask) {
  return (static_cast<unsigned>(key) * 2654435761u) & static_cast<unsigned>(mask);
}

struct View {
  int tx, ty, k, carry;
};

struct EnvRef {
  const int32_t* grid;  // this env's (W, H, 3)
  const int2* table;    // this env's slots, or null without the overlay
  const int32_t* color; // this env's (N,) agent colors
  const int32_t* dir;   // this env's (N,) agent directions
  int mask, w, h;
};

__device__ __forceinline__ int cell_at(const EnvRef& r, int x, int y) {
  if (x < 0 || x >= r.w || y < 0 || y >= r.h) return kWallPacked;
  const int c = x * r.h + y;
  if (r.table != nullptr) {
    for (unsigned s = hash_slot(c, r.mask);; s = (s + 1) & static_cast<unsigned>(r.mask)) {
      const int2 t = __ldcg(r.table + s);
      if (t.x == c) return pack(kTypeAgent, r.color[t.y], r.dir[t.y]);
      if (t.x == -1) break;
    }
  }
  const int32_t* g = r.grid + 3 * c;
  return pack(g[0], g[1], g[2]);
}

// Cell (i, j) of an agent's view: rot90(window, k=-k), and the carried
// object at the agent's own cell.
__device__ __forceinline__ int view_cell(const EnvRef& r, const View& v, int vs, int i, int j) {
  const int kr = vs - 1;
  if (i == vs / 2 && j == kr) return v.carry;
  int u, w;
  switch (v.k) {
    case 0: u = i;      w = j;      break;
    case 1: u = kr - j; w = i;      break;
    case 2: u = kr - i; w = kr - j; break;
    default: u = j;     w = kr - i; break;
  }
  return cell_at(r, v.tx + u, v.ty + w);
}

__device__ __forceinline__ uint32_t rows_below(int limit, int word) {
  const int lo = 32 * word;
  return limit <= lo ? 0u : limit >= lo + 32 ? ~0u : (1u << (limit - lo)) - 1u;
}

// One column's spreads on nw words (bit i of word w = row 32w + i), by one
// lane: from `see` (see-through rows) and `lit` (its lit rows) to the
// column's visible rows, left in `see`, and the next column's lit rows,
// left in `lit`. `q` and `r` hold the forward and backward spreads.
__device__ void vis_column_words(uint32_t* see, uint32_t* lit, uint32_t* q, uint32_t* r,
                                 int nw, int vs) {
  uint32_t carry = 0;  // the forward spread crossing into the next word
  for (int w = 0; w < nw; ++w) {
    const uint32_t sf = see[w] & rows_below(vs - 1, w);  // rows the forward pass checks
    uint32_t x = (lit[w] | carry) & sf, p = sf;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      x |= p & (x << k);
      p &= p << k;
    }
    q[w] = x;
    carry = x >> 31;
  }
  carry = 0;  // the backward spread crossing into the word below
  for (int w = nw - 1; w >= 0; --w) {
    const uint32_t sb = see[w] & rows_below(vs, w) & (w == 0 ? ~1u : ~0u);
    const uint32_t col = lit[w] | (q[w] << 1) | (w > 0 ? q[w - 1] >> 31 : 0u);
    uint32_t x = (col | (carry << 31)) & sb, p = sb;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      x |= p & (x >> k);
      p &= p >> k;
    }
    r[w] = x;
    carry = x & 1u;
  }
  for (int w = 0; w < nw; ++w) {
    const uint32_t up = w > 0 ? q[w - 1] >> 31 : 0u;
    const uint32_t down = w + 1 < nw ? r[w + 1] << 31 : 0u;
    see[w] = lit[w] | (q[w] << 1) | up | (r[w] >> 1) | down;
  }
  for (int w = 0; w < nw; ++w) {
    const uint32_t up = w > 0 ? q[w - 1] >> 31 : 0u;
    const uint32_t down = w + 1 < nw ? r[w + 1] << 31 : 0u;
    lit[w] = q[w] | (q[w] << 1) | up | r[w] | (r[w] >> 1) | down;
  }
}

__device__ __forceinline__ void put(int32_t* o, int q, int val, int packed) {
  if (packed) {
    o[q] = val;
  } else {
    o[3 * q] = val >> 8;
    o[3 * q + 1] = (val >> 4) & 15;
    o[3 * q + 2] = val & 15;
  }
}

__global__ void obs_general_kernel(
    const int32_t* __restrict__ grid, const int32_t* __restrict__ agent_pos,
    const int32_t* __restrict__ agent_dir, const int32_t* __restrict__ agent_color,
    const uint8_t* __restrict__ agent_term, const int32_t* __restrict__ carrying,
    int32_t* __restrict__ out, int2* table, int table_size, int n, int w, int h, int vs,
    int see_through_walls, int packed) {
  extern __shared__ __align__(16) uint32_t gsm[];
  const int e = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = (vs + 31) / 32;
  int2* tab = n > 1 ? table + static_cast<size_t>(e) * table_size : nullptr;

  if (tab != nullptr) {
    for (int s = threadIdx.x; s < table_size; s += blockDim.x) tab[s] = make_int2(-1, -1);
    __syncthreads();
    for (int a = threadIdx.x; a < n; a += blockDim.x) {
      const int idx = e * n + a;
      const int x = agent_pos[2 * idx], y = agent_pos[2 * idx + 1];
      if (agent_term[idx] || x < 0 || x >= w || y < 0 || y >= h) continue;
      const int key = x * h + y;
      for (unsigned s = hash_slot(key, table_size - 1);;
           s = (s + 1) & static_cast<unsigned>(table_size - 1)) {
        const int prev = atomicCAS(&tab[s].x, -1, key);
        if (prev == -1 || prev == key) {
          atomicMax(&tab[s].y, a);
          break;
        }
      }
    }
    __syncthreads();
  }

  const EnvRef env{grid + static_cast<size_t>(e) * w * h * 3, tab, agent_color + e * n,
                   agent_dir + e * n, table_size - 1, w, h};
  uint32_t* see = gsm + warp * 4 * nw;
  uint32_t* lit = see + nw;
  uint32_t* q = lit + nw;
  uint32_t* r = q + nw;
  const int half = vs / 2, kr = vs - 1;
  const size_t cells = static_cast<size_t>(vs) * vs;
  for (int a = warp; a < n; a += blockDim.x / 32) {
    const int idx = e * n + a;
    const int ax = agent_pos[2 * idx], ay = agent_pos[2 * idx + 1], ad = agent_dir[idx];
    View v;
    v.tx = ad == 0 ? ax : ad == 1 ? ax - half : ad == 2 ? ax - kr : ax - half;
    v.ty = ad == 0 ? ay - half : ad == 1 ? ay : ad == 2 ? ay - half : ay - kr;
    v.k = (ad + 1) & 3;
    v.carry = pack(carrying[3 * idx], carrying[3 * idx + 1], carrying[3 * idx + 2]);
    int32_t* o = out + static_cast<size_t>(idx) * cells * (packed ? 1 : 3);
    if (see_through_walls) {
      for (int c = lane; c < vs * vs; c += 32) put(o, c, view_cell(env, v, vs, c / vs, c % vs), packed);
      continue;
    }
    for (int k = lane; k < nw; k += 32) lit[k] = k == half / 32 ? 1u << (half % 32) : 0u;
    for (int j = kr; j >= 0; --j) {
      for (int i0 = 0; i0 < vs; i0 += 32) {
        const int i = i0 + lane;
        bool clear = false;
        if (i < vs) {
          const int c = view_cell(env, v, vs, i, j);
          const int t = c >> 8, s = c & 15;
          clear = !(t == kTypeWall || (t == kTypeDoor && s != kStateOpen));
        }
        const uint32_t bits = __ballot_sync(kFull, clear);
        if (lane == 0) see[i0 / 32] = bits;
      }
      __syncwarp();
      if (lane == 0) vis_column_words(see, lit, q, r, nw, vs);
      __syncwarp();
      for (int i = lane; i < vs; i += 32) {
        const bool visible = (see[i / 32] >> (i % 32)) & 1u;
        put(o, i * vs + j, visible ? view_cell(env, v, vs, i, j) : 0, packed);
      }
      __syncwarp();
    }
  }
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
    MGT_OBS_CASE(15)
    MGT_OBS_CASE(17)
    MGT_OBS_CASE(19)
    MGT_OBS_CASE(21)
    MGT_OBS_CASE(23)
    MGT_OBS_CASE(25)
    MGT_OBS_CASE(27)
    MGT_OBS_CASE(29)
    MGT_OBS_CASE(31)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MGT_OBS_CASE
}

// Launches obs_general_kernel on `stream`, one block an env, and returns
// cudaGetLastError() (0 on success). `table` is (E, table_size) int2
// scratch (table_size a power of two >= 2N; unused for N = 1).
extern "C" int mgt_obs_general_launch(
    const void* grid, const void* agent_pos, const void* agent_dir,
    const void* agent_color, const void* agent_term, const void* carrying,
    void* out, void* table, int table_size, int e, int n, int w, int h, int vs,
    int see_through_walls, int packed, void* stream) {
  int warps = std::min(kGeneralWarps, std::max(1, n));
  while (warps > 1 && general_smem(vs, warps) > kMaxSmem) --warps;
  const int smem = general_smem(vs, warps);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        obs_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  obs_general_kernel<<<e, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(grid), static_cast<const int32_t*>(agent_pos),
      static_cast<const int32_t*>(agent_dir), static_cast<const int32_t*>(agent_color),
      static_cast<const uint8_t*>(agent_term), static_cast<const int32_t*>(carrying),
      static_cast<int32_t*>(out), static_cast<int2*>(table), table_size, n, w, h, vs,
      see_through_walls, packed);
  return static_cast<int>(cudaGetLastError());
}
