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
// take: any odd view (views of 33 and more), any grid (past a block's shared
// memory) and any team.
//
// What bounds it on this card: latency. Its bytes are few (at 256 envs of
// 32x32, view 33, packed: 4.2 MB read and written, 1.2 us at 3.35 TB/s),
// but each view's visibility is a chain of vs dependent column steps. So
// the views run side by side: one warp an (env, agent) view, consecutive
// views on a block's warps, E·N warps in all, and each warp's chain is
// short:
//
// - stage: the warp reads its view's window once, lanes on consecutive
//   cells along the grid's contiguous y axis (c = x·H + y), four cells a
//   lane in flight, off-grid cells as walls, and keeps it in shared memory
//   as one packed uint16 a cell (t<<8|c<<4|s), already rotated
//   (rot90(window, -k): cell (i, j) of the view at j·vs + i);
// - overlay: the live agents in rounds of 32, one a lane; an agent inside
//   the window draws unless a later agent of its round is on its cell
//   (__match_any_sync), and the rounds draw in order, so the later live
//   agent wins; then the carried object at the agent's own cell;
// - sweep: each column's see-through rows from the staged cells, a lane a
//   column, then one lane runs the columns vs-1..0, each pass of the
//   reference's sweep (multigrid/utils/obs.py:235-273) an occluded fill by
//   one carry-propagating add (fill_up; the backward pass on bit-reversed
//   words): a 64-bit word a column in registers for views up to 63 (1.4-1.9x
//   faster there than the words form on an H100), ceil(vs/32) words in
//   shared memory past that (ops/obs.py::vis_column_words is the plain form);
//   then the unseen cells are set to 0, a lane a column;
// - write: row-major, consecutive lanes on consecutive output words.
//
// A window that does not fit the warp's share of shared memory (views past
// 163 at four warps a block) goes in strips of columns, right to left, the
// sweep's lit rows carried from strip to strip (general_plan).

constexpr int kGeneralMaxWarps = 4;  // warps a block
constexpr int kNarrowView = 63;      // views whose column is one 64-bit word

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// Bytes of shared memory one warp takes at view `vs` with strips of `strip`
// columns: the staged cells, then per strip column its see-through (then
// visible) rows, a 64-bit word for views up to 63; past that ceil(vs/32)
// words, and the lit rows and the two fills' words after the strip's.
__host__ __device__ __forceinline__ int general_warp_bytes(int vs, int strip) {
  const int words = vs <= kNarrowView ? 2 * strip : (strip + 3) * ((vs + 31) / 32);
  return round16(round16(2 * vs * strip) + 4 * words);
}

// The plan at view `vs`: four warps a block, each staging as many of its
// view's columns as fit a quarter of a block's shared memory (the whole
// window up to view 163); one warp a block where not even one column fits a
// quarter (views past about 23,000). Returns the strip's columns and sets
// `warps`; 0 where one column passes a whole block (views past 92,975).
int general_plan(int vs, int& warps) {
  for (warps = kGeneralMaxWarps;; warps = 1) {
    const int budget = kMaxSmem / warps;
    int strip = std::min(vs, budget / (2 * vs));
    while (strip > 0 && general_warp_bytes(vs, strip) > budget) --strip;
    if (strip > 0 || warps == 1) return strip;
  }
}

constexpr int kStageBatch = 4;       // window cells a lane loads at once

// Cell (u, v) of the window (world x - tx, y - ty) is cell (i, j) of the
// view: the inverse of rot90(window, k=-k).
template <int K>
__device__ __forceinline__ void view_of_window(int kr, int u, int v, int& i, int& j) {
  i = K == 0 ? u : K == 1 ? v : K == 2 ? kr - u : kr - v;
  j = K == 0 ? v : K == 1 ? kr - u : K == 2 ? kr - v : u;
}

__device__ __forceinline__ void view_of_window(int k, int kr, int u, int v, int& i, int& j) {
  switch (k) {
    case 0: view_of_window<0>(kr, u, v, i, j); break;
    case 1: view_of_window<1>(kr, u, v, i, j); break;
    case 2: view_of_window<2>(kr, u, v, i, j); break;
    default: view_of_window<3>(kr, u, v, i, j); break;
  }
}

// Stage the window rectangle of one strip (columns j0.. of the view): nu x
// nv cells from (u0, v0), consecutive lanes on consecutive y, each cell
// stored at its view cell (i, j) as (j - j0)·vs + i. A lane loads
// kStageBatch cells at once, unconditionally (off-grid cells read the
// env's first cell and are replaced by a wall), so their loads are in
// flight together.
template <int K>
__device__ __forceinline__ void stage_strip(const int32_t* __restrict__ g, uint16_t* cells,
                                            int lane, int w, int h, int vs, int tx, int ty,
                                            int u0, int v0, int nu, int nv, int j0) {
  const int su = 32 / nv, sv = 32 % nv;
  int du = lane / nv, dv = lane % nv;
  for (int base = 0; base < nu * nv; base += 32 * kStageBatch) {
    int cell[kStageBatch], at[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int u = u0 + du, v = v0 + dv;
      const int x = tx + u, y = ty + v;
      const bool in = x >= 0 && x < w && y >= 0 && y < h;
      const int32_t* p = g + (in ? 3 * (x * h + y) : 0);
      const int t = __ldg(p), c = __ldg(p + 1), s = __ldg(p + 2);
      cell[b] = in ? pack(t, c, s) : kWallPacked;
      int i, j;
      view_of_window<K>(vs - 1, u, v, i, j);
      at[b] = du < nu ? (j - j0) * vs + i : -1;
      du += su;
      dv += sv;
      if (dv >= nv) {
        dv -= nv;
        ++du;
      }
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b)
      if (at[b] >= 0) cells[at[b]] = static_cast<uint16_t>(cell[b]);
  }
}

__device__ __forceinline__ bool see_through(int c) {
  const int t = c >> 8, s = c & 15;
  return !(t == kTypeWall || (t == kTypeDoor && s != kStateOpen));
}

// The bits of `mask` reached from `seeds` (bits of mask) moving up through
// its runs of ones: each seed's run from the seed up, by one add whose
// carry runs to the run's end.
__device__ __forceinline__ uint64_t fill_up(uint64_t seeds, uint64_t mask) {
  return (mask & ~(mask + seeds)) | seeds;
}

// vis_column for a view of up to 63 rows (bit i = row i): the forward pass
// (rows 0..vs-2 checked, i+1 lit) as fill_up, the backward pass (rows
// 1..vs-1 checked, i-1 lit) as fill_up on the bit-reversed column.
__device__ __forceinline__ uint64_t vis_column64(uint64_t x, uint64_t see, int vs,
                                                 uint64_t& next) {
  const uint64_t sf = see & ((1ull << (vs - 1)) - 1ull);
  const uint64_t q = fill_up(x & sf, sf);
  const uint64_t col = x | (q << 1);
  const uint64_t sb = see & ~1ull;
  const uint64_t r = __brevll(fill_up(__brevll(col & sb), __brevll(sb)));
  next = q | (q << 1) | r | (r >> 1);
  return col | (r >> 1);
}

__device__ __forceinline__ uint32_t rows_below(int limit, int word) {
  const int lo = 32 * word;
  return limit <= lo ? 0u : limit >= lo + 32 ? ~0u : (1u << (limit - lo)) - 1u;
}

// vis_column64 on a column of nw words (bit i of word w = row 32w + i), by
// one lane: each fill_up an add over the words with a carry between them,
// the backward one from the top word down on bit-reversed words. `see` (the
// see-through rows) becomes the column's visible rows, `lit` (its lit
// rows) the next column's; `q` and `r` hold the two fills.
__device__ __forceinline__ void vis_column_words(uint32_t* see, uint32_t* lit, uint32_t* q,
                                                 uint32_t* r, int nw, int vs) {
  uint32_t carry = 0;
  for (int w = 0; w < nw; ++w) {
    const uint32_t sf = see[w] & rows_below(vs - 1, w);
    const uint32_t t = lit[w] & sf;
    const uint64_t sum = static_cast<uint64_t>(sf) + t + carry;
    q[w] = (sf & ~static_cast<uint32_t>(sum)) | t;
    carry = static_cast<uint32_t>(sum >> 32);
  }
  carry = 0;
  for (int w = nw - 1; w >= 0; --w) {
    const uint32_t sb = see[w] & rows_below(vs, w) & (w == 0 ? ~1u : ~0u);
    const uint32_t col = lit[w] | (q[w] << 1) | (w > 0 ? q[w - 1] >> 31 : 0u);
    const uint32_t rb = __brev(sb), t = __brev(col & sb);
    const uint64_t sum = static_cast<uint64_t>(rb) + t + carry;
    r[w] = __brev((rb & ~static_cast<uint32_t>(sum)) | t);
    carry = static_cast<uint32_t>(sum >> 32);
  }
  for (int w = 0; w < nw; ++w) {
    const uint32_t up = (q[w] << 1) | (w > 0 ? q[w - 1] >> 31 : 0u);
    const uint32_t down = (r[w] >> 1) | (w + 1 < nw ? r[w + 1] << 31 : 0u);
    see[w] = lit[w] | up | down;
    lit[w] = q[w] | up | r[w] | down;
  }
}

// kWide: views past 63, a column of ceil(vs/32) words in shared memory.
template <bool kWide>
__global__ void __launch_bounds__(32 * kGeneralMaxWarps) obs_general_kernel(
    const int32_t* __restrict__ grid, const int32_t* __restrict__ agent_pos,
    const int32_t* __restrict__ agent_dir, const int32_t* __restrict__ agent_color,
    const uint8_t* __restrict__ agent_term, const int32_t* __restrict__ carrying,
    int32_t* __restrict__ out, int views, int n, int w, int h, int vs, int strip,
    int see_through_walls, int packed) {
  extern __shared__ __align__(16) unsigned char gsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int v = blockIdx.x * (blockDim.x / 32) + warp;  // env v / n, agent v % n
  if (v >= views) return;  // the whole warp: nothing below waits on other warps
  const int e = v / n;
  const int half = vs / 2, kr = vs - 1;
  const int nw = (vs + 31) / 32;
  unsigned char* mine = gsm + warp * general_warp_bytes(vs, strip);
  uint16_t* cells = reinterpret_cast<uint16_t*>(mine);  // (strip, vs) column-major
  uint32_t* cols = reinterpret_cast<uint32_t*>(mine + round16(2 * vs * strip));
  uint64_t* cols64 = reinterpret_cast<uint64_t*>(cols);  // !kWide: one word a column
  uint32_t* lit = cols + strip * nw;                      // kWide: lit rows, fills
  uint32_t* fq = lit + nw;
  uint32_t* fr = fq + nw;

  const int ax = agent_pos[2 * v], ay = agent_pos[2 * v + 1], ad = agent_dir[v];
  const int tx = ad == 0 ? ax : ad == 1 ? ax - half : ad == 2 ? ax - kr : ax - half;
  const int ty = ad == 0 ? ay - half : ad == 1 ? ay : ad == 2 ? ay - half : ay - kr;
  const int k = (ad + 1) & 3;
  const int carry = pack(carrying[3 * v], carrying[3 * v + 1], carrying[3 * v + 2]);
  const int32_t* g = grid + static_cast<size_t>(e) * w * h * 3;
  // The overlay's first round, loaded beside the agent's own fields: agent
  // `lane`'s cell, whether it is drawn (live and on the grid), its encoding.
  int x0 = 0, y0 = 0, enc0 = 0;
  bool live0 = false;
  if (n > 1 && lane < n) {
    const int idx = e * n + lane;
    x0 = agent_pos[2 * idx];
    y0 = agent_pos[2 * idx + 1];
    live0 = !agent_term[idx] && x0 >= 0 && x0 < w && y0 >= 0 && y0 < h;
    enc0 = pack(kTypeAgent, agent_color[idx], agent_dir[idx]);
  }
  const int fields = packed ? 1 : 3;
  int32_t* o = out + static_cast<size_t>(v) * vs * vs * fields;
  uint64_t lit64 = 1ull << half;  // !kWide: lane 0's lit rows
  if (kWide)
    for (int i = lane; i < nw; i += 32) lit[i] = i == half / 32 ? 1u << (half % 32) : 0u;

  for (int jhi = vs; jhi > 0; jhi -= strip) {
    const int j0 = max(0, jhi - strip), sw = jhi - j0;  // this strip: columns [j0, jhi)
    // Stage the strip's window rectangle: (nu, nv) cells from (u0, v0).
    const int nu = k & 1 ? sw : vs, nv = k & 1 ? vs : sw;
    const int u0 = k == 1 ? kr + 1 - jhi : k == 3 ? j0 : 0;
    const int v0 = k == 0 ? j0 : k == 2 ? kr + 1 - jhi : 0;
    switch (k) {
      case 0: stage_strip<0>(g, cells, lane, w, h, vs, tx, ty, u0, v0, nu, nv, j0); break;
      case 1: stage_strip<1>(g, cells, lane, w, h, vs, tx, ty, u0, v0, nu, nv, j0); break;
      case 2: stage_strip<2>(g, cells, lane, w, h, vs, tx, ty, u0, v0, nu, nv, j0); break;
      default: stage_strip<3>(g, cells, lane, w, h, vs, tx, ty, u0, v0, nu, nv, j0); break;
    }
    __syncwarp();
    // One agent sees no other: N = 1 skips the overlay.
    for (int a0 = 0; n > 1 && a0 < n; a0 += 32) {
      int x = x0, y = y0, enc = enc0;
      bool live = live0;
      if (a0 > 0) {
        const int idx = e * n + a0 + lane;
        live = a0 + lane < n;
        if (live) {
          x = agent_pos[2 * idx];
          y = agent_pos[2 * idx + 1];
          live = !agent_term[idx] && x >= 0 && x < w && y >= 0 && y < h;
          enc = pack(kTypeAgent, agent_color[idx], agent_dir[idx]);
        }
      }
      int key = -1 - lane;  // the agent's staged cell, if it draws one
      if (live) {
        const int u = x - tx, wv = y - ty;
        if (u >= 0 && u < vs && wv >= 0 && wv < vs) {
          int i, j;
          view_of_window(k, kr, u, wv, i, j);
          if (j >= j0 && j < jhi) key = (j - j0) * vs + i;
        }
      }
      const unsigned same = __match_any_sync(kFull, key);
      if (key >= 0 && (same >> lane) == 1u) cells[key] = static_cast<uint16_t>(enc);
      __syncwarp();
    }
    if (lane == 0 && j0 <= kr && kr < jhi)
      cells[(kr - j0) * vs + half] = static_cast<uint16_t>(carry);
    __syncwarp();

    if (!see_through_walls) {
      // Each column's see-through rows, a lane a column (32 rows a word; a
      // 64-bit word a column for views up to 63).
      const int stride = kWide ? nw : 2;
      for (int jj = lane; jj < sw; jj += 32) {
        const uint16_t* col = cells + jj * vs;
        for (int i0 = 0; i0 < 32 * stride; i0 += 32) {
          uint32_t bits = 0;
          const int rows = min(32, vs - i0);
#pragma unroll 8
          for (int b = 0; b < rows; ++b)
            bits |= static_cast<uint32_t>(see_through(col[i0 + b])) << b;
          cols[jj * stride + i0 / 32] = bits;
        }
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll 4
        for (int jj = sw - 1; jj >= 0; --jj) {
          if (kWide) {
            vis_column_words(cols + jj * nw, lit, fq, fr, nw, vs);
          } else {
            uint64_t next;
            cols64[jj] = vis_column64(lit64, cols64[jj], vs, next);
            lit64 = next;
          }
        }
      }
      __syncwarp();
      // Unseen cells read 0, a lane a column.
      for (int jj = lane; jj < sw; jj += 32) {
        uint16_t* col = cells + jj * vs;
        for (int i0 = 0; i0 < vs; i0 += 32) {
          const uint32_t seen = kWide ? cols[jj * nw + i0 / 32]
                                      : static_cast<uint32_t>(cols64[jj] >> i0);
          const int rows = min(32, vs - i0);
#pragma unroll 8
          for (int b = 0; b < rows; ++b)
            if (!((seen >> b) & 1u)) col[i0 + b] = 0;
        }
      }
      __syncwarp();
    }

    // Write the strip's rows: lane by lane along each row's sw·fields words.
    const int wd = sw * fields, si = 32 / wd, sc = 32 % wd;
    int32_t* os = o + j0 * fields;
    int i = lane / wd, c = lane % wd;
#pragma unroll 4
    while (i < vs) {
      int val;
      if (packed) {
        val = cells[c * vs + i];
      } else {
        const int jj = c / 3, f = c - 3 * jj;
        val = (cells[jj * vs + i] >> (8 - 4 * f)) & (f == 0 ? 255 : 15);
      }
      os[static_cast<size_t>(i) * vs * fields + c] = val;
      i += si;
      c += sc;
      if (c >= wd) {
        c -= wd;
        ++i;
      }
    }
    __syncwarp();  // the next strip restages the cells
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

// Launches obs_general_kernel on `stream` (general_plan's warps and strips)
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a view whose one column passes a block's shared memory.
extern "C" int mgt_obs_general_launch(
    const void* grid, const void* agent_pos, const void* agent_dir,
    const void* agent_color, const void* agent_term, const void* carrying,
    void* out, int e, int n, int w, int h, int vs, int see_through_walls, int packed,
    void* stream) {
  int warps;
  const int strip = general_plan(vs, warps);
  if (strip < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = warps * general_warp_bytes(vs, strip);
  auto kernel = vs <= kNarrowView ? obs_general_kernel<false> : obs_general_kernel<true>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int views = e * n;
  kernel<<<(views + warps - 1) / warps, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(grid), static_cast<const int32_t*>(agent_pos),
      static_cast<const int32_t*>(agent_dir), static_cast<const int32_t*>(agent_color),
      static_cast<const uint8_t*>(agent_term), static_cast<const int32_t*>(carrying),
      static_cast<int32_t*>(out), views, n, w, h, vs, strip, see_through_walls, packed);
  return static_cast<int>(cudaGetLastError());
}
