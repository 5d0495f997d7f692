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
// once and write its observations (N*vs*vs int32 packed, or x3 as images).
// The design answers that by touching device memory once each way: one
// block per env stages the env's grid, packed t<<8|c<<4|s into one int32 a
// cell, in shared memory; the agent overlay, crop, rotation and visibility
// all run out of shared memory; and every output cell is written once.
// The TPU kernel's roll chains, permutation matmuls and hi/lo byte split
// have no counterpart here: a thread reads its rotated source cell directly.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (multigrid_tpu_torch/utils/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTypeWall = 2;
constexpr int kTypeDoor = 4;
constexpr int kTypeAgent = 10;
constexpr int kStateOpen = 0;
constexpr int kColorGrey = 5;
constexpr int kWallPacked = (kTypeWall << 8) | (kColorGrey << 4);
constexpr int kThreads = 128;

__device__ __forceinline__ int pack(int t, int c, int s) {
  return (t << 8) | (c << 4) | s;
}

__global__ void __launch_bounds__(kThreads) obs_kernel(
    const int32_t* __restrict__ grid,         // (E, W, H, 3)
    const int32_t* __restrict__ agent_pos,    // (E, N, 2)
    const int32_t* __restrict__ agent_dir,    // (E, N)
    const int32_t* __restrict__ agent_color,  // (E, N)
    const uint8_t* __restrict__ agent_term,   // (E, N) bool
    const int32_t* __restrict__ carrying,     // (E, N, 3)
    int32_t* __restrict__ out,  // (E, N, vs*vs) packed or (E, N, vs*vs, 3)
    int n, int w, int h, int vs, int see_through_walls, int packed) {
  extern __shared__ int32_t smem[];
  const int wh = w * h;
  const int v2 = vs * vs;
  int32_t* cells = smem;                                   // (W*H) packed
  int32_t* view = cells + wh;                              // (N, vs*vs) packed
  uint32_t* vis = reinterpret_cast<uint32_t*>(view + n * v2);  // (N, vs) bits

  const int e = blockIdx.x;
  const int32_t* g = grid + static_cast<size_t>(e) * wh * 3;
  for (int c = threadIdx.x; c < wh; c += blockDim.x) {
    cells[c] = pack(g[3 * c], g[3 * c + 1], g[3 * c + 2]);
  }
  __syncthreads();

  // Agents in index order, so a later agent wins a shared cell; terminated
  // agents are not drawn. One agent sees no other, so N = 1 skips this.
  if (n > 1 && threadIdx.x == 0) {
    for (int a = 0; a < n; ++a) {
      const int idx = e * n + a;
      const int x = agent_pos[2 * idx], y = agent_pos[2 * idx + 1];
      if (!agent_term[idx] && x >= 0 && x < w && y >= 0 && y < h) {
        cells[x * h + y] = pack(kTypeAgent, agent_color[idx], agent_dir[idx]);
      }
    }
  }
  __syncthreads();

  // Crop, rotate and carried object: one thread per (agent, view cell).
  const int half = vs / 2;
  const int r = vs - 1;
  const int own = half * vs + r;
  for (int q = threadIdx.x; q < n * v2; q += blockDim.x) {
    const int a = q / v2;
    const int cell = q - a * v2;
    const int idx = e * n + a;
    int val;
    if (cell == own) {
      const int32_t* cy = carrying + 3 * idx;
      val = pack(cy[0], cy[1], cy[2]);
    } else {
      const int i = cell / vs;
      const int j = cell - i * vs;
      const int d = agent_dir[idx];
      const int x = agent_pos[2 * idx], y = agent_pos[2 * idx + 1];
      int tx, ty;  // top-left of the view (get_view_exts)
      if (d == 0) {
        tx = x;
        ty = y - half;
      } else if (d == 1) {
        tx = x - half;
        ty = y;
      } else if (d == 2) {
        tx = x - vs + 1;
        ty = y - half;
      } else {
        tx = x - half;
        ty = y - vs + 1;
      }
      // out = rot90(win, k=-k), k = (dir + 1) mod 4: the source window cell.
      int u, v;
      switch ((d + 1) & 3) {
        case 0: u = i;     v = j;     break;
        case 1: u = r - j; v = i;     break;
        case 2: u = r - i; v = r - j; break;
        default: u = j;    v = r - i; break;
      }
      const int wx = tx + u, wy = ty + v;
      val = (wx >= 0 && wx < w && wy >= 0 && wy < h) ? cells[wx * h + wy]
                                                     : kWallPacked;
    }
    view[q] = val;
  }
  __syncthreads();

  // Flood fill, one thread per agent: vis[a*vs + j] holds column j's cells
  // as bits i. Columns run from the agent's (vs-1) to 0; in each, a forward
  // pass (i ascending) and a backward pass (i descending) spread visibility
  // through see-through cells within the column and into column j-1.
  if (!see_through_walls) {
    for (int a = threadIdx.x; a < n; a += blockDim.x) {
      const int32_t* va = view + a * v2;
      uint32_t* m = vis + a * vs;
      for (int j = 0; j < vs; ++j) m[j] = 0u;
      m[r] = 1u << half;
      for (int j = r; j >= 0; --j) {
        uint32_t see = 0u;
        for (int i = 0; i < vs; ++i) {
          const int c = va[i * vs + j];
          const int t = c >> 8, s = c & 15;
          const bool opaque =
              t == kTypeWall || (t == kTypeDoor && s != kStateOpen);
          if (!opaque) see |= 1u << i;
        }
        uint32_t col = m[j];
        uint32_t next = 0u;
        for (int i = 0; i < r; ++i) {
          if ((col >> i) & (see >> i) & 1u) {
            col |= 1u << (i + 1);
            next |= 3u << i;  // (i, j-1) and (i+1, j-1)
          }
        }
        for (int i = r; i >= 1; --i) {
          if ((col >> i) & (see >> i) & 1u) {
            col |= 1u << (i - 1);
            next |= 3u << (i - 1);  // (i-1, j-1) and (i, j-1)
          }
        }
        m[j] = col;
        if (j > 0) m[j - 1] |= next;
      }
    }
    __syncthreads();
  }

  const size_t per_env = static_cast<size_t>(n) * v2;
  int32_t* o = out + static_cast<size_t>(e) * per_env * (packed ? 1 : 3);
  for (int q = threadIdx.x; q < n * v2; q += blockDim.x) {
    int val = view[q];
    if (!see_through_walls) {
      const int a = q / v2;
      const int cell = q - a * v2;
      const int i = cell / vs;
      const int j = cell - i * vs;
      if (!((vis[a * vs + j] >> i) & 1u)) val = 0;
    }
    if (packed) {
      o[q] = val;
    } else {
      o[3 * q] = val >> 8;
      o[3 * q + 1] = (val >> 4) & 15;
      o[3 * q + 2] = val & 15;
    }
  }
}

}  // namespace

extern "C" size_t mgt_obs_smem_bytes(int n, int w, int h, int vs) {
  return sizeof(int32_t) * (static_cast<size_t>(w) * h
                            + static_cast<size_t>(n) * vs * vs
                            + static_cast<size_t>(n) * vs);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mgt_obs_launch(
    const void* grid, const void* agent_pos, const void* agent_dir,
    const void* agent_color, const void* agent_term, const void* carrying,
    void* out, int e, int n, int w, int h, int vs, int see_through_walls,
    int packed, void* stream) {
  const size_t smem = mgt_obs_smem_bytes(n, w, h, vs);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        obs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  obs_kernel<<<e, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(grid), static_cast<const int32_t*>(agent_pos),
      static_cast<const int32_t*>(agent_dir),
      static_cast<const int32_t*>(agent_color),
      static_cast<const uint8_t*>(agent_term),
      static_cast<const int32_t*>(carrying), static_cast<int32_t*>(out), n, w,
      h, vs, see_through_walls, packed);
  return static_cast<int>(cudaGetLastError());
}
