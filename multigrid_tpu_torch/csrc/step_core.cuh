// One env's action loop: every agent's action applied in the env's order.
//
// The per-env body of csrc/step.cu's kernels, and the same semantics as
// ops/step.py::handle_actions_plain, bit for bit (base.py:396-532 of the
// reference). step_rows reads and writes one env's rows (EnvRows), which
// hold a copy of the input state when it starts: the staged kernel points
// them into shared memory, step_env into the output tensors. Later agents
// see what earlier agents did in the same step (moved positions, written
// cells, termination flags).
//
// The header compiles as CUDA (host and device functions) and as plain C++
// (a host compiler without CUDA, as the CPU test of the logic builds it:
// tests/test_torch_step_kernel.py). Build the C++ form with
// -ffp-contract=off, as nvcc's device code computes the reward without
// contraction.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define MGT_STEP_FN __host__ __device__ __forceinline__
#else
#define MGT_STEP_FN inline
#endif

namespace mgt_step {

constexpr int32_t kTypeEmpty = 1;
constexpr int32_t kTypeWall = 2;
constexpr int32_t kTypeFloor = 3;
constexpr int32_t kTypeDoor = 4;
constexpr int32_t kTypeKey = 5;
constexpr int32_t kTypeBall = 6;
constexpr int32_t kTypeBox = 7;
constexpr int32_t kTypeGoal = 8;
constexpr int32_t kTypeLava = 9;
constexpr int32_t kColorRed = 0;
constexpr int32_t kStateOpen = 0;
constexpr int32_t kStateClosed = 1;
constexpr int32_t kStateLocked = 2;
constexpr int32_t kLeft = 0;
constexpr int32_t kRight = 1;
constexpr int32_t kForward = 2;
constexpr int32_t kPickup = 3;
constexpr int32_t kDrop = 4;
constexpr int32_t kToggle = 5;

// The step's shape and flags.
struct StepConfig {
  int n, w, h;
  int allow_agent_overlap, success_any, failure_any, joint_reward;
  double k;  // the success reward's 0.9 / max_steps, as ops/step.py rounds it
};

// The output state (already a copy of the input) and the step's inputs,
// each with a leading env axis and contiguous.
struct StepArgs {
  int32_t* grid;        // (E, W, H, 3)
  int32_t* box;         // (E, W, H, 3), or null: no box table
  int32_t* pos;         // (E, N, 2)
  int32_t* dir;         // (E, N)
  int32_t* carrying;    // (E, N, 3)
  int32_t* contents;    // (E, N, 3)
  uint8_t* terminated;  // (E, N) bool
  float* rewards;       // (E, N)
  const int32_t* actions;     // (E, N)
  const int32_t* order;       // (E, N)
  const uint8_t* mask;        // (E, N) bool, or null: every agent acts
  const int32_t* step_count;  // (E,), already incremented
  StepConfig cfg;
};

// One env's rows of the same fields, wherever they lie: in the output
// tensors (step_env) or in a copy staged in shared memory (csrc/step.cu's
// staged kernel).
struct EnvRows {
  int32_t* grid;        // (W, H, 3)
  int32_t* box;         // (W, H, 3), or null
  int32_t* pos;         // (N, 2)
  int32_t* dir;         // (N,)
  int32_t* carrying;    // (N, 3)
  int32_t* contents;    // (N, 3)
  uint8_t* term;        // (N,)
  float* rew;           // (N,)
  const int32_t* actions;
  const int32_t* order;
  const uint8_t* mask;  // or null
  int32_t step_count;
};

// torch's int32 arithmetic wraps; C's signed overflow is undefined.
MGT_STEP_FN int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// torch's % is a floor modulo: (-1) % 4 is 3, where C gives -1.
MGT_STEP_FN int32_t floor_mod4(int32_t d) { return (d % 4 + 4) % 4; }

// (float)(1 - step_count * k), each operation rounded once in float64 (the
// product is exact there), as ops/step.py::success_reward computes it.
MGT_STEP_FN float success_reward(int32_t step_count, double k) {
#if defined(__CUDA_ARCH__)
  return __double2float_rn(__dsub_rn(1.0, __dmul_rn(static_cast<double>(step_count), k)));
#else
  return static_cast<float>(1.0 - static_cast<double>(step_count) * k);
#endif
}

MGT_STEP_FN bool can_overlap(int32_t type, int32_t state) {
  return type == kTypeEmpty || type == kTypeGoal || type == kTypeFloor || type == kTypeLava ||
         (type == kTypeDoor && state == kStateOpen);
}

MGT_STEP_FN bool can_pickup(int32_t type) {
  return type == kTypeKey || type == kTypeBall || type == kTypeBox;
}

MGT_STEP_FN void set3(int32_t* dst, int32_t a, int32_t b, int32_t c) {
  dst[0] = a;
  dst[1] = b;
  dst[2] = c;
}

// Applies one env's N sub-steps in its order, writing its rows of the
// output state and its rewards. An order entry outside [0, N) is skipped.
MGT_STEP_FN void step_rows(const StepConfig& a, const EnvRows& r) {
  const int n = a.n, w = a.w, h = a.h;
  int32_t* grid = r.grid;
  int32_t* box = r.box;
  int32_t* pos = r.pos;
  int32_t* dir = r.dir;
  int32_t* carrying = r.carrying;
  int32_t* contents = r.contents;
  uint8_t* term = r.term;
  float* rew = r.rew;
  const int32_t* actions = r.actions;
  const int32_t* order = r.order;
  const uint8_t* mask = r.mask;
  const float value = success_reward(r.step_count, a.k);
  for (int j = 0; j < n; ++j) rew[j] = 0.0f;

  for (int t = 0; t < n; ++t) {
    const int i = order[t];
    if (i < 0 || i >= n) continue;
    const int32_t px = pos[2 * i], py = pos[2 * i + 1], d = dir[i];
    const int32_t c0 = carrying[3 * i], c1 = carrying[3 * i + 1], c2 = carrying[3 * i + 2];
    const int32_t act = actions[i];
    const bool active = (mask == nullptr || mask[i]) && !term[i];

    // Rotations.
    int32_t new_dir = d;
    if (active && act == kLeft) new_dir = floor_mod4(wrap_add(d, -1));
    if (active && act == kRight) new_dir = floor_mod4(wrap_add(d, 1));

    // The forward cell, from the old direction; an unplaced agent (dir -1)
    // has no forward offset. Off the grid it reads as a wall encoded 0.
    const bool dir_ok = d >= 0 && d < 4;
    const int32_t dx = dir_ok ? (d == 0) - (d == 2) : 0;
    const int32_t dy = dir_ok ? (d == 1) - (d == 3) : 0;
    const int32_t fx = wrap_add(px, dx), fy = wrap_add(py, dy);
    const bool in_bounds = fx >= 0 && fx < w && fy >= 0 && fy < h;
    const int64_t at = in_bounds ? (static_cast<int64_t>(fx) * h + fy) * 3 : 0;
    const int32_t e0 = in_bounds ? grid[at] : 0;
    const int32_t e1 = in_bounds ? grid[at + 1] : 0;
    const int32_t e2 = in_bounds ? grid[at + 2] : 0;
    const int32_t ftype = in_bounds ? e0 : kTypeWall;
    // Any agent, terminated, unplaced and the acting one included, on the
    // (unclamped) forward cell.
    bool agent_at_fwd = false;
    for (int j = 0; j < n; ++j) agent_at_fwd |= pos[2 * j] == fx && pos[2 * j + 1] == fy;

    // Forward.
    const bool move_ok = active && act == kForward && can_overlap(ftype, e2) &&
                         (a.allow_agent_overlap || !agent_at_fwd);
    const bool success = move_ok && ftype == kTypeGoal;
    const bool failure = move_ok && ftype == kTypeLava;

    // Pickup, drop, toggle.
    const bool is_carrying = c0 != kTypeEmpty;
    const bool do_pickup = active && act == kPickup && can_pickup(ftype) && !is_carrying;
    const bool do_drop =
        active && act == kDrop && is_carrying && ftype == kTypeEmpty && !agent_at_fwd;
    const bool is_toggle = active && act == kToggle;
    const bool has_matching_key = c0 == kTypeKey && c1 == e1;
    const int32_t new_door_state =
        e2 == kStateLocked ? (has_matching_key ? kStateOpen : kStateLocked)
                           : (e2 == kStateOpen ? kStateClosed : kStateOpen);
    const bool do_toggle_door = is_toggle && ftype == kTypeDoor;
    const bool do_toggle_box = is_toggle && ftype == kTypeBox;

    // The forward cell's box contents: the empty encoding without a table.
    int32_t b0 = kTypeEmpty, b1 = kColorRed, b2 = 0;
    if (box) {
      b0 = in_bounds ? box[at] : 0;
      b1 = in_bounds ? box[at + 1] : 0;
      b2 = in_bounds ? box[at + 2] : 0;
    }

    // Success and failure: rewards are assigned, not added.
    if (success) {
      if (a.success_any) {
        for (int j = 0; j < n; ++j) term[j] = 1;
      } else {
        term[i] = 1;
      }
      if (a.joint_reward) {
        for (int j = 0; j < n; ++j) rew[j] = value;
      } else {
        rew[i] = value;
      }
    }
    if (failure) {
      if (a.failure_any) {
        for (int j = 0; j < n; ++j) term[j] = 1;
      } else {
        term[i] = 1;
      }
    }

    // One cell of the env (in the grid whenever it changes) ...
    if (do_pickup || do_drop || do_toggle_door || do_toggle_box) {
      int32_t* cell = grid + at;
      if (do_pickup) set3(cell, kTypeEmpty, kColorRed, 0);
      if (do_drop) set3(cell, c0, c1, c2);
      if (do_toggle_door) cell[2] = new_door_state;
      if (do_toggle_box) set3(cell, b0, b1, b2);
      if (box) {
        int32_t* cont = box + at;
        if (do_pickup || do_toggle_box) set3(cont, kTypeEmpty, kColorRed, 0);
        if (do_drop) set3(cont, contents[3 * i], contents[3 * i + 1], contents[3 * i + 2]);
      }
    }
    // ... and the acting agent.
    if (move_ok) {
      pos[2 * i] = fx;
      pos[2 * i + 1] = fy;
    }
    dir[i] = new_dir;
    if (do_pickup) {
      set3(carrying + 3 * i, e0, e1, e2);
      set3(contents + 3 * i, b0, b1, b2);
    }
    if (do_drop) {
      set3(carrying + 3 * i, kTypeEmpty, kColorRed, 0);
      set3(contents + 3 * i, kTypeEmpty, kColorRed, 0);
    }
  }
}

// Env `env`'s rows of the output tensors.
MGT_STEP_FN EnvRows env_rows(const StepArgs& a, int64_t env) {
  const int64_t n = a.cfg.n, cells = static_cast<int64_t>(a.cfg.w) * a.cfg.h * 3;
  return EnvRows{a.grid + env * cells,
                 a.box ? a.box + env * cells : nullptr,
                 a.pos + env * n * 2,
                 a.dir + env * n,
                 a.carrying + env * n * 3,
                 a.contents + env * n * 3,
                 a.terminated + env * n,
                 a.rewards + env * n,
                 a.actions + env * n,
                 a.order + env * n,
                 a.mask ? a.mask + env * n : nullptr,
                 a.step_count[env]};
}

// Env `env`'s action loop on the output tensors themselves.
MGT_STEP_FN void step_env(const StepArgs& a, int64_t env) { step_rows(a.cfg, env_rows(a, env)); }

}  // namespace mgt_step
