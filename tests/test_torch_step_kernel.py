"""The step kernel's per-env logic ≡ ``handle_actions_plain``, on the CPU.

``csrc/step_core.cuh`` holds the body that ``csrc/step.cu`` runs for each
env; it compiles as plain C++ too. Here a host C++ compiler (``g++``) builds
it into a shared library called through ctypes, and the library applies the
same actions in the same orders as the plain version: every state field,
the rewards' bits and the termination flags must be equal. The CUDA kernel
itself (the copy of the state around this body) is held to the plain
version on the card by ``tests/test_torch_cuda.py``. The plain version is
held to ``jax.vmap(step_with_order)`` by ``tests/test_torch_step.py``.
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from multigrid_tpu_torch.core.config import EnvConfig
from multigrid_tpu_torch.core.constants import EMPTY_ENCODING, TYPE_GOAL, TYPE_LAVA
from multigrid_tpu_torch.core.state import FIELDS
from multigrid_tpu_torch.envs import CONFIGURATIONS, make
from multigrid_tpu_torch.ops import launch_counts, step_cuda
from multigrid_tpu_torch.ops.step import (
    handle_actions,
    handle_actions_plain,
    success_reward,
    success_reward_k,
)
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.utils.build import CSRC_DIR

from .test_torch_states import random_fields, to_torch
from .test_torch_step import CASES

torch.set_num_threads(1)

E = 32
STEPS = 4

SHIM = r'''
#include <string.h>

#include <vector>

#include "step_core.cuh"
#include "step_plan.cuh"

using namespace mgt_step;

extern "C" void mgt_step_host(
    int32_t* grid, int32_t* box, int32_t* pos, int32_t* dir, int32_t* carrying,
    int32_t* contents, uint8_t* terminated, float* rewards, const int32_t* actions,
    const int32_t* order, const uint8_t* mask, const int32_t* step_count, long long e, int n,
    int w, int h, int allow_agent_overlap, int success_any, int failure_any, int joint_reward,
    double k) {
  const StepArgs a{grid, box, pos, dir, carrying, contents, terminated, rewards, actions, order,
                   mask, step_count, {n, w, h, allow_agent_overlap, success_any, failure_any,
                                      joint_reward, k}};
  for (long long env = 0; env < e; ++env) step_env(a, env);
}

// The staged kernel's walk, one warp after another: each chunk's rows
// copied into the warp's stage (filled with 0xA5 first) by the plan's
// copies, every env stepped there through EnvRows, the stored fields copied
// out; `src` the input of each loaded field, `dst` the output of each stored
// one (step_plan.cuh's field order).
extern "C" void mgt_step_staged_host(const unsigned char** src, unsigned char** dst, long long e,
                                     int n, int w, int h, int allow_agent_overlap,
                                     int success_any, int failure_any, int joint_reward,
                                     double k, int sms) {
  const StepPlan p = plan_step(e, n, w, h, src[kBox] != nullptr, src[kMask] != nullptr, true,
                               sms);
  const StepConfig cfg{n, w, h, allow_agent_overlap, success_any, failure_any, joint_reward, k};
  std::vector<unsigned char> smem(p.smem_bytes, 0xA5);
  const int64_t all = static_cast<int64_t>(p.blocks) * p.warps;
  for (int64_t g = 0; g < all; ++g) {
    for (int64_t i = 0; i < warp_chunks(p, g); ++i) {
      const int64_t q = g + i * all;
      unsigned char* stage = smem.data() + kBarrierBytes +
                             ((g % p.warps) * p.depth + i % p.depth) * p.stage_bytes;
      for (int f = 0; f < kFields; ++f) {
        const ChunkCopy c = chunk_copy(p, q, f);
        if (loaded(f) && c.bulk + c.rem) memcpy(stage + c.shared, src[f] + c.global, c.bulk + c.rem);
      }
      for (int64_t t = 0; t < chunk_count(p, q); ++t) step_rows(cfg, stage_rows(p, stage, t));
      for (int f = 0; f < kFields; ++f) {
        const ChunkCopy c = chunk_copy(p, q, f);
        if (stored(f) && c.bulk + c.rem) memcpy(dst[f] + c.global, stage + c.shared, c.bulk + c.rem);
      }
    }
  }
}

// The plan: out = staged, chunk, warps, depth, blocks, threads, chunks,
// stage bytes, shared memory, then row[kFields], offset[kFields].
extern "C" void mgt_step_plan_host(long long e, int n, int w, int h, int box, int mask,
                                   int aligned, int sms, long long* out) {
  const StepPlan p = plan_step(e, n, w, h, box, mask, aligned, sms);
  const long long head[9] = {p.staged, p.chunk, p.warps, p.depth, p.blocks, p.threads,
                             p.chunks, p.stage_bytes, p.smem_bytes};
  for (int i = 0; i < 9; ++i) out[i] = head[i];
  for (int f = 0; f < kFields; ++f) {
    out[9 + f] = p.row[f];
    out[9 + kFields + f] = p.offset[f];
  }
}

// The staged kernel's walk of that plan: a row a chunk, in each warp's
// order, of the grid's warp, its i-th chunk, the stage's index in its
// block, the chunk, its first env, its envs, then for each field its
// copy's global and shared offsets, bulk and rem bytes, and whether the
// kernel loads and stores it.
extern "C" long long mgt_step_walk_host(long long e, int n, int w, int h, int box, int mask,
                                        int sms, long long* walk) {
  const StepPlan p = plan_step(e, n, w, h, box, mask, true, sms);
  const int64_t all = static_cast<int64_t>(p.blocks) * p.warps;
  long long rows = 0;
  for (int64_t g = 0; p.staged && g < all; ++g) {
    for (int64_t i = 0; i < warp_chunks(p, g); ++i, ++rows) {
      long long* r = walk + rows * (6 + 6 * kFields);
      const int64_t q = g + i * all;
      const long long head[6] = {g, i, (g % p.warps) * p.depth + i % p.depth, q, q * p.chunk,
                                 chunk_count(p, q)};
      for (int k = 0; k < 6; ++k) r[k] = head[k];
      for (int f = 0; f < kFields; ++f) {
        const ChunkCopy c = chunk_copy(p, q, f);
        const long long v[6] = {c.global, c.shared, c.bulk, c.rem, loaded(f), stored(f)};
        for (int k = 0; k < 6; ++k) r[6 + 6 * f + k] = v[k];
      }
    }
  }
  return rows;
}

extern "C" float mgt_success_reward(int32_t step_count, double k) {
  return success_reward(step_count, k);
}
'''

#: Teams of 16 beside the plain version's test cases.
KERNEL_CASES = {
    **CASES,
    'sixteen-agents-blocked': (9, 7, 16, True, dict(allow_agent_overlap=False,
                                                     joint_reward=True)),
    'sixteen-agents-overlap-all': (8, 8, 16, False, dict(success_any=False, failure_any=True)),
}


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    """The per-env body built for the host, as the kernel's header holds it."""
    gxx = shutil.which('g++')
    assert gxx, 'the logic test builds csrc/step_core.cuh with g++'
    tmp = tmp_path_factory.mktemp('step_core')
    (tmp / 'shim.cpp').write_text(SHIM)
    so = tmp / 'libstep_core.so'
    built = subprocess.run([gxx, '-std=c++17', '-O2', '-ffp-contract=off', '-shared', '-fPIC',
                            '-I', str(CSRC_DIR), '-o', str(so),
                            str(tmp / 'shim.cpp')], capture_output=True, text=True)
    assert built.returncode == 0, built.stderr
    out = ctypes.CDLL(str(so))
    out.mgt_step_host.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 7 + [ctypes.c_double]
    out.mgt_step_host.restype = None
    out.mgt_step_staged_host.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 7 + [ctypes.c_double, ctypes.c_int]
    out.mgt_step_staged_host.restype = None
    out.mgt_step_plan_host.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    out.mgt_step_plan_host.restype = None
    out.mgt_step_walk_host.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    out.mgt_step_walk_host.restype = ctypes.c_longlong
    out.mgt_success_reward.argtypes = [ctypes.c_int32, ctypes.c_double]
    out.mgt_success_reward.restype = ctypes.c_float
    return out


def kernel_logic(lib, cfg, state, actions, order, mask):
    """``handle_actions`` through the kernel's per-env body: the outputs
    start as copies of the state, as the kernel's do."""
    names = ('grid', 'box_contents', 'agent_pos', 'agent_dir', 'agent_carrying',
             'agent_carrying_contents', 'agent_terminated')
    outs = {k: getattr(state, k).clone().contiguous() for k in names}
    has_boxes = outs['box_contents'].numel() > 0
    e, n = state.agent_dir.shape
    rewards = torch.full((e, n), float('nan'), dtype=torch.float32)
    actions = actions.to(torch.int32).contiguous()
    order = order.to(torch.int32).contiguous()
    mask = None if mask is None else mask.to(torch.bool).contiguous()
    step_count = state.step_count.contiguous()
    lib.mgt_step_host(
        *(outs[k].data_ptr() if k != 'box_contents' or has_boxes else None for k in names),
        rewards.data_ptr(), actions.data_ptr(), order.data_ptr(),
        None if mask is None else mask.data_ptr(), step_count.data_ptr(), e, n,
        cfg.width, cfg.height, int(cfg.allow_agent_overlap), int(cfg.success_any),
        int(cfg.failure_any), int(cfg.joint_reward), success_reward_k(cfg.max_steps))
    return state.replace(**outs), rewards


#: The staged kernel's fields (csrc/step_plan.cuh's order) and the state
#: field or step input each holds.
STAGED = ('grid', 'box_contents', 'agent_pos', 'agent_dir', 'agent_carrying',
          'agent_carrying_contents', 'agent_terminated', 'actions', 'order', 'mask',
          'step_count', 'rewards')


def staged_logic(lib, cfg, state, actions, order, mask, sms):
    """``handle_actions`` through the staged kernel's walk on the host
    (``mgt_step_staged_host``): the inputs read only, the outputs fresh
    tensors filled with junk, every env stepped in its warp's stage."""
    e, n = state.agent_dir.shape
    has_boxes = state.box_contents.numel() > 0
    ins = {k: getattr(state, k).contiguous() for k in STAGED[:7]}
    ins.update(actions=actions.to(torch.int32).contiguous(),
               order=order.to(torch.int32).contiguous(),
               mask=None if mask is None else mask.to(torch.bool).contiguous(),
               step_count=state.step_count.contiguous())
    outs = {k: torch.full_like(ins[k], 0x5A) for k in STAGED[:7]}
    outs['rewards'] = torch.full((e, n), float('nan'), dtype=torch.float32)
    if not has_boxes:
        ins['box_contents'] = outs['box_contents'] = None
    src = (ctypes.c_void_p * len(STAGED))(
        *(None if ins.get(k) is None else ins[k].data_ptr() for k in STAGED))
    dst = (ctypes.c_void_p * len(STAGED))(
        *(None if outs.get(k) is None else outs[k].data_ptr() for k in STAGED))
    lib.mgt_step_staged_host(src, dst, e, n, cfg.width, cfg.height, int(cfg.allow_agent_overlap),
                             int(cfg.success_any), int(cfg.failure_any), int(cfg.joint_reward),
                             success_reward_k(cfg.max_steps), sms)
    if not has_boxes:
        outs['box_contents'] = state.box_contents
    rewards = outs.pop('rewards')
    return state.replace(**outs), rewards


def assert_same(got, want, what):
    (gs, gr), (ws, wr) = got, want
    for k in FIELDS:
        a, b = getattr(gs, k), getattr(ws, k)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        assert torch.equal(a, b), (what, k)
    assert torch.equal(gr.view(torch.int32), wr.view(torch.int32)), (what, 'rewards')


def unplace(state, rng, share=0.2):
    """Some agents with no direction (dir -1), half of those also off the
    grid at (-1, -1) as the reset leaves agents it has not placed yet: their
    forward cell is their own."""
    e, n = state.agent_dir.shape
    draw = rng.random((e, n))
    no_dir = torch.as_tensor(draw < share)
    off = torch.as_tensor(draw < share / 2)
    return state.replace(
        agent_dir=torch.where(no_dir, -1, state.agent_dir),
        agent_pos=torch.where(off[..., None], -1, state.agent_pos))


def chain(lib, cfg, state, rng, steps, masked=True, wild=True, sms=None):
    """``steps`` chained steps, kernel logic against the plain version from
    the same state each step; with ``sms``, through the staged kernel's
    walk for that many SMs."""
    e, n = state.agent_dir.shape
    for t in range(steps):
        state = state.replace(step_count=state.step_count + 1)
        actions = rng.integers(0, 7, (e, n))
        if wild:  # values outside 0-6 change nothing
            actions = np.where(rng.random((e, n)) < 0.05, rng.choice([-3, 7, 9, 100], (e, n)),
                               actions)
        actions = torch.as_tensor(actions.astype(np.int32))
        order = torch.as_tensor(np.argsort(rng.random((e, n)), -1))
        mask = torch.as_tensor(rng.random((e, n)) < 0.9) if masked else None
        want = handle_actions_plain(cfg, state, actions, order, mask)
        got = kernel_logic(lib, cfg, state, actions, order, mask) if sms is None else \
            staged_logic(lib, cfg, state, actions, order, mask, sms)
        assert_same(got, want, t)
        state = want[0]


@pytest.mark.parametrize('case', list(KERNEL_CASES))
def test_kernel_logic_matches_plain(lib, case):
    w, h, n, has_boxes, over = KERNEL_CASES[case]
    cfg = EnvConfig(width=w, height=h, num_agents=n, max_steps=20, **over)
    rng = np.random.default_rng(list(KERNEL_CASES).index(case) + 100)
    state = to_torch(random_fields(int(rng.integers(1 << 30)), E, w, h, n,
                                   has_boxes=has_boxes, max_steps=20))
    chain(lib, cfg, unplace(state, rng), rng, STEPS)
    chain(lib, cfg, state, rng, 2, masked=False, wild=False)


@pytest.mark.parametrize('case', list(KERNEL_CASES))
def test_staged_logic_matches_plain(lib, case):
    """The staged kernel's walk (csrc/step_plan.cuh's plan, chunks, warps'
    stages and stage layout; each env stepped on its staged rows through EnvRows)
    ≡ the plain version, at an env count no chunk divides and on 1 and 3
    SMs, so that warps walk several chunks through their stages."""
    w, h, n, has_boxes, over = KERNEL_CASES[case]
    cfg = EnvConfig(width=w, height=h, num_agents=n, max_steps=20, **over)
    rng = np.random.default_rng(list(KERNEL_CASES).index(case) + 200)
    e = 77
    state = to_torch(random_fields(int(rng.integers(1 << 30)), e, w, h, n,
                                   has_boxes=has_boxes, max_steps=20))
    chain(lib, cfg, unplace(state, rng), rng, 3, sms=1)
    chain(lib, cfg, state, rng, 2, masked=False, wild=False, sms=3)


#: Shapes of the plan's test (E, W, H, N, box table): the flagship, BUP,
#: 16,384 flagship envs, odd env counts, a 250x250 grid, 64x64 with a box
#: table and without (one least stage fits a block, two do not), 64
#: agents, one agent, single envs.
PLAN_SHAPES = {
    'flagship': (4096, 16, 16, 4, False),
    'bup': (4096, 11, 6, 2, True),
    'flagship-16384': (16384, 16, 16, 4, False),
    'odd-bup': (4097, 11, 6, 2, True),
    'odd-flagship': (16383, 16, 16, 4, False),
    '250x250': (8, 250, 250, 4, True),
    '64x64-boxes': (64, 64, 64, 4, True),
    '64x64': (64, 64, 64, 4, False),
    '32x32-64-agents': (256, 32, 32, 64, True),
    'one-agent': (1000, 7, 7, 1, True),
    'one-env': (1, 5, 5, 3, False),
}

#: csrc/step_plan.cuh's limits: a block's shared memory (one block an SM),
#: the mbarriers before the stages.
BLOCK_SMEM, BARRIER_BYTES = 232448, 256


def plan_of(lib, e, w, h, n, boxes, mask, sms=132, aligned=True):
    out = (ctypes.c_longlong * (9 + 2 * len(STAGED)))()
    lib.mgt_step_plan_host(e, n, w, h, int(boxes), int(mask), int(aligned), sms, out)
    keys = ('staged', 'chunk', 'warps', 'depth', 'blocks', 'threads', 'chunks', 'stage_bytes',
            'smem_bytes')
    plan = dict(zip(keys, out[:9]))
    plan['row'], plan['offset'] = list(out[9:9 + len(STAGED)]), list(out[9 + len(STAGED):])
    return plan


@pytest.mark.parametrize('mask', [False, True])
@pytest.mark.parametrize('shape', list(PLAN_SHAPES))
def test_step_plan(lib, shape, mask):
    """The launcher's plan on 132 SMs: the global kernel exactly where two
    stages of the least chunk (whose rows are a multiple of 16 bytes in
    every field) do not fit a block, or a tensor is not 16-byte aligned;
    else every env in exactly one chunk, every bulk copy's size and offsets
    multiples of 16 inside its field's room in the stage, tails under 16
    bytes only in the last chunk, at most 227 KB of shared memory a block
    and a block an SM, every warp's stages its own."""
    e, w, h, n, boxes = PLAN_SHAPES[shape]
    # Each field's bytes for one env, in STAGED's order.
    row = [w * h * 12, w * h * 12 if boxes else 0, n * 8, n * 4, n * 12, n * 12, n,
           n * 4, n * 4, n if mask else 0, 4, n * 4]
    unit = max(16 // math.gcd(r, 16) for r in row)
    least = sum(-(-unit * r // 16) * 16 for r in row)
    plan = plan_of(lib, e, w, h, n, boxes, mask)
    assert plan['row'] == row
    assert plan['staged'] == (2 * least + BARRIER_BYTES <= BLOCK_SMEM), plan
    assert not plan_of(lib, e, w, h, n, boxes, mask, aligned=False)['staged']
    if not plan['staged']:
        assert plan['blocks'] * plan['chunk'] >= e and plan['chunk'] >= 1
        return
    chunk, warps, depth, stage = plan['chunk'], plan['warps'], plan['depth'], plan['stage_bytes']
    assert chunk % unit == 0 and chunk <= 32 and plan['chunks'] == -(-e // chunk)
    assert plan['threads'] == 32 * warps and 1 <= warps <= 16 and plan['blocks'] <= 132
    assert plan['smem_bytes'] == BARRIER_BYTES + warps * depth * stage <= BLOCK_SMEM
    assert depth in (1, 2) and warps * depth <= BARRIER_BYTES // 8 and stage % 16 == 0
    assert 2 * stage + BARRIER_BYTES <= BLOCK_SMEM
    for f, r in enumerate(row):  # each field's room in a stage
        room = -(-chunk * r // 16) * 16
        assert plan['offset'][f] % 16 == 0
        assert plan['offset'][f] + room <= (plan['offset'][f + 1] if f + 1 < len(row) else stage)
    walk = np.zeros((plan['chunks'], 6 + 6 * len(STAGED)), np.int64)
    rows = lib.mgt_step_walk_host(e, n, w, h, int(boxes), int(mask), 132,
                                  walk.ctypes.data)
    assert rows == plan['chunks']
    g, j, st, q, first, count = walk[:, :6].T
    copies = walk[:, 6:].reshape(rows, len(STAGED), 6)
    covered = np.zeros(e, np.int64)
    for i in range(rows):
        covered[first[i]:first[i] + count[i]] += 1
    assert (covered == 1).all()
    assert (first == q * chunk).all() and (q == g + j * plan['blocks'] * warps).all()
    assert (st == g % warps * depth + j % depth).all() and (st < warps * depth).all()
    # Every block has a chunk for its first warp.
    assert set(range(plan['blocks'])) <= set((g // warps).tolist())
    last = q == plan['chunks'] - 1
    assert (count[~last] == chunk).all() and 1 <= count[last][0] <= chunk
    assert copies[..., 4].astype(bool).tolist() == [[k != 'rewards' for k in STAGED]] * rows
    assert copies[..., 5].astype(bool).tolist() == [
        [k in STAGED[:7] or k == 'rewards' for k in STAGED]] * rows
    glob, shared, bulk, rem = (copies[..., i] for i in range(4))
    want_bytes = count[:, None] * np.array(row)[None]
    assert (bulk + rem == want_bytes).all()
    assert (glob == first[:, None] * np.array(row)[None]).all()
    assert (glob % 16 == 0).all() and (bulk % 16 == 0).all() and (rem < 16).all()
    assert (rem[~last] == 0).all()
    # Where the copies land: the stage's base past the barriers, then the field.
    assert ((BARRIER_BYTES + st[:, None] * stage + shared) % 16 == 0).all()
    assert (shared == np.array(plan['offset'])[None]).all()


@pytest.mark.parametrize('success_any', [False, True])
@pytest.mark.parametrize('failure_any', [False, True])
@pytest.mark.parametrize('joint_reward', [False, True])
def test_kernel_logic_on_goals_and_lava(lib, success_any, failure_any, joint_reward):
    """Agents facing goals and lava, most of them moving forward: the
    success and failure paths under each flag, later agents inactive once
    an earlier one ended the episode."""
    w, h, n = 7, 6, 4
    cfg = EnvConfig(width=w, height=h, num_agents=n, max_steps=20, success_any=success_any,
                    failure_any=failure_any, joint_reward=joint_reward)
    rng = np.random.default_rng(int(success_any) + 2 * failure_any + 4 * joint_reward)
    fields = random_fields(int(rng.integers(1 << 30)), E, w, h, n, max_steps=20)
    env = np.arange(E)[:, None]
    pos, d = fields['agent_pos'], fields['agent_dir']
    vec = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]])
    fwd = pos + vec[d]
    inside = (fwd[..., 0] >= 0) & (fwd[..., 0] < w) & (fwd[..., 1] >= 0) & (fwd[..., 1] < h)
    fx, fy = np.clip(fwd[..., 0], 0, w - 1), np.clip(fwd[..., 1], 0, h - 1)
    kind = np.where(rng.random((E, n)) < 0.5, TYPE_GOAL, TYPE_LAVA)
    cell = np.where(inside, kind, fields['grid'][env, fx, fy, 0])
    fields['grid'][env, fx, fy] = np.stack([cell, np.zeros_like(cell), np.zeros_like(cell)], -1)
    fields['grid'][env, pos[..., 0], pos[..., 1]] = EMPTY_ENCODING
    state = to_torch(fields)
    state = state.replace(step_count=state.step_count + 1)
    actions = torch.as_tensor(np.where(rng.random((E, n)) < 0.8, 2, 3).astype(np.int32))
    order = torch.as_tensor(np.argsort(rng.random((E, n)), -1))
    want = handle_actions_plain(cfg, state, actions, order)
    assert_same(kernel_logic(lib, cfg, state, actions, order, None), want, 'goals')
    assert (want[1] > 0).any() and (want[0].agent_terminated & ~state.agent_terminated).any()


@pytest.mark.parametrize('env_id', list(CONFIGURATIONS))
def test_kernel_logic_matches_plain_on_the_zoo(lib, env_id):
    """One state per configuration of the zoo after a few random steps."""
    venv = VectorEnv(make(env_id, agents=2, device='cpu'), 8, reset_pool=False)
    _, state = venv.reset(seed=3)
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        _, state, *_ = venv.step(state, torch.randint(0, 7, (8, 2), generator=g))
    state = state.replace(pool=None)
    cfg = venv.env.cfg
    assert tuple(state.grid.shape) == (8, cfg.width, cfg.height, 3)
    chain(lib, cfg, state, np.random.default_rng(len(env_id)), 3)


def test_kernel_logic_at_the_borders(lib):
    """Every agent on the border, facing out or along it, at grids with no
    outer wall: forward cells off the grid read as walls."""
    w, h, n = 6, 5, 4
    cfg = EnvConfig(width=w, height=h, num_agents=n, max_steps=50)
    rng = np.random.default_rng(7)
    fields = random_fields(7, E, w, h, n, max_steps=50)
    side = rng.integers(0, 4, (E, n))
    x = np.where(side == 0, 0, np.where(side == 1, w - 1, rng.integers(0, w, (E, n))))
    y = np.where(side == 2, 0, np.where(side == 3, h - 1, rng.integers(0, h, (E, n))))
    fields['agent_pos'] = np.stack([x, y], -1).astype(np.int32)
    state = to_torch(fields)
    chain(lib, cfg, state, rng, STEPS)


def test_success_reward_bits(lib):
    """The reward computed in float64 without contraction, as the plain
    version rounds it, for many step counts and horizons."""
    steps = torch.arange(0, 5000, dtype=torch.int32)
    for max_steps in (1, 7, 20, 100, 333, 1000, 10240):
        want = success_reward(steps, max_steps)
        k = success_reward_k(max_steps)
        got = torch.tensor([lib.mgt_success_reward(int(s), k) for s in steps],
                           dtype=torch.float32)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), max_steps


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors ``handle_actions`` is the plain version and launches
    nothing; the kernel's wrapper refuses them."""
    w, h, n = 7, 6, 3
    cfg = EnvConfig(width=w, height=h, num_agents=n, max_steps=20)
    state = to_torch(random_fields(11, E, w, h, n, max_steps=20))
    rng = np.random.default_rng(11)
    actions = torch.as_tensor(rng.integers(0, 7, (E, n)))
    order = torch.as_tensor(np.argsort(rng.random((E, n)), -1))
    before = launch_counts()['step']
    with pytest.raises(ValueError, match='CUDA'):
        step_cuda.handle_actions(cfg, state, actions, order, None, success_reward_k(20))

    def refuse(*args):
        raise AssertionError('the kernel wrapper was called for CPU tensors')
    monkeypatch.setattr(step_cuda, 'handle_actions', refuse)
    assert_same(handle_actions(cfg, state, actions, order),
                handle_actions_plain(cfg, state, actions, order), 'cpu')
    assert launch_counts()['step'] == before
