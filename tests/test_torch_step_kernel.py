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
#include "step_core.cuh"

extern "C" void mgt_step_host(
    int32_t* grid, int32_t* box, int32_t* pos, int32_t* dir, int32_t* carrying,
    int32_t* contents, uint8_t* terminated, float* rewards, const int32_t* actions,
    const int32_t* order, const uint8_t* mask, const int32_t* step_count, long long e, int n,
    int w, int h, int allow_agent_overlap, int success_any, int failure_any, int joint_reward,
    double k) {
  const mgt_step::StepArgs a{grid, box, pos, dir, carrying, contents, terminated, rewards,
                             actions, order, mask, step_count, n, w, h, allow_agent_overlap,
                             success_any, failure_any, joint_reward, k};
  for (long long env = 0; env < e; ++env) mgt_step::step_env(a, env);
}

extern "C" float mgt_success_reward(int32_t step_count, double k) {
  return mgt_step::success_reward(step_count, k);
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
    subprocess.run([gxx, '-std=c++17', '-O2', '-ffp-contract=off', '-shared', '-fPIC',
                    '-I', str(CSRC_DIR), '-o', str(so), str(tmp / 'shim.cpp')],
                   check=True, capture_output=True, text=True)
    out = ctypes.CDLL(str(so))
    out.mgt_step_host.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 7 + [ctypes.c_double]
    out.mgt_step_host.restype = None
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


def chain(lib, cfg, state, rng, steps, masked=True, wild=True):
    """``steps`` chained steps, kernel logic against the plain version from
    the same state each step."""
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
        got = kernel_logic(lib, cfg, state, actions, order, mask)
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
