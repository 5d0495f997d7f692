"""The port's environments: golden reference traces and speed-mode resets.

Every recorded ``tests/golden/*.npz`` trace (the Empty family and the
procedural zoo: BlockedUnlockPickup, RedBlueDoors, LockedHallway,
Playground) replays
bit-exactly through the port's ``ParityRunner`` on the CPU (images,
directions, terminations, truncations; rewards to float32 rounding as in
tests/test_parity_empty.py). Invariant tests cover the speed-mode reset
here; tests/test_torch_streams.py holds it bit-equal to the JAX package's
from the same key.

"""

import numpy as np
import pytest
import torch

from multigrid_tpu_torch.core.constants import TYPE_EMPTY, TYPE_GOAL, TYPE_WALL
from multigrid_tpu_torch.envs import CONFIGURATIONS, make
from multigrid_tpu_torch.envs.parity import ParityRunner
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.utils import prng

from .ref_loader import GoldenReference

torch.set_num_threads(1)

# (env_id, seed, agents, steps, kwargs): the cases of
# tests/test_parity_empty.py and tests/test_parity_envs.py, one per golden
# trace.
GOLDEN = (
    [('MultiGrid-Empty-8x8-v0', s, n, 120, {})
     for s in (0, 7, 123) for n in (1, 2, 3)]
    + [('MultiGrid-Empty-Random-5x5-v0', s, n, 120, {})
       for s in (1, 42) for n in (2, 4)]
    + [('MultiGrid-Empty-16x16-v0', 3, 2, 150, {}),
       ('MultiGrid-Empty-Random-6x6-v0', 5, 3, 120,
        {'allow_agent_overlap': False}),
       ('MultiGrid-Empty-Random-6x6-v0', 9, 2, 150,
        {'joint_reward': True, 'success_termination_mode': 'all'})]
    + [('MultiGrid-BlockedUnlockPickup-v0', s, n, 150, {})
       for s in (0, 7, 123, 2024) for n in (1, 2)]
    + [('MultiGrid-RedBlueDoors-6x6-v0', s, n, 150, {})
       for s in (0, 7, 99) for n in (1, 3)]
    + [('MultiGrid-RedBlueDoors-8x8-v0', s, 2, 150, {}) for s in (0, 5)]
    + [('MultiGrid-LockedHallway-2Rooms-v0', s, 2, 150, {}) for s in (0, 11, 77)]
    + [('MultiGrid-LockedHallway-4Rooms-v0', s, 2, 120, {}) for s in (0, 3)]
    + [('MultiGrid-LockedHallway-6Rooms-v0', 0, 4, 100, {})]
    + [('MultiGrid-Playground-v0', s, n, 100, {})
       for s in (0, 13, 55) for n in (1, 2)]
    + [('MultiGrid-Playground-v0', 21, 6, 100, {}),
       ('MultiGrid-Playground-v0', 3, 10, 60, {})]
)


def _assert_obs_equal(ref_obs, our_obs, n, t):
    for i in range(n):
        np.testing.assert_array_equal(
            our_obs[i]['image'], np.asarray(ref_obs[i]['image']),
            err_msg=f't={t} agent={i}')
        assert our_obs[i]['direction'] == int(ref_obs[i]['direction']), (t, i)


@pytest.mark.parametrize(
    'env_id,seed,n,steps,kwargs', GOLDEN,
    ids=[f'{c[0][10:]}-s{c[1]}-n{c[2]}' for c in GOLDEN])
@torch.inference_mode()
def test_golden_replay(env_id, seed, n, steps, kwargs):
    ref = GoldenReference(env_id, seed, n, **kwargs)
    runner = ParityRunner(make(env_id, agents=n, device='cpu', **kwargs), seed)
    _assert_obs_equal(ref.reset_obs, runner.reset(), n, 'reset')
    action_rng = np.random.default_rng(seed + 1000)
    for t in range(steps):
        actions = {i: int(action_rng.integers(0, 7)) for i in range(n)}
        ref_obs, ref_rew, ref_term, ref_trunc = ref.step(actions)
        our_obs, our_rew, our_term, our_trunc, _ = runner.step(actions)
        _assert_obs_equal(ref_obs, our_obs, n, t)
        for i in range(n):
            assert our_rew[i] == pytest.approx(ref_rew[i], abs=1e-5), (t, i)
            assert our_term[i] == bool(ref_term[i]), (t, i)
            assert our_trunc[i] == bool(ref_trunc[i]), (t, i)
        if all(ref_term.values()) or all(ref_trunc.values()):
            break


def test_registry_holds_the_empty_family():
    """The Empty family, within the registry of all 13 configurations of
    the JAX package."""
    from multigrid_tpu.envs import CONFIGURATIONS as JAX_CONFIGURATIONS
    empty = [k for k in CONFIGURATIONS if k.startswith('MultiGrid-Empty-')]
    assert len(empty) == 6
    assert len(CONFIGURATIONS) == 13
    assert set(CONFIGURATIONS) == set(JAX_CONFIGURATIONS)
    for k, (cls, kwargs) in CONFIGURATIONS.items():
        jcls, jkwargs = JAX_CONFIGURATIONS[k]
        assert cls.__name__ == jcls.__name__ and kwargs == jkwargs, k


@pytest.mark.parametrize('env_id,agents', [
    ('MultiGrid-Empty-Random-5x5-v0', 4),
    ('MultiGrid-Empty-Random-6x6-v0', 3),
])
def test_random_reset_invariants(env_id, agents):
    """Speed-mode random starts: agents on distinct free cells inside the
    walls, directions in 0..3, layouts untouched, reproducible per seed."""
    env = make(env_id, agents=agents, device='cpu')
    keys = prng.split(prng.key(0), 512)
    state = env.reset_core(keys)
    pos = state.agent_pos.numpy()
    grid = state.grid.numpy()
    e = np.arange(512)[:, None]
    assert (grid[e, pos[..., 0], pos[..., 1], 0] == TYPE_EMPTY).all()
    for a in range(agents):
        for b in range(a):
            assert (pos[:, a] != pos[:, b]).any(-1).all()
    assert ((state.agent_dir >= 0) & (state.agent_dir < 4)).all()
    np.testing.assert_array_equal(grid, np.broadcast_to(env._layout, grid.shape))
    # Every free cell is drawn: uniform over the free interior.
    free = (env._layout[..., 0] == TYPE_EMPTY).sum()
    assert len({tuple(p) for p in pos[:, 0]}) == free
    again = env.reset_core(prng.split(prng.key(0), 512))
    assert torch.equal(again.agent_pos, state.agent_pos)
    assert torch.equal(again.agent_dir, state.agent_dir)


def test_layout_and_fixed_start():
    env = make('MultiGrid-Empty-16x16-v0', agents=4, device='cpu')
    obs, state = env.reset()
    grid = state.grid[0].numpy()
    assert (grid[0, :, 0] == TYPE_WALL).all() and (grid[:, 15, 0] == TYPE_WALL).all()
    assert grid[14, 14, 0] == TYPE_GOAL
    assert (state.agent_pos == 1).all() and (state.agent_dir == 0).all()
    assert obs['image'].shape == (1, 4, 7, 7, 3)
    assert env.cfg.max_steps == 4 * 16 * 16


def test_scripted_goal_reach_single_env():
    """Empty-5x5 from (1, 1) facing right: forward, forward, right, forward,
    forward reaches the goal on step 5 with reward 1 - 0.9·5/100."""
    env = make('MultiGrid-Empty-5x5-v0', agents=1, device='cpu')
    _, state = env.reset()
    for t, a in enumerate([2, 2, 1, 2, 2]):
        _, state, rew, term, trunc = env.step(state, [[a]])
        assert bool(term[0, 0]) == (t == 4)
    assert rew[0, 0].item() == np.float32(1.0 - 0.9 * 5 / 100)
    assert env.success(state).tolist() == [True]
    assert env.is_done(term, trunc).tolist() == [True]


def test_vector_random_start_auto_reset():
    """Auto-reset on Empty-Random keeps every env valid across episodes."""
    env = make('MultiGrid-Empty-Random-5x5-v0', agents=2, max_steps=5,
               device='cpu')
    venv = VectorEnv(env, 16)
    _, state = venv.reset(seed=3)
    episodes = 0
    g = torch.Generator().manual_seed(3)
    for _ in range(12):
        acts = torch.randint(0, 7, (16, 2), generator=g)
        _, state, _, _, _, done, _ = venv.step(state, acts)
        episodes += int(done.sum())
        assert (state.step_count <= 5).all()
        pos = state.agent_pos
        assert ((pos >= 1) & (pos <= 3)).all()
    assert episodes >= 16 * 2
