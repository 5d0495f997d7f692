"""The port's rendering ≡ the JAX package's (multigrid_tpu/render.py,
multigrid_tpu/utils/pprint.py), and ``python -m multigrid_tpu_torch.visualize``.

Frames are pixel-equal to JAX ``render_state`` on the same state (env 1 of
a batch of 2, carried across as numpy), on Empty, BlockedUnlockPickup and
LockedHallway after a reset and after random steps, with the highlight on
and off, at tiles of 32 and 16; the view-cone mask on random states with
agents at the borders and terminated; the ASCII map; the tile cache.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.core.config import EnvConfig as JaxEnvConfig
from multigrid_tpu.core.state import MultiGridState as JaxState
from multigrid_tpu.envs import make as jax_make
from multigrid_tpu.render import render_state as jax_render_state
from multigrid_tpu.render import visible_world_mask as jax_visible_world_mask
from multigrid_tpu.utils.pprint import state_to_string as jax_state_to_string
from multigrid_tpu_torch import render, visualize
from multigrid_tpu_torch.core.state import FIELDS, state_to_numpy
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.utils.pprint import state_to_string
from multigrid_tpu_torch.utils import prng

from .test_torch_states import random_fields, to_torch

torch.set_num_threads(1)

ENVS = ['MultiGrid-Empty-8x8-v0', 'MultiGrid-BlockedUnlockPickup-v0',
        'MultiGrid-LockedHallway-2Rooms-v0']


def _jax_single(state, index):
    """Env ``index`` of a port state as a single JAX env state."""
    host = state_to_numpy(state)
    return JaxState(**{k: jnp.asarray(host[k][index]) for k in FIELDS},
                    rng=jax.random.key(0),
                    extras={k: jnp.asarray(v[index]) for k, v in host['extras'].items()})


def _states(env_id, steps=6):
    """A batch of 2 fresh layouts, then the same after ``steps`` random
    steps (2 agents, on the CPU)."""
    env = make(env_id, agents=2, device='cpu')
    g = torch.Generator().manual_seed(len(env_id))
    _, state = env.reset(prng.split(prng.key(len(env_id)), 2))
    out = [state]
    for _ in range(steps):
        _, state, *_ = env.step(state, torch.randint(0, 7, (2, 2), generator=g))

    return env, out + [state]


@pytest.mark.parametrize('tile', [32, 16])
@pytest.mark.parametrize('highlight', [True, False])
@pytest.mark.parametrize('env_id', ENVS)
def test_frames_match_jax(env_id, highlight, tile):
    env, states = _states(env_id)
    jenv = jax_make(env_id, agents=2)
    for t, state in enumerate(states):
        ours = render.render_state(env, state, index=1, highlight=highlight, tile_size=tile)
        theirs = jax_render_state(jenv, _jax_single(state, 1), highlight=highlight,
                                  tile_size=tile)
        assert ours.dtype == np.uint8 and ours.shape == (env.height * tile,
                                                         env.width * tile, 3)
        if not np.array_equal(ours, theirs):
            diff = np.argwhere((ours != theirs).any(-1))
            raise AssertionError(f'{env_id} state {t}: {len(diff)} pixels differ, '
                                 f'first at {tuple(diff[0])}')


@pytest.mark.parametrize('vs', [3, 5, 7])
def test_visible_world_mask_matches_jax(vs):
    """Random states (views running off the grid, agents terminated, doors
    in every state), each env against the JAX mask."""
    e, w, h, n = 6, 9, 7, 3
    fields = random_fields(vs, e, w, h, n)
    state = to_torch(fields)
    env = types.SimpleNamespace(cfg=types.SimpleNamespace(width=w, height=h, view_size=vs))
    jenv = types.SimpleNamespace(cfg=JaxEnvConfig(width=w, height=h, num_agents=n,
                                                  view_size=vs))
    for i in range(e):
        ours = render.visible_world_mask(env, state, index=i)
        theirs = jax_visible_world_mask(jenv, _jax_single(state, i))
        np.testing.assert_array_equal(ours, theirs, err_msg=f'env {i}')


@pytest.mark.parametrize('env_id', ENVS)
def test_state_to_string_matches_jax(env_id):
    _, states = _states(env_id)
    for state in states:
        for i in (0, 1):
            assert state_to_string(state, i) == jax_state_to_string(_jax_single(state, i))


def test_tile_cache_is_keyed_by_content():
    a = render.render_tile((8, 1, 0), highlight=True, tile_size=16)
    assert render.render_tile((8, 1, 0), highlight=True, tile_size=16) is a
    b = render.render_tile((8, 1, 0), highlight=False, tile_size=16)
    assert b is not a and not np.array_equal(a, b)
    assert render.render_tile((8, 1, 0), agent=(0, 2), highlight=True, tile_size=16) is not a


def test_visualize_random_policy(tmp_path, capsys):
    """A random-policy run on the CPU: a frame for each reset and step, of
    the env's size, and a GIF of them."""
    gif = tmp_path / 'out.gif'
    frames = visualize.main(['--device', 'cpu', '--env', 'MultiGrid-Empty-5x5-v0',
                             '--num-agents', '2', '--num-episodes', '2', '--max-steps', '6',
                             '--tile-size', '8', '--gif', str(gif)])
    assert len(frames) == 2 * 7
    assert all(f.shape == (40, 40, 3) and f.dtype == np.uint8 for f in frames)
    out = capsys.readouterr().out
    assert 'episode 1: 6 steps' in out and f'saved 14 frames -> {gif}' in out
    assert gif.stat().st_size > 0


@pytest.mark.parametrize('flags', [[], ['--critic', 'centralized'], ['--per-agent-policies']])
def test_visualize_restores_a_checkpoint(tmp_path, capsys, flags):
    """A checkpoint of the training CLI (mlp on packed cells) drives the
    episodes through its actors: a shared policy, the centralized critic's
    actor, per-agent policies; a net of another width does not restore."""
    from multigrid_tpu_torch import train
    ck = str(tmp_path / 'ck')
    common = ['--device', 'cpu', '--env', 'MultiGrid-Empty-5x5-v0', '--num-agents', '2',
              '--hidden', '16', '--encoder', 'mlp'] + flags
    train.main(common + ['--num-envs', '4', '--rollout-steps', '4', '--num-timesteps', '64',
                         '--save-dir', ck, '--save-interval', '2'])
    frames = visualize.main(common + ['--load-dir', ck, '--num-episodes', '1',
                                      '--max-steps', '5', '--tile-size', '4'])
    assert len(frames) == 6 and frames[0].shape == (20, 20, 3)
    assert f'loaded policy from {ck}/step_' in capsys.readouterr().out
    with pytest.raises(SystemExit, match='failed to restore'):
        visualize.main(common + ['--hidden', '32', '--load-dir', ck])
