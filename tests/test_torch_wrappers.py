"""The port's observation wrappers ≡ the JAX package's (multigrid_tpu/wrappers.py).

On Empty-5x5 and BlockedUnlockPickup (with missions), 2 agents: each
wrapper's observations equal the JAX wrapper's on the same state, bit for
bit and dtype for dtype, after a reset (the JAX reset's state carried
across) and after ``step_with_order`` with the same actions and orders; and
through ``VectorEnv``, Empty's exact auto-reset and BUP's reserve pool (the
JAX reserve carried across) included. Spaces, ``one_hot`` on indices out of
range, the overlay order and ``packed_obs`` on wrapped envs besides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu import wrappers as jax_wrappers
from multigrid_tpu.envs import make as jax_make
from multigrid_tpu.ops.step import sample_order as jax_sample_order
from multigrid_tpu.parallel import VectorEnv as JaxVectorEnv
from multigrid_tpu_torch import wrappers
from multigrid_tpu_torch.core.state import FIELDS, state_from_arrays
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.parallel import VectorEnv

from .test_torch_pool import _port_state
from .test_torch_states import jax_fields, random_fields, to_jax, to_torch

torch.set_num_threads(1)

N = 2
EMPTY = 'MultiGrid-Empty-5x5-v0'
BUP = 'MultiGrid-BlockedUnlockPickup-v0'
WRAPPERS = ['FullyObsWrapper', 'ImgObsWrapper', 'OneHotObsWrapper']

_JAX_ENVS = {}


def _jax_env(env_id):
    """One JAX env a configuration, so that its jitted functions compile
    once in the file."""
    if env_id not in _JAX_ENVS:
        _JAX_ENVS[env_id] = jax_make(env_id, agents=N)
    return _JAX_ENVS[env_id]


def _port_single(jstate):
    """The port's ``E = 1`` state from a single JAX env state."""
    host = jax.device_get(jstate)
    return state_from_arrays({k: getattr(host, k) for k in FIELDS}, 'cpu',
                             extras=dict(host.extras))


def env0(obs):
    """Env 0 of a batched observation tree."""
    return {k: v[0] for k, v in obs.items()} if isinstance(obs, dict) else obs[0]


def assert_obs_equal(ours, theirs, where):
    """Observation trees equal: the same keys, dtypes and values."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), where
        for k in theirs:
            assert_obs_equal(ours[k], theirs[k], f'{where} {k}')
        return
    want = np.asarray(theirs)
    got = ours.numpy()
    assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize('name', WRAPPERS)
@pytest.mark.parametrize('env_id', [EMPTY, BUP])
def test_wrapper_matches_jax_after_reset_and_steps(env_id, name):
    jenv = _jax_env(env_id)
    jw = getattr(jax_wrappers, name)(jenv)
    pw = getattr(wrappers, name)(make(env_id, agents=N, device='cpu'))
    jobs, jstate = jw.reset(jax.random.key(3))
    state = _port_single(jstate)
    assert_obs_equal(env0(pw.observe(state)), jobs, 'reset')
    if isinstance(jobs, dict):  # ImgObsWrapper gives the image alone
        assert ('mission' in jobs) == (env_id == BUP)
    rng = np.random.default_rng(5)
    for t in range(4):
        actions = rng.integers(0, 7, N).astype(np.int32)
        order = rng.permutation(N).astype(np.int32)
        jobs, jstate, jrew, jterm, jtrunc = jw.step_with_order(
            jstate, jnp.asarray(actions), jnp.asarray(order))
        obs, state, rew, term, trunc = pw.step_with_order(
            state, torch.as_tensor(actions[None]), torch.as_tensor(order[None]))
        assert_obs_equal(env0(obs), jobs, f't={t}')
        np.testing.assert_array_equal(rew[0].numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(term[0].numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(trunc[0].numpy(), np.asarray(jtrunc))
        want = jax_fields(jstate)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(state, k)[0].numpy(), want[k], err_msg=k)


def test_single_agent_wrapper_matches_jax():
    """The agent axis goes (dim 1 behind the env axis here, dim 0 there);
    ``step`` takes bare actions and no mask."""
    jw = jax_wrappers.SingleAgentWrapper(jax_make(EMPTY))
    pw = wrappers.SingleAgentWrapper(make(EMPTY, device='cpu'))
    jobs, jstate = jw.reset(jax.random.key(0))
    state = _port_single(jstate)
    obs = pw.observe(state)
    assert obs['image'].shape == (1, 7, 7, 3) and obs['direction'].shape == (1,)
    assert_obs_equal(env0(obs), jobs, 'reset')
    for t, a in enumerate([2, 2, 1, 2, 2]):
        jobs, jstate, jrew, jterm, jtrunc = jw.step(jstate, a)
        obs, state, rew, term, trunc = pw.step(state, [a])
        assert rew.shape == term.shape == trunc.shape == (1,)
        assert_obs_equal(env0(obs), jobs, f't={t}')
        assert rew[0].item() == float(jrew) and bool(term[0]) == bool(jterm)
    assert bool(term[0]) and rew[0].item() == np.float32(1 - 0.9 * 5 / 100)
    with pytest.raises(AssertionError):
        wrappers.SingleAgentWrapper(make(EMPTY, agents=2, device='cpu'))


def _jax_vector_case(env_id, name, e):
    kw = dict(agents=N, max_steps=3, see_through_walls=True)
    jvenv = JaxVectorEnv(getattr(jax_wrappers, name)(jax_make(env_id, **kw)), e,
                         reset_pool_period=4)
    venv = VectorEnv(getattr(wrappers, name)(make(env_id, device='cpu', **kw)), e,
                     reset_pool_period=4)
    return jvenv, venv


@pytest.mark.parametrize('name', WRAPPERS)
@pytest.mark.parametrize('env_id', [EMPTY, BUP])
def test_wrapped_vector_env_matches_jax(env_id, name):
    """E 6, max_steps 3, 8 steps: every env auto-resets twice, through
    Empty's exact reset or BUP's pool (both packages holding the same
    reserve); the wrapped observations of every step, the states and the
    rewards agree bit for bit. The envs see through walls, which spares
    XLA:CPU the visibility compile (the single-env test covers it)."""
    e = 6
    jvenv, venv = _jax_vector_case(env_id, name, e)
    assert venv.reset_pool == jvenv.reset_pool == (env_id == BUP)
    jobs, jstate = jvenv.reset(jax.random.key(4))
    if venv.reset_pool:
        state = _port_state(jstate, jvenv)
    else:
        state = to_torch(jax_fields(jstate))
    assert_obs_equal(venv.observe(state), jobs, 'reset')
    draw_order = jax.jit(jax.vmap(lambda s: jax_sample_order(jax.random.split(s.rng)[0], N)))
    rng = np.random.default_rng(6)
    dones = 0
    for t in range(8):
        actions = rng.integers(0, 7, (e, N)).astype(np.int32)
        order = np.asarray(draw_order(jstate))
        jout = jvenv.step(jstate, jnp.asarray(actions), refresh=False)
        out = venv.step(state, torch.as_tensor(actions), order=torch.as_tensor(order.copy()),
                        refresh=False)
        jstate, state = jout[1], out[1]
        assert_obs_equal(out[0], jout[0], f't={t}')
        want = jax_fields(jstate)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(state, k).numpy(), want[k], err_msg=k)
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))
        dones += int(out[5].sum())
    assert dones == 2 * e


def test_packed_obs_only_on_an_unwrapped_env():
    """As in the JAX package (vector.py:83-86): a base env packs, a wrapped
    one raises, since the hook of every base env is the identity."""
    env = make(EMPTY, agents=N, device='cpu')
    obs, _ = VectorEnv(env, 2, packed_obs=True).reset(seed=0)
    assert obs['image'].shape == (2, N, 49)
    for name in WRAPPERS:
        with pytest.raises(ValueError, match='unwrapped'):
            VectorEnv(getattr(wrappers, name)(env), 2, packed_obs=True)


def test_one_hot_matches_jax_out_of_range():
    """Indices past a plane's width or negative give a zero row in both."""
    rng = np.random.default_rng(0)
    image = rng.integers(-2, 13, (3, 4, 5, 3)).astype(np.int32)
    got = wrappers.one_hot(torch.as_tensor(image))
    want = np.asarray(jax_wrappers.one_hot(jnp.asarray(image)))
    assert got.dtype == torch.uint8 and got.shape == (3, 4, 5, sum(wrappers.ONE_HOT_DIMS))
    np.testing.assert_array_equal(got.numpy(), want)
    assert wrappers.ONE_HOT_DIMS == jax_wrappers.ONE_HOT_DIMS


def test_fully_obs_image_matches_jax():
    """Random states with agents sharing cells, terminated, carrying and at
    the borders: the later live agent wins a cell, terminated ones are not
    drawn, as in the JAX overlay."""
    fields = random_fields(11, 16, 6, 5, 4)
    fields['agent_pos'][:, 1] = fields['agent_pos'][:, 0]  # a shared cell everywhere
    got = wrappers.fully_obs_image(to_torch(fields))
    want = jax.vmap(jax_wrappers.fully_obs_image)(to_jax(fields))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('name', [None] + WRAPPERS)
def test_transform_space_matches_jax(name):
    """The per-agent spaces (and their dtypes) that adapters report."""
    from gymnasium import spaces
    base = spaces.Dict({'image': spaces.Box(0, 255, (7, 7, 3), dtype=np.int32),
                        'direction': spaces.Discrete(4)})
    jenv, env = jax_make(EMPTY, agents=N), make(EMPTY, agents=N, device='cpu')
    if name is not None:
        jenv, env = getattr(jax_wrappers, name)(jenv), getattr(wrappers, name)(env)
    ours, theirs = env.transform_space(base), jenv.transform_space(base)
    assert ours == theirs
    if isinstance(theirs, spaces.Dict):
        for k in theirs.spaces:
            assert ours[k].dtype == theirs[k].dtype, k
    else:
        assert ours.dtype == theirs.dtype
