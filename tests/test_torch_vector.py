"""The port's ``VectorEnv.step`` ≡ the JAX package's, auto-resets included.

Both step E=8 Empty-5x5 envs (max_steps 100) for 110 steps, so every env
truncates and resets at least once; env 0 is scripted to the goal in its
first five steps. The envs see through walls, which spares XLA:CPU the
compile of the visibility mask; tests/test_torch_obs.py and the golden
traces cover it. The port is fed the agent orders the JAX side draws from
each env's ``rng`` (multigrid_tpu/parallel/vector.py:377-381).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multigrid_tpu.envs import make as jax_make
from multigrid_tpu.ops.step import sample_order as jax_sample_order
from multigrid_tpu.parallel import VectorEnv as JaxVectorEnv
from multigrid_tpu_torch.core.state import FIELDS, STATE_FIELDS
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.utils import prng

from .test_torch_states import jax_fields

torch.set_num_threads(1)

E, N, STEPS = 8, 2, 110
ENV_ID = 'MultiGrid-Empty-5x5-v0'


def _assert_state_equal(ours, theirs, t):
    want = jax_fields(theirs)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ours, k).numpy(), want[k],
                                      err_msg=f't={t} {k}')
    np.testing.assert_array_equal(ours.rng.numpy(), np.asarray(jax.random.key_data(theirs.rng)),
                                  err_msg=f't={t} rng')


def test_vector_step_matches_jax():
    kw = dict(agents=N, see_through_walls=True)
    jvenv = JaxVectorEnv(jax_make(ENV_ID, **kw), E)
    venv = VectorEnv(make(ENV_ID, device='cpu', **kw), E)
    jobs, jstate = jvenv.reset(jax.random.key(0))
    obs, state = venv.reset(seed=0)
    np.testing.assert_array_equal(obs['image'].numpy(), np.asarray(jobs['image']))
    _assert_state_equal(state, jstate, 'reset')

    draw_order = jax.jit(jax.vmap(
        lambda s: jax_sample_order(jax.random.split(s.rng)[0], N)))
    rng = np.random.default_rng(0)
    script = [2, 2, 1, 2, 2]  # forward, forward, right, forward, forward
    dones = np.zeros(E, int)
    for t in range(STEPS):
        actions = rng.integers(0, 7, (E, N)).astype(np.int32)
        if t < len(script):
            actions[0] = script[t]
        order = np.asarray(draw_order(jstate))
        jout = jvenv.step(jstate, jnp.asarray(actions))
        jstate = jout[1]
        out = venv.step(state, torch.as_tensor(actions),
                        order=torch.as_tensor(order.copy()))
        state = out[1]
        np.testing.assert_array_equal(out[0]['image'].numpy(),
                                      np.asarray(jout[0]['image']), err_msg=str(t))
        np.testing.assert_array_equal(out[0]['direction'].numpy(),
                                      np.asarray(jout[0]['direction']))
        _assert_state_equal(state, jstate, t)
        np.testing.assert_array_equal(out[2].numpy().view(np.int32),
                                      np.asarray(jout[2]).view(np.int32))
        for ours, theirs in zip(out[3:], jout[3:]):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        dones += out[5].numpy()
        if t == len(script) - 1:
            # Env 0 reached the goal: done, a success, reward 1 - 0.9·5/100
            # for the first agent in order (rewards are assigned, not added).
            assert out[5][0] and out[6][0]
            assert out[2][0].max().item() == np.float32(1 - 0.9 * 5 / 100)
    assert (dones >= 1).all()  # every env truncated (max_steps 100) and reset


def test_rollout_random_is_the_step_loop():
    """``rollout_random`` equals stepping by hand with the same key's
    draws; its obs checksum wraps to int32."""
    venv = VectorEnv(make('MultiGrid-Empty-Random-6x6-v0', agents=3,
                          max_steps=6, device='cpu'), 16)
    _, state = venv.reset(seed=5)
    final, summary = venv.rollout_random(state, prng.key(6), 9)

    _, state = venv.reset(seed=5)
    rew, episodes, obs_sum = 0.0, 0, 0
    key = prng.key(6)
    for _ in range(9):
        key, ak = prng.split(key).unbind(0)
        actions = prng.randint(ak, (16, 3), 0, 7)
        obs, state, r, _, _, done, _ = venv.step(state, actions)
        rew += float(r.sum())
        episodes += int(done.sum())
        obs_sum += int(obs['image'].sum())
    for k in STATE_FIELDS:
        assert torch.equal(getattr(final, k), getattr(state, k)), k
    assert int(summary['episodes']) == episodes >= 16
    # float32 sums in another order: equal to rounding.
    assert abs(float(summary['reward_sum']) - rew) < 1e-4
    assert int(summary['obs_sum']) == (obs_sum + 2**31) % 2**32 - 2**31
