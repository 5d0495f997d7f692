"""The port's fused rollout policy ≡ the JAX package's ``policy_sample``.

The plain version (float32 on the CPU) is held against the JAX kernel in
Pallas interpret mode (float32) on the same numpy inputs: the same actions,
log-probs and values to float32 rounding, with and without mission
features, and the first index on a constructed tie. The port's rollout with
``MULTIGRID_FUSED_POLICY`` set is held against its unfused rollout on
float32 nets under the same noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.learn.nets import ActorCritic as JaxActorCritic
from multigrid_tpu.ops.fused_policy import policy_sample as jax_policy_sample
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import ppo
from multigrid_tpu_torch.learn.nets import params_from_flax
from multigrid_tpu_torch.ops import fused_policy
from multigrid_tpu_torch.parallel import VectorEnv

torch.set_num_threads(1)

# tests/test_fused_policy.py's shapes: B 128, view 5 (C 25), hidden 128.
B, C, A = 128, 25, 7


def _inputs(missions, seed):
    """A float32 flax net's params and numpy cells, direction (and mission)
    features and Gumbel noise."""
    net = JaxActorCritic(encoder='mlp', packed_obs=True, num_missions=missions,
                         dtype=jnp.float32)
    mission = jnp.zeros((1,), jnp.int32) if missions else None
    params = jax.device_get(net.init(jax.random.key(seed), jnp.zeros((1, C), jnp.int32),
                                     jnp.zeros((1,), jnp.int32), mission))
    rng = np.random.default_rng(seed)
    cells = (rng.integers(0, 11, (B, C)) << 8) | (rng.integers(0, 6, (B, C)) << 4) \
        | rng.integers(0, 4, (B, C))
    theta = rng.integers(0, 4, B).astype(np.float32) * np.float32(np.pi / 2)
    dirf = np.stack([np.cos(theta), np.sin(theta)], -1)
    if missions:
        dirf = np.concatenate([dirf, np.eye(missions)[rng.integers(0, missions, B)]], -1)
    return (params, cells.astype(np.int32), dirf.astype(np.float32),
            rng.gumbel(size=(B, A)).astype(np.float32))


def _both(params, cells, dirf, gumbel):
    want = jax_policy_sample(params, jnp.asarray(cells), jnp.asarray(dirf),
                             jnp.asarray(gumbel), num_actions=A, interpret=True)
    got = fused_policy.policy_sample(params_from_flax(params), torch.as_tensor(cells),
                                     torch.as_tensor(dirf), torch.as_tensor(gumbel),
                                     num_actions=A)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize('missions', [0, 12])
def test_plain_version_matches_jax_kernel(missions):
    """F 2 and 14 (12 missions): equal actions, log-probs and values to
    float32 rounding (sums taken in other orders)."""
    want, got = _both(*_inputs(missions, 5 + missions))
    assert got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)
    assert len(set(got[0].tolist())) > 1


def test_tie_takes_the_first_index():
    """Actions 2 and 5 get identical logits (equal, zero Wa columns and
    equal biases) and equal noise, far above the rest: both versions pick 2."""
    params, cells, dirf, _ = _inputs(0, 9)
    head = params['params']['Dense_2']
    head['kernel'] = np.asarray(head['kernel']).copy()
    head['kernel'][:, [2, 5]] = 0.0
    head['bias'] = np.where(np.isin(np.arange(A), [2, 5]), 1.0, -30.0).astype(np.float32)
    gumbel = np.zeros((B, A), np.float32)
    gumbel[:, [2, 5]] = 0.25
    want, got = _both(params, cells, dirf, gumbel)
    assert (want[0] == 2).all() and (got[0] == 2).all()


def test_supports_gate():
    assert fused_policy.supports(16384, 128, 7)
    assert fused_policy.supports(1001, 32, 8)
    assert not fused_policy.supports(16384, 129, 7)
    assert not fused_policy.supports(16384, 128, 9)
    assert not fused_policy.supports(0, 128, 7)


def test_fused_rollout_matches_unfused(monkeypatch):
    """With float32 nets and the same noise the fused-policy rollout takes
    the unfused rollout's actions: equal trajectories and reward_per_step
    (rtol 1e-6, as tests/test_fused_policy.py:105-136)."""
    venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2, device='cpu'), 16,
                     packed_obs=True)
    state, net, config, tx = ppo.ppo_init(venv, 0, config=ppo.PPOConfig(rollout_steps=4),
                                          hidden=32, dtype=torch.float32,
                                          net_kwargs=dict(encoder='mlp'))
    plain = ppo.make_train_step(venv, net, config, tx)
    monkeypatch.setenv('MULTIGRID_FUSED_POLICY', '1')
    fused = ppo.make_train_step(venv, net, config, tx)
    assert fused.fused_policy and not plain.fused_policy
    # Per-agent policies and the centralized critic keep the unfused path.
    for kw in (dict(per_agent_policies=True), dict(centralized_critic=True)):
        assert not ppo.make_train_step(venv, net, config.replace(**kw), tx).fused_policy
    runs = []
    for step in (fused, plain):
        # The keys are the state's: each run starts from the same ones.
        runs.append(step.rollout_phase(state)[1])
        runs.append(step(state)[1])
    (traj_f, m_f), (traj_p, m_p) = runs[:2], runs[2:]
    assert torch.equal(traj_f.action, traj_p.action)
    assert torch.equal(traj_f.image, traj_p.image)
    torch.testing.assert_close(traj_f.log_prob, traj_p.log_prob, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(traj_f.value, traj_p.value, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(m_f['reward_per_step']), float(m_p['reward_per_step']),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m_f['entropy']), float(m_p['entropy']), rtol=1e-5)
