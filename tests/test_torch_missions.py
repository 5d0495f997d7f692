"""Mission-conditioned nets and PPO ≡ the JAX package's.

BlockedUnlockPickup surfaces each episode's mission index (12 missions);
the nets take its one-hot after the direction features. The
``ActorCritic`` and the ``CentralizedCritic`` with missions are held against
flax ``apply`` on the same weights (bf16 rounding), and ``sgd_step`` against
the JAX train step's own handle (jitted alone; no whole JAX train step is
compiled) on the same parameters and ``Rollout`` with missions: through the
loss kernel (JAX in Pallas interpret mode, the port's plain version, both
float32, F = 14 direction features) and with its gate off, and with the
centralized critic. Then ``ppo_init`` sizes the net from the env, the
rollout stores the missions and the minibatches carry them, and the fused
policy takes F = 14.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multigrid_tpu.envs import make as jax_make
from multigrid_tpu.learn import nets as jax_nets
from multigrid_tpu.learn import ppo as jax_ppo
from multigrid_tpu.parallel import VectorEnv as JaxVectorEnv
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import ppo
from multigrid_tpu_torch.learn.nets import ActorCritic, CentralizedCritic, params_from_flax
from multigrid_tpu_torch.ops import fused_ppo
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.utils import prng

torch.set_num_threads(1)

ENV_ID = 'MultiGrid-BlockedUnlockPickup-v0'
M = 12
T, E, N, H = 1, 128, 2, 32
CONFIG = dict(rollout_steps=T, gamma=0.97, gae_lambda=0.9)


def _packed(rng, shape):
    return ((rng.integers(0, 11, shape) << 8) | (rng.integers(0, 6, shape) << 4)
            | rng.integers(0, 4, shape)).astype(np.int32)


def _dense(rng, fan_in, features, bias=True):
    leaf = {'kernel': (rng.normal(size=(fan_in, features)) / np.sqrt(fan_in)
                       ).astype(np.float32)}
    if bias:
        leaf['bias'] = (0.1 * rng.normal(size=features)).astype(np.float32)
    return leaf


@pytest.fixture(scope='module')
def setup():
    """JAX nets with 12 missions, flax-structured params made with numpy,
    and a random trajectory with missions as numpy."""
    jnet = jax_nets.ActorCritic(encoder='mlp', packed_obs=True, hidden=H, num_missions=M)
    critic = jax_ppo.make_centralized_critic(jnet)
    rng = np.random.default_rng(0)
    actor = {'params': {'img_kernel': _dense(rng, 49 * 21, H)['kernel'],
                        'Dense_0': _dense(rng, 2 + M, H), 'Dense_1': _dense(rng, H, H),
                        'Dense_2': _dense(rng, H, 7), 'Dense_3': _dense(rng, H, 1)}}
    cparams = {'params': {'Dense_0': _dense(rng, N * 49 * 21, H),
                          'Dense_1': _dense(rng, 2 * N + M, H, bias=False),
                          'Dense_2': _dense(rng, H, H), 'Dense_3': _dense(rng, H, 1)}}
    mission = np.broadcast_to(2 * rng.integers(0, 6, (T, E, 1)), (T, E, N)).astype(np.int32)
    traj = dict(
        image=_packed(rng, (T, E, N, 49)),
        direction=rng.integers(0, 4, (T, E, N)).astype(np.int32),
        action=rng.integers(0, 7, (T, E, N)).astype(np.int32),
        log_prob=(np.log(1 / 7) + 0.3 * rng.normal(size=(T, E, N))).astype(np.float32),
        value=rng.normal(size=(T, E, N)).astype(np.float32),
        reward=np.where(rng.random((T, E, N)) < 0.2, rng.random((T, E, N)), 0
                        ).astype(np.float32),
        done=rng.random((T, E, N)) < 0.3,
        mission=mission.copy())
    last_value = rng.normal(size=(E, N)).astype(np.float32)
    return jnet, critic, {False: actor, True: {'actor': actor, 'critic': cparams}}, \
        traj, last_value


def test_actor_critic_with_missions_matches_flax(setup):
    """Logits and values agree to bf16 rounding (test_torch_nets.py's
    tolerance), and the mission moves them."""
    jnet, _, params, _, _ = setup
    rng = np.random.default_rng(1)
    image = _packed(rng, (6, N, 49))
    direction = rng.integers(0, 4, (6, N)).astype(np.int32)
    mission = rng.integers(0, M, (6, N)).astype(np.int32)
    want = jax.jit(jnet.apply)(params[False], jnp.asarray(image), jnp.asarray(direction),
                               jnp.asarray(mission))
    net = ActorCritic(49, hidden=H, packed_obs=True, num_missions=M, encoder='mlp')
    net.load_state_dict(params_from_flax(params[False]))
    args = [torch.as_tensor(x) for x in (image, direction, mission)]
    with torch.no_grad():
        logits, value = net(*args)
        other = net(args[0], args[1], (args[2] + 1) % M)[0]
    for got, w in zip((logits, value), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-2, atol=2e-2)
    assert not torch.equal(other, logits)


def test_centralized_critic_with_missions_matches_flax(setup):
    """The joint value with agent 0's mission agrees to bf16 rounding."""
    _, critic, params, _, _ = setup
    rng = np.random.default_rng(2)
    image = _packed(rng, (6, N, 49))
    direction = rng.integers(0, 4, (6, N)).astype(np.int32)
    mission = np.repeat(rng.integers(0, M, (6, 1)), N, 1).astype(np.int32)
    cparams = params[True]['critic']
    want = jax.jit(critic.apply)(cparams, jnp.asarray(image), jnp.asarray(direction),
                                 jnp.asarray(mission))
    net = CentralizedCritic(49, N, hidden=H, packed_obs=True, num_missions=M)
    net.load_state_dict(params_from_flax(cparams))
    with torch.no_grad():
        got = net(*(torch.as_tensor(x) for x in (image, direction, mission)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


def _compare_sgd_step(setup, critic, fused, monkeypatch, grad_tol, metric_tol,
                      dtype=torch.bfloat16):
    jnet, _, params, traj, last_value = setup
    params = params[critic]
    if dtype == torch.float32:
        jnet = jnet.clone(dtype=jnp.float32)
    config = jax_ppo.PPOConfig(centralized_critic=critic, **CONFIG)
    clip = optax.clip_by_global_norm(config.max_grad_norm)
    if critic:
        clip = optax.multi_transform(
            {'actor': clip, 'critic': optax.clip_by_global_norm(config.max_grad_norm)},
            lambda p: {'actor': jax.tree.map(lambda _: 'actor', p['actor']),
                       'critic': jax.tree.map(lambda _: 'critic', p['critic'])})
    tx = optax.chain(clip, optax.adam(config.lr))
    jt = jax_ppo.Rollout(**{k: jnp.asarray(v) for k, v in traj.items()})
    jax_ppo.FUSED_INTERPRET = fused
    try:
        jstep = jax_ppo.make_train_step(
            JaxVectorEnv(jax_make(ENV_ID, agents=N), E, packed_obs=True, reset_pool=False),
            jnet, config, tx)
        adv, tg = jstep.compute_gae(jt, jnp.asarray(last_value))
        jparams, jopt, jmetrics = jax.jit(jstep.sgd_step)(
            jax.tree.map(jnp.asarray, params), tx.init(params), jt, adv, tg)
    finally:
        jax_ppo.FUSED_INTERPRET = False
    if not fused:
        monkeypatch.setattr(fused_ppo, 'supports', lambda *a: False)
    pconfig = ppo.PPOConfig(centralized_critic=critic, **CONFIG)
    venv = VectorEnv(make(ENV_ID, agents=N, device='cpu'), E, packed_obs=True,
                     reset_pool=False)
    step = ppo.make_train_step(
        venv, ActorCritic(49, hidden=H, packed_obs=True, num_missions=M, dtype=dtype,
                          encoder='mlp'), pconfig,
        ppo.Optimizer(pconfig.lr, pconfig.max_grad_norm, critic=critic))
    p0 = params_from_flax(params)
    launches = fused_ppo.launches
    new, opt, metrics = step.sgd_step(
        p0, step.tx.init(p0), ppo.Rollout(**{k: torch.as_tensor(v) for k, v in traj.items()}),
        torch.tensor(np.asarray(adv)), torch.tensor(np.asarray(tg)))
    assert fused_ppo.launches == launches  # the CPU takes the plain version
    for k in ('loss', 'pg_loss', 'vf_loss', 'entropy'):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=metric_tol, atol=1e-6, err_msg=k)
    want_mu = params_from_flax(jax.device_get(jopt[1][0].mu))
    assert set(want_mu) == set(opt.mu)
    for k in want_mu:
        assert opt.mu[k].shape == want_mu[k].shape, k
        err = float((opt.mu[k] - want_mu[k]).abs().max())
        assert err <= grad_tol * float(want_mu[k].abs().max()) + 1e-9, (k, err)
    want_p = params_from_flax(jax.device_get(jparams))
    for k in want_p:
        diff = (new[k] - want_p[k]).abs()
        assert float(diff.max()) <= 2 * config.lr + 1e-6, k
        assert float((diff > 1e-5).float().mean()) < 0.02, k
    # The mission rows of the direction weights get a gradient.
    key = 'critic.Dense_1.kernel' if critic else 'Dense_0.kernel'
    rows = opt.mu[key][2 * N:] if critic else opt.mu[key][2:]
    assert float(rows.abs().max()) > 0


def test_sgd_step_with_missions_on_the_loss_kernel_path_matches_jax(setup, monkeypatch):
    """F = 14 direction features through the loss kernel: JAX's kernel in
    interpret mode against the port's plain version, both float32, to
    test_torch_ppo.py's kernel-path tolerances (grads 5e-4, metrics 2e-5)."""
    _compare_sgd_step(setup, False, True, monkeypatch, grad_tol=5e-4, metric_tol=2e-5)


@pytest.mark.parametrize('critic', [False, True])
def test_sgd_step_with_missions_on_the_autograd_path_matches_jax(setup, monkeypatch, critic):
    """The gate off, and the centralized critic (2N + 12 features, the plain
    dense term): autograd through float32 nets on both sides, so that the
    comparison is not blurred by bf16 rounding (the value head's bias
    gradient is a near-cancelling mean): grads to 1e-3 of each leaf's
    largest, metrics to 1e-4."""
    _compare_sgd_step(setup, critic, False, monkeypatch, grad_tol=1e-3, metric_tol=1e-4,
                      dtype=torch.float32)


def test_ppo_init_sizes_the_missions():
    venv = VectorEnv(make(ENV_ID, agents=N, device='cpu'), 8, packed_obs=True)
    state, net, config, tx = ppo.ppo_init(venv, 0, hidden=H, net_kwargs=dict(encoder='mlp'))
    assert net.num_missions == M == len(venv.env.mission_space)
    assert state.params['Dense_0.kernel'].shape == (2 + M, H)
    with pytest.warns(UserWarning, match='num_missions=0'):
        _, plain, _, _ = ppo.ppo_init(venv, 0, net=ActorCritic(49, hidden=H, packed_obs=True,
                                                          encoder='mlp'))
    assert plain.num_missions == 0
    empty = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=N, device='cpu'), 8,
                      packed_obs=True)
    assert ppo.ppo_init(empty, 0, hidden=H,
                        net_kwargs=dict(encoder='mlp'))[1].num_missions == 0


def test_rollout_stores_missions_and_minibatches_carry_them():
    """The rollout's missions are the observations' (2 · the box color of
    the episode), and the minibatch shuffle keeps them beside their
    images."""
    venv = VectorEnv(make(ENV_ID, agents=N, device='cpu', max_steps=3), 8, packed_obs=True)
    config = ppo.PPOConfig(rollout_steps=5, epochs=2, minibatches=2)
    state, net, config, tx = ppo.ppo_init(venv, 0, config=config, hidden=H,
                                          net_kwargs=dict(encoder='mlp'))
    step = ppo.make_train_step(venv, net, config, tx)
    first = state.last_obs['mission']
    _, traj, _, _ = step.rollout_phase(state)
    assert traj.mission.shape == (5, 8, N) and torch.equal(traj.mission[0], first)
    assert (traj.mission % 2 == 0).all() and (traj.mission < M).all()
    # Episodes end at step 3: the missions change with the layouts.
    assert not torch.equal(traj.mission[4], traj.mission[0])
    adv = torch.randn(5, 8, N)
    perm = torch.tensor([3, 1, 4, 0, 2])
    for m, (tr, _, _) in enumerate(ppo.minibatches((traj, adv, adv), 2, perm, 3)):
        want = torch.roll(traj.mission[perm], 3, dims=1)[:, 4 * m:4 * (m + 1)]
        assert torch.equal(tr.mission, want)
        assert torch.equal(tr.image, torch.roll(traj.image[perm], 3, dims=1)[:, 4 * m:4 * (m + 1)])


def test_fused_policy_takes_fourteen_features(monkeypatch):
    """With MULTIGRID_FUSED_POLICY set, the rollout on a float32 net with 12
    missions samples through the fused policy (its plain version here, F =
    14) and gives the unfused rollout's actions (the same noise) and its
    log-probs and values to float32 rounding."""
    monkeypatch.setenv('MULTIGRID_FUSED_POLICY', '1')
    venv = VectorEnv(make(ENV_ID, agents=N, device='cpu'), 16, packed_obs=True)
    state, net, config, tx = ppo.ppo_init(venv, 0, hidden=H, dtype=torch.float32,
                                          config=ppo.PPOConfig(rollout_steps=2),
                                          net_kwargs=dict(encoder='mlp'))
    fused = ppo.make_train_step(venv, net, config, tx)
    monkeypatch.delenv('MULTIGRID_FUSED_POLICY')
    plain = ppo.make_train_step(venv, net, config, tx)
    assert fused.fused_policy and not plain.fused_policy
    obs = state.last_obs
    outs = []
    for step in (fused, plain):
        outs.append(step.policy_step(state.params, step.prepare_policy(state.params), obs,
                                     prng.key(5)))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1:], outs[1][1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
