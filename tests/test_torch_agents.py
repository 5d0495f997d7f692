"""Per-agent policies and the centralized critic ≡ the JAX package's.

The centralized critic is held against flax ``apply``; the per-agent clip
and the actor/critic ``multi_transform`` against optax; and ``sgd_step``
against the JAX train step's own handle on the same parameters,
``Rollout`` and optimizer state, on each path: per-agent policies through the loss kernel (JAX in
Pallas interpret mode, float32; the port's plain version, float32) and with
the kernel's gate off, and the centralized critic with a shared and with
per-agent actors (autograd of the bf16 nets on both sides). No JAX train
step is compiled: the handle alone is jitted, since unjitted its op-by-op
dispatch compiles every primitive on its own and takes about ten times as
long. Then the port trains each variant on the CPU, and its CLI takes the
new flags.
"""

import json

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
from multigrid_tpu_torch import train as train_cli
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import ppo
from multigrid_tpu_torch.learn.nets import (
    ActorCritic,
    CentralizedCritic,
    params_from_flax,
    params_to_flax,
)
from multigrid_tpu_torch.ops import fused_ppo
from multigrid_tpu_torch.parallel import VectorEnv

torch.set_num_threads(1)

ENV_ID = 'MultiGrid-Empty-5x5-v0'
# T·E = 128 samples an agent: the JAX per-agent kernel gate holds
# (E % 128 == 0 for the rollout's first layer, ppo.py:301-309).
T, E, N, H = 1, 128, 2, 32
CONFIG = dict(rollout_steps=T, gamma=0.97, gae_lambda=0.9)


def _packed(rng, shape):
    return ((rng.integers(0, 11, shape) << 8) | (rng.integers(0, 6, shape) << 4)
            | rng.integers(0, 4, shape)).astype(np.int32)


def _dense(rng, fan_in, features, bias=True):
    """A flax ``Dense``'s params: a lecun-scaled kernel and a small bias."""
    leaf = {'kernel': (rng.normal(size=(fan_in, features)) / np.sqrt(fan_in)
                       ).astype(np.float32)}
    if bias:
        leaf['bias'] = (0.1 * rng.normal(size=features)).astype(np.float32)
    return leaf


@pytest.fixture(scope='module')
def setup():
    """JAX nets, flax-structured params of each kind (made with numpy: flax's
    eager init costs seconds) and a random trajectory as numpy."""
    jnet = jax_nets.ActorCritic(encoder='mlp', packed_obs=True, hidden=H)
    critic = jax_ppo.make_centralized_critic(jnet)
    rng = np.random.default_rng(0)
    inits = [{'params': {'img_kernel': _dense(rng, 49 * 21, H)['kernel'],
                         'Dense_0': _dense(rng, 2, H), 'Dense_1': _dense(rng, H, H),
                         'Dense_2': _dense(rng, H, 7), 'Dense_3': _dense(rng, H, 1)}}
             for _ in range(N)]
    cparams = {'params': {'Dense_0': _dense(rng, N * 49 * 21, H),
                          'Dense_1': _dense(rng, 2 * N, H, bias=False),
                          'Dense_2': _dense(rng, H, H), 'Dense_3': _dense(rng, H, 1)}}
    stacked = jax.tree.map(lambda *x: np.stack(x), *inits)
    params = {(True, False): stacked,
              (False, True): {'actor': inits[0], 'critic': cparams},
              (True, True): {'actor': stacked, 'critic': cparams}}
    traj = dict(
        image=_packed(rng, (T, E, N, 49)),
        direction=rng.integers(0, 4, (T, E, N)).astype(np.int32),
        action=rng.integers(0, 7, (T, E, N)).astype(np.int32),
        log_prob=(np.log(1 / 7) + 0.3 * rng.normal(size=(T, E, N))).astype(np.float32),
        value=rng.normal(size=(T, E, N)).astype(np.float32),
        reward=np.where(rng.random((T, E, N)) < 0.2, rng.random((T, E, N)), 0
                        ).astype(np.float32),
        done=rng.random((T, E, N)) < 0.3)
    last_value = rng.normal(size=(E, N)).astype(np.float32)
    return jnet, critic, params, traj, last_value


def _jax_tx(config):
    """The JAX package's optimizer for ``config`` (ppo.py:192-221)."""
    clip = (jax_ppo.clip_by_global_norm_per_agent(config.max_grad_norm)
            if config.per_agent_policies else optax.clip_by_global_norm(config.max_grad_norm))
    if config.centralized_critic:
        clip = optax.multi_transform(
            {'actor': clip, 'critic': optax.clip_by_global_norm(config.max_grad_norm)},
            lambda p: {'actor': jax.tree.map(lambda _: 'actor', p['actor']),
                       'critic': jax.tree.map(lambda _: 'critic', p['critic'])})
    return optax.chain(clip, optax.adam(config.lr))


def test_centralized_critic_matches_flax(setup):
    """The joint value of the same weights on the same observations agrees
    to bf16 rounding (test_torch_nets.py's tolerance); the train step
    broadcasts it, equal, to every agent."""
    _, critic, params, _, _ = setup
    rng = np.random.default_rng(1)
    image, direction = _packed(rng, (6, N, 49)), rng.integers(0, 4, (6, N)).astype(np.int32)
    cparams = params[(False, True)]['critic']
    want = jax.jit(critic.apply)(cparams, jnp.asarray(image), jnp.asarray(direction))
    net = CentralizedCritic(49, N, hidden=H, packed_obs=True)
    net.load_state_dict(params_from_flax(cparams))
    with torch.no_grad():
        got = net(torch.as_tensor(image), torch.as_tensor(direction))
    assert got.dtype == torch.float32 and got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)
    venv = VectorEnv(make(ENV_ID, agents=N, device='cpu'), 6, packed_obs=True)
    step = ppo.make_train_step(venv, ActorCritic(49, hidden=H, packed_obs=True, encoder='mlp'),
                               ppo.PPOConfig(centralized_critic=True), ppo.Optimizer(3e-4, 0.5))
    p = params_from_flax(params[(False, True)])
    with torch.no_grad():
        v = step.central_value(p, torch.as_tensor(image), torch.as_tensor(direction))
    assert v.shape == (6, N)
    torch.testing.assert_close(v, got[:, None].expand(6, N), rtol=0, atol=0)


def test_params_round_trip_stacked_and_actor_critic(setup):
    """Stacked per-agent trees keep their agent axis, and ``{'actor',
    'critic'}`` trees their two groups, through the converters."""
    params = setup[2][(True, True)]
    state = params_from_flax(params)
    assert state['actor.img_kernel'].shape == (N, 49 * 21, H)
    assert state['critic.Dense_0.kernel'].shape == (N * 49 * 21, H)
    assert 'critic.Dense_1.bias' not in state
    back = params_to_flax(state)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('per_agent,critic', [(True, False), (False, True), (True, True)])
def test_optimizer_matches_optax(per_agent, critic):
    """The per-agent clip and the actor/critic multi_transform, then adam,
    at steps 1-3: one agent clipped and one not at step 1, none at step 2,
    all at step 3."""
    rng = np.random.default_rng(2)
    lead = (N,) if per_agent else ()
    actor = {'a': rng.normal(size=lead + (5, 3)).astype(np.float32),
             'b': rng.normal(size=lead + (3,)).astype(np.float32)}
    params = {'actor': actor, 'critic': {'c': rng.normal(size=(4,)).astype(np.float32)}} \
        if critic else actor
    config = jax_ppo.PPOConfig(per_agent_policies=per_agent, centralized_critic=critic)
    tx = _jax_tx(config)
    ours = ppo.Optimizer(config.lr, config.max_grad_norm, per_agent=per_agent, critic=critic)
    jstate = tx.init(params)
    state = ours.init(params_from_flax(params))
    agent_scale = np.array([1.0, 0.01]).reshape((N,) + (1,) * 2) if per_agent else 1.0
    for scale in (1.0, 0.01, 3.0):
        grads = jax.tree.map(lambda v: (rng.normal(size=v.shape) * scale
                                        * (agent_scale if v.ndim > 2 else 1)
                                        ).astype(np.float32), params)
        want, jstate = tx.update(grads, jstate, params)
        got, state = ours.update(params_from_flax(grads), state)
        want = params_from_flax(jax.device_get(want))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=5e-5, atol=1e-12,
                                       err_msg=k)
    assert state.count == 3


def _compare_sgd_step(setup, per_agent, critic, fused, monkeypatch, grad_tol, metric_tol):
    jnet, _, params, traj, last_value = setup
    params = params[(per_agent, critic)]
    config = jax_ppo.PPOConfig(per_agent_policies=per_agent, centralized_critic=critic,
                               **CONFIG)
    tx = _jax_tx(config)
    jt = jax_ppo.Rollout(**{k: jnp.asarray(v) for k, v in traj.items()})
    jax_ppo.FUSED_INTERPRET = fused
    try:
        jstep = jax_ppo.make_train_step(
            JaxVectorEnv(jax_make(ENV_ID, agents=N), E, packed_obs=True), jnet, config, tx)
        adv, tg = jstep.compute_gae(jt, jnp.asarray(last_value))
        jparams, jopt, jmetrics = jax.jit(jstep.sgd_step)(
            jax.tree.map(jnp.asarray, params), tx.init(params), jt, adv, tg)
    finally:
        jax_ppo.FUSED_INTERPRET = False
    if not fused:
        monkeypatch.setattr(fused_ppo, 'supports', lambda *a: False)
    pconfig = ppo.PPOConfig(per_agent_policies=per_agent, centralized_critic=critic, **CONFIG)
    venv = VectorEnv(make(ENV_ID, agents=N, device='cpu'), E, packed_obs=True)
    step = ppo.make_train_step(
        venv, ActorCritic(49, hidden=H, packed_obs=True, encoder='mlp'), pconfig,
        ppo.Optimizer(pconfig.lr, pconfig.max_grad_norm, per_agent=per_agent, critic=critic))
    p0 = params_from_flax(params)
    new, opt, metrics = step.sgd_step(
        p0, step.tx.init(p0), ppo.Rollout(**{k: torch.as_tensor(v) for k, v in traj.items()}),
        torch.tensor(np.asarray(adv)), torch.tensor(np.asarray(tg)))
    for k in ('loss', 'pg_loss', 'vf_loss', 'entropy'):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=metric_tol, atol=1e-6, err_msg=k)
    # Adam's first moment after one step is 0.1 x the clipped gradient.
    want_mu = params_from_flax(jax.device_get(jopt[1][0].mu))
    assert set(want_mu) == set(opt.mu)
    for k in want_mu:
        assert opt.mu[k].shape == want_mu[k].shape, k
        err = float((opt.mu[k] - want_mu[k]).abs().max())
        assert err <= grad_tol * float(want_mu[k].abs().max()) + 1e-9, (k, err)
    # The step is ±lr·(~1) per element; an element whose gradient is a
    # near-cancelling sum may step the other way.
    want_p = params_from_flax(jax.device_get(jparams))
    for k in want_p:
        diff = (new[k] - want_p[k]).abs()
        assert float(diff.max()) <= 2 * config.lr + 1e-6, k
        assert float((diff > 1e-5).float().mean()) < 0.02, k
    return new, p0


def test_sgd_step_per_agent_on_the_loss_kernel_path_matches_jax(setup, monkeypatch):
    """One loss-kernel launch per agent, grads over N (ppo.py:527-581): JAX's
    kernel in interpret mode against the port's plain version, both float32,
    to test_torch_ppo.py's kernel-path tolerances."""
    _compare_sgd_step(setup, True, False, True, monkeypatch, grad_tol=5e-4, metric_tol=2e-5)


@pytest.mark.parametrize('per_agent,critic', [(True, False), (False, True), (True, True)])
def test_sgd_step_on_the_autograd_path_matches_jax(setup, monkeypatch, per_agent, critic):
    """Per-agent policies with the kernel's gate off, and the centralized
    critic (which never takes the kernel) with a shared and with per-agent
    actors: autograd through the bf16 nets on both sides, to
    test_torch_ppo.py's autograd-path tolerances. With the critic, the
    actor's own value head gets no gradient."""
    new, p0 = _compare_sgd_step(setup, per_agent, critic, False, monkeypatch,
                                grad_tol=5e-2, metric_tol=1e-2)
    if critic:
        for k in ('actor.Dense_3.kernel', 'actor.Dense_3.bias'):
            assert torch.equal(new[k], p0[k]), k


def _contiguous_only(fn):
    """``fn`` that first asserts what the CUDA wrappers check: every tensor
    argument contiguous."""
    def checked(*args, **kw):
        for a in args:
            if isinstance(a, torch.Tensor):
                assert a.is_contiguous(), tuple(a.shape)
        return fn(*args, **kw)
    return checked


@pytest.mark.parametrize('per_agent,critic', [(True, False), (False, True), (True, True)])
def test_every_agent_and_the_critic_train(per_agent, critic, monkeypatch):
    """One update on the CPU (3 agents) and one of 2 minibatches: every
    agent's own parameter slice moves (tests/test_ppo.py:34-56), and so do
    the critic's parameters. Each first-layer and loss-kernel call gets
    contiguous rows, as the kernels' wrappers require on the card."""
    from multigrid_tpu_torch.ops import fused_linear
    monkeypatch.setattr(fused_linear, 'onehot_linear_plain',
                        _contiguous_only(fused_linear.onehot_linear_plain))
    monkeypatch.setattr(fused_ppo, 'ppo_mlp_grads_plain',
                        _contiguous_only(fused_ppo.ppo_mlp_grads_plain))
    venv = VectorEnv(make(ENV_ID, agents=3, device='cpu'), 8, packed_obs=True)
    config = ppo.PPOConfig(rollout_steps=2, per_agent_policies=per_agent,
                           centralized_critic=critic)
    state, net, config, tx = ppo.ppo_init(venv, 1, config=config, hidden=16,
                                          net_kwargs=dict(encoder='mlp'))
    before = state.params
    actor = [k for k in before if not k.startswith('critic.')]
    state, metrics = ppo.make_train_step(venv, net, config, tx)(state)
    assert np.isfinite(float(metrics['loss']))
    _, metrics = ppo.make_train_step(venv, net, config.replace(minibatches=2), tx)(state)
    assert np.isfinite(float(metrics['loss']))
    if per_agent:
        assert all(before[k].shape[0] == 3 for k in actor)
        # Each agent starts from its own weights and its own slice trains.
        w = before[actor[0]]
        assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
        for a in range(3):
            assert any(not torch.equal(before[k][a], state.params[k][a]) for k in actor), a
    else:
        assert any(not torch.equal(before[k], state.params[k]) for k in actor)
    critic_keys = [k for k in before if k.startswith('critic.')]
    assert bool(critic_keys) == critic
    if critic:
        assert all(not torch.equal(before[k], state.params[k]) for k in critic_keys)


def test_cli_trains_per_agent_policies_with_the_centralized_critic(tmp_path, capsys):
    log = tmp_path / 'log.jsonl'
    train_cli.main(['--device', 'cpu', '--env', ENV_ID, '--num-agents', '2',
                    '--num-envs', '8', '--rollout-steps', '4', '--num-timesteps', '128',
                    '--hidden', '32', '--per-agent-policies', '--critic', 'centralized',
                    '--log-interval', '1', '--log-jsonl', str(log),
                    '--save-dir', str(tmp_path / 'ckpt')])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith('training MultiGrid-Empty-5x5-v0: 2 agents x 8 envs, 2 updates')
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r['update'] for r in rows] == [1, 2]
    assert all(np.isfinite(r['loss']) for r in rows)
    args = train_cli.parse_args(['--per-agent-policies', '--critic', 'centralized'])
    assert args.per_agent_policies and args.critic == 'centralized'
    with pytest.raises(SystemExit):
        train_cli.parse_args(['--critic', 'joint'])
