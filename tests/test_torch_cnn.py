"""The port's cnn ``ActorCritic`` ≡ the JAX package's flax module
(``ActorCritic(encoder='cnn')``, multigrid_tpu/learn/nets.py:120-133).

The same weights (carried across with ``params_from_flax``, whose conv
kernels go from flax's HWIO to torch's OIHW) and the same seeded numpy
observations go through both: images and packed cells, views 7 and 9 (at 7
the last map is 1x1 and hides the flatten order; at 9 it is 3x3), with
and without 12 missions. Float32 nets agree to float32 rounding (rtol and
atol 1e-5: the convolutions sum in other orders); bf16 nets to bf16
rounding (rtol and atol 2e-2, as the mlp in tests/test_torch_nets.py: a
bf16 result may differ in its last bit, 2**-8 relative, and carry it on).
Gradients of a scalar of the outputs against ``jax.grad``, in float32, to
1e-4 of each leaf's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.envs import make as jax_make
from multigrid_tpu.learn import nets as jax_nets
from multigrid_tpu.learn import ppo_init as jax_ppo_init
from multigrid_tpu.parallel.vector import VectorEnv as JaxVectorEnv
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
from multigrid_tpu_torch.learn.nets import ActorCritic, params_from_flax, params_to_flax
from multigrid_tpu_torch.parallel import VectorEnv

from .test_torch_nets import _packed, _triples

torch.set_num_threads(1)

DTYPES = {'float32': (jnp.float32, torch.float32, 1e-5),
          'bfloat16': (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(rng, lead, vs, packed, missions):
    image = _packed(rng, lead + (vs * vs,)) if packed else _triples(rng, lead + (vs, vs))
    direction = rng.integers(0, 4, lead).astype(np.int32)
    mission = rng.integers(0, missions, lead).astype(np.int32) if missions else None
    return image, direction, mission


def _flax(vs, packed, missions, hidden, dtype, seed):
    net = jax_nets.ActorCritic(encoder='cnn', packed_obs=packed, hidden=hidden,
                               num_missions=missions, dtype=dtype)
    image = jnp.zeros((vs * vs,) if packed else (vs, vs, 3), jnp.int32)
    mission = jnp.zeros((), jnp.int32) if missions else None
    params = net.init(jax.random.key(seed), image, jnp.zeros((), jnp.int32), mission)
    return net, jax.device_get(params)


def _port(vs, packed, missions, hidden, dtype, params):
    net = ActorCritic(vs * vs, hidden=hidden, packed_obs=packed, num_missions=missions,
                      dtype=dtype, encoder='cnn')
    net.load_state_dict(params_from_flax(params))  # names and shapes are the module's
    return net


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('missions', [0, 12])
@pytest.mark.parametrize('packed', [False, True])
@pytest.mark.parametrize('vs', [7, 9])
def test_cnn_matches_flax(vs, packed, missions, dtype):
    jdtype, tdtype, tol = DTYPES[dtype]
    rng = np.random.default_rng(vs + 2 * packed + missions)
    image, direction, mission = _inputs(rng, (5, 2), vs, packed, missions)
    net_j, params = _flax(vs, packed, missions, 32, jdtype, vs)
    want = net_j.apply(params, jnp.asarray(image), jnp.asarray(direction), _j(mission))
    net = _port(vs, packed, missions, 32, tdtype, params)
    with torch.no_grad():
        got = net(torch.as_tensor(image), torch.as_tensor(direction), _t(mission))
    assert got[0].shape == (5, 2, 7) and got[1].shape == (5, 2)
    assert got[0].dtype == got[1].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


def test_params_round_trip_and_layout():
    """params_to_flax(params_from_flax(p)) == p; the port keeps torch's
    OIHW conv kernels and flax's (in, out) dense kernels."""
    _, params = _flax(9, True, 12, 32, jnp.float32, 0)
    state = params_from_flax(params)
    assert state['Conv_0.kernel'].shape == (16, 21, 3, 3)
    assert state['Conv_2.kernel'].shape == (64, 32, 3, 3)
    assert state['Dense_0.kernel'].shape == (14, 16) and 'Dense_0.bias' not in state
    assert state['Dense_1.kernel'].shape == (3 * 3 * 64, 32)
    np.testing.assert_array_equal(state['Conv_1.kernel'][5, 3].numpy(),
                                  params['params']['Conv_1']['kernel'][:, :, 3, 5])
    back = params_to_flax(state)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    ours = ActorCritic(81, hidden=32, packed_obs=True, num_missions=12, encoder='cnn')
    assert {k: v.shape for k, v in ours.state_dict().items()} == \
        {k: v.shape for k, v in state.items()}


@pytest.mark.parametrize('packed', [False, True])
@pytest.mark.parametrize('vs', [7, 9])
def test_cnn_gradients_match_jax(vs, packed):
    """d/dθ of Σ logits·u + Σ value·v, float32 nets, 12 missions."""
    rng = np.random.default_rng(10 + vs + packed)
    image, direction, mission = _inputs(rng, (6, 2), vs, packed, 12)
    u = rng.normal(size=(6, 2, 7)).astype(np.float32)
    v = rng.normal(size=(6, 2)).astype(np.float32)
    net_j, params = _flax(vs, packed, 12, 32, jnp.float32, 1)

    def scalar(p):
        logits, value = net_j.apply(p, jnp.asarray(image), jnp.asarray(direction),
                                    jnp.asarray(mission))
        return (logits * u).sum() + (value * v).sum()

    want = params_from_flax(jax.device_get(jax.grad(scalar)(params)))
    net = _port(vs, packed, 12, 32, torch.float32, params)
    logits, value = net(torch.as_tensor(image), torch.as_tensor(direction), _t(mission))
    ((logits * torch.as_tensor(u)).sum() + (value * torch.as_tensor(v)).sum()).backward()
    got = dict(net.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].grad
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()), err_msg=k)


def test_per_agent_cnn_actors_match_flax_vmap():
    """Per-agent cnn policies: ``ppo_init`` stacks each agent's parameters
    and ``TrainStep.actor`` applies agent i's slice to agent i's packed
    cells, as the JAX package vmaps ``net.apply`` over the agent axis."""
    venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2, device='cpu'), 4, packed_obs=True)
    config = PPOConfig(rollout_steps=2, per_agent_policies=True)
    state, net, config, tx = ppo_init(venv, 0, config=config,
                                      net_kwargs=dict(hidden=32, encoder='cnn',
                                                      dtype=torch.float32))
    assert net.encoder == 'cnn' and state.params['Conv_0.kernel'].shape == (2, 16, 21, 3, 3)
    step = make_train_step(venv, net, config, tx)
    obs = state.last_obs
    with torch.no_grad():
        logits, value = step.actor(state.params, obs['image'], obs['direction'])
    net_j = jax_nets.ActorCritic(encoder='cnn', packed_obs=True, hidden=32, dtype=jnp.float32)
    params = params_to_flax(state.params)
    want_l, want_v = jax.vmap(net_j.apply, in_axes=(0, 1, 1), out_axes=(1, 1))(
        params, jnp.asarray(obs['image'].numpy()), jnp.asarray(obs['direction'].numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_l), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-5)


def test_default_net_is_the_jax_packages():
    """``ppo_init`` with no net and no encoder builds the cnn, as the JAX
    package's does (multigrid_tpu/learn/nets.py:80, ppo.py:175-178): the
    same parameter names and shapes on Empty-5x5 at hidden 16. Its
    ``per_agent_policies`` keyword is the config field's alias, as there
    (ppo.py:146, 167-168)."""
    jvenv = JaxVectorEnv(jax_make('MultiGrid-Empty-5x5-v0', agents=2), 2, use_pallas_obs=False)
    jstate, jnet, *_ = jax_ppo_init(jvenv, jax.random.key(0), net_kwargs=dict(hidden=16))
    want = {k: tuple(v.shape) for k, v in params_from_flax(jax.device_get(jstate.params)).items()}
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'), 2)
    state, net, config, _ = ppo_init(venv, 0, hidden=16)
    assert net.encoder == jnet.encoder == 'cnn' and not config.per_agent_policies
    assert {k: tuple(v.shape) for k, v in state.params.items()} == want
    assert 'Conv_0.kernel' in want and 'img_kernel' not in want
    state, _, config, _ = ppo_init(venv, 0, hidden=16, per_agent_policies=True)
    assert config.per_agent_policies and state.params['Conv_0.kernel'].shape == (2, 16, 21, 3, 3)


def test_small_views_raise_as_in_jax():
    """Views under 7 leave no map after three VALID convolutions; flax's
    init raises ZeroDivisionError there, and so does the port."""
    net = jax_nets.ActorCritic(encoder='cnn', hidden=8)
    with pytest.raises(ZeroDivisionError):
        net.init(jax.random.key(0), jnp.zeros((5, 5, 3), jnp.int32), jnp.zeros((), jnp.int32))
    for vs in (3, 5):
        with pytest.raises(ZeroDivisionError, match='at least 7'):
            ActorCritic(vs * vs, hidden=8, encoder='cnn')
    with pytest.raises(ValueError, match='encoder'):
        ActorCritic(49, encoder='resnet')


def test_cnn_actor_trains_through_autograd(monkeypatch):
    """A cnn actor takes none of the mlp's kernels: with the first-layer,
    loss and policy kernels' wrappers made to raise (and the fused policy
    asked for), an update runs through autograd and moves every parameter
    in the loss; a centralized critic beside it stays the mlp."""
    from multigrid_tpu_torch.ops import fused_linear, fused_policy, fused_ppo

    def refuse(*a, **k):
        raise AssertionError('a kernel wrapper was called for a cnn actor')

    monkeypatch.setenv('MULTIGRID_FUSED_POLICY', '1')
    venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2, device='cpu'), 4, packed_obs=True)
    for critic in (False, True):
        state, net, config, tx = ppo_init(
            venv, 0, config=PPOConfig(rollout_steps=3, centralized_critic=critic),
            net_kwargs=dict(hidden=16, encoder='cnn'))
        with monkeypatch.context() as m:
            m.setattr(fused_ppo, 'ppo_mlp_grads', refuse)
            m.setattr(fused_policy, 'policy_sample_prepared', refuse)
            if not critic:
                m.setattr(fused_linear, 'onehot_linear', refuse)
            step = make_train_step(venv, net, config, tx)
            assert not step.fused_policy
            new, metrics = step(state)
        assert np.isfinite(float(metrics['loss']))
        for k, v in state.params.items():
            # The critic's value replaces the actor's own head, out of the loss.
            if not k.startswith('actor.Dense_3'):
                assert not torch.equal(v, new.params[k]), k
        if critic:
            assert new.params['critic.Dense_0.kernel'].shape == (2 * 49 * 21, 16)
            assert new.params['actor.Conv_0.kernel'].shape == (16, 21, 3, 3)
