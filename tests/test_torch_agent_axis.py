"""Per-agent policies on one launch over all agents ≡ the JAX package's vmap.

The JAX package stacks per-agent parameters on a leading axis and
``jax.vmap``s the net and its kernels over it; Pallas's batching rule turns
each kernel into one launch with a leading grid axis over the agents
(multigrid_tpu/learn/ppo.py:264-303, 527-582). The port's counterparts take
(N, ...) tensors in one launch on the card. Here, on the CPU, their plain
versions are held against ``jax.vmap`` of the JAX kernels in Pallas
interpret mode on the same numpy inputs: the first layer (B2), its weight
gradient (B3), the PPO loss (B4), the batched mlp actor and one per-agent
``sgd_step``; then the batched route against the per-agent loop the port
ran before. The card's kernels are held against these plain versions and
against N single-agent launches in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from multigrid_tpu.learn import nets as jax_nets
from multigrid_tpu.ops import fused_linear as jax_fl
from multigrid_tpu.ops import fused_ppo as jax_fp
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import ppo
from multigrid_tpu_torch.learn.nets import ActorCritic, apply_per_agent, params_from_flax
from multigrid_tpu_torch.ops import fused_linear as fl
from multigrid_tpu_torch.ops import fused_ppo
from multigrid_tpu_torch.parallel import VectorEnv

from .test_torch_agents import _compare_sgd_step, setup  # noqa: F401 (a fixture)

torch.set_num_threads(1)

KW = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)


def _packed(rng, shape):
    cells = (rng.integers(0, 11, shape) << 8) | (rng.integers(0, 6, shape) << 4) \
        | rng.integers(0, 4, shape)
    return np.where(rng.random(shape) < 0.05, fl.PAD_CELL, cells).astype(np.int32)


def _dense(rng, fan_in, features):
    return {'kernel': (rng.normal(size=(fan_in, features)) / np.sqrt(fan_in)).astype(np.float32),
            'bias': (0.1 * rng.normal(size=features)).astype(np.float32)}


def _stacked_flax(rng, n, c, h, missions=0):
    """Flax-structured per-agent mlp params, stacked (N, ...), from numpy."""
    inits = [{'params': {'img_kernel': _dense(rng, c * 21, h)['kernel'],
                         'Dense_0': _dense(rng, 2 + missions, h), 'Dense_1': _dense(rng, h, h),
                         'Dense_2': _dense(rng, h, 7), 'Dense_3': _dense(rng, h, 1)}}
             for _ in range(n)]
    return jax.tree.map(lambda *x: np.stack(x), *inits)


@pytest.mark.parametrize('n,c,h', [(2, 49, 32), (3, 9, 16)])
def test_first_layer_twin_is_jax_vmap_bit_for_bit(n, c, h):
    """B2's agent-axis twin ≡ ``jax.vmap(onehot_linear_packed)`` in interpret
    mode, bf16 bit for bit. Both round the weights to bf16 and sum in f32
    in their own orders; the weights lie on a 1/64 grid, so every sum is
    exact in f32 whatever its order, and both outputs round the same value."""
    rng = np.random.default_rng(n + c + h)
    cells = _packed(rng, (n, 64, c))
    w = (rng.integers(-128, 129, (n, c * fl.NCH, h)) / 64).astype(np.float32)
    want = jax.vmap(lambda p, w_: jax_fl.onehot_linear_packed(p, w_, interpret=True))(
        jnp.asarray(cells), jnp.asarray(w))
    got = fl.onehot_linear_agents_forward(torch.as_tensor(cells), torch.as_tensor(w))
    assert got.dtype == torch.bfloat16 and got.shape == (n, 64, h)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # The twin is the single-agent plain version agent by agent.
    for i in range(n):
        assert torch.equal(got[i], fl.onehot_linear_plain(torch.as_tensor(cells[i]),
                                                          torch.as_tensor(w[i])))


@pytest.mark.parametrize('n,c,h', [(2, 49, 32), (3, 25, 16)])
def test_gradient_twin_is_jax_vmap(n, c, h):
    """B3's agent-axis twin ≡ dW through ``jax.vmap`` of the JAX custom VJP
    (the Pallas gradient kernel batched over the agents, interpret mode):
    f32 sums of the same bf16(g), rtol 1e-5. The differentiable wrapper
    takes the agent axis on the CPU with the same result and no launch."""
    rng = np.random.default_rng(10 + n + c)
    cells = _packed(rng, (n, 48, c))
    w = (rng.normal(size=(n, c * fl.NCH, h)) * 0.1).astype(np.float32)
    g = rng.normal(size=(n, 48, h)).astype(np.float32)

    def loss(w_):
        out = jax.vmap(lambda p, wi: jax_fl.onehot_linear(p, wi, True))(jnp.asarray(cells), w_)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    want = np.asarray(jax.grad(loss)(jnp.asarray(w)))
    got = fl.onehot_linear_agents_grad_w(torch.as_tensor(cells), torch.as_tensor(g))
    assert got.dtype == torch.float32 and got.shape == (n, c * fl.NCH, h)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    launches = fl.launches, fl.grad_launches
    wt = torch.as_tensor(w).requires_grad_(True)
    out = fl.onehot_linear(torch.as_tensor(cells), wt)
    assert torch.equal(out, fl.onehot_linear_agents_plain(torch.as_tensor(cells), wt.detach()))
    (out.float() * torch.as_tensor(g)).sum().backward()
    # The cotangent of a bf16 output is bf16: dW sums bf16(g), as above.
    torch.testing.assert_close(wt.grad, got, rtol=0, atol=0)
    assert (fl.launches, fl.grad_launches) == launches  # the CPU launches nothing


def _ppo_case(rng, n, b, c, h, missions):
    params = _stacked_flax(rng, n, c, h, missions)
    theta = rng.integers(0, 4, (n, b)) * np.pi / 2
    dirf = np.stack([np.cos(theta), np.sin(theta)], -1)
    if missions:
        dirf = np.concatenate([dirf, np.eye(missions)[rng.integers(0, missions, (n, b))]], -1)
    adv = rng.normal(size=(n, b))
    adv = (adv - adv.mean(1, keepdims=True)) / (adv.std(1, keepdims=True) + 1e-8)
    args = [_packed(rng, (n, b, c)), dirf.astype(np.float32),
            rng.integers(0, 7, (n, b)).astype(np.int32),
            (np.log(1 / 7) + 0.3 * rng.normal(size=(n, b))).astype(np.float32),
            adv.astype(np.float32), rng.normal(size=(n, b)).astype(np.float32)]
    return params, args


@pytest.mark.parametrize('n,missions', [(2, 0), (3, 4)])
def test_loss_twin_is_jax_vmap(n, missions):
    """B4's agent-axis twin (float32) ≡ ``jax.vmap(ppo_mlp_grads)`` in
    interpret mode (float32, tests/test_fused_ppo.py's per-agent path):
    stacked gradients and per-agent metrics, to the loss kernel's
    tolerances (tests/test_torch_fused_ppo.py, test_torch_agents.py)."""
    rng = np.random.default_rng(20 + n + missions)
    params, args = _ppo_case(rng, n, 64, 49, 32, missions)
    want_g, want_m = jax.vmap(lambda p, *a: jax_fp.ppo_mlp_grads(p, *a, interpret=True, **KW))(
        jax.tree.map(jnp.asarray, params), *map(jnp.asarray, args))
    grads, metrics = fused_ppo.ppo_mlp_grads_agents(
        params_from_flax(params), *(torch.as_tensor(a) for a in args), **KW)
    for k, v in jax.device_get(want_m).items():
        assert metrics[k].shape == (n,), k
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(v), rtol=2e-5, atol=1e-6,
                                   err_msg=k)
    want = params_from_flax(jax.device_get(want_g))
    assert set(grads) == set(want)
    for k in want:
        assert grads[k].shape == want[k].shape, k
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(), rtol=5e-4, atol=1e-6,
                                   err_msg=k)


def _jax_apply_net(jnet, params, image, direction, mission, fused):
    """The JAX train step's per-agent ``apply_net`` (ppo.py:269-285): the
    agent axis to the front, ``vmap`` of ``net.apply`` over the stacked
    parameters, the agent axis back."""
    img = jnp.moveaxis(image, -2, 0)
    dirn = jnp.moveaxis(direction, -1, 0)
    if mission is None:
        logits, value = jax.vmap(lambda p, i, d: jnet.apply(p, i, d, fused=fused))(
            params, img, dirn)
    else:
        logits, value = jax.vmap(lambda p, i, d, m: jnet.apply(p, i, d, m, fused=fused))(
            params, img, dirn, jnp.moveaxis(mission, -1, 0))
    return jnp.moveaxis(logits, 0, -2), jnp.moveaxis(value, 0, -1)


@pytest.mark.parametrize('fused', ['interpret', False], ids=['jax-kernel', 'jax-xla'])
@pytest.mark.parametrize('missions', [0, 3])
def test_batched_actor_matches_jax_per_agent_apply(missions, fused):
    """The batched mlp actor ≡ the JAX per-agent ``apply_net`` on the same
    stacked weights (``params_from_flax``) and (T, E, N) observations, with
    the first layer through JAX's vmapped kernel (interpret mode, as the
    per-agent rollout takes it) or XLA's one-hot product: logits and values
    to bf16 rounding (tests/test_torch_nets.py's tolerance)."""
    rng = np.random.default_rng(30 + missions)
    n, c, h = 3, 49, 32
    jnet = jax_nets.ActorCritic(encoder='mlp', packed_obs=True, hidden=h, num_missions=missions)
    params = _stacked_flax(rng, n, c, h, missions)
    image = _packed(rng, (2, 8, n, c))
    direction = rng.integers(0, 4, (2, 8, n)).astype(np.int32)
    mission = rng.integers(0, missions, (2, 8, n)).astype(np.int32) if missions else None
    want_l, want_v = _jax_apply_net(jnet, params, jnp.asarray(image), jnp.asarray(direction),
                                    None if mission is None else jnp.asarray(mission), fused)
    net = ActorCritic(c, hidden=h, packed_obs=True, encoder='mlp', num_missions=missions)
    with torch.no_grad():
        logits, value = apply_per_agent(
            net, params_from_flax(params), torch.as_tensor(image), torch.as_tensor(direction),
            None if mission is None else torch.as_tensor(mission))
    assert logits.dtype == value.dtype == torch.float32
    assert logits.shape == (2, 8, n, 7) and value.shape == (2, 8, n)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_l), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_v), rtol=2e-2, atol=2e-2)


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, counted)


def test_sgd_step_on_the_batched_route_matches_jax(setup, monkeypatch):  # noqa: F811
    """One per-agent ``sgd_step`` on the loss kernel's route ≡ the JAX
    package's ``_sgd_step_kernel_per_agent`` (interpret mode), through
    ``_compare_sgd_step``'s harness at its loss-kernel tolerances: the port
    makes one agent-axis loss call for all agents and no single-agent one."""
    calls = {}
    _counting(monkeypatch, fused_ppo, 'ppo_mlp_grads_agents', calls)
    _counting(monkeypatch, fused_ppo, 'ppo_mlp_grads', calls)
    _compare_sgd_step(setup, True, False, True, monkeypatch, grad_tol=5e-4, metric_tol=2e-5)
    assert calls == {'ppo_mlp_grads_agents': 1}


# ------------------------------------------- the batched route against the loop


def _loop_actor(net, params, image, direction, mission):
    """The per-agent loop the port ran before the agent axis: agent ``i``'s
    parameter slice on agent ``i``'s contiguous observations, one net call
    (one first-layer launch on the card) an agent."""
    image = image.movedim(image.dim() - (2 if net.packed_obs else 4), 0).contiguous()
    outs = [functional_call(net, {k: v[i] for k, v in params.items()},
                            (image[i], direction[..., i],
                             None if mission is None else mission[..., i]))
            for i in range(direction.shape[-1])]
    return torch.stack([o[0] for o in outs], -2), torch.stack([o[1] for o in outs], -1)


@pytest.mark.parametrize('packed', [True, False], ids=['packed', 'images'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=['bf16', 'f32'])
def test_batched_actor_matches_the_loop(dtype, packed):
    """The batched actor ≡ the loop, forward and autograd: bit for bit in
    bf16 (the CPU's batched and single products round alike); in float32 to
    1e-6 (a batched product may sum in another order). Its first layer on
    packed cells is one call of the agent-axis wrapper, with the kernel's
    contiguous (N, B, C) rows."""
    rng = np.random.default_rng(40)
    n, vs, h, missions = 3, 5, 16, 4
    nets = [ActorCritic(vs * vs, hidden=h, packed_obs=packed, dtype=dtype, encoder='mlp',
                        seed=i, num_missions=missions) for i in range(n)]
    params = {k: torch.stack([m.state_dict()[k] for m in nets]) for k in nets[0].state_dict()}
    if packed:
        image = torch.as_tensor(_packed(rng, (2, 6, n, vs * vs)))
    else:
        image = torch.as_tensor(np.stack([rng.integers(0, 11, (2, 6, n, vs, vs)),
                                          rng.integers(0, 6, (2, 6, n, vs, vs)),
                                          rng.integers(0, 4, (2, 6, n, vs, vs))], -1)
                                .astype(np.int32))
    direction = torch.as_tensor(rng.integers(0, 4, (2, 6, n)))
    mission = torch.as_tensor(rng.integers(0, missions, (2, 6, n)))
    g = torch.as_tensor(rng.normal(size=(2, 6, n, 7)).astype(np.float32))
    outs, grads = [], []
    for fn in (apply_per_agent, _loop_actor):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        logits, value = fn(nets[0], leaves, image, direction, mission)
        ((logits * g).sum() + value.sum()).backward()
        outs.append((logits.detach(), value.detach()))
        grads.append({k: v.grad for k, v in leaves.items()})
    tol = dict(rtol=0, atol=0) if dtype == torch.bfloat16 else dict(rtol=1e-6, atol=1e-6)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, **tol)
    for k in params:
        torch.testing.assert_close(grads[0][k], grads[1][k], **tol, msg=k)


def test_loss_grads_match_the_per_agent_loop():
    """The learner's one agent-axis loss call ≡ the loop of single-agent
    calls it replaces (each agent's grads over N, the metrics' mean), bit
    for bit on the CPU."""
    rng = np.random.default_rng(50)
    n, e, t = 3, 16, 2
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=n, device='cpu'), e,
                     packed_obs=True)
    state, net, config, tx = ppo.ppo_init(venv, 3, config=ppo.PPOConfig(
        rollout_steps=t, per_agent_policies=True), hidden=32, net_kwargs=dict(encoder='mlp'))
    step = ppo.make_train_step(venv, net, config, tx)
    state, traj, last_value, _ = step.rollout_phase(state)
    adv, tg = step.compute_gae(traj, last_value)
    adv = adv + torch.as_tensor(rng.normal(size=adv.shape).astype(np.float32))
    grads, metrics = step.loss_grads(state.params, traj, adv, tg)
    args = step.kernel_inputs(traj, adv, tg)
    per = [fused_ppo.ppo_mlp_grads({k: v[i] for k, v in state.params.items()},
                                   *(a[i] for a in args), **KW) for i in range(n)]
    for k in state.params:
        assert torch.equal(grads[k], torch.stack([g[k] for g, _ in per]) / n), k
    for k in metrics:
        assert torch.equal(metrics[k], torch.stack([m[k] for _, m in per]).mean()), k


@pytest.mark.parametrize('gate', [True, False], ids=['loss-kernel', 'gate-off'])
def test_update_calls_each_wrapper_once_for_all_agents(gate, monkeypatch):
    """A per-agent mlp update makes one first-layer call a rollout step (and
    one for the last value), one loss call an SGD step (gate off: one
    first-layer and one gradient call an SGD step), each over all agents,
    and no single-agent call: on the card, one launch each (chip_smoke.py's
    ``variants`` counts them)."""
    if not gate:
        monkeypatch.setattr(fused_ppo, 'supports', lambda *a: False)
    calls = {}
    for name in ('onehot_linear_agents_forward', 'onehot_linear_agents_grad_w',
                 'onehot_linear_forward', 'onehot_linear_grad_w'):
        _counting(monkeypatch, fl, name, calls)
    for name in ('ppo_mlp_grads_agents', 'ppo_mlp_grads'):
        _counting(monkeypatch, fused_ppo, name, calls)
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'), 8,
                     packed_obs=True)
    config = ppo.PPOConfig(rollout_steps=3, per_agent_policies=True, epochs=2)
    state, net, config, tx = ppo.ppo_init(venv, 4, config=config, hidden=32,
                                          net_kwargs=dict(encoder='mlp'))
    state, metrics = ppo.make_train_step(venv, net, config, tx)(state)
    assert np.isfinite(float(metrics['loss']))
    want = ({'onehot_linear_agents_forward': 4, 'ppo_mlp_grads_agents': 2} if gate else
            {'onehot_linear_agents_forward': 4 + 2, 'onehot_linear_agents_grad_w': 2})
    assert calls == want


def test_wrappers_take_only_their_rank():
    """Each wrapper's shapes: the agent-axis wrappers take (N, B, C) cells,
    the single-agent ones (B, C); the gradient kernel's plan shares the SMs'
    one wave among the agents."""
    rng = np.random.default_rng(60)
    cells = torch.as_tensor(_packed(rng, (2, 8, 9)))
    w = torch.as_tensor(rng.normal(size=(2, 9 * fl.NCH, 16)).astype(np.float32))
    assert fl.onehot_linear_agents_forward(cells, w).shape == (2, 8, 16)
    assert fl.onehot_linear(cells, w).shape == (2, 8, 16)
    assert fl.onehot_linear(cells[0], w[0]).shape == (8, 16)
    with pytest.raises(ValueError, match=r'\(N, B, C\)'):
        fl._check_shapes(cells[0], 16, agents=True)
    with pytest.raises(ValueError, match=r'\(B, C\)'):
        fl._check_shapes(cells, 16)
    for c, h, sms in [(49, 128, 132), (196, 256, 132), (9, 32, 20)]:
        tiles = -(-c // fl.GRAD_CELLS_PER_BLOCK) * -(-h // fl.GRAD_COLS_PER_BLOCK)
        for agents in (1, 2, 4):
            chunks, chunk = fl.grad_plan(65536, c, h, sms, agents)
            assert chunk % fl.GRAD_STAGE == 0 and (chunks - 1) * chunk < 65536 <= chunks * chunk
            assert tiles * chunks * agents <= max(sms, tiles * agents)
            assert (chunks, chunk) == fl.grad_plan(65536, c, h, sms, agents)  # fixed
    assert fl.grad_plan(65536, 49, 128, 132, 1) == fl.grad_plan(65536, 49, 128, 132)
