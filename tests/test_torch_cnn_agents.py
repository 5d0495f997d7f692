"""Per-agent cnn actors as one pass (``learn/nets.py::apply_per_agent``)
against the net applied agent by agent (``apply_per_agent_loop``).

The JAX package ``vmap``s ``net.apply`` over the agents' parameter slices
(multigrid_tpu/learn/ppo.py:264-287); the port runs each of the cnn's
convolutions once for all agents, one ``conv2d`` over their channel blocks
with a block-diagonal kernel (the grouped convolution), and its dense
layers as batched products. At view 7 and
hidden 16, for 2 and 3 agents, packed cells and channel triples, with and
without missions, the logits, the value and every parameter's gradient of
``Σ logits·u + Σ value·v`` agree with the loop form:

- float32 nets to ``1e-5`` relative to each tensor's largest magnitude
  (the one and the N convolutions sum in other orders);
- bfloat16 nets (the default) to ``2e-2``, bf16's half-ulp of 2^-9 over the
  five layers the backward passes through: outputs ``max|Δ|/(|want|+1)``,
  gradients ``‖Δ‖/‖want‖``.

``tests/test_torch_cnn.py`` holds the batched actor to flax's ``vmap``.
"""

import numpy as np
import pytest
import torch

from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
from multigrid_tpu_torch.learn import ppo
from multigrid_tpu_torch.learn.nets import ActorCritic, apply_per_agent, apply_per_agent_loop
from multigrid_tpu_torch.parallel import VectorEnv

torch.set_num_threads(1)

VS, HIDDEN, BATCH, MISSIONS = 7, 16, 6, 12
#: (relative tolerance of the outputs, of each gradient) by the net's dtype.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}


def _inputs(rng, n, packed, missions):
    shape = (BATCH, n, VS, VS)
    fields = [rng.integers(0, 11, shape), rng.integers(0, 6, shape), rng.integers(0, 3, shape)]
    if packed:
        image = (fields[0] << 8) | (fields[1] << 4) | fields[2]
        image = image.reshape(BATCH, n, VS * VS)
    else:
        image = np.stack(fields, -1)
    direction = rng.integers(0, 4, (BATCH, n))
    mission = rng.integers(0, MISSIONS, (BATCH, n)) if missions else None
    return (torch.as_tensor(image.astype(np.int32)), torch.as_tensor(direction.astype(np.int32)),
            None if mission is None else torch.as_tensor(mission.astype(np.int32)))


def _stacked(n, packed, missions, dtype):
    nets = [ActorCritic(VS * VS, hidden=HIDDEN, packed_obs=packed, seed=i, dtype=dtype,
                        num_missions=MISSIONS if missions else 0, encoder='cnn')
            for i in range(n)]
    names = [k for k, _ in nets[0].named_parameters()]
    params = {k: torch.stack([dict(m.named_parameters())[k].detach() for m in nets])
              for k in names}
    return nets[0], params


def _outputs_and_grads(fn, net, params, args, u, v):
    leaves = {k: p.clone().requires_grad_(True) for k, p in params.items()}
    logits, value = fn(net, leaves, *args)
    ((logits * u).sum() + (value * v).sum()).backward()
    return logits.detach(), value.detach(), {k: p.grad for k, p in leaves.items()}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('missions', [False, True], ids=['plain', 'missions'])
@pytest.mark.parametrize('packed', [True, False], ids=['packed', 'triples'])
@pytest.mark.parametrize('n', [2, 3])
def test_one_pass_cnn_matches_the_agent_loop(n, packed, missions, dtype):
    rng = np.random.default_rng(n * 8 + packed * 4 + missions * 2 + (dtype == torch.bfloat16))
    net, params = _stacked(n, packed, missions, dtype)
    args = _inputs(rng, n, packed, missions)
    u = torch.as_tensor(rng.standard_normal((BATCH, n, net.num_actions)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((BATCH, n)), dtype=torch.float32)
    got = _outputs_and_grads(apply_per_agent, net, params, args, u, v)
    want = _outputs_and_grads(apply_per_agent_loop, net, params, args, u, v)
    tol_out, tol_grad = TOL[dtype]
    assert got[0].shape == (BATCH, n, net.num_actions) and got[1].shape == (BATCH, n)
    for g, w, name in ((got[0], want[0], 'logits'), (got[1], want[1], 'value')):
        scale = 1.0 if dtype == torch.bfloat16 else float(w.abs().max())
        err = float(((g - w).abs() / (w.abs() + 1)).max()) if dtype == torch.bfloat16 \
            else float((g - w).abs().max()) / scale
        assert err < tol_out, (name, err)
    assert set(got[2]) == set(want[2]) == set(params)
    for k, w in want[2].items():
        g = got[2][k]
        assert g.shape == params[k].shape
        if dtype == torch.bfloat16:
            err = float((g - w).norm() / (w.norm() + 1e-12))
        else:
            err = float((g - w).abs().max()) / (float(w.abs().max()) + 1e-30)
        assert err < tol_grad, (k, err)


def test_train_step_takes_the_one_pass(monkeypatch):
    """``TrainStep.actor`` takes :func:`apply_per_agent` for the cnn, no
    loop over agents: an actor call makes three ``conv2d`` calls for both
    agents, on (2·out, 2·in, 3, 3) block-diagonal kernels, and with the
    per-agent ``functional_call`` (the loop's) made to raise, a rollout and
    an update run; with the loop swapped in for the one pass (as
    ``chip_smoke.py`` compares them), the same update's metrics and
    parameters agree within float32 tolerances."""
    venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2, device='cpu'), 4,
                     packed_obs=True)
    config = PPOConfig(rollout_steps=2, per_agent_policies=True)
    state, net, config, tx = ppo_init(venv, 0, config=config,
                                      net_kwargs=dict(hidden=HIDDEN, encoder='cnn',
                                                      dtype=torch.float32))
    assert state.params['Conv_0.kernel'].shape == (2, 16, 21, 3, 3)
    step = make_train_step(venv, net, config, tx)

    def refuse(*a, **k):
        raise AssertionError('the agent loop ran on the main path')

    convs = []
    conv2d = torch.nn.functional.conv2d
    monkeypatch.setattr(torch.nn.functional, 'conv2d',
                        lambda x, w, *a, **k: convs.append(tuple(w.shape)) or conv2d(x, w, *a, **k))
    obs = state.last_obs
    with torch.no_grad():
        step.actor(state.params, obs['image'], obs['direction'])
    assert convs == [(32, 42, 3, 3), (64, 32, 3, 3), (128, 64, 3, 3)]
    monkeypatch.setattr(ppo, 'functional_call', refuse)
    grouped, metrics = step(state)
    monkeypatch.undo()
    monkeypatch.setattr(ppo, 'apply_per_agent', apply_per_agent_loop)
    looped, want = make_train_step(venv, net, config, tx)(state)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k, p in grouped.params.items():
        np.testing.assert_allclose(p.numpy(), looped.params[k].numpy(), rtol=0,
                                   atol=1e-5 * float(p.abs().max()), err_msg=k)
