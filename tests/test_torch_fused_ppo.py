"""The PPO loss's gradients ≡ the JAX package's fused PPO-loss kernel.

The plain version in float32 is held against ``ppo_mlp_grads`` run in
Pallas interpret mode (which computes in float32) on the same numpy inputs,
at B 256, C 49, with and without mission features, to the tolerances of
tests/test_fused_ppo.py:86-97; and against autograd of the same loss
written out in PyTorch. The CUDA kernel is held against the plain version
in bfloat16 on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.ops import fused_ppo as jax_fp
from multigrid_tpu_torch.learn.nets import PARAM_NAMES, params_from_flax, params_to_flax
from multigrid_tpu_torch.ops import fused_ppo

torch.set_num_threads(1)

B, C, H = 256, 49, 32
KW = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)


def make_inputs(missions, seed=0):
    """(params as flax numpy, numpy args) from one seed."""
    rng = np.random.default_rng(seed)
    f = 2 + missions
    shapes = dict(zip(PARAM_NAMES, [(C * 21, H), (f, H), (H,), (H, H), (H,),
                                    (H, 7), (7,), (H, 1), (1,)]))
    params = {k: (rng.normal(size=s) / np.sqrt(s[0] if len(s) > 1 else 4)).astype(np.float32)
              for k, s in shapes.items()}
    cells = (rng.integers(0, 11, (B, C)) << 8) | (rng.integers(0, 6, (B, C)) << 4) \
        | rng.integers(0, 4, (B, C))
    theta = rng.integers(0, 4, B) * np.pi / 2
    dirf = np.stack([np.cos(theta), np.sin(theta)], -1)
    if missions:
        dirf = np.concatenate([dirf, np.eye(missions)[rng.integers(0, missions, B)]], -1)
    adv = rng.normal(size=B)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    args = [cells.astype(np.int32), dirf.astype(np.float32),
            rng.integers(0, 7, B).astype(np.int32),
            (np.log(1 / 7) + 0.3 * rng.normal(size=B)).astype(np.float32),
            adv.astype(np.float32), rng.normal(size=B).astype(np.float32)]
    return params_to_flax({k: torch.as_tensor(v) for k, v in params.items()}), args


@pytest.fixture(scope='module', params=[0, 5], ids=['missions0', 'missions5'])
def case(request):
    """Inputs and the JAX kernel's result, computed once per case."""
    params, args = make_inputs(request.param)
    grads, metrics = jax_fp.ppo_mlp_grads(
        jax.tree.map(jnp.asarray, params), *map(jnp.asarray, args), interpret=True, **KW)
    return params, args, jax.device_get(grads), jax.device_get(metrics)


def _torch_args(args):
    return [torch.as_tensor(a) for a in args]


def test_plain_matches_jax_interpret(case):
    params, args, want_grads, want_metrics = case
    grads, metrics = fused_ppo.ppo_mlp_grads(
        params_from_flax(params), *_torch_args(args), **KW)
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    want = params_from_flax(want_grads)
    assert set(grads) == set(want)
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(),
                                   rtol=5e-4, atol=1e-6, err_msg=k)


def test_plain_matches_autograd(case):
    """The hand-written backward ≡ autograd of the same f32 loss."""
    params, args, _, _ = case
    p = {k: v.requires_grad_(True) for k, v in params_from_flax(params).items()}
    packed, dirf, action, old_logp, adv, target = _torch_args(args)
    one_hot = torch.nn.functional.one_hot
    onehot = torch.cat([one_hot((packed >> 8).long(), 11),
                        one_hot(((packed >> 4) & 15).long(), 6),
                        one_hot((packed & 15).long(), 4)], -1).float()
    h = onehot.flatten(1) @ p['img_kernel'] + dirf @ p['Dense_0.kernel'] + p['Dense_0.bias']
    x2 = torch.relu(torch.relu(h) @ p['Dense_1.kernel'] + p['Dense_1.bias'])
    logp = torch.log_softmax(x2 @ p['Dense_2.kernel'] + p['Dense_2.bias'], -1)
    value = (x2 @ p['Dense_3.kernel'] + p['Dense_3.bias'])[:, 0]
    ratio = torch.exp(logp.gather(-1, action.long()[:, None])[:, 0] - old_logp)
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 0.8, 1.2) * adv).mean()
    vf = 0.5 * ((value - target) ** 2).mean()
    ent = -(logp.exp() * logp).sum(-1).mean()
    (pg + 0.5 * vf - 0.01 * ent).backward()
    grads, metrics = fused_ppo.ppo_mlp_grads_plain(
        {k: v.detach() for k, v in p.items()}, packed, dirf, action, old_logp, adv,
        target, **KW)
    np.testing.assert_allclose(float(metrics['entropy']), float(ent.detach()), rtol=1e-5)
    for k in p:
        np.testing.assert_allclose(grads[k].numpy(), p[k].grad.numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def test_bf16_plain_stays_near_f32():
    """The card's compute type moves the result by bf16 rounding only."""
    params, args = make_inputs(0, seed=3)
    p, a = params_from_flax(params), _torch_args(args)
    g32, m32 = fused_ppo.ppo_mlp_grads_plain(p, *a, **KW)
    g16, m16 = fused_ppo.ppo_mlp_grads_plain(p, *a, compute_dtype=torch.bfloat16, **KW)
    for k in g32:
        err = float((g16[k] - g32[k]).abs().max()) / (float(g32[k].abs().max()) + 1e-6)
        assert err < 5e-2, k
    for k in m32:
        assert abs(float(m16[k]) - float(m32[k])) <= 5e-2 * abs(float(m32[k])) + 1e-3, k


def test_supports():
    assert fused_ppo.supports(262144, 128, 7)
    assert fused_ppo.supports(100, 32, 8)
    assert not fused_ppo.supports(262144, 96, 7)
    assert not fused_ppo.supports(262144, 128, 9)
    assert not fused_ppo.supports(0, 128, 7)
