"""Tests of the port that need an NVIDIA GPU; they skip without one.

The CUDA kernel has no CPU mode, so these run on the card only. The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from multigrid_tpu_torch.core.state import FIELDS
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.ops import obs_cuda
from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain
from multigrid_tpu_torch.parallel import VectorEnv

from .test_torch_states import random_fields, to_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    return torch.device('cuda')


def _to(state, device):
    return state.replace(**{k: getattr(state, k).to(device) for k in FIELDS})


@pytest.mark.parametrize('stw', [False, True])
@pytest.mark.parametrize('packed', [False, True])
def test_kernel_matches_plain(cuda_device, stw, packed):
    """The CUDA kernel ≡ the plain version on the CPU, bit for bit."""
    for w, h, n, vs in [(16, 16, 4, 7), (13, 25, 3, 13), (8, 8, 1, 3),
                        (5, 5, 8, 11)]:
        state = to_torch(random_fields(w + n + vs, 64, w, h, n, has_boxes=False))
        want = gen_obs_batched_plain(state, vs, stw, packed)
        launches = obs_cuda.launches
        got = obs_cuda.gen_obs_batched(_to(state, cuda_device), vs, stw, packed)
        assert obs_cuda.launches == launches + 1
        assert torch.equal(got.cpu(), want), (w, h, n, vs)


def test_kernel_rejects_what_it_cannot_take(cuda_device):
    state = _to(to_torch(random_fields(0, 4, 8, 8, 9, has_boxes=False)), cuda_device)
    with pytest.raises(ValueError):
        obs_cuda.gen_obs_batched(state, 7, False)
    state = _to(to_torch(random_fields(0, 4, 8, 8, 2, has_boxes=False)), cuda_device)
    with pytest.raises(ValueError):
        obs_cuda.gen_obs_batched(state.replace(grid=state.grid.to(torch.int64)), 7, False)


def test_vector_env_on_the_card_matches_the_cpu(cuda_device):
    """The same actions and orders give the same trajectory on the card
    (kernel) as on the CPU (plain version), auto-resets included."""
    envs = [VectorEnv(make('MultiGrid-Empty-6x6-v0', agents=3, max_steps=12,
                           device=d), 32) for d in ('cpu', cuda_device)]
    states = [venv.reset(seed=0)[1] for venv in envs]
    rng = np.random.default_rng(0)
    episodes = 0
    for t in range(30):
        actions = torch.as_tensor(rng.integers(0, 7, (32, 3)))
        order = torch.as_tensor(np.argsort(rng.random((32, 3)), -1))
        outs = [venv.step(st, actions.to(venv.device), order=order.to(venv.device))
                for venv, st in zip(envs, states)]
        (c_obs, *c_rest), (g_obs, *g_rest) = outs
        assert torch.equal(c_obs['image'], g_obs['image'].cpu()), t
        for k in FIELDS:
            assert torch.equal(getattr(c_rest[0], k), getattr(g_rest[0], k).cpu()), (t, k)
        for a, b in zip(c_rest[1:], g_rest[1:]):
            assert torch.equal(a, b.cpu()), t
        states = [c_rest[0], g_rest[0]]
        episodes += int(c_rest[4].sum())
    assert episodes >= 32  # every env truncated at least once


# ----------------------------------------------------- training kernels


def _packed(rng, b, c, pad=0.0):
    """Packed cells with every channel in use; a share ``pad`` of them the
    pad value, which matches no channel."""
    from multigrid_tpu_torch.ops.fused_linear import PAD_CELL
    cells = (rng.integers(0, 11, (b, c)) << 8) | (rng.integers(0, 6, (b, c)) << 4) \
        | rng.integers(0, 4, (b, c))
    cells = np.where(rng.random((b, c)) < pad, PAD_CELL, cells)
    return torch.as_tensor(cells.astype(np.int32))


def _rel_err(got, want):
    """max |got - want| / (|want| + 1), the bench's tolerance measure."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (want.abs() + 1)).max())


@pytest.mark.parametrize('b,c,h,pad', [(16384, 49, 128, 0.0), (1001, 9, 128, 0.1),
                                       (333, 25, 32, 0.0), (77, 169, 256, 0.2)])
def test_onehot_linear_kernel_matches_plain(cuda_device, b, c, h, pad):
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(b + c + h)
    packed = _packed(rng, b, c, pad).to(cuda_device)
    w = torch.as_tensor(rng.normal(size=(c * fl.NCH, h)).astype(np.float32)).to(cuda_device)
    launches = fl.launches
    got = fl.onehot_linear_forward(packed, w)
    assert fl.launches == launches + 1
    want = fl.onehot_linear_plain(packed, w)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h)
    # bf16 output: the two differ by the rounding of differently ordered f32 sums.
    assert _rel_err(got, want) < 2e-2


@pytest.mark.parametrize('b,c,h', [(262144, 49, 128), (5000, 49, 128), (100, 9, 32),
                                   (300, 25, 256)])
def test_onehot_grad_kernel_matches_plain(cuda_device, b, c, h):
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(b + h)
    packed = _packed(rng, b, c, 0.05).to(cuda_device)
    g = torch.as_tensor(rng.normal(size=(b, h)).astype(np.float32)).to(cuda_device)
    launches = fl.grad_launches
    got = fl.onehot_linear_grad_w(packed, g)
    assert fl.grad_launches == launches + 1
    want = fl.onehot_linear_grad_w_plain(packed, g)
    # f32 sums of the same bf16 values in another order.
    assert float((got - want).abs().max()) <= 1e-4 * (float(want.abs().max()) + 1)
    # The same from run to run: the partial sums are added in a fixed order.
    assert torch.equal(got, fl.onehot_linear_grad_w(packed, g))


def test_onehot_linear_autograd_on_the_card(cuda_device):
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(7)
    packed = _packed(rng, 512, 49).to(cuda_device)
    w = torch.as_tensor(rng.normal(size=(49 * fl.NCH, 64)).astype(np.float32) * 0.1)
    w = w.to(cuda_device).requires_grad_(True)
    g = torch.as_tensor(rng.normal(size=(512, 64)).astype(np.float32)).to(cuda_device)
    before = fl.launches, fl.grad_launches
    (fl.onehot_linear(packed, w).float() * g).sum().backward()
    assert (fl.launches, fl.grad_launches) == (before[0] + 1, before[1] + 1)
    want = fl.onehot_linear_grad_w_plain(packed, g)
    assert float((w.grad - want).abs().max()) <= 1e-4 * (float(want.abs().max()) + 1)


def ppo_inputs(rng, b, c, h, missions, device):
    """Random ``ppo_mlp_grads`` arguments: params, cells, direction (and
    mission) features, actions, old log-probs near the policy's, normalized
    advantages and targets."""
    from multigrid_tpu_torch.learn.nets import PARAM_NAMES
    f = 2 + missions
    shapes = dict(zip(PARAM_NAMES, [(c * 21, h), (f, h), (h,), (h, h), (h,),
                                    (h, 7), (7,), (h, 1), (1,)]))
    params = {k: torch.as_tensor(
        (rng.normal(size=s) / np.sqrt(s[0] if len(s) > 1 else 4)).astype(np.float32))
        for k, s in shapes.items()}
    theta = rng.integers(0, 4, b) * np.pi / 2
    dirf = np.stack([np.cos(theta), np.sin(theta)], -1)
    if missions:
        dirf = np.concatenate([dirf, np.eye(missions)[rng.integers(0, missions, b)]], -1)
    adv = rng.normal(size=b)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    args = [_packed(rng, b, c), torch.as_tensor(dirf.astype(np.float32)),
            torch.as_tensor(rng.integers(0, 7, b).astype(np.int32)),
            torch.as_tensor((np.log(1 / 7) + 0.3 * rng.normal(size=b)).astype(np.float32)),
            torch.as_tensor(adv.astype(np.float32)),
            torch.as_tensor(rng.normal(size=b).astype(np.float32))]
    return ({k: v.to(device) for k, v in params.items()}, [a.to(device) for a in args])


@pytest.mark.parametrize('b,h,missions', [(256, 128, 0), (256, 128, 5), (1000, 32, 0),
                                          (65536, 128, 0)])
def test_ppo_loss_kernel_matches_plain(cuda_device, b, h, missions):
    from multigrid_tpu_torch.ops import fused_ppo
    params, args = ppo_inputs(np.random.default_rng(b + missions), b, 49, h,
                              missions, cuda_device)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)
    launches = fused_ppo.launches
    grads, metrics = fused_ppo.ppo_mlp_grads(params, *args, **kw)
    assert fused_ppo.launches == launches + 1
    want_g, want_m = fused_ppo.ppo_mlp_grads_plain(
        params, *args, compute_dtype=torch.bfloat16, **kw)
    # bf16 operands on both sides, f32 sums in another order (bench.py:85-90).
    for k in want_g:
        assert grads[k].shape == want_g[k].shape, k
        err = float((grads[k] - want_g[k]).abs().max()) / (float(want_g[k].abs().max()) + 1e-6)
        assert err < 5e-2, (k, err)
    for k in want_m:
        err = abs(float(metrics[k]) - float(want_m[k])) / (abs(float(want_m[k])) + 1e-6)
        assert err < 5e-2, (k, err)


def test_train_step_on_the_card(cuda_device):
    """Two PPO updates on the card: 5 forward launches per update (4 steps
    and the last value), the loss kernel once per SGD step, no dW kernel."""
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_ppo
    venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2, device=cuda_device), 64,
                     packed_obs=True)
    state, net, config, tx = ppo_init(venv, 0, config=PPOConfig(rollout_steps=4), hidden=32)
    step = make_train_step(venv, net, config, tx)
    fl.launches = fl.grad_launches = fused_ppo.launches = 0
    for _ in range(2):
        state, metrics = step(state)
    assert (fl.launches, fl.grad_launches, fused_ppo.launches) == (10, 0, 2)
    assert all(np.isfinite(float(metrics[k])) for k in ('loss', 'entropy', 'vf_loss'))
