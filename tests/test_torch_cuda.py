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


@pytest.mark.parametrize('e,n', [(1, 4), (7, 1), (9, 8), (4097, 4), (1001, 8), (999, 1)])
def test_kernel_matches_plain_at_any_env_count(cuda_device, e, n):
    """Env counts that fill no whole block, one agent and eight, ≡ the
    plain version bit for bit, as images and packed cells."""
    state = to_torch(random_fields(e + n, e, 16, 16, n, has_boxes=False))
    for packed in (False, True):
        want = gen_obs_batched_plain(state, 7, False, packed)
        got = obs_cuda.gen_obs_batched(_to(state, cuda_device), 7, False, packed)
        assert torch.equal(got.cpu(), want), (e, n, packed)


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


@pytest.mark.parametrize('b,c,h,pad', [
    (16384, 49, 128, 0.0), (1001, 9, 128, 0.1), (333, 25, 32, 0.0), (77, 169, 256, 0.2),
    # per-agent and critic shapes, every width, a ragged batch with pad cells
    (4096, 49, 128, 0.0), (4096, 196, 128, 0.0), (4096, 49, 32, 0.0), (4096, 49, 64, 0.0),
    (4096, 49, 100, 0.05), (4096, 49, 256, 0.0), (4096, 196, 100, 0.05), (1001, 49, 128, 0.1),
    (1001, 49, 7, 0.1)])
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
                                   (300, 25, 256),
                                   # the centralized critic's shape, a single sample
                                   (65536, 196, 128), (1, 49, 64)])
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
                                          (65536, 128, 0), (65536, 64, 0), (65536, 32, 0),
                                          (1001, 128, 0), (1001, 64, 3), (4097, 32, 5)])
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
    # The same from run to run: per-block partials summed in a fixed order.
    again, again_m = fused_ppo.ppo_mlp_grads(params, *args, **kw)
    for k in grads:
        assert torch.equal(grads[k], again[k]), k
    for k in metrics:
        assert torch.equal(metrics[k], again_m[k]), k


def test_first_layer_and_loss_kernels_run_on_the_tensor_cores(cuda_device):
    """The SASS of the first-layer kernel (B2) and of the loss kernel (B4),
    every width built, holds tensor-core instructions."""
    from multigrid_tpu_torch.utils import build
    ops = {**build.tensor_core_ops('fused_linear.cu'), **build.tensor_core_ops('fused_ppo.cu')}
    for kernel in ('onehot_linear_kernel', 'ppo_loss_kernel'):
        names = [n for n in ops if kernel in n]
        assert names, kernel
        for n in names:
            assert any(op.startswith(('HMMA', 'HGMMA')) for op in ops[n]), n


def test_gradient_kernel_runs_on_the_tensor_cores(cuda_device):
    """The SASS of the weight-gradient kernel (B3), every width built,
    holds tensor-core instructions."""
    from multigrid_tpu_torch.utils import build
    ops = build.tensor_core_ops('fused_linear.cu')
    names = [n for n in ops if 'onehot_grad_kernel' in n]
    assert names
    for n in names:
        assert any(op.startswith(('HMMA', 'HGMMA')) for op in ops[n]), n


def test_float32_nets_take_the_first_layer_kernel_on_the_card(cuda_device):
    """A float32 net on packed cells runs its first layer, and the
    centralized critic's over N·C cells, through the kernel on the card (as
    the JAX package's fused path does whatever the dtype), and agrees with
    the same net's float32 one-hot product on the CPU."""
    from multigrid_tpu_torch.learn.nets import ActorCritic, make_centralized_critic
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(11)
    image = _packed(rng, 64, 49).reshape(32, 2, 49)
    direction = torch.as_tensor(rng.integers(0, 4, (32, 2)))
    outs = []
    for dev, kernels in ((torch.device('cpu'), 0), (cuda_device, 2)):
        net = ActorCritic(49, hidden=64, packed_obs=True, dtype=torch.float32).to(dev)
        critic = make_centralized_critic(net, 2).to(dev)
        before = fl.launches
        outs.append((*net(image.to(dev), direction.to(dev)),
                     critic(image.to(dev), direction.to(dev))))
        assert fl.launches == before + kernels
    for g, w in zip(outs[1], outs[0]):
        assert g.dtype == torch.float32
        assert _rel_err(g.cpu(), w) < 2e-2


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


def _policy_inputs(rng, b, c, h, f, device):
    """Prepared fused-policy operands (bf16 on the card), cells, direction
    (and mission) features and Gumbel noise."""
    from multigrid_tpu_torch.ops import fused_policy
    shapes = {'img_kernel': (c * 21, h), 'Dense_0.kernel': (f, h), 'Dense_0.bias': (h,),
              'Dense_1.kernel': (h, h), 'Dense_1.bias': (h,), 'Dense_2.kernel': (h, 7),
              'Dense_2.bias': (7,), 'Dense_3.kernel': (h, 1), 'Dense_3.bias': (1,)}
    params = {k: torch.as_tensor((rng.normal(size=s) / np.sqrt(s[0] if len(s) > 1 else 4))
                                 .astype(np.float32)).to(device) for k, s in shapes.items()}
    theta = rng.integers(0, 4, b) * np.pi / 2
    dirf = np.stack([np.cos(theta), np.sin(theta)], -1)
    if f > 2:
        dirf = np.concatenate([dirf, np.eye(f - 2)[rng.integers(0, f - 2, b)]], -1)
    args = [_packed(rng, b, c, 0.05), torch.as_tensor(dirf.astype(np.float32)),
            torch.as_tensor(rng.gumbel(size=(b, 7)).astype(np.float32))]
    return fused_policy.prepare(params), [a.to(device) for a in args]


@pytest.mark.parametrize('b,c,h,f', [(16384, 49, 128, 2), (1001, 9, 32, 14),
                                     (333, 25, 256, 2), (64, 49, 64, 5)])
def test_policy_sample_kernel_matches_plain(cuda_device, b, c, h, f):
    """The fused-policy kernel ≡ its bf16 plain version: the same action on
    every row whose top-two perturbed logits are more than 1e-3 apart, the
    same log-prob where the actions agree, and the value, within
    2e-2·(|want| + 1) (sums in another order round to bf16 elsewhere)."""
    from multigrid_tpu_torch.ops import fused_policy
    w, (packed, dirf, gumbel) = _policy_inputs(np.random.default_rng(b + h), b, c, h, f,
                                               cuda_device)
    launches = fused_policy.launches
    action, logp, value = fused_policy.policy_sample_prepared(w, packed, dirf, gumbel)
    assert fused_policy.launches == launches + 1
    want_a, want_lp, want_v = fused_policy.policy_sample_plain(
        w, packed, dirf, gumbel, compute_dtype=torch.bfloat16)
    assert action.dtype == torch.int32 and action.shape == (b,)
    logits, _ = fused_policy.policy_heads_plain(w, packed, dirf, compute_dtype=torch.bfloat16)
    top2 = (logits + gumbel).topk(2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(action[clear], want_a[clear])
    same = action == want_a
    assert float(((logp - want_lp).abs() / (want_lp.abs() + 1))[same].max()) < 2e-2
    assert float(((value - want_v).abs() / (want_v.abs() + 1)).max()) < 2e-2


def test_policy_sample_kernel_takes_the_first_index_on_a_tie(cuda_device):
    """Two identical Wa columns and biases and equal noise, far above the
    other actions: the kernel picks the lower index on every row."""
    from multigrid_tpu_torch.ops import fused_policy
    w, (packed, dirf, gumbel) = _policy_inputs(np.random.default_rng(3), 4096, 49, 128, 2,
                                               cuda_device)
    w['wa'][:, 5] = w['wa'][:, 2]
    w['ba'][:] = -30.0
    w['ba'][[2, 5]] = 1.0
    gumbel[:] = 0.0
    gumbel[:, [2, 5]] = 0.25
    action, _, _ = fused_policy.policy_sample_prepared(w, packed, dirf, gumbel)
    assert (action == 2).all()
