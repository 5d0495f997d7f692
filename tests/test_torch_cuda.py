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


@pytest.mark.parametrize('n', [9, 16, 33])
@pytest.mark.parametrize('vs', [7, 15, 31])
def test_kernel_matches_plain_for_any_team_and_view(cuda_device, n, vs):
    """Teams past 8 agents (past 32: a second round of lanes) and views past
    13 (past 15: a fifth doubling step of the fill) ≡ the plain version bit
    for bit, see-through walls on and off, as images and packed cells."""
    state = to_torch(random_fields(100 * n + vs, 64, 16, 16, n, has_boxes=False))
    for stw in (False, True):
        for packed in (False, True):
            want = gen_obs_batched_plain(state, vs, stw, packed)
            launches = obs_cuda.launches
            got = obs_cuda.gen_obs_batched(_to(state, cuda_device), vs, stw, packed)
            assert obs_cuda.launches == launches + 1
            assert torch.equal(got.cpu(), want), (n, vs, stw, packed)


def test_sixteen_agents_step_through_the_kernel(cuda_device):
    """A 16-agent Empty-16x16 VectorEnv on the card resets and steps through
    the obs kernel (one launch a call), its observations equal to the plain
    version on the same states (Empty observes the merged state)."""
    venv = VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=16, device=cuda_device), 64)
    launches = obs_cuda.launches
    obs, state = venv.reset(seed=0)
    assert obs['image'].shape == (64, 16, 7, 7, 3)
    assert torch.equal(obs['image'], gen_obs_batched_plain(state, 7, False))
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for t in range(24):
        actions = torch.randint(0, 7, (64, 16), generator=g, device=cuda_device)
        obs, state, *_ = venv.step(state, actions)
        assert torch.equal(obs['image'], gen_obs_batched_plain(state, 7, False)), t
    assert obs_cuda.launches == launches + 25


def test_kernel_rejects_what_it_cannot_take(cuda_device):
    """An even view (no config takes one) and a grid of the wrong dtype."""
    state = _to(to_torch(random_fields(0, 4, 8, 8, 2, has_boxes=False)), cuda_device)
    for vs in (8, 32):
        with pytest.raises(ValueError):
            obs_cuda.gen_obs_batched(state, vs, False)
    with pytest.raises(ValueError):
        obs_cuda.gen_obs_batched(state.replace(grid=state.grid.to(torch.int64)), 7, False)


@pytest.mark.parametrize('stw', [False, True])
@pytest.mark.parametrize('packed', [False, True])
def test_general_kernel_takes_the_other_shapes(cuda_device, stw, packed, monkeypatch):
    """A view column past one 32-bit word (33, 35, 63) and envs whose grid
    and views pass a block's shared memory (64 views of 31 on 32x32, a
    250x250 grid) go to the general kernel, which ≡ the plain version; a
    shape both kernels take gives both the same bits."""
    for w, h, n, vs, e in [(8, 8, 2, 33, 16), (32, 32, 2, 35, 8), (64, 64, 1, 63, 4),
                           (32, 32, 64, 31, 2), (250, 250, 2, 7, 3), (16, 16, 9, 7, 32)]:
        state = to_torch(random_fields(w + n + vs, e, w, h, n, has_boxes=False))
        want = gen_obs_batched_plain(state, vs, stw, packed)
        kernel = obs_cuda.check_supported(n, w, h, vs)
        counts = obs_cuda.launches, obs_cuda.general_launches
        got = obs_cuda.gen_obs_batched(_to(state, cuda_device), vs, stw, packed)
        assert torch.equal(got.cpu(), want), (w, h, n, vs)
        if kernel == 'general':
            assert (obs_cuda.launches, obs_cuda.general_launches) == (counts[0], counts[1] + 1)
        else:  # the last case: the general kernel, called directly, agrees
            assert (w, h, n, vs) == (16, 16, 9, 7)
            monkeypatch.setattr(obs_cuda, 'check_supported', lambda *a: 'general')
            assert torch.equal(
                obs_cuda.gen_obs_batched(_to(state, cuda_device), vs, stw, packed), got)


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


# ------------------------------------- the agent axis of per-agent policies


def _agents(rng, n, b, c, pad=0.0):
    return torch.stack([_packed(rng, b, c, pad) for _ in range(n)])


@pytest.mark.parametrize('n,b,c,h', [(4, 4096, 49, 128), (2, 4096, 49, 128), (3, 1001, 9, 32),
                                     (2, 77, 25, 100), (4, 4096, 49, 64)])
def test_onehot_linear_agent_axis_is_n_single_launches(cuda_device, n, b, c, h):
    """B2 over N agents: one launch, bit-equal to N single-agent launches
    (each row computed as its agent's own launch computes it), within B2's
    tolerance of its twin, and equal from run to run."""
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(n + b + c + h)
    packed = _agents(rng, n, b, c, 0.05).to(cuda_device)
    w = torch.as_tensor(rng.normal(size=(n, c * fl.NCH, h)).astype(np.float32)).to(cuda_device)
    launches = fl.launches
    got = fl.onehot_linear_agents_forward(packed, w)
    assert fl.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == (n, b, h)
    singles = torch.stack([fl.onehot_linear_forward(packed[i], w[i]) for i in range(n)])
    assert torch.equal(got, singles)
    assert _rel_err(got, fl.onehot_linear_agents_plain(packed, w)) < 2e-2
    assert torch.equal(got, fl.onehot_linear_agents_forward(packed, w))


@pytest.mark.parametrize('n,b,c,h', [(4, 65536, 49, 128), (2, 131072, 49, 128),
                                     (3, 1001, 9, 32), (2, 300, 25, 256), (4, 1, 49, 64)])
def test_onehot_grad_agent_axis_matches_plain_and_single_launches(cuda_device, n, b, c, h):
    """B3 over N agents: one launch, each agent's dW within B3's tolerance
    (1e-4 of the largest entry) of its twin and of its own launch (the
    chunks differ, so the sums' order does), equal from run to run."""
    from multigrid_tpu_torch.ops import fused_linear as fl
    rng = np.random.default_rng(n + b + h)
    packed = _agents(rng, n, b, c, 0.05).to(cuda_device)
    g = torch.as_tensor(rng.normal(size=(n, b, h)).astype(np.float32)).to(cuda_device)
    launches = fl.grad_launches
    got = fl.onehot_linear_agents_grad_w(packed, g)
    assert fl.grad_launches == launches + 1
    assert got.shape == (n, c * fl.NCH, h)
    want = fl.onehot_linear_agents_grad_w_plain(packed, g)
    singles = torch.stack([fl.onehot_linear_grad_w(packed[i], g[i]) for i in range(n)])
    for i in range(n):
        scale = float(want[i].abs().max()) + 1
        assert float((got[i] - want[i]).abs().max()) <= 1e-4 * scale, i
        assert float((got[i] - singles[i]).abs().max()) <= 1e-4 * scale, i
    assert torch.equal(got, fl.onehot_linear_agents_grad_w(packed, g))


def _stacked_ppo_inputs(rng, n, b, h, missions, device):
    cases = [ppo_inputs(rng, b, 49, h, missions, device) for _ in range(n)]
    params = {k: torch.stack([p[k] for p, _ in cases]) for k in cases[0][0]}
    return params, [torch.stack([a[j] for _, a in cases]) for j in range(6)]


@pytest.mark.parametrize('n,b,h,missions', [(4, 65536, 128, 0), (2, 131072, 128, 12),
                                            (3, 1001, 64, 3), (2, 256, 32, 0)])
def test_ppo_loss_agent_axis_matches_plain_and_single_launches(cuda_device, n, b, h, missions):
    """B4 over N agents: one launch, each agent's gradients and metrics
    within B4's tolerance of its twin (bf16 operands) and of its own launch
    (its blocks sum in another order), equal from run to run."""
    from multigrid_tpu_torch.ops import fused_ppo
    params, args = _stacked_ppo_inputs(np.random.default_rng(n + b + missions), n, b, h,
                                       missions, cuda_device)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)
    launches = fused_ppo.launches
    grads, metrics = fused_ppo.ppo_mlp_grads_agents(params, *args, **kw)
    assert fused_ppo.launches == launches + 1
    want_g, want_m = fused_ppo.ppo_mlp_grads_agents_plain(
        params, *args, compute_dtype=torch.bfloat16, **kw)
    singles = [fused_ppo.ppo_mlp_grads({k: v[i] for k, v in params.items()},
                                       *(a[i] for a in args), **kw) for i in range(n)]
    for i, (sg, sm) in enumerate(singles):
        for k in want_g:
            assert grads[k].shape == want_g[k].shape == (n,) + sg[k].shape, k
            scale = float(want_g[k][i].abs().max()) + 1e-6
            assert float((grads[k][i] - want_g[k][i]).abs().max()) / scale < 5e-2, (i, k)
            assert float((grads[k][i] - sg[k]).abs().max()) / scale < 5e-2, (i, k)
        for k in want_m:
            for ref in (want_m[k][i], sm[k]):
                err = abs(float(metrics[k][i]) - float(ref)) / (abs(float(ref)) + 1e-6)
                assert err < 5e-2, (i, k, err)
    again, again_m = fused_ppo.ppo_mlp_grads_agents(params, *args, **kw)
    for k in grads:
        assert torch.equal(grads[k], again[k]), k
    for k in metrics:
        assert torch.equal(metrics[k], again_m[k]), k


def test_agent_axis_wrappers_raise_on_what_they_cannot_take(cuda_device):
    """No fallback: a shape, rank, width or layout the agent-axis kernels do
    not take raises ValueError on the card, and nothing launches."""
    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_ppo
    rng = np.random.default_rng(12)
    packed = _agents(rng, 2, 64, 49).to(cuda_device)
    w = torch.randn(2, 49 * fl.NCH, 128, device=cuda_device)
    g = torch.randn(2, 64, 128, device=cuda_device)
    params, args = _stacked_ppo_inputs(rng, 2, 64, 32, 0, cuda_device)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)
    before = fl.launches, fl.grad_launches, fused_ppo.launches
    bad = [lambda: fl.onehot_linear_agents_forward(packed[0], w[0]),     # no agent axis
           lambda: fl.onehot_linear_agents_forward(packed, w[:, :-21]),  # rows of another C
           lambda: fl.onehot_linear_agents_forward(packed, w[:1]),       # another N
           lambda: fl.onehot_linear_agents_forward(packed[:, ::2], w),   # not contiguous
           lambda: fl.onehot_linear_forward(packed, w),                  # agents to the single
           lambda: fl.onehot_linear_agents_grad_w(packed, g[..., :100]),  # width not built
           lambda: fl.onehot_linear_agents_grad_w(packed[0], g[0]),
           lambda: fl.onehot_linear_grad_w(packed, g),
           lambda: fused_ppo.ppo_mlp_grads_agents(
               {k: v[0] for k, v in params.items()}, *(a[0] for a in args), **kw),
           lambda: fused_ppo.ppo_mlp_grads(params, *args, **kw),
           lambda: fused_ppo.ppo_mlp_grads_agents(
               {**params, 'img_kernel': torch.randn(2, 49 * 21, 96, device=cuda_device)},
               *args, **kw)]
    for i, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
        assert (fl.launches, fl.grad_launches, fused_ppo.launches) == before, i


@pytest.mark.parametrize('gate', [True, False], ids=['loss-kernel', 'gate-off'])
def test_per_agent_train_step_launches_once_for_all_agents(cuda_device, gate, monkeypatch):
    """Two per-agent updates on the card (2 agents): one first-layer launch
    a rollout step for all agents (5 an update) and one loss launch an SGD
    step; with the gate off one more first-layer launch and one gradient
    launch an SGD step."""
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_ppo
    if not gate:
        monkeypatch.setattr(fused_ppo, 'supports', lambda *a: False)
    venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2, device=cuda_device), 64,
                     packed_obs=True)
    config = PPOConfig(rollout_steps=4, per_agent_policies=True)
    state, net, config, tx = ppo_init(venv, 0, config=config, hidden=32,
                                      net_kwargs=dict(encoder='mlp'))
    step = make_train_step(venv, net, config, tx)
    fl.launches = fl.grad_launches = fused_ppo.launches = 0
    for _ in range(2):
        state, metrics = step(state)
    want = (10, 0, 2) if gate else (12, 2, 0)
    assert (fl.launches, fl.grad_launches, fused_ppo.launches) == want
    assert all(np.isfinite(float(metrics[k])) for k in ('loss', 'entropy', 'vf_loss'))


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


def test_policy_kernel_runs_on_the_tensor_cores(cuda_device):
    """The SASS of the fused rollout-policy kernel (B5), every width built,
    holds tensor-core instructions."""
    from multigrid_tpu_torch.utils import build
    ops = build.tensor_core_ops('fused_policy.cu')
    names = [n for n in ops if 'policy_sample_kernel' in n]
    assert len(names) == 4
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
        net = ActorCritic(49, hidden=64, packed_obs=True, dtype=torch.float32,
                          encoder='mlp').to(dev)
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
    state, net, config, tx = ppo_init(venv, 0, config=PPOConfig(rollout_steps=4), hidden=32,
                                      net_kwargs=dict(encoder='mlp'))
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


def _state_to(state, device):
    """A batched state, extras and pool included, on ``device``."""
    from multigrid_tpu_torch.core.state import ResetPool
    pool = state.pool and ResetPool(_state_to(state.pool.reserve, device), state.pool.step)
    return state.replace(**{k: getattr(state, k).to(device) for k in FIELDS},
                         extras={k: v.to(device) for k, v in state.extras.items()}, pool=pool)


def test_pool_consumption_on_the_card_matches_the_cpu(cuda_device):
    """BUP, 64 envs, episodes of 3 steps, from the same state and reserve
    on both devices, the same actions and orders, ``refresh=False``: every
    step's state (fields, extras, pool step) and observations equal the
    CPU path's, three rounds of resets from the reserve included."""
    from multigrid_tpu_torch.ops.step import sample_order
    env_id, e = 'MultiGrid-BlockedUnlockPickup-v0', 64
    cpu = VectorEnv(make(env_id, agents=2, max_steps=3, device='cpu'), e, packed_obs=True)
    card = VectorEnv(make(env_id, agents=2, max_steps=3, device=cuda_device), e,
                     packed_obs=True)
    assert cpu.reset_pool and card.reset_pool
    _, state = cpu.reset(seed=3)
    gstate = _state_to(state, cuda_device)
    g = torch.Generator().manual_seed(3)
    dones = 0
    for t in range(9):
        actions = torch.randint(0, 7, (e, 2), generator=g)
        order = sample_order(g, e, 2, 'cpu')
        obs, state, *_, done, _ = cpu.step(state, actions, order=order, refresh=False)
        gobs, gstate, *_, gdone, _ = card.step(gstate, actions.to(cuda_device),
                                              order=order.to(cuda_device), refresh=False)
        assert torch.equal(gdone.cpu(), done) and torch.equal(gobs['image'].cpu(), obs['image'])
        for k in FIELDS:
            assert torch.equal(getattr(gstate, k).cpu(), getattr(state, k)), (t, k)
        for k, v in state.extras.items():
            assert torch.equal(gstate.extras[k].cpu(), v), (t, k)
        assert gstate.pool.step == state.pool.step == t + 1
        dones += int(done.sum())
    assert dones == 3 * e


def test_cnn_on_the_card_matches_cpu_float32(cuda_device):
    """The cnn (bf16 on the card, cuDNN convolutions) against the float32
    net on the CPU with the same weights, on packed cells with 12 missions,
    as chip_smoke.py's cnn check holds them: logits and values within
    ``max|Δ|/(|want|+1) < 2e-2``, each parameter's gradient of a scalar of
    them within ``‖Δ‖/‖want‖ < 0.1`` (bf16 rounds activations and
    gradients at each of the five layers above ``Conv_0``; an element of a
    gradient summed over many samples can cancel to near 0)."""
    from multigrid_tpu_torch.learn.nets import ActorCritic
    rng = np.random.default_rng(8)
    b = 2048
    image = _packed(rng, b, 81, 0.0)
    direction = torch.as_tensor(rng.integers(0, 4, b))
    mission = torch.as_tensor(rng.integers(0, 12, b))
    u = torch.as_tensor(rng.normal(size=(b, 7)).astype(np.float32))
    outs = []
    for dev, dtype in ((torch.device('cpu'), torch.float32), (cuda_device, torch.bfloat16)):
        net = ActorCritic(81, hidden=64, packed_obs=True, num_missions=12, dtype=dtype,
                          encoder='cnn', seed=4).to(dev)
        logits, value = net(image.to(dev), direction.to(dev), mission.to(dev))
        ((logits * u.to(dev)).sum() + value.sum()).backward()
        outs.append([logits.detach().cpu(), value.detach().cpu()]
                    + [p.grad.cpu() for _, p in sorted(net.named_parameters())])
    for g, w in zip(outs[1][:2], outs[0][:2]):
        assert _rel_err(g, w) < 2e-2
    for g, w in zip(outs[1][2:], outs[0][2:]):
        assert float((g.float() - w).norm() / w.norm()) < 0.1


def test_resume_on_the_card_is_exact(cuda_device, tmp_path):
    """BUP on the card (mlp on B2 and B4, the pool): 2 updates straight ≡ 1
    update, a checkpoint, a restore into freshly built objects and 1 more,
    bit for bit (B3 and B4 are equal from run to run)."""
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    def setup(seed):
        venv = VectorEnv(make('MultiGrid-BlockedUnlockPickup-v0', agents=2, max_steps=5,
                              device=cuda_device), 64, packed_obs=True)
        state, net, config, tx = ppo_init(venv, seed, hidden=32, config=PPOConfig(
            rollout_steps=4, epochs=2, minibatches=2), net_kwargs=dict(encoder='mlp'))
        return venv, state, make_train_step(venv, net, config, tx)

    venv, state, step = setup(0)
    state, _ = step(state)
    path = save_checkpoint(str(tmp_path / 'step_1'), state, venv)
    straight, _ = step(state)
    venv2, fresh, step2 = setup(1)
    resumed, _ = step2(restore_checkpoint(path, fresh, venv2))
    for k in straight.params:
        assert torch.equal(resumed.params[k], straight.params[k]), k
    for k in FIELDS:
        assert torch.equal(getattr(resumed.env_state, k), getattr(straight.env_state, k)), k
    assert torch.equal(resumed.env_state.pool.reserve.grid, straight.env_state.pool.reserve.grid)
    assert torch.equal(venv2.generator.get_state(), venv.generator.get_state())


# ------------------------------------------------ the user-facing surface


def _obs_to(obs, device):
    if isinstance(obs, dict):
        return {k: v.to(device) for k, v in obs.items()}
    return obs.to(device)


def _obs_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_obs_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize('name', ['FullyObsWrapper', 'ImgObsWrapper', 'OneHotObsWrapper'])
def test_wrapped_vector_env_on_the_card_matches_the_cpu(cuda_device, name):
    """BUP on the pool under each wrapper, 64 envs, episodes of 3 steps,
    from the same state and reserve on both devices, the same actions and
    orders, ``refresh=False``: every step's wrapped observations equal the
    CPU path's, one obs launch a step."""
    from multigrid_tpu_torch import wrappers
    from multigrid_tpu_torch.ops.step import sample_order
    env_id, e = 'MultiGrid-BlockedUnlockPickup-v0', 64
    cpu, card = (VectorEnv(getattr(wrappers, name)(make(env_id, agents=2, max_steps=3,
                                                        device=d)), e)
                 for d in ('cpu', cuda_device))
    obs, state = cpu.reset(seed=3)
    gstate = _state_to(state, cuda_device)
    assert _obs_equal(_obs_to(card.observe(gstate), 'cpu'), obs)
    g = torch.Generator().manual_seed(3)
    dones = 0
    for t in range(9):
        actions = torch.randint(0, 7, (e, 2), generator=g)
        order = sample_order(g, e, 2, 'cpu')
        obs, state, *_, done, _ = cpu.step(state, actions, order=order, refresh=False)
        launches = obs_cuda.launches
        gobs, gstate, *_ = card.step(gstate, actions.to(cuda_device),
                                     order=order.to(cuda_device), refresh=False)
        assert obs_cuda.launches == launches + 1
        assert _obs_equal(_obs_to(gobs, 'cpu'), obs), t
        dones += int(done.sum())
    assert dones == 3 * e


def test_adapters_launch_the_obs_kernel_once_a_call(cuda_device):
    """A ``GymAdapter`` over BUP keeps its state on the card and launches
    the obs kernel once a reset and once a step; a ``MiniGridCompatEnv``
    (host-side layouts uploaded to the card) through the MiniGrid facade
    does the same, its observations equal to the plain version's."""
    from multigrid_tpu_torch.adapters import GymAdapter
    from multigrid_tpu_torch.utils.minigrid_builder import Goal, Grid, MiniGridCompatEnv
    from multigrid_tpu_torch.utils.minigrid_interface import MiniGridInterface

    ad = GymAdapter(make('MultiGrid-BlockedUnlockPickup-v0', agents=2, device=cuda_device))
    launches = obs_cuda.launches
    ad.reset(seed=0)
    assert obs_cuda.launches == launches + 1 and ad._state.device.type == cuda_device.type
    for t in range(10):
        ad.step({0: t % 7} if t % 3 else {0: 2, 1: t % 7})
        assert obs_cuda.launches == launches + 2 + t

    class Room(MiniGridCompatEnv):
        mission = 'get to the green goal square'

        def _gen_grid(self, width, height):
            self.grid = Grid(width, height)
            self.grid.wall_rect(0, 0, width, height)
            self.put_obj(Goal(), width - 2, height - 2)
            self.place_agent()

    mg = MiniGridInterface(Room(grid_size=7, device=cuda_device))
    launches = obs_cuda.launches
    obs, _ = mg.reset(seed=1)
    for t, a in enumerate([2, 1, 2, 0, 2, 2]):
        want = gen_obs_batched_plain(_to(mg._state, 'cpu'), 7, False)[0, 0].numpy()
        np.testing.assert_array_equal(obs['image'], want)
        obs, *_ = mg.step(a)
        assert obs_cuda.launches == launches + 2 + t


@pytest.mark.parametrize('backend,procs', [('nccl', 1), ('gloo', 2)])
def test_sharded_training_on_the_card_matches_one_process(cuda_device, backend, procs):
    """PPO over processes on the card (spawned, a file-store rendezvous):
    NCCL in a world of one equals the plain path; two gloo processes
    sharing the card (NCCL refuses two on one card) match one process at
    rtol 1e-4 with the first rollout bit-equal. Each process launches B1 T,
    B2 T + 1 and B4 once an update."""
    from multigrid_tpu_torch.parallel.dryrun import assert_consistent, ppo_run, spawn

    kw = dict(num_envs=512, updates=2, env_id='MultiGrid-Empty-16x16-v0', agents=4,
              hidden=128, config=dict(rollout_steps=4), device='cuda')
    sharded = spawn(ppo_run, procs, (), kw, backend=backend, device='cuda', timeout=300)
    single = ppo_run(**kw, sharded=False)
    assert_consistent(sharded, single, f'{backend} x {procs}',
                      **(dict(rtol=0.0, atol=0.0) if procs == 1 else {}))
    for res in sharded:
        assert res['launches'] == {'obs': 8, 'obs_general': 0, 'onehot_linear': 10,
                                   'onehot_linear_grad': 0, 'ppo_loss': 2,
                                   'policy_sample': 0}


def test_model_axis_gate_on_the_card_is_one_process(cuda_device):
    """``dryrun_multichip(2)`` on the card, two gloo processes sharing it:
    the JAX gate's (1, 2) mesh and cnn, each process holding half of
    Dense_0's columns, bit for bit against one process; B1 T an update
    a process (the cnn launches no other kernel)."""
    from multigrid_tpu_torch.parallel.dryrun import assert_consistent, dryrun_multichip

    sharded, single = dryrun_multichip(2, backend='gloo', device='cuda', timeout=300)
    assert [r['mesh_shape'] for r in sharded] == [[1, 2], [1, 2]]
    assert_consistent(sharded, single, '(1, 2) gate', rtol=0.0, atol=0.0)
    for res in sharded:
        assert res['encoder'] == 'cnn'
        assert res['launches'] == {'obs': 6, 'obs_general': 0, 'onehot_linear': 0,
                                   'onehot_linear_grad': 0, 'ppo_loss': 0, 'policy_sample': 0}

