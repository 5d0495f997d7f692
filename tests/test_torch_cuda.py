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
