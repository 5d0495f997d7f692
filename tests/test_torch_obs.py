"""The port's plain observation function ≡ the JAX package's.

Seeded numpy states (doors, keys, balls, boxes, agents at the borders,
terminated and carrying agents) go through ``jax.vmap(gen_obs_grid_encoding)``
and the port's plain version (through the kernel wrapper, which takes the
plain version for CPU tensors); images and packed cells must be equal bit
for bit. One case is also held against the Pallas kernel in interpret mode, as
tests/test_obs_pallas.py runs it. The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py and tests/test_torch_cuda.py.
"""

import jax
import numpy as np
import pytest
import torch

from multigrid_tpu.ops.obs import gen_obs_grid_encoding
from multigrid_tpu_torch.core.constants import (
    STATE_OPEN,
    TYPE_DOOR,
    TYPE_WALL,
    UNSEEN_ENCODING,
)
from multigrid_tpu.ops.obs_pallas import gen_obs_batched_pallas
from multigrid_tpu_torch.ops import obs_cuda
from multigrid_tpu_torch.ops.obs import (
    gen_obs_batched_plain,
    get_vis_mask,
    vis_column,
    vis_column_bits,
)

from .test_torch_states import random_fields, to_jax, to_torch

torch.set_num_threads(1)

E = 8

# XLA:CPU compiles the JAX visibility mask slowly (seconds at view 7,
# minutes at view 13), so the full JAX pipeline runs at view 7 only. The
# other cases hold the crop, rotation and carried object to JAX with
# see_through_walls on, and the masked output to the reference's literal
# visibility sweep (multigrid/utils/obs.py:235-273) applied to those views.
CASES = (
    # (width, height, agents, view_size)
    [(8, 8, 2, vs) for vs in (3, 5, 9, 11, 13)]
    + [(13, 25, 2, 7), (8, 8, 1, 7), (8, 8, 3, 7), (8, 8, 4, 7)]
)


def _jax_images(fields, vs, stw):
    state = to_jax(fields)
    return np.asarray(jax.vmap(lambda s: gen_obs_grid_encoding(s, vs, stw))(state))


def _packed(img):
    img = np.asarray(img)
    p = (img[..., 0] << 8) | (img[..., 1] << 4) | img[..., 2]
    return p.reshape(p.shape[:-2] + (-1,))


def reference_vis(see):
    """The reference's in-place visibility sweeps on a (vs, vs) see-through
    mask, agent at (vs//2, vs-1)."""
    vs = see.shape[-1]
    mask = np.zeros((vs, vs), bool)
    mask[vs // 2, vs - 1] = True
    for j in reversed(range(vs)):
        for i in range(vs - 1):
            if mask[i, j] and see[i, j]:
                mask[i + 1, j] = True
                if j > 0:
                    mask[i + 1, j - 1] = mask[i, j - 1] = True
        for i in reversed(range(1, vs)):
            if mask[i, j] and see[i, j]:
                mask[i - 1, j] = True
                if j > 0:
                    mask[i - 1, j - 1] = mask[i, j - 1] = True
    return mask


def _check_wrapper(state, vs, stw, want):
    launches = obs_cuda.launches
    got = obs_cuda.gen_obs_batched(state, vs, stw)
    np.testing.assert_array_equal(got.numpy(), want)
    packed = obs_cuda.gen_obs_batched(state, vs, stw, packed=True)
    assert packed.shape == (state.num_envs, state.num_agents, vs * vs)
    np.testing.assert_array_equal(packed.numpy(), _packed(want))
    assert obs_cuda.launches == launches  # CPU tensors never launch


@pytest.mark.parametrize('stw', [False, True])
def test_plain_obs_matches_jax(stw):
    """The whole pipeline against ``gen_obs_grid_encoding`` at view 7."""
    fields = random_fields(3, E, 8, 8, 2, has_boxes=False)
    _check_wrapper(to_torch(fields), 7, stw, _jax_images(fields, 7, stw))


@pytest.mark.parametrize('w,h,n,vs', CASES,
                         ids=[f'{c[0]}x{c[1]}-n{c[2]}-vs{c[3]}' for c in CASES])
def test_plain_obs_matches_jax_views_and_reference_sweep(w, h, n, vs):
    fields = random_fields(100 * vs + 10 * n + w, E, w, h, n, has_boxes=False)
    views = _jax_images(fields, vs, True)
    state = to_torch(fields)
    _check_wrapper(state, vs, True, views)
    t, s = views[..., 0], views[..., 2]
    see = ~((t == TYPE_WALL) | ((t == TYPE_DOOR) & (s != STATE_OPEN)))
    vis = np.stack([[reference_vis(see[e, a]) for a in range(n)] for e in range(E)])
    masked = np.where(vis[..., None], views, UNSEEN_ENCODING)
    _check_wrapper(state, vs, False, masked)


@pytest.mark.parametrize('stw', [False, True])
def test_plain_obs_matches_pallas_interpret(stw):
    """The shape of tests/test_obs_pallas.py's first case (E=8, 8x8, N=2)."""
    fields = random_fields(7, E, 8, 8, 2, has_boxes=False)
    want = gen_obs_batched_pallas(to_jax(fields), 7, stw, interpret=True)
    got = gen_obs_batched_plain(to_torch(fields), 7, stw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('vs', [3, 7, 13])
def test_vis_mask_matches_reference_sweep(vs):
    """The column-by-column fixpoint equals the reference's literal in-place
    sweeps on random see-through masks."""
    rng = np.random.default_rng(vs)
    see = rng.random((300, vs, vs)) < 0.7
    obs = np.zeros((300, vs, vs, 3), np.int64)
    obs[..., 0] = np.where(see, 1, 2)  # empty / wall
    got = get_vis_mask(torch.as_tensor(obs)).numpy()
    for b in range(300):
        np.testing.assert_array_equal(got[b], reference_vis(see[b]), err_msg=str(b))


def _bits_to_bool(x, vs):
    return (x[..., None] >> torch.arange(vs)) & 1 == 1


@pytest.mark.parametrize('vs', [3, 5, 7, 9, 11, 13])
def test_vis_column_bits_match_the_loop_form(vs):
    """The CUDA kernel's bit algebra for one column (occluded fills by
    doubling) ≡ the loop form of :func:`vis_column`: for every (lit cells,
    see-through cells) pair up to view 7, and 20,000 seeded pairs beyond."""
    if vs <= 7:
        lit, see = torch.meshgrid(torch.arange(1 << vs), torch.arange(1 << vs), indexing='ij')
        lit, see = lit.flatten(), see.flatten()
    else:
        rng = np.random.default_rng(vs)
        n = 20000
        # Single lit cells and see-through columns with at most one opaque
        # cell, where the spreads run longest, beside random pairs.
        lit = torch.as_tensor(np.where(rng.random(n) < 0.5, 1 << rng.integers(0, vs, n),
                                       rng.integers(0, 1 << vs, n)))
        opaque = (1 << rng.integers(0, vs, n)) * (rng.random(n) < 0.5)
        see = torch.as_tensor(np.where(rng.random(n) < 0.5, (1 << vs) - 1 - opaque,
                                       rng.integers(0, 1 << vs, n)))
    got_col, got_next = vis_column_bits(lit, see, vs)
    want_col, want_next = vis_column(_bits_to_bool(lit, vs), _bits_to_bool(see, vs))
    assert torch.equal(_bits_to_bool(got_col, vs), want_col)
    assert torch.equal(_bits_to_bool(got_next, vs), want_next)
    assert int((got_col | got_next).max()) < (1 << vs)  # no bit past the column


@pytest.mark.parametrize('n,vs,w,h', [(9, 7, 8, 8), (2, 15, 8, 8), (2, 4, 8, 8),
                                      (4, 7, 250, 250)])
def test_kernel_rejects_unsupported_shapes(n, vs, w, h):
    with pytest.raises(ValueError):
        obs_cuda.check_supported(n, w, h, vs)


def test_kernel_takes_its_supported_range():
    for vs in (3, 5, 7, 9, 11, 13):
        for n in (1, 2, 8):
            obs_cuda.check_supported(n, 32, 32, vs)
    obs_cuda.check_supported(4, 13, 25, 7)
