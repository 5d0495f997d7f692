"""The general observation kernel's plain forms ≡ the JAX package.

The general CUDA kernel (``csrc/obs.cu::obs_general_kernel``) serves the
shapes ``obs_kernel`` does not take (views of 33 and more, grids past a
block's shared memory, large teams of wide views); the JAX package serves
them through its XLA path (``gen_obs_grid`` and ``get_vis_mask``,
multigrid_tpu/parallel/vector.py:113-147). Here, bit for bit:

- the kernel's sweep in its plain form (``ops/obs.py::vis_column_words``,
  each pass an occluded fill by one add) against ``get_vis_mask`` of both
  packages at views 33, 35, 63 and 97;
- ``gen_obs_batched_plain`` against ``gen_obs_grid`` and ``get_vis_mask``
  at the general shapes, and on states built to test the overlay: two live
  agents on one cell, a terminated agent, an agent off the grid.

The JAX functions run eagerly (op by op, as ``jax.vmap`` outside ``jit``),
one call a shape or swept view batched over its cases: no whole program is
compiled at these shapes. The kernel itself is held against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

from multigrid_tpu.ops.obs import gen_obs_grid as jax_gen_obs_grid
from multigrid_tpu.ops.obs import get_vis_mask as jax_get_vis_mask
from multigrid_tpu_torch.core.constants import (
    EMPTY_ENCODING,
    STATE_CLOSED,
    TYPE_AGENT,
    TYPE_DOOR,
    TYPE_WALL,
    UNSEEN_ENCODING,
)
from multigrid_tpu_torch.ops import obs_cuda
from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain, get_vis_mask, vis_column_words

from .test_torch_states import random_fields, to_jax, to_torch

torch.set_num_threads(1)

SWEPT_VIEWS = (33, 35, 63, 97)
MASKS = 64  # random see-through masks a swept view
# (agents, view, width, height): tests/test_torch_obs.py::
# test_general_kernel_takes_the_other_shapes.
SHAPES = [(2, 33, 8, 8), (4, 7, 250, 250), (64, 31, 32, 32), (2, 63, 64, 64)]
E = 4
# The overlay cases join this shape's batch as envs E..E+3.
OVERLAY = (4, 7, 250, 250)


def _random_masks(vs):
    """(MASKS, vs, vs, 3) view grids of walls and empty cells: random
    see-through masks, half of them all clear but one wall a column."""
    rng = np.random.default_rng(vs)
    see = rng.random((MASKS, vs, vs)) < 0.7
    holes = rng.integers(0, vs, (MASKS, vs))
    one = np.ones((MASKS, vs, vs), bool)
    np.put_along_axis(one, holes[:, None, :], False, axis=1)
    see[MASKS // 2:] = one[MASKS // 2:]
    obs = np.zeros((MASKS, vs, vs, 3), np.int32)
    obs[..., 0] = np.where(see, 1, TYPE_WALL)
    return obs


def _overlay_fields():
    """Four envs of OVERLAY's shape with a wall and a closed door in view;
    agent 2 at (3, 5) faces right, looking at (6, 5), where agent 0 faces
    down; agent 3 stands far off: 0 — agents 0 and 1 live on (6, 5) (agent
    1 is drawn); 1 — the same with agent 1 terminated (agent 0 is drawn);
    2 — agent 1 off the grid (drawn nowhere; its own view walls but its own
    cell); 3 — agent 2 terminated (not drawn, but it sees)."""
    n, _, w, h = OVERLAY
    fields = random_fields(11, 4, w, h, n, has_boxes=False)
    grid = np.broadcast_to(EMPTY_ENCODING, (4, w, h, 3)).copy()
    grid[:, [0, -1], :] = grid[:, :, [0, -1]] = (TYPE_WALL, 5, 0)
    grid[:, 9, 3:8] = (TYPE_WALL, 5, 0)
    grid[:, 7, 6] = (TYPE_DOOR, 2, STATE_CLOSED)
    fields['grid'] = grid
    fields['agent_pos'][:] = [[6, 5], [6, 5], [3, 5], [100, 100]]
    fields['agent_dir'][:] = [1, 2, 0, 0]  # down, left, right, right
    fields['agent_terminated'][:] = False
    fields['agent_terminated'][1, 1] = fields['agent_terminated'][3, 2] = True
    fields['agent_pos'][2, 1] = (-1, 4)
    return fields


def _jax_images(fields, vs):
    return np.asarray(jax.vmap(lambda s: jax_gen_obs_grid(s, vs))(to_jax(fields)))


@pytest.fixture(scope='module')
def jax_masks():
    """The JAX package's get_vis_mask of each swept view's random masks,
    one call a view size: ``{vs: (MASKS, vs, vs) bool}``."""
    return {vs: np.asarray(jax_get_vis_mask(_random_masks(vs))) for vs in SWEPT_VIEWS}


@pytest.fixture(scope='module')
def jax_views():
    """The JAX package's results at the general shapes, one gen_obs_grid and
    one get_vis_mask call a shape: ``{'fields', 'images': {shape: (E, N, vs,
    vs, 3)}, 'vis': {shape: (E, N, vs, vs) bool}}``; OVERLAY's envs E..
    are the overlay cases."""
    fields = {s: random_fields(sum(s), E, s[2], s[3], s[0], has_boxes=False) for s in SHAPES}
    overlay = _overlay_fields()
    fields[OVERLAY] = {k: np.concatenate([v, overlay[k]]) for k, v in fields[OVERLAY].items()}
    images = {k: _jax_images(f, k[1]) for k, f in fields.items()}
    vis = {k: np.asarray(jax_get_vis_mask(img)) for k, img in images.items()}
    return dict(fields=fields, images=images, vis=vis)


def _words_sweep(see):
    """(vs, vs) visibility of one see-through mask by vis_column_words,
    columns vs-1..0 from the agent's cell."""
    vs = see.shape[-1]
    nw = -(-vs // 32)

    def words(bits):
        x = sum(1 << int(i) for i in np.flatnonzero(bits))
        return [(x >> (32 * w)) & 0xFFFFFFFF for w in range(nw)]

    lit = words(np.arange(vs) == vs // 2)
    out = np.zeros((vs, vs), bool)
    for j in reversed(range(vs)):
        vis, lit = vis_column_words(lit, words(see[:, j]), vs)
        x = sum(v << (32 * w) for w, v in enumerate(vis))
        out[:, j] = [(x >> i) & 1 for i in range(vs)]
    return out


@pytest.mark.parametrize('vs', SWEPT_VIEWS)
def test_vis_column_words_sweep_matches_jax_get_vis_mask(jax_masks, vs):
    """The kernel's sweep in its plain form, column by column, ≡ the JAX
    package's get_vis_mask and the port's loop form on random see-through
    masks, half of them with one wall a column (the longest spreads): a
    column of two words (views 33-63, the kernel's 64-bit form) and of
    four (view 97)."""
    obs = _random_masks(vs)
    see = obs[..., 0] != TYPE_WALL
    want = jax_masks[vs]
    np.testing.assert_array_equal(get_vis_mask(torch.as_tensor(obs)).numpy(), want)
    for b in range(MASKS):
        np.testing.assert_array_equal(_words_sweep(see[b]), want[b], err_msg=str(b))


def _masked(images, vis):
    return np.where(vis[..., None], images, UNSEEN_ENCODING)


def _packed(img):
    p = (img[..., 0] << 8) | (img[..., 1] << 4) | img[..., 2]
    return p.reshape(p.shape[:-2] + (-1,))


def _check(state, vs, images, vis):
    for stw, want in ((True, images), (False, _masked(images, vis))):
        np.testing.assert_array_equal(gen_obs_batched_plain(state, vs, stw).numpy(), want)
        np.testing.assert_array_equal(
            gen_obs_batched_plain(state, vs, stw, packed=True).numpy(), _packed(want))


@pytest.mark.parametrize('n,vs,w,h', SHAPES,
                         ids=[f'{s[2]}x{s[3]}-n{s[0]}-vs{s[1]}' for s in SHAPES])
def test_plain_matches_jax_gen_obs_grid_at_general_shapes(jax_views, n, vs, w, h):
    """gen_obs_batched_plain ≡ the JAX package's XLA path (gen_obs_grid,
    then get_vis_mask unless see_through_walls) at the shapes the general
    kernel takes (at OVERLAY's, the overlay cases too), images and
    packed."""
    key = (n, vs, w, h)
    assert obs_cuda.check_supported(n, w, h, vs) == 'general'
    _check(to_torch(jax_views['fields'][key]), vs, jax_views['images'][key],
           jax_views['vis'][key])


def test_overlay_cases(jax_views):
    """Two live agents on one cell (the later drawn), a terminated agent
    (not drawn; the earlier live agent on its cell is), an agent off the
    grid (drawn nowhere; walls past the edge in its own view), as the JAX
    package draws them (the port's plain version ≡ it on these envs, with
    see_through_walls on and off: test_plain_matches_jax_gen_obs_grid_at_
    general_shapes at OVERLAY)."""
    n, vs, w, h = OVERLAY
    images = jax_views['images'][OVERLAY][E:]
    vis = jax_views['vis'][OVERLAY][E:]
    _check(to_torch(_overlay_fields()), vs, images, vis)
    # Agent 2 faces right from (3, 5): (6, 5) is its view cell (3, 3);
    # agent 0 faces down from (6, 5): (3, 5) is its view cell (6, 6).
    seen_by_2 = images[:, 2, vs // 2, vs - 1 - 3]
    np.testing.assert_array_equal(seen_by_2[0], (TYPE_AGENT, 1, 2))  # the later agent
    np.testing.assert_array_equal(seen_by_2[1], (TYPE_AGENT, 0, 1))  # agent 1 terminated
    np.testing.assert_array_equal(seen_by_2[2], (TYPE_AGENT, 0, 1))  # agent 1 off the grid
    np.testing.assert_array_equal(seen_by_2[3], (TYPE_AGENT, 1, 2))  # a terminated agent sees
    assert vis[:, 2, vs // 2, vs - 1 - 3].all()
    seen_by_0 = images[:, 0, vs // 2 + 3, vs - 1]
    np.testing.assert_array_equal(seen_by_0[0], (TYPE_AGENT, 2, 0))
    np.testing.assert_array_equal(seen_by_0[3], EMPTY_ENCODING)  # agent 2 terminated
    assert vis[[0, 3], 0, vs // 2 + 3, vs - 1].all()
    assert not (images[2, [0, 2, 3]] == (TYPE_AGENT, 1, 2)).all(-1).any()  # drawn nowhere
    walls = (images[2, 1] == (TYPE_WALL, 5, 0)).all(-1)
    walls[vs // 2, vs - 1] = True  # its own cell holds what it carries
    assert walls.all()
