"""Seeded numpy states shared by the port's tests, converters to both
packages' state types, and the tests of the state converter."""

import numpy as np
import pytest
import torch

from multigrid_tpu_torch.core.constants import (
    COLOR_GREY,
    EMPTY_ENCODING,
    TYPE_BALL,
    TYPE_BOX,
    TYPE_DOOR,
    TYPE_EMPTY,
    TYPE_FLOOR,
    TYPE_GOAL,
    TYPE_KEY,
    TYPE_LAVA,
    TYPE_WALL,
)
from multigrid_tpu_torch.core.state import FIELDS, state_from_arrays

_CELL_TYPES = np.array(
    [TYPE_EMPTY] * 10
    + [TYPE_WALL, TYPE_WALL, TYPE_FLOOR, TYPE_DOOR, TYPE_DOOR, TYPE_KEY,
       TYPE_BALL, TYPE_BOX, TYPE_GOAL, TYPE_LAVA])
_CARRY_TYPES = np.array([TYPE_KEY, TYPE_BALL, TYPE_BOX])


def random_fields(seed, e, w, h, n, *, has_boxes=True, max_steps=100):
    """Batched state fields as numpy: grids with walls, doors (open, closed,
    locked), keys, balls, boxes (with contents), goals, floor and lava;
    agents anywhere (borders included), some terminated, some carrying."""
    rng = np.random.default_rng(seed)
    t = rng.choice(_CELL_TYPES, size=(e, w, h))
    c = rng.integers(0, 6, size=(e, w, h))
    s = np.where(t == TYPE_DOOR, rng.integers(0, 3, size=(e, w, h)), 0)
    c = np.where(t == TYPE_EMPTY, 0, c)
    # Half the envs get outer walls; the rest let views and moves reach
    # off the grid.
    walled = rng.random(e) < 0.5
    ring = np.zeros((w, h), bool)
    ring[[0, -1], :] = ring[:, [0, -1]] = True
    wall_at = walled[:, None, None] & ring
    t = np.where(wall_at, TYPE_WALL, t)
    c = np.where(wall_at, COLOR_GREY, c)
    s = np.where(wall_at, 0, s)
    grid = np.stack([t, c, s], -1).astype(np.int32)

    def random_objects(shape):
        kind = rng.choice(np.array([TYPE_EMPTY, TYPE_KEY, TYPE_BALL]), size=shape)
        col = np.where(kind == TYPE_EMPTY, 0, rng.integers(0, 6, size=shape))
        return np.stack([kind, col, np.zeros(shape, int)], -1).astype(np.int32)

    if has_boxes:
        box = np.where((t == TYPE_BOX)[..., None], random_objects((e, w, h)),
                       EMPTY_ENCODING)
    else:
        box = np.zeros((e, 0, 0, 3), np.int32)
    pos = np.stack([rng.integers(0, w, (e, n)), rng.integers(0, h, (e, n))], -1)
    # Agents stand on empty cells.
    env = np.arange(e)[:, None]
    grid[env, pos[..., 0], pos[..., 1]] = EMPTY_ENCODING
    carry_t = np.where(rng.random((e, n)) < 0.35,
                       rng.choice(_CARRY_TYPES, size=(e, n)), TYPE_EMPTY)
    carry = np.stack([carry_t, np.where(carry_t == TYPE_EMPTY, 0,
                                        rng.integers(0, 6, (e, n))),
                      np.zeros((e, n), int)], -1).astype(np.int32)
    contents = np.where((carry_t == TYPE_BOX)[..., None],
                        random_objects((e, n)), EMPTY_ENCODING)
    return dict(
        grid=grid,
        box_contents=box.astype(np.int32),
        agent_pos=pos.astype(np.int32),
        agent_dir=rng.integers(0, 4, (e, n)).astype(np.int32),
        agent_color=(np.arange(n) % 6)[None].repeat(e, 0).astype(np.int32),
        agent_terminated=rng.random((e, n)) < 0.2,
        agent_carrying=carry,
        agent_carrying_contents=contents.astype(np.int32),
        step_count=rng.integers(0, max_steps, (e,)).astype(np.int32),
    )


def to_jax(fields):
    """JAX ``MultiGridState`` (batched) holding ``fields``."""
    import jax
    import jax.numpy as jnp

    from multigrid_tpu.core.state import MultiGridState
    e = fields['grid'].shape[0]
    return MultiGridState(
        **{k: jnp.asarray(fields[k]) for k in FIELDS},
        rng=jax.random.split(jax.random.key(0), e), extras={})


def to_torch(fields):
    return state_from_arrays(fields, 'cpu')


def jax_fields(state):
    """numpy fields of a JAX state, through ``jax.device_get``."""
    import jax
    host = jax.device_get(state)
    return {k: np.asarray(getattr(host, k)) for k in FIELDS}


# --------------------------------------------------------------------- tests

torch.set_num_threads(1)


@pytest.mark.parametrize('has_boxes', [True, False])
def test_state_round_trip_through_jax(has_boxes):
    """numpy → JAX state → jax.device_get → port state → numpy is exact, and
    keeps the JAX package's layouts and dtypes."""
    fields = random_fields(0, 4, 7, 5, 3, has_boxes=has_boxes)
    state = to_torch(jax_fields(to_jax(fields)))
    assert state.grid.shape == (4, 7, 5, 3) and state.grid.dtype == torch.int32
    assert state.agent_terminated.dtype == torch.bool
    assert state.box_contents.shape == ((4, 7, 5, 3) if has_boxes else (4, 0, 0, 3))
    assert state.step_count.shape == (4,)
    from multigrid_tpu_torch.core.state import state_to_numpy
    back = state_to_numpy(state)
    for k in FIELDS:
        np.testing.assert_array_equal(back[k], fields[k], err_msg=k)


def test_single_env_state_is_batch_of_one():
    """A single JAX env state (no env axis) converts to E = 1, and the port's
    init_state agrees with the JAX package's blank state."""
    import jax

    from multigrid_tpu.core.state import init_state as jax_init_state
    from multigrid_tpu_torch.core.state import init_state
    single = jax_init_state(6, 5, 3, jax.random.key(0), has_boxes=False)
    host = jax.device_get(single)
    ours = state_from_arrays({k: getattr(host, k) for k in FIELDS}, 'cpu')
    blank = init_state(1, 6, 5, 3, 'cpu', has_boxes=False)
    for k in FIELDS:
        assert torch.equal(getattr(ours, k), getattr(blank, k)), k
