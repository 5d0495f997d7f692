"""MiniGrid compatibility on the port: a Farama-minigrid env ported through
``utils/minigrid_builder.py`` and ``utils/minigrid_interface.py``, held
against the JAX package's (tests/test_minigrid_compat.py).

``DoorKeyEnv`` is the same Farama generator with the port's imports. Its
layouts equal the JAX package's from the same ``np_random`` seeds, and the
scripted solve (teleports through the setters, pickup, unlock, the goal)
goes step for step as in the JAX package, from the port's reset carried
across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.core.state import MultiGridState as JaxState
from multigrid_tpu.utils.minigrid_builder import Grid as JaxGrid
from multigrid_tpu.utils.minigrid_interface import MiniGridInterface as JaxMiniGridInterface
from multigrid_tpu_torch.core.actions import Action
from multigrid_tpu_torch.core.constants import (
    STATE_LOCKED,
    STATE_OPEN,
    TYPE_DOOR,
    TYPE_EMPTY,
    TYPE_GOAL,
    TYPE_KEY,
    Color,
)
from multigrid_tpu_torch.core.state import FIELDS, STATE_FIELDS, state_to_numpy
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.utils.minigrid_builder import (
    Door,
    Goal,
    Grid,
    Key,
    MiniGridCompatEnv,
)
from multigrid_tpu_torch.utils.minigrid_interface import MiniGridInterface
from multigrid_tpu_torch.utils import prng

from .test_minigrid_compat import DoorKeyEnv as JaxDoorKeyEnv

torch.set_num_threads(1)


class DoorKeyEnv(MiniGridCompatEnv):
    """Farama minigrid DoorKeyEnv, imports swapped (minigrid/envs/doorkey.py)."""

    mission = "use the key to open the door and then get to the goal"

    def __init__(self, size=8, max_steps=None, **kwargs):
        if max_steps is None:
            max_steps = 10 * size**2
        super().__init__(grid_size=size, max_steps=max_steps, **kwargs)

    def _gen_grid(self, width, height):
        # Create an empty grid
        self.grid = Grid(width, height)

        # Generate the surrounding walls
        self.grid.wall_rect(0, 0, width, height)

        # Place a goal in the bottom-right corner
        self.put_obj(Goal(), width - 2, height - 2)

        # Create a vertical splitting wall
        splitIdx = self._rand_int(2, width - 2)
        self.grid.vert_wall(splitIdx, 0)

        # Place the agent at a random position and orientation
        # on the left side of the splitting wall
        self.place_agent(size=(splitIdx, height))

        # Place a door in the wall
        doorIdx = self._rand_int(1, width - 2)
        self.put_obj(Door("yellow", is_locked=True), splitIdx, doorIdx)

        # Place a yellow key on the left side
        self.place_obj(obj=Key("yellow"), top=(0, 0), size=(splitIdx, height))

        self.mission = "use the key to open the door and then get to the goal"


def _find(grid: np.ndarray, type_idx: int) -> tuple[int, int]:
    xs, ys = np.nonzero(grid[:, :, 0] == type_idx)
    assert len(xs) == 1
    return int(xs[0]), int(ys[0])


def _empty_neighbor_facing(grid, x, y):
    """(pos, dir) of an empty cell adjacent to (x, y), facing it."""
    for (nx, ny), d in [((x - 1, y), 0), ((x, y - 1), 1),
                        ((x + 1, y), 2), ((x, y + 1), 3)]:
        if grid[nx, ny, 0] == TYPE_EMPTY:
            return (nx, ny), d
    raise AssertionError('no empty neighbor')


@pytest.fixture(scope='module')
def env():
    e = MiniGridInterface(DoorKeyEnv(size=6, device='cpu'))
    yield e
    e.close()


@pytest.mark.parametrize('seed', [0, 3, 11])
def test_doorkey_layout_matches_jax(seed):
    """From the same ``np_random`` seed both packages build the same grid,
    box table and agent."""
    ours, theirs = DoorKeyEnv(size=8, device='cpu'), JaxDoorKeyEnv(size=8)
    layout = ours.build_layout(np.random.default_rng(seed))
    theirs._np_random = np.random.default_rng(seed)
    theirs._gen_grid(8, 8)
    np.testing.assert_array_equal(layout['grid'], theirs.grid.data)
    np.testing.assert_array_equal(layout['box_contents'], theirs.grid.contents)
    np.testing.assert_array_equal(layout['agent_pos'][0], theirs._build_agent_pos)
    assert int(layout['agent_dir'][0]) == theirs._build_agent_dir


def test_doorkey_layout(env):
    obs, _ = env.reset(seed=3)
    grid = env._state.grid[0].numpy()
    assert obs['image'].shape == (7, 7, 3)
    assert obs['mission'] == DoorKeyEnv.mission
    kx, ky = _find(grid, TYPE_KEY)
    dx, dy = _find(grid, TYPE_DOOR)
    assert _find(grid, TYPE_GOAL) == (4, 4)
    assert grid[dx, dy, 2] == STATE_LOCKED
    # Key and agent are both strictly left of the splitting wall.
    assert kx < dx and env.agent_pos[0] < dx


def _jax_state(state):
    host = state_to_numpy(state)
    return JaxState(**{k: jnp.asarray(host[k][0]) for k in FIELDS},
                    rng=jax.random.key(0), extras={})


def test_doorkey_solve_matches_jax():
    """Pick up the key, unlock the door, reach the goal: the port's reset
    carried into the JAX interface, then the same teleports and actions on
    both, every observation, reward, flag and state field equal."""
    ours = MiniGridInterface(DoorKeyEnv(size=6, device='cpu'))
    theirs = JaxMiniGridInterface(JaxDoorKeyEnv(size=6))
    obs, _ = ours.reset(seed=3)
    theirs.reset(seed=3)
    theirs._state = _jax_state(ours._state)
    grid = ours._state.grid[0].numpy()
    kx, ky = _find(grid, TYPE_KEY)
    dx, dy = _find(grid, TYPE_DOOR)
    key_side, key_dir = _empty_neighbor_facing(grid, kx, ky)

    def both(**setters):
        for k, v in setters.items():
            setattr(ours, k, v)
            setattr(theirs, k, v)

    def step(action):
        a, b = ours.step(action), theirs.step(action)
        np.testing.assert_array_equal(a[0]['image'], b[0]['image'])
        assert a[0]['direction'] == b[0]['direction'] and a[0]['mission'] == b[0]['mission']
        assert a[1:4] == b[1:4]
        want = jax.device_get(theirs._state)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(ours._state, k)[0].numpy(),
                                          getattr(want, k), err_msg=k)
        return a

    both(agent_pos=key_side, agent_dir=key_dir)
    np.testing.assert_array_equal(ours.front_pos, [kx, ky])
    np.testing.assert_array_equal(ours.front_pos, theirs.front_pos)
    step(Action.pickup)
    assert ours.carrying is not None and ours.carrying[0] == TYPE_KEY
    np.testing.assert_array_equal(ours.carrying, theirs.carrying)

    both(agent_pos=(dx - 1, dy), agent_dir=0)  # facing the door
    np.testing.assert_array_equal(ours.dir_vec, [1, 0])
    step(Action.toggle)
    assert ours._state.grid[0, dx, dy, 2] == STATE_OPEN
    step(Action.forward)
    np.testing.assert_array_equal(ours.agent_pos, [dx, dy])

    both(agent_pos=(4, 3), agent_dir=1)  # above the goal, facing down
    _, reward, term, trunc, _ = step(Action.forward)
    assert term and reward > 0 and not trunc
    assert ours.steps_remaining == theirs.steps_remaining


def test_place_agent_respects_region(env):
    env.reset(seed=5)
    dx, _ = _find(env._state.grid[0].numpy(), TYPE_DOOR)
    for _ in range(5):
        x, y = env.place_agent(size=(dx, env.env.height))
        assert 0 < x < dx
        assert tuple(env.agent_pos) == (x, y)
    d = env.agent_dir
    env.place_agent(rand_dir=False)
    assert env.agent_dir == d


def test_space_setters(env):
    import gymnasium.spaces as sp
    env.reset(seed=0)
    assert isinstance(env.action_space, sp.Discrete)
    custom = sp.Discrete(3)
    env.action_space = custom
    assert env.action_space is custom
    env.action_space = None
    obs_space = env.observation_space
    env.observation_space = sp.Box(0, 1, (2,))
    assert env.observation_space.shape == (2,)
    env.observation_space = None
    assert type(env.observation_space) is type(obs_space)


def test_grid_encode_decode_roundtrip(env):
    """Builder-Grid encode/decode/slice (multigrid/core/grid.py:310-347),
    the same as the JAX package's Grid on the same data."""
    env.reset(seed=3)
    grid = env.env.grid  # the host-side builder Grid from the last reset
    enc = grid.encode()
    assert enc.shape == (grid.width, grid.height, 3)
    decoded, vis = Grid.decode(enc)
    assert vis.all()
    np.testing.assert_array_equal(decoded.data, grid.data)

    mask = np.ones((grid.width, grid.height), dtype=bool)
    mask[0, :] = False
    enc_m = grid.encode(mask)
    assert (enc_m[0, :, 0] == 0).all()  # unseen type index
    _, vis2 = Grid.decode(enc_m)
    np.testing.assert_array_equal(vis2, mask)
    jdecoded, jvis = JaxGrid.decode(enc_m)
    np.testing.assert_array_equal(Grid.decode(enc_m)[0].data, jdecoded.data)
    np.testing.assert_array_equal(jvis, vis2)

    sub = grid.slice(-1, -1, 3, 3)
    assert sub.data[0, 0, 0] == 2  # wall
    np.testing.assert_array_equal(sub.data[1, 1], grid.data[0, 0])


def test_rand_color_is_name(env):
    names = {c.value for c in Color}
    for _ in range(10):
        c = env.env._rand_color()
        assert isinstance(c, str) and c in names
    assert f'pick up the {env.env._rand_color()} ball'.count('Color.') == 0
    Key(env.env._rand_color())


def test_reset_core_draws_each_env_from_the_generator():
    """Each env's numpy stream is seeded with its key's two words (as the
    JAX builder seeds it from the key's data): the same keys give the same
    batch, env i of the batch is :meth:`build_layout` of key i's stream,
    uploaded in one state, and its ``rng`` the second key of
    ``split(key)``."""
    env = DoorKeyEnv(size=8, device='cpu')
    keys = prng.split(prng.key(9), 4)
    a = env.reset_core(keys)
    b = env.reset_core(prng.split(prng.key(9), 4))
    assert a.grid.shape == (4, 8, 8, 3) and a.agent_pos.shape == (4, 1, 2)
    for k in STATE_FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(a.rng, prng.split(keys)[:, 1])
    for i, s in enumerate(keys.tolist()):
        layout = env.build_layout(np.random.default_rng(s))
        np.testing.assert_array_equal(a.grid[i].numpy(), layout['grid'])
        np.testing.assert_array_equal(a.agent_pos[i].numpy(), layout['agent_pos'])
    assert len({a.grid[i].numpy().tobytes() for i in range(4)}) > 1


def test_compat_env_steps_in_a_vector_env():
    venv = VectorEnv(DoorKeyEnv(size=6, device='cpu'), 3, auto_reset=False)
    obs, state = venv.reset(seed=1)
    assert obs['image'].shape == (3, 1, 7, 7, 3)
    obs, state, rew, term, trunc, done, _ = venv.step(state, torch.full((3, 1), 2))
    assert state.step_count.tolist() == [1, 1, 1] and not done.any()
