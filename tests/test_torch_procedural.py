"""The port's procedural zoo (BlockedUnlockPickup, RedBlueDoors,
LockedHallway, Playground) against the JAX package.

- Explicit states, built from the families' parity layouts and then set up
  to fire their post-step hooks (a held target box, an agent facing the
  blue door, unlocked doors in front of agents), go through the JAX
  ``step_core`` (its dynamics and ``post_step``) and the port's with the
  same actions, masks and orders: every state field, every extra, the
  rewards (bit for bit), terminations and truncations must be equal.
- The speed-mode resets: each family's layout invariants and the step
  invariants of tests/test_invariants.py hold them here
  (tests/test_torch_streams.py holds them bit-equal to the JAX package's
  from the same keys).
- The success predicates of tests/test_success.py.
- An env that finishes takes the fresh layout's extras (its mission, its
  doors), and a cloned state shares no extras tensor with its original.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.core.state import MultiGridState as JaxState
from multigrid_tpu.envs import make as jax_make
from multigrid_tpu_torch.core.actions import Action
from multigrid_tpu_torch.core.constants import (
    DIR_TO_VEC,
    STATE_CLOSED,
    STATE_LOCKED,
    STATE_OPEN,
    TYPE_BALL,
    TYPE_BOX,
    TYPE_DOOR,
    TYPE_EMPTY,
    TYPE_FLOOR,
    TYPE_GOAL,
    TYPE_KEY,
    TYPE_LAVA,
    TYPE_WALL,
    Color,
    Direction,
    Type,
)
from multigrid_tpu_torch.core.state import FIELDS, state_from_arrays
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.utils import prng
from multigrid_tpu_torch.parallel import VectorEnv

from .test_torch_states import jax_fields

torch.set_num_threads(1)

E = 12
FAMILIES = {
    # name: (env_id, agents)
    'bup': ('MultiGrid-BlockedUnlockPickup-v0', 2),
    'rbd': ('MultiGrid-RedBlueDoors-6x6-v0', 3),
    'lh': ('MultiGrid-LockedHallway-4Rooms-v0', 2),
    'playground': ('MultiGrid-Playground-v0', 3),
}


def _parity_batch(env, e, seed):
    """(fields, extras) of ``e`` parity layouts, batched numpy."""
    rows = [env._gen_grid_parity(np.random.default_rng(seed + i)) for i in range(e)]
    w, h = env.width, env.height
    n = env.num_agents
    empty = np.broadcast_to(np.array([TYPE_EMPTY, 0, 0], np.int32), (e, n, 3))
    bc = (w, h) if env.uses_boxes else (0, 0)
    fields = dict(
        grid=np.stack([r['grid'] for r in rows]).astype(np.int32),
        box_contents=np.broadcast_to(np.array([TYPE_EMPTY, 0, 0], np.int32),
                                     (e,) + bc + (3,)).copy(),
        agent_pos=np.stack([r['agent_pos'] for r in rows]).astype(np.int32),
        agent_dir=np.stack([r['agent_dir'] for r in rows]).astype(np.int32),
        agent_color=np.broadcast_to(np.arange(n, dtype=np.int32) % 6, (e, n)).copy(),
        agent_terminated=np.zeros((e, n), bool),
        agent_carrying=empty.copy(),
        agent_carrying_contents=empty.copy(),
        step_count=np.zeros((e,), np.int32))
    extras = {k: np.stack([np.asarray(r['extras'][k]) for r in rows])
              for k in rows[0].get('extras', {})}
    return fields, extras


def _face(fields, env_i, agent, cell, direction):
    """Put ``agent`` of env ``env_i`` in front of ``cell``, facing it."""
    dx, dy = DIR_TO_VEC[direction]
    fields['agent_pos'][env_i, agent] = (cell[0] - dx, cell[1] - dy)
    fields['agent_dir'][env_i, agent] = direction


def _setup(name, env, rng):
    """Parity layouts set up to fire ``name``'s post-step hook."""
    fields, extras = _parity_batch(env, E, 100 * list(FAMILIES).index(name))
    fields['step_count'] = rng.integers(0, 50, E).astype(np.int32)
    if name == 'bup':
        # A third of the envs: one agent already holds the target box.
        for i in range(0, E, 3):
            fields['agent_carrying'][i, i % env.num_agents] = extras['target_enc'][i]
    elif name == 'rbd':
        # Half the envs: agent 0 faces the blue door; half of those have the
        # red door open (success on a toggle), the rest fail.
        for i in range(0, E, 2):
            bx, by = extras['blue_pos'][i]
            _face(fields, i, 0, (bx, by), 0)
            fields['grid'][i, bx - 1, by] = (TYPE_EMPTY, 0, 0)
            if i % 4 == 0:
                rx, ry = extras['red_pos'][i]
                fields['grid'][i, rx, ry, 2] = STATE_OPEN
    elif name == 'lh':
        # Open some doors, agents in front of them, some already counted.
        door_pos = env._door_pos
        for i in range(E):
            for r in range(env.num_rooms):
                if rng.random() < 0.6:
                    fields['grid'][i, door_pos[r, 0], door_pos[r, 1], 2] = STATE_OPEN
            extras['door_unlocked'][i] = rng.random(env.num_rooms) < 0.3
            for a in range(env.num_agents):
                r = int(rng.integers(env.num_rooms))
                x, y = door_pos[r]
                _face(fields, i, a, (x, y), 2 if r % 2 == 0 else 0)
    return fields, extras


def _jax_state(fields, extras):
    e = fields['grid'].shape[0]
    return JaxState(**{k: jnp.asarray(fields[k]) for k in FIELDS},
                    rng=jax.random.split(jax.random.key(0), e),
                    extras={k: jnp.asarray(v) for k, v in extras.items()})


def _assert_same(ours, theirs, where):
    want = jax_fields(theirs)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ours, k).numpy(), want[k],
                                      err_msg=f'{where} {k}')
    assert set(ours.extras) == set(theirs.extras), where
    for k, v in ours.extras.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(theirs.extras[k]),
                                      err_msg=f'{where} extras {k}')


@pytest.mark.parametrize('name', list(FAMILIES))
def test_step_core_matches_jax(name):
    """Dynamics and post-step hook, bit for bit, over 6 chained steps with
    actions weighted to toggles, pickups and forward moves."""
    env_id, n = FAMILIES[name]
    env, jenv = make(env_id, agents=n, device='cpu'), jax_make(env_id, agents=n)
    rng = np.random.default_rng(7)
    fields, extras = _setup(name, env, rng)
    ours = state_from_arrays(fields, 'cpu', extras=extras)
    theirs = _jax_state(fields, extras)
    jstep = jax.jit(jax.vmap(jenv.step_core))
    probs = np.array([0.08, 0.08, 0.3, 0.14, 0.08, 0.3, 0.02])
    fired = 0.0
    for t in range(6):
        actions = rng.choice(7, size=(E, n), p=probs).astype(np.int32)
        order = np.argsort(rng.random((E, n)), axis=-1).astype(np.int32)
        mask = rng.random((E, n)) < 0.9
        j_obs_state, theirs, j_rew, j_term, j_trunc = jstep(theirs, actions, order, mask)
        obs_state, ours, rew, term, trunc = env.step_core(
            ours, torch.as_tensor(actions), torch.as_tensor(order), torch.as_tensor(mask))
        _assert_same(ours, theirs, f't={t}')
        _assert_same(obs_state, j_obs_state, f't={t} obs_state')
        np.testing.assert_array_equal(rew.numpy().view(np.int32),
                                      np.asarray(j_rew).view(np.int32), err_msg=str(t))
        np.testing.assert_array_equal(term.numpy(), np.asarray(j_term), err_msg=str(t))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(j_trunc), err_msg=str(t))
        fired += float(rew.sum())
    if name != 'playground':  # the hooks fired: rewards were paid
        assert fired > 0


# --------------------------------------------------------- speed-mode resets

def _check_front(grid, pos, direction):
    fx, fy = np.asarray(pos) + DIR_TO_VEC[direction]
    if 0 <= fx < grid.shape[0] and 0 <= fy < grid.shape[1]:
        assert grid[fx, fy, 0] in (TYPE_EMPTY, TYPE_WALL)


def _layout_bup(env, state, obs):
    grid, ex = state.grid.numpy(), {k: v.numpy() for k, v in state.extras.items()}
    for i in range(state.num_envs):
        g = grid[i]
        doors = np.argwhere(g[..., 0] == TYPE_DOOR)
        assert len(doors) == 1 and doors[0][0] == 5 and 1 <= doors[0][1] <= 4
        dx, dy = doors[0]
        assert g[dx, dy, 2] == STATE_LOCKED and g[dx - 1, dy, 0] == TYPE_BALL
        boxes = np.argwhere(g[..., 0] == TYPE_BOX)
        assert len(boxes) == 1 and 6 <= boxes[0][0] <= 9
        bx, by = boxes[0]
        assert g[bx, by, 1] == ex['mission_color'][i]
        np.testing.assert_array_equal(ex['target_enc'][i], g[bx, by])
        keys = np.argwhere(g[..., 0] == TYPE_KEY)
        assert len(keys) == 1 and 1 <= keys[0][0] <= 4
        assert g[keys[0][0], keys[0][1], 1] == g[dx, dy, 1]
        for a in range(env.num_agents):
            x, y = state.agent_pos[i, a].tolist()
            assert 1 <= x <= 4 and 1 <= y <= 4 and g[x, y, 0] == TYPE_EMPTY
            _check_front(g, (x, y), int(state.agent_dir[i, a]))
    assert torch.equal(obs['mission'], (state.extras['mission_color'] * 2)[:, None]
                       .expand(-1, env.num_agents))


def _layout_rbd(env, state, obs):
    grid = state.grid.numpy()
    for i in range(state.num_envs):
        g = grid[i]
        for key, color, x in (('red_pos', 0, env._red_x), ('blue_pos', 2, env._blue_x)):
            px, py = state.extras[key][i].tolist()
            assert px == x and 1 <= py <= env.height - 2
            np.testing.assert_array_equal(g[px, py], (TYPE_DOOR, color, STATE_CLOSED))
        assert (g[..., 0] == TYPE_DOOR).sum() == 2
        for a in range(env.num_agents):
            x, y = state.agent_pos[i, a].tolist()
            assert env._red_x < x < env._blue_x and g[x, y, 0] == TYPE_EMPTY
    assert 'mission' not in obs


def _layout_lh(env, state, obs):
    grid = state.grid.numpy()
    hx0, hx1 = env._hallway_top[0], env._hallway_top[0] + env.geometry.room_size
    for i in range(state.num_envs):
        g = grid[i]
        door_colors = sorted(g[x, y, 1] for x, y in env._door_pos)
        assert all(g[x, y, 0] == TYPE_DOOR and g[x, y, 2] == STATE_LOCKED
                   for x, y in env._door_pos)
        keys = np.argwhere(g[..., 0] == TYPE_KEY)
        assert sorted(g[x, y, 1] for x, y in keys) == door_colors
        # At least one key in the hallway, so the chain can start.
        assert any(hx0 < x < hx1 - 1 for x, _ in keys)
        for a in range(env.num_agents):
            x, y = state.agent_pos[i, a].tolist()
            assert hx0 < x < hx1 - 1 and g[x, y, 0] == TYPE_EMPTY
    assert not state.extras['door_unlocked'].any()


def _layout_playground(env, state, obs):
    grid = state.grid.numpy()
    geom = env.geometry
    rs = geom.room_size
    for i in range(state.num_envs):
        g = grid[i]
        objects = np.isin(g[..., 0], (TYPE_KEY, TYPE_BALL, TYPE_BOX)).sum()
        assert objects == 12
        # Every room reachable from room (0, 0) through doors.
        seen, stack = {(0, 0)}, [(0, 0)]
        while stack:
            c, r = stack.pop()
            for d, (dc, dr) in enumerate(DIR_TO_VEC):
                if not geom.has_neighbor(c, r, d):
                    continue
                tx, ty = geom.room_top(c, r)
                if d == 0:
                    wall = g[tx + rs - 1, ty + 1:ty + rs - 1]
                elif d == 1:
                    wall = g[tx + 1:tx + rs - 1, ty + rs - 1]
                elif d == 2:
                    wall = g[tx, ty + 1:ty + rs - 1]
                else:
                    wall = g[tx + 1:tx + rs - 1, ty]
                if (wall[:, 0] == TYPE_DOOR).any() and (c + dc, r + dr) not in seen:
                    seen.add((c + dc, r + dr))
                    stack.append((c + dc, r + dr))
        assert len(seen) == geom.num_cols * geom.num_rows
        cells = set()
        for a in range(env.num_agents):
            x, y = state.agent_pos[i, a].tolist()
            assert g[x, y, 0] == TYPE_EMPTY
            _check_front(g, (x, y), int(state.agent_dir[i, a]))
            cells.add((x, y))
        assert len(cells) == env.num_agents


_LAYOUT = {'bup': _layout_bup, 'rbd': _layout_rbd, 'lh': _layout_lh,
           'playground': _layout_playground}


def _counts(state):
    """Per-env tallies of keys, balls and boxes: on the grid, carried, and
    inside boxes on the grid or carried."""
    grid_t = state.grid[..., 0].numpy()
    box_t = state.box_contents[..., 0].numpy()
    carried_t = state.agent_carrying[..., 0].numpy()
    carried_box_t = state.agent_carrying_contents[..., 0].numpy()

    def tally(t):
        hidden = ((box_t == t) & (grid_t == TYPE_BOX)).sum(axis=(1, 2)) if box_t.size else 0
        return ((grid_t == t).sum(axis=(1, 2)) + (carried_t == t).sum(axis=1) + hidden
                + ((carried_box_t == t) & (carried_t == TYPE_BOX)).sum(axis=1))

    return {t: tally(t) for t in (TYPE_KEY, TYPE_BALL, TYPE_BOX)}


@pytest.mark.parametrize('name', list(FAMILIES))
def test_speed_reset_and_step_invariants(name):
    """A batch of speed-mode layouts has each family's structure
    (reference layouts: the parity tests), reproducibly per seed; then 40
    random steps (no resets) keep the invariants of
    tests/test_invariants.py: valid encodings, objects conserved (boxes
    only vanish), agents on walkable cells, rewards in [0, 1]."""
    env_id, n = FAMILIES[name]
    env = make(env_id, agents=n, device='cpu')
    g = torch.Generator().manual_seed(17)
    state = env.reset_core(prng.split(prng.key(17), 64)).clone()
    again = env.reset_core(prng.split(prng.key(17), 64))
    assert torch.equal(again.grid, state.grid) and torch.equal(again.agent_pos, state.agent_pos)
    _LAYOUT[name](env, state, env.observe(state))

    initial = _counts(state)
    for t in range(40):
        actions = torch.randint(0, 7, (64, n), generator=g)
        _, state, rew, _, _ = env.step(state, actions)
        grid = state.grid.numpy()
        assert grid[..., 0].min() >= 0 and grid[..., 0].max() < len(Type)
        assert grid[..., 1].min() >= 0 and grid[..., 1].max() < len(Color)
        assert grid[..., 2].min() >= 0 and grid[..., 2].max() <= 2
        now = _counts(state)
        np.testing.assert_array_equal(now[TYPE_KEY], initial[TYPE_KEY])
        np.testing.assert_array_equal(now[TYPE_BALL], initial[TYPE_BALL])
        assert (now[TYPE_BOX] <= initial[TYPE_BOX]).all()
        pos = state.agent_pos.numpy()
        e_idx = np.arange(64)[:, None]
        cell = grid[e_idx, pos[..., 0], pos[..., 1]]
        walkable = np.isin(cell[..., 0], (TYPE_EMPTY, TYPE_GOAL, TYPE_FLOOR, TYPE_LAVA)) \
            | ((cell[..., 0] == TYPE_DOOR) & (cell[..., 2] == STATE_OPEN))
        assert walkable.all(), (name, t)
        assert (rew >= 0).all() and (rew <= 1).all()
        assert int(state.step_count.max()) <= env.cfg.max_steps


# ------------------------------------------------- the RoomGrid builders

@pytest.mark.parametrize('rand_pos', [True, False])
def test_room_builders_place_within_their_rooms(rand_pos):
    """``add_door`` puts a door of the asked color and lock on the asked
    wall (random inside its span, or its midpoint); ``add_object`` and
    ``add_distractors`` put objects only on empty interior cells of a room,
    none next to an agent; ``place_agents_in_room`` puts every agent in its
    room facing an empty cell or a wall."""
    env = make('MultiGrid-Playground-v0', agents=2, device='cpu')
    geom, e, g = env.geometry, 32, torch.Generator().manual_seed(11)
    keys = prng.split(prng.key(11), (4, e))
    state = env._init_room_state(e)
    start = state.grid.clone()
    color = torch.randint(0, 6, (e,), generator=g, dtype=torch.int32)
    state, door = env.add_door(state, keys[0], 1, 1, Direction.down, color, locked=True,
                               rand_pos=rand_pos)
    axis, fixed, lo, hi = geom.door_wall_span(1, 1, Direction.down)
    assert axis == 'y' and (door[:, 1] == fixed).all()
    if rand_pos:
        assert ((door[:, 0] >= lo) & (door[:, 0] < hi)).all()
    else:
        assert (door == torch.tensor(geom.fixed_door_pos(1, 1, Direction.down))).all()
    env_i = torch.arange(e)
    cell = state.grid[env_i, door[:, 0].long(), door[:, 1].long()]
    assert torch.equal(cell, torch.stack([torch.full_like(color, TYPE_DOOR), color,
                                          torch.full_like(color, STATE_LOCKED)], -1))

    state, pos = env.add_object(state, keys[1], 2, 0, TYPE_KEY, 3)
    tx, ty = geom.room_top(2, 0)
    rs = geom.room_size
    assert ((pos[:, 0] > tx) & (pos[:, 0] < tx + rs - 1)
            & (pos[:, 1] > ty) & (pos[:, 1] < ty + rs - 1)).all()
    cell = state.grid[env_i, pos[:, 0].long(), pos[:, 1].long()]
    assert (cell == torch.tensor([TYPE_KEY, 3, 0], dtype=torch.int32)).all()

    state = env.add_distractors(state, keys[2], num_distractors=10)
    grid = state.grid
    added = (grid != start).any(-1)
    assert (added.sum((1, 2)) == 12).all()  # the door, the key, 10 distractors
    kinds = grid[..., 0][added]
    assert np.isin(kinds.numpy(), (TYPE_DOOR, TYPE_KEY, TYPE_BALL, TYPE_BOX)).all()
    objects = added & (grid[..., 0] != TYPE_DOOR)  # the door replaced a wall
    assert (start[..., 0][objects] == TYPE_EMPTY).all()
    mid = torch.tensor(geom.middle_pos())
    xs, ys = torch.meshgrid(torch.arange(grid.shape[1]), torch.arange(grid.shape[2]),
                            indexing='ij')
    near = ((xs - mid[0]).abs() + (ys - mid[1]).abs()) <= 1
    assert not (added & near).any()

    state = env.place_agents_in_room(state, keys[3], 0, 2)
    ax, ay = state.agent_pos[..., 0], state.agent_pos[..., 1]
    tx, ty = geom.room_top(0, 2)
    assert ((ax > tx) & (ax < tx + rs - 1) & (ay > ty) & (ay < ty + rs - 1)).all()
    vec = torch.as_tensor(DIR_TO_VEC)[state.agent_dir.long()]
    front = state.grid[env_i[:, None], (ax + vec[..., 0]).long(), (ay + vec[..., 1]).long()]
    assert np.isin(front[..., 0].numpy(), (TYPE_EMPTY, TYPE_WALL)).all()


# ------------------------------------------------------- success predicates

def _rbd_facing_blue(env):
    _, state = env.reset(3)
    bx, by = state.extras['blue_pos'][0].tolist()
    pos = state.agent_pos.clone()
    pos[0, 0] = torch.tensor([bx - 1, by])
    return state.replace(agent_pos=pos, agent_dir=torch.zeros_like(state.agent_dir))


def _step(env, state, action):
    n = env.num_agents
    actions = torch.full((1, n), int(action), dtype=torch.int32)
    _, state, rew, term, _ = env.step_with_order(state, actions, torch.arange(n)[None])
    return state, rew, term


def test_redbluedoors_success_requires_red_first():
    """Success ⇔ both doors open at the end; the failure branch (blue
    first) terminates the agents too, and is no success."""
    env = make('MultiGrid-RedBlueDoors-6x6-v0', agents=1, device='cpu')
    state, rew, term = _step(env, _rbd_facing_blue(env), Action.toggle)
    assert term.all() and not env.success(state).any() and float(rew.sum()) == 0.0

    state = _rbd_facing_blue(env)
    rx, ry = state.extras['red_pos'][0].tolist()
    grid = state.grid.clone()
    grid[0, rx, ry, 2] = STATE_OPEN
    state, rew, term = _step(env, state.replace(grid=grid), Action.toggle)
    assert term.all() and env.success(state).all() and float(rew.sum()) > 0


def test_locked_hallway_success_is_all_doors():
    """Success ⇔ every door unlocked; some doors bank reward, not success."""
    env = make('MultiGrid-LockedHallway-2Rooms-v0', agents=2, device='cpu')
    _, state = env.reset(5)
    assert not env.success(state).any()
    for unlocked, want in (([True, False], False), ([True, True], True)):
        s = state.replace(extras={**state.extras,
                                  'door_unlocked': torch.tensor([unlocked])})
        assert env.success(s).tolist() == [want]


def test_bup_success_is_termination():
    """Agents terminate only through the box-pickup success, so any agent
    terminated is exact."""
    env = make('MultiGrid-BlockedUnlockPickup-v0', agents=2, device='cpu')
    _, state = env.reset(7)
    assert not env.success(state).any()
    done = state.replace(agent_terminated=torch.ones_like(state.agent_terminated))
    assert env.success(done).all()


def test_vectorenv_success_uses_pre_reset_state():
    """An agent that holds the target box ends its episode with success,
    read on the final state, not the fresh one the env resets to."""
    venv = VectorEnv(make('MultiGrid-BlockedUnlockPickup-v0', agents=2, device='cpu'), 4,
                     reset_pool=False)
    _, state = venv.reset(seed=1)
    carry = state.agent_carrying.clone()
    carry[0, 1] = state.extras['target_enc'][0]
    state = state.replace(agent_carrying=carry)
    _, new, rew, term, _, done, success = venv.step(
        state, torch.full((4, 2), int(Action.done)))
    assert done.tolist() == [True, False, False, False]
    assert success.tolist() == [True, False, False, False]
    assert (rew[0] > 0).all() and not new.agent_terminated[0].any()
    assert not venv.env.success(new).any()


# ------------------------------------------------- the extras of a reset

@pytest.mark.parametrize('env_id', ['MultiGrid-BlockedUnlockPickup-v0',
                                    'MultiGrid-RedBlueDoors-6x6-v0',
                                    'MultiGrid-LockedHallway-2Rooms-v0'])
def test_done_env_takes_the_fresh_layouts_extras(env_id):
    """Agents that only take the done action truncate at step 3 and reset;
    each env's extras must be those of its new layout (mission color = the
    box's color, door positions = the doors' cells, no door counted), not
    its old episode's: the exact reset here, the reserve pool's in
    tests/test_torch_pool.py."""
    venv = VectorEnv(make(env_id, agents=2, max_steps=3, device='cpu'), 32, reset_pool=False)
    obs, state = venv.reset(seed=4)
    for t in range(6):
        obs, state, _, _, _, done, _ = venv.step(state, torch.full((32, 2), int(Action.done)))
    assert done.all()  # step 6 ended every env's second episode
    grid = state.grid
    env_i = torch.arange(32)
    if 'mission_color' in state.extras:
        box = (grid[..., 0] == TYPE_BOX)
        box_color = torch.where(box, grid[..., 1], 0).sum((1, 2))
        assert torch.equal(state.extras['mission_color'], box_color)
        assert torch.equal(obs['mission'][:, 0], box_color * 2)
    if 'red_pos' in state.extras:
        for key, color in (('red_pos', 0), ('blue_pos', 2)):
            p = state.extras[key].long()
            cell = grid[env_i, p[:, 0], p[:, 1]]
            assert (cell[:, 0] == TYPE_DOOR).all() and (cell[:, 1] == color).all()
            assert (cell[:, 2] == STATE_CLOSED).all()
    if 'door_unlocked' in state.extras:
        assert not state.extras['door_unlocked'].any()


def test_clone_shares_no_extras():
    env = make('MultiGrid-LockedHallway-2Rooms-v0', agents=2, device='cpu')
    state = env.reset_core(prng.split(prng.key(0), 4)).clone()
    copy = state.clone()
    copy.extras['door_unlocked'][0, 0] = True
    assert not state.extras['door_unlocked'].any()
