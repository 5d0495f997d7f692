"""Rooms-in-a-grid procedural base environment.

Counterpart of ``multigrid_tpu.envs.roomgrid`` (the reference ``RoomGrid``,
multigrid/core/roomgrid.py:139): the static room lattice is built on the
host once; the random parts of a layout (door positions and colors, object
placement, agent placement with the front-cell retry) are batched draws over
the env axis from each env's key, split as the JAX package splits it, so a
layout is bit-equal to the JAX package's from the same key; or host-side in
parity mode, consuming numpy draws in the reference's exact order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import (
    DIR_TO_VEC,
    NUM_BASE_COLORS,
    STATE_CLOSED,
    STATE_LOCKED,
    TYPE_BALL,
    TYPE_BOX,
    TYPE_DOOR,
    TYPE_EMPTY,
    TYPE_KEY,
    TYPE_WALL,
    Direction,
)
from ..core.state import MultiGridState, init_state
from ..ops.place import (
    agent_occupancy,
    argmax_bits,
    place_obj_mask,
    set_cell,
    uniform_position,
)
from ..utils import prng
from . import layout
from .env import MultiGridEnv
from ..utils.device import constant


def opposite(direction: int) -> int:
    """The direction facing ``direction`` (roomgrid.py:35)."""
    return (direction + 2) % 4


class RoomGeometry:
    """Static geometry of the room lattice (host-side)."""

    def __init__(self, room_size: int, num_rows: int, num_cols: int):
        assert room_size >= 3 and num_rows > 0 and num_cols > 0
        self.room_size = room_size
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.width = (room_size - 1) * num_cols + 1
        self.height = (room_size - 1) * num_rows + 1

    def room_top(self, col: int, row: int) -> tuple[int, int]:
        rs = self.room_size
        return (col * (rs - 1), row * (rs - 1))

    @property
    def room_shape(self) -> tuple[int, int]:
        return (self.room_size, self.room_size)

    def middle_pos(self) -> tuple[int, int]:
        """Initial agent position: center of the middle room, facing right
        (core/roomgrid.py:231-236)."""
        rs = self.room_size
        return (
            (self.num_cols // 2) * (rs - 1) + (rs // 2),
            (self.num_rows // 2) * (rs - 1) + (rs // 2),
        )

    def base_grid(self) -> np.ndarray:
        """Wall lattice for all rooms (core/roomgrid.py:209-216)."""
        grid = layout.empty_grid(self.width, self.height)
        for row in range(self.num_rows):
            for col in range(self.num_cols):
                tx, ty = self.room_top(col, row)
                layout.wall_rect(grid, tx, ty, self.room_size, self.room_size)
        return grid

    def remove_wall(self, grid: np.ndarray, col: int, row: int, direction: int):
        """Remove the interior wall between two rooms (core/roomgrid.py:333-367)."""
        tx, ty = self.room_top(col, row)
        w = h = self.room_size
        if direction == Direction.right:
            grid[tx + w - 1, ty + 1:ty + h - 1] = layout.EMPTY
        elif direction == Direction.down:
            grid[tx + 1:tx + w - 1, ty + h - 1] = layout.EMPTY
        elif direction == Direction.left:
            grid[tx, ty + 1:ty + h - 1] = layout.EMPTY
        elif direction == Direction.up:
            grid[tx + 1:tx + w - 1, ty] = layout.EMPTY
        else:
            raise ValueError(direction)

    def fixed_door_pos(self, col: int, row: int, direction: int) -> tuple[int, int]:
        """Midpoint door position on a room wall (core/roomgrid.py:104-126,
        random=None branch)."""
        left, top = self.room_top(col, row)
        right = left + self.room_size - 1
        bottom = top + self.room_size - 1
        if direction == Direction.right:
            return (right, (top + bottom) // 2)
        if direction == Direction.down:
            return ((left + right) // 2, bottom)
        if direction == Direction.left:
            return (left, (top + bottom) // 2)
        if direction == Direction.up:
            return ((left + right) // 2, top)
        raise ValueError(direction)

    def door_wall_span(self, col: int, row: int, direction: int):
        """(axis, fixed coordinate, low, high) for a random door position
        draw: the varying coordinate is sampled from [low, high)
        (core/roomgrid.py:104-126, random branch)."""
        left, top = self.room_top(col, row)
        right = left + self.room_size - 1
        bottom = top + self.room_size - 1
        if direction == Direction.right:
            return ('x', right, top + 1, bottom)
        if direction == Direction.down:
            return ('y', bottom, left + 1, right)
        if direction == Direction.left:
            return ('x', left, top + 1, bottom)
        if direction == Direction.up:
            return ('y', top, left + 1, right)
        raise ValueError(direction)

    def has_neighbor(self, col: int, row: int, direction: int) -> bool:
        if direction == Direction.right:
            return col < self.num_cols - 1
        if direction == Direction.down:
            return row < self.num_rows - 1
        if direction == Direction.left:
            return col > 0
        if direction == Direction.up:
            return row > 0
        raise ValueError(direction)

    def neighbor(self, col: int, row: int, direction: int) -> tuple[int, int]:
        dx, dy = DIR_TO_VEC[direction]
        return (col + int(dx), row + int(dy))


### Batched placement helpers ------------------------------------------------


def next_to_agent_mask(agent_pos: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(E, W, H) bool — cells within L2 distance 1 of any agent (the
    ``reject_next_to`` filter, core/roomgrid.py:45-50): the agent cells and
    their orthogonal neighbours."""
    occ = agent_occupancy(agent_pos, width, height)
    pad = torch.nn.functional.pad(occ, (1, 1, 1, 1))
    return (occ | pad[:, :-2, 1:-1] | pad[:, 2:, 1:-1]
            | pad[:, 1:-1, :-2] | pad[:, 1:-1, 2:])


def front_ok_mask(grid: torch.Tensor) -> torch.Tensor:
    """(E, W, H, 4) bool — whether the cell in front of (x, y) facing d is
    empty or a wall (the roomgrid agent-placement retry predicate,
    core/roomgrid.py:398-402). Off the grid counts as a wall (accept)."""
    t = torch.nn.functional.pad(grid[..., 0], (1, 1, 1, 1), value=TYPE_WALL)
    fronts = torch.stack([
        t[:, 2:, 1:-1],    # right: (x+1, y)
        t[:, 1:-1, 2:],    # down:  (x, y+1)
        t[:, :-2, 1:-1],   # left:  (x-1, y)
        t[:, 1:-1, :-2],   # up:    (x, y-1)
    ], dim=-1)
    return (fronts == TYPE_EMPTY) | (fronts == TYPE_WALL)


def uniform_pos_dir(keys: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(position (E, 2), direction (E,)) drawn uniformly over each env's
    (W, H, 4) validity mask from its key (E, 2) — the distribution of the
    reference's redraw-until-the-front-cell-is-ok loop
    (core/roomgrid.py:396-402); the argmax of bits (W, H, 4) as the JAX
    package draws it (roomgrid.py:177-191)."""
    _, w, h, _ = valid.shape
    flat = argmax_bits(prng.bits(keys, (w, h, 4)), valid)
    pos = torch.stack([flat // (h * 4), (flat // 4) % h], dim=-1).to(torch.int32)
    return pos, (flat % 4).to(torch.int32)


def place_agents_device(
    state: MultiGridState,
    keys: torch.Tensor,
    top=None,
    size=None,
    check_front: bool = False,
) -> MultiGridState:
    """Place all agents one after another, each uniform over the free cells
    with a random direction (base.py:680-697); with ``check_front``, the
    roomgrid variant that redraws until the front cell is empty or a wall
    (core/roomgrid.py:373-404). Agent ``a`` draws from the ``a``-th key of
    ``split(keys, N)`` (roomgrid.py:194-230)."""
    n = state.num_agents
    agent_keys = prng.split(keys, n)
    agent_pos = state.agent_pos.clone(memory_format=torch.contiguous_format)
    agent_dir = state.agent_dir.clone(memory_format=torch.contiguous_format)
    front = front_ok_mask(state.grid) if check_front else None
    for a in range(n):
        # Clear this agent's own stale position first (the reference's
        # place_agent sets pos=(-1,-1) before sampling, base.py:687-691).
        agent_pos[:, a].fill_(-1)
        valid = place_obj_mask(state.grid, agent_pos, top, size)
        if check_front:
            agent_pos[:, a], agent_dir[:, a] = uniform_pos_dir(
                agent_keys[:, a], valid[..., None] & front)
        else:
            pair = prng.split(agent_keys[:, a])
            agent_pos[:, a] = uniform_position(pair[:, 0], valid)
            agent_dir[:, a] = prng.randint(pair[:, 1], (), 0, 4)
    return state.replace(agent_pos=agent_pos, agent_dir=agent_dir)


def place_object_device(
    state: MultiGridState,
    keys: torch.Tensor,
    obj_enc,
    top=None,
    size=None,
    reject_next_to: bool = False,
) -> tuple[MultiGridState, torch.Tensor]:
    """Place an object ((3,) or (E, 3) encoding) uniformly over the valid
    cells, from each env's key; returns ``(state, pos)``."""
    _, w, h, _ = state.grid.shape
    valid = place_obj_mask(state.grid, state.agent_pos, top, size)
    if reject_next_to:
        valid = valid & ~next_to_agent_mask(state.agent_pos, w, h)
    pos = uniform_position(keys, valid)
    return state.replace(grid=set_cell(state.grid, pos, obj_enc)), pos


def forward_cell(pos: torch.Tensor, direction: torch.Tensor,
                 dir_vec: torch.Tensor) -> torch.Tensor:
    """(E, 2) cell in front of agents at ``pos`` (E, 2) facing
    ``direction`` (E,); an agent with no direction (-1) faces its own cell."""
    ok = (direction >= 0) & (direction < 4)
    return pos + torch.where(ok[:, None], dir_vec[direction.clamp(0, 3).long()], 0)


def encodings(kind, color, state=0) -> torch.Tensor:
    """(E, 3) int32 cell encodings from (E,) tensors or ints (at least one
    a tensor)."""
    parts = [kind, color, state]
    ref = next(p for p in parts if isinstance(p, torch.Tensor))
    return torch.stack([p.to(torch.int32) if isinstance(p, torch.Tensor)
                        else torch.full_like(ref, p, dtype=torch.int32) for p in parts], -1)


class RoomGrid(MultiGridEnv):
    """Base class for environments built on a room lattice."""

    #: Layouts are generated procedurally, so a ``VectorEnv`` resets them
    #: through its reserve pool by default.
    procedural_reset = True

    def __init__(
        self,
        room_size: int = 7,
        num_rows: int = 3,
        num_cols: int = 3,
        **kwargs,
    ):
        self.geometry = RoomGeometry(room_size, num_rows, num_cols)
        super().__init__(
            width=self.geometry.width, height=self.geometry.height, **kwargs)
        self._base_grid = self.geometry.base_grid()

    @property
    def room_size(self) -> int:
        return self.geometry.room_size

    @property
    def num_rows(self) -> int:
        return self.geometry.num_rows

    @property
    def num_cols(self) -> int:
        return self.geometry.num_cols

    def _init_room_state(self, num_envs: int, base_grid=None) -> MultiGridState:
        """Fresh states with the wall lattice (or ``base_grid``, (W, H, 3)
        numpy or (E, W, H, 3)) and all agents at the middle room's center
        facing right (core/roomgrid.py:203-236)."""
        cfg, dev = self.cfg, self.device
        state = init_state(num_envs, cfg.width, cfg.height, cfg.num_agents, dev,
                           has_boxes=self.uses_boxes)
        grid = self._base_grid if base_grid is None else base_grid
        grid = constant(grid, dev, torch.int32)
        mid = constant(self.geometry.middle_pos(), dev, torch.int32)
        return state.replace(
            grid=grid.expand(state.grid.shape),
            agent_pos=mid.expand(num_envs, cfg.num_agents, 2),
            agent_dir=torch.zeros_like(state.agent_dir))

    # ------------------------------------------------- batched builders
    # The layout-building API for custom environments, mirroring the
    # reference RoomGrid methods (core/roomgrid.py:238-495) on batches; each
    # draws from the envs' keys (E, 2) as the JAX package's does from one.

    def place_in_room(self, state: MultiGridState, keys, obj_enc,
                      col: int, row: int) -> tuple[MultiGridState, torch.Tensor]:
        """Place an object at a random empty position in a room, rejecting
        cells next to agents (core/roomgrid.py:238-256)."""
        return place_object_device(
            state, keys, obj_enc, top=self.geometry.room_top(col, row),
            size=self.geometry.room_shape, reject_next_to=True)

    def add_object(self, state: MultiGridState, keys, col: int, row: int,
                   kind, color) -> tuple[MultiGridState, torch.Tensor]:
        """Add an object of a given type and color ((E,) tensors or ints) to
        a room (core/roomgrid.py:258-281)."""
        e = state.num_envs
        enc = encodings(constant(kind, self.device, torch.int32).expand(e), color)
        return self.place_in_room(state, keys, enc, col, row)

    def add_door(self, state: MultiGridState, keys, col: int, row: int,
                 direction: int, color, locked: bool = False,
                 rand_pos: bool = True) -> tuple[MultiGridState, torch.Tensor]:
        """Add a door on a room wall (core/roomgrid.py:283-331): at a random
        (``randint(keys)``) or the midpoint position of the wall, returning
        ``(state, pos)``."""
        e, geom = state.num_envs, self.geometry
        if rand_pos:
            axis, fixed, lo, hi = geom.door_wall_span(col, row, direction)
            coord = prng.randint(keys, (), lo, hi)
            fixed = torch.full_like(coord, fixed)
            pos = torch.stack([fixed, coord] if axis == 'x' else [coord, fixed], -1)
        else:
            pos = torch.as_tensor(geom.fixed_door_pos(col, row, direction),
                                  dtype=torch.int32, device=self.device).expand(e, 2)
        color = torch.as_tensor(color, dtype=torch.int32, device=self.device).expand(e)
        enc = encodings(TYPE_DOOR, color, STATE_LOCKED if locked else STATE_CLOSED)
        return state.replace(grid=set_cell(state.grid, pos, enc)), pos

    def place_agents_in_room(self, state: MultiGridState, keys, col: int,
                             row: int) -> MultiGridState:
        """Place all agents in a room with the front-cell retry
        (core/roomgrid.py:373-404)."""
        return place_agents_device(
            state, keys, top=self.geometry.room_top(col, row),
            size=self.geometry.room_shape, check_front=True)

    def add_distractors(self, state: MultiGridState, keys,
                        num_distractors: int = 10) -> MultiGridState:
        """Scatter random objects (ball, key or box of a random color) into
        random rooms (core/roomgrid.py:454-495, which crashes in the
        reference on a latent ``set.append``; correct here). Distractor
        ``d`` draws from keys ``4d .. 4d + 3`` of ``split(keys, 4·n)``
        (roomgrid.py:366-392)."""
        geom = self.geometry
        kinds = constant([TYPE_BALL, TYPE_KEY, TYPE_BOX], self.device, torch.int32)
        rs = geom.room_size
        sub = prng.split(keys, 4 * num_distractors)
        for d in range(num_distractors):
            kind = kinds[prng.randint(sub[:, 4 * d], (), 0, 3).long()]
            color = prng.randint(sub[:, 4 * d + 1], (), 0, NUM_BASE_COLORS)
            room = prng.randint(sub[:, 4 * d + 2], (2,), 0, [geom.num_cols, geom.num_rows])
            state, _ = place_object_device(
                state, sub[:, 4 * d + 3], encodings(kind, color), top=room * (rs - 1),
                size=(rs, rs), reject_next_to=True)
        return state


    # ----------------------------------------------------------- parity side

    def _parity_init(self) -> dict:
        """Host-side fresh layout dict with agents at the middle."""
        cfg = self.cfg
        mid = self.geometry.middle_pos()
        return dict(
            grid=self._base_grid.copy(),
            agent_pos=np.tile(np.asarray(mid, np.int32), (cfg.num_agents, 1)),
            agent_dir=np.zeros((cfg.num_agents,), dtype=np.int32),
        )

    def _parity_place_in_room(self, G, grid, agent_pos, obj_enc, col: int,
                              row: int) -> np.ndarray:
        """place_in_room: rejection with the next-to-agent filter
        (core/roomgrid.py:238-256)."""
        from .parity import parity_place_obj

        def reject_next_to(pos):
            d = np.linalg.norm(np.asarray(pos) - agent_pos, axis=-1)
            return bool((d <= 1).any())

        return parity_place_obj(
            G, grid, agent_pos, obj_enc, self.geometry.room_top(col, row),
            self.geometry.room_shape, reject_fn=reject_next_to, max_tries=1000)

    def _parity_place_agent_in_room(self, G, grid, agent_pos, agent_dir,
                                    agent_idx: int, col: int | None = None,
                                    row: int | None = None) -> None:
        """Roomgrid agent placement with the front-cell retry
        (core/roomgrid.py:373-404), drawing from G in reference order."""
        from .parity import parity_place_agent

        col = col if col is not None else int(G.integers(0, self.num_cols))
        row = row if row is not None else int(G.integers(0, self.num_rows))
        top = self.geometry.room_top(col, row)
        size = self.geometry.room_shape
        while True:
            pos, dirn = parity_place_agent(
                G, grid, agent_pos, agent_idx, top, size, max_tries=1000)
            fx, fy = np.asarray(pos) + DIR_TO_VEC[dirn]
            if grid[fx, fy, 0] in (TYPE_EMPTY, TYPE_WALL):
                break
        agent_dir[agent_idx] = dirn


__all__ = ['RoomGeometry', 'RoomGrid', 'forward_cell', 'front_ok_mask', 'next_to_agent_mask',
           'place_agents_device', 'place_object_device', 'uniform_pos_dir']
