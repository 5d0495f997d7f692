"""Locked hallway environment (reference: multigrid/envs/locked_hallway.py:13).

A central hallway with locked, color-coded rooms on either side. Keys are
chained: some start in the hallway, the rest inside rooms that earlier keys
unlock. Agents are rewarded per door unlocked; the episode terminates when
every door has been unlocked.
"""

from __future__ import annotations

from math import ceil

import numpy as np
import torch

from ..core.actions import Action
from ..core.constants import (
    DIR_TO_VEC,
    NUM_BASE_COLORS,
    STATE_LOCKED,
    TYPE_DOOR,
    TYPE_KEY,
    Direction,
)
from ..core.state import MultiGridState
from ..ops.place import place_obj_mask, set_cell, uniform_position
from ..ops.step import success_reward
from . import layout
from .roomgrid import RoomGrid, encodings, forward_cell, place_agents_device
from ..utils import prng
from ..utils.device import constant


_LEFT, _HALLWAY, _RIGHT = range(3)  # room columns


class LockedHallwayEnv(RoomGrid):
    """Unlock all the doors (envs/locked_hallway.py:64-227).

    Registered: ``MultiGrid-LockedHallway-{2,4,6}Rooms-v0``. Extras:
    ``door_unlocked`` (E, num_rooms), the doors already rewarded.
    """

    mission = "unlock all the doors"
    #: No Box ever appears in these layouts.
    uses_boxes = False

    def __init__(
        self,
        num_rooms: int = 6,
        room_size: int = 5,
        max_hallway_keys: int = 1,
        max_keys_per_room: int = 2,
        max_steps: int | None = None,
        joint_reward: bool = True,
        **kwargs,
    ):
        assert room_size >= 4
        assert num_rooms % 2 == 0
        self.num_rooms = num_rooms
        self.max_hallway_keys = max_hallway_keys
        self.max_keys_per_room = max_keys_per_room
        super().__init__(
            room_size=room_size,
            num_rows=(num_rooms // 2),
            num_cols=3,
            max_steps=max_steps or (8 * num_rooms * room_size**2),
            joint_reward=joint_reward,
            **kwargs,
        )
        geom = self.geometry
        # The hallway is the middle column with its inner walls removed
        # (locked_hallway.py:162-164).
        for row in range(geom.num_rows - 1):
            geom.remove_wall(self._base_grid, _HALLWAY, row, Direction.down)
        self._hallway_top = geom.room_top(_HALLWAY, 0)
        self._hallway_size = (geom.room_size, geom.height)
        # Door positions are fixed (rand_pos=False, locked_hallway.py:167-174):
        # room r = row*2 + side, side 0 = LEFT (door on its right wall),
        # side 1 = RIGHT (door on its left wall).
        self._door_pos = np.array([
            geom.fixed_door_pos(_LEFT if r % 2 == 0 else _RIGHT, r // 2,
                                Direction.right if r % 2 == 0 else Direction.left)
            for r in range(num_rooms)], dtype=np.int32)
        # Top-left corner of the room behind door r.
        self._room_tops = np.array([
            geom.room_top(_LEFT if r % 2 == 0 else _RIGHT, r // 2)
            for r in range(num_rooms)], dtype=np.int32)

    def _gen_grid(self, keys: torch.Tensor) -> MultiGridState:
        """Batched layouts (locked_hallway.py:149-194): a shuffled color
        sequence, one locked door per room, chained key placement, agents in
        the hallway; from the keys of ``split(keys, 6)`` as the JAX package
        splits them (locked_hallway.py:98-200)."""
        e, nr, dev = keys.shape[0], self.num_rooms, self.device
        k_seq, k_doors, k_nhall, k_group, k_place, k_agents = prng.split(keys, 6).unbind(1)
        # color_sequence: a shuffled cycle of colors, cut to num_rooms
        # (locked_hallway.py:159-160).
        reps = ceil(nr / NUM_BASE_COLORS)
        pool = torch.arange(NUM_BASE_COLORS, dtype=torch.int32, device=dev).repeat(reps)
        color_sequence = pool[prng.permutation(k_seq, pool.numel())[:, :nr]]   # (E, nr)
        # Door colors: an independent shuffle of the sequence, given to the
        # rooms in creation order by popping from its end
        # (locked_hallway.py:166-174).
        perm = prng.permutation(k_doors, nr)
        door_color = color_sequence.gather(1, perm).flip(-1)     # room r: pop() r

        grid = constant(self._base_grid, dev).expand(e, -1, -1, -1).clone()
        dx, dy = (constant(self._door_pos[:, k], dev, torch.long) for k in (0, 1))
        grid[:, dx, dy] = encodings(TYPE_DOOR, door_color.reshape(-1), STATE_LOCKED) \
            .reshape(e, nr, 3)
        state = self._init_room_state(e, base_grid=grid)

        # The room each color opens; a later room wins a repeated color, as
        # the reference's dict overwrite does (locked_hallway.py:170-171).
        color_iota = torch.arange(NUM_BASE_COLORS, device=dev)
        room_of_color = torch.zeros((e, NUM_BASE_COLORS), dtype=torch.long, device=dev)
        for r in range(nr):
            room_of_color = torch.where(color_iota == door_color[:, r:r + 1], r, room_of_color)

        # Chained keys (locked_hallway.py:176-190): the first
        # num_hallway_keys keys go in the hallway; the rest come in groups,
        # each in the room opened by the key before the group.
        num_hallway_keys = prng.randint(k_nhall, (), 1, self.max_hallway_keys + 1)
        group_keys, place_keys = prng.split(k_group, nr), prng.split(k_place, nr)
        room_tops = constant(self._room_tops, dev)
        hall_top = constant(self._hallway_top, dev, torch.int32)
        hall_size = constant(self._hallway_size, dev, torch.int32)
        room_shape = constant(self.geometry.room_shape, dev, torch.int32)
        group_room = torch.zeros((e,), dtype=torch.long, device=dev)
        remaining = torch.zeros((e,), dtype=torch.int32, device=dev)
        grid = state.grid
        for k in range(nr):
            in_hallway = k < num_hallway_keys
            start_group = ~in_hallway & (remaining == 0)
            size_draw = prng.randint(group_keys[:, k], (), 1, self.max_keys_per_room + 1)
            prev_color = color_sequence[:, max(k - 1, 0)].long()
            prev_room = room_of_color.gather(1, prev_color[:, None])[:, 0]
            group_room = torch.where(start_group, prev_room, group_room)
            remaining = torch.where(start_group, size_draw, remaining)
            top = torch.where(in_hallway[:, None], hall_top, room_tops[group_room])
            size = torch.where(in_hallway[:, None], hall_size, room_shape)
            pos = uniform_position(place_keys[:, k],
                                   place_obj_mask(grid, state.agent_pos, top, size))
            grid = set_cell(grid, pos, encodings(TYPE_KEY, color_sequence[:, k]))
            remaining = torch.where(in_hallway, remaining, remaining - 1)
        state = state.replace(grid=grid)

        # Agents in the hallway (plain placement, no front-cell retry:
        # locked_hallway.py:192-194 calls MultiGridEnv.place_agent).
        state = place_agents_device(state, k_agents, top=self._hallway_top,
                                    size=self._hallway_size)

        return state.replace(extras={
            'door_unlocked': torch.zeros((e, nr), dtype=torch.bool, device=dev)})

    def post_step(self, prev_state, state, actions, rewards, terminations, action_mask):
        """Per-door unlock rewards and the all-doors termination
        (locked_hallway.py:203-227). A toggling agent facing a door that is
        no longer locked and not yet counted earns the reward (for everyone,
        if joint); the returned terminations flip when every door is
        unlocked, without touching agent state (the reference only updates
        the returned dict)."""
        cfg, dev = self.cfg, state.device
        e, n = state.agent_dir.shape
        if action_mask is None:
            action_mask = torch.ones((e, n), dtype=torch.bool, device=dev)
        unlocked = state.extras['door_unlocked']
        door_pos = constant(self._door_pos, dev)
        dir_vec = constant(DIR_TO_VEC, dev)
        reward_value = success_reward(state.step_count, cfg.max_steps)
        # The doors' cells sit at fixed positions: one gather for all.
        door_encs = state.grid[:, door_pos[:, 0].long(), door_pos[:, 1].long()]  # (E, D, 3)
        agent_iota = torch.arange(n, device=dev)
        for i in range(n):
            fwd = forward_cell(state.agent_pos[:, i], state.agent_dir[:, i], dir_vec)
            matches = (fwd[:, None, :] == door_pos[None]).all(-1)               # (E, D)
            # Doors are at distinct cells: at most one matches.
            fwd_enc = torch.where(matches[..., None], door_encs, 0).sum(1)
            door_not_locked = (fwd_enc[:, 0] == TYPE_DOOR) & (fwd_enc[:, 2] != STATE_LOCKED)
            not_yet = (matches & ~unlocked).any(-1)
            fire = (action_mask[:, i] & (actions[:, i] == int(Action.toggle))
                    & door_not_locked & matches.any(-1) & not_yet)
            add = torch.where(fire, reward_value, 0.0)[:, None]
            rewards = rewards + (add if cfg.joint_reward else torch.where(
                agent_iota == i, add, 0.0))
            unlocked = unlocked | (matches & fire[:, None])
        terminations = torch.where(unlocked.all(-1)[:, None],
                                   torch.ones_like(terminations), terminations)
        state = state.replace(extras={**state.extras, 'door_unlocked': unlocked})
        return state, rewards, terminations

    def success(self, state: MultiGridState) -> torch.Tensor:
        """Task complete ⇔ every room's door has been unlocked: the exact
        all-doors termination (locked_hallway.py:225-227). Any agent
        terminated never fires here: post_step flips the *returned*
        terminations without touching agent state."""
        return state.extras['door_unlocked'].all(-1)

    # ------------------------------------------------------------ parity mode

    def _gen_grid_parity(self, G: np.random.Generator) -> dict:
        """Host-side layout consuming draws in reference order
        (locked_hallway.py:149-194)."""
        from .parity import parity_place_agent, parity_place_obj

        nr = self.num_rooms
        data = self._parity_init()
        grid, agent_pos, agent_dir = data['grid'], data['agent_pos'], data['agent_dir']

        # Shuffled color cycle (G.shuffle on a Python list, like _rand_perm).
        pool = list(range(NUM_BASE_COLORS)) * ceil(nr / NUM_BASE_COLORS)
        G.shuffle(pool)
        color_sequence = pool[:nr]

        door_colors = list(color_sequence)
        G.shuffle(door_colors)
        room_of_color: dict[int, int] = {}
        for r in range(nr):
            color = door_colors.pop()
            room_of_color[color] = r
            grid[self._door_pos[r, 0], self._door_pos[r, 1]] = layout.door(color, STATE_LOCKED)

        num_hallway_keys = int(G.integers(1, self.max_hallway_keys + 1))
        for key_color in color_sequence[:num_hallway_keys]:
            parity_place_obj(G, grid, agent_pos, layout.key(key_color),
                             self._hallway_top, self._hallway_size)

        key_index = num_hallway_keys
        while key_index < nr:
            room = room_of_color[color_sequence[key_index - 1]]
            num_room_keys = int(G.integers(1, self.max_keys_per_room + 1))
            for key_color in color_sequence[key_index:key_index + num_room_keys]:
                parity_place_obj(G, grid, agent_pos, layout.key(key_color),
                                 tuple(self._room_tops[room]), self.geometry.room_shape)
                key_index += 1

        for a in range(self.cfg.num_agents):
            _, agent_dir[a] = parity_place_agent(
                G, grid, agent_pos, a, self._hallway_top, self._hallway_size)

        return dict(grid=grid, agent_pos=agent_pos, agent_dir=agent_dir,
                    extras={'door_unlocked': np.zeros((nr,), dtype=bool)})
