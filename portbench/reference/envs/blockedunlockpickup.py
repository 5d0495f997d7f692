"""Blocked-unlock-pickup environment
(reference: multigrid/envs/blockedunlockpickup.py:10).

Two rooms joined by a locked door that is blocked by a ball. Agents must move
the ball, fetch the key, unlock the door, and pick up the box in the far room.
Cooperative by default: everyone is rewarded when any agent holds the box.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import (
    NUM_BASE_COLORS,
    STATE_LOCKED,
    TYPE_BALL,
    TYPE_BOX,
    TYPE_KEY,
    Color,
    Direction,
)
from ..core.state import MultiGridState
from ..ops.place import set_cell
from ..ops.step import apply_success, success_reward
from . import layout
from .roomgrid import RoomGrid, encodings
from ..utils import prng
from ..utils.device import constant



class BlockedUnlockPickupEnv(RoomGrid):
    """Pick up the box behind the blocked, locked door
    (envs/blockedunlockpickup.py:104-175).

    Registered: ``MultiGrid-BlockedUnlockPickup-v0``. Extras: ``target_enc``
    (E, 3), the box to pick up, and ``mission_color`` (E,), its color.
    """

    def __init__(
        self,
        room_size: int = 6,
        max_steps: int | None = None,
        joint_reward: bool = True,
        **kwargs,
    ):
        assert room_size >= 4
        super().__init__(
            num_rows=1,
            num_cols=2,
            room_size=room_size,
            max_steps=max_steps or (16 * room_size**2),
            joint_reward=joint_reward,
            success_termination_mode='any',
            **kwargs,
        )

    def mission_of(self, state: MultiGridState, env: int = 0) -> str:
        color = Color.from_index(int(state.extras['mission_color'][env])).value
        return f"pick up the {color} box"

    def mission_index(self, state: MultiGridState) -> torch.Tensor:
        """(E,) index into :attr:`mission_space`: the space is the (color,
        type) product with type 'box' first, so an episode's index is
        ``color_index * 2``."""
        return state.extras['mission_color'] * 2

    @property
    def mission_space(self):
        """Missions over (color, object type): the reference enumerates
        [list(Color), [Type.box, Type.key]] (blockedunlockpickup.py:123-126),
        12 missions, though only box missions are issued."""
        from ..core.mission import MissionSpace
        return MissionSpace(
            mission_func=lambda color, obj_type: f"pick up the {color} {obj_type}",
            ordered_placeholders=[[c.value for c in Color], ['box', 'key']],
        )

    def _gen_grid(self, keys: torch.Tensor) -> MultiGridState:
        """Batched layouts (envs/blockedunlockpickup.py:142-164): box in the
        right room, locked door between the rooms, a ball left of the door
        blocking it, the matching key in the left room, agents in the left
        room; draw ``i`` from key ``i`` of ``split(keys, 7 + N)``, as the JAX
        package splits them (blockedunlockpickup.py:79-129)."""
        e = keys.shape[0]
        k = prng.split(keys, 7 + self.cfg.num_agents)
        # Agents start at the middle room's center, so the next-to-agent
        # filter sees them while objects are placed (core/roomgrid.py:231-236).
        state = self._init_room_state(e)

        # Box (random color) in the right room.
        box_color = prng.randint(k[:, 0], (), 0, NUM_BASE_COLORS)
        state, _ = self.add_object(state, k[:, 1], 1, 0, TYPE_BOX, box_color)

        # Locked door (random color, random height) on the shared wall.
        door_color = prng.randint(k[:, 2], (), 0, NUM_BASE_COLORS)
        state, door_pos = self.add_door(state, k[:, 3], 0, 0, Direction.right,
                                        door_color, locked=True)

        # The blocking ball (random color) directly left of the door.
        ball_color = prng.randint(k[:, 4], (), 0, NUM_BASE_COLORS)
        state = state.replace(grid=set_cell(
            state.grid, door_pos - constant([1, 0], self.device, torch.int32),
            encodings(TYPE_BALL, ball_color)))

        # The key of the door's color, in the left room.
        state, _ = self.add_object(state, k[:, 5], 0, 0, TYPE_KEY, door_color)

        # Agents in the left room, with the front-cell retry.
        state = self.place_agents_in_room(state, k[:, 6], 0, 0)
        box_enc = encodings(TYPE_BOX, box_color)
        return state.replace(extras={'target_enc': box_enc, 'mission_color': box_color})

    def post_step(self, prev_state, state, actions, rewards, terminations, action_mask):
        """Success when any agent carries the target box
        (envs/blockedunlockpickup.py:166-175); the reference fires again
        every step the box is held, and so does this."""
        cfg = self.cfg
        target = state.extras['target_enc']
        reward_value = success_reward(state.step_count, cfg.max_steps)
        agent_iota = torch.arange(cfg.num_agents, device=state.device)
        terminated = state.agent_terminated
        for i in range(cfg.num_agents):
            fire = (state.agent_carrying[:, i] == target).all(-1)
            terminated, rewards = apply_success(
                cfg, (agent_iota == i).expand_as(terminated), fire, terminated, rewards,
                reward_value)
        state = state.replace(agent_terminated=terminated)
        return state, rewards, terminated

    # ------------------------------------------------------------ parity mode

    def _gen_grid_parity(self, G: np.random.Generator) -> dict:
        """Host-side layout consuming draws in reference order
        (envs/blockedunlockpickup.py:142-164)."""
        geom = self.geometry
        data = self._parity_init()
        grid, agent_pos, agent_dir = data['grid'], data['agent_pos'], data['agent_dir']

        box_color = int(G.integers(0, 6))
        self._parity_place_in_room(G, grid, agent_pos, layout.box(box_color), 1, 0)

        door_color = int(G.integers(0, 6))
        _, door_x, lo, hi = geom.door_wall_span(0, 0, Direction.right)
        door_y = int(G.integers(lo, hi))
        grid[door_x, door_y] = layout.door(door_color, STATE_LOCKED)

        ball_color = int(G.integers(0, 6))
        grid[door_x - 1, door_y] = layout.ball(ball_color)

        self._parity_place_in_room(G, grid, agent_pos, layout.key(door_color), 0, 0)

        for a in range(self.cfg.num_agents):
            self._parity_place_agent_in_room(G, grid, agent_pos, agent_dir, a, col=0, row=0)

        return dict(
            grid=grid, agent_pos=agent_pos, agent_dir=agent_dir,
            extras={'target_enc': np.asarray(layout.box(box_color)),
                    'mission_color': np.int32(box_color)},
        )
