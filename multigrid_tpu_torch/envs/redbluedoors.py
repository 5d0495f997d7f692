"""Red-then-blue doors environment (reference: multigrid/envs/redbluedoors.py:10).

A room with a red door on the left wall and a blue door on the right wall.
Agents must open the red door first, then the blue door; opening the blue
door while the red one is closed is a failure (and the blue door snaps shut).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.actions import Action
from ..core.constants import (
    COLOR_BLUE,
    COLOR_RED,
    DIR_TO_VEC,
    STATE_CLOSED,
    STATE_OPEN,
)
from ..core.state import MultiGridState, init_state
from ..ops.place import set_cell
from ..ops.step import apply_failure, apply_success, success_reward
from . import layout
from .env import MultiGridEnv
from .roomgrid import forward_cell, place_agents_device
from ..utils import prng
from ..utils.device import constant



class RedBlueDoorsEnv(MultiGridEnv):
    """Open the red door then the blue door (envs/redbluedoors.py:104-187).

    Registered: ``MultiGrid-RedBlueDoors-{6x6,8x8}-v0``. Extras: the doors'
    cells ``red_pos`` and ``blue_pos``, each (E, 2).
    """

    mission = "open the red door then the blue door"
    procedural_reset = True
    #: No Box ever appears in these layouts.
    uses_boxes = False

    def __init__(
        self,
        size: int = 8,
        max_steps: int | None = None,
        joint_reward: bool = True,
        success_termination_mode: str = 'any',
        failure_termination_mode: str = 'any',
        **kwargs,
    ):
        self.size = size
        super().__init__(
            width=2 * size,
            height=size,
            max_steps=max_steps or (20 * size**2),
            joint_reward=joint_reward,
            success_termination_mode=success_termination_mode,
            failure_termination_mode=failure_termination_mode,
            **kwargs,
        )
        # Static layout: outer walls and the inner room (envs/redbluedoors.py:148-152).
        w, h = self.cfg.width, self.cfg.height
        self.room_top = (w // 4, 0)
        self.room_size = (w // 2, h)
        grid = layout.empty_grid(w, h)
        layout.wall_rect(grid, 0, 0, w, h)
        layout.wall_rect(grid, *self.room_top, *self.room_size)
        self._layout = grid
        self._red_x = self.room_top[0]
        self._blue_x = self.room_top[0] + self.room_size[0] - 1

    def _gen_grid(self, keys: torch.Tensor) -> MultiGridState:
        """Agents inside the room, then the two doors at random heights of
        its walls (envs/redbluedoors.py:155-168; agents are placed first, so
        the door cells are walls while they are), from the keys of
        ``split(keys, 3)`` (redbluedoors.py:74-95)."""
        cfg, dev, e = self.cfg, self.device, keys.shape[0]
        k = prng.split(keys, 3)
        state = init_state(e, cfg.width, cfg.height, cfg.num_agents, dev,
                           has_boxes=self.uses_boxes)
        grid = constant(self._layout, dev)
        state = state.replace(grid=grid.expand(state.grid.shape))
        state = place_agents_device(state, k[:, 0], top=self.room_top, size=self.room_size)
        red_y = prng.randint(k[:, 1], (), 1, cfg.height - 1)
        blue_y = prng.randint(k[:, 2], (), 1, cfg.height - 1)
        red_pos = torch.stack([torch.full_like(red_y, self._red_x), red_y], -1)
        blue_pos = torch.stack([torch.full_like(blue_y, self._blue_x), blue_y], -1)
        grid = set_cell(state.grid, red_pos, layout.door(COLOR_RED, STATE_CLOSED))
        grid = set_cell(grid, blue_pos, layout.door(COLOR_BLUE, STATE_CLOSED))
        return state.replace(grid=grid, extras={'red_pos': red_pos, 'blue_pos': blue_pos})

    @staticmethod
    def _door_state(grid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        env = torch.arange(grid.shape[0], device=grid.device)
        return grid[env, pos[:, 0].long(), pos[:, 1].long(), 2]

    def post_step(self, prev_state, state, actions, rewards, terminations, action_mask):
        """Success or failure after the step (envs/redbluedoors.py:170-187):
        each agent, in index order, that toggled while facing the open blue
        door succeeds if the red door is open, else fails, and the blue door
        closes again."""
        cfg, dev = self.cfg, state.device
        e, n = state.agent_dir.shape
        red_pos, blue_pos = state.extras['red_pos'], state.extras['blue_pos']
        if action_mask is None:
            action_mask = torch.ones((e, n), dtype=torch.bool, device=dev)
        dir_vec = constant(DIR_TO_VEC, dev)
        reward_value = success_reward(state.step_count, cfg.max_steps)
        env = torch.arange(e, device=dev)
        bx, by = blue_pos[:, 0].long(), blue_pos[:, 1].long()
        agent_iota = torch.arange(n, device=dev)
        grid, terminated = state.grid, state.agent_terminated
        red_open = self._door_state(grid, red_pos) == STATE_OPEN
        for i in range(n):  # the reference's dict order, 0..N-1
            fwd = forward_cell(state.agent_pos[:, i], state.agent_dir[:, i], dir_vec)
            facing_blue = (fwd == blue_pos).all(-1)
            blue_open = grid[env, bx, by, 2] == STATE_OPEN
            fire = (action_mask[:, i] & (actions[:, i] == int(Action.toggle))
                    & facing_blue & blue_open)
            success = fire & red_open
            failure = fire & ~red_open
            oh = (agent_iota == i).expand(e, n)
            terminated, rewards = apply_success(
                cfg, oh, success, terminated, rewards, reward_value)
            terminated = apply_failure(cfg, oh, failure, terminated)
            # A failure closes the blue door again (redbluedoors.py:186).
            if i == 0:
                grid = grid.clone()
            grid[env, bx, by, 2] = torch.where(failure, STATE_CLOSED, grid[env, bx, by, 2])
        # on_success/on_failure set the returned flags and the agents' alike.
        state = state.replace(grid=grid, agent_terminated=terminated)
        return state, rewards, terminated

    def success(self, state: MultiGridState) -> torch.Tensor:
        """Task complete ⇔ both doors are open: success leaves red and blue
        open (envs/redbluedoors.py:177-183), failure shuts the blue door
        again (:186), and truncation never opens it. (Any agent terminated
        is wrong here: failure terminates agents too.)"""
        return ((self._door_state(state.grid, state.extras['red_pos']) == STATE_OPEN)
                & (self._door_state(state.grid, state.extras['blue_pos']) == STATE_OPEN))

    # ------------------------------------------------------------ parity mode

    def _gen_grid_parity(self, G: np.random.Generator) -> dict:
        """Host-side layout consuming draws in reference order
        (envs/redbluedoors.py:139-168)."""
        from .parity import parity_place_agent

        cfg = self.cfg
        grid = self._layout.copy()
        agent_pos = np.full((cfg.num_agents, 2), -1, dtype=np.int32)
        agent_dir = np.full((cfg.num_agents,), -1, dtype=np.int32)
        for a in range(cfg.num_agents):
            _, agent_dir[a] = parity_place_agent(
                G, grid, agent_pos, a, self.room_top, self.room_size)
        red_y = int(G.integers(1, cfg.height - 1))
        blue_y = int(G.integers(1, cfg.height - 1))
        grid[self._red_x, red_y] = layout.door(COLOR_RED, STATE_CLOSED)
        grid[self._blue_x, blue_y] = layout.door(COLOR_BLUE, STATE_CLOSED)
        return dict(
            grid=grid, agent_pos=agent_pos, agent_dir=agent_dir,
            extras={'red_pos': np.array([self._red_x, red_y], np.int32),
                    'blue_pos': np.array([self._blue_x, blue_y], np.int32)},
        )
