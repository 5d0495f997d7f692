"""Empty room environment (reference: multigrid/envs/empty.py:10).

Agents race to the green goal square in the bottom-right corner. Default
setting is competitive: first agent to the goal terminates the episode and
takes the (sole) reward.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import Direction
from ..core.state import MultiGridState, state_from_numpy
from . import layout
from .env import MultiGridEnv


class EmptyEnv(MultiGridEnv):
    """Empty grid with a goal in the corner (envs/empty.py:112-170).

    Registered configurations: ``MultiGrid-Empty-{5x5,6x6,8x8,16x16}-v0`` and
    the ``-Random-`` start-position variants.
    """

    mission = "get to the green goal square"
    #: No Box ever appears in these layouts.
    uses_boxes = False

    def __init__(
        self,
        size: int = 8,
        agent_start_pos: tuple[int, int] | None = (1, 1),
        agent_start_dir: Direction | None = Direction.right,
        max_steps: int | None = None,
        joint_reward: bool = False,
        success_termination_mode: str = 'any',
        **kwargs,
    ):
        self.agent_start_pos = agent_start_pos
        self.agent_start_dir = agent_start_dir
        super().__init__(
            grid_size=size,
            max_steps=max_steps or (4 * size**2),
            joint_reward=joint_reward,
            success_termination_mode=success_termination_mode,
            **kwargs,
        )
        # Static layout: outer walls + goal at (w-2, h-2) (envs/empty.py:153-162).
        grid = layout.empty_grid(size, size)
        layout.wall_rect(grid, 0, 0, size, size)
        grid[size - 2, size - 2] = layout.GOAL
        self._layout = grid
        # One env's fresh state, broadcast to a batch at every reset.
        n = self.cfg.num_agents
        fixed = self._fixed_start
        self._template = state_from_numpy(
            grid,
            np.broadcast_to(np.asarray(agent_start_pos if fixed else (-1, -1)), (n, 2)),
            np.full((n,), int(agent_start_dir) if fixed else -1),
            self.device, has_boxes=self.uses_boxes)

    @property
    def _fixed_start(self) -> bool:
        return self.agent_start_pos is not None and self.agent_start_dir is not None

    def _gen_grid(
        self, num_envs: int, generator: torch.Generator | None
    ) -> MultiGridState:
        state = self._template.expand(num_envs)
        if self._fixed_start:
            return state
        # Random starts: sequential uniform placement over free cells
        # (base.py:680-697), one fixed-cost draw per agent.
        from .roomgrid import place_agents_device
        return place_agents_device(state, generator)

    # ------------------------------------------------------------ parity mode

    def _gen_grid_parity(self, G: np.random.Generator) -> dict:
        """Host-side layout generation consuming numpy draws in exactly the
        reference's order (envs/empty.py:153-170 + base.py:604-697)."""
        cfg = self.cfg
        grid = self._layout.copy()
        agent_pos = np.full((cfg.num_agents, 2), -1, dtype=np.int32)
        agent_dir = np.full((cfg.num_agents,), -1, dtype=np.int32)

        for a in range(cfg.num_agents):
            if self._fixed_start:
                agent_pos[a] = self.agent_start_pos
                agent_dir[a] = int(self.agent_start_dir)
            else:
                from .parity import parity_place_obj
                agent_pos[a] = parity_place_obj(G, grid, agent_pos, None)
                agent_dir[a] = G.integers(0, 4)

        return dict(grid=grid, agent_pos=agent_pos, agent_dir=agent_dir)
