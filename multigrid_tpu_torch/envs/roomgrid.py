"""Agent placement for the speed-mode reset.

Only :func:`place_agents_device` of ``multigrid_tpu.envs.roomgrid`` is here:
the Empty family's random starts need it. The RoomGrid environments
themselves are not part of the port yet.
"""

from __future__ import annotations

import torch

from ..core.state import MultiGridState
from ..ops.place import place_obj_mask, uniform_position


def place_agents_device(
    state: MultiGridState, generator: torch.Generator | None
) -> MultiGridState:
    """Place all agents one after another, each uniform over the free cells
    of the grid with a random direction (base.py:680-697)."""
    e, n = state.agent_dir.shape
    agent_pos = state.agent_pos.clone()
    agent_dir = state.agent_dir.clone()
    for a in range(n):
        # Clear this agent's own stale position first (the reference's
        # place_agent sets pos=(-1,-1) before sampling, base.py:687-691).
        agent_pos[:, a] = -1
        valid = place_obj_mask(state.grid, agent_pos)
        agent_pos[:, a] = uniform_position(generator, valid)
        agent_dir[:, a] = torch.randint(
            0, 4, (e,), generator=generator, device=state.device,
            dtype=torch.int32)
    return state.replace(agent_pos=agent_pos, agent_dir=agent_dir)
