"""MiniGrid compatibility facade (reference:
multigrid/utils/minigrid_interface.py:12-188).

Counterpart of the JAX package's ``multigrid_tpu/utils/minigrid_interface.py``:
a single-agent view over the Gymnasium adapter so code written against
Farama ``minigrid.MiniGridEnv`` ports by changing imports: scalar
reset/step, the single-agent convenience properties
(``agent_pos``/``agent_dir``/``carrying``/``dir_vec``/``front_pos``),
position/direction/space setters, and ``place_agent`` — the full surface of
the reference shim (minigrid_interface.py:41-188).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..adapters.gym import GymAdapter
from ..core.constants import DIR_TO_VEC, TYPE_EMPTY
from ..envs.env import MultiGridEnv
from . import prng


class MiniGridInterface(GymAdapter):
    """Single-agent scalar facade over the multi-agent dict API.

    >>> env = MiniGridInterface(make('MultiGrid-Empty-8x8-v0'))
    >>> obs, info = env.reset(seed=0)          # scalar obs dict
    >>> obs, reward, term, trunc, info = env.step(2)
    """

    def __init__(self, env: MultiGridEnv, render_mode: str | None = None):
        assert env.num_agents == 1, (
            'MiniGridInterface requires a single-agent environment '
            '(minigrid_interface.py:33-38)'
        )
        self._observation_space_override = None
        self._action_space_override = None
        super().__init__(env, render_mode=render_mode)

    def reset(self, **kwargs):
        obs, infos = super().reset(**kwargs)
        return obs[0], infos[0]

    def step(self, action):
        obs, rewards, terms, truncs, infos = super().step({0: int(action)})
        return obs[0], rewards[0], terms[0], truncs[0], infos[0]

    # Single-agent spaces with setters (minigrid_interface.py:61-103).

    @property
    def observation_space(self):
        if self._observation_space_override is not None:
            return self._observation_space_override
        return self._agent_observation_space()

    @observation_space.setter
    def observation_space(self, space):
        self._observation_space_override = space

    @property
    def action_space(self):
        if self._action_space_override is not None:
            return self._action_space_override
        from gymnasium import spaces

        from ..core.actions import Action
        return spaces.Discrete(len(Action))

    @action_space.setter
    def action_space(self, space):
        self._action_space_override = space

    # Single-agent state properties (minigrid_interface.py:105-182).

    @property
    def agent_pos(self) -> np.ndarray:
        return self._state.agent_pos[0, 0].cpu().numpy()

    @agent_pos.setter
    def agent_pos(self, value):
        """Overwrite the agent's position (minigrid_interface.py:116-126)."""
        if value is not None:
            self._state = self._state.replace(agent_pos=torch.as_tensor(
                value, dtype=torch.int32, device=self._state.device).reshape(1, 1, 2))

    @property
    def agent_dir(self) -> int:
        return int(self._state.agent_dir[0, 0])

    @agent_dir.setter
    def agent_dir(self, value):
        """Overwrite the agent's direction (minigrid_interface.py:139-148)."""
        self._state = self._state.replace(agent_dir=torch.as_tensor(
            value, dtype=torch.int32, device=self._state.device).reshape(1, 1))

    @property
    def carrying(self) -> np.ndarray | None:
        """Encoding triple of the carried object, or None."""
        enc = self._state.agent_carrying[0, 0].cpu().numpy()
        return None if enc[0] == TYPE_EMPTY else enc

    @property
    def dir_vec(self) -> np.ndarray:
        """Forward unit vector (minigrid_interface.py:161-171)."""
        return np.asarray(DIR_TO_VEC)[self.agent_dir]

    @property
    def front_pos(self) -> np.ndarray:
        """Cell directly in front of the agent
        (minigrid_interface.py:173-182)."""
        return self.agent_pos + self.dir_vec

    def place_agent(
        self, top=None, size=None, rand_dir: bool = True,
        max_tries: float = math.inf,
    ) -> tuple[int, int]:
        """Place the agent at a random empty position, drawn from the
        adapter's key: ``key, k1, k2 = split(key, 3)``, the cell from
        ``k1`` and the direction from ``k2``, as the JAX interface draws them
        (minigrid_interface.py:184-188 → base.py:680-697).

        Speed-mode distribution: uniform over valid cells (identical to the
        reference's rejection loop conditioned on acceptance).
        """
        from ..ops.place import place_obj_mask, uniform_position

        assert self._state is not None, 'call reset() before place_agent()'
        dev = self._state.device
        state = self._state.replace(
            agent_pos=torch.full((1, 1, 2), -1, dtype=torch.int32, device=dev))
        valid = place_obj_mask(state.grid, state.agent_pos, top, size)
        self._key, k1, k2 = prng.split(self._key, 3).unbind(0)
        pos = uniform_position(k1[None], valid)
        dirn = (prng.randint(k2[None], (), 0, 4).reshape(1, 1)
                if rand_dir else self._state.agent_dir)
        self._state = state.replace(agent_pos=pos.reshape(1, 1, 2), agent_dir=dirn)
        x, y = pos[0].tolist()
        return (int(x), int(y))

    @property
    def steps_remaining(self) -> int:
        return int(self.env.cfg.max_steps) - int(self._state.step_count[0])
