"""Gymnasium adapter: the reference's user-facing ``gym.Env`` surface.

Counterpart of the JAX package's ``multigrid_tpu/adapters/gym.py``. The
reference's ``MultiGridEnv`` *is* a ``gym.Env`` (multigrid/base.py:36) with
dict-keyed multi-agent reset/step. Here that surface is a host-side adapter
over one env of the batched core: the state stays on the env's device (the
card by default), the env's ``reset``/``step`` do the work (the observation
kernel once a call), and the adapter converts to and from per-agent dicts,
moving each returned field to the host in one copy.

Reference semantics reproduced:
* ``reset(seed)`` → ``({agent: obs}, {agent: info})`` (base.py:250-301);
  obs = ``{'image', 'direction', 'mission'}`` (base.py:368-376).
* ``step({agent: action})`` → obs/reward/termination/truncation/info dicts
  (base.py:303-346); agents missing from the action dict are skipped
  (base.py:403-404).
* mission sampled per episode from ``mission_space`` (base.py:272-273).

gymnasium is an optional extra here, as pettingzoo and ray are in the JAX
package: without it the adapters still reset, step and render on the card,
while the spaces and :func:`register_gymnasium_envs` import it and raise.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.actions import Action
from ..core.mission import Mission, MissionSpace
from ..envs import CONFIGURATIONS
from ..envs.env import MultiGridEnv
from ..utils import prng

try:
    from gymnasium import Env as _Env
    from gymnasium import Space as _Space
except ImportError:  # pragma: no cover - gymnasium is an optional extra
    _Env = _Space = object


class GymMissionSpace(_Space):
    """gymnasium.Space facade over :class:`MissionSpace`
    (the reference's MissionSpace subclasses ``spaces.MultiDiscrete``,
    multigrid/core/mission.py:45-93)."""

    def __init__(self, mission_space: MissionSpace):
        if _Space is not object:
            super().__init__(shape=None, dtype=None)
        self.mission_space = mission_space

    def sample(self, mask=None) -> Mission:
        return self.mission_space.sample()

    def contains(self, x) -> bool:
        return self.mission_space.contains(x)

    def __repr__(self):
        return f'GymMissionSpace({self.mission_space!r})'


class GymAdapter(_Env):
    """Stateful Gymnasium view over one env of a batched environment.

    It holds an ``E = 1`` state on the env's device (whose ``rng`` draws
    the agents' orders) and a key there for its resets, ``key(seed)`` at
    ``reset(seed=...)``, split at each reset as the JAX adapter's
    (adapters/gym.py:112-118).

    >>> env = GymAdapter(make('MultiGrid-Empty-8x8-v0', agents=2))
    >>> obs, infos = env.reset(seed=0)
    >>> obs, rewards, terms, truncs, infos = env.step({0: 2, 1: 1})
    """

    metadata = {'render_modes': ['human', 'rgb_array'], 'render_fps': 20}

    def __init__(self, env: MultiGridEnv, render_mode: str | None = None):
        self.env = env
        self.render_mode = render_mode or getattr(env, 'render_mode', None)
        self._key = prng.key(int(np.random.SeedSequence().generate_state(1)[0]), env.device)
        self._state = None
        self._mission: Mission = Mission(env.mission)
        self._window = None
        self._clock = None

    # --------------------------------------------------------------- spaces

    @property
    def num_agents(self) -> int:
        return self.env.num_agents

    @property
    def agents(self) -> list[int]:
        return list(range(self.num_agents))

    def _agent_observation_space(self):
        from gymnasium import spaces
        vs = self.env.cfg.view_size
        base = spaces.Dict({
            'image': spaces.Box(0, 255, (vs, vs, 3), dtype=np.int32),
            'direction': spaces.Discrete(4),
            'mission': GymMissionSpace(self.env.mission_space),
        })
        # Wrapped envs rewrite the per-agent space through the wrapper chain
        # (FullyObs → full-grid image, OneHot → 21 channels, ...), matching
        # the reference wrappers' observation_space mutations
        # (multigrid/wrappers.py:41-58,139-147).
        return self.env.transform_space(base)

    @property
    def observation_space(self):
        """Joint observation space keyed by agent index (base.py:196-211)."""
        from gymnasium import spaces
        return spaces.Dict({
            i: self._agent_observation_space() for i in self.agents
        })

    @property
    def action_space(self):
        """Joint action space keyed by agent index (base.py:213-228)."""
        from gymnasium import spaces
        return spaces.Dict({
            i: spaces.Discrete(len(Action)) for i in self.agents
        })

    # ------------------------------------------------------------ lifecycle

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if _Env is not object:
            super().reset(seed=seed)
        if seed is not None:
            self._key = prng.key(seed, self.env.device)
            self.env.mission_space.seed(seed)
        self._key, k = prng.split(self._key).unbind(0)
        obs, self._state = self.env.reset(k)
        mission = self.env.mission_of(self._state)
        if isinstance(mission, Mission):
            self._mission = mission
        else:
            # Resolve the index in the env's mission space so downstream
            # index-based encodings match the reference's MultiDiscrete space.
            text = mission or self.env.mission
            space = self.env.mission_space
            self._mission = next(
                (m for m in space if str(m) == str(text)), Mission(text))
        if self.render_mode == 'human':
            self.render()
        return self._obs_dicts(obs), {i: {} for i in self.agents}

    def step(self, actions: dict[Any, int]):
        assert self._state is not None, 'call reset() before step()'
        n = self.num_agents
        act = np.zeros((1, n), dtype=np.int32)
        mask = np.zeros((1, n), dtype=bool)
        for i, a in actions.items():
            act[0, int(i)] = int(a)
            mask[0, int(i)] = True
        dev = self._state.device
        obs, self._state, rew, term, trunc = self.env.step(
            self._state, torch.as_tensor(act, device=dev), torch.as_tensor(mask, device=dev))
        rew = rew[0].cpu().numpy()
        term = term[0].cpu().numpy()
        trunc = trunc[0].cpu().numpy()
        if self.render_mode == 'human':
            self.render()
        return (
            self._obs_dicts(obs),
            {i: float(rew[i]) for i in self.agents},
            {i: bool(term[i]) for i in self.agents},
            {i: bool(trunc[i]) for i in self.agents},
            {i: {} for i in self.agents},
        )

    def _obs_dicts(self, obs) -> dict[int, Any]:
        """Per-agent observations of the one env, each field moved to the
        host in one copy."""
        if not isinstance(obs, dict):
            # Image-only wrappers (ImgObsWrapper) collapse the obs dict to
            # the raw image array (reference wrappers.py:92-97).
            arr = obs[0].cpu().numpy()
            return {i: arr[i] for i in self.agents}
        image = obs['image'][0].cpu().numpy()
        direction = obs['direction'][0].cpu().numpy()
        return {
            i: {
                'image': image[i],
                'direction': int(direction[i]),
                'mission': self._mission,
            }
            for i in self.agents
        }

    # ------------------------------------------------------------ rendering

    def get_frame(self, highlight: bool = True, tile_size: int = 32):
        """Full-environment RGB frame (base.py:758-783)."""
        from ..render import render_state
        return render_state(
            self.env, self._state, highlight=highlight, tile_size=tile_size
        )

    def render(self):
        """Render per ``render_mode`` (base.py:785-831)."""
        img = self.get_frame()
        if self.render_mode == 'human':
            import pygame
            img = np.transpose(img, axes=(1, 0, 2))
            screen_size = (img.shape[0], img.shape[1])
            if self._window is None:
                pygame.init()
                pygame.display.init()
                self._window = pygame.display.set_mode(screen_size)
                pygame.display.set_caption('multigrid_tpu_torch')
                self._clock = pygame.time.Clock()
            surf = pygame.surfarray.make_surface(img)
            self._window.blit(surf, (0, 0))
            pygame.event.pump()
            self._clock.tick(self.metadata['render_fps'])
            pygame.display.flip()
            return None
        return img

    def close(self):
        if self._window is not None:
            import pygame
            pygame.display.quit()
            pygame.quit()
            self._window = None

    def __str__(self):
        """ASCII map of the current state (reference base.py pretty-print)."""
        if self._state is None:
            return repr(self)
        from ..utils.pprint import state_to_string
        return state_to_string(self._state)


def register_gymnasium_envs() -> None:
    """Register all configurations with Gymnasium
    (reference envs/__init__.py:55-57), under the JAX package's ids; the
    entry point takes ``make``'s keywords (``device`` among them)."""
    import gymnasium as gym

    from ..envs import make as make_batched

    for env_id in CONFIGURATIONS:
        def _entry(env_id=env_id, render_mode=None, **kwargs):
            return GymAdapter(
                make_batched(env_id, **kwargs), render_mode=render_mode
            )
        gym.register(id=env_id, entry_point=_entry)
