"""PettingZoo adapter (reference: multigrid/pettingzoo/__init__.py).

Counterpart of the JAX package's ``multigrid_tpu/adapters/pettingzoo.py``.

Wraps the Gymnasium adapter in PettingZoo's ``ParallelEnv`` protocol: string
agent names ``'agent_0'..``, a live ``agents`` list that drops terminated
agents (pettingzoo/__init__.py:52-57), and per-agent space getters.
"""

from __future__ import annotations

from ..envs.env import MultiGridEnv
from .gym import GymAdapter

try:
    from pettingzoo import ParallelEnv
except ImportError:  # pragma: no cover - pettingzoo is an optional extra
    ParallelEnv = object


class PettingZooWrapper(ParallelEnv):
    """ParallelEnv view over one env of a batched environment
    (reference pettingzoo/__init__.py:38-79).

    >>> env = PettingZooWrapper(make('MultiGrid-Empty-8x8-v0', agents=2))
    >>> obs, infos = env.reset(seed=0)
    >>> obs, rewards, terms, truncs, infos = env.step(
    ...     {a: env.action_space(a).sample() for a in env.agents})
    """

    metadata = {'render_modes': ['human', 'rgb_array'], 'name': 'multigrid_tpu_torch'}

    def __init__(self, env: MultiGridEnv, render_mode: str | None = None):
        self._gym = GymAdapter(env, render_mode=render_mode)
        self.possible_agents = [
            f'agent_{i}' for i in range(env.num_agents)
        ]
        self.agents = list(self.possible_agents)
        self._obs_spaces: dict = {}
        self._act_spaces: dict = {}

    @property
    def env(self) -> MultiGridEnv:
        return self._gym.env

    @property
    def render_mode(self):
        return self._gym.render_mode

    def _index(self, agent: str) -> int:
        return int(agent.rsplit('_', 1)[1])

    def observation_space(self, agent: str):
        # PettingZoo's API test requires the same space *object* per agent.
        if agent not in self._obs_spaces:
            self._obs_spaces[agent] = self._gym._agent_observation_space()
        return self._obs_spaces[agent]

    def action_space(self, agent: str):
        from gymnasium import spaces

        from ..core.actions import Action
        if agent not in self._act_spaces:
            self._act_spaces[agent] = spaces.Discrete(len(Action))
        return self._act_spaces[agent]

    def reset(self, seed: int | None = None, options: dict | None = None):
        obs, infos = self._gym.reset(seed=seed, options=options)
        self.agents = list(self.possible_agents)
        named = lambda d: {f'agent_{i}': v for i, v in d.items()}
        return named(obs), named(infos)

    def step(self, actions: dict):
        int_actions = {self._index(a): v for a, v in actions.items()}
        obs, rewards, terms, truncs, infos = self._gym.step(int_actions)
        named = lambda d: {f'agent_{i}': v for i, v in d.items()}
        obs, rewards, terms, truncs, infos = (
            named(obs), named(rewards), named(terms), named(truncs),
            named(infos),
        )
        # Live-agent bookkeeping (pettingzoo/__init__.py:52-57).
        self.agents = [
            a for a in self.possible_agents if not (terms[a] or truncs[a])
        ]
        return obs, rewards, terms, truncs, infos

    def render(self):
        return self._gym.render()

    def close(self):
        self._gym.close()


def to_pettingzoo_env(env_cls: type, *wrappers, **config) -> type:
    """Class factory mirroring the reference ``to_pettingzoo_env``
    (pettingzoo/__init__.py:82-115): returns a ParallelEnv subclass whose
    constructor builds ``env_cls``, applies observation wrappers, and wraps."""

    class _PZEnv(PettingZooWrapper):
        def __init__(self, render_mode=None, **kwargs):
            env = env_cls(**{**config, **kwargs})
            for wrapper in wrappers:
                env = wrapper(env)
            super().__init__(env, render_mode=render_mode)

    _PZEnv.__name__ = f'PettingZoo_{env_cls.__name__}'
    return _PZEnv
