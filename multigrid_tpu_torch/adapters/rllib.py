"""RLlib adapter (reference: multigrid/rllib/__init__.py).

Counterpart of the JAX package's ``multigrid_tpu/adapters/rllib.py``.

``RLlibWrapper`` exposes the multi-agent dict protocol RLlib's
``MultiAgentEnv`` expects: ``__all__`` keys on termination/truncation dicts
(rllib/__init__.py:59-63) and per-agent space getters (:65-69). Ray is an
optional dependency — without it the wrapper still works as a plain
dict-protocol env (duck-typed), matching RLlib's interface.
"""

from __future__ import annotations

from ..envs import CONFIGURATIONS
from ..envs.env import MultiGridEnv
from ..wrappers import OneHotObsWrapper
from .gym import GymAdapter

try:
    from ray.rllib.env.multi_agent_env import MultiAgentEnv
    _HAS_RAY = True
except ImportError:  # pragma: no cover - ray is an optional extra
    MultiAgentEnv = object
    _HAS_RAY = False


class RLlibWrapper(MultiAgentEnv):
    """MultiAgentEnv view over one env of a batched environment
    (reference rllib/__init__.py:44-69)."""

    def __init__(self, env: MultiGridEnv, render_mode: str | None = None):
        if _HAS_RAY:
            super().__init__()
        self._gym = GymAdapter(env, render_mode=render_mode)
        self.agents = self.possible_agents = list(range(env.num_agents))

    @property
    def env(self) -> MultiGridEnv:
        return self._gym.env

    def get_observation_space(self, agent_id: int):
        return self._gym._agent_observation_space()

    def get_action_space(self, agent_id: int):
        from gymnasium import spaces

        from ..core.actions import Action
        return spaces.Discrete(len(Action))

    @property
    def observation_space(self):
        return self._gym.observation_space

    @property
    def action_space(self):
        return self._gym.action_space

    def reset(self, *, seed=None, options=None):
        return self._gym.reset(seed=seed, options=options)

    def step(self, actions: dict):
        obs, rewards, terms, truncs, infos = self._gym.step(actions)
        # '__all__' keys (rllib/__init__.py:59-63).
        terms['__all__'] = all(terms.values())
        truncs['__all__'] = all(truncs.values())
        return obs, rewards, terms, truncs, infos

    def render(self):
        return self._gym.render()

    def close(self):
        self._gym.close()


def to_rllib_env(env_cls: type, *wrappers, default_config: dict | None = None) -> type:
    """Class factory mirroring the reference ``to_rllib_env``
    (rllib/__init__.py:72-105): the returned class takes a single RLlib
    ``config`` dict."""
    default_config = default_config or {}

    class _RLlibEnv(RLlibWrapper):
        def __init__(self, config: dict | None = None):
            config = {**default_config, **(config or {})}
            render_mode = config.pop('render_mode', None)
            env = env_cls(**config)
            for wrapper in wrappers:
                env = wrapper(env)
            super().__init__(env, render_mode=render_mode)

    _RLlibEnv.__name__ = f'RLlib_{env_cls.__name__}'
    return _RLlibEnv


def register_rllib_envs() -> None:
    """Register all configurations with Ray Tune, wrapped in
    ``OneHotObsWrapper`` (reference rllib/__init__.py:109-111)."""
    from ray.tune.registry import register_env

    for env_id, (env_cls, config) in CONFIGURATIONS.items():
        cls = to_rllib_env(env_cls, OneHotObsWrapper, default_config=config)
        register_env(env_id, lambda cfg, cls=cls: cls(cfg))


if _HAS_RAY:  # auto-register on import, as the reference does
    register_rllib_envs()
