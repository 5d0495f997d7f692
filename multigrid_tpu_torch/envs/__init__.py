"""Environment registry.

Mirrors the reference's ``CONFIGURATIONS`` dict of ``(cls, kwargs)``
(multigrid/envs/__init__.py:38-52). The port holds the Empty family so far.
``make(env_id, device=None, **overrides)`` builds an environment on the card
unless ``device`` says otherwise.
"""

from __future__ import annotations

from .empty import EmptyEnv
from .env import MultiGridEnv

CONFIGURATIONS: dict[str, tuple[type, dict]] = {
    'MultiGrid-Empty-5x5-v0': (EmptyEnv, {'size': 5}),
    'MultiGrid-Empty-Random-5x5-v0': (EmptyEnv, {'size': 5, 'agent_start_pos': None}),
    'MultiGrid-Empty-6x6-v0': (EmptyEnv, {'size': 6}),
    'MultiGrid-Empty-Random-6x6-v0': (EmptyEnv, {'size': 6, 'agent_start_pos': None}),
    'MultiGrid-Empty-8x8-v0': (EmptyEnv, {}),
    'MultiGrid-Empty-16x16-v0': (EmptyEnv, {'size': 16}),
}


def register(env_id: str, env_cls: type, **kwargs) -> None:
    """Register a new environment configuration."""
    CONFIGURATIONS[env_id] = (env_cls, kwargs)


def make(env_id: str, device=None, **overrides) -> MultiGridEnv:
    """Construct a registered environment on ``device`` (default: the card)."""
    env_cls, config = CONFIGURATIONS[env_id]
    return env_cls(**{**config, **overrides}, device=device)


__all__ = ['CONFIGURATIONS', 'EmptyEnv', 'MultiGridEnv', 'make', 'register']
