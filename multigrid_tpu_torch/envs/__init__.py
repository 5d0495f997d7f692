"""Environment zoo and registry.

Mirrors the reference's ``CONFIGURATIONS`` dict of ``(cls, kwargs)``
(multigrid/envs/__init__.py:38-52), all 13 configurations of the JAX
package. ``make(env_id, device=None, **overrides)`` builds an environment on
the card unless ``device`` says otherwise.
"""

from __future__ import annotations

from .blockedunlockpickup import BlockedUnlockPickupEnv
from .empty import EmptyEnv
from .env import MultiGridEnv
from .locked_hallway import LockedHallwayEnv
from .playground import PlaygroundEnv
from .redbluedoors import RedBlueDoorsEnv
from .roomgrid import RoomGrid

CONFIGURATIONS: dict[str, tuple[type, dict]] = {
    'MultiGrid-BlockedUnlockPickup-v0': (BlockedUnlockPickupEnv, {}),
    'MultiGrid-Empty-5x5-v0': (EmptyEnv, {'size': 5}),
    'MultiGrid-Empty-Random-5x5-v0': (EmptyEnv, {'size': 5, 'agent_start_pos': None}),
    'MultiGrid-Empty-6x6-v0': (EmptyEnv, {'size': 6}),
    'MultiGrid-Empty-Random-6x6-v0': (EmptyEnv, {'size': 6, 'agent_start_pos': None}),
    'MultiGrid-Empty-8x8-v0': (EmptyEnv, {}),
    'MultiGrid-Empty-16x16-v0': (EmptyEnv, {'size': 16}),
    'MultiGrid-LockedHallway-2Rooms-v0': (LockedHallwayEnv, {'num_rooms': 2}),
    'MultiGrid-LockedHallway-4Rooms-v0': (LockedHallwayEnv, {'num_rooms': 4}),
    'MultiGrid-LockedHallway-6Rooms-v0': (LockedHallwayEnv, {'num_rooms': 6}),
    'MultiGrid-Playground-v0': (PlaygroundEnv, {}),
    'MultiGrid-RedBlueDoors-6x6-v0': (RedBlueDoorsEnv, {'size': 6}),
    'MultiGrid-RedBlueDoors-8x8-v0': (RedBlueDoorsEnv, {'size': 8}),
}


def register(env_id: str, env_cls: type, **kwargs) -> None:
    """Register a new environment configuration."""
    CONFIGURATIONS[env_id] = (env_cls, kwargs)


def make(env_id: str, device=None, **overrides) -> MultiGridEnv:
    """Construct a registered environment on ``device`` (default: the card)."""
    env_cls, config = CONFIGURATIONS[env_id]
    return env_cls(**{**config, **overrides}, device=device)


__all__ = [
    'BlockedUnlockPickupEnv', 'CONFIGURATIONS', 'EmptyEnv', 'LockedHallwayEnv',
    'MultiGridEnv', 'PlaygroundEnv', 'RedBlueDoorsEnv', 'RoomGrid', 'make',
    'register',
]
