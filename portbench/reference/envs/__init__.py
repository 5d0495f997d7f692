"""The two configurations the benchmark runs, as the registry builds them."""

from __future__ import annotations

from .blockedunlockpickup import BlockedUnlockPickupEnv
from .empty import EmptyEnv

CONFIGURATIONS = {
    'MultiGrid-BlockedUnlockPickup-v0': (BlockedUnlockPickupEnv, {}),
    'MultiGrid-Empty-16x16-v0': (EmptyEnv, {'size': 16}),
}


def make(env_id: str, device=None, **overrides):
    env_cls, config = CONFIGURATIONS[env_id]
    return env_cls(**{**config, **overrides}, device=device)
