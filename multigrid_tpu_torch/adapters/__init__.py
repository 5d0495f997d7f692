"""Host-side framework adapters.

Stateful views over one env of the batched core, re-creating the
reference's integration surface: Gymnasium (multigrid/base.py:36 as a
``gym.Env``), PettingZoo (multigrid/pettingzoo/__init__.py), and RLlib
(multigrid/rllib/__init__.py). Counterpart of the JAX package's
``multigrid_tpu/adapters``: the env's state stays on its device (the card
by default), and the adapters move small dicts across to the host.
"""

from .gym import GymAdapter, register_gymnasium_envs
from .pettingzoo import PettingZooWrapper, to_pettingzoo_env
from .rllib import RLlibWrapper, to_rllib_env

__all__ = [
    'GymAdapter', 'PettingZooWrapper', 'RLlibWrapper',
    'register_gymnasium_envs', 'to_pettingzoo_env', 'to_rllib_env',
]
