"""multigrid_tpu_torch — the PyTorch and CUDA port of ``multigrid_tpu``.

The gridworld lives as dense integer tensors with a leading env axis, the
multi-agent step is plain PyTorch on batched tensors, observations come from
a hand-written CUDA kernel (with a plain PyTorch version for the CPU), and
thousands of environments run in lockstep on one card: the 13
configurations of the env zoo, procedural layouts drawn on the device.
``learn`` trains PPO policies on them (shared or per agent, optionally with
a centralized critic, conditioned on the mission where the env has one),
with the policy's first layer, its weight gradient, the whole PPO
loss and the fused rollout policy step in hand-written CUDA kernels
(``python -m multigrid_tpu_torch.train``). The user-facing surface has the
JAX package's names: observation wrappers (``wrappers``), rendering
(``render``, ``python -m multigrid_tpu_torch.visualize``), the Gymnasium,
PettingZoo and RLlib adapters (``adapters``) and MiniGrid compatibility
(``utils.minigrid_builder``, ``utils.minigrid_interface``). Entry points run
on the card unless the caller passes ``device='cpu'``.
"""

from .core import (
    Action,
    Color,
    Direction,
    EnvConfig,
    MultiGridState,
    State,
    Type,
)
from .envs import CONFIGURATIONS, make
from .envs.env import MultiGridEnv
from .parallel import VectorEnv

__version__ = '0.1.0'

__all__ = [
    'Action', 'CONFIGURATIONS', 'Color', 'Direction', 'EnvConfig',
    'MultiGridEnv', 'MultiGridState', 'State', 'Type', 'VectorEnv', 'make',
]
