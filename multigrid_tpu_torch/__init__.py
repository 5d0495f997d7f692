"""multigrid_tpu_torch — the PyTorch and CUDA port of ``multigrid_tpu``.

The gridworld lives as dense integer tensors with a leading env axis, the
multi-agent step is plain PyTorch on batched tensors, observations come from
a hand-written CUDA kernel (with a plain PyTorch version for the CPU), and
thousands of environments run in lockstep on one card. ``learn`` trains a
shared PPO policy on them, with the policy's first layer, its weight
gradient and the whole PPO loss in hand-written CUDA kernels
(``python -m multigrid_tpu_torch.train``). Entry points run on the card
unless the caller passes ``device='cpu'``.
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
