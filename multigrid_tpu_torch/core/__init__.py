"""Core state model: constants, actions, dense state tensors, static config.

As in ``multigrid_tpu.core``, the reference's ``Grid``/``WorldObj`` names
resolve lazily to the host-side imperative builders
(:mod:`~multigrid_tpu_torch.utils.minigrid_builder`) used for porting
MiniGrid environments.
"""

from .actions import Action
from .config import EnvConfig
from .constants import Color, Direction, State, Type, TILE_PIXELS
from .mission import Mission, MissionSpace
from .state import (
    MultiGridState,
    ResetPool,
    init_state,
    is_carrying,
    state_from_arrays,
    state_from_numpy,
    state_to_numpy,
)

_BUILDER_NAMES = frozenset({'Grid', 'WorldObj', 'Wall', 'Floor', 'Goal', 'Lava', 'Key',
                            'Ball', 'Box', 'Door'})


def __getattr__(name):
    # Lazy: the builder imports envs.layout, which imports this package.
    if name in _BUILDER_NAMES:
        from ..utils import minigrid_builder
        return getattr(minigrid_builder, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


__all__ = [
    'Action', 'Ball', 'Box', 'Color', 'Direction', 'Door', 'EnvConfig', 'Floor', 'Goal',
    'Grid', 'Key', 'Lava', 'Mission', 'MissionSpace', 'MultiGridState', 'ResetPool', 'State',
    'TILE_PIXELS', 'Type', 'Wall', 'WorldObj', 'init_state', 'is_carrying',
    'state_from_arrays', 'state_from_numpy', 'state_to_numpy',
]
