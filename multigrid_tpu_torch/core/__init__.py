"""Core state model: constants, actions, dense state tensors, static config."""

from .actions import Action
from .config import EnvConfig
from .constants import Color, Direction, State, Type, TILE_PIXELS
from .mission import Mission, MissionSpace
from .state import (
    MultiGridState,
    ResetPool,
    init_state,
    state_from_arrays,
    state_from_numpy,
    state_to_numpy,
)

__all__ = [
    'Action', 'Color', 'Direction', 'EnvConfig', 'Mission', 'MissionSpace',
    'MultiGridState', 'ResetPool', 'State', 'TILE_PIXELS', 'Type', 'init_state',
    'state_from_arrays', 'state_from_numpy', 'state_to_numpy',
]
