"""Core constants and enumerations — the frozen wire format.

The integer index order of :class:`Type`, :class:`Color`, :class:`State` and
:class:`Direction` is the dense-array encoding used by every kernel in this
framework and must match the reference bit-for-bit
(reference: multigrid/core/constants.py:34-113). Do not reorder.

Alongside the Python-level enums (host-side API parity) this module exports
plain module-level integers and numpy tables for use inside tensor code and
the CUDA kernels.
"""

from __future__ import annotations

import enum

import numpy as np

from ..utils.enum import IndexedEnum

#: Tile size for rendering a grid cell, in pixels (reference constants.py:10)
TILE_PIXELS = 32

#: RGB color table, indexed by Color (reference constants.py:12-19).
#: Extensible via :meth:`Color.add_color`.
COLORS = {
    'red': np.array([255, 0, 0]),
    'green': np.array([0, 255, 0]),
    'blue': np.array([0, 0, 255]),
    'purple': np.array([112, 39, 195]),
    'yellow': np.array([255, 255, 0]),
    'grey': np.array([100, 100, 100]),
}


class Type(str, IndexedEnum):
    """Object types (index order is the grid encoding; constants.py:34-48)."""
    unseen = 'unseen'
    empty = 'empty'
    wall = 'wall'
    floor = 'floor'
    door = 'door'
    key = 'key'
    ball = 'ball'
    box = 'box'
    goal = 'goal'
    lava = 'lava'
    agent = 'agent'


class Color(str, IndexedEnum):
    """Object colors (constants.py:51-88)."""
    red = 'red'
    green = 'green'
    blue = 'blue'
    purple = 'purple'
    yellow = 'yellow'
    grey = 'grey'

    @classmethod
    def add_color(cls, name: str, rgb) -> None:
        """Add a new color to the enumeration and the RGB table."""
        cls.add_item(name, name)
        COLORS[name] = np.asarray(rgb, dtype=np.uint8)

    @staticmethod
    def cycle(n: int) -> tuple['Color', ...]:
        """Return a cycle of ``n`` colors (used for default agent colors)."""
        return tuple(Color.from_index(i % len(Color)) for i in range(int(n)))

    def rgb(self) -> np.ndarray:
        """Return the RGB value of this color."""
        return COLORS[self]


class State(str, IndexedEnum):
    """Object states (constants.py:91-97)."""
    open = 'open'
    closed = 'closed'
    locked = 'locked'


class Direction(enum.IntEnum):
    """Agent directions (constants.py:100-113)."""
    right = 0
    down = 1
    left = 2
    up = 3

    def to_vec(self) -> np.ndarray:
        """Return the (dx, dy) unit vector for this direction."""
        return DIR_TO_VEC[self]


#: Direction → (dx, dy) unit vectors, row-indexed by Direction.
DIR_TO_VEC = np.array(
    [
        [1, 0],   # right (+x)
        [0, 1],   # down  (+y)
        [-1, 0],  # left  (-x)
        [0, -1],  # up    (-y)
    ],
    dtype=np.int32,
)

### Plain integer constants for tensor code (kept in sync with the enums).

TYPE_UNSEEN = 0
TYPE_EMPTY = 1
TYPE_WALL = 2
TYPE_FLOOR = 3
TYPE_DOOR = 4
TYPE_KEY = 5
TYPE_BALL = 6
TYPE_BOX = 7
TYPE_GOAL = 8
TYPE_LAVA = 9
TYPE_AGENT = 10

COLOR_RED = 0
COLOR_GREEN = 1
COLOR_BLUE = 2
COLOR_PURPLE = 3
COLOR_YELLOW = 4
COLOR_GREY = 5
NUM_BASE_COLORS = 6

STATE_OPEN = 0
STATE_CLOSED = 1
STATE_LOCKED = 2

DIR_RIGHT = 0
DIR_DOWN = 1
DIR_LEFT = 2
DIR_UP = 3

#: Grid-cell encodings as (type, color, state) triples.
EMPTY_ENCODING = np.array([TYPE_EMPTY, COLOR_RED, 0], dtype=np.int32)
WALL_ENCODING = np.array([TYPE_WALL, COLOR_GREY, 0], dtype=np.int32)
UNSEEN_ENCODING = np.array([TYPE_UNSEEN, COLOR_RED, 0], dtype=np.int32)

### Minigrid compatibility maps (reference constants.py:119-124)

OBJECT_TO_IDX = {t: t.to_index() for t in Type}
IDX_TO_OBJECT = {t.to_index(): t for t in Type}
COLOR_TO_IDX = {c: c.to_index() for c in Color}
IDX_TO_COLOR = {c.to_index(): c for c in Color}
STATE_TO_IDX = {s: s.to_index() for s in State}
COLOR_NAMES = sorted(list(Color))
