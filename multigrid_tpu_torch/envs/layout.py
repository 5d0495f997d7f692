"""Host-side (numpy) grid layout builders.

Static layout pieces (outer walls, fixed goals, room partitions) are built
once at environment construction with numpy and uploaded as constants; only
the random parts of a layout are generated per-reset. The builders mirror the
reference ``Grid`` mutation helpers (multigrid/core/grid.py:133-195) but
operate directly on dense ``(W, H, 3)`` encodings.
"""

from __future__ import annotations

import numpy as np

from ..core.constants import (
    COLOR_GREEN,
    COLOR_GREY,
    COLOR_RED,
    EMPTY_ENCODING,
    STATE_OPEN,
    TYPE_BALL,
    TYPE_BOX,
    TYPE_DOOR,
    TYPE_FLOOR,
    TYPE_GOAL,
    TYPE_KEY,
    TYPE_LAVA,
    TYPE_WALL,
)


def encode(type_idx: int, color_idx: int = COLOR_RED, state_idx: int = 0) -> np.ndarray:
    """(3,) int32 cell encoding."""
    return np.array([type_idx, color_idx, state_idx], dtype=np.int32)


# Canonical object encodings (default colors match the WorldObj constructors,
# multigrid/core/world_object.py:279-617).
WALL = encode(TYPE_WALL, COLOR_GREY)
GOAL = encode(TYPE_GOAL, COLOR_GREEN)
LAVA = encode(TYPE_LAVA, COLOR_RED)
EMPTY = np.asarray(EMPTY_ENCODING, dtype=np.int32)


def floor(color: int) -> np.ndarray:
    return encode(TYPE_FLOOR, color)


def key(color: int) -> np.ndarray:
    return encode(TYPE_KEY, color)


def ball(color: int) -> np.ndarray:
    return encode(TYPE_BALL, color)


def box(color: int) -> np.ndarray:
    return encode(TYPE_BOX, color)


def door(color: int, state: int = STATE_OPEN) -> np.ndarray:
    return encode(TYPE_DOOR, color, state)


def empty_grid(width: int, height: int) -> np.ndarray:
    """Fresh (W, H, 3) grid of empty cells (core/grid.py:54-55)."""
    grid = np.empty((width, height, 3), dtype=np.int32)
    grid[...] = EMPTY
    return grid


def horz_wall(grid: np.ndarray, x: int, y: int, length: int | None = None,
              cell: np.ndarray = WALL) -> None:
    length = grid.shape[0] - x if length is None else length
    grid[x:x + length, y] = cell


def vert_wall(grid: np.ndarray, x: int, y: int, length: int | None = None,
              cell: np.ndarray = WALL) -> None:
    length = grid.shape[1] - y if length is None else length
    grid[x, y:y + length] = cell


def wall_rect(grid: np.ndarray, x: int, y: int, w: int, h: int) -> None:
    """Walled rectangle outline (core/grid.py:177-195)."""
    horz_wall(grid, x, y, w)
    horz_wall(grid, x, y + h - 1, w)
    vert_wall(grid, x, y, h)
    vert_wall(grid, x + w - 1, y, h)
