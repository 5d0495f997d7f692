"""Full-frame RGB rendering.

Counterpart of the JAX package's ``multigrid_tpu/render.py``: host-side
visualization over the dense state (the reference renders through the
object graph: multigrid/core/grid.py:197-308, world_object renderers, and
base.py:707-756 for view-cone highlighting). One env of a batched state is
copied to the host once a frame (:func:`host_env`); tiles are rasterized
once per (cell encoding, agent overlay, highlight, tile size) and cached,
as the reference caches them (core/grid.py:40,229-255), and frames
assemble by block copy.
"""

from __future__ import annotations

import math

import numpy as np

from .core.constants import (
    COLORS,
    STATE_LOCKED,
    STATE_OPEN,
    TILE_PIXELS,
    Color,
    Type,
)
from .core.state import STATE_FIELDS, MultiGridState
from .ops.obs import gen_obs_grid_encoding, get_view_exts, get_vis_mask
from .utils.rendering import (
    downsample,
    fill_coords,
    highlight_img,
    point_in_circle,
    point_in_line,
    point_in_rect,
    point_in_triangle,
    rotate_fn,
)

_TILE_CACHE: dict = {}

_T_WALL = Type.wall.to_index()
_T_FLOOR = Type.floor.to_index()
_T_DOOR = Type.door.to_index()
_T_KEY = Type.key.to_index()
_T_BALL = Type.ball.to_index()
_T_BOX = Type.box.to_index()
_T_GOAL = Type.goal.to_index()
_T_LAVA = Type.lava.to_index()


def _rgb(color_idx: int) -> np.ndarray:
    return np.asarray(COLORS[Color.from_index(int(color_idx))], dtype=np.uint8)


def render_object(img: np.ndarray, type_idx: int, color_idx: int,
                  state_idx: int) -> None:
    """Draw one world object onto a tile (reference per-type renderers,
    multigrid/core/world_object.py:279-617)."""
    color = _rgb(color_idx)
    if type_idx == _T_WALL:
        fill_coords(img, point_in_rect(0, 1, 0, 1), color)
    elif type_idx == _T_GOAL:
        fill_coords(img, point_in_rect(0, 1, 0, 1), color)
    elif type_idx == _T_FLOOR:
        fill_coords(img, point_in_rect(0.031, 1, 0.031, 1), color // 2)
    elif type_idx == _T_LAVA:
        fill_coords(img, point_in_rect(0, 1, 0, 1), (255, 128, 0))
        for i in range(3):
            ylo, yhi = 0.3 + 0.2 * i, 0.4 + 0.2 * i
            fill_coords(img, point_in_line(0.1, ylo, 0.3, yhi, r=0.03), (0, 0, 0))
            fill_coords(img, point_in_line(0.3, yhi, 0.5, ylo, r=0.03), (0, 0, 0))
            fill_coords(img, point_in_line(0.5, ylo, 0.7, yhi, r=0.03), (0, 0, 0))
            fill_coords(img, point_in_line(0.7, yhi, 0.9, ylo, r=0.03), (0, 0, 0))
    elif type_idx == _T_DOOR:
        if state_idx == STATE_OPEN:
            fill_coords(img, point_in_rect(0.88, 1.00, 0.00, 1.00), color)
            fill_coords(img, point_in_rect(0.92, 0.96, 0.04, 0.96), (0, 0, 0))
        elif state_idx == STATE_LOCKED:
            # Solid door tinted 0.45, key slot (world_object.py:103-108).
            fill_coords(img, point_in_rect(0.00, 1.00, 0.00, 1.00), color)
            fill_coords(img, point_in_rect(0.06, 0.94, 0.06, 0.94),
                        0.45 * color.astype(np.float64))
            fill_coords(img, point_in_rect(0.52, 0.75, 0.50, 0.56), color)
        else:
            fill_coords(img, point_in_rect(0.00, 1.00, 0.00, 1.00), color)
            fill_coords(img, point_in_rect(0.04, 0.96, 0.04, 0.96), (0, 0, 0))
            fill_coords(img, point_in_rect(0.08, 0.92, 0.08, 0.92), color)
            fill_coords(img, point_in_rect(0.12, 0.88, 0.12, 0.88), (0, 0, 0))
            fill_coords(img, point_in_circle(cx=0.75, cy=0.50, r=0.08), color)
    elif type_idx == _T_KEY:
        fill_coords(img, point_in_rect(0.50, 0.63, 0.31, 0.88), color)   # shaft
        fill_coords(img, point_in_rect(0.38, 0.50, 0.59, 0.66), color)   # teeth
        fill_coords(img, point_in_rect(0.38, 0.50, 0.81, 0.88), color)
        fill_coords(img, point_in_circle(cx=0.56, cy=0.28, r=0.19), color)  # bow
        fill_coords(img, point_in_circle(cx=0.56, cy=0.28, r=0.064), (0, 0, 0))
    elif type_idx == _T_BALL:
        fill_coords(img, point_in_circle(0.5, 0.5, 0.31), color)
    elif type_idx == _T_BOX:
        fill_coords(img, point_in_rect(0.12, 0.88, 0.12, 0.88), color)
        fill_coords(img, point_in_rect(0.18, 0.82, 0.18, 0.82), (0, 0, 0))
        fill_coords(img, point_in_rect(0.16, 0.84, 0.47, 0.53), color)   # lid line


def render_agent(img: np.ndarray, color_idx: int, dir_idx: int) -> None:
    """Directed triangle (reference core/agent.py:150-168)."""
    tri = point_in_triangle((0.12, 0.19), (0.87, 0.50), (0.12, 0.81))
    tri = rotate_fn(tri, cx=0.5, cy=0.5, theta=0.5 * math.pi * int(dir_idx))
    fill_coords(img, tri, _rgb(color_idx))


def render_tile(
    cell: tuple[int, int, int],
    agent: tuple[int, int] | None = None,
    highlight: bool = False,
    tile_size: int = TILE_PIXELS,
    subdivs: int = 3,
) -> np.ndarray:
    """Rasterize one tile, cached by content key (core/grid.py:197-257)."""
    key = (cell, agent, highlight, tile_size)
    if key in _TILE_CACHE:
        return _TILE_CACHE[key]

    img = np.zeros((tile_size * subdivs, tile_size * subdivs, 3), dtype=np.uint8)
    type_idx, color_idx, state_idx = cell
    # Grid lines FIRST, then the object/agent over them — the reference's
    # draw order (core/grid.py:235-249); full-tile fills (goal, lava, open
    # doors) legitimately cover their own top/left border lines.
    fill_coords(img, point_in_rect(0, 0.031, 0, 1), (100, 100, 100))
    fill_coords(img, point_in_rect(0, 1, 0, 0.031), (100, 100, 100))
    if type_idx not in (Type.empty.to_index(), Type.unseen.to_index()):
        render_object(img, type_idx, color_idx, state_idx)
    if agent is not None:
        render_agent(img, agent[0], agent[1])
    if highlight:
        highlight_img(img)

    img = downsample(img, subdivs)
    _TILE_CACHE[key] = img
    return img


def host_env(state: MultiGridState, index: int = 0) -> MultiGridState:
    """Env ``index`` of a batched state as an ``E = 1`` state on the CPU:
    one copy to the host per field (extras and pool left out)."""
    return MultiGridState(
        **{f: getattr(state, f)[index:index + 1].cpu() for f in STATE_FIELDS})


def _visible_mask(cfg, one: MultiGridState) -> np.ndarray:
    """:func:`visible_world_mask` of an ``E = 1`` state on the CPU."""
    vs = cfg.view_size
    obs = gen_obs_grid_encoding(one, vs, True)  # unmasked views
    vis = get_vis_mask(obs)[0].numpy()
    tx, ty = (t[0].numpy() for t in get_view_exts(one.agent_dir, one.agent_pos, vs))
    dirs = one.agent_dir[0].numpy()
    terminated = one.agent_terminated[0].numpy()

    mask = np.zeros((cfg.width, cfg.height), dtype=bool)
    for a in range(one.num_agents):
        if terminated[a]:
            continue
        # The view is rot90(window, -k) with k = (dir+1) % 4
        # (ops/obs.py::rotation_sources), so rot90(view, k) is the window in
        # world axes, offset by the view's top-left corner.
        k = (int(dirs[a]) + 1) % 4
        ii, jj = np.nonzero(np.rot90(vis[a], k=k))
        x, y = int(tx[a]) + ii, int(ty[a]) + jj
        inside = (x >= 0) & (x < cfg.width) & (y >= 0) & (y < cfg.height)
        mask[x[inside], y[inside]] = True
    return mask


def visible_world_mask(env, state: MultiGridState, index: int = 0) -> np.ndarray:
    """(W, H) bool — the union of env ``index``'s live agents' visible
    cells, in world coordinates (base.py:712-747), through the plain
    observation functions on the host."""
    return _visible_mask(env.cfg, host_env(state, index))


def render_state(
    env,
    state: MultiGridState,
    *,
    index: int = 0,
    highlight: bool = True,
    tile_size: int = TILE_PIXELS,
) -> np.ndarray:
    """Full-environment frame of env ``index`` of a batched state
    (base.py:707-756). Returns (H*t, W*t, 3) uint8."""
    one = host_env(state, index)
    grid = one.grid[0].numpy()
    agent_pos = one.agent_pos[0].numpy()
    agent_dir = one.agent_dir[0].numpy()
    agent_color = one.agent_color[0].numpy()
    terminated = one.agent_terminated[0].numpy()
    w, h, _ = grid.shape

    agent_at: dict[tuple[int, int], tuple[int, int]] = {}
    for a in range(one.num_agents):
        if not terminated[a]:
            agent_at[(int(agent_pos[a, 0]), int(agent_pos[a, 1]))] = (
                int(agent_color[a]), int(agent_dir[a]))

    hmask = (
        _visible_mask(env.cfg, one) if highlight
        else np.zeros((w, h), dtype=bool)
    )

    frame = np.zeros((h * tile_size, w * tile_size, 3), dtype=np.uint8)
    for x in range(w):
        for y in range(h):
            tile = render_tile(
                tuple(int(v) for v in grid[x, y]),
                agent=agent_at.get((x, y)),
                highlight=bool(hmask[x, y]),
                tile_size=tile_size,
            )
            frame[y * tile_size:(y + 1) * tile_size,
                  x * tile_size:(x + 1) * tile_size] = tile
    return frame
