"""Partial-observation generation in plain PyTorch.

Counterpart of ``multigrid_tpu.ops.obs`` and the plain version of the CUDA
observation kernel (``ops/obs_cuda.py``): the CPU path, and what the kernel
is held against on the card. For each (env, agent):

1. overlay live agents' encodings into the grid      (reference obs.py:162-173)
2. per-agent view extents                             (obs.py:275-316)
3. crop from a wall-padded grid, so off-grid cells read as walls
4. rotate so the agent faces up                       (obs.py:180-196)
5. carried-object overlay at the agent's view cell    (obs.py:204-207)
6. two-pass flood-fill visibility mask                (obs.py:235-273)
7. unseen-masking                                     (obs.py:93-102)

Steps 3 and 4 are one gather: each output cell reads its rotated source cell
of the window directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.config import EnvConfig
from ..core.constants import (
    DIR_DOWN,
    DIR_LEFT,
    DIR_RIGHT,
    STATE_OPEN,
    TYPE_DOOR,
    TYPE_WALL,
    UNSEEN_ENCODING,
    WALL_ENCODING,
)
from ..core.state import MultiGridState
from ..utils.device import constant


def get_view_exts(
    agent_dir: torch.Tensor, agent_pos: torch.Tensor, view_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-left (x, y) of each agent's view rectangle (obs.py:275-316).

    Elementwise for any batch shape of ``agent_dir`` / ``agent_pos[..., 2]``.
    """
    x = agent_pos[..., 0]
    y = agent_pos[..., 1]
    half = view_size // 2
    top_x = torch.where(
        agent_dir == DIR_RIGHT, x,
        torch.where(agent_dir == DIR_DOWN, x - half,
                    torch.where(agent_dir == DIR_LEFT, x - view_size + 1,
                                x - half)))
    top_y = torch.where(
        agent_dir == DIR_RIGHT, y - half,
        torch.where(agent_dir == DIR_DOWN, y,
                    torch.where(agent_dir == DIR_LEFT, y - half,
                                y - view_size + 1)))
    return top_x, top_y


def see_behind_mask(obs_grid: torch.Tensor) -> torch.Tensor:
    """Whether each view cell can be seen through: not a wall and not a
    door that is closed or locked (obs.py:46-63)."""
    t = obs_grid[..., 0]
    s = obs_grid[..., 2]
    return ~((t == TYPE_WALL) | ((t == TYPE_DOOR) & (s != STATE_OPEN)))


def _shift_up(v: torch.Tensor) -> torch.Tensor:
    """Along the last axis: the value at i moves to i+1."""
    return F.pad(v[..., :-1], (1, 0))


def _shift_down(v: torch.Tensor) -> torch.Tensor:
    """Along the last axis: the value at i moves to i-1."""
    return F.pad(v[..., 1:], (0, 1))


def _propagate(v: torch.Tensor, s: torch.Tensor, shift, steps: int) -> torch.Tensor:
    """Fixpoint of the in-place sweep ``if v[i] & s[i]: v[i ± 1] = True``;
    ``steps`` iterations suffice for a column of ``steps + 1`` cells."""
    for _ in range(steps):
        v = v | shift(v & s)
    return v


def vis_column(carry: torch.Tensor, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One column of the flood fill, the loop form: from its lit cells
    ``carry`` and see-through cells ``s`` (bool, (..., vs), row i on the last
    axis), a forward pass (i ascending) and a backward pass (i descending)
    spread visibility through see-through cells. Returns the column's
    visible cells and the cells of column j-1 it lights (straight and
    diagonal)."""
    vs = s.shape[-1]
    ii = torch.arange(vs, device=s.device)
    f = _propagate(carry, s, _shift_up, vs - 1)
    b = _propagate(f, s, _shift_down, vs - 1)
    # Forward pass checks i in [0, vs-2], lighting (i, j-1), (i+1, j-1);
    # backward pass checks i in [1, vs-1], lighting (i-1, j-1), (i, j-1).
    cf = f & s & (ii != vs - 1)
    cb = b & s & (ii != 0)
    return b, cf | _shift_up(cf) | cb | _shift_down(cb)


def vis_column_bits(lit, see, view_size: int):
    """:func:`vis_column` as the CUDA kernel computes it (csrc/obs.cu,
    ``vis_column``): columns as integers, bit i = row i; ``lit`` and ``see``
    Python ints or integer tensors of any shape. Each pass is an occluded
    fill by doubling (at most 31 rows: four steps reach 15, a fifth 31);
    returns (visible, next column's lit cells)."""
    steps = (1, 2, 4, 8, 16) if view_size > 15 else (1, 2, 4, 8)
    sf = see & ((1 << (view_size - 1)) - 1)  # rows the forward pass checks
    q, p = lit & sf, sf
    for k in steps:
        q = q | (p & (q << k))
        p = p & (p << k)
    col = lit | (q << 1)
    sb = see & ~1  # rows the backward pass checks
    r, p = col & sb, sb
    for k in steps:
        r = r | (p & (r >> k))
        p = p & (p >> k)
    return col | (r >> 1), q | (q << 1) | r | (r >> 1)


def _brev32(x: int) -> int:
    return int(f'{x:032b}'[::-1], 2)


def vis_column_words(lit: list[int], see: list[int], view_size: int):
    """:func:`vis_column` as the general CUDA kernel computes it
    (csrc/obs.cu, ``vis_column_words``, and ``vis_column64``, which is the
    same on two words): a column of any length as a list of 32-bit words
    (bit i of word w = row 32w + i). Each pass is an occluded fill by one
    add: the seeds added to the see-through rows carry up through each run
    of them, so ``mask & ~(mask + seeds) | seeds`` is every run from its
    seed up; the add runs over the words with a carry between them, the
    backward pass on bit-reversed words from the top word down. Returns
    (visible, next column's lit cells) as word lists."""
    nw, full = len(see), 0xFFFFFFFF

    def below(limit, w):
        lo = 32 * w
        return 0 if limit <= lo else full if limit >= lo + 32 else (1 << (limit - lo)) - 1

    q, r, carry = [0] * nw, [0] * nw, 0
    for w in range(nw):
        sf = see[w] & below(view_size - 1, w)
        t = lit[w] & sf
        total = sf + t + carry
        q[w], carry = (sf & ~total & full) | t, total >> 32
    carry = 0
    for w in reversed(range(nw)):
        sb = see[w] & below(view_size, w) & (full - 1 if w == 0 else full)
        col = lit[w] | ((q[w] << 1) & full) | (q[w - 1] >> 31 if w else 0)
        rb, t = _brev32(sb), _brev32(col & sb)
        total = rb + t + carry
        r[w], carry = _brev32((rb & ~total & full) | t), total >> 32
    up = [((q[w] << 1) & full) | (q[w - 1] >> 31 if w else 0) for w in range(nw)]
    down = [(r[w] >> 1) | ((r[w + 1] << 31) & full if w + 1 < nw else 0) for w in range(nw)]
    vis = [lit[w] | up[w] | down[w] for w in range(nw)]
    nxt = [q[w] | up[w] | r[w] | down[w] for w in range(nw)]
    return vis, nxt


def get_vis_mask(obs_grid: torch.Tensor) -> torch.Tensor:
    """Two-pass flood-fill visibility (obs.py:235-273).

    ``obs_grid`` is (..., vs, vs, 3) with the agent at ``(vs//2, vs-1)``
    facing up; returns (..., vs, vs) bool. Columns ``j`` are swept from
    ``vs-1`` down to 0 (:func:`vis_column`), each lit by its neighbour.
    """
    vs = obs_grid.shape[-2]
    see = see_behind_mask(obs_grid)  # (..., vs_i, vs_j)
    ii = torch.arange(vs, device=obs_grid.device)
    cols = [None] * vs
    carry = (ii == vs // 2).expand(see[..., :, vs - 1].shape)
    for j in range(vs - 1, -1, -1):
        cols[j], carry = vis_column(carry, see[..., :, j])
    return torch.stack(cols, dim=-1)


def overlay_agents(state: MultiGridState) -> torch.Tensor:
    """(E, W, H, 3) grid with live agents drawn as (agent, color, dir).

    Agents are drawn in index order, so later agents win a shared cell;
    terminated agents are skipped (obs.py:162-173).
    """
    grid = state.grid.clone()
    w, h = grid.shape[1], grid.shape[2]
    env = torch.arange(grid.shape[0], device=grid.device)
    enc = state.agent_encoding
    for a in range(state.num_agents):
        x, y = state.agent_pos[:, a, 0], state.agent_pos[:, a, 1]
        live = ~state.agent_terminated[:, a] & (x >= 0) & (x < w) & (y >= 0) & (y < h)
        xc, yc = x.clamp(0, w - 1).long(), y.clamp(0, h - 1).long()
        grid[env, xc, yc] = torch.where(live[:, None], enc[:, a], grid[env, xc, yc])
    return grid


def rotation_sources(view_size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(4, vs, vs) window row and column read by output cell (i, j) of
    ``rot90(win, k=-k)``, for k = 0..3."""
    vs = view_size
    i = torch.arange(vs, device=device)[:, None].expand(vs, vs)
    j = torch.arange(vs, device=device)[None, :].expand(vs, vs)
    r = vs - 1
    src_u = torch.stack([i, r - j, r - i, j])
    src_v = torch.stack([j, i, r - j, r - i])
    return src_u, src_v


def gen_obs_grid(state: MultiGridState, view_size: int) -> torch.Tensor:
    """(E, N, vs, vs, 3) observation sub-grids WITHOUT the visibility mask:
    overlay, crop with off-grid cells as walls, rotate to face up, carried
    object at the agent's own cell."""
    vs = view_size
    e, n = state.agent_dir.shape
    w, h = state.grid.shape[1], state.grid.shape[2]
    dev = state.device

    # Single-agent envs skip the overlay: the agent's own cell is overwritten
    # by the carried object below anyway.
    grid = overlay_agents(state) if n > 1 else state.grid
    wall = constant(WALL_ENCODING, dev, torch.int32)
    big = wall.expand(e, w + 2 * vs, h + 2 * vs, 3).clone()
    big[:, vs:vs + w, vs:vs + h] = grid

    top_x, top_y = get_view_exts(state.agent_dir, state.agent_pos, vs)
    k = ((state.agent_dir + 1) % 4).long()                    # (E, N)
    src_u, src_v = rotation_sources(vs, dev)
    xs = (top_x + vs)[:, :, None, None] + src_u[k]            # (E, N, vs, vs)
    ys = (top_y + vs)[:, :, None, None] + src_v[k]
    env = torch.arange(e, device=dev)[:, None, None, None]
    out = big[env, xs.long(), ys.long()]                      # (E, N, vs, vs, 3)
    out[:, :, vs // 2, vs - 1] = state.agent_carrying
    return out


def gen_obs_grid_encoding(
    state: MultiGridState, view_size: int, see_through_walls: bool
) -> torch.Tensor:
    """(E, N, vs, vs, 3) int32 observation images; cells the agent cannot
    see hold the unseen encoding unless ``see_through_walls``."""
    obs = gen_obs_grid(state, view_size)
    if see_through_walls:
        return obs
    vis = get_vis_mask(obs)
    unseen = constant(UNSEEN_ENCODING, obs.device, obs.dtype)
    return torch.where(vis[..., None], obs, unseen)


def pack_cells(img: torch.Tensor) -> torch.Tensor:
    """(..., vs, vs, 3) triples → (..., vs·vs) int32 ``t<<8 | c<<4 | s``."""
    packed = (img[..., 0] << 8) | (img[..., 1] << 4) | img[..., 2]
    return packed.reshape(packed.shape[:-2] + (-1,))


def gen_obs_batched_plain(
    state: MultiGridState,
    view_size: int,
    see_through_walls: bool,
    packed: bool = False,
) -> torch.Tensor:
    """Plain version of the observation kernel: images (E, N, vs, vs, 3), or
    packed cells (E, N, vs·vs) with ``packed=True``."""
    img = gen_obs_grid_encoding(state, view_size, see_through_walls)
    return pack_cells(img) if packed else img


def gen_obs(cfg: EnvConfig, state: MultiGridState) -> dict[str, torch.Tensor]:
    """``{'image': (E, N, vs, vs, 3) int32, 'direction': (E, N) int32}``
    through the plain path (base.py:348-376)."""
    image = gen_obs_grid_encoding(state, cfg.view_size, cfg.see_through_walls)
    return {'image': image, 'direction': state.agent_dir}
