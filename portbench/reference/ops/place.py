"""Batched placement primitives for the speed-mode reset.

The reference places objects and agents by rejection sampling over a
rectangle, accepting the first valid cell (multigrid/base.py:604-670). That
is the same distribution as one uniform draw over the valid cells, which is
what :func:`uniform_position` makes: one fixed-cost draw per env, no loop,
from each env's key, bit-equal to the JAX package's
(multigrid_tpu/ops/place.py:48-66). Bit-exact parity with the reference's
numpy draws is the job of the host generators in
:mod:`multigrid_tpu_torch.envs.parity`.

A rectangle's ``top`` and ``size`` are Python pairs (the same for every env)
or ``(E, 2)`` integer tensors (one rectangle per env).
"""

from __future__ import annotations

import torch

from ..core.constants import TYPE_EMPTY
from ..utils import prng
from ..utils.device import constant


def agent_occupancy(agent_pos: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(E, W, H) bool mask of cells holding any agent; unplaced agents at
    (-1, -1) hold none."""
    dev = agent_pos.device
    cx = torch.arange(width, device=dev)[None, :, None, None]
    cy = torch.arange(height, device=dev)[None, None, :, None]
    x = agent_pos[:, None, None, :, 0]
    y = agent_pos[:, None, None, :, 1]
    return ((cx == x) & (cy == y)).any(-1)


def _coord(v, k: int) -> torch.Tensor | int:
    """Coordinate ``k`` of a pair, broadcastable against (E, W, H)."""
    if isinstance(v, torch.Tensor):
        return v[:, k, None, None]
    return int(v[k])


def rect_mask(width: int, height: int, top, size, device) -> torch.Tensor:
    """(E or 1, W, H) bool mask of the cells inside ``[top, top + size)``."""
    xs = torch.arange(width, device=device)[None, :, None]
    ys = torch.arange(height, device=device)[None, None, :]
    tx, ty = _coord(top, 0), _coord(top, 1)
    return ((xs >= tx) & (xs < tx + _coord(size, 0))
            & (ys >= ty) & (ys < ty + _coord(size, 1)))


def uniform_position(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(E, 2) int32 cell drawn uniformly from the True entries of each env's
    (W, H) mask, from each env's key (E, 2): the argmax of random bits over
    the valid cells. An env with no valid cell gets cell (0, 0); callers
    must guarantee a valid cell, as the reference does by looping forever."""
    e, w, h = valid.shape
    flat = argmax_bits(prng.bits(keys, (w, h)), valid).reshape(e)
    return torch.stack([flat // h, flat % h], dim=-1).to(torch.int32)


def argmax_bits(bits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The flat index, over all axes after the first, of the largest of
    ``bits`` (uint32 values) among the True entries of ``valid``: the top
    bit is set on valid entries, so one always wins (index 0 where none
    is), first index on ties, as ``jnp.argmax`` takes it."""
    g = torch.where(valid, (bits >> 1) | 2**31, 0)
    return g.reshape(g.shape[0], -1).argmax(dim=-1)



def set_cell(grid: torch.Tensor, pos: torch.Tensor, enc) -> torch.Tensor:
    """A copy of the (E, W, H, 3) grid with cell ``pos`` (E, 2) of each env
    set to ``enc`` ((3,) or (E, 3))."""
    e = grid.shape[0]
    enc = constant(enc, grid.device, grid.dtype).expand(e, 3)
    grid = grid.clone(memory_format=torch.contiguous_format)
    env = torch.arange(e, device=grid.device)
    grid[env, pos[:, 0].long(), pos[:, 1].long()] = enc
    return grid


def place_obj_mask(grid: torch.Tensor, agent_pos: torch.Tensor, top=None,
                   size=None) -> torch.Tensor:
    """(E, W, H) validity mask for ``place_obj`` (base.py:604-662): cell
    empty, no agent on it, inside the target rectangle (its top clamped at
    0, as the reference clamps it)."""
    _, w, h, _ = grid.shape
    valid = (grid[..., 0] == TYPE_EMPTY) & ~agent_occupancy(agent_pos, w, h)
    if top is not None or size is not None:
        if top is None:
            top = (0, 0)
        elif isinstance(top, torch.Tensor):
            top = top.clamp_min(0)
        else:
            top = (max(top[0], 0), max(top[1], 0))
        valid = valid & rect_mask(w, h, top, (w, h) if size is None else size, grid.device)
    return valid
