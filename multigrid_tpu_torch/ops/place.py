"""Batched placement primitives for the speed-mode reset.

The reference places objects and agents by rejection sampling over a
rectangle, accepting the first valid cell (multigrid/base.py:604-670). That
is the same distribution as one uniform draw over the valid cells, which is
what :func:`uniform_position` makes: one fixed-cost draw per env, no loop.
The draws come from a ``torch.Generator`` and cannot match ``jax.random``;
bit-exact parity with the reference's numpy draws is the job of the host
generators in :mod:`multigrid_tpu_torch.envs.parity`.
"""

from __future__ import annotations

import torch

from ..core.constants import TYPE_EMPTY


def agent_occupancy(agent_pos: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(E, W, H) bool mask of cells holding any agent; unplaced agents at
    (-1, -1) hold none."""
    dev = agent_pos.device
    cx = torch.arange(width, device=dev)[None, :, None, None]
    cy = torch.arange(height, device=dev)[None, None, :, None]
    x = agent_pos[:, None, None, :, 0]
    y = agent_pos[:, None, None, :, 1]
    return ((cx == x) & (cy == y)).any(-1)


def uniform_position(
    generator: torch.Generator | None, valid: torch.Tensor
) -> torch.Tensor:
    """(E, 2) int32 cell drawn uniformly from the True entries of each env's
    (W, H) mask. An env with no valid cell gets cell (0, 0); callers must
    guarantee a valid cell, as the reference does by looping forever."""
    e, w, h = valid.shape
    u = torch.rand((e, w * h), generator=generator, device=valid.device)
    # Valid cells score in [1, 2), invalid ones 0: the argmax is valid.
    score = torch.where(valid.reshape(e, -1), u + 1.0, 0.0)
    flat = score.argmax(dim=-1)
    return torch.stack([flat // h, flat % h], dim=-1).to(torch.int32)


def place_obj_mask(grid: torch.Tensor, agent_pos: torch.Tensor) -> torch.Tensor:
    """(E, W, H) validity mask for ``place_obj`` over the whole grid
    (base.py:604-662): cell empty and no agent on it."""
    _, w, h, _ = grid.shape
    return (grid[..., 0] == TYPE_EMPTY) & ~agent_occupancy(agent_pos, w, h)
