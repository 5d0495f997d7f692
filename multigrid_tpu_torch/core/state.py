"""Dense environment state as a dataclass of tensors.

The counterpart of ``multigrid_tpu.core.state``: the grid is a dense
``(W, H, 3)`` array of (type, color, state) triples, Box contents live in a
side table, and agents are split typed arrays. Here every field carries a
leading env axis ``E``; a single environment is the ``E = 1`` case.

Layouts and dtypes (the same as the JAX package's, with the ``E`` axis):

* ``grid``                    — ``(E, W, H, 3)`` int32, x-major.
* ``box_contents``            — ``(E, W, H, 3)`` int32, or ``(E, 0, 0, 3)``
                                for environments that never hold a Box.
* ``agent_pos``               — ``(E, N, 2)`` int32.
* ``agent_dir``, ``agent_color`` — ``(E, N)`` int32.
* ``agent_terminated``        — ``(E, N)`` bool.
* ``agent_carrying``, ``agent_carrying_contents`` — ``(E, N, 3)`` int32.
* ``step_count``              — ``(E,)`` int32.

There is no per-env ``rng`` field. Randomness (agent order, random starts)
comes from a ``torch.Generator`` that the caller passes to the function that
draws, so a state is plain data.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .constants import COLOR_RED, EMPTY_ENCODING, TYPE_AGENT

#: Tensor fields in declaration order (``extras`` excluded).
FIELDS = (
    'grid', 'box_contents', 'agent_pos', 'agent_dir', 'agent_color',
    'agent_terminated', 'agent_carrying', 'agent_carrying_contents',
    'step_count',
)


@dataclasses.dataclass
class MultiGridState:
    """State of ``E`` MultiGrid environments (leading env axis everywhere)."""

    grid: torch.Tensor
    box_contents: torch.Tensor
    agent_pos: torch.Tensor
    agent_dir: torch.Tensor
    agent_color: torch.Tensor
    agent_terminated: torch.Tensor
    agent_carrying: torch.Tensor
    agent_carrying_contents: torch.Tensor
    step_count: torch.Tensor
    #: Env-specific extra state (door flags, target encodings, mission index).
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_envs(self) -> int:
        return self.agent_dir.shape[0]

    @property
    def num_agents(self) -> int:
        return self.agent_dir.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.grid.device

    @property
    def agent_encoding(self) -> torch.Tensor:
        """(E, N, 3) agent grid encodings: (Type.agent, color, dir)."""
        return torch.stack([
            torch.full_like(self.agent_dir, TYPE_AGENT),
            self.agent_color, self.agent_dir,
        ], dim=-1)

    def replace(self, **changes) -> 'MultiGridState':
        return dataclasses.replace(self, **changes)

    def expand(self, num_envs: int) -> 'MultiGridState':
        """Broadcast an ``E = 1`` state to ``num_envs`` envs without copying.

        The result's tensors are read-only views; :meth:`clone` materializes
        them.
        """
        assert self.num_envs == 1, 'expand takes a single-env state'
        return self.replace(**{
            f: getattr(self, f).expand((num_envs,) + getattr(self, f).shape[1:])
            for f in FIELDS})

    def clone(self) -> 'MultiGridState':
        """Deep copy with every tensor materialized (contiguous)."""
        return self.replace(
            **{f: getattr(self, f).clone(memory_format=torch.contiguous_format)
               for f in FIELDS},
            extras=dict(self.extras))


def init_state(
    num_envs: int,
    width: int,
    height: int,
    num_agents: int,
    device: str | torch.device,
    has_boxes: bool = True,
) -> MultiGridState:
    """Blank states: empty grid, agents unplaced at (-1, -1), dir -1.

    ``has_boxes=False`` allocates a zero-sized ``box_contents`` table, as the
    JAX package does for Box-free environments.
    """
    e, n = num_envs, num_agents
    empty = torch.as_tensor(EMPTY_ENCODING, dtype=torch.int32, device=device)
    bc = (width, height) if has_boxes else (0, 0)
    colors = (torch.arange(n, dtype=torch.int32, device=device) % 6) + COLOR_RED
    return MultiGridState(
        grid=empty.expand(e, width, height, 3).clone(),
        box_contents=empty.expand(e, *bc, 3).clone(),
        agent_pos=torch.full((e, n, 2), -1, dtype=torch.int32, device=device),
        agent_dir=torch.full((e, n), -1, dtype=torch.int32, device=device),
        agent_color=colors.expand(e, n).clone(),
        agent_terminated=torch.zeros((e, n), dtype=torch.bool, device=device),
        agent_carrying=empty.expand(e, n, 3).clone(),
        agent_carrying_contents=empty.expand(e, n, 3).clone(),
        step_count=torch.zeros((e,), dtype=torch.int32, device=device),
    )


def state_from_numpy(
    grid: np.ndarray,
    agent_pos: np.ndarray,
    agent_dir: np.ndarray,
    device: str | torch.device,
    *,
    box_contents: np.ndarray | None = None,
    agent_color: np.ndarray | None = None,
    extras: dict[str, Any] | None = None,
    has_boxes: bool = True,
) -> MultiGridState:
    """Build an ``E = 1`` state from one environment's host-side layout.

    Used by the parity-mode reset, where layouts are generated on the host
    with numpy streams that match the reference.
    """
    grid = np.asarray(grid, dtype=np.int32)
    w, h, _ = grid.shape
    n = int(np.asarray(agent_dir).shape[0])
    if box_contents is None:
        bc_shape = (w, h, 3) if has_boxes else (0, 0, 3)
        box_contents = np.broadcast_to(EMPTY_ENCODING, bc_shape)
    if agent_color is None:
        agent_color = np.arange(n, dtype=np.int32) % 6
    empty_n = np.broadcast_to(EMPTY_ENCODING, (n, 3))
    return state_from_arrays(dict(
        grid=grid,
        box_contents=box_contents,
        agent_pos=agent_pos,
        agent_dir=agent_dir,
        agent_color=agent_color,
        agent_terminated=np.zeros((n,), dtype=bool),
        agent_carrying=empty_n,
        agent_carrying_contents=empty_n,
        step_count=np.zeros((), dtype=np.int32),
    ), device, extras=extras)


def state_from_arrays(
    fields: dict[str, np.ndarray],
    device: str | torch.device,
    *,
    extras: dict[str, Any] | None = None,
) -> MultiGridState:
    """State from a dict of numpy arrays named like :data:`FIELDS`.

    Carries state across from the JAX package: pass the fields of a
    ``jax.device_get``-ed ``MultiGridState``, batched (leading ``E`` axis)
    or single (no env axis, giving ``E = 1``). Keys outside :data:`FIELDS`
    (the JAX ``rng`` and ``extras``) are ignored.
    """
    single = np.ndim(fields['grid']) == 3

    def conv(name):
        a = np.asarray(fields[name])
        a = a.astype(bool if name == 'agent_terminated' else np.int32)
        if single:
            a = a[None]
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return MultiGridState(**{f: conv(f) for f in FIELDS},
                          extras=dict(extras or {}))


def state_to_numpy(state: MultiGridState) -> dict[str, np.ndarray]:
    """Batched numpy copies of the state's tensor fields."""
    return {f: getattr(state, f).cpu().numpy() for f in FIELDS}


def where_state(
    cond: torch.Tensor, a: MultiGridState, b: MultiGridState
) -> MultiGridState:
    """Per-env select: ``a`` where ``cond`` (shape ``(E,)``), else ``b``."""
    def sel(x, y):
        return torch.where(cond.view((-1,) + (1,) * (x.dim() - 1)), x, y)
    return b.replace(**{f: sel(getattr(a, f), getattr(b, f)) for f in FIELDS})

