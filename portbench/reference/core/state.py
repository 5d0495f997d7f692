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
* ``rng``                     — ``(E, 2)`` int64: each env's threefry2x32
                                key, two uint32 words (``jax.random.key_data``
                                of the JAX package's ``rng``). The env's step
                                splits it for its agents' order and the
                                auto-reset folds it
                                (:mod:`~multigrid_tpu_torch.utils.prng`).

A :class:`~multigrid_tpu_torch.parallel.VectorEnv` with a reserve pool
carries it in ``pool`` (:class:`ResetPool`, its layouts packed): batch-level
state, never selected per env.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .constants import COLOR_RED, EMPTY_ENCODING, TYPE_AGENT, TYPE_EMPTY
from ..utils.device import constant

#: The layout and agent tensor fields in declaration order (``rng`` and
#: ``extras`` excluded): the JAX ``MultiGridState``'s fields but its key.
FIELDS = (
    'grid', 'box_contents', 'agent_pos', 'agent_dir', 'agent_color',
    'agent_terminated', 'agent_carrying', 'agent_carrying_contents',
    'step_count',
)

#: Every tensor field (``extras`` excluded): :data:`FIELDS` and the envs'
#: keys.
STATE_FIELDS = FIELDS + ('rng',)



@dataclasses.dataclass
class ResetPool:
    """A VectorEnv's reserve pool (multigrid_tpu/parallel/vector.py:243-263):
    ``reserve`` holds one pregenerated layout a slot, extras included, in
    the JAX package's storage form (``VectorEnv.pool_pack``,
    vector.py:199-240): ``grid`` one int32 plane (E, W·H) of packed cells
    ``type<<8 | color<<4 | state`` with a Box's contents in bits 12–23, and
    ``box_contents`` zero-sized (E, 0, 0, 3); ``VectorEnv.pool_unpack``
    gives the triples back. ``step`` is the global step ``g`` (env ``i``
    consumes slot ``(i + g) mod E``): a 0-d int64 tensor on the reserve's
    device, as the JAX package carries ``_GSTEP`` on the device, so that a
    captured step reads it there (an int, or a tensor on another device,
    given here becomes one). ``keys`` (E, 2) is each slot's key stream
    (``_RKEY``): a refresh at step ``g`` regenerates a slot from
    ``fold_in(keys[slot], g)``; None where the slots are given without one
    (a refresh then raises). Under a mesh a process holds the slots of its
    own env rows and their keys (``E/R`` of each), the step whole."""

    reserve: 'MultiGridState'
    step: torch.Tensor | int = 0
    keys: torch.Tensor | None = None

    @property
    def nbytes(self) -> int:
        """The bytes this pool holds: the reserve's tensors and extras, the
        slots' keys and the step."""
        r = self.reserve
        tensors = [getattr(r, f) for f in STATE_FIELDS] + list(r.extras.values()) + [
            self.step] + ([] if self.keys is None else [self.keys])
        return sum(t.numel() * t.element_size() for t in tensors)

    def __post_init__(self):
        dev = self.reserve.device
        if not isinstance(self.step, torch.Tensor):
            self.step = torch.tensor(int(self.step), dtype=torch.int64, device=dev)
        elif self.step.device != dev:
            self.step = self.step.to(dev)
        if self.keys is not None and self.keys.device != dev:
            self.keys = self.keys.to(dev)


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
    rng: torch.Tensor
    #: Env-specific extra state (door flags, target encodings, mission
    #: color): tensors with the leading env axis, merged per env like the
    #: fields above.
    extras: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    #: The VectorEnv's reserve pool, where it has one; the per-env code
    #: paths never see it (``VectorEnv.step`` takes it off first).
    pool: ResetPool | None = None

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

        The result's tensors (extras included) are read-only views;
        :meth:`clone` materializes them.
        """
        assert self.num_envs == 1, 'expand takes a single-env state'

        def ex(t):
            return t.expand((num_envs,) + t.shape[1:])
        return self.replace(**{f: ex(getattr(self, f)) for f in STATE_FIELDS},
                            extras={k: ex(v) for k, v in self.extras.items()})

    def clone(self) -> 'MultiGridState':
        """Deep copy with every tensor materialized (contiguous), the
        extras' and the pool's tensors too, so no write to the copy reaches
        the original."""
        def cp(t):
            return t.clone(memory_format=torch.contiguous_format)
        pool = None if self.pool is None else ResetPool(
            self.pool.reserve.clone(), self.pool.step.clone(),
            None if self.pool.keys is None else self.pool.keys.clone())
        return self.replace(**{f: cp(getattr(self, f)) for f in STATE_FIELDS},
                            extras={k: cp(v) for k, v in self.extras.items()}, pool=pool)


def init_state(
    num_envs: int,
    width: int,
    height: int,
    num_agents: int,
    device: str | torch.device,
    has_boxes: bool = True,
) -> MultiGridState:
    """Blank states: empty grid, agents unplaced at (-1, -1), dir -1,
    every key ``[0, 0]``.

    ``has_boxes=False`` allocates a zero-sized ``box_contents`` table, as the
    JAX package does for Box-free environments.
    """
    e, n = num_envs, num_agents
    empty = constant(EMPTY_ENCODING, device, torch.int32)
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
        rng=torch.zeros((e, 2), dtype=torch.int64, device=device),
    )


def is_carrying(state: MultiGridState) -> torch.Tensor:
    """(..., N) bool: whether each agent carries an object
    (multigrid_tpu/core/state.py:169)."""
    return state.agent_carrying[..., 0] != TYPE_EMPTY


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
    with numpy streams that match the reference. ``extras`` holds one env's
    numpy values (no env axis).
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
    """State from a dict of numpy arrays named like :data:`FIELDS` (and ``rng``).

    Carries state across from the JAX package: pass the fields of a
    ``jax.device_get``-ed ``MultiGridState``, batched (leading ``E`` axis)
    or single (no env axis, giving ``E = 1``), and its ``extras`` the same
    way: each extra is converted per env, integer extras to int32 and
    boolean ones kept bool. ``rng`` holds the keys' uint32 words
    (``jax.random.key_data`` of the JAX state's ``rng``); without it every
    key is ``[0, 0]``. Other keys of ``fields`` are ignored.
    """
    single = np.ndim(fields['grid']) == 3

    def conv(a, dtype):
        a = np.asarray(a).astype(dtype)
        if single:
            a = a[None]
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def kind(a):
        return bool if np.asarray(a).dtype == bool else np.int32

    dtypes = {'agent_terminated': bool, 'rng': np.int64}
    fields = dict(fields)
    if fields.get('rng') is None:
        e = () if single else np.shape(fields['grid'])[:1]
        fields['rng'] = np.zeros(e + (2,), np.int64)
    else:
        fields['rng'] = np.asarray(fields['rng']).astype(np.uint32)
    return MultiGridState(
        **{f: conv(fields[f], dtypes.get(f, np.int32)) for f in STATE_FIELDS},
        extras={k: conv(v, kind(v)) for k, v in (extras or {}).items()})


def state_to_numpy(state: MultiGridState) -> dict[str, Any]:
    """Batched numpy copies of the state's tensor fields (``rng`` as uint32
    words, ``jax.random.key_data``'s layout), with its ``extras`` (a dict of
    arrays) and its ``pool`` (None, or the reserve's own ``state_to_numpy``
    in its packed storage form, the step as an int and the slots' keys as
    uint32 words or None)."""
    out: dict[str, Any] = {f: getattr(state, f).cpu().numpy() for f in STATE_FIELDS}
    out['rng'] = out['rng'].astype(np.uint32)
    out['extras'] = {k: v.cpu().numpy() for k, v in state.extras.items()}
    pool = state.pool
    out['pool'] = None if pool is None else {
        'reserve': state_to_numpy(pool.reserve), 'step': int(pool.step),
        'keys': None if pool.keys is None else pool.keys.cpu().numpy().astype(np.uint32)}
    return out


def where_state(
    cond: torch.Tensor, a: MultiGridState, b: MultiGridState
) -> MultiGridState:
    """Per-env select: ``a`` where ``cond`` (shape ``(E,)``), else ``b``,
    for every field and every extra (the extras of a fresh episode are part
    of its state: its mission, its doors' positions). The result keeps
    ``b``'s pool: a pool belongs to the batch, not to an env."""
    def sel(x, y):
        return torch.where(cond.view((-1,) + (1,) * (x.dim() - 1)), x, y)

    if a.extras.keys() != b.extras.keys():
        raise ValueError(f'extras differ: {sorted(a.extras)} and {sorted(b.extras)}')
    return b.replace(**{f: sel(getattr(a, f), getattr(b, f)) for f in STATE_FIELDS},
                     extras={k: sel(a.extras[k], v) for k, v in b.extras.items()})
