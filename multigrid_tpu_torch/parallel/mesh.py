"""The process mesh of a sharded run.

Counterpart of ``multigrid_tpu.parallel.mesh``. Env batches shard over a
data axis (``'env'``): process ``r`` of ``R`` holds the contiguous rows
``[r·E/R, (r+1)·E/R)`` of the global batch of ``E`` envs, and the learner's
parameters are replicated. The ``'model'`` axis (a tensor-parallel first
layer in the JAX package's dry run) is not ported: ``n_model_shards`` other
than 1 raises.

One process is a mesh of one shard, with no process group, so
``VectorEnv(env, E, mesh=make_mesh())`` works without a launcher.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import torch
import torch.distributed as dist

from ..core.state import FIELDS, MultiGridState
from . import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``(env, model)`` process mesh: ``ranks`` (global ranks, env-major)
    laid out as ``shape``, this process's global ``rank``, and the env
    axis's process group (None for a mesh of one process, whose
    collectives are the identity)."""

    shape: tuple[int, int]
    ranks: tuple[int, ...]
    rank: int
    group: Any = None
    axis_names: ClassVar[tuple[str, str]] = ('env', 'model')

    @property
    def env_shards(self) -> int:
        return self.shape[0]

    @property
    def coords(self) -> tuple[int, int]:
        """This process's ``(env, model)`` coordinates."""
        i = self.ranks.index(self.rank)
        return i // self.shape[1], i % self.shape[1]


def make_mesh(
    n_env_shards: int | None = None,
    n_model_shards: int = 1,
    *,
    devices: list[int] | None = None,
) -> Mesh:
    """An ``(env, model)`` mesh over ``devices``: global ranks, by default
    every process of the run (this one alone without
    :func:`~multigrid_tpu_torch.parallel.distributed.initialize`). With the
    defaults every process goes to the env axis. A mesh of a strict subset
    of the run's processes creates a process group, which every process of
    the run must do together (``torch.distributed.new_group``)."""
    if n_model_shards != 1:
        raise NotImplementedError(
            "the 'model' mesh axis (a tensor-parallel first layer, "
            "__graft_entry__.py:86-93) is not ported: ROADMAP A, the model-axis item")
    world, rank = distributed.process_count(), distributed.process_index()
    ranks = tuple(range(world)) if devices is None else tuple(int(d) for d in devices)
    if n_env_shards is None:
        n_env_shards = len(ranks) // n_model_shards
    if n_env_shards * n_model_shards != len(ranks):
        raise ValueError(f'{n_env_shards} x {n_model_shards} != {len(ranks)} processes')
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f'mesh ranks {ranks} are not distinct processes of {world}')
    if not dist.is_initialized() or len(ranks) == 1 < world:
        group = None
    elif len(ranks) == world:
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(ranks))
    if rank not in ranks:
        raise ValueError(f'process {rank} is not in the mesh {ranks}')
    return Mesh((n_env_shards, n_model_shards), ranks, rank, group)


def env_rows(num_envs: int, mesh: Mesh) -> slice:
    """The rows of a global batch of ``num_envs`` envs that this process
    holds; raises unless the env shards divide it."""
    shards = mesh.env_shards
    if num_envs % shards:
        raise ValueError(f'num_envs={num_envs} not divisible by {shards} mesh shards')
    per = num_envs // shards
    return slice(mesh.coords[0] * per, (mesh.coords[0] + 1) * per)


def _map_rows(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, MultiGridState):
        return tree.replace(**{f: fn(getattr(tree, f)) for f in FIELDS},
                            extras={k: fn(v) for k, v in tree.extras.items()})
    if isinstance(tree, dict):
        return {k: _map_rows(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_rows(v, fn) for v in tree)
    return tree


def shard_batch(tree, mesh: Mesh):
    """This process's rows of a tree of global ``(E, ...)`` tensors (dicts,
    lists, tuples and states; a state's reserve pool stays whole: every
    process holds the global reserve)."""
    return _map_rows(tree, lambda x: x[env_rows(x.shape[0], mesh)])


def gather_batch(tree, mesh: Mesh):
    """The global batch of a tree of this process's ``(E/R, ...)`` rows
    (the inverse of :func:`shard_batch`), on every process."""
    return _map_rows(tree, lambda x: distributed.all_gather_rows(x, mesh.group))


__all__ = ['Mesh', 'env_rows', 'gather_batch', 'make_mesh', 'shard_batch']
