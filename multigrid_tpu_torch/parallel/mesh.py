"""The process mesh of a sharded run.

Counterpart of ``multigrid_tpu.parallel.mesh``. A mesh lays the run's
processes out as ``(env, model)``, env-major (global rank ``e·R_m + m`` at
coordinates ``(e, m)``, as ``np.asarray(devices).reshape(n_env, n_model)``
lays out the JAX package's devices). Env batches shard over the data axis
(``'env'``): the processes of env coordinate ``e`` of ``R_e`` hold the
contiguous rows ``[e·E/R_e, (e+1)·E/R_e)`` of the global batch of ``E`` envs,
replicated over ``'model'``. The learner's parameters are replicated,
except that every 2-D ``Dense_0…kernel`` and its Adam moments are split by
columns over ``'model'``, as the JAX dry run places them
(``__graft_entry__.py:85-92``; :func:`shard_params`, :func:`gather_params`).

One process is a mesh of one shard, with no process group, so
``VectorEnv(env, E, mesh=make_mesh())`` works without a launcher. A world
of one that a launcher started (``torchrun --nproc-per-node 1``) has a
process group, and its mesh's collectives are real calls over it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import torch
import torch.distributed as dist

from ..core.state import STATE_FIELDS, MultiGridState, ResetPool
from . import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``(env, model)`` process mesh: ``ranks`` (global ranks, env-major)
    laid out as ``shape``, this process's global ``rank``, and its process
    groups, each None where it would hold one process of several or there
    is no process group (its collectives are then the identity; in a world
    of one every group is the world's): ``group``, the env axis's (the
    processes with this process's model coordinate: gradient means,
    advantage moments, episode sums, the env rows' gathers);
    ``model_group``, the model axis's (the processes with this env
    coordinate: the column gathers of the parameters); ``mesh_group``,
    every process of the mesh."""

    shape: tuple[int, int]
    ranks: tuple[int, ...]
    rank: int
    group: Any = None
    model_group: Any = None
    mesh_group: Any = None
    axis_names: ClassVar[tuple[str, str]] = ('env', 'model')

    @property
    def env_shards(self) -> int:
        return self.shape[0]

    @property
    def model_shards(self) -> int:
        return self.shape[1]

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives: every
        group NCCL's, or none
        (:func:`~multigrid_tpu_torch.parallel.distributed.capturable`)."""
        return all(distributed.capturable(g)
                   for g in (self.group, self.model_group, self.mesh_group))

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
    defaults every process goes to the env axis.

    Every process of the run calls it together, with the same arguments:
    the groups of a mesh over a strict subset of the run's processes, and
    the ``R_m`` env groups and ``R_e`` model groups of a mesh with both axes
    above 1, are new process groups, created in one order on every process
    (``torch.distributed.new_group``). A process outside ``devices`` takes
    part in that, then gets ``ValueError``."""
    world, rank = distributed.process_count(), distributed.process_index()
    ranks = tuple(range(world)) if devices is None else tuple(int(d) for d in devices)
    if n_env_shards is None:
        n_env_shards = len(ranks) // n_model_shards
    if n_env_shards * n_model_shards != len(ranks):
        raise ValueError(f'{n_env_shards} x {n_model_shards} != {len(ranks)} processes')
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f'mesh ranks {ranks} are not distinct processes of {world}')
    groups, made = {}, {}

    def group(members: tuple[int, ...]):
        # One group per member set; None for one process of several.
        if len(members) == world:
            return dist.group.WORLD
        if len(members) == 1:
            return None
        if members not in made:
            made[members] = dist.new_group(list(members))
        return made[members]

    if dist.is_initialized():
        grid = [ranks[e * n_model_shards:(e + 1) * n_model_shards] for e in range(n_env_shards)]
        whole = group(ranks)
        env_groups = [group(tuple(row[m] for row in grid)) for m in range(n_model_shards)]
        model_groups = [group(row) for row in grid]
        if rank in ranks:
            e, m = divmod(ranks.index(rank), n_model_shards)
            groups = dict(group=env_groups[m], model_group=model_groups[e], mesh_group=whole)
    if rank not in ranks:
        raise ValueError(f'process {rank} is not in the mesh {ranks}')
    return Mesh((n_env_shards, n_model_shards), ranks, rank, **groups)


def env_rows(num_envs: int, mesh: Mesh) -> slice:
    """The rows of a global batch of ``num_envs`` envs that this process
    holds; raises unless the env shards divide it."""
    shards = mesh.env_shards
    if num_envs % shards:
        raise ValueError(f'num_envs={num_envs} not divisible by {shards} mesh shards')
    per = num_envs // shards
    return slice(mesh.coords[0] * per, (mesh.coords[0] + 1) * per)


def env_peer(mesh: Mesh, offset: int) -> int:
    """The rank, in this process's env group (:attr:`Mesh.group`), of the
    process ``offset`` env shards after this one, cyclically, with this
    process's model coordinate."""
    e, m = mesh.coords
    peer = mesh.ranks[(e + offset) % mesh.env_shards * mesh.model_shards + m]
    return dist.get_group_rank(mesh.group, peer) if mesh.group is not None else 0


def _map_rows(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, MultiGridState):
        p = tree.pool
        pool = None if p is None else ResetPool(_map_rows(p.reserve, fn), p.step,
                                                None if p.keys is None else fn(p.keys))
        return tree.replace(**{f: fn(getattr(tree, f)) for f in STATE_FIELDS},
                            extras={k: fn(v) for k, v in tree.extras.items()}, pool=pool)
    if isinstance(tree, dict):
        return {k: _map_rows(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_rows(v, fn) for v in tree)
    return tree


def shard_batch(tree, mesh: Mesh):
    """This process's rows of a tree of global ``(E, ...)`` tensors (dicts,
    lists, tuples and states; a state's reserve pool too, its slots and
    their keys cut to the same rows, as ``P('env')`` places the JAX
    package's, its global step kept)."""
    return _map_rows(tree, lambda x: x[env_rows(x.shape[0], mesh)])


def gather_batch(tree, mesh: Mesh):
    """The global batch of a tree of this process's ``(E/R, ...)`` rows
    (the inverse of :func:`shard_batch`; a state's reserve pool too), on
    every process."""
    return _map_rows(tree, lambda x: distributed.all_gather_rows(x, mesh.group))


def model_sharded(name: str, x: torch.Tensor) -> bool:
    """Whether the JAX dry run's placement splits the parameter or moment
    ``name`` over ``'model'``: a 2-D tensor whose name holds ``Dense_0`` and
    ``kernel`` (``__graft_entry__.py:89``). Per-agent policies' kernels are
    stacked to 3-D and stay replicated."""
    return 'Dense_0' in name and 'kernel' in name and x.dim() == 2


def model_columns(columns: int, mesh: Mesh) -> slice:
    """The columns of a ``columns``-wide sharded kernel that this process
    holds; raises unless the model shards divide them."""
    shards = mesh.model_shards
    if columns % shards:
        raise ValueError(f'{columns} columns not divisible by {shards} model shards')
    per = columns // shards
    return slice(mesh.coords[1] * per, (mesh.coords[1] + 1) * per)


def shard_params(params: dict[str, torch.Tensor], mesh: Mesh | None) -> dict[str, torch.Tensor]:
    """This process's part of a dict of full parameters (or of Adam
    moments, keyed alike): every :func:`model_sharded` tensor cut to its
    :func:`model_columns` (a copy, so that the full tensor is not kept),
    the rest as they are; ``params`` itself without a model axis."""
    if mesh is None or mesh.model_shards == 1:
        return params
    return {k: v[:, model_columns(v.shape[1], mesh)].clone(memory_format=torch.contiguous_format)
            if model_sharded(k, v) else v for k, v in params.items()}


def gather_params(params: dict[str, torch.Tensor], mesh: Mesh | None) -> dict[str, torch.Tensor]:
    """The full parameters (or moments) of this process's part, on every
    process of its model group (the inverse of :func:`shard_params`: the
    :func:`model_sharded` tensors' columns gathered in model order)."""
    if mesh is None or mesh.model_shards == 1:
        return params
    return {k: distributed.all_gather_rows(v, mesh.model_group, dim=1)
            if model_sharded(k, v) else v for k, v in params.items()}


__all__ = ['Mesh', 'env_peer', 'env_rows', 'gather_batch', 'gather_params', 'make_mesh',
           'model_columns', 'model_sharded', 'shard_batch', 'shard_params']
