"""Batched lockstep execution, on one device or sharded over processes.

Thousands of environments run in lockstep on one card; a run of several
processes (one card each, ``torch.distributed``) shards the env batch over
the ``env`` axis of a process mesh (:mod:`.mesh`, :mod:`.distributed`), and
the learner's ``Dense_0`` kernels over its ``model`` axis.
"""

from .mesh import (
    Mesh,
    env_rows,
    gather_batch,
    gather_params,
    make_mesh,
    model_sharded,
    shard_batch,
    shard_params,
)
from .vector import VectorEnv

__all__ = ['Mesh', 'VectorEnv', 'env_rows', 'gather_batch', 'gather_params', 'make_mesh',
           'model_sharded', 'shard_batch', 'shard_params']
