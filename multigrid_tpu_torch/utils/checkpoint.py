"""Checkpoint and resume with ``torch.save``.

Counterpart of ``multigrid_tpu.utils.checkpoint`` (which saves through
orbax): one file holds the whole training state (parameters, the
optimizer's count, moments and schedule count, the env batch with its
extras, its keys and its reserve pool with its slots' keys, the last
observations, the running episode returns, the update count, and the
train state's key, which draws the actions and shuffles), so a resumed run
continues exactly where the saved one stood, as the JAX package's
checkpoint carries its keys. A checkpoint written by the JAX package is
not read here.

A sharded run's checkpoint holds the global state, as the JAX package's
holds global arrays: the columns of the ``Dense_0`` kernels and of their
Adam moments are gathered over the ``'model'`` axis, the processes' env
rows over ``'env'`` (the reserve pool's slots and keys with them, packed),
and the mesh's first process alone writes; on restore
every process reads the file and takes its rows and columns, so a
checkpoint written on one mesh restores on any other, or in one process.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any

import torch

from ..core.state import STATE_FIELDS, MultiGridState, ResetPool
from ..learn.ppo import OptState, TrainState
from ..parallel import distributed
from ..parallel.mesh import gather_batch, gather_params, shard_params
from ..parallel.vector import VectorEnv
from .profiling import trace_annotation


def _state_tree(s: MultiGridState) -> dict[str, Any]:
    return {**{f: getattr(s, f) for f in STATE_FIELDS}, 'extras': dict(s.extras),
            'pool': None if s.pool is None else {'reserve': _state_tree(s.pool.reserve),
                                                 'step': s.pool.step, 'keys': s.pool.keys}}


def _state_from_tree(t: dict[str, Any]) -> MultiGridState:
    pool = t['pool']
    return MultiGridState(
        **{f: t[f] for f in STATE_FIELDS}, extras=t['extras'],
        pool=None if pool is None else ResetPool(_state_from_tree(pool['reserve']),
                                                 pool['step'], pool['keys']))


def _train_tree(state: TrainState) -> dict[str, Any]:
    opt = state.opt_state
    return {
        'params': state.params,
        'opt_state': {'count': opt.count, 'mu': opt.mu, 'nu': opt.nu,
                      'schedule_count': opt.schedule_count},
        'env_state': _state_tree(state.env_state),
        'last_obs': dict(state.last_obs),
        'ep_return_acc': state.ep_return_acc,
        'update_count': state.update_count,
        'key': state.key,
    }


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _mismatch(where: str, stored, want) -> ValueError:
    return ValueError(
        f'checkpoint/env-config mismatch: stored leaf {where} is {stored} but the restore '
        f'target expects {want}; the checkpoint was likely written under a different '
        'environment configuration')


def _place(target, stored, where: str):
    """``stored`` laid out like ``target``: the same keys, tensors of the
    same shapes (moved to the target's device and dtype), ints where it has
    ints and None where it has None. An int stored where the target holds a
    0-d tensor (the optimizer's counts and the pool's step, which checkpoints
    written before they moved onto the device hold as ints) becomes one."""
    if isinstance(target, torch.Tensor) and target.dim() == 0 \
            and isinstance(stored, int) and not isinstance(stored, bool):
        stored = torch.tensor(stored)
    if isinstance(target, torch.Tensor):
        if not isinstance(stored, torch.Tensor) or stored.shape != target.shape:
            raise _mismatch(where, getattr(stored, 'shape', stored), tuple(target.shape))
        return stored.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        if not isinstance(stored, dict) or set(stored) != set(target):
            keys = sorted(stored) if isinstance(stored, dict) else stored
            raise _mismatch(where, f'keys {keys}', f'keys {sorted(target)}')
        return {k: _place(target[k], stored[k], f'{where}.{k}') for k in target}
    if (target is None) != (stored is None) or \
            isinstance(target, int) != isinstance(stored, int):
        raise _mismatch(where, stored, target)
    return stored


def _load(path: str) -> dict[str, Any]:
    raw = torch.load(path, map_location='cpu', weights_only=True)
    if not isinstance(raw, dict) or 'train_state' not in raw:
        keys = list(raw) if isinstance(raw, dict) else type(raw).__name__
        raise ValueError(f'{path} does not look like a TrainState checkpoint '
                         f'(top-level keys: {keys})')
    return raw


def _local_part(tree: dict[str, Any], venv: VectorEnv) -> dict[str, Any]:
    """A stored train tree's ``Dense_0`` columns and env rows cut to this
    process's, the reserve pool's slots and keys too (its step whole)."""
    opt = tree['opt_state']
    tree = {**tree, 'params': shard_params(tree['params'], venv.mesh),
            'opt_state': {**opt, 'mu': shard_params(opt['mu'], venv.mesh),
                          'nu': shard_params(opt['nu'], venv.mesh)}}
    if venv.local_envs == venv.num_envs:
        return tree
    stored = tuple(getattr(tree.get('ep_return_acc'), 'shape', ()))
    if stored != (venv.num_envs,):
        raise _mismatch('train_state.ep_return_acc', stored, (venv.num_envs,))
    rows = venv.rows

    def cut(env):
        pool = env['pool']
        if pool is not None:
            pool = {**pool, 'reserve': cut(pool['reserve']),
                    'keys': None if pool['keys'] is None else pool['keys'][rows]}
        return {**{f: env[f][rows] for f in STATE_FIELDS}, 'pool': pool,
                'extras': {k: v[rows] for k, v in env['extras'].items()}}
    return {**tree,
            'env_state': cut(tree['env_state']),
            'last_obs': {k: v[rows] for k, v in tree['last_obs'].items()},
            'ep_return_acc': tree['ep_return_acc'][rows]}


def save_checkpoint(path: str, state: TrainState, venv: VectorEnv) -> str:
    """Atomically write ``state`` to the file ``path`` (a temporary file
    in the same directory, then a rename).
    Under a mesh every process calls it: the kernels' columns and the env
    rows (the reserve's slots and keys among them) are gathered, the
    mesh's first process writes, and all return once
    the file is there. Returns the absolute path."""
    with trace_annotation('mgt.checkpoint.save'):
        mesh = venv.mesh
        if mesh is not None:
            opt = state.opt_state
            state = state.replace(
                params=gather_params(state.params, mesh),
                opt_state=dataclasses.replace(opt, mu=gather_params(opt.mu, mesh),
                                              nu=gather_params(opt.nu, mesh)),
                env_state=gather_batch(state.env_state, mesh),
                last_obs=gather_batch(state.last_obs, mesh),
                ep_return_acc=gather_batch(state.ep_return_acc, mesh))
            if mesh.coords != (0, 0):
                distributed.barrier(mesh.mesh_group)
                return os.path.abspath(path)
        path = _write(path, state, venv)
        if mesh is not None:
            distributed.barrier(mesh.mesh_group)
        return path


def _write(path: str, state: TrainState, venv: VectorEnv) -> str:
    path = os.path.abspath(path)
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    tree = {'train_state': _to_cpu(_train_tree(state))}
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=f'.{os.path.basename(path)}.')
    try:
        with os.fdopen(fd, 'wb') as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def restore_checkpoint(path: str, target: TrainState, venv: VectorEnv) -> TrainState:
    """The training state saved at ``path``, laid out like ``target`` (a
    freshly initialized ``TrainState`` for the same configuration: its
    tensors give the shapes, devices and dtypes; under a mesh, this
    process's rows of the stored global batch and its columns of the
    stored ``Dense_0`` kernels and moments) and the saved keys. Any
    difference of structure or shape raises ``ValueError``
    (checkpoint/env-config mismatch)."""
    raw = _load(path)
    tree = _place(_train_tree(target), _local_part(raw['train_state'], venv), 'train_state')
    opt = tree['opt_state']
    return target.replace(
        params=tree['params'],
        opt_state=OptState(opt['count'], opt['mu'], opt['nu'], opt['schedule_count']),
        env_state=_state_from_tree(tree['env_state']),
        last_obs=tree['last_obs'],
        ep_return_acc=tree['ep_return_acc'],
        key=tree['key'],
        update_count=tree['update_count'])



def restore_params(path: str, target_params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Only the parameters of a checkpoint, laid out like
    ``target_params`` (evaluation needs no optimizer state, whose layout
    depends on training flags such as ``--lr-anneal``)."""
    stored = _load(path)['train_state']['params']
    if set(stored) != set(target_params):
        raise ValueError(f'checkpoint/model mismatch: stored parameters {sorted(stored)} '
                         f'but the target has {sorted(target_params)}')
    for k, t in target_params.items():
        if stored[k].shape != t.shape:
            raise ValueError(f'checkpoint/model mismatch: stored parameter {k} has shape '
                             f'{tuple(stored[k].shape)} but the target expects {tuple(t.shape)}')
    return {k: stored[k].to(device=t.device, dtype=t.dtype) for k, t in target_params.items()}


def latest_checkpoint(directory: str) -> str | None:
    """The ``step_*`` checkpoint of the highest step in ``directory``, or
    None."""
    if not os.path.isdir(directory):
        return None
    steps = [d for d in os.listdir(directory)
             if d.startswith('step_') and d.split('_')[-1].isdigit()]
    if not steps:
        return None
    return os.path.join(directory, max(steps, key=lambda d: int(d.split('_')[-1])))
