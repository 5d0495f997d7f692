"""The work of tests/test_torch_model_axis.py's four spawned processes, and
the same work in one process for the comparison. Imports no JAX: the
spawned processes start from a fresh interpreter and load only the port."""

import torch
import torch.distributed as dist

from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
from multigrid_tpu_torch.learn.ppo import params_digest
from multigrid_tpu_torch.parallel import (
    VectorEnv,
    distributed,
    gather_params,
    make_mesh,
    model_sharded,
)
from multigrid_tpu_torch.parallel.dryrun import ppo_run
from multigrid_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

#: PPO runs of 3 updates (T 2) on float32 nets, each on a (1, 2) mesh (bit
#: for bit against one process) and on the (2, 2) mesh (rtol 1e-4: a
#: bfloat16 net rounds the reordered gradient sums of two env shards into
#: visible differences at these tiny batches). Hidden 16 takes autograd of
#: the loss, hidden 32 the mlp's PPO-loss kernel's plain version.
_TINY = dict(num_envs=16, updates=3, env_id='MultiGrid-Empty-5x5-v0', agents=2, float32=True,
             config=dict(rollout_steps=2), device='cpu')
RUNS = {
    'cnn': dict(_TINY, encoder='cnn', hidden=16),
    'mlp': dict(_TINY, encoder='mlp', hidden=32),
}
#: The (1, 2) meshes: processes 0-1 and processes 2-3.
PAIRS = ([0, 1], [2, 3])


def setup(encoder: str, mesh=None):
    """A 16-env Empty-5x5 batch, 2 agents, and a float32 net of ``encoder``
    (seed 3): ``(venv, state, step)``."""
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'), 16,
                     packed_obs=encoder == 'mlp', mesh=mesh)
    state, net, config, tx = ppo_init(venv, 3, config=PPOConfig(rollout_steps=2),
                                      net_kwargs=dict(hidden=32, encoder=encoder,
                                                      dtype=torch.float32))
    return venv, state, make_train_step(venv, net, config, tx)


def sharded_part(state) -> dict:
    """The :func:`model_sharded` tensors this process holds, of the
    parameters and both Adam moments: ``{'params/k': rows}``."""
    opt = state.opt_state
    return {f'{part}/{k}': v.tolist() for part, tree in (('params', state.params),
                                                        ('mu', opt.mu), ('nu', opt.nu))
            for k, v in tree.items() if model_sharded(k, v)}


def update_once(encoder: str, mesh=None) -> dict:
    """One update from :func:`setup`: this process's sharded tensors after
    it and the full parameters' digest."""
    venv, state, step = setup(encoder, mesh)
    state, _ = step(state)
    return {'part': sharded_part(state),
            'digest': params_digest(gather_params(state.params, venv.mesh))}


def third_update(state, step, venv) -> dict:
    state, metrics = step(state)
    return {'metrics': {k: float(v) for k, v in metrics.items()},
            'digest': params_digest(gather_params(state.params, venv.mesh))}


def two_then_save(encoder: str, path: str, mesh=None) -> dict:
    """2 updates, a checkpoint at ``path``, then the third update."""
    venv, state, step = setup(encoder, mesh)
    for _ in range(2):
        state, _ = step(state)
    save_checkpoint(path, state, venv)
    return third_update(state, step, venv)


def resume(encoder: str, path: str, mesh=None) -> dict:
    """The third update from the checkpoint at ``path``, restored into
    fresh objects."""
    venv, state, step = setup(encoder, mesh)
    return third_update(restore_checkpoint(path, state, venv), step, venv)


def _groups(mesh) -> dict:
    return {name: None if g is None else dist.get_process_group_ranks(g)
            for name, g in (('env', mesh.group), ('model', mesh.model_group),
                            ('mesh', mesh.mesh_group))}


def all_scenarios(ckdir: str, one_process_checkpoint: str) -> dict:
    """Every scenario on the run's 4 processes, in one process group: the
    (2, 2) mesh's layout and runs; then the two (1, 2) meshes side by side,
    processes 0-1 on the cnn and a checkpoint they write, processes 2-3 on
    the mlp and a checkpoint written in one process, which they resume."""
    rank = distributed.process_index()
    mesh = make_mesh(2, 2)
    out = {'coords': list(mesh.coords), 'groups': _groups(mesh),
           'grid': {k: ppo_run(**kw, mesh=mesh) for k, kw in RUNS.items()}}
    # Every process takes part in creating both pairs' groups.
    pair = None
    for ranks in PAIRS:
        if rank in ranks:
            pair = make_mesh(1, 2, devices=ranks)
        else:
            try:
                make_mesh(1, 2, devices=ranks)
            except ValueError:
                pass
    encoder = 'cnn' if rank in PAIRS[0] else 'mlp'
    out.update(pair_coords=list(pair.coords), pair_groups=_groups(pair), encoder=encoder,
               run=ppo_run(**RUNS[encoder], mesh=pair),
               update_once=update_once(encoder, pair))
    if encoder == 'cnn':
        out['saved'] = two_then_save(encoder, f'{ckdir}/pair', pair)
    else:
        out['resumed'] = resume(encoder, one_process_checkpoint, pair)
    return out
