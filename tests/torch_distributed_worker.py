"""The work of tests/test_torch_distributed.py's spawned processes, and the
same work in one process for the comparison. Imports no JAX: the spawned
processes start from a fresh interpreter and load only the port."""

import time

import torch

from multigrid_tpu_torch.core.actions import NUM_ACTIONS
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
from multigrid_tpu_torch.learn.ppo import params_digest
from multigrid_tpu_torch.parallel import VectorEnv, distributed, gather_batch, make_mesh
from multigrid_tpu_torch.parallel.dryrun import ppo_run
from multigrid_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from multigrid_tpu_torch.utils import prng

BUP = 'MultiGrid-BlockedUnlockPickup-v0'

#: Rollouts held bit for bit: the counterpart of tests/test_multichip.py:41-56
#: (Empty-8x8, 2 agents, 16 envs, 4 steps) and of :59-75 (BUP on the
#: reserve pool with max_steps 6, 8 steps so that episodes end), with the
#: actions fixed or drawn from a key, each process drawing its own rows.
ROLLOUTS = {
    'empty-explicit': dict(env_id='MultiGrid-Empty-8x8-v0', env_kwargs={}, steps=4, drawn=False),
    'empty-drawn': dict(env_id='MultiGrid-Empty-8x8-v0', env_kwargs={}, steps=4, drawn=True),
    'bup-pool-explicit': dict(env_id=BUP, env_kwargs=dict(max_steps=6), steps=8, drawn=False),
    'bup-pool-drawn': dict(env_id=BUP, env_kwargs=dict(max_steps=6), steps=8, drawn=True),
}
ROLLOUT_ENVS = 16

#: Sharded train steps (2 updates, T 2) held to one process at rtol 1e-4,
#: on float32 nets: a bfloat16 net rounds the few-ulp differences of the
#: reordered gradient sums into visible ones within two updates at these
#: tiny batches. Hidden 16 takes autograd of the loss; hidden 32 the PPO-loss
#: kernel's plain version.
_TINY = dict(num_envs=16, updates=2, env_id='MultiGrid-Empty-5x5-v0', agents=2,
             float32=True, device='cpu')
TRAIN_RUNS = {
    'default': dict(_TINY, hidden=16, config=dict(rollout_steps=2)),
    'default-loss-kernel': dict(_TINY, hidden=32, config=dict(rollout_steps=2)),
    'minibatches': dict(_TINY, hidden=16, config=dict(rollout_steps=2, minibatches=2,
                                                      epochs=2)),
    'minibatches-loss-kernel': dict(_TINY, hidden=32, config=dict(rollout_steps=2,
                                                                  minibatches=4)),
    'per-agent': dict(_TINY, hidden=16, config=dict(rollout_steps=2,
                                                    per_agent_policies=True)),
    'per-agent-loss-kernel': dict(_TINY, hidden=32, config=dict(rollout_steps=2,
                                                                per_agent_policies=True)),
    'critic': dict(_TINY, hidden=16, config=dict(rollout_steps=2, centralized_critic=True)),
    'fused-policy': dict(_TINY, hidden=32, fused_policy=True, config=dict(rollout_steps=2)),
    'bup-pool': dict(_TINY, env_id=BUP, env_kwargs=dict(max_steps=6), hidden=32,
                     config=dict(rollout_steps=4)),
}


def rollout(env_id, env_kwargs, steps, drawn, mesh=None) -> dict:
    """Reset (seed 5) and ``steps`` steps of a 16-env batch with 2 agents,
    then a 4-step ``rollout_random``; the global grids, observations,
    rewards and dones of every step, the summary, the final keys and the
    final pool step. Drawn actions are ``randint`` of a key chain's keys at
    the global shape, each process computing only its rows."""
    venv = VectorEnv(make(env_id, agents=2, device='cpu', **env_kwargs), ROLLOUT_ENVS,
                     mesh=mesh)

    def glob(x):
        return (x if mesh is None else gather_batch(x, mesh)).tolist()

    obs, state = venv.reset(seed=5)
    rec = {'grid': [glob(state.grid)], 'image': [glob(obs['image'])], 'reward': [],
           'done': []}
    fixed = torch.zeros((ROLLOUT_ENVS, 2), dtype=torch.int32)
    fixed[:, 0] = 2
    key = prng.key(11)
    for _ in range(steps):
        key, ak = prng.split(key).unbind(0)
        actions = (prng.randint(ak, (ROLLOUT_ENVS, 2), 0, NUM_ACTIONS, rows=venv.rows)
                   if drawn else venv.local(fixed))
        obs, state, rew, _, _, done, _ = venv.step(state, actions)
        for k, v in (('grid', state.grid), ('image', obs['image']), ('reward', rew),
                     ('done', done)):
            rec[k].append(glob(v))
    state, summary = venv.rollout_random(state, key, 4)
    rec['summary'] = {k: float(v) for k, v in summary.items()}
    rec['final_grid'] = glob(state.grid)
    rec['final_rng'] = glob(state.rng)
    rec['pool_step'] = None if state.pool is None else int(state.pool.step)
    return rec


def _setup(mesh):
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'), 16,
                     packed_obs=True, mesh=mesh)
    state, net, config, tx = ppo_init(venv, 3, config=PPOConfig(rollout_steps=2),
                                      net_kwargs=dict(hidden=32, dtype=torch.float32, encoder='mlp'))
    return venv, state, make_train_step(venv, net, config, tx)


def checkpoint_resume(ckdir: str, mesh=None) -> dict:
    """2 updates, a checkpoint, a third update; then fresh objects restored
    from the checkpoint take the third update again. Returns both third
    updates' metrics and parameter digests, and the checkpoint's path."""
    venv, state, step = _setup(mesh)
    for _ in range(2):
        state, _ = step(state)
    path = save_checkpoint(f'{ckdir}/step_2', state, venv)
    state, straight = step(state)
    venv2, state2, step2 = _setup(mesh)
    state2, resumed = step2(restore_checkpoint(path, state2, venv2))
    return {'path': path,
            'straight': {k: float(v) for k, v in straight.items()},
            'resumed': {k: float(v) for k, v in resumed.items()},
            'digests': [params_digest(state.params), params_digest(state2.params)]}


def third_update_from(path: str) -> dict:
    """One process restoring the checkpoint at ``path`` (global shapes) and
    taking one update: its metrics and the restored state's shapes."""
    venv, state, step = _setup(None)
    state = restore_checkpoint(path, state, venv)
    shapes = {'grid': list(state.env_state.grid.shape),
              'image': list(state.last_obs['image'].shape),
              'ep_return_acc': list(state.ep_return_acc.shape)}
    _, metrics = step(state)
    return {'shapes': shapes, 'metrics': {k: float(v) for k, v in metrics.items()}}


def all_scenarios(ckdir: str) -> dict:
    """Every scenario on the run's processes, in one process group."""
    mesh = make_mesh()
    return {'summary': distributed.process_summary('cpu'), 'coords': list(mesh.coords),
            'rollouts': {k: rollout(**kw, mesh=mesh) for k, kw in ROLLOUTS.items()},
            'train': {k: ppo_run(**kw) for k, kw in TRAIN_RUNS.items()},
            'checkpoint': checkpoint_resume(ckdir, mesh)}


def fail_on_process_1() -> None:
    """Process 1 raises; process 0 waits for it in a collective."""
    if distributed.process_index() == 1:
        raise ValueError('process 1 fails')
    distributed.barrier(make_mesh().group)


def hang() -> None:
    time.sleep(600)
