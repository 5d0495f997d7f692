"""The work of tests/test_torch_sharded_pool.py's spawned processes, and the
same work in one process for the comparison. Imports no JAX: the spawned
processes start from a fresh interpreter and load only the port."""

import hashlib

import numpy as np
import torch

from multigrid_tpu_torch.core.actions import NUM_ACTIONS
from multigrid_tpu_torch.core.state import STATE_FIELDS
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
from multigrid_tpu_torch.parallel import VectorEnv, gather_batch, make_mesh
from multigrid_tpu_torch.utils import prng
from multigrid_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

BUP = 'MultiGrid-BlockedUnlockPickup-v0'
RBD = 'MultiGrid-RedBlueDoors-6x6-v0'

#: 24 envs, so that 4 env shards hold 6 slots each and 2 hold 12. A period
#: of 5 refreshes 5 slots a step ([0, 5), [5, 10), ... [19, 24) clamped)
#: and a chunk of 4 refreshes 20 ([0, 20), then [4, 24) clamped): the
#: windows cross the shards' boundaries. Episodes of 4 steps end often, so
#: envs consume slots; 52 steps take the global step past 2E = 48, so that
#: the shift ``k = (g mod E) // L`` takes every value and the window wraps.
NUM_ENVS, PERIOD, CHUNK, STEPS = 24, 5, 4, 52
CASES = {
    'bup': dict(env_id=BUP, env_kwargs=dict(max_steps=4)),
    'rbd': dict(env_id=RBD, env_kwargs=dict(max_steps=4)),
}
#: ``step``: every step refreshes its slots; ``chunked``: steps with
#: ``refresh=False`` and one ``refresh_pool(CHUNK)`` a chunk, as rollouts do.
MODES = ('step', 'chunked')
#: The meshes the spawned processes run, (env shards, model shards).
MESHES = ((4, 1), (2, 2))


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        a = np.ascontiguousarray(t.detach().cpu().numpy())
        h.update(f'{a.dtype.str}{a.shape}'.encode() + a.tobytes())
    return h.hexdigest()[:16]


def _state_parts(state, rows=slice(None)):
    return [getattr(state, f)[rows] for f in STATE_FIELDS] + [
        state.extras[k][rows] for k in sorted(state.extras)]


def state_digest(state, rows=slice(None)) -> str:
    """A digest of a state's rows ``rows``: every field and extra."""
    return _digest(_state_parts(state, rows))


def pool_digest(pool, rows=slice(None)) -> str:
    """A digest of a pool's slots ``rows``: the packed reserve's fields and
    extras, the slots' keys, and the global step."""
    return _digest(_state_parts(pool.reserve, rows) + [pool.keys[rows], pool.step])


def rollout(env_id, env_kwargs, mode, mesh=None) -> dict:
    """Reset (seed 3) and :data:`STEPS` steps of a 24-env batch with 2
    agents, actions drawn from a key at the global shape (this process's
    rows only). At every step the digests of this process's rows of the
    state, observations, rewards and dones, and of its slots of the pool,
    with the number of slots it holds."""
    venv = VectorEnv(make(env_id, agents=2, device='cpu', **env_kwargs), NUM_ENVS,
                     reset_pool=True, reset_pool_period=PERIOD, mesh=mesh)
    obs, state = venv.reset(seed=3)
    key = prng.key(17)
    rec = {'rows': [venv.rows.start, venv.rows.stop], 'steps': [], 'pool': [],
           'slots': [], 'step': []}
    for t in range(STEPS):
        key, actions = prng.randint(key, (NUM_ENVS, 2), 0, NUM_ACTIONS, rows=venv.rows,
                                    split_first=True)
        obs, state, rew, _, _, done, _ = venv.step(state, actions, refresh=mode == 'step')
        if mode == 'chunked' and (t + 1) % CHUNK == 0:
            state = venv.refresh_pool(state, CHUNK)
        rec['steps'].append(_digest(_state_parts(state) + [obs['image'], obs['direction'],
                                                           obs['mission'] if 'mission' in obs
                                                           else rew, rew, done]))
        rec['pool'].append(pool_digest(state.pool))
        rec['slots'].append([state.pool.reserve.grid.shape[0], state.pool.keys.shape[0]])
        rec['step'].append(int(state.pool.step))
    return rec


def one_process(env_id, env_kwargs, mode, rows: list[slice]) -> list[dict]:
    """The one-process run of :func:`rollout`, digested over each of the
    row ranges ``rows`` of the global batch and of the reserve."""
    venv = VectorEnv(make(env_id, agents=2, device='cpu', **env_kwargs), NUM_ENVS,
                     reset_pool=True, reset_pool_period=PERIOD)
    obs, state = venv.reset(seed=3)
    key = prng.key(17)
    recs = [{'steps': [], 'pool': [], 'step': []} for _ in rows]
    for t in range(STEPS):
        key, actions = prng.randint(key, (NUM_ENVS, 2), 0, NUM_ACTIONS, split_first=True)
        obs, state, rew, _, _, done, _ = venv.step(state, actions, refresh=mode == 'step')
        if mode == 'chunked' and (t + 1) % CHUNK == 0:
            state = venv.refresh_pool(state, CHUNK)
        for r, rec in zip(rows, recs):
            rec['steps'].append(_digest(_state_parts(state, r) + [
                obs['image'][r], obs['direction'][r],
                obs['mission'][r] if 'mission' in obs else rew[r], rew[r], done[r]]))
            rec['pool'].append(pool_digest(state.pool, r))
            rec['step'].append(int(state.pool.step))
    return recs


def _train_setup(mesh):
    venv = VectorEnv(make(BUP, agents=2, device='cpu', max_steps=4), NUM_ENVS,
                     packed_obs=True, reset_pool_period=PERIOD, mesh=mesh)
    state, net, config, tx = ppo_init(venv, 5, config=PPOConfig(rollout_steps=3),
                                      net_kwargs=dict(hidden=16, dtype=torch.float32,
                                                      encoder='mlp'))
    return venv, state, make_train_step(venv, net, config, tx)


def train_and_save(path: str, mesh=None) -> str:
    """Two BUP updates on the pool, then a checkpoint at ``path``; the
    digest of the global env state, its pool with it, as saved."""
    venv, state, step = _train_setup(mesh)
    for _ in range(2):
        state, _ = step(state)
    save_checkpoint(path, state, venv)
    env = state.env_state if mesh is None else gather_batch(state.env_state, mesh)
    return state_digest(env) + pool_digest(env.pool)


def restored(path: str, mesh=None) -> dict:
    """The checkpoint at ``path`` restored under ``mesh``: this process's
    rows, the digests of its env state and pool, the slots it holds."""
    venv, state, _ = _train_setup(mesh)
    env = restore_checkpoint(path, state, venv).env_state
    return {'rows': [venv.rows.start, venv.rows.stop],
            'digest': state_digest(env) + pool_digest(env.pool),
            'slots': [env.pool.reserve.grid.shape[0], env.pool.keys.shape[0]]}


def all_scenarios(ckdir: str) -> dict:
    """Every scenario in one process group of 4: the rollouts under each
    mesh of :data:`MESHES`, then a checkpoint written at 4 env shards and
    restored at 2 (the ``(2, 2)`` mesh)."""
    out = {}
    meshes = {shape: make_mesh(*shape) for shape in MESHES}
    for shape, mesh in meshes.items():
        for case, kw in CASES.items():
            for mode in MODES:
                out[f'{shape[0]}x{shape[1]}/{case}/{mode}'] = rollout(**kw, mode=mode,
                                                                     mesh=mesh)
    path = f'{ckdir}/step_2'
    out['saved'] = train_and_save(path, meshes[(4, 1)])
    out['restored_2'] = restored(path, meshes[(2, 2)])
    out['path'] = path
    return out
