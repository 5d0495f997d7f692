"""The keyed streams the port shares with the JAX package: the runs that
``tests/torch_jax_streams.json`` records, and their digests.

A run is a ``VectorEnv`` of 8 envs reset from ``key(SEED)`` and stepped 12
times with actions drawn by numpy, episodes of 5 steps so that envs
auto-reset (from the exact reset or the reserve pool); two runs then take a
``rollout_random``. Each step's digest hashes every state field (the keys
``rng`` included), the extras, the reserve pool (its layouts, keys and
step), the observations, rewards, terminations, truncations, ``done`` and
``success``: equal digests are equal streams, bit for bit.

The digests in the file are written from the JAX package
(``python -m tests.test_torch_streams``); ``tests/test_torch_streams.py``
holds the port to them on the CPU and checks them against the JAX package,
and ``chip_smoke.py`` replays them on the card. Imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

PATH = Path(__file__).with_name('torch_jax_streams.json')

NUM_ENVS, STEPS, MAX_STEPS, SEED, ACTION_SEED = 8, 12, 5, 2024, 7
BUP = 'MultiGrid-BlockedUnlockPickup-v0'

#: name: (env id, agents, extra env kwargs, reserve pool, rollout_random steps).
RUNS = {
    'empty16': ('MultiGrid-Empty-16x16-v0', 4, {}, False, 3),
    'empty16-random': ('MultiGrid-Empty-16x16-v0', 4, {'agent_start_pos': None}, False, 0),
    'bup-exact': (BUP, 2, {}, False, 0),
    'bup-pool': (BUP, 2, {}, True, 18),
    'rbd8-exact': ('MultiGrid-RedBlueDoors-8x8-v0', 2, {}, False, 0),
    'rbd8-pool': ('MultiGrid-RedBlueDoors-8x8-v0', 2, {}, True, 0),
    'lh2-exact': ('MultiGrid-LockedHallway-2Rooms-v0', 2, {}, False, 0),
    'lh2-pool': ('MultiGrid-LockedHallway-2Rooms-v0', 2, {}, True, 0),
    'playground-exact': ('MultiGrid-Playground-v0', 3, {}, False, 0),
    'playground-pool': ('MultiGrid-Playground-v0', 3, {}, True, 0),
}

#: The state fields in the JAX ``MultiGridState``'s order, the key last.
FIELDS = ('grid', 'box_contents', 'agent_pos', 'agent_dir', 'agent_color',
          'agent_terminated', 'agent_carrying', 'agent_carrying_contents', 'step_count', 'rng')


def actions(name: str) -> list[np.ndarray]:
    """The run's (E, N) int32 actions, one array a step."""
    n = RUNS[name][1]
    rng = np.random.default_rng(ACTION_SEED)
    return [rng.integers(0, 7, (NUM_ENVS, n)).astype(np.int32) for _ in range(STEPS)]


def _canonical(a) -> bytes:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == bool:
        a = a.astype(np.uint8)
    elif a.dtype.kind in 'iu':
        a = a.astype(np.int64)
    elif a.dtype.kind == 'f':
        a = a.astype(np.float32)
    return f'{a.dtype.str}{a.shape}'.encode() + a.tobytes()


def digest(record: dict) -> str:
    """A 16-hex-digit digest of a step's record: a dict of arrays, and of
    dicts of arrays, hashed in sorted key order with shapes and dtypes
    (integers as int64, booleans as uint8, floats as float32)."""
    h = hashlib.sha256()

    def walk(prefix, x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(f'{prefix}/{k}', x[k])
        elif x is not None:
            h.update(prefix.encode() + b'\0' + _canonical(x))
    walk('', record)
    return h.hexdigest()[:16]


def record(state: dict, pool: dict | None, out: dict | None = None) -> dict:
    """A step's record from host arrays: ``state`` the fields (FIELDS, the
    keys as uint32 words) and ``extras``; ``pool`` the reserve's fields and
    extras, its keys and its step, or None; ``out`` the step's outputs
    (``image``, ``reward``, ``term``, ``trunc``, ``done``, ``success``)."""
    return {'state': state, 'pool': pool, 'out': out}


def load() -> dict:
    return json.loads(PATH.read_text())


def port_run(name: str, device) -> dict:
    """The run on the port (``device`` 'cpu' or the card): ``{'steps':
    [digest of the reset, then of each step], 'rollout': summary or
    None}``."""
    import torch

    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.core.state import state_to_numpy
    from multigrid_tpu_torch.utils import prng

    env_id, n, kw, pool, rollout_steps = RUNS[name]
    venv = VectorEnv(make(env_id, agents=n, max_steps=MAX_STEPS, device=device, **kw),
                     NUM_ENVS, reset_pool=pool)
    key = prng.key(SEED, venv.device)
    obs, state = venv.reset(key)

    def host(s):
        h = state_to_numpy(s)
        fields = {f: h[f] for f in FIELDS}
        fields['extras'] = h['extras']
        p = h['pool']
        # The reserve's layouts as the JAX side records them: unpacked.
        reserve = None if p is None else state_to_numpy(venv.pool_unpack(s.pool.reserve))
        pool_rec = None if p is None else {
            **{f: reserve[f] for f in FIELDS}, 'extras': reserve['extras'],
            'keys': p['keys'], 'step': np.int64(p['step'])}
        return fields, pool_rec

    steps = [digest(record(*host(state), {'image': obs['image'].cpu().numpy()}))]
    for a in actions(name):
        obs, state, rew, term, trunc, done, success = venv.step(
            state, torch.as_tensor(a, device=venv.device))
        out = {'image': obs['image'], 'reward': rew, 'term': term, 'trunc': trunc,
               'done': done, 'success': success}
        steps.append(digest(record(*host(state), {k: v.cpu().numpy() for k, v in out.items()})))
    summary = None
    if rollout_steps:
        state, s = venv.rollout_random(state, prng.fold_in(key, 1), rollout_steps)
        summary = {'reward_sum': float(s['reward_sum']), 'episodes': int(s['episodes']),
                   'obs_sum': int(s['obs_sum']),
                   'final': digest(record(*host(state)))}
    return {'steps': steps, 'rollout': summary}
