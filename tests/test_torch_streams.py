"""The port's speed-mode streams ≡ the JAX package's from the same key.

Keyed draws (``multigrid_tpu_torch/utils/prng.py``) make the port's
``VectorEnv`` the JAX package's, bit for bit: its reset from a key, each
step's agent orders, the exact auto-reset and the reserve pool's slots and
refreshes, and the random rollout's actions. The runs of
:mod:`tests.torch_streams` (Empty-16x16 with fixed and random starts, 4
agents; BlockedUnlockPickup, RedBlueDoors-8x8, LockedHallway-2Rooms and
Playground on the exact reset and on the pool; 8 envs, 12 steps of numpy
actions, episodes of 5 steps) are recorded as per-step digests in
``tests/torch_jax_streams.json``, written from the JAX package:

- the port's runs on the CPU give the file's digests (every state field
  with ``rng``, the extras, the pool, the observations, rewards,
  terminations, truncations, ``done`` and ``success``), and two runs'
  ``rollout_random`` summaries (the reward sum to float32 rounding: the
  sum's order differs);
- the file is the JAX package's: one run (:data:`LIVE`) is run again
  through JAX, so that a stale file fails; its env is the one the carried
  state below steps, so the two share their compiles; the other runs
  are written from JAX by the same :func:`jax_run`;

- a JAX state carried across (``state_from_arrays`` with its ``rng``)
  steps on in the port as it does in JAX, and ``state_to_numpy`` gives
  its ``rng`` back.

``python -m tests.test_torch_streams`` rewrites the file from JAX.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.envs import make as jax_make
from multigrid_tpu.parallel.vector import _GSTEP, _RESERVE, _RKEY
from multigrid_tpu.parallel.vector import VectorEnv as JaxVectorEnv
from multigrid_tpu_torch import VectorEnv, make
from multigrid_tpu_torch.core.state import state_from_arrays, state_to_numpy

from . import torch_streams as ts

torch.set_num_threads(1)


def _host(jvenv, state):
    """A JAX state's record: its fields (the key as uint32 words) and
    extras, and its pool as the port holds it."""
    h = jax.device_get(state)
    extras = {k: np.asarray(v) for k, v in h.extras.items() if not k.startswith('_vec:')}
    fields = {f: np.asarray(jax.random.key_data(state.rng)) if f == 'rng'
              else np.asarray(getattr(h, f)) for f in ts.FIELDS}
    fields['extras'] = extras
    pool = None
    if _RESERVE in state.extras:
        r = jax.device_get(jvenv._pool_unpack(state.extras[_RESERVE], state))
        pool = {**{f: np.asarray(getattr(r, f)) for f in ts.FIELDS},
                'extras': {k: np.asarray(v) for k, v in r.extras.items()},
                'keys': np.asarray(h.extras[_RKEY]), 'step': np.int64(h.extras[_GSTEP][0])}
    return fields, pool


def jax_run(name: str) -> dict:
    """The run through the JAX package: :func:`tests.torch_streams.port_run`'s
    form."""
    env_id, n, kw, pool, rollout_steps = ts.RUNS[name]
    jvenv = JaxVectorEnv(jax_make(env_id, agents=n, max_steps=ts.MAX_STEPS, **kw),
                         ts.NUM_ENVS, reset_pool=pool)
    key = jax.random.key(ts.SEED)
    obs, state = jvenv.reset(key)
    steps = [ts.digest(ts.record(*_host(jvenv, state), {'image': np.asarray(obs['image'])}))]
    for a in ts.actions(name):
        obs, state, rew, term, trunc, done, success = jvenv.step(state, jnp.asarray(a))
        out = {'image': obs['image'], 'reward': rew, 'term': term, 'trunc': trunc,
               'done': done, 'success': success}
        steps.append(ts.digest(ts.record(*_host(jvenv, state),
                                         {k: np.asarray(v) for k, v in out.items()})))
    summary = None
    if rollout_steps:
        state, s = jvenv.rollout_random(state, jax.random.fold_in(key, 1), rollout_steps)
        summary = {'reward_sum': float(s['reward_sum']), 'episodes': int(s['episodes']),
                   'obs_sum': int(s['obs_sum']),
                   'final': ts.digest(ts.record(*_host(jvenv, state)))}
    return {'steps': steps, 'rollout': summary}


def _assert_run(got: dict, want: dict, name: str):
    assert got['steps'] == want['steps'], (name, [
        i for i, (a, b) in enumerate(zip(got['steps'], want['steps'])) if a != b])
    assert (got['rollout'] is None) == (want['rollout'] is None), name
    if want['rollout'] is not None:
        g, w = got['rollout'], want['rollout']
        assert (g['episodes'], g['obs_sum'], g['final']) == (
            w['episodes'], w['obs_sum'], w['final']), name
        # float32 sums of the same rewards in another order.
        np.testing.assert_allclose(g['reward_sum'], w['reward_sum'], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('name', list(ts.RUNS))
def test_port_streams_match_the_jax_digests(name):
    """The port's run on the CPU, step by step, is the JAX package's."""
    _assert_run(ts.port_run(name, 'cpu'), ts.load()['runs'][name], name)


#: The run checked against JAX live: a JAX run compiles its reset and step
#: (about 30 s on the CPU), and the others are written by the same code.
LIVE = ('lh2-exact',)


@pytest.mark.parametrize('name', LIVE)
def test_digests_are_the_jax_packages(name):
    """The file's digests of run ``name`` are the JAX package's run, so
    the file cannot go stale."""
    _assert_run(jax_run(name), ts.load()['runs'][name], name)


def test_the_file_names_every_run():
    data = ts.load()
    assert set(data['runs']) == set(ts.RUNS)
    assert data['config'] == config()
    assert all(len(r['steps']) == ts.STEPS + 1 for r in data['runs'].values())
    assert set(LIVE) <= set(ts.RUNS)


def config() -> dict:
    return {'num_envs': ts.NUM_ENVS, 'steps': ts.STEPS, 'max_steps': ts.MAX_STEPS,
            'seed': ts.SEED, 'action_seed': ts.ACTION_SEED,
            'runs': {k: list(v[:2]) + [v[2], v[3], v[4]] for k, v in ts.RUNS.items()}}


def test_carried_jax_state_steps_on_alike():
    """A JAX LockedHallway state (the ``lh2-exact`` run's env, another key)
    carried across with its ``rng`` steps on in the port as in JAX: the
    orders and the auto-reset come from the carried keys; ``state_to_numpy``
    gives the keys back as JAX's words."""
    env_id, n, _, _, _ = ts.RUNS['lh2-exact']
    jvenv = JaxVectorEnv(jax_make(env_id, agents=n, max_steps=ts.MAX_STEPS), ts.NUM_ENVS,
                         reset_pool=False)
    _, jstate = jvenv.reset(jax.random.key(5))
    h = jax.device_get(jstate)
    fields = {f: getattr(h, f) for f in ts.FIELDS if f != 'rng'}
    fields['rng'] = np.asarray(jax.random.key_data(jstate.rng))
    state = state_from_arrays(fields, 'cpu', extras=dict(h.extras))
    np.testing.assert_array_equal(state_to_numpy(state)['rng'], fields['rng'])
    assert state_to_numpy(state)['rng'].dtype == np.uint32
    venv = VectorEnv(make(env_id, agents=n, max_steps=ts.MAX_STEPS, device='cpu'), ts.NUM_ENVS,
                     reset_pool=False)
    for a in np.random.default_rng(1).integers(0, 7, (7, ts.NUM_ENVS, n)).astype(np.int32):
        _, jstate, *_ = jvenv.step(jstate, jnp.asarray(a))
        _, state, *_ = venv.step(state, torch.as_tensor(a))
        fields, _ = _host(jvenv, jstate)
        got = state_to_numpy(state)
        for f in ts.FIELDS:
            np.testing.assert_array_equal(got[f], fields[f], err_msg=f)


def write() -> None:
    """Rewrite ``tests/torch_jax_streams.json`` from the JAX package."""
    data = {'config': config(), 'runs': {name: jax_run(name) for name in ts.RUNS}}
    ts.PATH.write_text(json.dumps(data, indent=1) + '\n')


if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')
    write()
    print(f'wrote {ts.PATH}', file=sys.stderr)
