"""Checkpoints of the port (``multigrid_tpu_torch/utils/checkpoint.py``):
a ``TrainState`` with extras, the reserve pool and its keys (the envs',
the pool slots' and the train state's) round trips; training resumes
exactly (K updates, save, restore into freshly
built objects, N - K more ≡ N straight, bit for bit on the CPU); a
params-only restore crosses ``--lr-anneal``; mismatches raise the JAX
package's "checkpoint/env-config mismatch" (multigrid_tpu/utils/checkpoint.py).
"""

import os

import pytest
import torch

from multigrid_tpu_torch.core.state import STATE_FIELDS
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import PPOConfig, linear_schedule, make_train_step, ppo_init
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)

torch.set_num_threads(1)

BUP = 'MultiGrid-BlockedUnlockPickup-v0'
CONFIG = PPOConfig(rollout_steps=4, epochs=2, minibatches=2)


def _setup(seed=0, e=4, encoder='mlp', hidden=16, schedule=True, max_steps=5):
    venv = VectorEnv(make(BUP, agents=2, max_steps=max_steps, device='cpu'), e,
                     packed_obs=True)
    state, net, config, tx = ppo_init(
        venv, seed, config=CONFIG, net_kwargs=dict(hidden=hidden, encoder=encoder),
        lr_schedule=linear_schedule(CONFIG.lr, 0.0, 6) if schedule else None)
    return venv, state, make_train_step(venv, net, config, tx)


def _assert_env_equal(a, b):
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.extras.keys() == b.extras.keys()
    for k in a.extras:
        assert torch.equal(a.extras[k], b.extras[k]), k


def _assert_same(a, b, venv_a, venv_b):
    """Two train states (and their vector envs) hold the same values."""
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    oa, ob = a.opt_state, b.opt_state
    assert (oa.count, oa.schedule_count) == (ob.count, ob.schedule_count)
    for k in oa.mu:
        assert torch.equal(oa.mu[k], ob.mu[k]) and torch.equal(oa.nu[k], ob.nu[k]), k
    _assert_env_equal(a.env_state, b.env_state)
    assert (a.env_state.pool is None) == (b.env_state.pool is None)
    if a.env_state.pool is not None:
        assert a.env_state.pool.step == b.env_state.pool.step
        assert torch.equal(a.env_state.pool.keys, b.env_state.pool.keys)
        _assert_env_equal(a.env_state.pool.reserve, b.env_state.pool.reserve)
    for k in a.last_obs:
        assert torch.equal(a.last_obs[k], b.last_obs[k]), k
    assert torch.equal(a.ep_return_acc, b.ep_return_acc)
    assert a.update_count == b.update_count
    assert torch.equal(a.key, b.key)


def test_round_trip_keeps_extras_pool_and_generators(tmp_path):
    venv, state, step = _setup()
    state, _ = step(state)
    assert state.env_state.pool is not None and state.env_state.pool.step == 4
    assert state.env_state.extras and state.opt_state.schedule_count == 4
    path = save_checkpoint(str(tmp_path / 'step_1'), state, venv)
    assert os.listdir(tmp_path) == ['step_1']  # the temporary file was renamed
    venv2, fresh, _ = _setup(seed=5)
    restored = restore_checkpoint(path, fresh, venv2)
    _assert_same(restored, state, venv2, venv)


@pytest.mark.parametrize('encoder', ['mlp', 'cnn'])
def test_resume_is_exact(tmp_path, encoder):
    """3 updates straight ≡ 1 update, a checkpoint, a restore into freshly
    built objects and 2 more: BUP with episodes of 5 steps, so resets come
    from the pool across the checkpoint, 2 epochs x 2 minibatches (the
    shuffles draw the train state's key) and an annealed rate."""
    venv, state, step = _setup(encoder=encoder)
    straight = state
    for _ in range(3):
        straight, _ = step(straight)

    venv, state, step = _setup(encoder=encoder)
    state, _ = step(state)
    path = save_checkpoint(str(tmp_path / 'step_1'), state, venv)
    venv2, fresh, step2 = _setup(seed=9, encoder=encoder)
    resumed = restore_checkpoint(path, fresh, venv2)
    for _ in range(2):
        resumed, _ = step2(resumed)
    assert resumed.update_count == 3 and resumed.env_state.pool.step == 12
    _assert_same(resumed, straight, venv2, venv2)



def test_restore_params_crosses_lr_anneal(tmp_path):
    """A checkpoint trained with a schedule restores its parameters into a
    net built without one; the whole state does not restore there."""
    venv, state, step = _setup(schedule=True)
    state, _ = step(state)
    path = save_checkpoint(str(tmp_path / 'step_1'), state, venv)
    venv2, plain, _ = _setup(seed=3, schedule=False)
    params = restore_params(path, plain.params)
    for k in params:
        assert torch.equal(params[k], state.params[k]), k
    with pytest.raises(ValueError, match='checkpoint/env-config mismatch.*schedule_count'):
        restore_checkpoint(path, plain, venv2)


def test_mismatches_raise(tmp_path):
    venv, state, _ = _setup()
    path = save_checkpoint(str(tmp_path / 'step_1'), state, venv)
    venv8, other, _ = _setup(e=8)
    with pytest.raises(ValueError, match='checkpoint/env-config mismatch.*env_state'):
        restore_checkpoint(path, other, venv8)
    _, wide, _ = _setup(hidden=32)
    with pytest.raises(ValueError, match='checkpoint/model mismatch'):
        restore_params(path, wide.params)
    _, cnn, _ = _setup(encoder='cnn')
    with pytest.raises(ValueError, match='checkpoint/model mismatch'):
        restore_params(path, cnn.params)
    junk = tmp_path / 'step_2'
    torch.save({'weights': torch.zeros(3)}, junk)
    with pytest.raises(ValueError, match='does not look like a TrainState checkpoint'):
        restore_params(str(junk), state.params)


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path / 'none')) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for name in ('step_2', 'step_10', 'step_9', 'best', 'step_x'):
        (tmp_path / name).write_bytes(b'')
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / 'step_10')
