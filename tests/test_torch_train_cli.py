"""The training CLI's schedules and its train → save → resume → evaluate
path, in process on the CPU (``python -m multigrid_tpu_torch.train`` and
``python -m multigrid_tpu_torch.evaluate``).

The learning-rate schedule is held against ``optax.linear_schedule``
inside ``optax.adam`` (clipped as the JAX package clips), one optimizer
update per SGD minibatch step, to float32 rounding (rtol 1e-6); the
entropy stages against scripts/train.py:183-190.
"""

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multigrid_tpu_torch import evaluate as evaluate_cli
from multigrid_tpu_torch import train as train_cli
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import (
    Optimizer,
    PPOConfig,
    linear_schedule,
    make_train_step,
    ppo_init,
)
from multigrid_tpu_torch.parallel import VectorEnv
from multigrid_tpu_torch.utils.checkpoint import restore_checkpoint

torch.set_num_threads(1)

BUP = 'MultiGrid-BlockedUnlockPickup-v0'


def test_linear_schedule_in_adam_gives_the_optax_steps():
    """``adam(linear_schedule(1, 0, 4))`` on a constant gradient: update
    sizes 1, 0.75, 0.5, 0.25, 0, 0 (the schedule counts from 0)."""
    tx = Optimizer(linear_schedule(1.0, 0.0, 4), max_grad_norm=1e9)
    params = {'w': torch.zeros(3)}
    opt = tx.init(params)
    sizes = []
    for _ in range(6):
        updates, opt = tx.update({'w': torch.ones(3)}, opt)
        sizes.append(float(-updates['w'][0]))
    np.testing.assert_allclose(sizes, [1, 0.75, 0.5, 0.25, 0, 0], atol=1e-5)
    assert opt.count == opt.schedule_count == 6


def test_lr_schedule_matches_optax_per_sgd_step():
    """Two updates of 2 epochs x 2 minibatches: 8 optimizer steps of the
    clipped, scheduled Adam against optax's on the same gradients, every
    update to float32 rounding; the schedule reaches 0 at the step count
    ``total_updates`` as optax's does."""
    rng = np.random.default_rng(0)
    shapes = {'a': (5, 3), 'b': (3,)}
    grads = [{k: rng.normal(size=s).astype(np.float32) * (3 if i % 3 else 0.1)
              for k, s in shapes.items()} for i in range(8)]
    lr, total = 3e-4, 6
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.adam(optax.linear_schedule(lr, 0.0, total)))
    opt_j = tx.init({k: jnp.zeros(s) for k, s in shapes.items()})
    ours = Optimizer(linear_schedule(lr, 0.0, total), 0.5)
    opt = ours.init({k: torch.zeros(s) for k, s in shapes.items()})
    for i, g in enumerate(grads):
        want, opt_j = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_j)
        got, opt = ours.update({k: torch.as_tensor(v) for k, v in g.items()}, opt)
        for k in shapes:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-12, err_msg=f'step {i} {k}')
        if i >= total:
            assert not got['a'].any()
    for t in range(10):
        assert linear_schedule(lr, 0.0, total)(t) == float(optax.linear_schedule(
            lr, 0.0, total)(t))


def test_schedule_counts_sgd_steps():
    """One PPO update of 2 epochs x 2 minibatches advances the schedule by
    4, as optax counts the optimizer's updates."""
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'), 4,
                     packed_obs=True)
    state, net, config, tx = ppo_init(
        venv, 0, config=PPOConfig(rollout_steps=2, epochs=2, minibatches=2), hidden=16,
        net_kwargs=dict(encoder='mlp'), lr_schedule=linear_schedule(3e-4, 0.0, 8))
    state, _ = make_train_step(venv, net, config, tx)(state)
    assert state.opt_state.schedule_count == state.opt_state.count == 4


def test_ent_anneal_stages_match_the_jax_cli():
    """scripts/train.py:183-190: stage = min(update·4 // num_updates, 3),
    ent_coef·(1 - stage/4)."""
    for num_updates in (1, 3, 4, 7, 10, 61):
        for update in range(num_updates):
            stage = min(update * 4 // max(num_updates, 1), 3)
            assert train_cli.ent_coef_at(0.01, update, num_updates) == \
                0.01 * (1.0 - stage / 4), (num_updates, update)


def _rows(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith('{')]


def _train(args, capsys):
    train_cli.main(['--device', 'cpu', '--env', BUP, '--num-envs', '8', '--rollout-steps',
                    '4', '--hidden', '16', '--log-interval', '1'] + args)
    return capsys.readouterr().out


def _params(path):
    return torch.load(path, weights_only=True)['train_state']['params']


def test_cli_trains_saves_resumes_and_evaluates(tmp_path, capsys):
    """The JAX CLI's defaults (the cnn, packed cells, the pool on BUP):
    4 updates straight ≡ 2 updates and a resume for 2 more, bit for bit;
    then the evaluation reads the checkpoint and prints its JSON row."""
    per_update = 8 * 2 * 4
    straight, split = tmp_path / 'straight', tmp_path / 'split'
    out = _train(['--num-timesteps', str(4 * per_update), '--save-dir', str(straight),
                  '--save-interval', '2'], capsys)
    assert out.splitlines()[0].startswith(f'training {BUP}: 2 agents x 8 envs, 4 updates')
    assert [r['update'] for r in _rows(out)] == [1, 2, 3, 4]
    assert out.splitlines()[-1].startswith('timing: {"update": {"total_s"')
    assert sorted(p.name for p in straight.iterdir()) == ['step_2', 'step_4']
    _train(['--num-timesteps', str(2 * per_update), '--save-dir', str(split)], capsys)
    out = _train(['--num-timesteps', str(4 * per_update), '--save-dir', str(split),
                  '--load-dir', str(split), '--save-interval', '2'], capsys)
    assert out.splitlines()[0] == f'resumed from {split / "step_2"} (update 2)'
    assert [r['update'] for r in _rows(out)] == [3, 4]
    want, got = _params(straight / 'step_4'), _params(split / 'step_4')
    assert want['Conv_0.kernel'].shape == (16, 21, 3, 3)  # the cnn by default
    for k in want:
        assert torch.equal(got[k], want[k]), k

    result = evaluate_cli.main(['--device', 'cpu', '--env', BUP, '--num-envs', '8',
                                '--num-steps', '5000', '--hidden', '16', '--load-dir',
                                str(split), '--env-config', '{"max_steps": 20}'])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f'loaded policy from {split / "step_4"}'
    assert json.loads(lines[-1]) == result
    assert result['agent_steps'] == 2 * 256 * 8 * 2 and result['episodes'] >= 8 * 25
    assert 0 <= result['success_rate_exact'] <= 1
    assert set(result) == {'checkpoint', 'agent_steps', 'episodes', 'success_rate_exact',
                           'mean_episode_return', 'eval_agent_steps_per_sec'}

    with pytest.raises(SystemExit, match='Hint'):
        _train(['--num-timesteps', str(4 * per_update), '--save-dir', str(split),
                '--load-dir', str(split), '--encoder', 'mlp'], capsys)
    with pytest.raises(SystemExit, match='Hint'):
        evaluate_cli.main(['--device', 'cpu', '--env', BUP, '--num-envs', '8',
                           '--hidden', '32', '--load-dir', str(split)])


def test_cli_lr_anneal_reaches_zero_per_sgd_step(tmp_path, capsys):
    """``--lr-anneal`` over 4 updates of 2 x 2 SGD steps reaches 0 after the
    first update (the JAX package's schedule counts SGD steps): the
    parameters stop moving; ``--ent-anneal`` prints its stages."""
    out = _train(['--num-timesteps', str(4 * 64), '--save-dir', str(tmp_path),
                  '--save-interval', '1', '--lr-anneal', '--ent-anneal', '--epochs', '2',
                  '--minibatches', '2', '--encoder', 'mlp'], capsys)
    assert [line for line in out.splitlines() if line.startswith('ent-anneal')] == [
        'ent-anneal stage: ent_coef -> 0.0075', 'ent-anneal stage: ent_coef -> 0.005',
        'ent-anneal stage: ent_coef -> 0.0025']
    first = _params(tmp_path / 'step_1')
    venv = VectorEnv(make(BUP, agents=2, device='cpu'), 8, packed_obs=True)
    state, *_ = ppo_init(venv, 0, net_kwargs=dict(hidden=16, encoder='mlp'),
                         lr_schedule=linear_schedule(3e-4, 0.0, 4),
                         config=PPOConfig(rollout_steps=4, epochs=2, minibatches=2))
    assert not torch.equal(first['img_kernel'], state.params['img_kernel'].cpu())
    for k in ('step_2', 'step_4'):
        later = _params(tmp_path / k)
        for name in first:
            assert torch.equal(later[name], first[name]), (k, name)
    restored = restore_checkpoint(str(tmp_path / 'step_4'), state, venv)
    assert restored.opt_state.schedule_count == 16


def test_cli_takes_env_config_triples_and_updates_per_call(tmp_path, capsys):
    """``--env-config``, ``--no-packed-obs`` and ``--updates-per-call 2``:
    2 calls of 2 updates each; the env's max_steps is the configured one.
    ``--save-best success_rate`` keeps ``best`` at the first window with
    enough episodes (a NaN-safe, strict improvement: truncated episodes
    give 0.0, never above it again here)."""
    out = _train(['--env', 'MultiGrid-Empty-5x5-v0', '--env-config', '{"max_steps": 3}',
                  '--no-packed-obs', '--updates-per-call', '2', '--num-timesteps',
                  str(4 * 64), '--save-dir', str(tmp_path), '--save-interval', '1',
                  '--save-best', 'success_rate', '--save-best-min-episodes', '8'], capsys)
    rows = _rows(out)
    assert [r['update'] for r in rows] == [1, 2] and rows[-1]['agent_steps'] == 4 * 64
    assert rows[-1]['episodes_in_batch'] > 0  # episodes of 3 steps end in each rollout
    best = [line for line in out.splitlines() if line.startswith('best ')]
    assert best == [f'best success_rate={rows[0]["success_rate"]:.4f} -> {tmp_path / "best"}']
    assert sorted(p.name for p in tmp_path.iterdir()) == ['best', 'step_1', 'step_2']
    last = torch.load(tmp_path / 'step_2', weights_only=True)['train_state']
    assert last['update_count'] == 4 and last['last_obs']['image'].shape == (8, 2, 7, 7, 3)


def test_entry_points_run_with_jax_blocked(tmp_path):
    """Train, resume from the checkpoint and evaluate in a process where
    importing JAX or the JAX package fails: the checkpoint's ``torch.load``
    and the evaluation pull in neither."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ck = str(tmp_path)
    code = (
        f"import sys\nsys.path.insert(0, {root!r})\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'multigrid_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from multigrid_tpu_torch import evaluate, train\n"
        "args = ['--device', 'cpu', '--env', 'MultiGrid-Empty-5x5-v0', '--num-envs', '4',\n"
        "        '--rollout-steps', '2', '--hidden', '8', '--save-dir', " + repr(ck) + ",\n"
        "        '--save-interval', '1']\n"
        "train.main(args + ['--num-timesteps', '16'])\n"
        "train.main(args + ['--num-timesteps', '32', '--load-dir', " + repr(ck) + "])\n"
        "evaluate.main(['--device', 'cpu', '--env', 'MultiGrid-Empty-5x5-v0',\n"
        "               '--num-envs', '4', '--num-steps', '8', '--hidden', '8',\n"
        "               '--load-dir', " + repr(ck) + "])\n"
        "assert not any(m.startswith(('jax', 'flax', 'optax', 'orbax')) for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n")
    out = subprocess.run([sys.executable, '-I', '-c', code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert any(line.startswith('resumed from') for line in lines)
    assert json.loads(lines[-1])['agent_steps'] == 256 * 4 * 2
