"""The PPO cells' driver and comparison (cells that ``BENCHMARK.json`` does
not hold yet) on the CPU at a tiny size: a sound run's exact numbers, and
the control and each fault, planted in the reference put in the program's
place or in the program itself, read well above a sound run in at least
one number, and above its limit."""

import pytest
import torch

from portbench import harness
from portbench.control import control_checks

CELLS = ['bup-ppo', 'empty16-ppo']


def cell_of(root, name, seed=2**31 + 99):
    return harness.resolve(name, seed, 0.5, False, 'cpu', 0.0, root=root)


def sound(root, name):
    c, bench = cell_of(root, name)
    return harness.run_cell(c, bench, root=root)['checks']


def caught(checks, reference):
    """Whether some number reads over its limit and 3 times the sound
    run's reading."""
    return any(c.value > c.limit and c.value > 3 * reference[c.name]['value'] for c in checks)


@pytest.mark.parametrize('name', CELLS)
def test_sound_run_follows_the_reference(tiny_ppo_root, name):
    checks = sound(tiny_ppo_root, name)
    assert checks['start_differs']['value'] == 0
    assert checks['envs_differ']['value'] == 0
    assert all(c['value'] < 0.1 for c in checks.values())


@pytest.mark.parametrize('name', CELLS)
@pytest.mark.parametrize('kind', ['control', 'half', 'altered'])
def test_control_and_faults_are_caught(tiny_ppo_root, name, kind):
    c, _ = cell_of(tiny_ppo_root, name)
    assert caught(control_checks(c, kind), sound(tiny_ppo_root, name))


def unchanged(original):
    def fault(self, state, shuffle=None):
        _, metrics = original(self, state, shuffle)
        return state, metrics
    return fault


def half_batch(original):
    def fault(self, params, traj, advantages, targets):
        half = advantages.shape[1] // 2
        return original(self, params, traj.map(lambda x: x[:, :half]),
                        advantages[:, :half], targets[:, :half])
    return fault


def altered(original):
    def fault(self, params, prepped, obs, key):
        action, log_prob, value, key = original(self, params, prepped, obs, key)
        action = action.clone()
        action[0, 0] = (action[0, 0] + 1) % 7
        return action, log_prob, value, key
    return fault


# A half batch is not caught in empty16-ppo, whose one minibatch an update
# gives half and whole batches gradients of about the same norms: one of
# the reasons the PPO cells wait (PERF.md, Open questions).
@pytest.mark.parametrize('name,method,fault', [
    ('bup-ppo', '__call__', unchanged), ('empty16-ppo', '__call__', unchanged),
    ('bup-ppo', 'loss_grads', half_batch),
    ('bup-ppo', 'policy_step', altered), ('empty16-ppo', 'policy_step', altered)])
def test_broken_program_is_caught(tiny_ppo_root, monkeypatch, name, method, fault):
    reference = sound(tiny_ppo_root, name)
    from multigrid_tpu_torch.learn.ppo import TrainStep
    monkeypatch.setattr(TrainStep, method, fault(getattr(TrainStep, method)))
    c, bench = cell_of(tiny_ppo_root, name)
    checks = harness.run_cell(c, bench, root=tiny_ppo_root)['checks']
    assert caught([harness.Check(k, v['value'], v['limit']) for k, v in checks.items()],
                  reference)


def test_made_weights_follow_the_seed():
    from portbench import counting
    from portbench.drivers.ppo import make_params
    net = counting.NetShapes(49, 32, 14)
    a, b = make_params(5, net, 'cpu'), make_params(5, net, 'cpu')
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['img_kernel'], make_params(6, net, 'cpu')['img_kernel'])
    assert a['Dense_0.kernel'].shape == (14, 32) and a['Dense_3.bias'].shape == (1,)
