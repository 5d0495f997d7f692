"""The control of a cell's comparison, and the faults it must catch: the
plain reference with one guarantee or one precision broken, put in the
program's place.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--kind <kind>]

It runs what a run of the cell runs, at the cell's size and with its keys
and weights, through the broken reference, and prints the numbers the
run's comparison gives them, each beside its limit: the control, and
each fault, has to fail at least one. The benchmark's own runs never run
it.

- env cells (``random_rollout``), ``--kind control``: every observation
  sees through walls (the configuration states occlusion). It runs the
  reset, the warm-up call and the window's calls up to the first in which
  the envs reach ``max_steps``, which it takes as the sampled call.
- PPO cells (``ppo``), the first ``check_updates`` updates from the seed:
  ``control``, every product's operands rounded through float8 e4m3 (the
  configuration states bfloat16); ``half``, each minibatch's loss over
  its first half of envs alone, the mean taken over them; ``altered``,
  the action of the first agent of the first env changed at every
  rollout step, where it is made.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import counting, envcheck, harness, ppocheck  # noqa: E402
from portbench.drivers.ppo import make_params  # noqa: E402
from portbench.drivers.random_rollout import MAX_CALLS  # noqa: E402
from portbench.reference.learner import Learner  # noqa: E402
from portbench.reference.utils import prng  # noqa: E402


def env_control_checks(cell: harness.Cell) -> list:
    """An env cell's checks with the broken reference as the program."""
    cfg, steps = cell.config, cell.traffic['steps_per_call']
    broken = envcheck.reference_env(cfg, cell.device, break_guarantee='occlusion')
    reset_key, call_keys = envcheck.keys_of(cell.seed, MAX_CALLS + 1)
    call_keys = call_keys.to(cell.device)
    reset_obs, reset_state = broken.reset(reset_key.to(cell.device))
    state, _ = broken.rollout_random(reset_state, call_keys[MAX_CALLS], steps)
    call = 0
    while True:
        first = (call + 1) * steps
        before = state
        state, summary = broken.rollout_random(state, call_keys[call], steps)
        if (first + steps) // cfg['max_steps'] > first // cfg['max_steps']:
            break
        call += 1
    sample = envcheck.Sample(before, call_keys[call], state, summary)
    return envcheck.compare(envcheck.reference_env(cfg, cell.device), reset_key, reset_obs,
                            reset_state, sample, steps)


class HalfBatch(Learner):
    def loss(self, params, traj, adv, targets):
        half = adv.shape[1] // 2
        return super().loss(params, {k: None if v is None else v[:, :half]
                                     for k, v in traj.items()},
                            adv[:, :half], targets[:, :half])


class Altered(Learner):
    def sample(self, logits, gumbel):
        action = super().sample(logits, gumbel).clone()
        action[0, 0] = (action[0, 0] + 1) % 7
        return action


def _as_program(s):
    """A reference train state read as the program's is read."""
    return types.SimpleNamespace(
        params=s.params, env_state=s.env_state, last_obs=s.last_obs, key=s.key,
        opt_state=types.SimpleNamespace(mu=s.mu, nu=s.nu, count=s.count))


def ppo_control_checks(cell: harness.Cell, kind: str = 'control') -> list:
    """A PPO cell's checks with the broken reference as the program."""
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    vs = cfg['agent_view_size']
    net = counting.NetShapes(vs * vs, cfg['net']['hidden'], 2 + cfg['net'].get('missions', 0))
    params = make_params(cell.seed, net, dev)
    key = prng.key(cell.seed).to(dev)
    base = ppocheck.reference_learner(cfg, tr, dev, lowp=kind == 'control')
    cls = {'control': Learner, 'half': HalfBatch, 'altered': Altered}[kind]
    broken = cls(base.venv, base.net, base.cfg)
    s = broken.init(params, key)
    states, losses = [_as_program(s)], []
    for _ in range(tr['check_updates']):
        s, (loss, _), _ = broken.update(s)
        states.append(_as_program(s))
        losses.append(float(loss))
    return ppocheck.compare(ppocheck.reference_learner(cfg, tr, dev), params, key, states,
                            losses)


def control_checks(cell: harness.Cell, kind: str = 'control') -> list:
    if cell.traffic['driver'] == 'ppo':
        return ppo_control_checks(cell, kind)
    if kind != 'control':
        raise ValueError(f'an env cell has no fault {kind!r} here')
    return env_control_checks(cell)


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--kind', default='control', choices=('control', 'half', 'altered'))
    args = p.parse_args(argv)
    for seed in args.seeds:
        cell, _ = harness.resolve(args.workload, seed, 0.0, False, 'cuda', 0.0)
        checks = control_checks(cell, args.kind)
        print(json.dumps({'workload': cell.name, 'seed': seed, 'kind': args.kind,
                          'correct': all(c.ok for c in checks),
                          'checks': {c.name: {'value': c.value, 'limit': c.limit}
                                     for c in checks}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
