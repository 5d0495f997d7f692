"""End-to-end rates of two checkouts of the port in turns, on one card.

    python3 chip_turns.py TREE_A TREE_B
    python3 chip_turns.py --draws TREE_A TREE_B

runs each checkout in a process of its own, in the order A, B, B, A, and
prints each run's rates as a JSON line, then the ratio B / A by sums. A
run times its checkout by that checkout's own ``chip_smoke.py`` phases (so
two trees whose APIs differ are timed alike): agent-steps/s at the env
flagship (``timing``), the trained flagship (``train_timing``) and the BUP
recipe (``bup_timing``), after the phases that build their states. With
``--draws``, each run's keyed-draw kernels instead: the ms of a launch
alone of each draw that checkout's ``prng_times`` times, and B / A by sums
for the draws both time. Compare two versions only within one call: a
card's clocks differ between calls.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RATES = ('env_agent_steps_per_s', 'trained_agent_steps_per_s',
         'bup_trained_agent_steps_per_s')


def _smoke(tree: str):
    """The checkout's ``chip_smoke`` module, its kernels built."""
    import importlib.util

    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location('tree_chip_smoke',
                                                  os.path.join(tree, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build_kernels()
    return mod


def draws(tree: str) -> dict:
    """The ms of a launch alone of each keyed draw the checkout at ``tree``
    times (its ``prng_times``), in this process."""
    mod = _smoke(tree)
    return {'tree': tree, 'card': mod.smi_line(),
            'ms': {k: v['ms'] for k, v in mod.prng_times('cuda').items()}}


def rates(tree: str) -> dict:
    """The rates of the checkout at ``tree``, timed in this process."""
    mod = _smoke(tree)
    venv, _, state, _, _ = mod.main_path()
    env_rate = mod.timing(venv, state)['rate']
    tvenv, step, tstate, *_ = mod.train_path()
    _, tt = mod.train_timing(tvenv, step, tstate)
    bvenv, bstep, bfused, bstate, *_ = mod.bup_train()
    bt = mod.bup_timing(bvenv, bstep, bfused, bstate)
    return {'tree': tree, 'card': mod.smi_line(), RATES[0]: env_rate,
            RATES[1]: tt['rate'], RATES[2]: bt['rate']}


def main(argv: list[str]) -> None:
    kind = 'draws' if argv[:1] == ['--draws'] else 'rates'
    argv = argv[1:] if kind == 'draws' else argv
    if argv[:1] == ['--one'] and len(argv) == 2:
        print(json.dumps((draws if kind == 'draws' else rates)(os.path.abspath(argv[1]))),
              flush=True)
        return
    if len(argv) != 2:
        sys.exit('usage: chip_turns.py [--draws] TREE_A TREE_B')
    a, b = (os.path.abspath(t) for t in argv)
    runs = []
    for tree in (a, b, b, a):
        lines = subprocess.run([sys.executable, os.path.abspath(__file__)]
                               + (['--draws'] if kind == 'draws' else []) + ['--one', tree],
                               check=True, stdout=subprocess.PIPE,
                               text=True).stdout.strip().splitlines()
        print('\n'.join(lines[:-1]), file=sys.stderr, flush=True)  # the phases' own lines
        runs.append(json.loads(lines[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if kind == 'draws':
        runs = [r['ms'] for r in runs]
        keys = [k for k in runs[0] if k in runs[1]]
    else:
        keys = RATES
    ratio = {k: sum(r[k] for r in runs[1:3]) / (runs[0][k] + runs[3][k]) for k in keys}
    print(json.dumps({'a': a, 'b': b, 'b_over_a_by_sums': ratio}), flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
