"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
at a size the CPU steps in seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: The CPU's sizes: a handful of envs, episodes that end within a few calls
#: (a few updates), 8 steps a call or a rollout.
TINY = {'num_envs': 8, 'max_steps': 20}
TINY_STEPS = 8


def tiny_copy(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``portbench/`` copied to ``dest``, every
    configuration cut to :data:`TINY` and every traffic to
    :data:`TINY_STEPS` steps a call or a rollout."""
    shutil.copy(ROOT / 'BENCHMARK.json', dest / 'BENCHMARK.json')
    shutil.copytree(ROOT / 'portbench', dest / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    for f in (dest / 'portbench' / 'configs').glob('*.json'):
        f.write_text(json.dumps({**json.loads(f.read_text()), **TINY}))
    for f in (dest / 'portbench' / 'traffic').glob('*.json'):
        traffic = json.loads(f.read_text())
        cut = 'rollout_steps' if traffic['driver'] == 'ppo' else 'steps_per_call'
        f.write_text(json.dumps({**traffic, cut: TINY_STEPS}))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_copy(tmp_path)


#: The PPO cells that ``BENCHMARK.json`` does not hold yet (PERF.md, Open
#: questions), for the tests of their driver and comparison.
PPO_CELLS = [
    {'name': 'bup-ppo', 'config': 'bup-n2-e4096', 'traffic': 'ppo-t128-e2-m4', 'chips': 1,
     'why': 'PPO updates back to back'},
    {'name': 'empty16-ppo', 'config': 'empty16x16-n4-e4096', 'traffic': 'ppo-t16-e1-m1',
     'chips': 1, 'why': 'PPO updates back to back'},
]


@pytest.fixture
def tiny_ppo_root(tmp_path):
    root = tiny_copy(tmp_path)
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['workloads'] += PPO_CELLS
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return root
