"""Whole runs of the env cells on the CPU at a tiny size: the sound
program reads correct; the control and the program with its timed path
broken read not correct; what a run loads; how it fails without a card."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.control import control_checks

from .conftest import ROOT

CELLS = ['empty16-random', 'bup-random']


def run(root, cell, seed=2**31 + 99, seconds=1.0):
    c, bench = harness.resolve(cell, seed, seconds, False, 'cpu', 0.0, root=root)
    return harness.run_cell(c, bench, root=root)


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    result = run(tiny_root, cell)
    assert result['correct'], result['checks']
    assert result['attempted'] >= 3
    assert list(result)[-1] == 'checks'
    assert set(result['metrics']) == {'setup_s', 'env_agent_steps_per_s', 'peak_mem_gib'}


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(tiny_root, cell):
    c, _ = harness.resolve(cell, 2**31 + 7, 0.0, False, 'cpu', 0.0, root=tiny_root)
    checks = control_checks(c)
    assert not all(ch.ok for ch in checks)


def unchanged(original):
    """A rollout that returns the state it was given."""
    def fault(self, state, key, steps):
        _, summary = original(self, state, key, steps)
        return state, summary
    return fault


def half_batch(original):
    """A rollout that steps only the first half of the envs."""
    def fault(self, state, key, steps):
        new, summary = original(self, state, key, steps)
        half = state.grid.shape[0] // 2
        fields = {f: torch.cat([getattr(new, f)[:half], getattr(state, f)[half:]])
                  for f in ('grid', 'agent_pos', 'agent_dir', 'agent_terminated',
                            'step_count', 'rng')}
        return new.replace(**fields), summary
    return fault


def altered(original):
    """A rollout whose answer is altered where it is made: one env's agent
    turned."""
    def fault(self, state, key, steps):
        new, summary = original(self, state, key, steps)
        return new.replace(agent_dir=(new.agent_dir + (torch.arange(
            new.agent_dir.numel()).reshape(new.agent_dir.shape) == 0)) % 4), summary
    return fault


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('fault', [unchanged, half_batch, altered])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    from multigrid_tpu_torch import VectorEnv
    monkeypatch.setattr(VectorEnv, 'rollout_random', fault(VectorEnv.rollout_random))
    result = run(tiny_root, cell)
    assert not result['correct'], result['checks']


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'multigrid_tpu_torch_extra', sys)
    assert 'multigrid_tpu' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'multigrid_tpu.envs', sys)
    assert 'multigrid_tpu' in harness.forbidden_modules()


def test_a_run_loads_no_jax(tiny_root):
    code = (f'import sys; sys.path.insert(0, {str(ROOT)!r}); from pathlib import Path; '
            'from portbench import harness; '
            f'c, b = harness.resolve("bup-random", 5, 0.5, False, "cpu", 0.0, root=Path({str(tiny_root)!r})); '
            f'harness.run_cell(c, b, root=Path({str(tiny_root)!r})); '
            'print(harness.forbidden_modules())')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         check=True, env={'PATH': '/usr/bin:/bin', 'USE_FLAX': '0'})
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_the_reference_imports_nothing_of_the_program():
    code = (f'import sys; sys.path.insert(0, {str(ROOT)!r}); '
            'import portbench.envcheck, portbench.control, portbench.counting, portbench.tracing; '
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"multigrid_tpu_torch", "multigrid_tpu", "jax", "jaxlib", "flax"}))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == '[]'


def test_without_a_card_a_run_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    out = subprocess.run([sys.executable, str(ROOT / 'portbench' / 'run.py'), '--workload',
                          'empty16-random', '--seed', '1', '--seconds', '1', '--trace', '0'],
                         capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ''
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout or 'x')
