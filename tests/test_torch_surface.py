"""The last public names of the JAX package, and the two profile modules.

Each name the JAX package exports and the port had lacked (ROADMAP A3) is
held to the JAX package's on the CPU: the reference-parity builder names of
``core``, ``ops.gen_obs_grid`` (bit for bit, on seeded states),
``core.state.is_carrying``, ``envs.roomgrid.opposite`` and the tracing hooks
of ``utils.profiling``. ``python -m multigrid_tpu_torch.profile_env`` and
``profile_train`` run with ``--device cpu`` at 8 envs and 4 steps and print
the JAX scripts' keys (scripts/profile_env.py, scripts/profile_train.py).
"""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import multigrid_tpu.core as jax_core
import multigrid_tpu.ops as jax_ops
from multigrid_tpu.core.state import is_carrying as jax_is_carrying
from multigrid_tpu.envs.roomgrid import opposite as jax_opposite
from multigrid_tpu.utils import profiling as jax_profiling
from multigrid_tpu_torch import core, ops, profile_env, profile_train
from multigrid_tpu_torch.core.state import is_carrying
from multigrid_tpu_torch.envs.roomgrid import opposite
from multigrid_tpu_torch.utils import minigrid_builder, profiling

from .test_torch_states import random_fields, to_jax, to_torch

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(__file__), '..', 'scripts')
BUILDER_NAMES = ['Grid', 'WorldObj', 'Wall', 'Floor', 'Goal', 'Lava', 'Key', 'Ball', 'Box',
                 'Door']


@pytest.mark.parametrize('name', BUILDER_NAMES)
def test_core_resolves_the_builder_names(name):
    """``core.<name>`` is the port's MiniGrid builder class, as the JAX
    package's resolves to its own (multigrid_tpu/core/__init__.py:16-34)."""
    assert name in jax_core.__all__ and name in core.__all__
    assert getattr(core, name) is getattr(minigrid_builder, name)
    assert getattr(core, name).__name__ == getattr(jax_core, name).__name__
    with pytest.raises(AttributeError):
        core.NotAName  # noqa: B018


def test_gen_obs_grid_matches_jax():
    """``ops.gen_obs_grid`` (the sub-grids without the visibility mask) ≡
    the JAX package's, vmapped over envs, bit for bit."""
    assert 'gen_obs_grid' in jax_ops.__all__ and 'gen_obs_grid' in ops.__all__
    fields = random_fields(5, 6, 8, 8, 2)
    want = jax.jit(jax.vmap(lambda s: jax_ops.gen_obs_grid(s, 5)))(to_jax(fields))
    got = ops.gen_obs_grid(to_torch(fields), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_is_carrying_matches_jax():
    fields = random_fields(7, 16, 6, 6, 3)
    want = jax.vmap(jax_is_carrying)(to_jax(fields))
    got = is_carrying(to_torch(fields))
    assert got.dtype == torch.bool and got.any() and not got.all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_opposite_matches_jax():
    assert [opposite(d) for d in range(4)] == [jax_opposite(d) for d in range(4)] == [2, 3, 0, 1]


def test_trace_hooks_write_a_trace(tmp_path):
    """``trace_to`` writes a trace of its block into ``log_dir`` that holds
    the ``trace_annotation`` scopes, as the JAX package's hooks do with
    ``jax.profiler`` (multigrid_tpu/utils/profiling.py:21-31)."""
    assert callable(jax_profiling.trace_annotation) and callable(jax_profiling.trace_to)
    with profiling.trace_to(str(tmp_path)):
        with profiling.trace_annotation('mgt-scope'):
            torch.ones(8).sum()
    traces = list(tmp_path.iterdir())
    assert len(traces) == 1 and traces[0].name.endswith('.pt.trace.json')
    assert 'mgt-scope' in traces[0].read_text()


def _script_keys(name, pattern):
    with open(os.path.join(SCRIPTS, name)) as f:
        return re.findall(pattern, f.read())


def test_profile_env_prints_the_jax_scripts_phases(capsys):
    """Every phase the JAX script emits but its Mosaic ``pad_prologue``, with
    its keys."""
    rows = profile_env.main(['--device', 'cpu', '--env-id', 'MultiGrid-BlockedUnlockPickup-v0',
                             '--agents', '2', '--num-envs', '8', '--steps', '4'])
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == rows
    want = _script_keys('profile_env.py', r"emit\('(\w+)'") + ['reset_core']
    assert [r['phase'] for r in rows] == [p for p in want if p != 'pad_prologue']
    for r in rows[:-1]:
        assert set(r) == {'phase', 'ms_per_step', 'agent_steps_per_sec'}
        assert r['ms_per_step'] > 0
    assert set(rows[-1]) == {'phase', 'us_per_env_reset', 'pool_ms_per_step_at_period',
                             'period'}
    assert rows[-1]['period'] == 128


def test_profile_train_prints_the_jax_scripts_stages(capsys):
    rates = profile_train.main(['--device', 'cpu', '--env-id', 'MultiGrid-Empty-5x5-v0',
                                '--agents', '2', '--num-envs', '8', '--rollout-steps', '4',
                                '--updates-per-call', '1'])
    out = capsys.readouterr().out.splitlines()
    want = _script_keys('profile_train.py', r"emit\('(\w+)'")
    assert list(rates) == want == ['A_env_only', 'B_rollout_policy_nostore',
                                   'C_rollout_stored', 'E_full_train']
    assert [line.split()[0] for line in out[:-1]] == want
    assert json.loads(out[-1]) == {k: round(v) for k, v in rates.items()}
    assert all(v > 0 for v in rates.values())
