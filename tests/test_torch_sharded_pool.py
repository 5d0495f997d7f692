"""The reserve pool sharded over the env axis, on the CPU: four gloo
processes against one.

The JAX package places its whole state, the reserve pool's extras among
it, on ``P('env')`` (multigrid_tpu/parallel/vector.py:180-183), so each
device holds the slots of its own rows. The port does the same: under a
mesh of ``P`` env shards each process holds ``E/P`` slots and their keys,
and a finished env's slot ``(i + g) mod E`` reaches it through a barrel
shift of packed rows between the shards (``VectorEnv._window``).

Four spawned processes (a file store in a temporary directory, a join
timeout) run every scenario of ``tests/torch_sharded_pool_worker.py`` once,
in one process group: BlockedUnlockPickup and RedBlueDoors batches of 24
envs under ``(4, 1)`` and ``(2, 2)`` meshes, 52 steps (past ``2E``, so the
shift takes every value and the window wraps) with refresh windows across
the shards' boundaries, every step refreshing its slots or one chunked
``refresh_pool`` a chunk; then a BUP checkpoint written at 4 env shards
and restored at 2. Each test holds a scenario to this process's run of it
(held to the JAX package by tests/test_torch_streams.py): every step's
rows, and each process's slots and keys, bit for bit.
"""

import pytest
import torch

from multigrid_tpu_torch.parallel.dryrun import spawn
from multigrid_tpu_torch.utils.checkpoint import restore_checkpoint

from . import torch_sharded_pool_worker as worker

torch.set_num_threads(1)

TIMEOUT = 300.0
ROLLOUTS = [f'{e}x{m}/{case}/{mode}' for e, m in worker.MESHES for case in worker.CASES
            for mode in worker.MODES]


@pytest.fixture(scope='module')
def four_procs(tmp_path_factory):
    """Every scenario on 4 gloo processes: each process's results."""
    ckdir = tmp_path_factory.mktemp('sharded-pool-ck')
    return spawn(worker.all_scenarios, 4, (str(ckdir),), device='cpu', timeout=TIMEOUT)


@pytest.fixture(scope='module')
def one_process(four_procs):
    """This process's run of each case and mode, digested over the rows
    that each of the spawned processes holds under each mesh."""
    out = {}
    for case, kw in worker.CASES.items():
        for mode in worker.MODES:
            names = [n for n in ROLLOUTS if n.endswith(f'/{case}/{mode}')]
            rows = [slice(*res[n]['rows']) for n in names for res in four_procs]
            recs = iter(worker.one_process(**kw, mode=mode, rows=rows))
            for n in names:
                for rank in range(len(four_procs)):
                    out[n, rank] = next(recs)
    return out


@pytest.mark.parametrize('name', ROLLOUTS)
def test_sharded_pool_steps_match_one_process(four_procs, one_process, name):
    """Every step's rows of each process (state, extras, observations,
    rewards, dones) equal those rows of one process's run, and so do its
    slots of the reserve and their keys, across the window's wraps."""
    for rank, res in enumerate(four_procs):
        got, want = res[name], one_process[name, rank]
        bad = [t for t, (a, b) in enumerate(zip(got['steps'], want['steps'])) if a != b]
        assert not bad, f'{name}, process {rank}: rows differ at steps {bad}'
        bad = [t for t, (a, b) in enumerate(zip(got['pool'], want['pool'])) if a != b]
        assert not bad, f'{name}, process {rank}: slots differ at steps {bad}'
        assert got['step'] == want['step'] == list(range(1, worker.STEPS + 1))


@pytest.mark.parametrize('shape', worker.MESHES)
def test_each_process_holds_its_own_slots(four_procs, shape):
    """Under ``P`` env shards a process holds ``E/P`` slots and keys, those
    of its own rows (processes on one env shard hold the same rows), and
    the global step passes ``2E``."""
    e = worker.NUM_ENVS
    per = e // shape[0]
    for rank, res in enumerate(four_procs):
        for case in worker.CASES:
            for mode in worker.MODES:
                rec = res[f'{shape[0]}x{shape[1]}/{case}/{mode}']
                shard = rank // shape[1]
                assert rec['rows'] == [shard * per, (shard + 1) * per]
                assert all(s == [per, per] for s in rec['slots'])
    assert worker.STEPS > 2 * e


def test_checkpoint_from_four_shards_restores_at_two(four_procs):
    """A checkpoint written by 4 env shards holds the global reserve; at 2
    env shards each process takes its 12 slots and keys, equal to those
    rows of the checkpoint restored in one process."""
    path = four_procs[0]['path']
    assert len({res['saved'] for res in four_procs}) == 1
    for rank, res in enumerate(four_procs):
        got = res['restored_2']
        assert got['slots'] == [12, 12] and got['rows'] == [rank // 2 * 12, rank // 2 * 12 + 12]
        venv, state, _ = worker._train_setup(None)
        env = restore_checkpoint(path, state, venv).env_state
        rows = slice(*got['rows'])
        assert got['digest'] == worker.state_digest(env, rows) + worker.pool_digest(env.pool, rows)


def test_checkpoint_from_four_shards_restores_in_one_process(four_procs):
    """The same checkpoint restored in one process is the state the 4
    shards saved, their pools gathered, bit for bit."""
    path = four_procs[0]['path']
    venv, state, _ = worker._train_setup(None)
    env = restore_checkpoint(path, state, venv).env_state
    assert env.pool.reserve.grid.shape[0] == worker.NUM_ENVS
    assert worker.state_digest(env) + worker.pool_digest(env.pool) == four_procs[0]['saved']
