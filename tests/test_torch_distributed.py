"""Multi-process execution on the CPU: the env batch sharded over two gloo
processes against the same global batch in one process.

Two spawned processes (a file store in a temporary directory, a join
timeout of 120 s) run every scenario of ``tests/torch_distributed_worker.py``
once, in one process group; each test holds its scenario to this process's
run of it:

- rollouts bit for bit (the counterpart of tests/test_multichip.py:41-56 and
  :59-75): grids, observations, rewards and dones, with actions fixed and
  drawn from a key, on Empty and on BlockedUnlockPickup's reserve
  pool;
- PPO updates at ``rtol=1e-4, atol=1e-6`` (the JAX gate's tolerance,
  __graft_entry__.py:122-127) with the first rollout's integer checksums
  equal and the parameters equal across the processes after every update;
- a checkpoint written by the two processes, restored in one process with
  the global shapes and resumed bit for bit on two.

No JAX train step is compiled: the single-process port is held to the JAX
package by tests/test_torch_ppo.py. ``dryrun_multichip(2)`` and ``(4)``
spawn their own processes; ``train --mesh`` runs here as a world of one.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.parallel import distributed as jax_distributed
from multigrid_tpu_torch import gen_api_docs, probe_random_success
from multigrid_tpu_torch import train as train_cli
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.parallel import (
    Mesh,
    VectorEnv,
    distributed,
    env_rows,
    gather_batch,
    make_mesh,
    shard_batch,
)
from multigrid_tpu_torch.parallel.dryrun import (
    GRADIENT_RTOL,
    assert_consistent,
    dryrun_multichip,
    ppo_run,
    spawn,
)
from multigrid_tpu_torch.utils.checkpoint import restore_checkpoint

from . import torch_distributed_worker as worker

torch.set_num_threads(1)

TIMEOUT = 120.0


@pytest.fixture(scope='module')
def two_procs(tmp_path_factory):
    """Every scenario on 2 gloo processes: each process's results."""
    ckdir = tmp_path_factory.mktemp('sharded-ck')
    return spawn(worker.all_scenarios, 2, (str(ckdir),), device='cpu', timeout=TIMEOUT)


def test_process_summary_has_the_jax_keys():
    want = jax_distributed.process_summary()
    got = distributed.process_summary('cpu')
    assert got.keys() == want.keys()
    assert got == {'process_index': 0, 'process_count': 1, 'local_devices': 1,
                   'global_devices': 1, 'device_kind': 'cpu'}
    for pkg, summary in ((jax_distributed, want), (distributed, got)):
        assert pkg.global_env_batch(16) == 16 * summary['global_devices']
    distributed.initialize(num_processes=1)  # one process: a no-op
    assert not torch.distributed.is_initialized()


def test_sharded_processes_see_their_topology(two_procs):
    for rank, res in enumerate(two_procs):
        assert res['summary'] == {'process_index': rank, 'process_count': 2,
                                  'local_devices': 1, 'global_devices': 2,
                                  'device_kind': 'cpu'}
        assert res['coords'] == [rank, 0]


def test_make_mesh_in_one_process():
    mesh = make_mesh()
    assert mesh.axis_names == ('env', 'model')
    assert mesh.shape == (1, 1) and mesh.coords == (0, 0) and mesh.group is None
    assert make_mesh(1, 1, devices=[0]) == mesh
    assert env_rows(12, mesh) == slice(0, 12)
    assert mesh.model_shards == 1 and mesh.model_group is None and mesh.mesh_group is None
    with pytest.raises(ValueError, match='1 x 2 != 1'):
        make_mesh(1, 2)
    with pytest.raises(ValueError, match='2 x 1 != 1'):
        make_mesh(2)
    with pytest.raises(ValueError, match='not distinct processes'):
        make_mesh(devices=[1])


def test_rows_and_shard_batch_of_a_two_shard_mesh():
    """Process 1 of 2 holds rows 6..12 of 12, of the state and of its
    reserve pool (the slots and their keys; the global step whole, as the
    JAX package places its pool on ``P('env')``); the env shards must
    divide the batch (vector.py:121-131)."""
    mesh = Mesh((2, 1), (0, 1), 1)
    assert env_rows(12, mesh) == slice(6, 12)
    with pytest.raises(ValueError, match='not divisible by 2 mesh shards'):
        env_rows(13, mesh)
    x = torch.arange(24).reshape(12, 2)
    assert torch.equal(shard_batch({'x': [x]}, mesh)['x'][0], x[6:])
    venv = VectorEnv(make('MultiGrid-BlockedUnlockPickup-v0', agents=2, device='cpu'), 12)
    _, state = venv.reset(seed=0)
    part = shard_batch(state, mesh)
    assert torch.equal(part.grid, state.grid[6:]) and part.pool.step is state.pool.step
    assert torch.equal(part.pool.reserve.grid, state.pool.reserve.grid[6:])
    assert torch.equal(part.pool.reserve.extras['mission_color'],
                       state.pool.reserve.extras['mission_color'][6:])
    assert torch.equal(part.pool.keys, state.pool.keys[6:])
    assert torch.equal(part.extras['mission_color'], state.extras['mission_color'][6:])
    assert gather_batch(x, make_mesh()) is x
    with pytest.raises(ValueError, match='not divisible by 2 mesh shards'):
        VectorEnv(make('MultiGrid-Empty-5x5-v0', device='cpu'), 13, mesh=mesh)


def test_one_shard_mesh_is_the_unsharded_env():
    env = make('MultiGrid-Empty-8x8-v0', agents=2, device='cpu')
    want = worker.rollout(**worker.ROLLOUTS['empty-drawn'])
    got = worker.rollout(**worker.ROLLOUTS['empty-drawn'], mesh=make_mesh())
    assert got == want
    venv = VectorEnv.sharded(env, 8)
    assert venv.mesh.shape == (1, 1) and venv.local_envs == venv.num_envs == 8


@pytest.mark.parametrize('name', list(worker.ROLLOUTS))
def test_sharded_rollout_matches_one_process(two_procs, name):
    """2 processes give one process's global grids, observations, rewards
    and dones at every step, bit for bit, and its random rollout's summary
    (the reward sum added in another order)."""
    want = worker.rollout(**worker.ROLLOUTS[name])
    for res in two_procs:
        got = res['rollouts'][name]
        for k in ('grid', 'image', 'reward', 'done'):
            assert len(got[k]) == len(want[k])
            for t, (a, b) in enumerate(zip(got[k], want[k])):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f'{name}: {k} at step {t}')
        assert got['final_grid'] == want['final_grid']
        assert got['pool_step'] == want['pool_step']
        for k in ('episodes', 'obs_sum'):
            assert got['summary'][k] == want['summary'][k], k
        np.testing.assert_allclose(got['summary']['reward_sum'], want['summary']['reward_sum'],
                                   rtol=1e-6)
    if name.startswith('bup'):
        assert want['pool_step'] == 12 and any(any(d) for d in want['done'])


@pytest.mark.parametrize('name', list(worker.TRAIN_RUNS))
def test_sharded_train_step_matches_one_process(two_procs, name):
    """2 processes' PPO updates ≡ one process's on the global batch: the
    first rollout bit-equal, metrics at rtol 1e-4, parameters equal across
    the processes after every update."""
    single = ppo_run(**worker.TRAIN_RUNS[name], sharded=False)
    sharded = [res['train'][name] for res in two_procs]
    assert_consistent(sharded, single, name)
    assert all(r['process_count'] == 2 for r in sharded) and single['process_count'] == 1
    assert single['params_digests'][0] != single['params_digests'][1]


def test_sharded_checkpoint_restores_anywhere(two_procs):
    """A checkpoint written by 2 processes holds the global state: one
    process restores it with the global shapes and takes the third update
    (rtol 1e-4 of the sharded one); on 2 processes it resumes bit for bit."""
    ck = two_procs[0]['checkpoint']
    assert json.dumps(two_procs[1]['checkpoint']) == json.dumps(ck)
    assert json.dumps(ck['resumed']) == json.dumps(ck['straight'])
    assert ck['digests'][0] == ck['digests'][1]
    one = worker.third_update_from(ck['path'])
    assert one['shapes'] == {'grid': [16, 5, 5, 3], 'image': [16, 2, 49],
                             'ep_return_acc': [16]}
    for k, v in ck['straight'].items():
        np.testing.assert_allclose(one['metrics'][k], v, rtol=1e-4, atol=1e-6,
                                   equal_nan=True, err_msg=k)


def test_sharded_restore_checks_the_global_batch(two_procs, tmp_path):
    """A checkpoint of 16 envs does not restore into a mesh's 12."""
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'), 12,
                     packed_obs=True, mesh=Mesh((2, 1), (0, 1), 0))
    from multigrid_tpu_torch.learn import PPOConfig, ppo_init
    state, *_ = ppo_init(venv, 3, config=PPOConfig(rollout_steps=2), hidden=32,
                         net_kwargs=dict(encoder='mlp'))
    with pytest.raises(ValueError, match='checkpoint/env-config mismatch'):
        restore_checkpoint(two_procs[0]['checkpoint']['path'], state, venv)


def test_train_cli_mesh_is_a_world_of_one(tmp_path, capsys):
    """``--mesh`` without a launcher trains as one process and writes its
    checkpoint, which restores."""
    ck = tmp_path / 'ck'
    train_cli.main(['--device', 'cpu', '--mesh', '--env', 'MultiGrid-Empty-5x5-v0',
                    '--num-agents', '2', '--num-envs', '8', '--rollout-steps', '2',
                    '--num-timesteps', '64', '--encoder', 'mlp', '--hidden', '32',
                    '--save-dir', str(ck), '--save-interval', '1', '--log-interval', '1'])
    out = capsys.readouterr().out
    rows = [json.loads(line) for line in out.splitlines() if line.startswith('{')]
    assert [r['update'] for r in rows] == [1, 2]
    assert (ck / 'step_2').exists()
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_on_two_processes():
    """The JAX gate's topology and net (__graft_entry__.py:104-127): two
    processes make a (1, 2) mesh and train the default cnn on images."""
    sharded, single = dryrun_multichip(2, device='cpu', num_envs_per_proc=16,
                                       timeout=TIMEOUT)
    assert len(sharded) == 2 and len(single['metrics']) == 3
    assert sharded[0]['agent_steps'] == 3 * 2 * 32 * 4
    assert [r['mesh_shape'] for r in sharded] == [[1, 2], [1, 2]]
    assert {r['encoder'] for r in sharded} == {single['encoder']} == {'cnn'}
    # One env shard: the same gradients, so the same parameters bit for bit.
    assert single['gradient_error'] == [0.0, 0.0, 0.0]
    assert single['params_digests'] == sharded[0]['params_digests']


def test_dryrun_multichip_on_four_processes():
    """The JAX gate on a (2, 2) mesh: every rollout bit-equal to one
    process that starts each update from the sharded run's parameters, the
    metrics at rtol 1e-4 and Adam's moments within ``GRADIENT_RTOL``."""
    sharded, single = dryrun_multichip(4, device='cpu', num_envs_per_proc=16,
                                       timeout=TIMEOUT)
    assert [r['mesh_shape'] for r in sharded] == [[2, 2]] * 4
    assert sharded[0]['rollouts'] == single['rollouts'] and len(single['rollouts']) == 3
    assert max(single['gradient_error']) < GRADIENT_RTOL


def test_probe_classification_is_the_jax_scripts():
    """The probe's classification ≡ scripts/probe_random_success.py:43-45
    on the same arrays."""
    rng = np.random.default_rng(4)
    e, n = 512, 3
    done, success = rng.random(e) < 0.5, rng.random(e) < 0.3
    term, trunc = rng.random((e, n)) < 0.6, rng.random((e, n)) < 0.2
    jd, js, jt, jr = map(jnp.asarray, (done, success, term, trunc))
    win = jd & js
    tr = jnp.any(jr, axis=-1) & ~jnp.all(jt, axis=-1)
    want = [int(win.sum()), int((jd & ~win & ~tr).sum()), int((jd & tr).sum())]
    got = probe_random_success.classify(*map(torch.as_tensor, (done, success, term, trunc)))
    assert [int(x) for x in got] == want


def test_probe_runs_at_a_tiny_size():
    row = probe_random_success.probe('MultiGrid-RedBlueDoors-6x6-v0', 2, 16, 40, 0, 'cpu')
    assert row['episodes'] == row['successes'] + row['failures'] + row['truncations'] > 0
    assert row['success_rate'] == row['successes'] / row['episodes']


def test_gen_api_docs_writes_the_ports_pages(tmp_path):
    assert gen_api_docs.main([str(tmp_path)]) == 0
    index = (tmp_path / 'README.md').read_text()
    for m in ('parallel.mesh', 'parallel.distributed', 'parallel.dryrun'):
        assert f'multigrid_tpu_torch.{m}' in index
        assert (tmp_path / f'multigrid_tpu_torch_{m.replace(".", "_")}.md').exists()
    assert gen_api_docs.main([str(tmp_path), '--check']) == 0
    (tmp_path / 'README.md').write_text('stale')
    assert gen_api_docs.main([str(tmp_path), '--check']) == 1
    with pytest.raises(SystemExit):
        gen_api_docs.main([str(gen_api_docs.JAX_DOCS)])


def test_spawn_fails_when_a_process_fails_or_hangs():
    """A process that raises fails the run at once (the one waiting for it
    in a collective fails too, or is killed), long before the timeout; one
    still running at the timeout is killed and fails it."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match='fail_on_process_1 on 2 processes failed: exit codes'):
        spawn(worker.fail_on_process_1, 2, device='cpu', timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2
    with pytest.raises(RuntimeError, match=r'ranks \[0\] still running after 3'):
        spawn(worker.hang, 1, device='cpu', timeout=3.0)
