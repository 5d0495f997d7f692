"""The ``'model'`` mesh axis on the CPU: the ``(env, model)`` layout of the
JAX dry run, ``Dense_0`` and its Adam moments split by columns, and PPO over
it against one process.

Four spawned gloo processes (a file store in a temporary directory, a join
timeout of 120 s) run every scenario of ``tests/torch_model_axis_worker.py``
once, in one process group:

- a ``(2, 2)`` mesh: its coordinates and process groups against JAX
  ``make_mesh(2, 2)``'s device layout, and 3 PPO updates of the cnn and of
  the mlp held to one process at ``rtol=1e-4, atol=1e-6`` (the JAX gate's
  tolerance, __graft_entry__.py:122-127) with every rollout bit-equal;
- two ``(1, 2)`` meshes side by side (processes 0-1, the cnn; 2-3, the mlp):
  3 updates bit for bit against one process (the parameters after every
  update, every rollout's checksums, every metric), each process holding
  only its columns of the kernel and of both moments, and checkpoints from
  ``(1, 2)`` to one process and from one process to ``(1, 2)``, resumed bit
  for bit.

The names the port splits are held to the names the gate's placement
selects on the JAX package's ``ppo_init`` tree (__graft_entry__.py:85-92).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.envs import make as jax_make
from multigrid_tpu.learn import PPOConfig as JaxPPOConfig
from multigrid_tpu.learn import ppo_init as jax_ppo_init
from multigrid_tpu.parallel import make_mesh as jax_make_mesh
from multigrid_tpu.parallel.vector import VectorEnv as JaxVectorEnv
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import PPOConfig, ppo_init
from multigrid_tpu_torch.parallel import (
    Mesh,
    VectorEnv,
    gather_params,
    make_mesh,
    model_sharded,
    shard_params,
)
from multigrid_tpu_torch.parallel.dryrun import assert_consistent, ppo_run, spawn

from . import torch_model_axis_worker as worker

torch.set_num_threads(1)

TIMEOUT = 120.0


@pytest.fixture(scope='module')
def one_process_checkpoint(tmp_path_factory):
    """A checkpoint of the mlp after 2 updates in one process, and the
    third update from there."""
    path = str(tmp_path_factory.mktemp('one-ck') / 'step_2')
    return path, worker.two_then_save('mlp', path)


@pytest.fixture(scope='module')
def four_procs(tmp_path_factory, one_process_checkpoint):
    """Every scenario on 4 gloo processes: each process's results."""
    ckdir = tmp_path_factory.mktemp('model-axis-ck')
    results = spawn(worker.all_scenarios, 4, (str(ckdir), one_process_checkpoint[0]),
                    device='cpu', timeout=TIMEOUT)
    return results, str(ckdir)


def _jax_layout(n_env, n_model):
    mesh = jax_make_mesh(n_env, n_model, devices=jax.devices()[:n_env * n_model])
    return np.vectorize(lambda d: d.id)(mesh.devices)


def test_grid_layout_is_the_jax_meshs(four_procs):
    """Process r of the (2, 2) mesh sits where JAX's device r does (env-
    major); its env group is its column of the layout, its model group its
    row."""
    ids = _jax_layout(2, 2)
    for rank, res in enumerate(four_procs[0]):
        e, m = (int(i) for i in np.argwhere(ids == rank)[0])
        assert res['coords'] == [e, m]
        assert res['groups'] == {'env': sorted(ids[:, m].tolist()),
                                 'model': sorted(ids[e, :].tolist()), 'mesh': [0, 1, 2, 3]}


def test_pair_meshes_are_model_axes(four_procs):
    """A (1, 2) mesh has no env group: its two processes hold the whole env
    batch and split the kernels between them."""
    for rank, res in enumerate(four_procs[0]):
        pair = worker.PAIRS[rank // 2]
        assert res['pair_coords'] == [0, rank % 2]
        assert res['pair_groups'] == {'env': None, 'model': pair, 'mesh': pair}
        assert res['run']['mesh_shape'] == [1, 2] and res['encoder'] == res['run']['encoder']


@pytest.mark.parametrize('encoder', list(worker.RUNS))
def test_model_axis_run_is_one_process_bit_for_bit(four_procs, encoder):
    """3 updates over (1, 2): every process's gathered parameters after
    every update, every rollout's checksums and every metric equal one
    process's."""
    single = ppo_run(**worker.RUNS[encoder], sharded=False)
    runs = [res['run'] for res in four_procs[0] if res['encoder'] == encoder]
    assert len(runs) == 2
    for run in runs:
        assert run['params_digests'] == single['params_digests']
        assert run['rollouts'] == single['rollouts']
    assert_consistent(runs, single, f'(1, 2) {encoder}', rtol=0.0, atol=0.0)
    assert len(set(single['params_digests'])) == 3


@pytest.mark.parametrize('encoder', list(worker.RUNS))
def test_grid_run_matches_one_process(four_procs, encoder):
    """3 updates over (2, 2) ≡ one process at rtol 1e-4, every rollout
    bit-equal, the parameters equal across the 4 processes."""
    single = ppo_run(**worker.RUNS[encoder], sharded=False)
    runs = [res['grid'][encoder] for res in four_procs[0]]
    assert all(r['mesh_shape'] == [2, 2] and r['process_count'] == 2 for r in runs)
    assert len(single['rollouts']) == 3
    assert_consistent(runs, single, f'(2, 2) {encoder}')


@pytest.mark.parametrize('encoder', list(worker.RUNS))
def test_each_process_holds_its_columns(four_procs, encoder):
    """After an update each process of a (1, 2) mesh holds columns [m·H/2,
    (m+1)·H/2) of Dense_0's kernel and of both its moments, equal to one
    process's; nothing else is split."""
    want = worker.update_once(encoder)
    full = want['part']
    assert sorted(full) == ['mu/Dense_0.kernel', 'nu/Dense_0.kernel', 'params/Dense_0.kernel']
    for res in four_procs[0]:
        if res['encoder'] != encoder:
            continue
        got, m = res['update_once'], res['pair_coords'][1]
        assert got['digest'] == want['digest']
        for k, v in full.items():
            cols = np.asarray(v).shape[1] // 2
            np.testing.assert_array_equal(np.asarray(got['part'][k]),
                                          np.asarray(v)[:, m * cols:(m + 1) * cols], err_msg=k)


def test_checkpoint_from_model_axis_resumes_in_one_process(four_procs):
    """A checkpoint written by a (1, 2) mesh holds the full kernel and
    moments: one process restores it and takes the third update bit for
    bit."""
    results, ckdir = four_procs
    saved = [res['saved'] for res in results if res['encoder'] == 'cnn']
    assert json.dumps(saved[0]) == json.dumps(saved[1])
    assert json.dumps(worker.resume('cnn', f'{ckdir}/pair')) == json.dumps(saved[0])
    assert worker.two_then_save('cnn', f'{ckdir}/one')['digest'] == saved[0]['digest']


def test_checkpoint_from_one_process_resumes_on_model_axis(four_procs, one_process_checkpoint):
    """A one-process checkpoint restores on a (1, 2) mesh, each process
    cutting its columns, and the third update is bit-equal."""
    resumed = [res['resumed'] for res in four_procs[0] if res['encoder'] == 'mlp']
    assert [json.dumps(r) for r in resumed] == [json.dumps(one_process_checkpoint[1])] * 2


def test_shard_and_gather_in_one_process():
    """Without a model axis both are the identity; a (1, 2) mesh's process
    1 keeps the right half of a 2-D Dense_0 kernel only, and refuses a
    width the shards do not divide."""
    params = {'Dense_0.kernel': torch.arange(12.0).reshape(2, 6), 'Dense_0.bias': torch.ones(6),
              'Dense_1.kernel': torch.ones(6, 6), 'critic.Dense_0.kernel': torch.ones(4, 6),
              'Dense_0.kernel3': torch.ones(2, 3, 6)}
    assert shard_params(params, None) is params and gather_params(params, make_mesh()) is params
    part = shard_params(params, Mesh((1, 2), (0, 1), 1))
    assert torch.equal(part['Dense_0.kernel'], params['Dense_0.kernel'][:, 3:])
    assert part['Dense_0.kernel'].is_contiguous()
    assert part['critic.Dense_0.kernel'].shape == (4, 3)
    for k in ('Dense_0.bias', 'Dense_1.kernel', 'Dense_0.kernel3'):
        assert part[k] is params[k]
    with pytest.raises(ValueError, match='not divisible by 4 model shards'):
        shard_params(params, Mesh((1, 4), (0, 1, 2, 3), 0))


def _jax_sharded_names(state) -> set[str]:
    """The leaves the gate's ``place`` puts on ``P(None, 'model')``, named
    ``params/…``, ``mu/…`` or ``nu/…`` and the parameter's dotted path."""
    names = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        name = '/'.join(str(p) for p in path)
        if 'Dense_0' in name and 'kernel' in name and getattr(leaf, 'ndim', 0) == 2:
            keys = [getattr(p, 'key', getattr(p, 'name', None)) for p in path]
            part = next(k for k in keys if k in ('params', 'mu', 'nu'))
            names.add(part + '/' + '.'.join(k for k in keys[keys.index(part) + 1:]
                                            if isinstance(k, str) and k != 'params'))
    return names


@pytest.mark.parametrize('variant', ['cnn', 'mlp', 'critic', 'per-agent'])
def test_sharded_names_are_the_gates(variant):
    """The port splits exactly the parameters and moments that the gate's
    placement selects: Dense_0's kernel (the direction features' layer in
    the cnn and the mlp, the joint one-hot layer in the critic as well);
    none with per-agent policies, whose kernels are 3-D."""
    encoder = 'mlp' if variant == 'mlp' else 'cnn'
    cfg = dict(centralized_critic=variant == 'critic',
               per_agent_policies=variant == 'per-agent', rollout_steps=2)
    jvenv = JaxVectorEnv(jax_make('MultiGrid-Empty-5x5-v0', agents=2), 2,
                         packed_obs=encoder == 'mlp', use_pallas_obs=False)
    jstate, *_ = jax_ppo_init(jvenv, jax.random.key(0), config=JaxPPOConfig(**cfg),
                              net_kwargs=dict(hidden=16, encoder=encoder, dtype=jnp.float32))
    venv = VectorEnv(make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu'), 2,
                     packed_obs=encoder == 'mlp')
    state, *_ = ppo_init(venv, 0, config=PPOConfig(**cfg),
                         net_kwargs=dict(hidden=16, encoder=encoder, dtype=torch.float32))
    ours = {f'{part}/{k}' for part, tree in (('params', state.params), ('mu', state.opt_state.mu),
                                            ('nu', state.opt_state.nu))
            for k, v in tree.items() if model_sharded(k, v)}
    assert ours == _jax_sharded_names(jstate)
    want = {'cnn': {'Dense_0.kernel'}, 'mlp': {'Dense_0.kernel'},
            'critic': {'actor.Dense_0.kernel', 'critic.Dense_0.kernel'}, 'per-agent': set()}
    assert ours == {f'{p}/{k}' for p in ('params', 'mu', 'nu') for k in want[variant]}
