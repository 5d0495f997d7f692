"""The last compiled programs of the JAX package as CUDA graphs, shown on
the CPU: the sharded loops under a process mesh and the CLIs' scans.

On the card a mesh over NCCL replays graphs that hold its collectives, and
a mesh over gloo (whose collectives run on the host) runs eagerly by rule
(``Mesh.capturable``). Here, over two spawned gloo processes (one spawn for
the file, ``tests/torch_mesh_graphs_worker.py``, with a join timeout):

- ``graphed()`` follows the backend, with graphs forced on;
- the one-buffer gather (``all_gather_into_tensor`` and a permute on the
  device) equals gloo's list gather along every dim;
- the mesh-key check raises on every process when their keys differ, and
  passes on the keys that the sharded step, rollout and update make;
- the bodies of the sharded update (env axis, per agent, model axis) and
  of the sharded random rollout read nothing on the host and issue the same
  operations, their collectives among them, at every call: what a capture
  needs (``tests/torch_capture.py``).

The sharded runs against one process are ``tests/test_torch_distributed.py``
and ``tests/test_torch_model_axis.py``, whose gathers take the one-buffer
form. A world of one has real groups and equals one process bit for bit.
``evaluate``'s scan step and the probe's are what the card
captures; both CLIs give the results of their eager loops as they were. No
JAX function is compiled here.
"""

import json

import pytest
import torch
import torch.distributed as dist

from multigrid_tpu_torch import evaluate as evaluate_cli
from multigrid_tpu_torch import probe_random_success
from multigrid_tpu_torch.core.actions import NUM_ACTIONS
from multigrid_tpu_torch.envs import make
from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
from multigrid_tpu_torch.learn.ppo import sample_actions
from multigrid_tpu_torch.parallel import VectorEnv, distributed, make_mesh
from multigrid_tpu_torch.parallel.dryrun import assert_consistent, ppo_run, spawn
from multigrid_tpu_torch.utils import graphs
from multigrid_tpu_torch.utils.checkpoint import restore_params, save_checkpoint
from multigrid_tpu_torch.utils import prng

from . import torch_capture
from . import torch_mesh_graphs_worker as worker

torch.set_num_threads(1)

TIMEOUT = 120.0
BUP = 'MultiGrid-BlockedUnlockPickup-v0'


@pytest.fixture(scope='module')
def two_procs():
    """Every check on 2 gloo processes: each process's results."""
    return spawn(worker.all_checks, 2, device='cpu', timeout=TIMEOUT)


def test_gloo_mesh_runs_eagerly_by_rule(two_procs):
    """With graphs on, a VectorEnv over a gloo mesh does not replay (its
    collectives run on the host) and one without a mesh does."""
    for res in two_procs:
        assert res['backend_rule'] == {'capturable': [True, False], 'mesh_capturable': False,
                                       'graphed': [False, True]}


def test_graphed_is_off_on_the_cpu_under_a_mesh():
    """On the CPU nothing replays, with a mesh or without; a mesh with no
    process group has no collective, so a graph could hold it."""
    mesh = make_mesh()
    assert mesh.group is None and mesh.capturable
    env = make('MultiGrid-Empty-5x5-v0', agents=2, device='cpu')
    assert not VectorEnv(env, 4, mesh=mesh).graphed() and not VectorEnv(env, 4).graphed()


def test_one_buffer_gather_is_the_list_gather(two_procs):
    """``all_gather_rows`` through one buffer and a permute on the device
    ≡ gloo's list of parts concatenated, along each dim, for float32,
    bfloat16, int32, uint8 and bool, and for a strided part."""
    for res in two_procs:
        assert len(res['gathers']) == 5 * 4 + 1
        assert all(res['gathers'].values()), res['gathers']


def test_mesh_key_check_raises_on_a_mismatch(two_procs):
    """Processes about to capture graphs of different keys raise before the
    warm-up's collectives; devices count by type, as each process holds its
    own card."""
    for rank, res in enumerate(two_procs):
        assert res['keys']['mismatch'].startswith(f'process {rank} captures a graph'), res
    a = graphs.key_digest(('step', ((4,), torch.int32, torch.device('cuda', 0))))
    assert a == graphs.key_digest(('step', ((4,), torch.int32, torch.device('cuda', 1))))
    assert a != graphs.key_digest(('step', ((5,), torch.int32, torch.device('cuda', 0))))
    assert 0 <= a < 2**63
    graphs.check_key(('step', 0), None, 'cpu')  # no group: nothing to compare


def test_real_graph_keys_agree_over_the_group(two_procs):
    """The keys that ``TrainStep.run``, ``rollout_random`` (chunk and one
    step) and ``VectorEnv.step`` check over a 2-process mesh before their
    captures pass the check on both processes, and are alike."""
    keys = [res['real_keys']['digests'] for res in two_procs]
    assert len(keys[0]) == 4 and len(set(keys[0])) == 4, keys
    assert keys[0] == keys[1]


#: The collectives of each sharded update: the env axis's all-reduces and
#: the batch's gather; the model axis's column gathers.
UPDATE_COLLECTIVES = {
    'env-axis': ['c10d._allgather_base_.default', 'c10d.allreduce_.default'],
    'env-axis-per-agent': ['c10d._allgather_base_.default', 'c10d.allreduce_.default'],
    'model-axis': ['c10d._allgather_base_.default'],
}


@pytest.mark.parametrize('name', list(worker.UPDATES))
def test_sharded_update_body_is_capturable(two_procs, name):
    """The sharded PPO update (``TrainStep.update``, the update graph's
    body) with its all-reduces and one-buffer gathers inside: no host read,
    the same operations at every call."""
    for res in two_procs:
        report = res['updates'][name]
        assert report['ops'] and report['same'] and not report['host_reads'], report
        assert report['collectives'] == UPDATE_COLLECTIVES[name], report


def test_sharded_rollout_chunk_body_is_capturable(two_procs):
    """BUP's chunk of 16 steps and its refresh on a replicated reserve pool
    under a 2-process mesh (each process's rows of the global draws)."""
    for res in two_procs:
        report = res['rollout']
        assert report['ops'] and report['same'] and not report['host_reads'], report


def test_world_of_one_has_real_groups_and_is_one_process(tmp_path):
    """A world of one (as ``torchrun --nproc-per-node 1`` starts) gives its
    mesh the world's group, so its collectives are real calls; its
    updates equal one process's bit for bit."""
    kw = dict(num_envs=8, updates=2, env_id='MultiGrid-Empty-5x5-v0', agents=2, hidden=32,
              float32=True, config=dict(rollout_steps=2), device='cpu')
    distributed.join(f'file://{tmp_path / "store"}', 1, 0, device='cpu')
    try:
        mesh = make_mesh()
        assert mesh.group is mesh.model_group is mesh.mesh_group is dist.group.WORLD
        assert not mesh.capturable  # gloo
        sharded = ppo_run(**kw)
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()
    assert_consistent([sharded], ppo_run(**kw, sharded=False), 'world of one', rtol=0, atol=0)


# --------------------------------------------------------------- the CLIs' scans

def _checkpoint(tmp_path):
    venv = VectorEnv(make(BUP, agents=2, max_steps=20, device='cpu'), 8, packed_obs=True)
    state, *_ = ppo_init(venv, 7, hidden=16, net_kwargs=dict(encoder='mlp'))
    return save_checkpoint(str(tmp_path / 'step_1'), state, venv)


@pytest.fixture
def short_iterations(monkeypatch):
    """Iterations of 16 steps in place of 256 (the body is the same at
    every step), so that the CPU runs few."""
    monkeypatch.setattr(evaluate_cli, 'STEPS_PER_ITER', 16)


def _eval_args(path, iterations=2):
    return ['--device', 'cpu', '--env', BUP, '--num-envs', '8', '--num-steps',
            str(iterations * evaluate_cli.STEPS_PER_ITER * 8 * 2), '--hidden', '16',
            '--encoder', 'mlp', '--checkpoint', path, '--env-config', '{"max_steps": 20}']


def test_evaluate_gives_its_eager_loops_results(tmp_path, capsys, short_iterations):
    """``evaluate`` (BUP on the reserve pool, 2 iterations) ≡ its loop as
    it ran before its steps became a graph's body: each iteration's key,
    each step's split of it, actor, Gumbel draw, step and sums, then the
    pool's refresh (scripts/evaluate.py:111-148's key chain)."""
    path = _checkpoint(tmp_path)
    got = evaluate_cli.main(_eval_args(path))
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got

    args = evaluate_cli.parse_args(_eval_args(path))
    venv = VectorEnv(make(BUP, agents=2, device='cpu', max_steps=20), 8, packed_obs=True)
    tmp, net, config, tx = ppo_init(venv, args.seed, config=PPOConfig(),
                                    net_kwargs=dict(hidden=16, encoder='mlp'))
    params = restore_params(path, tmp.params)
    step = make_train_step(venv, net, config, tx)
    key, rk = prng.split(prng.key(args.seed + 1)).unbind(0)
    _, state = venv.reset(rk)
    total = [0.0, 0.0, 0.0]
    for _ in range(2):
        key, k = prng.split(key).unbind(0)
        obs = venv.observe(state)
        ep_acc, acc = torch.zeros(8), [torch.zeros((), dtype=torch.int64),
                                       torch.zeros((), dtype=torch.int64), torch.zeros(())]
        for _ in range(evaluate_cli.STEPS_PER_ITER):
            k, ka = prng.split(k).unbind(0)
            logits, _ = step.actor(params, obs['image'], obs['direction'], obs.get('mission'))
            action = sample_actions(logits, prng.gumbel(ka, logits.shape))
            obs, state, rew, _, _, done, success = venv.step(state, action, refresh=False)
            ep_acc = ep_acc + rew.sum(-1)
            acc[0] += done.sum()
            acc[1] += (done & success).sum()
            acc[2] += torch.where(done, ep_acc, 0.0).sum()
            ep_acc = torch.where(done, 0.0, ep_acc)
        state = venv.refresh_pool(state, evaluate_cli.STEPS_PER_ITER)
        total = [t + float(a) for t, a in zip(total, acc)]
    assert total[0] > 0
    want = {'checkpoint': path, 'agent_steps': 2 * 16 * 8 * 2, 'episodes': int(total[0]),
            'success_rate_exact': round(total[1] / max(total[0], 1), 5),
            'mean_episode_return': round(total[2] / max(total[0], 1), 4)}
    assert {k: v for k, v in got.items() if k != 'eval_agent_steps_per_sec'} == want


def test_probe_gives_its_eager_loops_results():
    """``probe`` (RedBlueDoors-6x6 on the reserve pool, 40 steps) ≡ its
    loop as it ran before its step became a graph's body."""
    got = probe_random_success.probe('MultiGrid-RedBlueDoors-6x6-v0', 2, 16, 40, 3, 'cpu')
    venv = VectorEnv(make('MultiGrid-RedBlueDoors-6x6-v0', agents=2, device='cpu'), 16)
    rk, key = prng.split(prng.key(3)).unbind(0)
    _, state = venv.reset(rk)
    counts = torch.zeros(3, dtype=torch.int64)
    for _ in range(40):
        key, ak = prng.split(key).unbind(0)
        actions = prng.randint(ak, (16, 2), 0, NUM_ACTIONS)
        _, state, _, term, trunc, done, success = venv.step(state, actions)
        counts += torch.stack(probe_random_success.classify(done, success, term, trunc))
    succ, fail, trunc_n = counts.tolist()
    assert succ + fail + trunc_n > 0
    assert got == {'env': 'MultiGrid-RedBlueDoors-6x6-v0', 'agents': 2,
                   'episodes': succ + fail + trunc_n, 'successes': succ, 'failures': fail,
                   'truncations': trunc_n, 'success_rate': succ / (succ + fail + trunc_n)}


def test_evaluate_iteration_and_probe_step_are_capturable(tmp_path, short_iterations):
    """The bodies the card captures: ``evaluate``'s scan step (the policy's
    step on BUP's pool) and the probe's (BUP on the pool)."""
    path = _checkpoint(tmp_path)
    venv = VectorEnv(make(BUP, agents=2, device='cpu', max_steps=20), 8, packed_obs=True)
    tmp, net, config, tx = ppo_init(venv, 0, hidden=16, net_kwargs=dict(encoder='mlp'))
    step = make_train_step(venv, net, config, tx)
    params = restore_params(path, tmp.params)
    run = torch_capture.chain(lambda c: evaluate_cli.scan_step(step, params, c),
                              evaluate_cli.start(venv, tmp.env_state, prng.key(1)))
    torch_capture.assert_capturable(torch_capture.record(run), 'evaluate step')
    probe_venv = VectorEnv(make(BUP, agents=2, device='cpu', max_steps=6), 8)
    carry = (probe_venv.reset(seed=0)[1], prng.key(2), torch.zeros(3, dtype=torch.int64))
    body = torch_capture.chain(lambda c: probe_random_success.scan_step(probe_venv, c), carry)
    torch_capture.assert_capturable(torch_capture.record(body), 'probe step')
