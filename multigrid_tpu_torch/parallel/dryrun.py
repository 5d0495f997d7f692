"""The sharding correctness gate: PPO sharded over processes against one.

Counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``
(:104-127), at its topology and net: :func:`dryrun_multichip` runs 3 PPO
updates (T 2) of the default ``ActorCritic`` (the cnn on ``(vs, vs, 3)``
images) on the flagship (Empty-16x16, 4 agents, 128 envs a process) over an
``(n/2, 2)`` mesh where ``n`` is even (``(n, 1)`` where odd): the env batch
sharded over ``'env'``, the ``Dense_0`` kernel and its Adam moments split
by columns over ``'model'``. It then runs the same global batch in this
process alone, and asserts that every metric agrees (``rtol=1e-4,
atol=1e-6``, as the JAX gate does) and that every update's rollout is
bit-equal in its integer checksums. A dropped all-reduce, a mis-split
batch, a stale shard or a wrong column changes the numbers; the absence of
a crash alone would not catch it.

    python -m multigrid_tpu_torch.parallel.dryrun 2              # on the card
    python -m multigrid_tpu_torch.parallel.dryrun 2 --device cpu  # gloo

The processes are spawned here (:func:`spawn`) and meet through a file
store in a temporary directory, never a TCP port. Each has a join timeout:
a process that fails or hangs fails the run. NCCL refuses two processes on
one card, so two processes sharing a card take ``backend='gloo'``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import multiprocessing as mp
import os
import sys
import tempfile
import time
from collections.abc import Callable
from multiprocessing.connection import wait

import numpy as np
import torch

from ..utils.device import resolve_device
from . import distributed

FLAGSHIP = 'MultiGrid-Empty-16x16-v0'
#: Seconds a spawned run may take, start to join.
JOIN_TIMEOUT = 600.0


def _child(rank: int, n_procs: int, store: str, backend, device: str, timeout: float,
           fn: Callable, args: tuple, kwargs: dict, out: str) -> None:
    torch.set_num_threads(1)
    distributed.join(f'file://{store}', n_procs, rank, backend=backend, device=device,
                     timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(*args, **kwargs)
    finally:
        distributed.shutdown()
    with open(out, 'w') as f:
        json.dump(result, f)


def spawn(fn: Callable, n_procs: int, args: tuple = (), kwargs: dict | None = None, *,
          backend: str | None = None, device: str | torch.device | None = None,
          timeout: float = JOIN_TIMEOUT) -> list:
    """``fn(*args, **kwargs)`` in each of ``n_procs`` new processes joined
    into one process group (``initialize``'s backend and card rules; one
    process too, so that its collectives are real calls); returns
    each process's result (JSON values), in rank order. ``fn`` is a
    module-level function. Raises if a process exits with an error (the
    others are killed then) or is still running ``timeout`` seconds after
    the start (it is killed)."""
    device = str(resolve_device(device))
    ctx = mp.get_context('spawn')
    with tempfile.TemporaryDirectory(prefix='mgt-spawn-') as tmp:
        outs = [os.path.join(tmp, f'rank{r}.json') for r in range(n_procs)]
        procs = [ctx.Process(target=_child, daemon=True, args=(
            r, n_procs, os.path.join(tmp, 'store'), backend, device, timeout, fn, args,
            kwargs or {}, outs[r])) for r in range(n_procs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            pending = procs
            # Until all exit, one fails (the others would wait for it in a
            # collective) or the time is up.
            while pending and not any(p.exitcode for p in procs):
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                wait([p.sentinel for p in pending], left)
                pending = [p for p in pending if p.exitcode is None]
        finally:
            running = [r for r, p in enumerate(procs) if p.exitcode is None]
            for r in running:
                procs[r].kill()
                procs[r].join(30)
        failed = {r: p.exitcode for r, p in enumerate(procs) if r not in running and p.exitcode}
        if failed:
            raise RuntimeError(f'{fn.__name__} on {n_procs} processes failed: exit codes '
                               f'{failed}, ranks {running} killed (the tracebacks are on '
                               'stderr)')
        if running:
            raise RuntimeError(f'{fn.__name__} on {n_procs} processes: ranks {running} still '
                               f'running after {timeout} s (killed)')
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
        return results


def rollout_checksums(traj, venv) -> dict[str, list[int]]:
    """Integer checksums of each step of a (T, E/R, N, ...) rollout: its
    observations, actions, dones and reward bits, each env's weighted by its
    index in the global batch (so a row moved to another env changes it),
    summed over the mesh's processes. ``{field: [T sums]}``."""
    t = traj.action.shape[0]
    w = torch.arange(venv.rows.start, venv.rows.stop, device=traj.action.device) + 1
    fields = {'image': traj.image, 'direction': traj.direction, 'action': traj.action,
              'done': traj.done, 'reward_bits': traj.reward.contiguous().view(torch.int32)}
    if traj.mission is not None:
        fields['mission'] = traj.mission
    sums = torch.stack([(x.to(torch.int64).reshape(t, w.shape[0], -1).sum(-1) * w).sum(-1)
                        for x in fields.values()])
    if venv.mesh is not None:
        sums = distributed.all_reduce(sums, venv.mesh.group)
    return dict(zip(fields, sums.tolist()))


def ppo_run(num_envs: int, updates: int = 3, *, env_id: str = FLAGSHIP, agents: int = 4,
            env_kwargs: dict | None = None, config: dict | None = None, hidden: int = 128,
            encoder: str = 'mlp', float32: bool = False, fused_policy: bool = False,
            sharded: bool = True, model_shards: int = 1, mesh=None,
            device: str | None = None, save_params: str | None = None,
            load_params: str | None = None) -> dict:
    """``updates`` PPO updates (seed 0) of the mlp on packed cells, or of
    the cnn (``encoder='cnn'``) on ``(vs, vs, 3)`` images as the JAX gate
    trains it, on a global batch of ``num_envs`` envs: over a mesh of every
    process of the run with ``model_shards`` on ``'model'`` (``sharded``),
    over ``mesh``, or in this process alone. Returns each update's metrics,
    its rollout's :func:`rollout_checksums` (the rollout run once more from
    the update's state and keys, untimed), the full parameters'
    digest after each update, the kernels' launches in the updates and
    their seconds (on the host's clock, to the metrics' copy to the host),
    and the bytes of this process's reserve pool (0 without one).
    cuDNN runs deterministic meanwhile, and the CPU on one thread as each
    spawned process does, so that the cnn's processes compute the same
    bits.

    With ``save_params`` (a directory) the first process writes the full
    parameters and Adam's first moments before the first update and after
    each (``params{u}.pt``);
    with ``load_params`` every update from the second on starts from the
    parameters written there after the update before, in place of this
    run's own: a one-process run that follows a sharded run's parameters
    (:func:`dryrun_multichip`)."""
    from collections import Counter

    from ..envs import make
    from ..learn import PPOConfig, make_train_step, ppo_init
    from ..learn.ppo import params_digest
    from ..ops import launch_counts, zero_launch_counts
    from .mesh import gather_params, make_mesh, shard_params
    from .vector import VectorEnv

    env = make(env_id, agents=agents, device=device, **(env_kwargs or {}))
    if mesh is None and sharded:
        mesh = make_mesh(n_model_shards=model_shards)
    venv = VectorEnv(env, num_envs, packed_obs=encoder == 'mlp', mesh=mesh)
    state, net, cfg, tx = ppo_init(
        venv, 0, config=PPOConfig(**(config or {})),
        net_kwargs=dict(hidden=hidden, encoder=encoder,
                        **({'dtype': torch.float32} if float32 else {})))
    before = os.environ.get('MULTIGRID_FUSED_POLICY')
    if fused_policy:
        os.environ['MULTIGRID_FUSED_POLICY'] = '1'
    else:
        os.environ.pop('MULTIGRID_FUSED_POLICY', None)
    try:
        step = make_train_step(venv, net, cfg, tx)
    finally:
        if before is None:
            os.environ.pop('MULTIGRID_FUSED_POLICY', None)
        else:
            os.environ['MULTIGRID_FUSED_POLICY'] = before
    if fused_policy and not step.fused_policy:
        raise RuntimeError('the fused-policy rollout is off for this configuration')
    rows, rollouts, digests, seconds, launches = [], [], [], 0.0, Counter()
    deterministic, threads = torch.backends.cudnn.deterministic, torch.get_num_threads()
    torch.backends.cudnn.deterministic = True
    if venv.device.type == 'cpu':
        torch.set_num_threads(1)
    try:
        _save_params(save_params, 0, state, venv)
        for u in range(updates):
            if load_params is not None and u:
                state = state.replace(params=shard_params(
                    {k: v.to(state.params[k].device) for k, v in _load_params(
                        load_params, u)['params'].items()}, venv.mesh))
            # The keys are the state's: the rollout again leaves them as they are.
            rollouts.append(rollout_checksums(step.rollout_phase(state)[1], venv))
            if venv.device.type == 'cuda':
                torch.cuda.synchronize()
            zero_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state)
            rows.append({k: float(v) for k, v in metrics.items()})
            seconds += time.perf_counter() - t0
            launches.update(launch_counts())
            digests.append(params_digest(gather_params(state.params, venv.mesh)))
            _save_params(save_params, u + 1, state, venv)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.set_num_threads(threads)
    return {'metrics': rows, 'rollouts': rollouts, 'params_digests': digests,
            'launches': {k: launches[k] for k in launch_counts()}, 'seconds': seconds,
            'agent_steps': updates * cfg.rollout_steps * num_envs * agents,
            'process_count': 1 if venv.mesh is None else venv.mesh.env_shards,
            'mesh_shape': [1, 1] if venv.mesh is None else list(venv.mesh.shape),
            'encoder': net.encoder,
            'pool_bytes': 0 if state.env_state.pool is None else state.env_state.pool.nbytes}


def _params_path(folder: str, update: int) -> str:
    return os.path.join(folder, f'params{update}.pt')


def _save_params(folder: str | None, update: int, state, venv) -> None:
    """The full parameters and Adam's first moments after ``update``
    updates into ``folder``, by the first process (every process joins the
    gathers)."""
    if folder is None:
        return
    from .mesh import gather_params
    full = {name: {k: v.detach().cpu() for k, v in gather_params(tree, venv.mesh).items()}
            for name, tree in (('params', state.params), ('mu', state.opt_state.mu))}
    if distributed.process_index() == 0:
        torch.save(full, _params_path(folder, update))


def _load_params(folder: str, update: int) -> dict[str, dict[str, torch.Tensor]]:
    return torch.load(_params_path(folder, update), weights_only=True)


def gradient_error(sharded: str, single: str, updates: int) -> list[float]:
    """How far each update's gradients in a one-process run that follows a
    sharded run's parameters (``ppo_run``'s ``load_params``) are from the
    sharded run's: after update ``u``, ``|m_single - m_sharded| /
    |m_sharded|`` of Adam's first moments ``m`` (each a running mean of its
    run's clipped gradients; Euclidean norms over all parameters, float64).
    Rounding alone leaves it under bfloat16's precision; gradients of
    other samples move it to the order of 1. Both runs must start from the
    same parameters."""
    first, other = _load_params(single, 0)['params'], _load_params(sharded, 0)['params']
    if any(not torch.equal(first[k], v) for k, v in other.items()):
        raise AssertionError('the sharded and the one-process runs start from other '
                             'parameters')
    out = []
    for u in range(1, updates + 1):
        a, b = _load_params(single, u)['mu'], _load_params(sharded, u)['mu']
        num = sum(float(torch.sum((a[k].double() - b[k].double()) ** 2)) for k in b)
        den = sum(float(torch.sum(b[k].double() ** 2)) for k in b)
        out.append(math.sqrt(num / den) if den else math.inf)
    return out


def ppo_runs(runs: list[dict]) -> list[dict]:
    """:func:`ppo_run` for each keyword dict of ``runs``, in order."""
    return [ppo_run(**kw) for kw in runs]


def assert_consistent(sharded: list[dict], single: dict, label: str = 'sharded run',
                      rtol: float = 1e-4, atol: float = 1e-6) -> None:
    """Hold every process's :func:`ppo_run` result to the one-process run's.

    Every process's parameters (digests, after every update) and metrics
    equal the first process's; every update's rollout is bit-equal to one
    process's (its first differing step is reported); every metric agrees
    within ``rtol``/``atol`` (NaN where NaN). Where several env shards sum
    the gradients in another order, the one process follows the sharded
    run's parameters (``ppo_run``'s ``load_params``), so that a bfloat16
    logit near a tie picks the same action."""
    for rank, res in enumerate(sharded):
        if res['params_digests'] != sharded[0]['params_digests']:
            raise AssertionError(f'{label}: the parameters of process {rank} differ from '
                                 "process 0's after an update")
        if not _nan_equal(res, sharded[0]):
            raise AssertionError(f'{label}: process {rank} reports other metrics than '
                                 f'process 0: {res["metrics"]} vs {sharded[0]["metrics"]}')
    got = sharded[0]
    for u, (a, b) in enumerate(zip(got['rollouts'], single['rollouts'])):
        if a != b:
            step = min(next(t for t, (x, y) in enumerate(zip(a[k], b[k])) if x != y)
                       for k in b if a[k] != b[k])
            raise AssertionError(f'{label}: the rollout of update {u + 1} first differs from '
                                 f"one process's at step {step + 1}")
        for k in sorted(single['metrics'][u]):
            np.testing.assert_allclose(
                got['metrics'][u][k], single['metrics'][u][k], rtol=rtol, atol=atol,
                equal_nan=True,
                err_msg=f'{label}: metric {k!r} of update {u + 1} diverges between '
                        f'{got["process_count"]} processes and one')


def _nan_equal(a: dict, b: dict) -> bool:
    return all(x.keys() == y.keys() and all(
        x[k] == y[k] or (math.isnan(x[k]) and math.isnan(y[k])) for k in x)
        for x, y in zip(a['metrics'], b['metrics']))


#: The most :func:`gradient_error` a sharded update may show: each env
#: shard's gradients are rounded to bfloat16 (relative 2^-8) before their
#: mean, one process's once after the whole batch's sum; 2e-3 on the CPU.
GRADIENT_RTOL = 2e-2


def dryrun_multichip(n_procs: int, *, backend: str | None = None,
                     device: str | torch.device | None = None, num_envs_per_proc: int = 128,
                     rollout_steps: int = 2, timeout: float = JOIN_TIMEOUT):
    """Sharding correctness gate: 3 PPO updates of the default cnn on the
    flagship over ``n_procs`` spawned processes, on an ``(n/2, 2)`` mesh
    where ``n_procs`` is even (else ``(n, 1)``), and the same global batch
    (``num_envs_per_proc · n_procs`` envs) in this process, held together
    by :func:`assert_consistent` with every rollout bit-equal. From the
    second update on this process starts each update from the sharded
    run's parameters (``ppo_run``'s ``load_params``): several env shards sum
    the gradients in another order, so the bfloat16 parameters would round
    otherwise and a later rollout could pick another action. The gradients
    are held to the sharded run's too: with one env shard the parameters
    after every update are the same bits, with several Adam's moments
    agree within :data:`GRADIENT_RTOL` (:func:`gradient_error`). Returns
    ``(sharded, single)``: each process's :func:`ppo_run` result and this
    process's, the latter with its ``gradient_error``."""
    device = str(resolve_device(device))
    n_model = 2 if n_procs % 2 == 0 else 1
    num_envs = num_envs_per_proc * n_procs
    kw = dict(updates=3, encoder='cnn', config=dict(rollout_steps=rollout_steps),
              device=device)
    label = f'dryrun_multichip({n_procs})'
    with tempfile.TemporaryDirectory(prefix='mgt-gate-') as tmp:
        shard_dir, single_dir = os.path.join(tmp, 'sharded'), os.path.join(tmp, 'single')
        os.makedirs(shard_dir)
        os.makedirs(single_dir)
        sharded = spawn(ppo_run, n_procs, (num_envs,),
                        dict(kw, model_shards=n_model, save_params=shard_dir),
                        backend=backend, device=device, timeout=timeout)
        single = ppo_run(num_envs, sharded=False, load_params=shard_dir,
                         save_params=single_dir, **kw)
        errors = gradient_error(shard_dir, single_dir, kw['updates'])
    assert_consistent(sharded, single, label)
    if n_procs == n_model:
        if single['params_digests'] != sharded[0]['params_digests']:
            raise AssertionError(f'{label}: one env shard, and the parameters differ from '
                                 "one process's after an update")
    elif not max(errors) < GRADIENT_RTOL:
        raise AssertionError(f"{label}: the gradients differ from one process's: Adam's "
                             f'moments at relative errors {errors} (limit {GRADIENT_RTOL})')
    single['gradient_error'] = errors
    print(f'{label}: ok: 3 updates on the {tuple(sharded[0]["mesh_shape"])} (env, model) '
          f'mesh consistent with one process, every rollout bit-equal, Adam\'s moments at '
          f'relative errors {errors}; metrics {sharded[0]["metrics"][-1]}', flush=True)
    return sharded, single


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description='PPO sharded over N processes against one.')
    p.add_argument('n_procs', type=int)
    p.add_argument('--device', default=None, help="'cuda' (default) or 'cpu'")
    p.add_argument('--backend', default=None,
                   help="'nccl' (default on the card) or 'gloo' (default on the CPU; "
                        'two processes on one card)')
    p.add_argument('--num-envs-per-proc', type=int, default=128)
    p.add_argument('--rollout-steps', type=int, default=2)
    args = p.parse_args(argv)
    dryrun_multichip(args.n_procs, backend=args.backend, device=args.device,
                     num_envs_per_proc=args.num_envs_per_proc,
                     rollout_steps=args.rollout_steps)


if __name__ == '__main__':
    main(sys.argv[1:])
