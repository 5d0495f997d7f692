"""PPO training: updates back to back, as the CLI trains.

Traffic parameters (``portbench/traffic/<name>.json``): ``rollout_steps``,
``epochs`` and ``minibatches`` of the PPO config; ``log_interval``, the
updates between two reads of the metrics on the host (the CLI's
``--log-interval``, a synchronization each); ``check_updates``, the first
updates that the reference follows; ``stretch_updates``, the updates the
traced run profiles.

Set-up builds the configuration's vector env and the mlp actor-critic
(its weights made on the card from the seed by the benchmark, one draw),
the train state from the seed (``ppo_init``), and the training step
(``make_train_step``), then runs the first ``check_updates`` updates
through ``TrainStep.__call__`` (the first captures the update's graph).
The window calls it once an update until ``seconds`` have passed, with a
CUDA event recorded on the stream after each update, and ends with one
synchronization: ``train_agent_steps_per_s`` is E·N·T·updates over the
window, ``update_ms_p95`` the 95th percentile of the intervals between
consecutive events (the first from an event recorded at the window's
start), so a stall lands in the update it delays.
"""

from __future__ import annotations

import gc
import math
import sys
import time

from .. import counting, ppocheck, tracing
from ..harness import GIB, Cell, Outcome
from ..reference.utils import prng


def make_params(seed: int, net: counting.NetShapes, device) -> dict:
    """The mlp's float32 weights from ``seed`` on ``device``, one normal
    draw for all kernels, each scaled by ``1/sqrt(fan_in)``, zero biases;
    named as the program's ``ActorCritic`` names them."""
    import torch
    h, f, a = net.hidden, net.features, net.actions
    shapes = {'img_kernel': (net.cells * 21, h), 'Dense_0.kernel': (f, h),
              'Dense_1.kernel': (h, h), 'Dense_2.kernel': (h, a), 'Dense_3.kernel': (h, 1)}
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=g, device=device)
    params, i = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        params[name] = flat[i:i + n].reshape(shape) / math.sqrt(shape[0])
        i += n
        if name != 'img_kernel':
            params[name.replace('kernel', 'bias')] = torch.zeros(shape[1], device=device)
    return params


def run(cell: Cell) -> Outcome:
    import torch
    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.learn.nets import ActorCritic

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    cuda = dev != 'cpu'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    env = make(cfg['env_id'], agents=cfg['agents'], agent_view_size=cfg['agent_view_size'],
               max_steps=cfg['max_steps'], device=dev)
    venv = VectorEnv(env, cfg['num_envs'], packed_obs=True, reset_pool=cfg['reset_pool'])
    spec = cfg['net']
    vs = cfg['agent_view_size']
    shapes = counting.NetShapes(vs * vs, spec['hidden'], 2 + spec.get('missions', 0))
    params = make_params(cell.seed, shapes, dev)
    net = ActorCritic(vs * vs, hidden=spec['hidden'], packed_obs=True, dtype=torch.bfloat16,
                      num_missions=spec.get('missions', 0), encoder='mlp').to(dev)
    net.load_state_dict(params)
    config = PPOConfig(rollout_steps=tr['rollout_steps'], epochs=tr['epochs'],
                       minibatches=tr['minibatches'])
    key = prng.key(cell.seed)
    state, net, config, tx = ppo_init(venv, key.to(dev), config=config, net=net)
    step = make_train_step(venv, net, config, tx)

    states, losses = [state], []
    for _ in range(tr['check_updates']):
        state, metrics = step(state)
        states.append(state)
        losses.append(metrics['loss'])
    losses = [float(x) for x in losses]
    sync()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - cell.t_start

    events = []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    updates = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        state, metrics = step(state)
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        updates += 1
        if updates % tr['log_interval'] == 0:
            _ = {k: float(v) for k, v in metrics.items()}
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    intervals = ([start.elapsed_time(events[0])]
                 + [a.elapsed_time(b) for a, b in zip(events, events[1:])]) if cuda else [0.0]

    trace = None
    if cell.trace:
        count = tr['stretch_updates']

        def stretch():
            s = state
            for _ in range(count):
                s, _ = step(s)

        trace = tracing.profile(stretch, work=count)

    e, n, t = cfg['num_envs'], cfg['agents'], tr['rollout_steps']
    flops = counting.update_flops(e, n, shapes, t, tr['epochs'])
    e2e = {'setup_s': setup_s,
           'train_agent_steps_per_s': e * n * t * updates / window_s,
           'update_ms_p95': float(torch.quantile(torch.tensor(intervals), 0.95)),
           'peak_mem_gib': peak / GIB}
    del venv, env, state, step, net, metrics
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    learner = ppocheck.reference_learner(cfg, tr, dev)
    checks = ppocheck.compare(learner, params, key.to(dev), states, losses)
    print(f'{cell.name}: set-up {setup_s:.3f} s, window {window_s:.3f} s, {updates} updates, '
          f'check {time.perf_counter() - t_check:.3f} s', file=sys.stderr)
    return Outcome(attempted=updates, failed=int(not all(c.ok for c in checks)),
                   metrics=e2e, checks=checks, memory_peak_bytes=peak, trace=trace,
                   shapes=dict(net=shapes, envs=e, agents=n, rollout_steps=t,
                               epochs=tr['epochs'], minibatches=tr['minibatches'],
                               updates=updates, window_s=window_s, flops=flops))
