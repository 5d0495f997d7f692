"""Random rollouts: the experience generator alone, as a closed loop.

Traffic parameters (``portbench/traffic/<name>.json``): ``steps_per_call``,
the steps of one ``VectorEnv.rollout_random`` call; ``stretch_calls``, the
calls the traced run profiles. Set-up builds the vector env of the
configuration on the card, resets it from the seed's key and warms up one
call (the capture of its graphs). The window then calls
``rollout_random`` back to back, each call with the next key of the seed,
until ``seconds`` have passed on the host's clock, and ends with one
synchronization: ``env_agent_steps_per_s`` is E·N·steps over the whole
window. A traced run then profiles ``stretch_calls`` more calls.

One call of the window, drawn from the seed among those in which the
envs reach ``max_steps``, is kept (its state before, its key, the state
and summary after, copied into buffers made in set-up) and checked
against the plain reference once the window has closed and the program's
graphs are freed (:mod:`portbench.envcheck`).
"""

from __future__ import annotations

import gc
import random
import sys
import time

from .. import counting, envcheck, tracing
from ..harness import GIB, Cell, Outcome

#: Keys made for the window's calls: more than any window can use.
MAX_CALLS = 1 << 16


def run(cell: Cell) -> Outcome:
    import torch
    from multigrid_tpu_torch import VectorEnv, make

    cfg, dev = cell.config, cell.device
    steps = cell.traffic['steps_per_call']
    cuda = dev != 'cpu'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    env = make(cfg['env_id'], agents=cfg['agents'], agent_view_size=cfg['agent_view_size'],
               max_steps=cfg['max_steps'], device=dev)
    venv = VectorEnv(env, cfg['num_envs'], packed_obs=cfg['packed_obs'],
                     reset_pool=cfg['reset_pool'])
    reset_key, call_keys = envcheck.keys_of(cell.seed, MAX_CALLS + 1)
    call_keys = call_keys.to(dev)
    reset_obs, reset_state = venv.reset(reset_key.to(dev))
    state, warm_summary = venv.rollout_random(reset_state, call_keys[MAX_CALLS], steps)
    kept = envcheck.Sample(reset_state.clone(), None, reset_state.clone(),
                           {k: v.clone() for k, v in warm_summary.items()})
    sync()
    # The same collector state in every run: what set-up made is collected
    # once and kept out of later collections.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - cell.t_start

    # One of the calls in which the step count since the reset crosses a
    # multiple of max_steps is kept, by reservoir sampling from the seed,
    # in buffers made here, so that what a run holds does not depend on
    # which call it keeps.
    max_steps = env.cfg.max_steps
    pick = random.Random(cell.seed)

    def keep(call, before, after, summary):
        envcheck.copy_into(kept.before, before)
        envcheck.copy_into(kept.after, after)
        for k, v in summary.items():
            kept.summary[k].copy_(v)
        kept.key = call_keys[call]

    boundary_calls = calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        first = (calls + 1) * steps
        before = state
        state, summary = venv.rollout_random(state, call_keys[calls], steps)
        if (first + steps) // max_steps > first // max_steps:
            boundary_calls += 1
            if pick.randrange(boundary_calls) == 0:
                keep(calls, before, state, summary)
        calls += 1
    if not boundary_calls:
        keep(calls - 1, before, state, summary)
    sync()
    window_s = time.perf_counter() - t0
    del before, summary
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    trace = None
    if cell.trace:
        stretch = cell.traffic['stretch_calls']

        def stretch_calls():
            s = state
            for i in range(stretch):
                s, _ = venv.rollout_random(s, call_keys[calls + i], steps)

        trace = tracing.profile(stretch_calls, work=stretch * steps)

    e, n = cfg['num_envs'], cfg['agents']
    metrics = {'setup_s': setup_s,
               'env_agent_steps_per_s': e * n * steps * calls / window_s,
               'peak_mem_gib': peak / GIB}
    del venv, env, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = envcheck.reference_env(cfg, dev)
    checks = envcheck.compare(ref, reset_key, reset_obs, reset_state, kept, steps)
    print(f'{cell.name}: set-up {setup_s:.3f} s, window {window_s:.3f} s, {calls} calls, '
          f'check {time.perf_counter() - t_check:.3f} s', file=sys.stderr)
    shapes = counting.Shapes(e, n, ref.env.width, ref.env.height, ref.env.uses_boxes,
                             cfg['agent_view_size'])
    return Outcome(attempted=calls, failed=int(not all(c.ok for c in checks)),
                   metrics=metrics, checks=checks, memory_peak_bytes=peak, trace=trace,
                   shapes=shapes)
