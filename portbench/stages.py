"""The env step's stages inside the captured graphs of a traced
random-rollout run, read from the program's own stage counters
(``multigrid_tpu_torch.utils.profiling``: ``stage_counters``,
``zero_stages``, ``stage_totals``).

A per-layer reader runs once the cell's run has returned, its window,
its profiled stretch and its check done on graphs without marks. The first
reader that asks builds the cell's vector env again, resets it from the
seed's key and, with the stage counters on, warms up one call (the capture
of the marked graphs) with the run's warm-up key, zeroes the table and
runs ``stretch_calls`` calls with the seed's first keys between two CUDA
events; then it reads the table once. The result is kept on the trace
(``trace.stages``) for the other readers:

- ``ns`` and ``marks``: each stage's self time in the stretch and its
  marks; ``counts``: ``layouts.made`` and ``layouts.used``;
- ``steps``: the stretch's env steps; ``episodes``: its summaries' finished
  episodes; ``wall_ns``: the CUDA events' time around it; ``host_s``: its
  host wall; ``tick_ns``: the smallest step of the device's clock.

None where the program has no stage counters or the cell's traffic is
not random rollouts: the readers then read nothing.
"""

from __future__ import annotations

import json
import sys
import time

from . import envcheck

#: What a stage table needs of the program.
NEEDS = ('stage_counters', 'zero_stages', 'stage_totals', 'timer_tick_ns')


def of(ctx):
    """The cell's stage table (see the module), measured at the first call
    of a traced run; None where there is none."""
    trace = ctx.trace
    if trace is None:
        return None
    if not hasattr(trace, 'stages'):
        trace.stages = measure(ctx.cell)
    return trace.stages


def us_per_step(table, *names):
    """The named stages' microseconds an env step; None without a table or
    where none of them was marked."""
    if table is None or not any(n in table['ns'] for n in names):
        return None
    return sum(table['ns'].get(n, 0) for n in names) / table['steps'] / 1e3


def measure(cell):
    import torch
    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.utils import profiling

    from .drivers.random_rollout import MAX_CALLS

    if cell.traffic.get('driver') != 'random_rollout' or \
            not all(hasattr(profiling, n) for n in NEEDS):
        return None
    cfg, dev = cell.config, torch.device(cell.device)
    steps, calls = cell.traffic['steps_per_call'], cell.traffic['stretch_calls']
    cuda = dev.type == 'cuda'
    env = make(cfg['env_id'], agents=cfg['agents'], agent_view_size=cfg['agent_view_size'],
               max_steps=cfg['max_steps'], device=dev)
    venv = VectorEnv(env, cfg['num_envs'], packed_obs=cfg['packed_obs'],
                     reset_pool=cfg['reset_pool'])
    reset_key, call_keys = envcheck.keys_of(cell.seed, MAX_CALLS + 1)
    call_keys = call_keys.to(dev)
    _, state = venv.reset(reset_key.to(dev))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
    with profiling.stage_counters():
        state, _ = venv.rollout_random(state, call_keys[MAX_CALLS], steps)
        if cuda:
            torch.cuda.synchronize()
        summaries = []
        t0 = time.perf_counter()
        if cuda:
            events[0].record()
        profiling.zero_stages(dev)
        for i in range(calls):
            state, summary = venv.rollout_random(state, call_keys[i], steps)
            summaries.append(summary['episodes'])
        if cuda:
            events[1].record()
        stages, counts = profiling.stage_totals(dev)
        host_s = time.perf_counter() - t0
    marked = {k: v for k, v in stages.items() if v['marks'] or v['ns']}
    table = {'ns': {k: v['ns'] for k, v in marked.items()},
             'marks': {k: v['marks'] for k, v in marked.items()},
             'counts': counts, 'steps': calls * steps,
             'episodes': int(sum(int(e) for e in summaries)),
             'wall_ns': events[0].elapsed_time(events[1]) * 1e6 if cuda else None,
             'host_s': host_s,
             'tick_ns': profiling.timer_tick_ns(dev) if cuda else None}
    del venv, env, state
    if cuda:
        torch.cuda.empty_cache()
    print(f'{cell.name}: stages {json.dumps(table)}', file=sys.stderr)
    return table
