#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card     — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build    — builds the CUDA kernels from ``multigrid_tpu_torch/csrc``.
3. kernels  — the observation kernel against its plain PyTorch version on
               the card, ``torch.equal``, on seeded states stepped a few
               times: the flagship shape (E=4096, N=4, 16x16, view 7; see
               through walls off and on; packed and images), view sizes 3-13,
               1, 2 and 8 agents, a 13x25 grid, doors (open, closed, locked),
               keys, balls, boxes, agents at the borders, terminated and
               carrying.
4. main     — ``VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=4), 4096)``
               on the default device: reset, then ``rollout_random`` for 256
               steps, with the kernel's launch count set to 0 just before and
               read just after (one launch per step, one for the reset).
5. check    — the outputs: finite, the expected shapes, valid states, the
               kernel equal to the plain version on the rollout's final
               state, and two recorded reference traces
               (``tests/golden``) replayed bit-exactly on the card.
6. timing   — agent-steps/s by length differencing (median of short/long
               rollout pairs, synchronized), the kernel's time per launch
               from CUDA events, its bound (bytes over 3.35 TB/s), and the
               plain version's time.
7. breakdown — each layer's time in a step (step, reset and merge, obs),
               and the device's busy share and kernels per step from
               ``torch.profiler``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet) for the bounds.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12  # float32 outside the tensor cores

E, N, SIZE, VS = 4096, 4, 16, 7
STEPS = 256


def fail(msg: str) -> None:
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f'== {name}', flush=True)


# ------------------------------------------------------------------ states

def random_state(seed, e, w, h, n, device, steps=3):
    """Seeded numpy state with every cell kind, stepped a few times on the
    card with random actions and orders."""
    import numpy as np
    import torch

    from multigrid_tpu_torch.core.config import EnvConfig
    from multigrid_tpu_torch.core.constants import (
        COLOR_GREY, EMPTY_ENCODING, TYPE_BALL, TYPE_BOX, TYPE_DOOR,
        TYPE_EMPTY, TYPE_FLOOR, TYPE_GOAL, TYPE_KEY, TYPE_LAVA, TYPE_WALL)
    from multigrid_tpu_torch.core.state import state_from_arrays
    from multigrid_tpu_torch.ops.step import step_with_order

    rng = np.random.default_rng(seed)
    kinds = np.array([TYPE_EMPTY] * 10 + [TYPE_WALL, TYPE_WALL, TYPE_FLOOR,
                     TYPE_DOOR, TYPE_DOOR, TYPE_KEY, TYPE_BALL, TYPE_BOX,
                     TYPE_GOAL, TYPE_LAVA])
    t = rng.choice(kinds, size=(e, w, h))
    c = np.where(t == TYPE_EMPTY, 0, rng.integers(0, 6, (e, w, h)))
    s = np.where(t == TYPE_DOOR, rng.integers(0, 3, (e, w, h)), 0)
    # Half the envs are walled; in the rest views run off the grid.
    ring = np.zeros((w, h), bool)
    ring[[0, -1], :] = ring[:, [0, -1]] = True
    wall = (rng.random(e) < 0.5)[:, None, None] & ring
    t, c, s = np.where(wall, TYPE_WALL, t), np.where(wall, COLOR_GREY, c), np.where(wall, 0, s)
    grid = np.stack([t, c, s], -1).astype(np.int32)
    box = np.where((t == TYPE_BOX)[..., None],
                   np.stack([rng.choice([TYPE_EMPTY, TYPE_KEY, TYPE_BALL], (e, w, h)),
                             rng.integers(0, 6, (e, w, h)), np.zeros((e, w, h), int)], -1),
                   EMPTY_ENCODING)
    pos = np.stack([rng.integers(0, w, (e, n)), rng.integers(0, h, (e, n))], -1)
    # A quarter of the agents on the border.
    edge = rng.random((e, n)) < 0.25
    pos[..., 0] = np.where(edge, rng.choice([0, w - 1], (e, n)), pos[..., 0])
    grid[np.arange(e)[:, None], pos[..., 0], pos[..., 1]] = EMPTY_ENCODING
    carry_t = np.where(rng.random((e, n)) < 0.35,
                       rng.choice([TYPE_KEY, TYPE_BALL, TYPE_BOX], (e, n)), TYPE_EMPTY)
    carry = np.stack([carry_t, np.where(carry_t == TYPE_EMPTY, 0, rng.integers(0, 6, (e, n))),
                      np.zeros((e, n), int)], -1)
    state = state_from_arrays(dict(
        grid=grid, box_contents=box, agent_pos=pos,
        agent_dir=rng.integers(0, 4, (e, n)),
        agent_color=np.broadcast_to(np.arange(n) % 6, (e, n)),
        agent_terminated=rng.random((e, n)) < 0.2,
        agent_carrying=carry,
        agent_carrying_contents=np.broadcast_to(EMPTY_ENCODING, (e, n, 3)),
        step_count=np.zeros((e,), np.int32)), device)
    cfg = EnvConfig(width=w, height=h, num_agents=n, max_steps=1000)
    g = torch.Generator(device=device).manual_seed(seed)
    for _ in range(steps):
        actions = torch.randint(0, 7, (e, n), generator=g, device=device)
        order = torch.rand((e, n), generator=g, device=device).argsort(-1)
        state = step_with_order(cfg, state, actions, order)[0]
    return state


# ------------------------------------------------------------------ phases

def card_info():
    import torch
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f'nvidia-smi unavailable (rc {smi.returncode})'
    print(line, flush=True)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)')


def build_kernels():
    from multigrid_tpu_torch.ops import obs_cuda
    from multigrid_tpu_torch.utils import build
    t0 = time.perf_counter()
    build.build([obs_cuda.SOURCE])
    print(f'built {obs_cuda.SOURCE} in {time.perf_counter() - t0:.2f} s')
    for line in build.build_log(obs_cuda.SOURCE).splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line.lower():
            print('  ' + line.strip())


def kernel_cases(device):
    """Kernel ≡ plain on every case; returns the largest abs difference."""
    import torch

    from multigrid_tpu_torch.ops import obs_cuda
    from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain

    cases = []  # (label, state, vs, stw, packed)
    flag = random_state(1, E, SIZE, SIZE, N, device)
    for stw in (False, True):
        for packed in (False, True):
            cases.append((f'flagship E={E} N={N} 16x16 vs=7 stw={stw} packed={packed}',
                          flag, VS, stw, packed))
    small = random_state(2, 512, SIZE, SIZE, N, device)
    for vs in (3, 5, 9, 11, 13):
        for stw in (False, True):
            cases.append((f'vs={vs} stw={stw}', small, vs, stw, False))
    for n in (1, 2, 8):
        st = random_state(3 + n, 512, SIZE, SIZE, n, device)
        cases.append((f'N={n}', st, VS, False, False))
        cases.append((f'N={n} packed', st, VS, False, True))
    tall = random_state(20, 512, 13, 25, 3, device)
    for vs in (7, 13):
        cases.append((f'13x25 N=3 vs={vs}', tall, vs, False, False))
    tiny = random_state(21, 256, 5, 5, 4, device)
    cases.append(('5x5 N=4 vs=13 (view past every border)', tiny, 13, False, False))

    max_err = 0
    for label, st, vs, stw, packed in cases:
        got = obs_cuda.gen_obs_batched(st, vs, stw, packed)
        want = gen_obs_batched_plain(st, vs, stw, packed)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        ok = torch.equal(got, want)
        print(f'  {"ok  " if ok else "FAIL"} {label}  shape={tuple(got.shape)} max_abs_err={err}')
        if not ok:
            fail(f'kernel differs from plain version: {label}')
    print(f'{len(cases)} cases equal')
    return max_err


def main_path(device=None):
    import torch

    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.ops import obs_cuda

    env = make('MultiGrid-Empty-16x16-v0', agents=N, device=device)
    if device is None and env.device.type != 'cuda':
        fail(f'default device is {env.device}, not cuda')
    venv = VectorEnv(env, E)
    obs_cuda.launches = 0
    obs, state = venv.reset(seed=0)
    after_reset = obs_cuda.launches
    state, summary = venv.rollout_random(state, STEPS)
    torch.cuda.synchronize()
    launches = obs_cuda.launches
    print(f'reset + rollout_random({STEPS}): {launches} obs-kernel launches '
          f'({after_reset} at reset)')
    if after_reset != 1 or launches - after_reset != STEPS:
        fail(f'expected 1 launch at reset and {STEPS} in the rollout, got '
             f'{after_reset} and {launches - after_reset}')
    return venv, obs, state, summary, launches


def check_outputs(venv, obs, state, summary, device=None):
    import numpy as np
    import torch

    from multigrid_tpu_torch.envs import make
    from multigrid_tpu_torch.envs.parity import ParityRunner
    from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain

    if tuple(obs['image'].shape) != (E, N, VS, VS, 3):
        fail(f'reset obs shape {tuple(obs["image"].shape)}')
    rew = float(summary['reward_sum'])
    if not np.isfinite(rew) or rew < 0:
        fail(f'reward_sum {rew}')
    print(f'summary: reward_sum={rew} episodes={int(summary["episodes"])} '
          f'obs_sum={int(summary["obs_sum"])}')
    pos = state.agent_pos
    if not (((pos >= 1) & (pos <= SIZE - 2)).all() and (state.step_count <= 4 * SIZE**2).all()):
        fail('rollout left agents off the floor or step counts past max_steps')
    final = venv.observe(state)['image']
    if not torch.equal(final, gen_obs_batched_plain(state, VS, False)):
        fail('kernel differs from plain version on the rollout state')
    # Recorded reference trajectories, replayed through the kernel on the card.
    golden = os.path.join(HERE, 'tests', 'golden')
    for env_id, seed, n in [('MultiGrid-Empty-16x16-v0', 3, 2),
                            ('MultiGrid-Empty-Random-5x5-v0', 42, 4)]:
        data = np.load(os.path.join(golden, f'{env_id}-s{seed}-n{n}.npz'))
        runner = ParityRunner(make(env_id, agents=n, device=device), seed)
        obs0 = runner.reset()
        images = [np.stack([obs0[i]['image'] for i in range(n)])]
        acts = np.random.default_rng(seed + 1000)
        for t in range(len(data['rewards'])):
            o, r, te, tr, _ = runner.step({i: int(acts.integers(0, 7)) for i in range(n)})
            images.append(np.stack([o[i]['image'] for i in range(n)]))
            if not all(te[i] == bool(data['terms'][t, i]) for i in range(n)):
                fail(f'{env_id} s{seed}: terminations differ at step {t}')
        if not np.array_equal(np.stack(images), data['images'].astype(np.int32)):
            fail(f'{env_id} s{seed}: observations differ from the golden trace')
        print(f'golden {env_id} s{seed} n{n}: {len(images) - 1} steps equal on the card')


def breakdown(venv, state, steps=32):
    """Where a step's time goes: each layer's synchronized host time, then
    the device's busy share and kernel count from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multigrid_tpu_torch.core.state import where_state
    from multigrid_tpu_torch.ops.step import sample_order

    env, g = venv.env, venv.generator
    layers = {'step': 0.0, 'reset+merge': 0.0, 'obs': 0.0}
    for _ in range(steps):
        actions = torch.randint(0, 7, (E, N), generator=g, device=venv.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        order = sample_order(g, E, N, venv.device)
        _, new_state, _, term, trunc = env.step_core(state, actions, order)
        done = term.all(-1) | trunc.any(-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = where_state(done, env.reset_core(E, g), new_state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        venv.observe(state)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        layers['step'] += t1 - t0
        layers['reset+merge'] += t2 - t1
        layers['obs'] += t3 - t2
    print('per-step host time by layer (synchronized): ' + ', '.join(
        f'{k} {v / steps * 1e3:.4f} ms' for k, v in layers.items()))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = venv.rollout_random(state, 16)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print('device busy share: not measured (the profiler saw no device time)')
        return state
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f'profiled rollout_random(16): wall {wall_ms:.4f} ms, device busy '
          f'{busy_ms:.4f} ms ({busy_ms / wall_ms:.4f} of the wall time), '
          f'{len(kernels) / 16:.1f} device kernels per step')
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f'  {us / 16:9.3f} us/step  {name[:90]}')
    return state


def timing(venv, state):
    import torch

    from multigrid_tpu_torch.ops import obs_cuda
    from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain

    short, long_ = STEPS // 4, STEPS
    t_short, t_long = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, s = venv.rollout_random(state, short)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, s = venv.rollout_random(state, long_)
        torch.cuda.synchronize()
        t_short.append(t1 - t0)
        t_long.append(time.perf_counter() - t1)
    marginal = E * N * (long_ - short)
    print('pairs (short s, long s, agent-steps/s): ' + '; '.join(
        f'{ts:.6f}, {tl:.6f}, {marginal / (tl - ts):.6e}'
        for ts, tl in zip(t_short, t_long)))
    t_short.sort()
    t_long.sort()
    rate = marginal / (t_long[1] - t_short[1])
    step_ms = (t_long[1] - t_short[1]) / (long_ - short) * 1e3
    print(f'agent-steps/s (median of 3, length-differenced {short}/{long_} steps): '
          f'{rate:.6e}  ({step_ms:.4f} ms/step)')

    def event_ms(fn, reps):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    launches = obs_cuda.launches
    ms = event_ms(lambda: obs_cuda.gen_obs_batched(state, VS, False), 200)
    plain_ms = event_ms(lambda: gen_obs_batched_plain(state, VS, False), 20)
    obs_cuda.launches = launches  # timing launches are not main-path launches

    n_cells = E * N * VS * VS
    read = (state.grid.numel() * 4 + state.agent_pos.numel() * 4
            + state.agent_dir.numel() * 4 + state.agent_color.numel() * 4
            + state.agent_terminated.numel() + state.agent_carrying.numel() * 4)
    written = n_cells * 3 * 4
    # Integer operations: about 16 per output cell (crop, rotation, mask,
    # unpack) and 12 per cell for the two fill passes.
    ops = n_cells * (16 + 12) + state.grid.numel() // 3 * 4
    bytes_ms = (read + written) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / VECTOR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = 'bytes' if bytes_ms >= ops_ms else 'operations'
    print(f'obs kernel: {ms:.6f} ms/launch; plain version {plain_ms:.6f} ms; '
          f'bound {bound_ms:.6f} ms by {bound_by} ({read + written} bytes, '
          f'{ops} ops); {bound_ms / ms:.4f} of the bound')
    return dict(rate=rate, step_ms=step_ms, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('no CUDA device')
    if not os.path.isdir(os.path.join(HERE, 'multigrid_tpu_torch')):
        fail(f'multigrid_tpu_torch not found beside {__file__}')
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    device = torch.device('cuda')

    phase('card')
    card_info()
    phase('build')
    build_kernels()
    phase('kernels')
    max_err = kernel_cases(device)
    phase('main')
    venv, obs, state, summary, launches = main_path()
    phase('check')
    check_outputs(venv, obs, state, summary)
    phase('timing')
    t = timing(venv, state)
    phase('breakdown')
    breakdown(venv, state)
    print(f'total {time.perf_counter() - t_start:.1f} s')

    record = {'kernels': [{
        'name': 'obs',
        'route': 'cuda',
        'source': 'multigrid_tpu_torch/csrc/obs.cu',
        'replaces': 'multigrid_tpu/ops/obs_pallas.py:176',
        'launches': launches,
        'max_abs_err': max_err,
        'equal': max_err == 0,
        'ms': t['ms'],
        'plain_ms': t['plain_ms'],
        'bound_ms': t['bound_ms'],
        'bound_by': t['bound_by'],
        'library_ms': None,
    }]}
    print(json.dumps(record))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
