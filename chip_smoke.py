#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card     — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build    — builds the three CUDA sources of ``multigrid_tpu_torch/csrc``
               (one nvcc each, in parallel) and prints registers and spills.
3. kernels  — each kernel against its plain PyTorch version on the card.
               The observation kernel, ``torch.equal``, on seeded states
               stepped a few times: the flagship shape (E=4096, N=4, 16x16,
               view 7; see through walls off and on; packed and images),
               view sizes 3-13, 1, 2 and 8 agents, a 13x25 grid, doors
               (open, closed, locked), keys, balls, boxes, agents at the
               borders, terminated and carrying. The training kernels in
               bf16, each with its tolerance: the first layer (B=16384,
               C=49, H=128; C 9/25/169, H 32/256, a ragged batch, pad
               cells), its weight gradient (B=262144 and small shapes) and
               the PPO loss (B=262144, and B=256 with 0 and 5 missions).
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
8. train    — PPO on the flagship with packed observations, mlp 128, T 16:
               3 updates through the fused loss kernel (17 first-layer
               launches and 1 loss launch an update, no gradient kernel);
               from the same state and generator states, 3 updates with the
               kernel's gate off (autograd; the gradient kernel once per SGD
               step), whose metrics must track the first run's; one update
               of 2 epochs x 4 minibatches. Launch counts are set to 0
               before each run and read after it; all metrics finite.
9. train timing — trained agent-steps/s by length differencing (median
               of 3 pairs of 1 and 4 updates), the rollout, GAE and SGD
               phases, peak memory, and each training kernel's time at the
               path's shapes on a rollout's data beside its bound, its plain
               version and a library call.
10. train breakdown — one update under ``torch.profiler``: the device's
               busy share and the kernels that take its time.

Products in float32 run in full float32 (TF32 off) for the plain versions.
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
TENSOR_OPS_PER_S = 989e12  # bf16 dense, tensor cores

E, N, SIZE, VS = 4096, 4, 16, 7
STEPS = 256
#: The trained flagship: mlp 128 on packed cells, T 16 (scripts/measure_train.py:25-36).
TRAIN_T, HIDDEN, C = 16, 128, VS * VS
SOURCES = ('obs.cu', 'fused_linear.cu', 'fused_ppo.cu')


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


def event_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls, CUDA events."""
    import torch
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


def bound(nbytes, vector_ops=0, tensor_ops=0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rates."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (vector_ops / VECTOR_OPS_PER_S + tensor_ops / TENSOR_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


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
    from multigrid_tpu_torch.utils import build
    t0 = time.perf_counter()
    build.build(list(SOURCES))
    print(f'built {", ".join(SOURCES)} in {time.perf_counter() - t0:.2f} s '
          '(one nvcc each, in parallel)')
    for src in SOURCES:
        print(f'  {src}:')
        for line in build.build_log(src).splitlines():
            if 'Compiling entry' in line:
                print('    ' + line.split("'")[1][:100])
            elif 'registers' in line or 'spill' in line or 'error' in line.lower():
                print('      ' + line.strip())


def obs_cases(device):
    """Obs kernel ≡ plain on every case; returns the largest abs difference."""
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


# ------------------------------------------------------------ training

def random_cells(rng, b, c, device, pad=0.0):
    """Packed cells using every channel; a share ``pad`` of them the pad
    value, which matches no channel."""
    import numpy as np
    import torch

    from multigrid_tpu_torch.ops.fused_linear import PAD_CELL
    cells = (rng.integers(0, 11, (b, c)) << 8) | (rng.integers(0, 6, (b, c)) << 4) \
        | rng.integers(0, 4, (b, c))
    cells = np.where(rng.random((b, c)) < pad, PAD_CELL, cells)
    return torch.as_tensor(cells.astype(np.int32), device=device)


def ppo_inputs(rng, b, c, h, missions, device):
    """Random ``ppo_mlp_grads`` arguments: lecun-scaled params, cells,
    direction (and mission) features, actions, old log-probs near the
    policy's, normalized advantages and targets."""
    import numpy as np
    import torch

    from multigrid_tpu_torch.learn.nets import PARAM_NAMES
    f = 2 + missions
    shapes = [(c * 21, h), (f, h), (h,), (h, h), (h,), (h, 7), (7,), (h, 1), (1,)]
    params = {k: torch.as_tensor((rng.normal(size=s) / np.sqrt(s[0] if len(s) > 1 else 4))
                                 .astype(np.float32), device=device)
              for k, s in zip(PARAM_NAMES, shapes)}
    theta = rng.integers(0, 4, b) * np.pi / 2
    dirf = np.stack([np.cos(theta), np.sin(theta)], -1)
    if missions:
        dirf = np.concatenate([dirf, np.eye(missions)[rng.integers(0, missions, b)]], -1)
    adv = rng.normal(size=b)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    args = [random_cells(rng, b, c, device), dirf.astype(np.float32),
            rng.integers(0, 7, b).astype(np.int32),
            (np.log(1 / 7) + 0.3 * rng.normal(size=b)).astype(np.float32),
            adv.astype(np.float32), rng.normal(size=b).astype(np.float32)]
    return params, [torch.as_tensor(a, device=device) for a in args]


def train_kernel_cases(device):
    """The three training kernels against their plain versions on the card,
    in the working dtype (bf16 operands). Returns each kernel's largest
    error, in the measure its tolerance uses."""
    import numpy as np
    import torch

    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_ppo

    rng = np.random.default_rng(30)
    errs = {}  # kernel -> [max abs error, max error in the tolerance's measure]

    def check(kernel, label, abs_err, err, tol):
        e = errs.setdefault(kernel, [0.0, 0.0])
        e[0], e[1] = max(e[0], abs_err), max(e[1], err)
        print(f'  {"ok  " if err < tol else "FAIL"} {kernel} {label} max_abs_err={abs_err:.3e} '
              f'err={err:.3e} (< {tol})')
        if not err < tol:
            fail(f'{kernel} differs from its plain version: {label}')

    # B2: max|got - want| / (|want| + 1) < 2e-2 (bench.py:54-55): bf16
    # outputs of f32 sums taken in other orders.
    for b, c, h, pad in [(E * N, C, HIDDEN, 0.0), (E * N, C, HIDDEN, 0.1), (4096, 9, 128, 0.0),
                         (4096, 25, 128, 0.0), (1024, 169, 128, 0.05), (E * N, C, 32, 0.0),
                         (E * N, C, 256, 0.0), (1001, C, HIDDEN, 0.1)]:
        packed = random_cells(rng, b, c, device, pad)
        w = torch.as_tensor(rng.normal(size=(c * 21, h)).astype(np.float32), device=device)
        got = fl.onehot_linear_forward(packed, w)
        want = fl.onehot_linear_plain(packed, w)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float((diff / (want.float().abs() + 1)).max())
        check('onehot_linear', f'B={b} C={c} H={h} pad={pad}', float(diff.max()), err, 2e-2)
    # B3: f32 sums of the same bf16 values in other orders, against the
    # largest entry; and the same result from run to run.
    for b, c, h in [(E * N * TRAIN_T, C, HIDDEN), (E * N, C, HIDDEN), (1001, 9, 32),
                    (3000, 25, 256), (500, 169, 64)]:
        packed = random_cells(rng, b, c, device, 0.05)
        g = torch.as_tensor(rng.normal(size=(b, h)).astype(np.float32), device=device)
        got = fl.onehot_linear_grad_w(packed, g)
        want = fl.onehot_linear_grad_w_plain(packed, g)
        again = fl.onehot_linear_grad_w(packed, g)
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        err = abs_err / (float(want.abs().max()) + 1)
        check('onehot_linear_grad', f'B={b} C={c} H={h}', abs_err, err, 1e-4)
        if not torch.equal(got, again):
            fail(f'onehot_linear_grad differs from run to run at B={b}')
    # B4: per leaf max|g - r| / (max|r| + 1e-6) < 5e-2 (bench.py:85-90),
    # and the metrics likewise.
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)
    for b, missions in [(E * N * TRAIN_T, 0), (256, 0), (256, 5)]:
        params, args = ppo_inputs(rng, b, C, HIDDEN, missions, device)
        grads, metrics = fused_ppo.ppo_mlp_grads(params, *args, **kw)
        want_g, want_m = fused_ppo.ppo_mlp_grads_plain(
            params, *args, compute_dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        abs_err = max(float((grads[k] - want_g[k]).abs().max()) for k in want_g)
        err = max(float((grads[k] - want_g[k]).abs().max()) / (float(want_g[k].abs().max()) + 1e-6)
                  for k in want_g)
        err = max([err] + [abs(float(metrics[k]) - float(want_m[k])) / (abs(float(want_m[k])) + 1e-6)
                           for k in want_m])
        check('ppo_loss', f'B={b} missions={missions}', abs_err, err, 5e-2)
    return errs


def _counts():
    from multigrid_tpu_torch.ops import fused_linear, fused_ppo, obs_cuda
    return {'obs': obs_cuda.launches, 'onehot_linear': fused_linear.launches,
            'onehot_linear_grad': fused_linear.grad_launches, 'ppo_loss': fused_ppo.launches}


def _zero_counts():
    from multigrid_tpu_torch.ops import fused_linear, fused_ppo, obs_cuda
    obs_cuda.launches = fused_linear.launches = fused_linear.grad_launches = 0
    fused_ppo.launches = 0


def _run(step, state, updates):
    import torch
    rows = []
    for _ in range(updates):
        state, metrics = step(state)
        rows.append({k: float(v) for k, v in metrics.items()})
    torch.cuda.synchronize()
    return state, rows


def _check_finite(rows, label):
    import math
    for row in rows:
        for k, v in row.items():
            no_episode = k in ('episode_reward', 'success_rate') and row['episodes_in_batch'] == 0
            if not (math.isfinite(v) or (no_episode and math.isnan(v))):
                fail(f'{label}: {k} = {v}')


def train_path(device=None):
    """PPO on the flagship with the learner's two paths and minibatches.
    Each path runs with the launch counts set to 0 just before it."""
    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.ops import fused_ppo

    venv = VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=N, device=device), E,
                     packed_obs=True)
    if device is None and venv.device.type != 'cuda':
        fail(f'default device is {venv.device}, not cuda')
    state, net, config, tx = ppo_init(venv, 0, config=PPOConfig(rollout_steps=TRAIN_T),
                                      hidden=HIDDEN)
    step = make_train_step(venv, net, config, tx)
    state, _ = _run(step, state, 1)  # warm-up: first launches, cuBLAS handles
    snapshot = (state, state.generator.get_state(), venv.generator.get_state())
    per_update = TRAIN_T + 1

    _zero_counts()
    state_b4, rows_b4 = _run(step, state, 3)
    counts = _counts()
    print(f'3 updates, fused loss kernel: launches {counts}')
    want = {'obs': 3 * TRAIN_T, 'onehot_linear': 3 * per_update, 'onehot_linear_grad': 0,
            'ppo_loss': 3}
    if counts != want:
        fail(f'expected launches {want}, got {counts}')
    _check_finite(rows_b4, 'fused loss path')

    # The learner with the kernel's gate off: autograd of the loss, whose
    # first layer's dW is the gradient kernel, from the same state and the
    # same generator states.
    state, g_state, venv_g_state = snapshot
    state.generator.set_state(g_state)
    venv.generator.set_state(venv_g_state)
    gate = fused_ppo.supports
    fused_ppo.supports = lambda *a: False
    try:
        step_off = make_train_step(venv, net, config, tx)
    finally:
        fused_ppo.supports = gate
    _zero_counts()
    _, rows_off = _run(step_off, state, 3)
    counts_off = _counts()
    print(f'3 updates, autograd learner: launches {counts_off}')
    want = {'obs': 3 * TRAIN_T, 'onehot_linear': 3 * (per_update + 1),
            'onehot_linear_grad': 3, 'ppo_loss': 0}
    if counts_off != want:
        fail(f'expected launches {want}, got {counts_off}')
    _check_finite(rows_off, 'autograd learner path')
    # rtol 0.05, atol 5e-3, as tests/test_fused_ppo.py:140-147.
    for i, (a, b) in enumerate(zip(rows_b4, rows_off)):
        print(f'  update {i + 1}: ' + ', '.join(
            f'{k} {a[k]:.6f}/{b[k]:.6f}' for k in ('loss', 'pg_loss', 'vf_loss', 'entropy')))
        for k in ('loss', 'pg_loss', 'vf_loss', 'entropy'):
            if abs(a[k] - b[k]) > 5e-3 + 0.05 * abs(b[k]):
                fail(f'update {i + 1}: {k} {a[k]} (fused) vs {b[k]} (autograd)')

    step_mb = make_train_step(venv, net, config.replace(epochs=2, minibatches=4), tx)
    _zero_counts()
    state_b4, rows_mb = _run(step_mb, state_b4, 1)
    counts_mb = _counts()
    print(f'1 update, 2 epochs x 4 minibatches: launches {counts_mb}, '
          f'loss {rows_mb[0]["loss"]:.6f}')
    if counts_mb['ppo_loss'] != 8 or counts_mb['onehot_linear'] != per_update:
        fail(f'minibatch update launched {counts_mb}')
    _check_finite(rows_mb, 'minibatch update')
    print('metrics of the last fused update: ' + json.dumps(rows_b4[-1]))
    return venv, step, state_b4, counts, counts_off


def train_timing(venv, step, state):
    """Trained agent-steps/s, the phases of an update, each training
    kernel's time against its bound, plain version and library call, and
    the peak memory."""
    import statistics

    import torch
    import torch.nn.functional as F

    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_ppo

    samples = E * N * TRAIN_T
    short, long_ = 1, 4
    rates, pairs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = _run(step, state, short)
        t1 = time.perf_counter()
        state, _ = _run(step, state, long_)
        t2 = time.perf_counter()
        pairs.append((t1 - t0, t2 - t1))
        rates.append(samples * (long_ - short) / ((t2 - t1) - (t1 - t0)))
    print('pairs (short s, long s, trained agent-steps/s): ' + '; '.join(
        f'{a:.6f}, {b:.6f}, {r:.6e}' for (a, b), r in zip(pairs, rates)))
    rate = statistics.median(rates)
    print(f'trained agent-steps/s (median of 3, length-differenced {short}/{long_} '
          f'updates): {rate:.6e} ({samples / rate * 1e3:.4f} ms/update)')

    phases = {'rollout': 0.0, 'gae': 0.0, 'sgd': 0.0}
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, traj, last_value, _ = step.rollout_phase(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        adv, tg = step.compute_gae(traj, last_value)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params, opt, _ = step.sgd_step(state.params, state.opt_state, traj, adv, tg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        state = state.replace(params=params, opt_state=opt)
        phases['rollout'] += t1 - t0
        phases['gae'] += t2 - t1
        phases['sgd'] += t3 - t2
    peak = torch.cuda.max_memory_allocated()
    print('per-update host time by phase (synchronized): ' + ', '.join(
        f'{k} {v / reps * 1e3:.4f} ms' for k, v in phases.items())
        + f'; peak memory {peak / 2**30:.4f} GiB')

    # The kernels at the path's shapes, on this rollout's data.
    counts = _counts()
    b16, h = E * N, HIDDEN
    w = state.params['img_kernel']
    packed16 = traj.image[0].reshape(b16, C).contiguous()
    args = step.kernel_inputs(traj, adv, tg)
    packed = args[0]
    g = (torch.randn(samples, h, device=w.device) * 1e-3).to(torch.bfloat16)
    kw = dict(clip_eps=step.config.clip_eps, vf_coef=step.config.vf_coef,
              ent_coef=step.config.ent_coef, num_actions=7)

    def fields(p):
        t, col, st = p >> 8, (p >> 4) & 15, p & 15
        valid = [(t >= 0) & (t < 11), col < 6, st < 4]
        rows = torch.stack([t, 11 + col, 17 + st], -1) \
            + 21 * torch.arange(p.shape[1], device=p.device)[:, None]
        # Out-of-range fields (none in these observations) would index a
        # real row here: the library call is only a yardstick of time.
        return (int(sum(v.sum() for v in valid)),
                rows.reshape(p.shape[0], -1).clamp(0, 21 * C - 1).long())

    nnz16, idx16 = fields(packed16)
    nnz, idx = fields(packed)
    out = {}
    ms = event_ms(lambda: fl.onehot_linear_forward(packed16, w), 100)
    plain = event_ms(lambda: fl.onehot_linear_plain(packed16, w), 10)
    lib = event_ms(lambda: F.embedding_bag(idx16, w, mode='sum'), 100)
    bd = bound(packed16.numel() * 4 + w.numel() * 4 + b16 * h * 2, vector_ops=nnz16 * h)
    out['onehot_linear'] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bd[0], bound_by=bd[1])

    ms = event_ms(lambda: fl.onehot_linear_grad_w(packed, g), 20)
    plain = event_ms(lambda: fl.onehot_linear_grad_w_plain(packed, g), 5)
    wl = w.detach().clone().requires_grad_(True)
    emb = F.embedding_bag(idx, wl, mode='sum')
    g32 = g.float()
    lib = event_ms(lambda: torch.autograd.grad(emb, wl, g32, retain_graph=True), 20)
    bd = bound(packed.numel() * 4 + g.numel() * 2 + w.numel() * 4, vector_ops=nnz * h)
    out['onehot_linear_grad'] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bd[0],
                                     bound_by=bd[1])

    p = state.params
    ms = event_ms(lambda: fused_ppo.ppo_mlp_grads(p, *args, **kw), 10)
    plain = event_ms(lambda: fused_ppo.ppo_mlp_grads_plain(
        p, *args, compute_dtype=torch.bfloat16, **kw), 3)
    f1 = args[1].shape[1] + 1
    param_bytes = sum(v.numel() * 4 for v in p.values())
    in_bytes = sum(a.numel() * a.element_size() for a in args) + param_bytes
    dense = 2 * samples * (2 * f1 * h + 3 * h * h + 3 * h * 8)
    bd = bound(in_bytes + param_bytes, vector_ops=2 * nnz * h, tensor_ops=dense)
    out['ppo_loss'] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bd[0],
                           bound_by=bd[1])
    fl.launches, fl.grad_launches, fused_ppo.launches = (
        counts['onehot_linear'], counts['onehot_linear_grad'], counts['ppo_loss'])
    for name, r in out.items():
        lib = 'none' if r['library_ms'] is None else f'{r["library_ms"]:.6f} ms'
        print(f'{name}: {r["ms"]:.6f} ms/launch; plain {r["plain_ms"]:.6f} ms; library {lib}; '
              f'bound {r["bound_ms"]:.6f} ms by {r["bound_by"]}; {r["bound_ms"] / r["ms"]:.4f} '
              'of the bound')
    return state, dict(rate=rate, kernels=out)


def train_breakdown(step, state, steps=8):
    """Where a rollout step's host time goes (each layer synchronized), then
    where an update's device time goes, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multigrid_tpu_torch.learn.ppo import _select_log_prob, gumbel_noise, sample_actions

    venv, params, obs, env_state = step.venv, state.params, state.last_obs, state.env_state
    layers = {'policy forward': 0.0, 'sampling': 0.0, 'env step': 0.0}
    with torch.no_grad():
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, value = step.policy(params, obs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            action = sample_actions(logits, gumbel_noise(logits.shape, state.generator,
                                                         venv.device))
            _select_log_prob(logits, action)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            obs, env_state, *_ = venv.step(env_state, action)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            layers['policy forward'] += t1 - t0
            layers['sampling'] += t2 - t1
            layers['env step'] += t3 - t2
    print('per-rollout-step host time by layer (synchronized): ' + ', '.join(
        f'{k} {v / steps * 1e3:.4f} ms' for k, v in layers.items()))
    state = state.replace(last_obs=obs, env_state=env_state)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print('device busy share: not measured (the profiler saw no device time)')
        return state
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f'profiled update: wall {wall_ms:.4f} ms, device busy {busy_ms:.4f} ms '
          f'({busy_ms / wall_ms:.4f} of the wall time), {len(kernels)} device kernels')
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f'  {us / 1e3:9.4f} ms  {name[:90]}')
    return state


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
    # Full float32 products for the plain versions the kernels are held to.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase('card')
    card_info()
    phase('build')
    build_kernels()
    phase('kernels')
    obs_err = obs_cases(device)
    errs = train_kernel_cases(device)
    phase('main')
    venv, obs, state, summary, launches = main_path()
    phase('check')
    check_outputs(venv, obs, state, summary)
    phase('timing')
    t = timing(venv, state)
    phase('breakdown')
    breakdown(venv, state)
    phase('train')
    tvenv, step, tstate, counts, counts_off = train_path()
    phase('train timing')
    tstate, tt = train_timing(tvenv, step, tstate)
    phase('train breakdown')
    train_breakdown(step, tstate)
    print(f'total {time.perf_counter() - t_start:.1f} s')

    kernels = [dict(name='obs', route='cuda', source='multigrid_tpu_torch/csrc/obs.cu',
                    replaces='multigrid_tpu/ops/obs_pallas.py:176', launches=launches,
                    max_abs_err=obs_err, equal=obs_err == 0, ms=t['ms'],
                    plain_ms=t['plain_ms'], bound_ms=t['bound_ms'], bound_by=t['bound_by'],
                    library_ms=None)]
    for name, replaces, src, n in [
            ('onehot_linear', 'multigrid_tpu/ops/fused_linear.py:133', 'fused_linear.cu',
             counts['onehot_linear']),
            ('onehot_linear_grad', 'multigrid_tpu/ops/fused_linear.py:213', 'fused_linear.cu',
             counts_off['onehot_linear_grad']),
            ('ppo_loss', 'multigrid_tpu/ops/fused_ppo.py:67', 'fused_ppo.cu',
             counts['ppo_loss'])]:
        kernels.append(dict(name=name, route='cuda', source=f'multigrid_tpu_torch/csrc/{src}',
                            replaces=replaces, launches=n, max_abs_err=errs[name][0],
                            max_rel_err=errs[name][1],
                            **tt['kernels'][name]))
    kernels[2]['launches_path'] = 'train, learner gate off (autograd)'
    print(json.dumps({'kernels': kernels, 'trained_agent_steps_per_s': tt['rate']}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
