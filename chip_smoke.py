#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card     — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build    — builds the four CUDA sources of ``multigrid_tpu_torch/csrc``
               (one nvcc each, in parallel), prints registers and spills,
               and the tensor-core instructions in each kernel's SASS
               (cuobjdump; B2, B3 and B4 must have some).
3. kernels  — each kernel against its plain PyTorch version on the card.
               The observation kernel, ``torch.equal``, on seeded states
               stepped a few times: the flagship shape (E=4096, N=4, 16x16,
               view 7; see through walls off and on; packed and images),
               view sizes 3-13, 1, 2 and 8 agents, a 13x25 grid, doors
               (open, closed, locked), keys, balls, boxes, agents at the
               borders, terminated and carrying. The training kernels in
               bf16, each with its tolerance: the first layer (B=16384,
               C=49, H=128; the per-agent (4096, 49) and critic (4096, 196)
               shapes; C 9/25/169, H 32/100/256, a ragged batch, pad
               cells), its weight gradient (B=262144, the critic's
               (65536, 196) and small shapes; equal from run to run), the
               PPO loss (B=262144 and 65536, B=256 with 0 and 5 missions, a
               ragged B=1001; equal from run to run), and
               the fused rollout policy (B=16384; C 9/25, H 32/256, F 2/14,
               a ragged batch; a constructed tie takes the first index).
4. main     — ``VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=4), 4096)``
               on the default device: reset, then ``rollout_random`` for 256
               steps, with the kernel's launch count set to 0 just before and
               read just after (one launch per step, one for the reset).
5. check    — the outputs: finite, the expected shapes, valid states, the
               kernel equal to the plain version on the rollout's final
               state, and two recorded reference traces
               (``tests/golden``) replayed bit-exactly on the card.
6. timing   — agent-steps/s by length differencing (median of short/long
               rollout pairs, synchronized), and the obs kernel at the
               flagship as images and as packed cells: its launches alone
               (CUDA events), the profiler's kernel time and the wrapper's
               whole call, each against its bound (bytes over 3.35 TB/s),
               and the plain version's time.
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
               path's shapes on a rollout's data beside its bound (the
               one-hot part the lesser of the sparse adds and the dense
               product, both printed), its plain version and a library
               call; B2 and B3 also at the per-agent and critic shapes, B4
               also at 65,536 samples, and B4's stages apart (torch.profiler).
10. train breakdown — one update under ``torch.profiler``: the device's
               busy share and the kernels that take its time.
11. variants — the same flagship through each learner variant, launch
               counts set to 0 before each run and checked exactly after
               it: the fully fused rollout policy (``MULTIGRID_FUSED_POLICY``;
               its metrics track the default path's over 3 updates, and
               under 2% of the first rollout step's actions differ), per-agent
               policies on the loss kernel and with its gate off (metrics
               tracking), and the centralized critic with a shared and with
               per-agent actors (actor and critic parameters move).
12. variant timing — each variant's trained agent-steps/s beside the
               default path's, the rollout step's layers with and without the
               fused policy, and the fused policy's kernel time at B=16384
               beside its bound and plain version.

``python3 chip_smoke.py --kernel-times`` builds the kernels and only times
B1 (images and packed), B2, B3 (flagship, per-agent and critic shapes), B4
(with its stages) and B5 on seeded inputs, for comparing two trees in
turns within one call (copy the script into the other tree).

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
SOURCES = ('obs.cu', 'fused_linear.cu', 'fused_ppo.cu', 'fused_policy.cu')
#: B3's kernels in the profiler: the product and the sum of its partials.
GRAD_KERNELS = ('onehot_grad_kernel', 'sum_partials_kernel')


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


def bound(nbytes, vector_ops=0, tensor_ops=0, ops_ms=0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rates (plus ``ops_ms`` of operations
    already reckoned, see :func:`onehot_ms`)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms += (vector_ops / VECTOR_OPS_PER_S + tensor_ops / TENSOR_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


def onehot_ms(nnz, b, c, h, label):
    """The least time of one one-hot product one_hot(packed) @ W (or its
    transpose) over b samples of c cells and h columns, in ms: the lesser of
    its ``nnz`` · h adds on the CUDA cores (the sparse form) and the dense
    2·b·c·21·h on the tensor cores, so the bound reads the same work
    whatever implements it. Prints both."""
    sparse = nnz * h / VECTOR_OPS_PER_S * 1e3
    dense = 2 * b * c * 21 * h / TENSOR_OPS_PER_S * 1e3
    print(f'  {label} one-hot part: sparse {sparse:.6f} ms ({nnz * h} adds), dense '
          f'{dense:.6f} ms ({2 * b * c * 21 * h} ops); the lesser counts')
    return min(sparse, dense)


def nonzeros(packed):
    """The one-hot's ones in these packed cells: fields in their channel's
    range."""
    t, col, st = packed >> 8, (packed >> 4) & 15, packed & 15
    return int(((t >= 0) & (t < 11)).sum() + (col < 6).sum() + (st < 4).sum())


def onehot_launch_ms(packed, w, reps=200):
    """CUDA-event time of the first-layer kernel's launches alone, without
    the wrapper's weight cast and checks: the kernel takes less time than
    the wrapper's host work, which event timing of whole calls measures."""
    import torch

    from multigrid_tpu_torch.ops import fused_linear as fl
    b, c = packed.shape
    h = w.shape[1]
    wb = fl.pad_columns(w.detach().to(torch.bfloat16)).contiguous()
    out = torch.empty((b, h), dtype=torch.bfloat16, device=packed.device)
    fn = fl._lib_fn('mgt_onehot_linear_launch', 3, 4)
    args = (packed.data_ptr(), wb.data_ptr(), out.data_ptr(), b, c, h, wb.shape[1],
            torch.cuda.current_stream().cuda_stream)

    def launch():
        if fn(*args):
            fail('onehot_linear kernel launch failed')
    return event_ms(launch, reps)


def obs_launch_ms(state, vs, stw, packed, reps=200):
    """CUDA-event time of the observation kernel's launches alone, without
    the wrapper's checks and allocation, as for B2."""
    import torch

    from multigrid_tpu_torch.ops import obs_cuda
    e, w, h, _ = state.grid.shape
    n = state.agent_dir.shape[-1]
    out = torch.empty((e, n, vs * vs) if packed else (e, n, vs, vs, 3), dtype=torch.int32,
                      device=state.grid.device)
    fn = obs_cuda._launch_fn()
    args = (state.grid.data_ptr(), state.agent_pos.data_ptr(), state.agent_dir.data_ptr(),
            state.agent_color.data_ptr(), state.agent_terminated.data_ptr(),
            state.agent_carrying.data_ptr(), out.data_ptr(), e, n, w, h, vs, int(stw),
            int(packed), torch.cuda.current_stream().cuda_stream)

    def launch():
        if fn(*args):
            fail('obs kernel launch failed')
    return event_ms(launch, reps)


def obs_bound(state, vs, packed):
    """(bound_ms, bound_by, bytes, ops) of the observation kernel: its
    inputs read once and its output (4-byte packed cells, or 3 int32 a
    cell) written once, against about 28 integer operations an output cell
    (crop, rotation, mask, two fill passes) and 4 a grid cell (packing)."""
    e, n = state.agent_dir.shape
    n_cells = e * n * vs * vs
    read = (state.grid.numel() * 4 + state.agent_pos.numel() * 4
            + state.agent_dir.numel() * 4 + state.agent_color.numel() * 4
            + state.agent_terminated.numel() + state.agent_carrying.numel() * 4)
    written = n_cells * (1 if packed else 3) * 4
    ops = n_cells * (16 + 12) + state.grid.numel() // 3 * 4
    return (*bound(read + written, vector_ops=ops), read + written, ops)


def obs_times(state, label, packed, call_reps=200):
    """The observation kernel at the flagship (view 7, see-through-walls
    off): its launches alone (CUDA events), the profiler's kernel time and
    the wrapper's whole call, beside its bound. Launch counts unchanged."""
    from multigrid_tpu_torch.ops import obs_cuda
    launches = obs_cuda.launches
    ms = obs_launch_ms(state, VS, False, packed)
    dev_ms = kernel_device_ms(lambda: obs_cuda.gen_obs_batched(state, VS, False, packed),
                              'obs_kernel')
    call_ms = event_ms(lambda: obs_cuda.gen_obs_batched(state, VS, False, packed), call_reps)
    obs_cuda.launches = launches
    bd, by, nbytes, ops = obs_bound(state, VS, packed)
    print(f'obs kernel {label}: launches {ms:.6f} ms, the kernel {dev_ms} ms '
          f'(torch.profiler), the wrapper\'s call {call_ms:.6f} ms; bound {bd:.6f} ms by {by} '
          f'({nbytes} bytes, {ops} ops); {bd / ms:.4f} of the bound')
    return dict(ms=ms, profiler_ms=dev_ms, call_ms=call_ms, bound_ms=bd, bound_by=by)


def kernel_device_ms(fn, name, reps=20):
    """Device time in ms of the kernels whose names hold ``name`` (a string,
    or a tuple of strings) in one call of ``fn``, from torch.profiler (None
    where it sees no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (name,) if isinstance(name, str) else name
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(n in e.name for n in names)]
    return sum(us) / 1e3 / reps if us else None


def ppo_stages(fn, reps=5):
    """Device time in ms of each stage of a loss-kernel call ``fn``, from
    torch.profiler: the loss kernel (and a first-layer pre-pass where there
    is one), the sum of its partials, B3 on dx1 and B3's partial sum, and
    the rest (casts and fills)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    stages, last = {}, None
    for e in events:
        key = next((k for name, k in (('first_layer_kernel', 'first-layer pre-pass'),
                                      ('ppo_loss_kernel', 'loss kernel'),
                                      ('onehot_grad_kernel', 'B3 on dx1')) if name in e.name), None)
        if key is not None:
            last = key
        elif 'sum_partials' in e.name and last in ('loss kernel', 'B3 on dx1'):
            key = 'partial sum' if last == 'loss kernel' else 'B3 partial sum'
        else:
            key = 'other'
        stages[key] = stages.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    if not events:
        print('  stages: not measured (the profiler saw no device time)')
    return stages


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


def sass_tensor_ops():
    """{kernel: tensor-core instructions in the SASS of all its builds};
    fails unless B2, B3 and B4's loss kernel have some. Printed on one line."""
    from multigrid_tpu_torch.utils import build
    names = {'obs.cu': [('obs', 'obs')],
             'fused_linear.cu': [('onehot_linear', 'onehot_linear'),
                                 ('onehot_linear_grad', 'onehot_grad')],
             'fused_ppo.cu': [('ppo_loss', 'ppo_loss')],
             'fused_policy.cu': [('policy_sample', 'policy_sample')]}
    found = {k: set() for ks in names.values() for k, _ in ks}
    for src, kernels in names.items():
        for fn, ops in build.tensor_core_ops(src).items():
            for k, stem in kernels:
                if f'{stem}_kernel' in fn:
                    found[k].update(ops)
    found = {k: sorted(v) for k, v in found.items()}
    print('tensor-core instructions in the SASS (cuobjdump): ' + '; '.join(
        f'{k}: {" ".join(v) or "none"}' for k, v in found.items()))
    for k in ('onehot_linear', 'onehot_linear_grad', 'ppo_loss'):
        if not found[k]:
            fail(f'no tensor-core instruction in the SASS of the {k} kernel')
    return found


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

    plain_ms = event_ms(lambda: gen_obs_batched_plain(state, VS, False), 20)
    img = obs_times(state, f'images ({E}, {N}, {VS}, {VS}, 3)', False)
    pk = obs_times(state, f'packed ({E}, {N}, {VS * VS})', True)
    print(f'obs plain version {plain_ms:.6f} ms')
    return dict(rate=rate, step_ms=step_ms, ms=img['ms'], plain_ms=plain_ms,
                bound_ms=img['bound_ms'], bound_by=img['bound_by'],
                call_ms=img['call_ms'], profiler_ms=img['profiler_ms'], packed=pk)


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
                         (E * N, C, 256, 0.0), (1001, C, HIDDEN, 0.1),
                         # per-agent and critic shapes, and an odd width
                         (E, C, HIDDEN, 0.0), (E, N * C, HIDDEN, 0.0), (E, N * C, 100, 0.05)]:
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
    for b, c, h in [(E * N * TRAIN_T, C, HIDDEN), (E * TRAIN_T, N * C, HIDDEN),
                    (E * N, C, HIDDEN), (1001, 9, 32), (3000, 25, 256), (500, 169, 64),
                    (1, C, HIDDEN), (255, 196, 256)]:
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
    for b, missions in [(E * N * TRAIN_T, 0), (E * TRAIN_T, 0), (256, 0), (256, 5), (1001, 3)]:
        params, args = ppo_inputs(rng, b, C, HIDDEN, missions, device)
        grads, metrics = fused_ppo.ppo_mlp_grads(params, *args, **kw)
        want_g, want_m = fused_ppo.ppo_mlp_grads_plain(
            params, *args, compute_dtype=torch.bfloat16, **kw)
        again, again_m = fused_ppo.ppo_mlp_grads(params, *args, **kw)
        torch.cuda.synchronize()
        if not (all(torch.equal(grads[k], again[k]) for k in grads)
                and all(torch.equal(metrics[k], again_m[k]) for k in metrics)):
            fail(f'ppo_loss differs from run to run at B={b}')
        abs_err = max(float((grads[k] - want_g[k]).abs().max()) for k in want_g)
        err = max(float((grads[k] - want_g[k]).abs().max()) / (float(want_g[k].abs().max()) + 1e-6)
                  for k in want_g)
        err = max([err] + [abs(float(metrics[k]) - float(want_m[k])) / (abs(float(want_m[k])) + 1e-6)
                           for k in want_m])
        check('ppo_loss', f'B={b} missions={missions} (equal from run to run)', abs_err, err,
              5e-2)
    return errs


def policy_kernel_cases(device):
    """The fused rollout policy against its bf16 plain version: actions
    equal on every row whose plain top-two perturbed logits are more than
    1e-3 apart (bf16 roundings of sums taken in other orders may flip a
    nearer tie), log-probs where the actions agree and values within
    2e-2·(|want| + 1); and the first index on a constructed tie. Returns
    the largest abs error and the largest error in the tolerance's measure."""
    import numpy as np
    import torch

    from multigrid_tpu_torch.ops import fused_policy as fp

    rng = np.random.default_rng(31)
    worst = [0.0, 0.0]

    def inputs(b, c, h, f, pad):
        params, args = ppo_inputs(rng, b, c, h, f - 2, device)
        gumbel = torch.as_tensor(rng.gumbel(size=(b, 7)).astype(np.float32), device=device)
        return fp.prepare(params), random_cells(rng, b, c, device, pad), args[1], gumbel

    for b, c, h, f, pad in [(E * N, C, HIDDEN, 2, 0.0), (4096, 9, 128, 2, 0.0),
                            (4096, 25, 32, 14, 0.05), (2048, C, 256, 2, 0.0),
                            (1001, 25, 256, 14, 0.1), (777, 9, 64, 5, 0.0)]:
        w, packed, dirf, gumbel = inputs(b, c, h, f, pad)
        action, logp, value = fp.policy_sample_prepared(w, packed, dirf, gumbel)
        want_a, want_lp, want_v = fp.policy_sample_plain(w, packed, dirf, gumbel,
                                                         compute_dtype=torch.bfloat16)
        logits, _ = fp.policy_heads_plain(w, packed, dirf, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        top2 = (logits + gumbel).topk(2, -1).values
        near = (top2[:, 0] - top2[:, 1]) <= 1e-3
        same = action == want_a
        d_lp, d_v = (logp - want_lp).abs()[same], (value - want_v).abs()
        abs_err = max(float(d_lp.max()), float(d_v.max()))
        err = max(float((d_lp / (want_lp.abs()[same] + 1)).max()),
                  float((d_v / (want_v.abs() + 1)).max()))
        worst[0], worst[1] = max(worst[0], abs_err), max(worst[1], err)
        ok = bool((same | near).all()) and err < 2e-2
        print(f'  {"ok  " if ok else "FAIL"} policy_sample B={b} C={c} H={h} F={f} pad={pad}: '
              f'{int(near.sum())} rows with a top-two gap <= 1e-3, {int((~same).sum())} '
              f'actions differ, max_abs_err={abs_err:.3e} err={err:.3e} (< 2e-2)')
        if not ok:
            fail(f'policy_sample differs from its plain version at B={b} C={c} H={h} F={f}')
    # Two identical Wa columns and biases and equal noise, far above the rest.
    w, packed, dirf, gumbel = inputs(4096, C, HIDDEN, 2, 0.0)
    w['wa'][:, 5] = w['wa'][:, 2]
    w['ba'][:] = -30.0
    w['ba'][[2, 5]] = 1.0
    gumbel[:] = 0.0
    gumbel[:, [2, 5]] = 0.25
    action, _, _ = fp.policy_sample_prepared(w, packed, dirf, gumbel)
    torch.cuda.synchronize()
    firsts = int((action == 2).sum())
    print(f'  {"ok  " if firsts == 4096 else "FAIL"} policy_sample tie of actions 2 and 5: '
          f'{firsts} of 4096 rows take 2')
    if firsts != 4096:
        fail('policy_sample does not take the first index on a tie')
    return worst


def _counts():
    from multigrid_tpu_torch.ops import fused_linear, fused_policy, fused_ppo, obs_cuda
    return {'obs': obs_cuda.launches, 'onehot_linear': fused_linear.launches,
            'onehot_linear_grad': fused_linear.grad_launches, 'ppo_loss': fused_ppo.launches,
            'policy_sample': fused_policy.launches}


def _zero_counts():
    from multigrid_tpu_torch.ops import fused_linear, fused_policy, fused_ppo, obs_cuda
    obs_cuda.launches = fused_linear.launches = fused_linear.grad_launches = 0
    fused_ppo.launches = fused_policy.launches = 0


def _set_counts(counts):
    from multigrid_tpu_torch.ops import fused_linear, fused_policy, fused_ppo, obs_cuda
    obs_cuda.launches, fused_linear.launches = counts['obs'], counts['onehot_linear']
    fused_linear.grad_launches, fused_ppo.launches = (counts['onehot_linear_grad'],
                                                      counts['ppo_loss'])
    fused_policy.launches = counts['policy_sample']


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


def _snapshot(step, state):
    """A warmed-up state (one update) and the generators' states."""
    state, _ = _run(step, state, 1)
    return state, state.generator.get_state(), step.venv.generator.get_state()


def _restore(step, snap):
    state, g, venv_g = snap
    state.generator.set_state(g)
    step.venv.generator.set_state(venv_g)
    return state


def _counted(step, snap, updates, label, **want):
    """``updates`` updates from ``snap``, the launch counts set to 0 just
    before and checked exactly just after against ``want`` (16 obs launches
    an update, 0 of any kernel not named)."""
    state = _restore(step, snap)
    _zero_counts()
    state, rows = _run(step, state, updates)
    counts = _counts()
    want = {**{k: 0 for k in counts}, 'obs': TRAIN_T * updates, **want}
    print(f'{label}, {updates} updates: launches {counts}')
    if counts != want:
        fail(f'{label}: expected launches {want}, got {counts}')
    _check_finite(rows, label)
    return state, rows


def _track(rows, ref, label):
    """``rows``' metrics track ``ref``'s: rtol 0.05, atol 5e-3
    (tests/test_fused_ppo.py:140-147)."""
    for i, (a, b) in enumerate(zip(rows, ref)):
        print(f'  update {i + 1}: ' + ', '.join(
            f'{k} {a[k]:.6f}/{b[k]:.6f}' for k in ('loss', 'pg_loss', 'vf_loss', 'entropy')))
        for k in ('loss', 'pg_loss', 'vf_loss', 'entropy'):
            if abs(a[k] - b[k]) > 5e-3 + 0.05 * abs(b[k]):
                fail(f'{label}, update {i + 1}: {k} {a[k]} vs {b[k]}')


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
    snap = _snapshot(step, state)  # warm-up: first launches, cuBLAS handles
    per_update = TRAIN_T + 1
    state_b4, rows_b4 = _counted(step, snap, 3, 'fused loss kernel',
                                 onehot_linear=3 * per_update, ppo_loss=3)
    counts = _counts()

    # The learner with the kernel's gate off: autograd of the loss, whose
    # first layer's dW is the gradient kernel, from the same state and the
    # same generator states.
    gate = fused_ppo.supports
    fused_ppo.supports = lambda *a: False
    try:
        step_off = make_train_step(venv, net, config, tx)
    finally:
        fused_ppo.supports = gate
    _, rows_off = _counted(step_off, snap, 3, 'autograd learner',
                           onehot_linear=3 * (per_update + 1), onehot_linear_grad=3)
    counts_off = _counts()
    _track(rows_b4, rows_off, 'fused loss kernel vs autograd learner')

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
        rows = torch.stack([t, 11 + col, 17 + st], -1) \
            + 21 * torch.arange(p.shape[1], device=p.device)[:, None]
        # Out-of-range fields (none in these observations) would index a
        # real row here: the library call is only a yardstick of time.
        return nonzeros(p), rows.reshape(p.shape[0], -1).clamp(0, 21 * C - 1).long()

    nnz16, idx16 = fields(packed16)
    nnz, idx = fields(packed)
    out = {}
    ms = onehot_launch_ms(packed16, w)
    call_ms = event_ms(lambda: fl.onehot_linear_forward(packed16, w), 100)
    dev_ms = kernel_device_ms(lambda: fl.onehot_linear_forward(packed16, w),
                              'onehot_linear_kernel')
    print(f'onehot_linear ({b16}, {C}) H={h}: launches {ms:.6f} ms, the wrapper\'s call '
          f'{call_ms:.6f} ms (CUDA events), the kernel {dev_ms} ms (torch.profiler)')
    plain = event_ms(lambda: fl.onehot_linear_plain(packed16, w), 10)
    lib = event_ms(lambda: F.embedding_bag(idx16, w, mode='sum'), 100)
    bd = bound(packed16.numel() * 4 + w.numel() * 4 + b16 * h * 2,
               ops_ms=onehot_ms(nnz16, b16, C, h, 'onehot_linear'))
    # The per-agent (agent 0's cells, as TrainStep.actor copies them) and
    # the critic's shapes (every agent's cells of an env, critic-sized W).
    shapes = {}
    for label, p16, wx in [
            ('per agent', traj.image[0][:, 0].contiguous(), w),
            ('critic', traj.image[0].reshape(E, N * C).contiguous(),
             torch.randn(N * C * 21, h, device=w.device) * 0.05)]:
        t = onehot_launch_ms(p16, wx)
        bx = bound(p16.numel() * 4 + wx.numel() * 4 + p16.shape[0] * h * 2,
                   ops_ms=onehot_ms(nonzeros(p16), *p16.shape, h, f'onehot_linear {label}'))
        shapes[label] = dict(shape=[*p16.shape, h], ms=t, bound_ms=bx[0])
        print(f'onehot_linear {label} {tuple(p16.shape)} H={h}: {t:.6f} ms/launch; bound '
              f'{bx[0]:.6f} ms by {bx[1]}')
    out['onehot_linear'] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bd[0],
                                bound_by=bd[1], call_ms=call_ms, profiler_ms=dev_ms,
                                shapes=shapes)

    ms = event_ms(lambda: fl.onehot_linear_grad_w(packed, g), 20)
    plain = event_ms(lambda: fl.onehot_linear_grad_w_plain(packed, g), 5)
    wl = w.detach().clone().requires_grad_(True)
    emb = F.embedding_bag(idx, wl, mode='sum')
    g32 = g.float()
    lib = event_ms(lambda: torch.autograd.grad(emb, wl, g32, retain_graph=True), 20)
    bd = bound(packed.numel() * 4 + g.numel() * 2 + w.numel() * 4,
               ops_ms=onehot_ms(nnz, samples, C, h, 'onehot_linear_grad'))
    dev_ms = kernel_device_ms(lambda: fl.onehot_linear_grad_w(packed, g), GRAD_KERNELS)
    print(f'onehot_linear_grad ({samples}, {C}) H={h}: {ms:.6f} ms a call (CUDA events), '
          f'the kernel and its partial sum {dev_ms} ms (torch.profiler)')
    # The per-agent (one agent's samples) and the critic's shapes (every
    # agent's cells of an env, one sample an env and step).
    shapes = {}
    for label, px in [('per agent', packed[:samples // N]),
                      ('critic', packed.reshape(-1, N * C))]:
        px = px.contiguous()
        gx = g[:px.shape[0]]
        t = event_ms(lambda: fl.onehot_linear_grad_w(px, gx), 20)
        bx = bound(px.numel() * 4 + gx.numel() * 2 + px.shape[1] * 21 * h * 4,
                   ops_ms=onehot_ms(nonzeros(px), *px.shape, h, f'onehot_linear_grad {label}'))
        shapes[label] = dict(shape=[*px.shape, h], ms=t, bound_ms=bx[0])
        print(f'onehot_linear_grad {label} {tuple(px.shape)} H={h}: {t:.6f} ms a call; bound '
              f'{bx[0]:.6f} ms by {bx[1]}')
    out['onehot_linear_grad'] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bd[0],
                                     bound_by=bd[1], profiler_ms=dev_ms, shapes=shapes)

    p = state.params
    ms = event_ms(lambda: fused_ppo.ppo_mlp_grads(p, *args, **kw), 10)
    plain = event_ms(lambda: fused_ppo.ppo_mlp_grads_plain(
        p, *args, compute_dtype=torch.bfloat16, **kw), 3)
    f1 = args[1].shape[1] + 1
    # Read: the per-sample inputs and the float32 parameters, once; written:
    # the float32 gradients, one per parameter.
    param_bytes = sum(v.numel() * 4 for v in p.values())
    in_bytes = sum(a.numel() * a.element_size() for a in args) + param_bytes
    grad_bytes = param_bytes
    dense = 2 * samples * (2 * f1 * h + 3 * h * h + 3 * h * 8)
    bd = bound(in_bytes + grad_bytes, tensor_ops=dense,
               ops_ms=2 * onehot_ms(nnz, samples, C, h, 'ppo_loss (h and dW_img, each)'))
    stages = ppo_stages(lambda: fused_ppo.ppo_mlp_grads(p, *args, **kw))
    print(f'ppo_loss B={samples} stages (torch.profiler, ms): '
          + ', '.join(f'{k} {v:.6f}' for k, v in stages.items()))
    quarter = [a[:samples // N] for a in args]
    ms_q = event_ms(lambda: fused_ppo.ppo_mlp_grads(p, *quarter, **kw), 10)
    stages_q = ppo_stages(lambda: fused_ppo.ppo_mlp_grads(p, *quarter, **kw))
    print(f'ppo_loss B={samples // N} (per agent): {ms_q:.6f} ms/launch; stages (ms): '
          + ', '.join(f'{k} {v:.6f}' for k, v in stages_q.items()))
    out['ppo_loss'] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bd[0],
                           bound_by=bd[1], stages=stages,
                           per_agent=dict(batch=samples // N, ms=ms_q, stages=stages_q))
    _set_counts(counts)
    for name, r in out.items():
        lib = 'none' if r['library_ms'] is None else f'{r["library_ms"]:.6f} ms'
        print(f'{name}: {r["ms"]:.6f} ms/launch; plain {r["plain_ms"]:.6f} ms; library {lib}; '
              f'bound {r["bound_ms"]:.6f} ms by {r["bound_by"]}; {r["bound_ms"] / r["ms"]:.4f} '
              'of the bound')
    return state, dict(rate=rate, kernels=out)


def rollout_layers(step, state, steps=8):
    """Where a rollout step's host time goes, each layer synchronized: the
    policy step (noise, forward and sampling, through ``step.policy_step``:
    the fused-policy kernel where the step takes it) and the env step."""
    import torch

    venv, params, obs, env_state = step.venv, state.params, state.last_obs, state.env_state
    prepped = step.prepare_policy(params)
    layers = {'policy step': 0.0, 'env step': 0.0}
    with torch.no_grad():
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            action = step.policy_step(params, prepped, obs, state.generator)[0]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            obs, env_state, *_ = venv.step(env_state, action)
            torch.cuda.synchronize()
            layers['policy step'] += t1 - t0
            layers['env step'] += time.perf_counter() - t1
    label = 'fused policy' if prepped is not None else 'default path'
    print(f'per-rollout-step host time by layer, {label} (synchronized): ' + ', '.join(
        f'{k} {v / steps * 1e3:.4f} ms' for k, v in layers.items()))
    return state.replace(last_obs=obs, env_state=env_state)


def train_breakdown(step, state, steps=8):
    """Where a rollout step's host time goes (each layer synchronized), then
    where an update's device time goes, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = rollout_layers(step, state, steps)

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


def variants(device=None):
    """The trained flagship through each learner variant, each from its own
    warmed-up state, with exact launch counts. Returns ``{name: (step,
    snapshot)}`` for the timing and the fused run's launch counts."""
    import torch

    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.ops import fused_ppo

    venv = VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=N, device=device), E,
                     packed_obs=True)
    per_update = TRAIN_T + 1
    out = {}

    # The fully fused rollout policy beside the default path, from one state.
    state, net, config, tx = ppo_init(venv, 0, config=PPOConfig(rollout_steps=TRAIN_T),
                                      hidden=HIDDEN)
    default = make_train_step(venv, net, config, tx)
    os.environ['MULTIGRID_FUSED_POLICY'] = '1'
    try:
        fused = make_train_step(venv, net, config, tx)
    finally:
        del os.environ['MULTIGRID_FUSED_POLICY']
    if not fused.fused_policy or default.fused_policy:
        fail('MULTIGRID_FUSED_POLICY does not select the fused policy at the flagship')
    snap = _snapshot(default, state)
    # The first rollout step's actions from the same observations and noise:
    # they differ only where the top two perturbed logits nearly tie (the
    # kernel keeps f32 logits, the net rounds them to bf16).
    state = _restore(default, snap)
    with torch.no_grad():
        a_fused = fused.policy_step(state.params, fused.prepare_policy(state.params),
                                    state.last_obs, state.generator)[0]
        state = _restore(default, snap)
        a_default = default.policy_step(state.params, None, state.last_obs,
                                        state.generator)[0]
    share = float((a_fused != a_default).float().mean())
    print(f'first rollout step: {int((a_fused != a_default).sum())} of {a_fused.numel()} '
          f'actions differ between the fused policy and the default path ({share:.6f})')
    if not share < 0.02:
        fail(f'the fused policy changes {share} of the first step\'s actions')
    _, rows_f = _counted(fused, snap, 3, 'fused policy', onehot_linear=3, ppo_loss=3,
                         policy_sample=3 * TRAIN_T)
    counts_fused = _counts()
    _, rows_d = _counted(default, snap, 3, 'default path', onehot_linear=3 * per_update,
                         ppo_loss=3)
    _track(rows_f, rows_d, 'fused policy vs default path')
    out['default'] = (default, snap)
    out['fused policy'] = (fused, snap)

    # Per-agent policies: the loss kernel once per agent, and its gate off.
    cfg = PPOConfig(rollout_steps=TRAIN_T, per_agent_policies=True)
    state, net, cfg, tx = ppo_init(venv, 1, config=cfg, hidden=HIDDEN)
    per_agent = make_train_step(venv, net, cfg, tx)
    gate = fused_ppo.supports
    fused_ppo.supports = lambda *a: False
    try:
        per_agent_off = make_train_step(venv, net, cfg, tx)
    finally:
        fused_ppo.supports = gate
    snap = _snapshot(per_agent, state)
    _, rows_k = _counted(per_agent, snap, 3, 'per-agent policies, loss kernel',
                         onehot_linear=3 * N * per_update, ppo_loss=3 * N)
    _, rows_o = _counted(per_agent_off, snap, 3, 'per-agent policies, gate off',
                         onehot_linear=3 * (N * per_update + N), onehot_linear_grad=3 * N)
    _track(rows_o, rows_k, 'per-agent gate off vs loss kernel')
    out['per-agent'] = (per_agent, snap)
    out['per-agent, gate off'] = (per_agent_off, snap)

    # The centralized critic (its first layer on the first-layer kernel over
    # N·C cells, its dW on the gradient kernel) with a shared and with
    # per-agent actors; the learner is autograd.
    for shared in (True, False):
        cfg = PPOConfig(rollout_steps=TRAIN_T, per_agent_policies=not shared,
                        centralized_critic=True)
        state, net, cfg, tx = ppo_init(venv, 2, config=cfg, hidden=HIDDEN)
        step = make_train_step(venv, net, cfg, tx)
        snap = _snapshot(step, state)
        actors = 1 if shared else N
        name = f'centralized critic, {"shared" if shared else "per-agent"} actor'
        after, _ = _counted(step, snap, 2, name,
                            onehot_linear=2 * ((actors + 1) * per_update + actors + 1),
                            onehot_linear_grad=2 * (actors + 1))
        for group in ('actor.', 'critic.'):
            keys = [k for k in snap[0].params if k.startswith(group)]
            moved = sum(not torch.equal(snap[0].params[k], after.params[k]) for k in keys)
            print(f'  {group[:-1]}: {moved} of {len(keys)} parameters moved')
            if not moved:
                fail(f'{name}: no {group[:-1]} parameter moved')
        out[name] = (step, snap)
    return out, counts_fused


def variant_timing(steps):
    """Trained agent-steps/s of each variant (median of 3 length-differenced
    pairs of 1 and 4 updates, the variants in turns), the rollout step's
    layers with and without the fused policy, and the fused policy kernel's
    time at the flagship beside its bound and plain version."""
    import statistics

    import torch

    from multigrid_tpu_torch.learn.nets import direction_features
    from multigrid_tpu_torch.ops import fused_policy as fp

    samples = E * N * TRAIN_T
    short, long_ = 1, 4
    states = {name: _restore(step, snap) for name, (step, snap) in steps.items()}
    rates = {name: [] for name in steps}
    for _ in range(3):
        for name, (step, _) in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = _run(step, states[name], short)
            t1 = time.perf_counter()
            states[name], _ = _run(step, state, long_)
            t2 = time.perf_counter()
            rates[name].append(samples * (long_ - short) / ((t2 - t1) - (t1 - t0)))
    base = statistics.median(rates['default'])
    medians = {}
    for name, r in rates.items():
        medians[name] = statistics.median(r)
        print(f'{name}: trained agent-steps/s {medians[name]:.6e} '
              f'({samples / medians[name] * 1e3:.4f} ms/update, {medians[name] / base:.4f} of '
              f'the default path; pairs {", ".join(f"{x:.6e}" for x in r)})')

    default, fused = steps['default'][0], steps['fused policy'][0]
    for step in (default, fused, fused, default):
        rollout_layers(step, states['default'], 8)

    counts = _counts()
    state = states['fused policy']
    obs, b = state.last_obs, E * N
    w = fp.prepare(state.params)
    packed = obs['image'].reshape(b, C)
    dirf = direction_features(obs['direction']).float().reshape(b, 2)
    gumbel = -torch.log(-torch.log(torch.rand(b, 7, device=packed.device).clamp_min(1e-30)))
    ms = event_ms(lambda: fp.policy_sample_prepared(w, packed, dirf, gumbel), 100)
    plain = event_ms(lambda: fp.policy_sample_plain(w, packed, dirf, gumbel,
                                                    compute_dtype=torch.bfloat16), 10)
    _set_counts(counts)
    nnz = nonzeros(packed)
    in_bytes = sum(x.numel() * x.element_size() for x in [packed, dirf, gumbel, *w.values()])
    bd = bound(in_bytes + 12 * b,
               tensor_ops=2 * b * (HIDDEN * HIDDEN + 3 * HIDDEN + 8 * HIDDEN),
               ops_ms=onehot_ms(nnz, b, C, HIDDEN, 'policy_sample'))
    print(f'policy_sample: {ms:.6f} ms/launch; plain {plain:.6f} ms; library none; '
          f'bound {bd[0]:.6f} ms by {bd[1]} ({in_bytes + 12 * b} bytes); '
          f'{bd[0] / ms:.4f} of the bound')
    return dict(rates=medians, kernel=dict(ms=ms, plain_ms=plain, library_ms=None,
                                           bound_ms=bd[0], bound_by=bd[1]))


def kernel_times(device):
    """``--kernel-times``: B2 at the rollout's three shapes, B3 at the
    learner's three (flagship, per agent, critic), B1 at the flagship as
    images and packed (launches alone, profiler, call), B4 at 262,144 and
    65,536 samples with its stages, and B5 at 16,384, on seeded inputs:
    CUDA-event times of the package beside this script, for comparing two
    trees in turns within one call. Prints one JSON line."""
    import numpy as np
    import torch

    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_policy as fp
    from multigrid_tpu_torch.ops import fused_ppo, obs_cuda

    rng = np.random.default_rng(40)
    res = {}
    for label, b, c in [('flagship', E * N, C), ('per agent', E, C), ('critic', E, N * C)]:
        packed = random_cells(rng, b, c, device)
        w = torch.as_tensor((rng.normal(size=(c * 21, HIDDEN)) * 0.05).astype(np.float32),
                            device=device)
        key = f'onehot_linear {label} ({b}, {c}, {HIDDEN})'
        res[key + ' call'] = event_ms(lambda: fl.onehot_linear_forward(packed, w), 100)
        res[key + ' kernel (profiler)'] = kernel_device_ms(
            lambda: fl.onehot_linear_forward(packed, w), 'onehot_linear_kernel')
        if hasattr(fl, 'pad_columns'):  # the launcher's signature of this tree
            res[key + ' launches'] = onehot_launch_ms(packed, w)
    for label, b, c in [('flagship', E * N * TRAIN_T, C), ('per agent', E * TRAIN_T, C),
                        ('critic', E * TRAIN_T, N * C)]:
        packed = random_cells(rng, b, c, device, 0.05)
        g = torch.as_tensor((rng.normal(size=(b, HIDDEN)) * 1e-3).astype(np.float32),
                            device=device).to(torch.bfloat16)
        key = f'onehot_linear_grad {label} ({b}, {c}, {HIDDEN})'
        res[key + ' call'] = event_ms(lambda: fl.onehot_linear_grad_w(packed, g), 20)
        res[key + ' kernel (profiler)'] = kernel_device_ms(
            lambda: fl.onehot_linear_grad_w(packed, g), GRAD_KERNELS)
    state = random_state(1, E, SIZE, SIZE, N, device)
    for packed in (False, True):
        key = f'obs {"packed" if packed else "images"} ({E}, {N}, {VS})'
        res[key + ' launches'] = obs_launch_ms(state, VS, False, packed)
        res[key + ' kernel (profiler)'] = kernel_device_ms(
            lambda: obs_cuda.gen_obs_batched(state, VS, False, packed), 'obs_kernel')
        res[key + ' call'] = event_ms(lambda: obs_cuda.gen_obs_batched(state, VS, False, packed),
                                      200)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)
    for b in (E * N * TRAIN_T, E * TRAIN_T):
        params, args = ppo_inputs(rng, b, C, HIDDEN, 0, device)
        res[f'ppo_loss B={b}'] = event_ms(lambda: fused_ppo.ppo_mlp_grads(params, *args, **kw), 10)
        res[f'ppo_loss B={b} stages'] = ppo_stages(
            lambda: fused_ppo.ppo_mlp_grads(params, *args, **kw))
    params, args = ppo_inputs(rng, E * N, C, HIDDEN, 0, device)
    w = fp.prepare(params)
    gumbel = torch.as_tensor(rng.gumbel(size=(E * N, 7)).astype(np.float32), device=device)
    res[f'policy_sample ({E * N}, {C}, {HIDDEN})'] = event_ms(
        lambda: fp.policy_sample_prepared(w, args[0], args[1], gumbel), 100)
    for k, v in res.items():
        print(f'{k}: {v}')
    print(json.dumps({'kernel_times_ms': res, 'tree': HERE}))


def main() -> None:
    times_only = sys.argv[1:] == ['--kernel-times']
    if sys.argv[1:] and not times_only:
        fail(f'unknown arguments {sys.argv[1:]}; usage: chip_smoke.py [--kernel-times]')
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
    if times_only:
        phase('kernel times')
        kernel_times(device)
        return
    sass = sass_tensor_ops()
    phase('kernels')
    obs_err = obs_cases(device)
    errs = train_kernel_cases(device)
    policy_err = policy_kernel_cases(device)
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
    phase('variants')
    steps, counts_fused = variants()
    phase('variant timing')
    vt = variant_timing(steps)
    print(f'total {time.perf_counter() - t_start:.1f} s')

    kernels = [dict(name='obs', route='cuda', source='multigrid_tpu_torch/csrc/obs.cu',
                    replaces='multigrid_tpu/ops/obs_pallas.py:176', launches=launches,
                    max_abs_err=obs_err, equal=obs_err == 0, ms=t['ms'],
                    plain_ms=t['plain_ms'], bound_ms=t['bound_ms'], bound_by=t['bound_by'],
                    library_ms=None, sass_tensor_ops=sass['obs'], call_ms=t['call_ms'],
                    profiler_ms=t['profiler_ms'], packed=t['packed'])]
    for name, replaces, src, n in [
            ('onehot_linear', 'multigrid_tpu/ops/fused_linear.py:133', 'fused_linear.cu',
             counts['onehot_linear']),
            ('onehot_linear_grad', 'multigrid_tpu/ops/fused_linear.py:213', 'fused_linear.cu',
             counts_off['onehot_linear_grad']),
            ('ppo_loss', 'multigrid_tpu/ops/fused_ppo.py:67', 'fused_ppo.cu',
             counts['ppo_loss'])]:
        kernels.append(dict(name=name, route='cuda', source=f'multigrid_tpu_torch/csrc/{src}',
                            replaces=replaces, launches=n, max_abs_err=errs[name][0],
                            max_rel_err=errs[name][1], sass_tensor_ops=sass[name],
                            **tt['kernels'][name]))
    kernels[2]['launches_path'] = 'train, learner gate off (autograd)'
    kernels.append(dict(name='policy_sample', route='cuda',
                        source='multigrid_tpu_torch/csrc/fused_policy.cu',
                        replaces='multigrid_tpu/ops/fused_policy.py:62',
                        launches=counts_fused['policy_sample'],
                        launches_path='train, MULTIGRID_FUSED_POLICY set',
                        max_abs_err=policy_err[0], max_rel_err=policy_err[1],
                        sass_tensor_ops=sass['policy_sample'], **vt['kernel']))
    print(json.dumps({'kernels': kernels, 'trained_agent_steps_per_s': tt['rate'],
                      'variants_trained_agent_steps_per_s': vt['rates']}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
