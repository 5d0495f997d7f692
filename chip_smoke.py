#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card     — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build    — builds the four CUDA sources of ``multigrid_tpu_torch/csrc``
               (one nvcc each, in parallel), prints each build's time,
               registers and spills, and the tensor-core instructions in
               each kernel's SASS (cuobjdump; B2, B3, B4 and B5 must have
               some).
3. kernels  — each kernel against its plain PyTorch version on the card.
               The observation kernel also on states of every procedural
               family (BUP N 1/2, RedBlueDoors 6x6/8x8, LockedHallway 2/4/6
               rooms, Playground N 1/2/10; doors in every state, carried
               keys and boxes), and the general obs kernel on views 33, 35
               and 63, a 250x250 grid and 64 agents with view 31, and
               against obs_kernel on a shape both take.
               The observation kernel, ``torch.equal``, on seeded states
               stepped a few times: the flagship shape (E=4096, N=4, 16x16,
               view 7; see through walls off and on; packed and images),
               view sizes 3-31, 1, 2, 8, 9, 16 and 33 agents (views 15 and
               31 with 16 and 33), a 13x25 grid, doors
               (open, closed, locked), keys, balls, boxes, agents at the
               borders, terminated and carrying. The training kernels in
               bf16, each with its tolerance: the first layer (B=16384,
               C=49, H=128; the per-agent (4096, 49) and critic (4096, 196)
               shapes; C 9/25/169, H 32/100/256, a ragged batch, pad
               cells), its weight gradient (B=262144, the critic's
               (65536, 196) and small shapes; equal from run to run), the
               PPO loss (B=262144 and 65536, B=256 with 0 and 5 missions, a
               ragged B=1001, B=262144 with 12 missions (F 14); equal from
               run to run); the agent axis of B2, B3 and B4 (per-agent
               policies, one launch for all agents) at the flagship's per-
               agent shapes (N 4: 4096 rows an agent a rollout step, 65,536
               an SGD step) and BUP's (N 2: 4096 and 131,072, F 14), each
               against its plain version and N single-agent launches (B2
               bit-equal to them), B3 and B4 equal from run to run; and the
               fused rollout policy (B=16384; C 9/25,
               H 32/256, F 2/14, a ragged batch, B=8192 at F 14; a
               constructed tie takes the first index).
4. main     — ``VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=4), 4096)``
               on the default device: reset, then ``rollout_random`` for 256
               steps, with the kernel's launch count set to 0 just before and
               read just after (one launch per step, one for the reset).
5. check    — the outputs: finite, the expected shapes, valid states, the
               kernel equal to the plain version on the rollout's final
               state, and two recorded reference traces
               (``tests/golden``) replayed bit-exactly on the card.
   team     — ``VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=16),
               4096)``: reset and 32 steps, the launch counts set to 0 just
               before and read just after (one obs launch a call), every
               step's observations equal to the plain version; the obs
               kernel at N=16 timed by its launches alone beside its bound.
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
               also at 65,536 samples, and B4's stages apart (torch.profiler);
               the agent axis of B2, B3 and B4 at the flagship's per-agent
               shapes beside N single-agent launches and its bound.
10. train breakdown — one update under ``torch.profiler``: the device's
               busy share and the kernels that take its time.
11. variants — the same flagship through each learner variant, launch
               counts set to 0 before each run and checked exactly after
               it: the fully fused rollout policy (``MULTIGRID_FUSED_POLICY``;
               its metrics track the default path's over 3 updates, and
               under 2% of the first rollout step's actions differ), per-agent
               policies on the loss kernel and with its gate off (metrics
               tracking; each kernel launched once for all agents: B2 17 and
               B4 1 an update, gate off B2 18 and B3 1), and the centralized
               critic with a shared and with per-agent actors (actor and
               critic parameters move).
12. variant timing — each variant's trained agent-steps/s beside the
               default path's, the rollout step's layers with and without the
               fused policy, and the fused policy's kernel time at B=16384
               (its launches alone, the profiler's kernel time and the
               wrapper's call) beside its bound and plain version.
13. wide view — views past 31 through the entry points (Empty-16x16, 2
               agents, view 33, 1024 envs): reset and 8 steps on the general
               obs kernel, launch counts exact, observations equal to the
               plain version.
14. zoo     — each of the 13 configurations, 2 agents, 4096 envs, on the
               exact reset (reset_pool=False): reset and
               32 random steps with max_steps 16 (every env resets twice),
               launch counts exact, every call's observations equal to the
               plain version, every finished env holding its fresh layout's
               extras; each configuration's step layers and reset share at
               its registered max_steps; one golden trace per procedural
               family replayed on the card.
15. bup train — the JAX package's production recipe: BlockedUnlockPickup,
               2 agents, 4096 envs, mlp 128 with 12 missions, T 128, 2 epochs
               x 4 minibatches, on the reserve pool as the JAX CLI runs it
               (one refresh_pool(128) a rollout): 3 updates with exact launch counts (B1 128,
               B2 129, B4 8 an update), parameters moving, metrics finite;
               one fused-policy update (B5 at F 14) tracking the default's.
16. bup timing — its trained agent-steps/s, a rollout step's layers (policy,
               step, reset and merge, the pool's refresh amortized over the
               rollout, obs) with and without the fused policy, and B1, B2,
               B4 (F 14) and B5 (F 14) at its shapes beside their bounds,
               plain versions and library calls.
17. pool    — the reserve pool (the default on procedural envs) on BUP,
               RedBlueDoors-8x8, LockedHallway 2 and 6 rooms and Playground,
               2 agents, 4096 envs, max_steps 16: 48 random steps in chunks
               of 16 with refresh_pool(16), launch counts exact, every
               finished env holding reserve slot (i + g) mod E (fields and
               extras), no env replaying its layout, each refresh rewriting
               only its slots and every slot within the period, every
               observation equal to the plain version; each family's step
               layers and reset share with the pool.
18. pool timing — BUP at 4096 envs, with the pool and with
               reset_pool=False in turns: the env step's layers and reset
               share, and the BUP recipe's trained agent-steps/s.
19. cnn train — the cnn encoder at the JAX CLI's defaults (Empty-8x8, 2
               agents, 1024 envs, hidden 128, T 16) and at the flagship: 3
               updates each with exact launch counts (the obs kernel only),
               parameters moving, the card within bf16 tolerance of the CPU's
               float32 net (outputs and gradients), trained agent-steps/s and
               the device's busy share.
20. resume  — 2 updates, a checkpoint, 1 update, then a restore into fresh
               objects and 1 update, bit-equal to 3 straight, on the mlp
               default path and on the cnn (cuDNN deterministic).
21. wrappers — each observation wrapper (FullyObs, ImgObs, OneHot) over
               the flagship VectorEnv, and OneHot over BUP (2 agents, 4096
               envs) on its reserve pool: reset and 32 steps with launch
               counts exact (one obs launch a call), every call's raw
               observations equal to the plain version, the wrapped
               observations equal to the wrapper chain on the plain
               version's, with the wrapper's shape and dtype.
22. wrapper timing — ms a VectorEnv.step unwrapped and under each wrapper
               in turns: the flagship, and BUP on the pool with OneHot.
23. render  — render_state at the flagship (16x16, tile 32, highlight on)
               on the main run's state: each env's view-cone highlight equal
               to the cells the obs kernel shows its agents, no kernel
               launched, ms a frame with the tile cache warm.
24. adapters — a GymAdapter over BUP on the card (partial action dicts,
               every observation equal to the plain version, one obs launch
               a reset and a step), a 256-step episode loop's steps/s and
               the device's busy share; PettingZoo's live agents, RLlib's
               __all__ and the MiniGrid facade's DoorKey solve (an
               imperative MiniGridCompatEnv), launches exact. The parts
               that need gymnasium, pettingzoo or pygame run where they are
               installed; the absent packages and what did not run are
               printed.
25. cli     — python -m multigrid_tpu_torch.train on BUP with the JAX CLI's
               defaults (saving every 2 updates), again with --load-dir, then
               python -m multigrid_tpu_torch.evaluate --load-dir: each exits 0
               and prints JSON rows that parse.
26. visualize — python -m multigrid_tpu_torch.visualize's entry point in
               this process on the cli phase's cnn checkpoint (BUP, 2
               episodes, a GIF) and with --encoder mlp on an mlp checkpoint
               (B2): launches exact (obs one at ppo_init and one a frame, B2
               one a step), observations and B2 outputs held to their plain
               versions, frames of BUP's size.
27. distributed — data-parallel PPO over spawned processes on this card
               (a file-store rendezvous, a join timeout each): NCCL in a
               world of one (the flagship's metrics equal to the plain
               path's, then both in turns for trained agent-steps/s); gloo
               with two processes sharing the card, 2048 of 4096 envs each
               (the flagship, 2 epochs x 4 minibatches, the BUP recipe on
               the replicated pool, the fused policy; each held to this
               process: every rollout bit-equal, metrics at rtol 1e-4; on
               the BUP recipe the first update whose rollout differs, and
               its step, is reported and the metrics are held up to it;
               not a scaling measure); every process's launches exact (B1
               16, B2 17, B4 1 an update, B5 16 fused); the extra ms a BUP
               step pays a process for the global reserve's draws; and
               torchrun --nproc-per-node 1 -m multigrid_tpu_torch.train
               --mesh (2 updates, one checkpoint that evaluate reads).
28. model axis — the (env, model) mesh of the JAX dry run, each process
               keeping its columns of the Dense_0 kernels and their Adam
               moments, over gloo processes sharing the card (not a scaling
               measure): 2 processes at (1, 2) on the JAX gate's
               configuration (the cnn on images, 256 envs, T 2, 3 updates),
               the mlp flagship (E 4096, T 16, 3 updates) and the fused
               policy, each bit-equal to one process with each process's
               launches exact (B1 16, B2 17, B4 1 an update; B5 16 fused;
               B1 2 on the cnn); the checkpoint round trip, (1, 2) to one
               process and back, bit-equal; then 4 processes at (2, 2):
               dryrun_multichip(4), the gate at 512 envs, at rtol 1e-4.
29. profile — python -m multigrid_tpu_torch.profile_env and profile_train
               at the flagship (64 env steps a phase, 2 updates a train
               stage): the JAX scripts' keys, each phase's time.

``python3 chip_smoke.py --kernel-times`` builds the kernels and only times
B1 (images and packed, at the flagship, with 16 agents and at the BUP
shape), the general obs kernel (view 33, launches alone), B2, B3 (flagship,
per-agent and critic shapes), B4 (with its stages; and at F 14) and B5 (at
the seven shapes of its kernel cases) on seeded inputs, with digests of
B1's and B4's outputs, for comparing two trees in turns within one call
(copy the script into the other tree, which must have this tree's
launchers).

Products in float32 run in full float32 (TF32 off) for the plain versions.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
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
#: B5's cases (B, C, H, F, share of pad cells): the rollout's flagship shape
#: first, then other cell counts, widths, feature counts and ragged batches.
POLICY_SHAPES = [(E * N, C, HIDDEN, 2, 0.0), (4096, 9, 128, 2, 0.0), (4096, 25, 32, 14, 0.05),
                 (2048, C, 256, 2, 0.0), (1001, 25, 256, 14, 0.1), (777, 9, 64, 5, 0.0),
                 (E * 2, C, HIDDEN, 14, 0.0)]
#: The JAX package's production training recipe (docs/PERFORMANCE.md:259-268):
#: BlockedUnlockPickup (11x6, view 7, 12 missions), 2 agents, 4096 envs,
#: mlp 128 bf16 on packed cells, T 128, 2 epochs x 4 minibatches.
BUP, BUP_N, BUP_T, BUP_EPOCHS, BUP_MB = 'MultiGrid-BlockedUnlockPickup-v0', 2, 128, 2, 4
BUP_F = 2 + 12  # direction features and the mission one-hot
#: One golden trace per procedural family, replayed on the card.
ZOO_GOLDEN = [('MultiGrid-BlockedUnlockPickup-v0', 0, 2), ('MultiGrid-RedBlueDoors-6x6-v0', 0, 3),
              ('MultiGrid-LockedHallway-2Rooms-v0', 0, 2), ('MultiGrid-Playground-v0', 0, 2)]
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


def onehot_agents_launch_ms(packed, w, reps=200):
    """CUDA-event times of the first-layer kernel's launches alone over N
    agents, ``(one launch over all agents, N single-agent launches)``: the
    agent-axis launch on (N, B, C) cells and (N, C·21, H) weights, and the
    single-agent launch on each agent's slices in turn."""
    import torch

    from multigrid_tpu_torch.ops import fused_linear as fl
    n, b, c = packed.shape
    h = w.shape[-1]
    wb = fl.pad_columns(w.detach().to(torch.bfloat16)).contiguous()
    out = torch.empty((n, b, h), dtype=torch.bfloat16, device=packed.device)
    st = torch.cuda.current_stream().cuda_stream
    agents = fl._lib_fn('mgt_onehot_linear_agents_launch', 3, 5)
    single = fl._lib_fn('mgt_onehot_linear_launch', 3, 4)
    args = (packed.data_ptr(), wb.data_ptr(), out.data_ptr(), n, b, c, h, wb.shape[-1], st)
    each = [(packed[i].data_ptr(), wb[i].data_ptr(), out[i].data_ptr(), b, c, h, wb.shape[-1],
             st) for i in range(n)]

    def launch_agents():
        if agents(*args):
            fail('onehot_linear agent-axis kernel launch failed')

    def launch_singles():
        for a in each:
            if single(*a):
                fail('onehot_linear kernel launch failed')
    return event_ms(launch_agents, reps), event_ms(launch_singles, reps)


def obs_launch_ms(state, vs, stw, packed, reps=200):
    """CUDA-event time of the observation kernel's launches alone (the
    kernel ``check_supported`` names for this shape), without the wrapper's
    checks and allocations, as for B2."""
    import torch

    from multigrid_tpu_torch.ops import obs_cuda
    e, w, h, _ = state.grid.shape
    n = state.agent_dir.shape[-1]
    dev = state.grid.device
    out = torch.empty((e, n, vs * vs) if packed else (e, n, vs, vs, 3), dtype=torch.int32,
                      device=dev)
    ptrs = (state.grid.data_ptr(), state.agent_pos.data_ptr(), state.agent_dir.data_ptr(),
            state.agent_color.data_ptr(), state.agent_terminated.data_ptr(),
            state.agent_carrying.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    kernel = obs_cuda.check_supported(n, w, h, vs)
    if kernel == 'obs':
        args = (*ptrs, e, n, w, h, vs, int(stw), int(packed), stream)
    else:
        slots = obs_cuda.table_size(n)
        table = torch.empty((e, slots if n > 1 else 0, 2), dtype=torch.int32, device=dev)
        args = (*ptrs, table.data_ptr(), slots, e, n, w, h, vs, int(stw), int(packed), stream)
    fn = obs_cuda._lib_fn(kernel)

    def launch():
        if fn(*args):
            fail(f'{kernel} kernel launch failed')
    return event_ms(launch, reps)


def policy_launch_ms(w, packed, dirf, gumbel, reps=200):
    """CUDA-event time of the fused-policy kernel's launches alone, without
    the wrapper's checks and allocations, as for B2."""
    import torch

    from multigrid_tpu_torch.ops import fused_policy as fp
    b, c = packed.shape
    f, na = dirf.shape[1], gumbel.shape[1]
    outs = [torch.empty((b,), dtype=dt, device=packed.device)
            for dt in (torch.int32, torch.float32, torch.float32)]
    fn = fp._lib_fn()
    args = (packed.data_ptr(), dirf.data_ptr(), gumbel.data_ptr(),
            *[w[k].data_ptr() for k in ('w_img', 'wd', 'w1', 'b1', 'wa', 'ba', 'wv', 'bv')],
            *[o.data_ptr() for o in outs], b, c, f, na, w['w_img'].shape[-1],
            torch.cuda.current_stream().cuda_stream)

    def launch():
        if fn(*args):
            fail('policy_sample kernel launch failed')
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


def general_bound(state, vs, packed):
    """(bound_ms, bound_by, bytes, ops) of the general obs kernel: what
    gen_obs needs of this state, each read once — the grid cells inside
    some agent's view (12 bytes each, the union of the views clipped to the
    grid), the agents' positions, directions, colors, terminations and
    carried objects — and its output written once, against the same 28
    integer operations an output cell as :func:`obs_bound`."""
    import torch

    e, w, h, _ = state.grid.shape
    n = state.agent_dir.shape[-1]
    half, kr = vs // 2, vs - 1
    x, y, d = state.agent_pos[..., 0], state.agent_pos[..., 1], state.agent_dir
    tx = torch.where(d == 0, x, torch.where(d == 2, x - kr, x - half))
    ty = torch.where(d == 1, y, torch.where(d == 3, y - kr, y - half))
    xs = torch.arange(w, device=x.device)
    ys = torch.arange(h, device=x.device)
    in_x = (xs >= tx[..., None]) & (xs < tx[..., None] + vs)           # (E, N, W)
    in_y = (ys >= ty[..., None]) & (ys < ty[..., None] + vs)           # (E, N, H)
    seen = torch.zeros((e, w, h), dtype=torch.bool, device=x.device)
    for a in range(n):
        seen |= in_x[:, a, :, None] & in_y[:, a, None, :]
    cells = int(seen.sum())
    n_cells = e * n * vs * vs
    read = (cells * 12 + state.agent_pos.numel() * 4 + state.agent_dir.numel() * 4
            + state.agent_color.numel() * 4 + state.agent_terminated.numel()
            + state.agent_carrying.numel() * 4)
    written = n_cells * (1 if packed else 3) * 4
    ops = n_cells * (16 + 12)
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

def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f'nvidia-smi unavailable (rc {smi.returncode})'


def card_info():
    import torch
    print(smi_line(), flush=True)
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
            elif ('registers' in line or 'spill' in line or 'error' in line.lower()
                  or line.startswith('nvcc took')):
                print('      ' + line.strip())


def sass_tensor_ops():
    """{kernel: tensor-core instructions in the SASS of all its builds};
    fails unless B2, B3, B4's loss kernel and B5 have some. Printed on one
    line."""
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
    for k in ('onehot_linear', 'onehot_linear_grad', 'ppo_loss', 'policy_sample'):
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
    # Views past 13 (past 15 the fill takes a fifth doubling step), teams
    # past 8 agents (past 32 a second round of lanes).
    for vs in (15, 17, 21, 31):
        for stw in (False, True):
            cases.append((f'vs={vs} stw={stw}', small, vs, stw, False))
    cases.append(('13x25 N=3 vs=31', tall, 31, False, True))
    for n in (9, 16, 33):
        st = random_state(3 + n, 512, SIZE, SIZE, n, device)
        cases.append((f'N={n}', st, VS, False, False))
        cases.append((f'N={n} packed', st, VS, False, True))
        for vs in (15, 31):
            cases.append((f'N={n} vs={vs} packed', st, vs, False, True))

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


def team_path(device=None, steps=32):
    """A 16-agent team on the flagship env: reset and ``steps`` steps with
    random actions, the launch counts set to 0 just before and read just
    after (one obs launch a call, no other kernel), every step's
    observations equal to the plain version on the same state (Empty
    observes the merged state). Returns the launch count and the obs
    kernel's time at N=16 (launches alone) beside its bound."""
    import torch

    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain

    n = 16
    venv = VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=n, device=device), E)
    if device is None and venv.device.type != 'cuda':
        fail(f'default device is {venv.device}, not cuda')
    _zero_counts()
    obs, state = venv.reset(seed=0)
    pairs = [(obs['image'], state)]
    for _ in range(steps):
        actions = torch.randint(0, 7, (E, n), generator=venv.generator, device=venv.device)
        obs, state, *_ = venv.step(state, actions)
        pairs.append((obs['image'], state))
    torch.cuda.synchronize()
    counts = _counts()
    want = {**{k: 0 for k in counts}, 'obs': steps + 1}
    print(f'16-agent VectorEnv, reset + {steps} steps: launches {counts}')
    if counts != want:
        fail(f'16-agent VectorEnv: expected launches {want}, got {counts}')
    for t, (image, st) in enumerate(pairs):
        if not torch.equal(image, gen_obs_batched_plain(st, VS, False)):
            fail(f'16-agent VectorEnv: observations differ from the plain version at call {t}')
    print(f'16-agent VectorEnv: all {len(pairs)} observations equal to the plain version')
    ms = obs_launch_ms(state, VS, False, False)
    bd, by, nbytes, _ = obs_bound(state, VS, False)
    print(f'obs kernel images ({E}, {n}, {VS}, {VS}, 3): launches {ms:.6f} ms; bound {bd:.6f} '
          f'ms by {by} ({nbytes} bytes); {bd / ms:.4f} of the bound')
    return dict(launches=counts['obs'], ms=ms, bound_ms=bd, bound_by=by)


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
    for env_id, seed, n in [('MultiGrid-Empty-16x16-v0', 3, 2),
                            ('MultiGrid-Empty-Random-5x5-v0', 42, 4)]:
        replay_golden(env_id, seed, n, device)


def replay_golden(env_id, seed, n, device=None):
    """A recorded reference trajectory (tests/golden) through the parity
    runner on the card: observations, terminations and truncations equal,
    rewards to float32 rounding."""
    import numpy as np

    from multigrid_tpu_torch.envs import make
    from multigrid_tpu_torch.envs.parity import ParityRunner

    data = np.load(os.path.join(HERE, 'tests', 'golden', f'{env_id}-s{seed}-n{n}.npz'))
    runner = ParityRunner(make(env_id, agents=n, device=device), seed)
    obs0 = runner.reset()
    images = [np.stack([obs0[i]['image'] for i in range(n)])]
    acts = np.random.default_rng(seed + 1000)
    for t in range(len(data['rewards'])):
        o, r, te, tr, _ = runner.step({i: int(acts.integers(0, 7)) for i in range(n)})
        images.append(np.stack([o[i]['image'] for i in range(n)]))
        if not all(te[i] == bool(data['terms'][t, i]) and tr[i] == bool(data['truncs'][t, i])
                   and abs(r[i] - float(data['rewards'][t, i])) <= 1e-5 for i in range(n)):
            fail(f'{env_id} s{seed}: rewards, terminations or truncations differ at step {t}')
    if not np.array_equal(np.stack(images), data['images'].astype(np.int32)):
        fail(f'{env_id} s{seed}: observations differ from the golden trace')
    print(f'golden {env_id} s{seed} n{n}: {len(images) - 1} steps equal on the card')


def breakdown(venv, state, steps=32):
    """Where a step's time goes: each layer's synchronized host time, then
    the device's busy share and kernel count from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state, _, layers = env_layers(venv, state, steps)
    print('per-step host time by layer (synchronized): ' + ', '.join(
        f'{k} {v:.4f} ms' for k, v in layers.items()))

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
    for b, missions in [(E * N * TRAIN_T, 0), (E * TRAIN_T, 0), (256, 0), (256, 5), (1001, 3),
                        (E * BUP_N * BUP_T // BUP_MB, BUP_F - 2)]:
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
    agent_axis_cases(rng, device, check)
    return errs


def agent_axis_cases(rng, device, check):
    """The agent axis of B2, B3 and B4 (per-agent policies, one launch for
    all agents) at the flagship's per-agent shapes (N 4: 4096 rows an agent
    a rollout step, 65,536 an SGD step) and BUP's (N 2: 4096 and 131,072, F
    14): each against its plain version at its tolerance and against N
    single-agent launches (B2 bit-equal to them, B3 and B4 at the same
    tolerance: their sums split otherwise), B3 and B4 equal from run to run."""
    import torch

    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_ppo

    def stacked(n, make):
        return torch.stack([make() for _ in range(n)])

    for n, b in [(N, E), (BUP_N, E)]:
        packed = stacked(n, lambda: random_cells(rng, b, C, device))
        w = torch.as_tensor(rng.normal(size=(n, C * 21, HIDDEN)).astype('float32'), device=device)
        got = fl.onehot_linear_agents_forward(packed, w)
        singles = torch.stack([fl.onehot_linear_forward(packed[i], w[i]) for i in range(n)])
        want = fl.onehot_linear_agents_plain(packed, w)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float((diff / (want.float().abs() + 1)).max())
        check('onehot_linear', f'agent axis N={n} B={b} C={C} H={HIDDEN}', float(diff.max()),
              err, 2e-2)
        if not torch.equal(got, singles):
            fail(f'onehot_linear agent axis N={n} differs from {n} single launches')
        print(f'  ok   onehot_linear agent axis N={n} B={b}: bit-equal to {n} single launches')
    for n, b in [(N, E * TRAIN_T), (BUP_N, E * BUP_N * BUP_T // BUP_MB // BUP_N)]:
        packed = stacked(n, lambda: random_cells(rng, b, C, device, 0.05))
        g = torch.as_tensor(rng.normal(size=(n, b, HIDDEN)).astype('float32'), device=device)
        got = fl.onehot_linear_agents_grad_w(packed, g)
        again = fl.onehot_linear_agents_grad_w(packed, g)
        want = fl.onehot_linear_agents_grad_w_plain(packed, g)
        singles = torch.stack([fl.onehot_linear_grad_w(packed[i], g[i]) for i in range(n)])
        torch.cuda.synchronize()
        for ref, label in [(want, 'plain'), (singles, f'{n} single launches')]:
            abs_err = max(float((got[i] - ref[i]).abs().max()) for i in range(n))
            err = max(float((got[i] - ref[i]).abs().max()) / (float(ref[i].abs().max()) + 1)
                      for i in range(n))
            check('onehot_linear_grad', f'agent axis N={n} B={b} against {label}', abs_err,
                  err, 1e-4)
        if not torch.equal(got, again):
            fail(f'onehot_linear_grad agent axis N={n} differs from run to run')
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)
    for n, b, missions in [(N, E * TRAIN_T, 0),
                           (BUP_N, E * BUP_N * BUP_T // BUP_MB // BUP_N, BUP_F - 2)]:
        cases = [ppo_inputs(rng, b, C, HIDDEN, missions, device) for _ in range(n)]
        params = {k: torch.stack([p[k] for p, _ in cases]) for k in cases[0][0]}
        args = [torch.stack([a[j] for _, a in cases]) for j in range(6)]
        grads, metrics = fused_ppo.ppo_mlp_grads_agents(params, *args, **kw)
        again, again_m = fused_ppo.ppo_mlp_grads_agents(params, *args, **kw)
        want = fused_ppo.ppo_mlp_grads_agents_plain(params, *args,
                                                    compute_dtype=torch.bfloat16, **kw)
        singles = [fused_ppo.ppo_mlp_grads({k: v[i] for k, v in params.items()},
                                           *(a[i] for a in args), **kw) for i in range(n)]
        singles = ({k: torch.stack([g[k] for g, _ in singles]) for k in grads},
                   {k: torch.stack([m[k] for _, m in singles]) for k in metrics})
        torch.cuda.synchronize()
        if not (all(torch.equal(grads[k], again[k]) for k in grads)
                and all(torch.equal(metrics[k], again_m[k]) for k in metrics)):
            fail(f'ppo_loss agent axis N={n} differs from run to run')
        for (ref_g, ref_m), label in [(want, 'plain'), (singles, f'{n} single launches')]:
            abs_err = max(float((grads[k] - ref_g[k]).abs().max()) for k in ref_g)
            err = max(float((grads[k][i] - ref_g[k][i]).abs().max())
                      / (float(ref_g[k][i].abs().max()) + 1e-6) for k in ref_g for i in range(n))
            err = max([err] + [abs(float(metrics[k][i]) - float(ref_m[k][i]))
                               / (abs(float(ref_m[k][i])) + 1e-6)
                               for k in ref_m for i in range(n)])
            check('ppo_loss', f'agent axis N={n} B={b} missions={missions} against {label} '
                  '(equal from run to run)', abs_err, err, 5e-2)


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

    for b, c, h, f, pad in POLICY_SHAPES:
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
    from multigrid_tpu_torch.ops import launch_counts
    return launch_counts()


def _zero_counts():
    from multigrid_tpu_torch.ops import zero_launch_counts
    zero_launch_counts()


def _set_counts(counts):
    from multigrid_tpu_torch.ops import fused_linear, fused_policy, fused_ppo, obs_cuda
    obs_cuda.launches, fused_linear.launches = counts['obs'], counts['onehot_linear']
    obs_cuda.general_launches = counts['obs_general']
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
    before and checked exactly just after against ``want`` (one obs launch
    a rollout step, 0 of any kernel not named)."""
    state = _restore(step, snap)
    _zero_counts()
    state, rows = _run(step, state, updates)
    counts = _counts()
    want = {**{k: 0 for k in counts}, 'obs': step.config.rollout_steps * updates, **want}
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
                                      hidden=HIDDEN, net_kwargs=dict(encoder='mlp'))
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
    # One agent's cells (a single launch of an agent's share of the agent
    # axis's work) and the critic's shapes (every agent's cells of an env,
    # critic-sized W).
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
    for name, r in agent_axis_times(traj, p, args, kw).items():
        out[name]['agents'] = r
    _set_counts(counts)
    for name, r in out.items():
        lib = 'none' if r['library_ms'] is None else f'{r["library_ms"]:.6f} ms'
        print(f'{name}: {r["ms"]:.6f} ms/launch; plain {r["plain_ms"]:.6f} ms; library {lib}; '
              f'bound {r["bound_ms"]:.6f} ms by {r["bound_by"]}; {r["bound_ms"] / r["ms"]:.4f} '
              'of the bound')
    return state, dict(rate=rate, kernels=out)


def agent_axis_times(traj, params, args, kw):
    """The agent axis of B2, B3 and B4 at the flagship's per-agent shapes,
    on this rollout's cells laid out agent-major as the per-agent path lays
    them out: one launch over the N agents beside N single-agent launches
    of the same work (B2 by its launches alone, B3 and B4 by their calls;
    CUDA events), with the launch's bound. Each agent's weights are the
    trained net's plus its own noise."""
    import torch

    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_ppo

    h, out = HIDDEN, {}
    gen = torch.Generator(device=traj.image.device).manual_seed(50)

    def noisy(v):
        return v + 1e-3 * torch.randn((N,) + v.shape, generator=gen, device=v.device)

    def row(shape, ms, singles_ms, bd):
        print(f'  agent axis {shape}: one launch {ms:.6f} ms, {N} single launches '
              f'{singles_ms:.6f} ms ({singles_ms / ms:.4f}x); bound {bd[0]:.6f} ms by {bd[1]} '
              f'({bd[0] / ms:.4f} of the bound)')
        return dict(agents=N, shape=list(shape), ms=ms, single_launches_ms=singles_ms,
                    bound_ms=bd[0], bound_by=bd[1])

    # B2: a rollout step's cells, (N, E, C).
    p2 = traj.image[0].movedim(1, 0).contiguous()
    w2 = noisy(params['img_kernel'])
    ms, singles = onehot_agents_launch_ms(p2, w2)
    nnz = nonzeros(p2)
    bd = bound(p2.numel() * 4 + w2.numel() * 4 + N * E * h * 2,
               ops_ms=onehot_ms(nnz, N * E, C, h, 'onehot_linear agent axis'))
    out['onehot_linear'] = row((N, E, C, h), ms, singles, bd)

    # B3 and B4: an SGD step's samples, (N, T·E, ...).
    def agent_major(a):
        return a.reshape((-1, N) + a.shape[1:]).movedim(1, 0).contiguous()
    args_a = [agent_major(a) for a in args]
    p3, b = args_a[0], args_a[0].shape[1]
    g3 = (torch.randn(N, b, h, generator=gen, device=p3.device) * 1e-3).to(torch.bfloat16)
    ms = event_ms(lambda: fl.onehot_linear_agents_grad_w(p3, g3), 20)
    singles = event_ms(lambda: [fl.onehot_linear_grad_w(p3[i], g3[i]) for i in range(N)], 20)
    nnz = nonzeros(p3)
    bd = bound(p3.numel() * 4 + g3.numel() * 2 + N * C * 21 * h * 4,
               ops_ms=onehot_ms(nnz, N * b, C, h, 'onehot_linear_grad agent axis'))
    out['onehot_linear_grad'] = row((N, b, C, h), ms, singles, bd)

    pa = {k: noisy(v) for k, v in params.items()}
    each = [{k: v[i] for k, v in pa.items()} for i in range(N)]
    ms = event_ms(lambda: fused_ppo.ppo_mlp_grads_agents(pa, *args_a, **kw), 10)
    singles = event_ms(lambda: [fused_ppo.ppo_mlp_grads(each[i], *(a[i] for a in args_a), **kw)
                                for i in range(N)], 10)
    f1 = args_a[1].shape[-1] + 1
    param_bytes = sum(v.numel() * 4 for v in pa.values())
    in_bytes = sum(a.numel() * a.element_size() for a in args_a) + param_bytes
    dense = 2 * N * b * (2 * f1 * h + 3 * h * h + 3 * h * 8)
    bd = bound(in_bytes + param_bytes, tensor_ops=dense,
               ops_ms=2 * onehot_ms(nnz, N * b, C, h, 'ppo_loss agent axis (h and dW_img)'))
    out['ppo_loss'] = row((N, b, C, h), ms, singles, bd)
    return out


def rollout_layers(step, state, steps=8):
    """Where a rollout step's host time goes, each layer synchronized (see
    :func:`env_layers`): the policy step (noise, forward and sampling,
    through ``step.policy_step``: the fused-policy kernel where the step
    takes it), then the env step's layers, the pool's refresh amortized
    over the rollout's length as the rollout amortizes it. Returns
    ``(state, layers)``."""
    import torch

    params = state.params
    prepped = step.prepare_policy(params)

    def policy(obs):
        return step.policy_step(params, prepped, obs, state.generator)[0]
    with torch.no_grad():
        env_state, obs, layers = env_layers(step.venv, state.env_state, steps, policy,
                                            step.config.rollout_steps)
    label = 'fused policy' if prepped is not None else 'default path'
    print(f'per-rollout-step host time by layer, {label} (synchronized): ' + ', '.join(
        f'{k} {v:.4f} ms' for k, v in layers.items()))
    return state.replace(last_obs=obs, env_state=env_state), layers


def train_breakdown(step, state, steps=8):
    """Where a rollout step's host time goes (each layer synchronized), then
    where an update's device time goes, from torch.profiler."""
    state, _ = rollout_layers(step, state, steps)
    return profile_update(step, state)


def profile_update(step, state, label='update'):
    """One update under torch.profiler: the device's busy share of the
    wall time and the kernels that take its time. Returns the state."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    print(f'profiled {label}: wall {wall_ms:.4f} ms, device busy {busy_ms:.4f} ms '
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
    snapshot)}`` for the timing, the fused run's launch counts and the
    per-agent runs' (``{'loss kernel': ..., 'gate off': ...}``)."""
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
                                      hidden=HIDDEN, net_kwargs=dict(encoder='mlp'))
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
    state, net, cfg, tx = ppo_init(venv, 1, config=cfg, hidden=HIDDEN,
                                   net_kwargs=dict(encoder='mlp'))
    per_agent = make_train_step(venv, net, cfg, tx)
    gate = fused_ppo.supports
    fused_ppo.supports = lambda *a: False
    try:
        per_agent_off = make_train_step(venv, net, cfg, tx)
    finally:
        fused_ppo.supports = gate
    snap = _snapshot(per_agent, state)
    # One launch of each kernel's agent axis for all N agents: a rollout
    # step's first layer, an SGD step's loss (gate off: its first layer and
    # that layer's dW).
    _, rows_k = _counted(per_agent, snap, 3, 'per-agent policies, loss kernel',
                         onehot_linear=3 * per_update, ppo_loss=3)
    counts_agents = {'loss kernel': _counts()}
    _, rows_o = _counted(per_agent_off, snap, 3, 'per-agent policies, gate off',
                         onehot_linear=3 * (per_update + 1), onehot_linear_grad=3)
    counts_agents['gate off'] = _counts()
    _track(rows_o, rows_k, 'per-agent gate off vs loss kernel')
    out['per-agent'] = (per_agent, snap)
    out['per-agent, gate off'] = (per_agent_off, snap)

    # The centralized critic (its first layer on the first-layer kernel over
    # N·C cells, its dW on the gradient kernel) with a shared and with
    # per-agent actors; the learner is autograd.
    for shared in (True, False):
        cfg = PPOConfig(rollout_steps=TRAIN_T, per_agent_policies=not shared,
                        centralized_critic=True)
        state, net, cfg, tx = ppo_init(venv, 2, config=cfg, hidden=HIDDEN,
                                       net_kwargs=dict(encoder='mlp'))
        step = make_train_step(venv, net, cfg, tx)
        snap = _snapshot(step, state)
        name = f'centralized critic, {"shared" if shared else "per-agent"} actor'
        # The actor (per-agent: all agents in one launch) and the critic.
        after, _ = _counted(step, snap, 2, name, onehot_linear=2 * (2 * per_update + 2),
                            onehot_linear_grad=2 * 2)
        for group in ('actor.', 'critic.'):
            keys = [k for k in snap[0].params if k.startswith(group)]
            moved = sum(not torch.equal(snap[0].params[k], after.params[k]) for k in keys)
            print(f'  {group[:-1]}: {moved} of {len(keys)} parameters moved')
            if not moved:
                fail(f'{name}: no {group[:-1]} parameter moved')
        out[name] = (step, snap)
    return out, counts_fused, counts_agents


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
    ms = policy_launch_ms(w, packed, dirf, gumbel)
    call_ms = event_ms(lambda: fp.policy_sample_prepared(w, packed, dirf, gumbel), 100)
    dev_ms = kernel_device_ms(lambda: fp.policy_sample_prepared(w, packed, dirf, gumbel),
                              'policy_sample_kernel')
    plain = event_ms(lambda: fp.policy_sample_plain(w, packed, dirf, gumbel,
                                                    compute_dtype=torch.bfloat16), 10)
    _set_counts(counts)
    nnz = nonzeros(packed)
    in_bytes = sum(x.numel() * x.element_size() for x in [packed, dirf, gumbel, *w.values()])
    bd = bound(in_bytes + 12 * b,
               tensor_ops=2 * b * (HIDDEN * HIDDEN + 3 * HIDDEN + 8 * HIDDEN),
               ops_ms=onehot_ms(nnz, b, C, HIDDEN, 'policy_sample'))
    print(f'policy_sample: launches {ms:.6f} ms, the wrapper\'s call {call_ms:.6f} ms (CUDA '
          f'events), the kernel {dev_ms} ms (torch.profiler); plain {plain:.6f} ms; library '
          f'none; bound {bd[0]:.6f} ms by {bd[1]} ({in_bytes + 12 * b} bytes); '
          f'{bd[0] / ms:.4f} of the bound')
    return dict(rates=medians, kernel=dict(ms=ms, plain_ms=plain, library_ms=None,
                                           bound_ms=bd[0], bound_by=bd[1], call_ms=call_ms,
                                           profiler_ms=dev_ms))


# ------------------------------------------------------ the procedural zoo

def zoo_states(device, e=1024):
    """Seeded states of each procedural family on the card: fresh layouts
    stepped 6 times with random actions, then agents given carried keys and
    boxes, and doors set open, closed or locked at random. Returns
    ``[(label, state, view)]``."""
    import torch

    from multigrid_tpu_torch.core.constants import (
        STATE_LOCKED, TYPE_BOX, TYPE_DOOR, TYPE_EMPTY, TYPE_KEY)
    from multigrid_tpu_torch.envs import make

    out = []
    for env_id, ns in [(BUP, (1, 2)), ('MultiGrid-RedBlueDoors-6x6-v0', (2,)),
                       ('MultiGrid-RedBlueDoors-8x8-v0', (2,)),
                       ('MultiGrid-LockedHallway-2Rooms-v0', (2,)),
                       ('MultiGrid-LockedHallway-4Rooms-v0', (2,)),
                       ('MultiGrid-LockedHallway-6Rooms-v0', (2,)),
                       ('MultiGrid-Playground-v0', (1, 2, 10))]:
        for n in ns:
            env = make(env_id, agents=n, device=device)
            g = torch.Generator(device=env.device).manual_seed(n)
            state = env.reset_core(e, g).clone()
            for _ in range(6):
                state = env.step(state, torch.randint(0, 7, (e, n), generator=g,
                                                      device=env.device), g)[1]
            kind = torch.randint(0, 3, (e, n), generator=g, device=env.device)
            color = torch.randint(0, 6, (e, n), generator=g, device=env.device,
                                  dtype=torch.int32)
            carry = torch.stack([torch.tensor([TYPE_EMPTY, TYPE_KEY, TYPE_BOX],
                                              device=env.device, dtype=torch.int32)[kind],
                                 torch.where(kind == 0, 0, color), torch.zeros_like(color)], -1)
            grid = state.grid.clone()
            door = grid[..., 0] == TYPE_DOOR
            grid[..., 2] = torch.where(door, torch.randint(
                0, STATE_LOCKED + 1, door.shape, generator=g, device=env.device,
                dtype=torch.int32), grid[..., 2])
            state = state.replace(grid=grid, agent_carrying=carry)
            if not bool(door.flatten(1).any(-1).all()):
                fail(f'{env_id}: a layout without a door')
            out.append((f'{env_id[10:]} N={n}', state, env.cfg.view_size))
    return out


def zoo_obs_cases(device):
    """B1 ≡ its plain version on every procedural family's states (doors in
    every state, carried keys and boxes), images and packed, see-through
    walls off and on. Returns the largest abs difference."""
    import torch

    from multigrid_tpu_torch.ops import obs_cuda
    from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain

    max_err, cases = 0, 0
    for label, st, vs in zoo_states(device):
        for stw, packed in ((False, False), (False, True), (True, False)):
            got = obs_cuda.gen_obs_batched(st, vs, stw, packed)
            want = gen_obs_batched_plain(st, vs, stw, packed)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err, cases = max(max_err, err), cases + 1
            ok = torch.equal(got, want)
            print(f'  {"ok  " if ok else "FAIL"} {label} stw={stw} packed={packed} '
                  f'shape={tuple(got.shape)} max_abs_err={err}')
            if not ok:
                fail(f'obs kernel differs from plain version: {label}')
    print(f'{cases} zoo cases equal')
    return max_err


def general_cases(device):
    """The general obs kernel ≡ the plain version on the shapes obs_kernel
    does not take (views 33, 35 and 63; a 250x250 grid; 64 agents with view
    31), and ≡ obs_kernel on a shape both take; then its time at two shapes
    beside its bound and the plain version's. Launch counts are restored."""
    import torch

    from multigrid_tpu_torch.ops import obs_cuda
    from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain

    counts = _counts()
    max_err, n_cases = 0, 0
    shapes = [(32, 32, 2, 33, 256), (32, 32, 2, 35, 256), (64, 64, 1, 63, 64),
              (250, 250, 2, 7, 64), (32, 32, 64, 31, 16)]
    states = {}
    for w, h, n, vs, e in shapes:
        if obs_cuda.check_supported(n, w, h, vs) != 'general':
            fail(f'{w}x{h} N={n} view {vs} does not go to the general kernel')
        st = states[(w, h, n, vs)] = random_state(50 + vs + n, e, w, h, n, device)
        for stw in (False, True):
            for packed in (False, True):
                before = obs_cuda.general_launches
                got = obs_cuda.gen_obs_batched(st, vs, stw, packed)
                want = gen_obs_batched_plain(st, vs, stw, packed)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err, n_cases = max(max_err, err), n_cases + 1
                ok = torch.equal(got, want) and obs_cuda.general_launches == before + 1
                print(f'  {"ok  " if ok else "FAIL"} general {w}x{h} N={n} vs={vs} E={e} '
                      f'stw={stw} packed={packed} max_abs_err={err}')
                if not ok:
                    fail(f'general obs kernel differs from plain version: {w}x{h} N={n} vs={vs}')
    # A shape both take: the general kernel, forced, against obs_kernel.
    st = random_state(60, 1024, SIZE, SIZE, 9, device)
    route = obs_cuda.check_supported
    for packed in (False, True):
        want = obs_cuda.gen_obs_batched(st, VS, False, packed)
        obs_cuda.check_supported = lambda *a: 'general'
        try:
            got = obs_cuda.gen_obs_batched(st, VS, False, packed)
        finally:
            obs_cuda.check_supported = route
        torch.cuda.synchronize()
        n_cases += 1
        print(f'  {"ok  " if torch.equal(got, want) else "FAIL"} general = obs_kernel at '
              f'16x16 N=9 vs=7 E=1024 packed={packed}')
        if not torch.equal(got, want):
            fail('general obs kernel differs from obs_kernel at a shape both take')
    print(f'{n_cases} general-kernel cases equal')
    times = {}
    for key in [(250, 250, 2, 7), (32, 32, 2, 33)]:
        st, vs = states[key], key[3]
        ms = obs_launch_ms(st, vs, False, True, reps=50)
        call = event_ms(lambda: obs_cuda.gen_obs_batched(st, vs, False, True), 20)
        plain = event_ms(lambda: gen_obs_batched_plain(st, vs, False, True), 3)
        bd, by, nbytes, ops = general_bound(st, vs, True)
        label = f'{key[0]}x{key[1]} N={key[2]} vs={vs} E={st.num_envs} packed'
        times[label] = dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=bd, bound_by=by)
        print(f'general obs kernel {label}: launches {ms:.6f} ms (CUDA events), the '
              f'wrapper\'s call {call:.6f} ms; plain {plain:.6f} ms; bound {bd:.6f} ms by {by} '
              f'({nbytes} bytes, {ops} ops); {bd / ms:.4f} of the bound')
    _set_counts(counts)
    return dict(max_abs_err=max_err, cases=n_cases, times=times)


def wide_view_path(device=None, e=1024, steps=8):
    """Views past 31 through the entry points: ``VectorEnv(make(
    'MultiGrid-Empty-16x16-v0', agents=2, agent_view_size=33), 1024)``,
    reset and ``steps`` steps, the launch counts set to 0 just before and
    read just after (one general-kernel launch a call, no obs_kernel), each
    call's observations equal to the plain version."""
    import torch

    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain

    venv = VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=2, agent_view_size=33,
                          device=device), e)
    _zero_counts()
    obs, state = venv.reset(seed=0)
    pairs = [(obs['image'], state)]
    for _ in range(steps):
        actions = torch.randint(0, 7, (e, 2), generator=venv.generator, device=venv.device)
        obs, state, *_ = venv.step(state, actions)
        pairs.append((obs['image'], state))
    torch.cuda.synchronize()
    counts = _counts()
    want = {**{k: 0 for k in counts}, 'obs_general': steps + 1}
    print(f'view-33 VectorEnv, reset + {steps} steps: launches {counts}')
    if counts != want:
        fail(f'view-33 VectorEnv: expected launches {want}, got {counts}')
    for t, (image, st) in enumerate(pairs):
        if not torch.equal(image, gen_obs_batched_plain(st, 33, False)):
            fail(f'view-33 VectorEnv: observations differ from the plain version at call {t}')
    print(f'view-33 VectorEnv: all {len(pairs)} observations equal to the plain version')
    return counts['obs_general']


def fresh_extras_ok(state, fresh):
    """Whether the envs in ``fresh`` (E,) hold extras of their own layout:
    the mission color is the box's, the doors' cells hold the red and blue
    doors, no door is counted unlocked, the step count is 0."""
    import torch

    from multigrid_tpu_torch.core.constants import STATE_CLOSED, TYPE_BOX, TYPE_DOOR

    ok = state.step_count == 0
    ex, grid = state.extras, state.grid
    env = torch.arange(state.num_envs, device=grid.device)
    if 'mission_color' in ex:
        box = grid[..., 0] == TYPE_BOX
        ok &= torch.where(box, grid[..., 1], 0).flatten(1).sum(-1) == ex['mission_color']
        ok &= box.flatten(1).sum(-1) == 1
    for key, color in (('red_pos', 0), ('blue_pos', 2)):
        if key in ex:
            p = ex[key].long()
            cell = grid[env, p[:, 0], p[:, 1]]
            ok &= (cell[:, 0] == TYPE_DOOR) & (cell[:, 1] == color) & (cell[:, 2] == STATE_CLOSED)
    if 'door_unlocked' in ex:
        ok &= ~ex['door_unlocked'].any(-1)
    return bool((ok | ~fresh).all())


def env_layers(venv, state, steps=8, policy=None, chunk=None):
    """Where a step's host time goes, each layer synchronized: the policy
    (where ``policy(obs) -> actions`` is given, else uniform-random
    actions), then the stages of ``VectorEnv.step`` itself: the env step
    (``step_dynamics``: orders, dynamics, hook, done and success), the
    reset and merge (``reset_done``: an exact reset of every env, or with
    the reserve pool the consumption of its slots and the merge) and the
    observations (``observe``). With the pool the steps run with
    ``refresh=False`` (``next_pool``), as rollout loops run them, and one
    ``refresh_pool(chunk)`` follows (``chunk`` None: ``steps``), its time
    divided by ``chunk``: the amortized refresh, ``refresh``.
    Returns ``(state, obs, {layer: ms a step})``."""
    import torch

    g, e, n = venv.generator, venv.num_envs, venv.num_agents
    layers = {'policy': 0.0, 'step': 0.0, 'reset+merge': 0.0, 'obs': 0.0}
    obs = venv.observe(state)
    for _ in range(steps):
        pool = state.pool
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        actions = policy(obs) if policy is not None else torch.randint(
            0, 7, (e, n), generator=g, device=venv.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        obs_state, state, *_, done, _ = venv.step_dynamics(state, actions)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        obs_state, state = venv.reset_done(done, obs_state, state, pool)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        obs = venv.observe(obs_state)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if pool is not None:
            state = state.replace(pool=venv.next_pool(pool, refresh=False))
        for k, a, b in (('policy', t0, t1), ('step', t1, t2), ('reset+merge', t2, t3),
                        ('obs', t3, t4)):
            layers[k] += b - a
    out = {k: v / steps * 1e3 for k, v in layers.items() if policy is not None or k != 'policy'}
    if state.pool is not None:
        chunk = chunk or steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = venv.refresh_pool(state, chunk)
        torch.cuda.synchronize()
        out['refresh'] = (time.perf_counter() - t0) / chunk * 1e3
    return state, obs, out


def reset_share(layers):
    """The reset's share of the env step's host time: reset and merge (and
    the amortized refresh of the pool) over step, reset, refresh and obs."""
    reset = layers['reset+merge'] + layers.get('refresh', 0.0)
    return reset / (sum(layers.values()) - layers.get('policy', 0.0))


@contextlib.contextmanager
def obs_checked():
    """Inside, every observation a ``VectorEnv`` or an env's own ``reset``,
    ``step`` and ``observe`` (the adapters' path) make through the kernel
    is also made by the plain version on the same state; yields the list
    to which each call that differs adds its env count."""
    import torch

    from multigrid_tpu_torch.envs import env as env_module
    from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain
    from multigrid_tpu_torch.parallel import vector

    kernel = vector.gen_obs_batched
    mismatches = []

    def checked(state, view_size, see_through_walls, packed=False):
        got = kernel(state, view_size, see_through_walls, packed)
        if not torch.equal(got, gen_obs_batched_plain(state, view_size, see_through_walls,
                                                       packed)):
            mismatches.append(state.num_envs)
        return got

    vector.gen_obs_batched = env_module.gen_obs_batched = checked
    try:
        yield mismatches
    finally:
        vector.gen_obs_batched = env_module.gen_obs_batched = kernel


def zoo(device=None, steps=32):
    """Each of the 13 configurations, 2 agents, 4096 envs on the card, with
    the exact reset (``reset_pool=False``; the pool phase covers the pool):

    - correctness with ``max_steps=16``, so that every env resets twice in
      ``steps`` random steps: the launch counts set to 0 just before the
      reset and read just after the last step (one obs launch a call), each
      call's observations equal to the plain version on the state it
      observed, and every env that finished holding its fresh layout's
      extras;
    - at the registered ``max_steps``, where a step's host time goes
      (step, reset and merge, obs) and the reset's share of it;
    - one golden trace per procedural family replayed on the card.
    """
    import torch

    from multigrid_tpu_torch import CONFIGURATIONS, VectorEnv, make

    shares, launches = {}, 0
    for env_id in sorted(CONFIGURATIONS):
        venv = VectorEnv(make(env_id, agents=2, max_steps=16, device=device), E,
                         reset_pool=False)
        if venv.device.type != 'cuda':
            fail(f'default device is {venv.device}, not cuda')
        with obs_checked() as mismatches:
            _zero_counts()
            obs, state = venv.reset(seed=0)
            dones = 0
            for t in range(steps):
                actions = torch.randint(0, 7, (E, 2), generator=venv.generator,
                                        device=venv.device)
                obs, state, _, _, _, done, _ = venv.step(state, actions)
                dones += int(done.sum())
                if not fresh_extras_ok(state, done):
                    fail(f'{env_id}: an env that finished at step {t} holds stale extras')
            torch.cuda.synchronize()
        counts = _counts()
        want = {**{k: 0 for k in counts}, 'obs': steps + 1}
        if counts != want:
            fail(f'{env_id}: expected launches {want}, got {counts}')
        if mismatches:
            fail(f'{env_id}: observations differ from the plain version')
        if dones < 2 * E:
            fail(f'{env_id}: {dones} episodes ended in {steps} steps, fewer than {2 * E}')
        if 'mission' in obs and not torch.equal(
                obs['mission'][:, 0], state.extras['mission_color'] * 2):
            fail(f'{env_id}: the observed missions are not the episodes\'')
        launches += counts['obs']

        venv = VectorEnv(make(env_id, agents=2, device=device), E, reset_pool=False)
        _, state = venv.reset(seed=1)
        env_layers(venv, state, 2)  # warm-up
        _, _, layers = env_layers(venv, state, 8)
        shares[env_id] = dict(**layers, reset_share=reset_share(layers))
        print(f'{env_id}: reset + {steps} steps (max_steps 16, {dones} episodes ended): '
              f'launches {counts}, observations equal to the plain version, fresh extras ok; '
              f'per-step host time (registered max_steps): ' + ', '.join(
                  f'{k} {v:.4f} ms' for k, v in layers.items())
              + f'; reset share {reset_share(layers):.4f}')
    for env_id, seed, n in ZOO_GOLDEN:
        replay_golden(env_id, seed, n, device)
    return dict(launches=launches, reset_share=shares)


# ------------------------------------------------ BlockedUnlockPickup recipe

def bup_train(device=None):
    """The JAX package's production recipe on the card: BlockedUnlockPickup,
    2 agents, 4096 envs, mlp 128 bf16 with 12 missions, T 128, 2 epochs x 4
    minibatches. Three updates with the launch counts set to 0 just before
    and checked exactly just after (128 obs launches, 129 first-layer
    launches and 8 loss-kernel launches an update, no gradient kernel);
    metrics finite and every parameter group moving; then one update from
    the same state on the fused-policy variant (128 policy launches, F 14),
    whose metrics track the default path's first update."""
    import torch

    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init

    venv = VectorEnv(make(BUP, agents=BUP_N, device=device), E, packed_obs=True)
    if venv.device.type != 'cuda':
        fail(f'default device is {venv.device}, not cuda')
    cfg = PPOConfig(rollout_steps=BUP_T, epochs=BUP_EPOCHS, minibatches=BUP_MB)
    state, net, cfg, tx = ppo_init(venv, 0, config=cfg, hidden=HIDDEN,
                                   net_kwargs=dict(encoder='mlp'))
    if net.num_missions != 12 or state.params['Dense_0.kernel'].shape[0] != BUP_F:
        fail(f'BUP net has {net.num_missions} missions, not 12')
    step = make_train_step(venv, net, cfg, tx)
    snap = _snapshot(step, state)
    sgd = BUP_EPOCHS * BUP_MB
    after, rows = _counted(step, snap, 3, 'BUP recipe', onehot_linear=3 * (BUP_T + 1),
                           ppo_loss=3 * sgd)
    counts = _counts()
    moved = [k for k in snap[0].params if not torch.equal(snap[0].params[k], after.params[k])]
    print(f'  {len(moved)} of {len(snap[0].params)} parameters moved; metrics of the last '
          'update: ' + json.dumps(rows[-1]))
    if len(moved) != len(snap[0].params):
        fail(f'BUP recipe: parameters that did not move: '
             f'{sorted(set(snap[0].params) - set(moved))}')
    os.environ['MULTIGRID_FUSED_POLICY'] = '1'
    try:
        fused = make_train_step(venv, net, cfg, tx)
    finally:
        del os.environ['MULTIGRID_FUSED_POLICY']
    if not fused.fused_policy:
        fail('MULTIGRID_FUSED_POLICY does not select the fused policy on the BUP recipe')
    _, rows_f = _counted(fused, snap, 1, 'BUP recipe, fused policy (F 14)', onehot_linear=1,
                         ppo_loss=sgd, policy_sample=BUP_T)
    counts_fused = _counts()
    _track(rows_f, rows[:1], 'BUP fused policy vs default path')
    return venv, step, fused, after, counts, counts_fused


def bup_timing(venv, step, fused, state):
    """The BUP recipe's trained agent-steps/s (median of 3 length-differenced
    pairs of 1 and 3 updates), a rollout step's layers (policy, step, reset
    and merge, obs) with and without the fused policy, and each kernel at
    the recipe's shapes on a rollout's data beside its bound, its plain
    version and a library call: B1 (4096, 2, 11x6, view 7, packed), B2
    (8192, 49, 128), B4 (262,144, F 14; B3 inside it) and B5 (8192, F 14).
    Launch counts are restored."""
    import statistics

    import torch
    import torch.nn.functional as F

    from multigrid_tpu_torch.learn import ppo
    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.ops import fused_policy as fp
    from multigrid_tpu_torch.ops import fused_ppo
    from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain

    counts = _counts()
    samples = E * BUP_N * BUP_T
    short, long_ = 1, 3
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = _run(step, state, short)
        t1 = time.perf_counter()
        state, _ = _run(step, state, long_)
        t2 = time.perf_counter()
        rates.append(samples * (long_ - short) / ((t2 - t1) - (t1 - t0)))
    rate = statistics.median(rates)
    print(f'BUP recipe trained agent-steps/s (median of 3, length-differenced {short}/{long_} '
          f'updates): {rate:.6e} ({samples / rate * 1e3:.4f} ms/update; pairs '
          + ', '.join(f'{r:.6e}' for r in rates) + ')')

    layers = {}
    for label, s in (('default path', step), ('fused policy', fused),
                     ('fused policy', fused), ('default path', step)):
        state, lay = rollout_layers(s, state, 8)
        layers.setdefault(label, []).append(lay)
        print(f'  BUP reset share of the env step, {label}: {reset_share(lay):.4f}')

    state = profile_update(step, state, 'BUP recipe update')

    # The kernels at the recipe's shapes, on a rollout's data.
    with torch.no_grad():
        state, traj, last_value, _ = step.rollout_phase(state)
        adv, tg = step.compute_gae(traj, last_value)
    env_state = state.env_state
    out = {}
    ms = obs_launch_ms(env_state, VS, False, True)
    plain = event_ms(lambda: gen_obs_batched_plain(env_state, VS, False, True), 10)
    bd, by, nbytes, _ = obs_bound(env_state, VS, True)
    out['obs'] = dict(shape=[E, BUP_N, 11, 6, VS], ms=ms, plain_ms=plain, bound_ms=bd,
                      bound_by=by, library_ms=None)
    b8 = E * BUP_N
    w = state.params['img_kernel']
    packed8 = traj.image[0].reshape(b8, C).contiguous()
    rows = (torch.stack([packed8 >> 8, 11 + ((packed8 >> 4) & 15), 17 + (packed8 & 15)], -1)
            + 21 * torch.arange(C, device=w.device)[:, None]).reshape(b8, -1).long()
    ms = onehot_launch_ms(packed8, w)
    plain = event_ms(lambda: fl.onehot_linear_plain(packed8, w), 10)
    lib = event_ms(lambda: F.embedding_bag(rows, w, mode='sum'), 100)
    bd = bound(packed8.numel() * 4 + w.numel() * 4 + b8 * HIDDEN * 2,
               ops_ms=onehot_ms(nonzeros(packed8), b8, C, HIDDEN, 'BUP onehot_linear'))
    out['onehot_linear'] = dict(shape=[b8, C, HIDDEN], ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=bd[0], bound_by=bd[1])
    perm = torch.randperm(BUP_T, device=w.device)
    tr, a, t = next(ppo.minibatches((traj, adv, tg), BUP_MB, perm, 0))
    args = step.kernel_inputs(tr, a, t)
    b = args[0].shape[0]
    if b != samples // BUP_MB or args[1].shape[1] != BUP_F:
        fail(f'BUP minibatch kernel inputs {tuple(args[0].shape)}, {tuple(args[1].shape)}')
    p = state.params
    kw = dict(clip_eps=step.config.clip_eps, vf_coef=step.config.vf_coef,
              ent_coef=step.config.ent_coef, num_actions=7)
    ms = event_ms(lambda: fused_ppo.ppo_mlp_grads(p, *args, **kw), 10)
    plain = event_ms(lambda: fused_ppo.ppo_mlp_grads_plain(
        p, *args, compute_dtype=torch.bfloat16, **kw), 3)
    stages = ppo_stages(lambda: fused_ppo.ppo_mlp_grads(p, *args, **kw))
    param_bytes = sum(v.numel() * 4 for v in p.values())
    f1 = BUP_F + 1
    nnz = nonzeros(args[0])
    bd = bound(sum(x.numel() * x.element_size() for x in args) + 2 * param_bytes,
               tensor_ops=2 * b * (2 * f1 * HIDDEN + 3 * HIDDEN * HIDDEN + 3 * HIDDEN * 8),
               ops_ms=2 * onehot_ms(nnz, b, C, HIDDEN, 'BUP ppo_loss (h and dW_img, each)'))
    print(f'BUP ppo_loss B={b} F={BUP_F} stages (torch.profiler, ms): '
          + ', '.join(f'{k} {v:.6f}' for k, v in stages.items()))
    out['ppo_loss'] = dict(shape=[b, C, HIDDEN, BUP_F], ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=bd[0], bound_by=bd[1], stages=stages)
    wp = fp.prepare(p)
    obs = state.last_obs
    dirf = step.dir_features(obs['direction'], obs['mission']).reshape(b8, BUP_F)
    gumbel = -torch.log(-torch.log(torch.rand(b8, 7, device=w.device).clamp_min(1e-30)))
    ms = policy_launch_ms(wp, packed8, dirf, gumbel)
    plain = event_ms(lambda: fp.policy_sample_plain(wp, packed8, dirf, gumbel,
                                                    compute_dtype=torch.bfloat16), 10)
    in_bytes = sum(x.numel() * x.element_size() for x in [packed8, dirf, gumbel, *wp.values()])
    bd = bound(in_bytes + 12 * b8,
               tensor_ops=2 * b8 * (HIDDEN * HIDDEN + (BUP_F + 1) * HIDDEN + 8 * HIDDEN),
               ops_ms=onehot_ms(nonzeros(packed8), b8, C, HIDDEN, 'BUP policy_sample'))
    out['policy_sample'] = dict(shape=[b8, C, HIDDEN, BUP_F], ms=ms, plain_ms=plain,
                                library_ms=None, bound_ms=bd[0], bound_by=bd[1])
    _set_counts(counts)
    for name, r in out.items():
        lib = 'none' if r['library_ms'] is None else f'{r["library_ms"]:.6f} ms'
        print(f'BUP {name} {r["shape"]}: {r["ms"]:.6f} ms/launch; plain {r["plain_ms"]:.6f} ms; '
              f'library {lib}; bound {r["bound_ms"]:.6f} ms by {r["bound_by"]}; '
              f'{r["bound_ms"] / r["ms"]:.4f} of the bound')
    return dict(rate=rate, layers=layers, kernels=out)


# ------------------------------------------------------- the reserve pool

#: The procedural families the pool phases drive (each family's layouts).
POOL_FAMILIES = ('MultiGrid-BlockedUnlockPickup-v0', 'MultiGrid-RedBlueDoors-8x8-v0',
                 'MultiGrid-LockedHallway-2Rooms-v0', 'MultiGrid-LockedHallway-6Rooms-v0',
                 'MultiGrid-Playground-v0')


def pool_path(device=None, e=E, steps=48):
    """The reserve pool on each procedural family, 2 agents, ``e`` envs,
    ``max_steps`` 16 (period 16), ``steps`` random steps with
    ``refresh=False`` in chunks of 16, each followed by ``refresh_pool(16)``
    (the JAX package's ``rollout_random``), the launch counts set to 0 just
    before the reset and read just after (one obs launch a call, no other
    kernel). Checks that every env that finished holds reserve slot ``(i +
    g) mod E`` as read just before its step, fields and extras; that no
    env takes the layout it just played (the slot and that slot's last
    refresh differ from its previous layout's: grids alone may repeat by
    chance, RedBlueDoors-8x8 has 36 door layouts); that each refresh
    rewrites only the slots ``refresh_slots`` names and every slot is
    regenerated within the period; and that every call's observations
    equal the plain version. Then each family's step layers with the pool at its
    registered ``max_steps`` (16 steps and one ``refresh_pool(16)``) and
    the reset share. Returns ``{'launches', 'layers'}``."""
    import torch

    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.core.state import FIELDS

    chunk = VectorEnv.REFRESH_CHUNK
    launches, out = 0, {}
    for env_id in POOL_FAMILIES:
        venv = VectorEnv(make(env_id, agents=2, max_steps=16, device=device), e)
        if device is None and venv.device.type != 'cuda':
            fail(f'default device is {venv.device}, not cuda')
        if not venv.reset_pool or venv.reset_pool_period != 16:
            fail(f'{env_id}: pool {venv.reset_pool}, period {venv.reset_pool_period}')
        with obs_checked() as mismatches:
            _zero_counts()
            _, state = venv.reset(seed=0)
            env_i = torch.arange(e, device=venv.device)
            # Each slot's last refresh (the step it was made at), and where
            # each env's layout came from: (slot, that refresh), (-1, -1)
            # for the reset's own.
            regenerated = torch.zeros(e, dtype=torch.int64, device=venv.device)
            origin = torch.full((e, 2), -1, dtype=torch.int64, device=venv.device)
            dones = 0
            for t in range(steps):
                slots = venv.consume(state.pool)
                slot = (env_i + state.pool.step) % e
                actions = torch.randint(0, 7, (e, 2), generator=venv.generator,
                                        device=venv.device)
                _, state, *_, done, _ = venv.step(state, actions, refresh=False)
                dones += int(done.sum())
                if not all(torch.equal(getattr(state, f)[done], getattr(slots, f)[done])
                           for f in FIELDS) or not all(
                        torch.equal(v[done], slots.extras[k][done])
                        for k, v in state.extras.items()):
                    fail(f'{env_id}: a finished env at step {t} does not hold its slot')
                taken = torch.stack([slot, regenerated[slot]], -1)
                if ((taken == origin).all(-1) & done).any():
                    fail(f'{env_id}: an env replayed its layout at step {t}')
                origin = torch.where(done[:, None], taken, origin)
                if (t + 1) % chunk == 0:
                    before = state.pool.reserve
                    start, count = venv.refresh_slots(state.pool.step, chunk)
                    state = venv.refresh_pool(state, chunk)
                    kept = torch.ones(e, dtype=torch.bool, device=venv.device)
                    kept[start:start + count] = False
                    if not all(torch.equal(getattr(state.pool.reserve, f)[kept],
                                           getattr(before, f)[kept]) for f in FIELDS):
                        fail(f'{env_id}: a refresh rewrote slots outside {start}:{start + count}')
                    regenerated[start:start + count] = state.pool.step
                stale = state.pool.step - int(regenerated.min())
                if stale > venv.reset_pool_period:
                    fail(f'{env_id}: a slot went {stale} steps without a refresh')
            torch.cuda.synchronize()
        counts = _counts()
        want = {**{k: 0 for k in counts}, 'obs': steps + 1}
        if counts != want:
            fail(f'{env_id}: expected launches {want}, got {counts}')
        if mismatches:
            fail(f'{env_id}: observations differ from the plain version')
        if dones < 2 * e:
            fail(f'{env_id}: {dones} episodes ended in {steps} steps, fewer than {2 * e}')
        launches += counts['obs']

        venv = VectorEnv(make(env_id, agents=2, device=device), e)
        _, state = venv.reset(seed=1)
        state, _, _ = env_layers(venv, state, 2)  # warm-up
        _, _, layers = env_layers(venv, state, chunk)
        out[env_id] = dict(**layers, reset_share=reset_share(layers))
        print(f'{env_id}, pool: reset + {steps} steps (max_steps 16, {dones} episodes ended): '
              f'launches {counts}, every finished env holds its slot, no replay, refreshes '
              'within the period, observations equal to the plain version; per-step host '
              f'time (registered max_steps {venv.env.cfg.max_steps}, period '
              f'{venv.reset_pool_period}): ' + ', '.join(
                  f'{k} {v:.4f} ms' for k, v in layers.items())
              + f'; reset share {reset_share(layers):.4f}')
    return dict(launches=launches, layers=out)


def pool_timing(device=None, pairs=2):
    """BlockedUnlockPickup at 4096 envs and its registered ``max_steps``,
    with the pool and with ``reset_pool=False``, in turns (pool, exact,
    exact, pool): the env step's layers (step, reset or consume and merge,
    the amortized refresh over a chunk of 16, obs) and the reset share;
    then the BUP recipe's trained agent-steps/s on each, ``pairs``
    length-differenced pairs of 1 and 2 updates each, in turns, each turn
    after one untimed update (the other path ran last)."""
    import statistics

    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init

    order = ['pool', 'exact', 'exact', 'pool'] * (pairs // 2)
    venvs = {label: VectorEnv(make(BUP, agents=BUP_N, device=device), E,
                              reset_pool=None if label == 'pool' else False)
             for label in ('pool', 'exact')}
    states = {}
    for label, venv in venvs.items():
        _, state = venv.reset(seed=1)
        states[label], _, _ = env_layers(venv, state, 2)  # warm-up
    layers = {'pool': [], 'exact': []}
    for label in order:
        states[label], _, lay = env_layers(venvs[label], states[label], VectorEnv.REFRESH_CHUNK)
        layers[label].append(dict(**lay, reset_share=reset_share(lay)))
        print(f'BUP env step, {label}: ' + ', '.join(f'{k} {v:.4f} ms' for k, v in lay.items())
              + f'; reset share {reset_share(lay):.4f}')

    samples = E * BUP_N * BUP_T
    runs = {}
    for label in ('pool', 'exact'):
        venv = VectorEnv(make(BUP, agents=BUP_N, device=device), E, packed_obs=True,
                         reset_pool=None if label == 'pool' else False)
        cfg = PPOConfig(rollout_steps=BUP_T, epochs=BUP_EPOCHS, minibatches=BUP_MB)
        state, net, cfg, tx = ppo_init(venv, 0, config=cfg, hidden=HIDDEN,
                                       net_kwargs=dict(encoder='mlp'))
        step = make_train_step(venv, net, cfg, tx)
        state, _ = _run(step, state, 1)  # warm-up
        runs[label] = [step, state]
    rates = {'pool': [], 'exact': []}
    for label in order:
        step, state = runs[label]
        state, _ = _run(step, state, 1)
        t0 = time.perf_counter()
        state, _ = _run(step, state, 1)
        t1 = time.perf_counter()
        state, _ = _run(step, state, 2)
        t2 = time.perf_counter()
        runs[label][1] = state
        rates[label].append(samples / ((t2 - t1) - (t1 - t0)))
        print(f'  BUP recipe, {label}: 1 update {t1 - t0:.6f} s, 2 updates {t2 - t1:.6f} s')
    for label, r in rates.items():
        print(f'BUP recipe trained agent-steps/s, {label} (length-differenced 1/2 updates, in '
              f'turns): median {statistics.median(r):.6e}; pairs '
              + ', '.join(f'{x:.6e}' for x in r))
    return dict(layers=layers, rates=rates)


# ------------------------------------------------------------ the cnn

def cnn_vs_cpu(net, params, obs, label, samples=2048):
    """The cnn on the card (bf16, cuDNN) against the float32 net on the CPU
    with the same weights, on ``samples`` of the observations: logits and
    values within ``max|Δ|/(|want|+1) < 2e-2`` (B2's tolerance); each
    parameter's gradient of ``Σ logits·u + Σ value`` within ``‖Δ‖/‖want‖ <
    0.1``: bf16 rounds the activations and the gradients at each of the
    five layers the backward passes to reach ``Conv_0`` (the CPU's own bf16
    net read 3.1e-2 there on 2048 random samples, 6.8e-2 on 256)."""
    import torch

    from multigrid_tpu_torch.learn.nets import ActorCritic

    cells = obs['image'].reshape(-1, obs['image'].shape[-1])[:samples]
    direction = obs['direction'].reshape(-1)[:samples]
    mission = obs.get('mission')
    mission = None if mission is None else mission.reshape(-1)[:samples]
    u = torch.randn(len(cells), net.num_actions, generator=torch.Generator().manual_seed(0))
    outs = []
    for dev, dtype in ((torch.device('cpu'), torch.float32), (cells.device, torch.bfloat16)):
        m = ActorCritic(net.num_cells, hidden=net.hidden, packed_obs=True, dtype=dtype,
                        num_missions=net.num_missions, encoder='cnn').to(dev)
        m.load_state_dict({k: v.to(dev) for k, v in params.items()})
        logits, value = m(cells.to(dev), direction.to(dev),
                          None if mission is None else mission.to(dev))
        ((logits * u.to(dev)).sum() + value.sum()).backward()
        outs.append(dict(logits=logits.detach().float().cpu(), value=value.detach().cpu(),
                         **{k: p.grad.cpu() for k, p in m.named_parameters()}))
    want, got = outs
    err_out = max(float(((got[k] - want[k]).abs() / (want[k].abs() + 1)).max())
                  for k in ('logits', 'value'))
    err_grad = max(float((got[k] - want[k]).norm() / (want[k].norm() + 1e-12))
                   for k in want if k not in ('logits', 'value'))
    print(f'cnn {label}: card (bf16) vs CPU (float32) on {len(cells)} samples: outputs '
          f'{err_out:.3e} (< 2e-2), gradients {err_grad:.3e} of each leaf\'s norm (< 0.1)')
    if err_out >= 2e-2 or err_grad >= 0.1:
        fail(f'cnn {label}: the card differs from the CPU float32 version')
    return err_out, err_grad


def cnn_train(device=None):
    """PPO with the cnn encoder through the entry points: the JAX CLI's
    defaults (Empty-8x8, 2 agents, 1024 envs, cnn, hidden 128, T 16) and
    the flagship (Empty-16x16, 4 agents, 4096 envs). Each: 3 updates with
    the launch counts set to 0 just before and checked exactly after (the
    obs kernel once a step, no first-layer, loss or policy kernel: the cnn
    runs through autograd and conv2d), every parameter moving, metrics
    finite; the card against the CPU's float32 net (:func:`cnn_vs_cpu`);
    trained agent-steps/s (median of 3 pairs of 1 and 3 updates) and the
    device's busy share in one profiled update."""
    import statistics

    import torch

    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init

    out = {}
    for label, env_id, n, e in (('CLI defaults', 'MultiGrid-Empty-8x8-v0', 2, 1024),
                                ('flagship', 'MultiGrid-Empty-16x16-v0', N, E)):
        venv = VectorEnv(make(env_id, agents=n, device=device), e, packed_obs=True)
        if device is None and venv.device.type != 'cuda':
            fail(f'default device is {venv.device}, not cuda')
        state, net, cfg, tx = ppo_init(venv, 0, config=PPOConfig(rollout_steps=TRAIN_T),
                                       net_kwargs=dict(hidden=HIDDEN, encoder='cnn'))
        step = make_train_step(venv, net, cfg, tx)
        snap = _snapshot(step, state)
        after, rows = _counted(step, snap, 3, f'cnn {label}')
        counts = _counts()
        moved = [k for k in snap[0].params
                 if not torch.equal(snap[0].params[k], after.params[k])]
        if len(moved) != len(snap[0].params):
            fail(f'cnn {label}: parameters that did not move: '
                 f'{sorted(set(snap[0].params) - set(moved))}')
        print(f'  metrics of the last update: ' + json.dumps(rows[-1]))
        errs = cnn_vs_cpu(net, after.params, after.last_obs, label)
        samples = e * n * TRAIN_T
        rates = []
        state = after
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = _run(step, state, 1)
            t1 = time.perf_counter()
            state, _ = _run(step, state, 3)
            t2 = time.perf_counter()
            rates.append(samples * 2 / ((t2 - t1) - (t1 - t0)))
        rate = statistics.median(rates)
        print(f'cnn {label} trained agent-steps/s (median of 3, length-differenced 1/3 '
              f'updates): {rate:.6e} ({samples / rate * 1e3:.4f} ms/update; pairs '
              + ', '.join(f'{r:.6e}' for r in rates) + ')')
        profile_update(step, state, f'cnn {label} update')
        out[label] = dict(rate=rate, launches=counts, errors=errs)
    return out


# ---------------------------------------------------------- checkpoints

def resume_path(device=None):
    """Exact resume at the flagship (Empty-16x16, 4 agents, 4096 envs,
    packed cells, hidden 128, T 16) through ``utils/checkpoint.py``: 2
    updates, a checkpoint, 1 more update; then freshly built objects
    restored from the checkpoint and 1 update. Parameters, optimizer state,
    env state, last observations and both generators must equal the
    uninterrupted run's bit for bit: on the mlp default path (B2, B4; B3
    and B4 are equal from run to run) and on the cnn with
    ``torch.backends.cudnn.deterministic`` set."""
    import torch

    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.core.state import FIELDS
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    def build(encoder):
        venv = VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=N, device=device), E,
                         packed_obs=True)
        state, net, cfg, tx = ppo_init(venv, 0, config=PPOConfig(rollout_steps=TRAIN_T),
                                       net_kwargs=dict(hidden=HIDDEN, encoder=encoder))
        return venv, state, make_train_step(venv, net, cfg, tx)

    def differing(a, b, venv_a, venv_b):
        pairs = [(f'params.{k}', a.params[k], b.params[k]) for k in a.params]
        pairs += [(f'opt_state.mu.{k}', a.opt_state.mu[k], b.opt_state.mu[k])
                  for k in a.opt_state.mu]
        pairs += [(f'opt_state.nu.{k}', a.opt_state.nu[k], b.opt_state.nu[k])
                  for k in a.opt_state.nu]
        pairs += [(f'env_state.{f}', getattr(a.env_state, f), getattr(b.env_state, f))
                  for f in FIELDS]
        pairs += [(f'last_obs.{k}', a.last_obs[k], b.last_obs[k]) for k in a.last_obs]
        pairs += [('ep_return_acc', a.ep_return_acc, b.ep_return_acc),
                  ('generator', a.generator.get_state(), b.generator.get_state()),
                  ('env generator', venv_a.generator.get_state(), venv_b.generator.get_state())]
        bad = [name for name, x, y in pairs if not torch.equal(x, y)]
        if (a.opt_state.count, a.update_count) != (b.opt_state.count, b.update_count):
            bad.append('counts')
        return bad, len(pairs)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for encoder in ('mlp', 'cnn'):
            torch.backends.cudnn.deterministic = encoder == 'cnn'
            try:
                venv, state, step = build(encoder)
                state, _ = _run(step, state, 2)
                path = save_checkpoint(os.path.join(tmp, f'{encoder}_step_2'), state, venv)
                straight, _ = _run(step, state, 1)
                venv2, fresh, step2 = build(encoder)
                resumed = restore_checkpoint(path, fresh, venv2)
                resumed, _ = _run(step2, resumed, 1)
                bad, total = differing(resumed, straight, venv2, venv)
            finally:
                torch.backends.cudnn.deterministic = False
            size = os.path.getsize(path)
            print(f'resume, {encoder}: 2 updates, checkpoint ({size} bytes), restore into '
                  f'fresh objects, 1 update vs 3 straight: '
                  + (f'all {total} tensors and both generators bit-equal' if not bad
                     else f'differ in {bad}'))
            if bad:
                fail(f'resume on the {encoder} is not exact: {bad}')
            out[encoder] = dict(equal=True, checkpoint_bytes=size)
    return out


def cli_path(tmp, updates=4):
    """The entry points as a user runs them, each its own process on the
    card: ``python -m multigrid_tpu_torch.train`` on BlockedUnlockPickup
    with the JAX CLI's defaults (cnn, packed cells, the pool; 1024 envs,
    T 16) for ``updates // 2`` updates, saving every 2 into the directory
    ``tmp``; again with ``--load-dir`` to ``updates``; then ``python -m
    multigrid_tpu_torch.evaluate --load-dir`` for one 256-step iteration
    on episodes of at most 64 steps (``--env-config``; the registered 576
    would end none). Each must exit 0 and print JSON rows that parse."""
    def run(args, label):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, '-m'] + args, cwd=HERE, capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            fail(f'cli {label}: exit {res.returncode}: {res.stderr[-3000:]}')
        lines = res.stdout.splitlines()
        rows = [json.loads(line) for line in lines if line.startswith('{')]
        if not rows:
            fail(f'cli {label}: no JSON row in {res.stdout[-2000:]}')
        print(f'cli {label} ({time.perf_counter() - t0:.1f} s): {lines[0]}; last row '
              f'{json.dumps(rows[-1])}' + (f'; {lines[-1]}' if lines[-1].startswith('timing')
                                           else ''))
        return lines, rows

    e, n, t = 1024, 2, 16
    train = ['multigrid_tpu_torch.train', '--env', BUP, '--num-agents', str(n),
             '--num-envs', str(e), '--rollout-steps', str(t), '--save-dir', tmp,
             '--save-interval', '2', '--log-interval', '1']
    run(train + ['--num-timesteps', str(updates // 2 * e * n * t)], 'train')
    lines, rows = run(train + ['--num-timesteps', str(updates * e * n * t), '--load-dir',
                               tmp], 'resume')
    if not lines[0].startswith(f'resumed from {os.path.join(tmp, "step_")}') or \
            rows[-1]['update'] != updates:
        fail(f'cli resume: {lines[0]}, last update {rows[-1]["update"]}')
    _, rows = run(['multigrid_tpu_torch.evaluate', '--env', BUP, '--num-agents', str(n),
                   '--num-envs', str(e), '--num-steps', str(256 * e * n), '--load-dir',
                   tmp, '--env-config', '{"max_steps": 64}'], 'evaluate')
    if rows[-1]['agent_steps'] != 256 * e * n or rows[-1]['episodes'] < e:
        fail(f'cli evaluate: {rows[-1]}')
    return rows[-1]


# ------------------------------------------------ the user-facing surface

WRAPPERS = ('FullyObsWrapper', 'ImgObsWrapper', 'OneHotObsWrapper')
#: What each wrapper makes of the flagship's (view 7, 16x16) images.
WRAPPED_IMAGES = {'FullyObsWrapper': ((SIZE, SIZE, 3), 'torch.int32'),
                  'ImgObsWrapper': ((VS, VS, 3), 'torch.uint8'),
                  'OneHotObsWrapper': ((VS, VS, 21), 'torch.uint8')}


def obs_equal(a, b):
    """Observation trees equal: the same keys, dtypes and values."""
    import torch
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            obs_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def wrapped_plain(venv, state):
    """The wrapped observations of ``state`` from the plain observation
    version: raw images, missions, then the env's wrapper chain."""
    from multigrid_tpu_torch.ops.obs import gen_obs_batched_plain
    cfg = venv.env.cfg
    raw = gen_obs_batched_plain(state, cfg.view_size, cfg.see_through_walls, venv.packed_obs)
    obs = venv.env.attach_mission({'image': raw, 'direction': state.agent_dir}, state)
    return venv.env.transform_obs(obs, state)


def wrappers_path(device=None, steps=32):
    """Each observation wrapper over the flagship ``VectorEnv`` (Empty-16x16,
    4 agents, 4096 envs), and OneHot over BUP (2 agents, 4096 envs) on its
    reserve pool: reset and ``steps`` random steps, the launch counts set to
    0 just before and read just after (one obs launch a call, no other
    kernel), every call's raw observations equal to the plain version, and
    the wrapped observations of the last state equal to the wrapper chain
    on the plain version's, with the wrapper's shape and dtype. Returns
    the obs launches."""
    import torch

    from multigrid_tpu_torch import VectorEnv, make, wrappers

    launches = 0
    cases = [(w, 'MultiGrid-Empty-16x16-v0', N) for w in WRAPPERS] + \
        [('OneHotObsWrapper', BUP, BUP_N)]
    for name, env_id, n in cases:
        venv = VectorEnv(getattr(wrappers, name)(make(env_id, agents=n, device=device)), E)
        if device is None and venv.device.type != 'cuda':
            fail(f'default device is {venv.device}, not cuda')
        with obs_checked() as mismatches:
            _zero_counts()
            obs, state = venv.reset(seed=0)
            for _ in range(steps):
                actions = torch.randint(0, 7, (E, n), generator=venv.generator,
                                        device=venv.device)
                obs, state, *_ = venv.step(state, actions)
            torch.cuda.synchronize()
        counts = _counts()
        want = {**{k: 0 for k in counts}, 'obs': steps + 1}
        if counts != want:
            fail(f'{name} on {env_id}: expected launches {want}, got {counts}')
        if mismatches:
            fail(f'{name} on {env_id}: observations differ from the plain version')
        image = obs if name == 'ImgObsWrapper' else obs['image']
        if env_id != BUP and (tuple(image.shape[2:]), str(image.dtype)) != WRAPPED_IMAGES[name]:
            fail(f'{name}: images {tuple(image.shape)} {image.dtype}')
        if env_id == BUP and not torch.equal(obs['mission'][:, 0],
                                             state.extras['mission_color'] * 2):
            fail(f'{name} on {env_id}: the observed missions are not the episodes\'')
        if not obs_equal(venv.observe(state), wrapped_plain(venv, state)):
            fail(f'{name} on {env_id}: wrapped observations differ from the plain version\'s')
        launches += counts['obs']
        print(f'{name} over {env_id} ({n} agents, {E} envs, pool {venv.reset_pool}): reset + '
              f'{steps} steps, launches {counts}, images {tuple(image.shape)} {image.dtype}, '
              'equal to the plain version')
    return launches


def _step_ms(venv, state, steps):
    """Synchronized host ms a ``VectorEnv.step`` with random actions."""
    import torch
    e, n = venv.num_envs, venv.num_agents
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        actions = torch.randint(0, 7, (e, n), generator=venv.generator, device=venv.device)
        _, state, *_ = venv.step(state, actions)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) / steps * 1e3


def wrapper_timing(device=None, rounds=4, steps=16):
    """ms a ``VectorEnv.step`` unwrapped and under each wrapper, in turns
    (the order reversed every other round), median of ``rounds``: the
    flagship (Empty-16x16, 4 agents, 4096 envs) and BUP (2 agents, 4096
    envs, on the pool) unwrapped and under OneHot."""
    import statistics

    from multigrid_tpu_torch import VectorEnv, make, wrappers

    out = {}
    for env_id, n, names in [('MultiGrid-Empty-16x16-v0', N, WRAPPERS),
                             (BUP, BUP_N, ('OneHotObsWrapper',))]:
        venvs, states, times = {}, {}, {}
        for name in (None,) + names:
            env = make(env_id, agents=n, device=device)
            venv = VectorEnv(env if name is None else getattr(wrappers, name)(env), E)
            _, state = venv.reset(seed=0)
            state, _ = _step_ms(venv, state, 2)  # warm-up
            key = name or 'unwrapped'
            venvs[key], states[key], times[key] = venv, state, []
        for r in range(rounds):
            for key in (list(venvs) if r % 2 == 0 else list(venvs)[::-1]):
                states[key], ms = _step_ms(venvs[key], states[key], steps)
                times[key].append(ms)
        med = {k: statistics.median(v) for k, v in times.items()}
        out[env_id] = {k: dict(ms=med[k], runs=times[k], over_unwrapped=med[k] / med['unwrapped'])
                       for k in med}
        print(f'{env_id} ({n} agents, {E} envs), ms a VectorEnv.step (median of {rounds}, '
              f'{steps} steps each, in turns): ' + ', '.join(
                  f'{k} {med[k]:.4f} ({med[k] / med["unwrapped"]:.4f}x)' for k in med))
    return out


def render_path(venv, state, frames=16):
    """``render_state`` at the flagship (16x16, 4 agents, tile 32, highlight
    on) on the main run's final state: the view-cone highlight of env i
    against the cells the obs kernel shows its live agents (``visible_world_mask``
    takes the plain visibility on the host), frames of the right shape,
    no kernel launched while rendering, and ms a frame with the tile cache
    warm (median over ``frames`` envs)."""
    import statistics

    import numpy as np
    import torch

    from multigrid_tpu_torch import render
    from multigrid_tpu_torch.core.constants import TYPE_UNSEEN
    from multigrid_tpu_torch.ops.obs import get_view_exts

    image = venv.observe(state)['image'][:frames].cpu().numpy()
    tx, ty = (t[:frames].cpu().numpy() for t in get_view_exts(state.agent_dir, state.agent_pos, VS))
    dirs = state.agent_dir[:frames].cpu().numpy()
    dead = state.agent_terminated[:frames].cpu().numpy()
    for i in range(frames):
        want = np.zeros((SIZE, SIZE), bool)
        for a in range(N):
            if dead[i, a]:
                continue
            ii, jj = np.nonzero(np.rot90(image[i, a, ..., 0] != TYPE_UNSEEN, k=(dirs[i, a] + 1) % 4))
            x, y = tx[i, a] + ii, ty[i, a] + jj
            inside = (x >= 0) & (x < SIZE) & (y >= 0) & (y < SIZE)
            want[x[inside], y[inside]] = True
        if not np.array_equal(render.visible_world_mask(venv.env, state, index=i), want):
            fail(f'render: the highlight of env {i} is not the cells its agents observe')
    _zero_counts()
    for i in range(frames):  # warm the tile cache
        render.render_state(venv.env, state, index=i)
    ms = []
    for i in range(frames):
        t0 = time.perf_counter()
        frame = render.render_state(venv.env, state, index=i)
        ms.append((time.perf_counter() - t0) * 1e3)
        if frame.shape != (SIZE * 32, SIZE * 32, 3) or frame.dtype != np.uint8:
            fail(f'render: frame {frame.shape} {frame.dtype}')
    torch.cuda.synchronize()
    if any(_counts().values()):
        fail(f'render launched kernels: {_counts()}')
    med = statistics.median(ms)
    print(f'render_state 16x16, tile 32, highlight on: {med:.4f} ms a frame (median of '
          f'{frames}, cache warm, {len(render._TILE_CACHE)} tiles cached); highlights equal '
          'the cells the obs kernel shows')
    return med


def _doorkey_env(device):
    """Farama minigrid's DoorKeyEnv, imports swapped: the imperative
    authoring path (``utils/minigrid_builder.py``)."""
    from multigrid_tpu_torch.utils.minigrid_builder import (
        Door, Goal, Grid, Key, MiniGridCompatEnv)

    class DoorKeyEnv(MiniGridCompatEnv):
        mission = 'use the key to open the door and then get to the goal'

        def _gen_grid(self, width, height):
            self.grid = Grid(width, height)
            self.grid.wall_rect(0, 0, width, height)
            self.put_obj(Goal(), width - 2, height - 2)
            split = self._rand_int(2, width - 2)
            self.grid.vert_wall(split, 0)
            self.place_agent(size=(split, height))
            self.put_obj(Door('yellow', is_locked=True), split, self._rand_int(1, width - 2))
            self.place_obj(obj=Key('yellow'), top=(0, 0), size=(split, height))

    return DoorKeyEnv(grid_size=6, max_steps=360, device=device)


def adapters_path(device=None, steps=256, checked=32):
    """The adapters on the card: a ``GymAdapter`` over BUP (2 agents) for
    ``checked`` steps with partial action dicts, every observation equal to
    the plain version and one obs launch a reset and a step; then a
    ``steps``-step episode loop (resetting where an episode ends) timed,
    its launches counted, and 64 of its steps under torch.profiler for the
    device's busy share; PettingZoo's live agents, RLlib's ``__all__``, the
    MiniGrid facade's DoorKey solve (``MiniGridCompatEnv``), each with exact
    launches. Phases that need gymnasium, pettingzoo or pygame run where
    they are installed, and the absent ones are named. Returns the launches,
    steps/s, launches a step and busy share."""
    import importlib.util

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multigrid_tpu_torch import make
    from multigrid_tpu_torch.adapters import GymAdapter, PettingZooWrapper, RLlibWrapper
    from multigrid_tpu_torch.core.constants import STATE_OPEN, TYPE_DOOR, TYPE_EMPTY, TYPE_KEY
    from multigrid_tpu_torch.utils.minigrid_interface import MiniGridInterface

    absent = [m for m in ('gymnasium', 'pettingzoo', 'pygame')
              if importlib.util.find_spec(m) is None]
    rng = np.random.default_rng(9)
    ad = GymAdapter(make(BUP, agents=BUP_N, device=device))

    def expect(label, want_obs):
        counts = _counts()
        want = {**{k: 0 for k in counts}, 'obs': want_obs}
        if counts != want:
            fail(f'adapters {label}: expected launches {want}, got {counts}')

    with obs_checked() as mismatches:
        _zero_counts()
        obs, _ = ad.reset(seed=0)
        calls = 1
        for t in range(checked):
            actions = {i: int(rng.integers(7)) for i in range(BUP_N) if rng.random() < 0.8}
            obs, rew, term, trunc, _ = ad.step(actions)
            calls += 1
            if all(term.values()) or any(trunc.values()):
                obs, _ = ad.reset()
                calls += 1
        torch.cuda.synchronize()
    expect('gym checked', calls)
    if mismatches or (device is None and ad._state.device.type != 'cuda'):
        fail(f'adapters: {len(mismatches)} observations differ from the plain version '
             f'(state on {ad._state.device})')
    if obs[0]['image'].shape != (VS, VS, 3) or obs[0]['mission'] != ad.env.mission_of(ad._state):
        fail(f'adapters: obs {obs[0]["image"].shape}, mission {obs[0]["mission"]!r}')

    acts = rng.integers(0, 7, (steps, BUP_N))
    ad.reset(seed=1)
    _zero_counts()
    resets = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        _, _, term, trunc, _ = ad.step({0: int(acts[t, 0]), 1: int(acts[t, 1])})
        if all(term.values()) or any(trunc.values()):
            ad.reset()
            resets += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect('gym loop', steps + resets)
    rate = steps / wall
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(64):
            ad.step({0: int(acts[t % steps, 0]), 1: int(acts[t % steps, 1])})
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = (sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / pwall) if kernels else None
    print(f'GymAdapter over {BUP} ({BUP_N} agents): {steps}-step loop {rate:.2f} steps/s '
          f'({wall * 1e3 / steps:.4f} ms a step, {resets} resets), obs launches one a '
          f'call ({steps + resets} in all); profiled 64 steps: wall {pwall:.4f} ms, device busy '
          + (f'{busy:.4f} of it, {len(kernels) / 64:.1f} device kernels a step' if busy is not None
             else 'not measured (the profiler saw no device time)'))

    pz = PettingZooWrapper(make('MultiGrid-Empty-5x5-v0', agents=2, device=device))
    _zero_counts()
    pz.reset(seed=0)
    for t, a in enumerate([2, 2, 1, 2, 2]):
        _, rewards, terms, _, _ = pz.step({'agent_0': a, 'agent_1': 6})
    expect('pettingzoo', 6)
    if pz.agents != [] or not terms['agent_0'] or rewards['agent_0'] <= 0:
        fail(f'pettingzoo: live agents {pz.agents} after the goal, rewards {rewards}')
    rl = RLlibWrapper(make('MultiGrid-Empty-5x5-v0', agents=2, device=device))
    rl.reset(seed=0)
    _, _, terms, truncs, _ = rl.step({0: 2, 1: 1})
    if terms.get('__all__') is not False or '__all__' not in truncs:
        fail(f'rllib: {terms} {truncs}')

    mg = MiniGridInterface(_doorkey_env(device))
    with obs_checked() as mismatches:
        _zero_counts()
        mg.reset(seed=3)
        grid = mg._state.grid[0].cpu().numpy()
        (kx, ky), (dx, dy) = (tuple(int(v[0]) for v in np.nonzero(grid[..., 0] == t))
                              for t in (TYPE_KEY, TYPE_DOOR))
        # An empty cell beside the key, facing it.
        mg.agent_pos, mg.agent_dir = next(
            (p, d) for p, d in [((kx - 1, ky), 0), ((kx, ky - 1), 1), ((kx + 1, ky), 2),
                                ((kx, ky + 1), 3)] if grid[p[0], p[1], 0] == TYPE_EMPTY)
        mg.step(3)  # pickup
        mg.agent_pos, mg.agent_dir = (dx - 1, dy), 0
        mg.step(5)  # toggle: the key opens the door
        mg.step(2)
        mg.agent_pos, mg.agent_dir = (4, 3), 1
        _, reward, term, _, _ = mg.step(2)
        torch.cuda.synchronize()
    expect('minigrid', 5)
    if mismatches or not term or reward <= 0 or int(mg._state.grid[0, dx, dy, 2]) != STATE_OPEN:
        fail(f'minigrid DoorKey: term {term}, reward {reward}, {len(mismatches)} mismatches')
    print('PettingZoo (live agents drop at the goal), RLlib (__all__) and the MiniGrid facade '
          '(DoorKey solved by the imperative MiniGridCompatEnv) on the card: launches exact, '
          'observations equal to the plain version')

    if 'gymnasium' not in absent:
        import gymnasium

        from multigrid_tpu_torch.adapters import register_gymnasium_envs
        if not ad.observation_space[0].contains(ad.step({0: 2})[0][0]):
            fail('adapters: an observation outside the declared space')
        register_gymnasium_envs()
        genv = gymnasium.make('MultiGrid-Empty-5x5-v0', agents=2, device=device,
                              disable_env_checker=True)
        genv.reset(seed=0)
    if 'pettingzoo' not in absent:
        from pettingzoo.test import parallel_api_test
        parallel_api_test(PettingZooWrapper(make('MultiGrid-Empty-5x5-v0', agents=2,
                                                 device=device)), num_cycles=30)
    not_run = {'gymnasium': 'the spaces and register_gymnasium_envs',
               'pettingzoo': "pettingzoo's parallel_api_test",
               'pygame': "render_mode='human'"}
    print('adapters: ' + ('; '.join(f'{m} absent, so {not_run[m]} did not run' for m in absent)
                          if absent else 'gymnasium, pettingzoo and pygame present: all ran'))
    return dict(launches=calls + steps + resets + 6 + 5, steps_per_s=rate,
                ms_a_step=wall * 1e3 / steps, obs_launches_a_call=1, device_busy=busy,
                absent=absent)


def visualize_path(ckdir, device=None):
    """``python -m multigrid_tpu_torch.visualize``, in this process so that
    its launches count: on the cnn checkpoint the cli phase wrote into
    ``ckdir`` (BUP, 2 agents, 2 episodes of at most 64 steps, a GIF), and
    with ``--encoder mlp`` on an mlp checkpoint written here (B2 on packed
    cells), the launch counts set to 0 just before and read just after
    each (obs: one at ``ppo_init``, one a frame; B2: one a step with the
    mlp), every observation and every B2 output held against its plain
    version, frames of BUP's size. Returns the launches."""
    import numpy as np
    import torch

    from multigrid_tpu_torch import VectorEnv, make, visualize
    from multigrid_tpu_torch.learn import nets, ppo_init
    from multigrid_tpu_torch.ops import fused_linear as fl
    from multigrid_tpu_torch.utils.checkpoint import save_checkpoint

    kernel, b2_err = nets.onehot_linear, [0.0]

    def b2_checked(packed, w):
        got = kernel(packed, w)
        want = fl.onehot_linear_plain(packed, w)
        b2_err[0] = max(b2_err[0], float(((got.float() - want.float()).abs()
                                          / (want.float().abs() + 1)).max()))
        return got

    mlp_dir = os.path.join(ckdir, 'mlp')
    venv = VectorEnv(make(BUP, agents=BUP_N, device=device), 64, packed_obs=True)
    state, *_ = ppo_init(venv, 0, net_kwargs=dict(encoder='mlp'))
    save_checkpoint(os.path.join(mlp_dir, 'step_0'), state, venv)
    out = {}
    for label, args in [('cnn', ['--load-dir', ckdir, '--gif', os.path.join(ckdir, 'bup.gif')]),
                        ('mlp', ['--load-dir', mlp_dir, '--encoder', 'mlp'])]:
        nets.onehot_linear = b2_checked
        try:
            with obs_checked() as mismatches:
                _zero_counts()
                frames = visualize.main(
                    ['--env', BUP, '--num-agents', str(BUP_N), '--num-episodes', '2',
                     '--max-steps', '64'] + args + ([] if device is None else ['--device', device]))
                torch.cuda.synchronize()
        finally:
            nets.onehot_linear = kernel
        counts = _counts()
        policy_steps = len(frames) - 2
        want = {**{k: 0 for k in counts}, 'obs': 1 + len(frames),
                'onehot_linear': policy_steps if label == 'mlp' else 0}
        if counts != want:
            fail(f'visualize {label}: expected launches {want}, got {counts}')
        if mismatches or not b2_err[0] < 2e-2:
            fail(f'visualize {label}: {len(mismatches)} observations differ, B2 error '
                 f'{b2_err[0]:.3e}')
        if any(f.shape != (6 * 32, 11 * 32, 3) or f.dtype != np.uint8 for f in frames):
            fail(f'visualize {label}: frames {frames[0].shape} {frames[0].dtype}')
        out[label] = counts
        print(f'visualize {label}: {len(frames)} frames, launches {counts}, observations equal '
              f'to the plain version' + (f', B2 err {b2_err[0]:.3e} (< 2e-2)' if label == 'mlp'
                                         else f', GIF {os.path.getsize(args[-1])} bytes'))
    return dict(launches=out['cnn']['obs'] + out['mlp']['obs'],
                launches_b2=out['mlp']['onehot_linear'], b2_err=b2_err[0])


# ------------------------------------------------------ multi-process runs

#: A spawned run's join timeout (s): a process that fails or hangs fails it.
SPAWN_TIMEOUT = 600.0


def _flagship_run(updates, device=None, **kw):
    """:func:`ppo_run` keywords of the trained flagship (Empty-16x16, 4
    agents, 4096 global envs, mlp 128 on packed cells, T 16)."""
    return dict(num_envs=E, updates=updates, env_id='MultiGrid-Empty-16x16-v0', agents=N,
                hidden=HIDDEN, device=device, **{'config': dict(rollout_steps=TRAIN_T), **kw})


def _want_launches(kw):
    """The kernels a process launches in the updates of the run ``kw``
    (:func:`ppo_run`'s keywords), as the single path does: B1 T, B2 T + 1
    (1 with the fused policy, whose B5 takes the T rollout steps), B4 once
    an SGD step, each an update; the cnn B1 alone."""
    cfg, updates, fused = kw.get('config', {}), kw['updates'], kw.get('fused_policy', False)
    t = cfg.get('rollout_steps', TRAIN_T)
    if kw.get('encoder', 'mlp') == 'cnn':
        return {'obs': t * updates, 'obs_general': 0, 'onehot_linear': 0,
                'onehot_linear_grad': 0, 'ppo_loss': 0, 'policy_sample': 0}
    return {'obs': t * updates, 'obs_general': 0,
            'onehot_linear': (1 if fused else t + 1) * updates, 'onehot_linear_grad': 0,
            'ppo_loss': cfg.get('epochs', 1) * cfg.get('minibatches', 1) * updates,
            'policy_sample': t * updates if fused else 0}


def _checked(label, results, runs, single=None, exact=False, counted=True):
    """Each process's results of ``runs`` with exact launch counts; held to
    ``single`` (one process's runs) where given by
    :func:`~multigrid_tpu_torch.parallel.dryrun.assert_consistent`: every
    rollout's checksums equal (a run with ``flips`` reports the first
    differing update and step instead), the metrics of every update with an
    equal rollout at rtol 1e-4 (equal with ``exact``), the parameters equal
    across processes after every update. Prints each process's launches and
    every compared update's metrics; returns ``{name: consistency}``."""
    from multigrid_tpu_torch.parallel.dryrun import assert_consistent

    out = {}
    for i, kw in enumerate(runs):
        name = kw.get('name', f'run {i}')
        per_proc = [res[i] for res in results]
        want = _want_launches(kw)
        for rank, res in enumerate(per_proc):
            if counted and res['launches'] != want:
                fail(f'{label}, {name}, process {rank}: launches {res["launches"]}, '
                     f'expected {want}')
        print(f'{label}, {name}: launches a process {per_proc[0]["launches"]} in '
              f'{kw["updates"]} updates')
        _check_finite(per_proc[0]['metrics'], f'{label}, {name}')
        if single is None:
            continue
        ref = single[i]
        for u, (a, b) in enumerate(zip(per_proc[0]['metrics'], ref['metrics'])):
            same = per_proc[0]['rollouts'][u] == ref['rollouts'][u]
            print(f'  update {u + 1} (rollout {"bit-equal" if same else "differs"}): '
                  + ', '.join(f'{k} {a[k]:.9g}/{b[k]:.9g}'
                              for k in ('loss', 'pg_loss', 'vf_loss', 'entropy',
                                        'reward_per_step')))
        try:
            out[name] = assert_consistent(per_proc, ref, f'{label}, {name}',
                                          flips=kw.get('flips', False),
                                          **(dict(rtol=0.0, atol=0.0) if exact else {}))
        except AssertionError as exc:
            fail(str(exc))
        if out[name]['first_flip']:
            u, t = out[name]['first_flip']
            print(f'  {name}: the rollout of update {u} first differs at step {t} (a '
                  f'parameter rounded otherwise after the reordered gradient sums); '
                  f'updates 1-{u - 1} compared at rtol 1e-4')
    return out


def _bup_reset_extra_ms(device=None, card='', reps=4):
    """The extra ms a BUP env step pays on each of 2 processes to refresh
    the global reserve (4096 envs) instead of its own half (2048): one
    ``refresh_pool(16)`` of each, in turns (global, half, half, global),
    over 16 steps. Returns ``{'global_ms', 'half_ms', 'extra_ms'}`` a step
    (medians)."""
    import statistics

    import torch

    from multigrid_tpu_torch import VectorEnv, make

    venvs = {e: VectorEnv(make(BUP, agents=BUP_N, device=device), e) for e in (E, E // 2)}
    states = {e: v.reset(seed=1)[1] for e, v in venvs.items()}
    chunk = VectorEnv.REFRESH_CHUNK
    times = {E: [], E // 2: []}
    for e in [E, E // 2, E // 2, E] * reps:
        venvs[e].refresh_pool(states[e], chunk)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        venvs[e].refresh_pool(states[e], chunk)
        torch.cuda.synchronize()
        times[e].append((time.perf_counter() - t0) * 1e3 / chunk)
    g, h = statistics.median(times[E]), statistics.median(times[E // 2])
    print(f'BUP reserve refresh a step on {card}: global {E} envs {g:.6f} ms, half {E // 2} '
          f'{h:.6f} ms; extra a process pays for the global draws {g - h:.6f} ms '
          '(medians, in turns)')
    return {'global_ms': g, 'half_ms': h, 'extra_ms': g - h}


def distributed_path(tmp, device=None):
    """Data-parallel PPO over processes (``parallel.mesh``, ``parallel.
    distributed``), each process on this card, spawned with a file-store
    rendezvous and a join timeout:

    - NCCL, one process: the flagship sharded over a world of one against
      the plain path in the same process from the same seed (equal metrics:
      an all-reduce over one process is the identity), then both in turns
      for their trained agent-steps/s;
    - gloo, two processes sharing the card (NCCL refuses two on one card),
      each 2048 of the 4096 envs: the flagship (3 updates), one update of
      2 epochs x 4 minibatches (the env-axis roll crosses the processes),
      the BUP recipe on the replicated pool (2 updates) and the fused-policy
      variant (3 updates), each against one process (this one): every
      rollout bit-equal and the metrics at rtol 1e-4. The BUP recipe's
      bfloat16 logits pick another action near a tie once the parameters
      differ in their last bits (the gradients summed in another order), so
      its first differing update and step is reported and the metrics are
      held to rtol 1e-4 up to it. Two processes on one card are not a
      scaling measure;
    - ``torchrun --standalone --nproc-per-node 1 -m multigrid_tpu_torch.train
      --mesh``: 2 flagship updates, one checkpoint, which ``python -m
      multigrid_tpu_torch.evaluate`` reads.

    Every process's launches are exact (B1 16, B2 17, B4 1 an update; B5
    16 on the fused variant). Returns the launches and times. With
    ``device='cpu'`` (a rehearsal without a card) the world of one is gloo's
    and no launch is counted."""
    from multigrid_tpu_torch.parallel.dryrun import ppo_run, ppo_runs, spawn

    out = {}
    # NCCL, a world of one: sharded and plain in turns, the first pair equal.
    counted = device is None
    nccl = [dict(_flagship_run(3, device), name='sharded'),
            dict(_flagship_run(3, device), name='plain', sharded=False)]
    nccl += [nccl[1], nccl[0]]
    t0 = time.perf_counter()
    res = spawn(ppo_runs, 1, ([{k: v for k, v in kw.items() if k != 'name'} for kw in nccl],),
                backend='nccl' if counted else 'gloo', device=device, timeout=SPAWN_TIMEOUT)
    print(f'nccl, 1 process: {time.perf_counter() - t0:.1f} s with start-up')
    _checked('nccl, 1 process', res, nccl[:1], single=[res[0][1]], exact=True, counted=counted)
    rates = {'sharded': [], 'plain': []}
    for kw, r in zip(nccl, res[0]):
        rates[kw['name']].append(r['agent_steps'] / r['seconds'])
    card = smi_line() if counted else 'the CPU'
    print(f'nccl, 1 process, on {card}: trained agent-steps/s of 3 updates in turns '
          '(sharded, plain, plain, sharded): ' + '; '.join(f'{k} ' + ', '.join(f'{x:.6e}' for x in v)
                                          for k, v in rates.items()))
    out['nccl_1'] = {'launches': res[0][0]['launches'], 'trained_agent_steps_per_s': rates}

    # gloo, two processes on the one card, against this process.
    bup_cfg = dict(rollout_steps=BUP_T, epochs=BUP_EPOCHS, minibatches=BUP_MB)
    gloo = [dict(_flagship_run(3, device), name='flagship'),
            dict(_flagship_run(1, device, config=dict(rollout_steps=TRAIN_T, epochs=2,
                                                      minibatches=4)),
                 name='2 epochs x 4 minibatches'),
            dict(num_envs=E, updates=2, env_id=BUP, agents=BUP_N, hidden=HIDDEN,
                 config=bup_cfg, device=device, flips=True,
                 name='BUP recipe, replicated pool'),
            dict(_flagship_run(3, device), fused_policy=True, name='fused policy')]
    names = ('name', 'flips')
    runs = [{k: v for k, v in kw.items() if k not in names} for kw in gloo]
    t0 = time.perf_counter()
    res = spawn(ppo_runs, 2, (runs,), backend='gloo', device=device, timeout=SPAWN_TIMEOUT)
    wall = time.perf_counter() - t0
    single = [ppo_run(**kw, sharded=False) for kw in runs]
    consistency = _checked('gloo, 2 processes', res, gloo, single=single, counted=counted)
    flag = [r[0] for r in res]
    rate = flag[0]['agent_steps'] / max(r['seconds'] for r in flag)
    print(f'gloo, 2 processes on one card, {card} ({wall:.1f} s with start-up): flagship '
          f'{rate:.6e} trained agent-steps/s over both (one process here: '
          f'{single[0]["agent_steps"] / single[0]["seconds"]:.6e}); two processes share '
          'one card, so this is no scaling measure')
    out['gloo_2'] = {'launches': [r[0]['launches'] for r in res],
                     'launches_fused': [r[3]['launches'] for r in res],
                     'trained_agent_steps_per_s_one_card': rate,
                     'one_process_trained_agent_steps_per_s':
                         single[0]['agent_steps'] / single[0]['seconds'],
                     'consistency': consistency}
    out['bup_reset_extra'] = _bup_reset_extra_ms(device, card)

    # The CLI under torchrun, then evaluate on its checkpoint.
    ck = os.path.join(tmp, 'mesh-ck')
    t = [sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc-per-node',
         '1', '-m', 'multigrid_tpu_torch.train', '--mesh', '--env',
         'MultiGrid-Empty-16x16-v0', '--num-agents', str(N), '--num-envs', str(E),
         '--rollout-steps', str(TRAIN_T), '--encoder', 'mlp', '--hidden', str(HIDDEN),
         '--num-timesteps', str(2 * E * N * TRAIN_T), '--save-dir', ck, '--save-interval',
         '2', '--log-interval', '1'] + ([] if device is None else ['--device', device])
    t0 = time.perf_counter()
    run = subprocess.run(t, cwd=HERE, capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        fail(f'torchrun train --mesh: exit {run.returncode}: {run.stderr[-3000:]}')
    rows = [json.loads(x) for x in run.stdout.splitlines() if x.startswith('{')]
    if [r['update'] for r in rows] != [1, 2] or os.listdir(ck) != ['step_2']:
        fail(f'torchrun train --mesh: rows {rows}, checkpoints {os.listdir(ck)}')
    print(f'torchrun train --mesh on {card} ({time.perf_counter() - t0:.1f} s): '
          f'{json.dumps(rows[-1])}')
    ev = subprocess.run([sys.executable, '-m', 'multigrid_tpu_torch.evaluate', '--env',
                         'MultiGrid-Empty-16x16-v0', '--num-agents', str(N), '--num-envs',
                         str(E), '--num-steps', str(64 * E * N), '--encoder', 'mlp',
                         '--hidden', str(HIDDEN), '--load-dir', ck]
                        + ([] if device is None else ['--device', device]), cwd=HERE,
                        capture_output=True, text=True, timeout=600)
    evals = [json.loads(x) for x in ev.stdout.splitlines() if x.startswith('{')]
    if ev.returncode != 0 or not evals or 'loaded' not in ev.stdout:
        fail(f'evaluate on the --mesh checkpoint: exit {ev.returncode}: '
             f'{ev.stdout[-1000:]} {ev.stderr[-2000:]}')
    print(f'evaluate on the --mesh checkpoint: {json.dumps(evals[-1])}')
    # NaN (no episode ended) as null, so that the record is strict JSON.
    out['torchrun_train'] = {k: None if v != v else v for k, v in rows[-1].items()}
    out['evaluate'] = evals[-1]
    return out


#: The JAX gate's configuration (__graft_entry__.py:64-74, 104-127): the
#: default ActorCritic (the cnn on images), 128 envs a process, T 2, 3
#: updates.
GATE_ENVS, GATE_T = 128, 2


def _gate_run(procs, device=None, **kw):
    """:func:`ppo_run` keywords of the JAX gate on ``procs`` processes."""
    return dict(num_envs=GATE_ENVS * procs, updates=3, env_id='MultiGrid-Empty-16x16-v0',
                agents=N, encoder='cnn', config=dict(rollout_steps=GATE_T), device=device, **kw)


def ck_third_update(path, model_shards, save, device=None):
    """The gate's configuration on a mesh of ``model_shards`` on
    ``'model'`` (1: one process, no mesh): 2 updates, a checkpoint at
    ``path`` and the third update (``save``), or the third update from the
    checkpoint at ``path`` restored into fresh objects. Returns its metrics
    and the full parameters' digest."""
    import torch

    from multigrid_tpu_torch import VectorEnv, make
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.learn.ppo import params_digest
    from multigrid_tpu_torch.parallel import gather_params, make_mesh
    from multigrid_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh(n_model_shards=model_shards) if model_shards > 1 else None
        venv = VectorEnv(make('MultiGrid-Empty-16x16-v0', agents=N, device=device),
                         GATE_ENVS * 2, mesh=mesh)
        state, net, cfg, tx = ppo_init(venv, 0, config=PPOConfig(rollout_steps=GATE_T))
        step = make_train_step(venv, net, cfg, tx)
        if save:
            for _ in range(2):
                state, _ = step(state)
            save_checkpoint(path, state, venv)
        else:
            state = restore_checkpoint(path, state, venv)
        state, metrics = step(state)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {'metrics': {k: float(v) for k, v in metrics.items()},
            'digest': params_digest(gather_params(state.params, venv.mesh))}


def model_axis_work(runs, ck_saved, ck_from_one, device=None):
    """A (1, 2) mesh's share: :func:`ppo_run` of each keyword dict of
    ``runs``; then a checkpoint of the gate written on the mesh at
    ``ck_saved`` and its third update; then the third update from the
    one-process checkpoint at ``ck_from_one``."""
    from multigrid_tpu_torch.parallel.dryrun import ppo_runs
    return {'runs': ppo_runs(runs),
            'saved': ck_third_update(ck_saved, 2, True, device),
            'resumed': ck_third_update(ck_from_one, 2, False, device)}


def model_axis_path(tmp, device=None):
    """The ``'model'`` mesh axis (``parallel.mesh.shard_params``): every
    process keeps its columns of the ``Dense_0`` kernels and of their Adam
    moments, the update gathers them; spawned gloo processes sharing this
    card (NCCL refuses two on one card), a file-store rendezvous and a join
    timeout each:

    - 2 processes at ``(1, 2)``: the JAX gate's configuration (the cnn on
      images, 256 envs, T 2, 3 updates), the mlp flagship (E 4096, T 16, 3
      updates) and the fused-policy variant, each bit-equal to one process
      (this one: the parameters after every update, every rollout, every
      metric), with each process's launches what the single path launches
      (B1 16, B2 17, B4 1 an update on the mlp, B5 16 fused; B1 2 on the
      cnn); and the checkpoint round trip: the gate written on ``(1, 2)``
      and resumed in one process, and written in one process and resumed on
      ``(1, 2)``, each third update bit-equal;
    - 4 processes at ``(2, 2)``: ``dryrun_multichip(4)``, the gate's
      configuration at 512 envs held to one process at rtol 1e-4.

    Two or four processes on one card are not a scaling measure. With
    ``device='cpu'`` (a rehearsal without a card) no launch is counted."""
    from multigrid_tpu_torch.parallel.dryrun import dryrun_multichip, ppo_run, spawn

    counted = device is None
    card = smi_line() if counted else 'the CPU'
    runs = [dict(_gate_run(2, device), name='JAX gate (cnn, 256 envs, T 2)'),
            dict(_flagship_run(3, device), name='mlp flagship'),
            dict(_flagship_run(3, device), fused_policy=True, name='fused policy')]
    plain = [{k: v for k, v in kw.items() if k != 'name'} for kw in runs]
    ck_saved, ck_one = os.path.join(tmp, 'model-axis-ck'), os.path.join(tmp, 'one-ck')
    one = ck_third_update(ck_one, 1, True, device)
    t0 = time.perf_counter()
    res = spawn(model_axis_work, 2, ([dict(kw, model_shards=2) for kw in plain], ck_saved,
                                     ck_one),
                dict(device=device), backend='gloo', device=device, timeout=SPAWN_TIMEOUT)
    wall = time.perf_counter() - t0
    for rank, r in enumerate(res):
        if [x['mesh_shape'] for x in r['runs']] != [[1, 2]] * len(runs):
            fail(f'model axis, process {rank}: meshes {[x["mesh_shape"] for x in r["runs"]]}')
    single = [ppo_run(**kw, sharded=False) for kw in plain]
    _checked('model axis (1, 2)', [r['runs'] for r in res], runs, single=single, exact=True,
             counted=counted)
    resumed_one = ck_third_update(ck_saved, 1, False, device)
    for label, got, want in [('(1, 2) checkpoint resumed in one process',
                              [resumed_one, res[1]['saved']], res[0]['saved']),
                             ('one-process checkpoint resumed on (1, 2)',
                              [r['resumed'] for r in res], one),
                             ('the gate on (1, 2) and in one process', [res[0]['saved']], one)]:
        if any(json.dumps(g) != json.dumps(want) for g in got):
            fail(f'model axis: {label}: {got} vs {want}')
    print(f'model axis (1, 2) checkpoints: both directions resume bit-equal (digest '
          f'{one["digest"]})')
    rates = [r['runs'][1]['agent_steps'] / r['runs'][1]['seconds'] for r in res]
    print(f'model axis (1, 2), 2 gloo processes on one card, {card} ({wall:.1f} s with '
          f'start-up): mlp flagship {", ".join(f"{x:.6e}" for x in rates)} trained '
          f'agent-steps/s a process, each on the whole batch (one process here: '
          f'{single[1]["agent_steps"] / single[1]["seconds"]:.6e}); no scaling measure')
    t0 = time.perf_counter()
    grid, _ = dryrun_multichip(4, backend='gloo', device=device, num_envs_per_proc=GATE_ENVS,
                               timeout=SPAWN_TIMEOUT)
    grid_wall = time.perf_counter() - t0
    want = _want_launches(_gate_run(4))
    for rank, r in enumerate(grid):
        if r['mesh_shape'] != [2, 2] or (counted and r['launches'] != want):
            fail(f'model axis (2, 2), process {rank}: mesh {r["mesh_shape"]}, launches '
                 f'{r["launches"]}, expected {want}')
    print(f'model axis (2, 2): dryrun_multichip(4) on {card} ({grid_wall:.1f} s with '
          f'start-up): launches a process {grid[0]["launches"]}')
    return {'launches': [r['runs'][1]['launches'] for r in res],
            'launches_fused': [r['runs'][2]['launches'] for r in res],
            'launches_gate': [r['runs'][0]['launches'] for r in res],
            'launches_grid': [r['launches'] for r in grid],
            'flagship_trained_agent_steps_per_s_a_process': rates,
            'one_process_trained_agent_steps_per_s':
                single[1]['agent_steps'] / single[1]['seconds'],
            'seconds_1x2': wall, 'seconds_2x2': grid_wall}


def profile_path(device=None, steps=64, updates_per_call=2):
    """``python -m multigrid_tpu_torch.profile_env`` and ``profile_train``
    at the flagship (Empty-16x16, 4 agents, 4096 envs), in this process:
    their JSON rows, checked for the JAX scripts' keys and positive
    times."""
    from multigrid_tpu_torch import profile_env, profile_train

    dev = [] if device is None else ['--device', device]
    card = smi_line() if device is None else 'the CPU'
    rows = profile_env.main(['--env-id', 'MultiGrid-Empty-16x16-v0', '--agents', str(N),
                             '--num-envs', str(E), '--steps', str(steps)] + dev)
    phases = [r['phase'] for r in rows]
    if phases != ['full_step', 'full_no_autoreset', 'obs_kernel', 'dynamics', 'reset_core'] \
            or not all(r.get('ms_per_step', 1) > 0 for r in rows):
        fail(f'profile_env: rows {rows}')
    rates = profile_train.main(['--num-envs', str(E), '--agents', str(N), '--rollout-steps',
                                str(TRAIN_T), '--updates-per-call', str(updates_per_call)]
                               + dev)
    if list(rates) != ['A_env_only', 'B_rollout_policy_nostore', 'C_rollout_stored',
                       'E_full_train'] or not all(v > 0 for v in rates.values()):
        fail(f'profile_train: {rates}')
    print(f'profile modules on {card}: env phases {json.dumps(rows)}; train stages '
          f'{json.dumps(rates)}')
    return {'env': rows, 'train': rates}


def kernel_times(device):
    """``--kernel-times``: B2 at the rollout's three shapes, B3 at the
    learner's three (flagship, per agent, critic), B1 at the flagship as
    images and packed (launches alone, profiler, call) and with 16 agents
    (launches alone, where the tree's kernel takes 16), B4 at 262,144 and
    65,536 samples with its stages, and B5 at the six shapes of its kernel
    cases, on seeded inputs: CUDA-event times of the package beside this
    script, for comparing two trees in turns within one call; and digests
    of B1's flagship images and of B4's gradients at 262,144, which two
    trees must share where the kernels compute the same bits. Prints one
    JSON line."""
    import hashlib

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

    def digest(tensors):
        return hashlib.sha256(b''.join(t.contiguous().cpu().numpy().tobytes()
                                       for t in tensors)).hexdigest()[:16]

    state = random_state(1, E, SIZE, SIZE, N, device)
    res['obs images digest'] = digest([obs_cuda.gen_obs_batched(state, VS, False)])
    for packed in (False, True):
        key = f'obs {"packed" if packed else "images"} ({E}, {N}, {VS})'
        res[key + ' launches'] = obs_launch_ms(state, VS, False, packed)
        res[key + ' kernel (profiler)'] = kernel_device_ms(
            lambda: obs_cuda.gen_obs_batched(state, VS, False, packed), 'obs_kernel')
        res[key + ' call'] = event_ms(lambda: obs_cuda.gen_obs_batched(state, VS, False, packed),
                                      200)
    team = random_state(5, E, SIZE, SIZE, 16, device)
    for packed in (False, True):
        key = f'obs {"packed" if packed else "images"} ({E}, 16, {VS})'
        res[key + ' launches'] = obs_launch_ms(team, VS, False, packed)
    bup = random_state(6, E, 11, 6, BUP_N, device)
    key = f'obs packed BUP shape ({E}, {BUP_N}, 11x6, {VS})'
    res[key + ' launches'] = obs_launch_ms(bup, VS, False, True)
    wide = random_state(7, 256, 32, 32, 2, device)
    res['obs_general packed (256, 2, 32x32, 33) launches'] = obs_launch_ms(wide, 33, False, True)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, num_actions=7)
    for b in (E * N * TRAIN_T, E * TRAIN_T):
        params, args = ppo_inputs(rng, b, C, HIDDEN, 0, device)
        if b == E * N * TRAIN_T:
            grads, metrics = fused_ppo.ppo_mlp_grads(params, *args, **kw)
            res[f'ppo_loss B={b} digest'] = digest(
                [grads[k] for k in sorted(grads)] + [metrics[k] for k in sorted(metrics)])
        res[f'ppo_loss B={b}'] = event_ms(lambda: fused_ppo.ppo_mlp_grads(params, *args, **kw), 10)
        res[f'ppo_loss B={b} stages'] = ppo_stages(
            lambda: fused_ppo.ppo_mlp_grads(params, *args, **kw))
    params, args = ppo_inputs(rng, E * N * TRAIN_T, C, HIDDEN, BUP_F - 2, device)
    res[f'ppo_loss B={E * N * TRAIN_T} F={BUP_F}'] = event_ms(
        lambda: fused_ppo.ppo_mlp_grads(params, *args, **kw), 10)
    for b, c, h, f, pad in POLICY_SHAPES:
        params, args = ppo_inputs(rng, b, c, h, f - 2, device)
        w = fp.prepare(params)
        packed = random_cells(rng, b, c, device, pad)
        gumbel = torch.as_tensor(rng.gumbel(size=(b, 7)).astype(np.float32), device=device)
        key = f'policy_sample ({b}, {c}, {h}, F {f})'
        res[key + ' launches'] = policy_launch_ms(w, packed, args[1], gumbel)
        res[key + ' call'] = event_ms(
            lambda: fp.policy_sample_prepared(w, packed, args[1], gumbel), 100)
        if b == E * N:
            res[key + ' kernel (profiler)'] = kernel_device_ms(
                lambda: fp.policy_sample_prepared(w, packed, args[1], gumbel),
                'policy_sample_kernel')
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
    obs_err = max(obs_cases(device), zoo_obs_cases(device))
    general = general_cases(device)
    errs = train_kernel_cases(device)
    policy_err = policy_kernel_cases(device)
    phase('main')
    venv, obs, state, summary, launches = main_path()
    phase('check')
    check_outputs(venv, obs, state, summary)
    phase('team')
    team = team_path()
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
    steps, counts_fused, counts_agents = variants()
    phase('variant timing')
    vt = variant_timing(steps)
    phase('wide view')
    wide_launches = wide_view_path()
    phase('zoo')
    zoo_res = zoo()
    phase('bup train')
    bvenv, bstep, bfused, bstate, bcounts, bcounts_fused = bup_train()
    phase('bup timing')
    bt = bup_timing(bvenv, bstep, bfused, bstate)
    phase('pool')
    pool = pool_path()
    phase('pool timing')
    pt = pool_timing()
    phase('cnn train')
    cnn = cnn_train()
    phase('resume')
    resumed = resume_path()
    phase('wrappers')
    wrapper_launches = wrappers_path()
    phase('wrapper timing')
    wt = wrapper_timing()
    phase('render')
    render_ms = render_path(venv, state)
    phase('adapters')
    adapters = adapters_path()
    with tempfile.TemporaryDirectory() as ckdir:
        phase('cli')
        cli_row = cli_path(ckdir)
        phase('visualize')
        vis = visualize_path(ckdir)
        phase('distributed')
        dist_res = distributed_path(ckdir)
        phase('model axis')
        model_axis = model_axis_path(ckdir)
    phase('profile')
    profiles = profile_path()
    print(f'total {time.perf_counter() - t_start:.1f} s')

    kernels = [dict(name='obs', route='cuda', source='multigrid_tpu_torch/csrc/obs.cu',
                    replaces='multigrid_tpu/ops/obs_pallas.py:176', launches=launches,
                    max_abs_err=obs_err, equal=obs_err == 0, ms=t['ms'],
                    plain_ms=t['plain_ms'], bound_ms=t['bound_ms'], bound_by=t['bound_by'],
                    library_ms=None, sass_tensor_ops=sass['obs'], call_ms=t['call_ms'],
                    profiler_ms=t['profiler_ms'], packed=t['packed'], team=team,
                    launches_zoo=zoo_res['launches'], launches_bup_train=bcounts['obs'],
                    launches_pool=pool['launches'],
                    launches_cnn_train={k: v['launches']['obs'] for k, v in cnn.items()},
                    launches_wrappers=wrapper_launches, launches_adapters=adapters['launches'],
                    launches_visualize=vis['launches'], bup=bt['kernels']['obs'])]
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
    for k, run in zip(kernels[1:4], ('loss kernel', 'gate off', 'loss kernel')):
        k['agents'].update(launches=counts_agents[run][k['name']],
                           launches_path=f'3 per-agent flagship updates, {run}')
    kernels[1]['launches_visualize_mlp'] = vis['launches_b2']
    for k in kernels[1:4]:
        k['launches_bup_train'] = bcounts[k['name']]
        if k['name'] in bt['kernels']:
            k['bup'] = bt['kernels'][k['name']]
    for k in kernels[:4]:
        if k['name'] != 'onehot_linear_grad':
            k['launches_distributed'] = {
                'path': '3 flagship updates a process',
                'nccl_1': dist_res['nccl_1']['launches'][k['name']],
                'gloo_2': [c[k['name']] for c in dist_res['gloo_2']['launches']]}
            k['launches_model_axis'] = {
                'path': '3 flagship updates a process, (1, 2) mesh',
                'gloo_2': [c[k['name']] for c in model_axis['launches']]}
    kernels[0]['launches_model_axis'].update(
        gate_1x2=[c['obs'] for c in model_axis['launches_gate']],
        gate_2x2=[c['obs'] for c in model_axis['launches_grid']])
    kernels.append(dict(name='policy_sample', route='cuda',
                        source='multigrid_tpu_torch/csrc/fused_policy.cu',
                        replaces='multigrid_tpu/ops/fused_policy.py:62',
                        launches=counts_fused['policy_sample'],
                        launches_path='train, MULTIGRID_FUSED_POLICY set',
                        max_abs_err=policy_err[0], max_rel_err=policy_err[1],
                        sass_tensor_ops=sass['policy_sample'], **vt['kernel'],
                        launches_bup_fused=bcounts_fused['policy_sample'],
                        launches_distributed={
                            'path': '3 fused-policy flagship updates a process',
                            'gloo_2': [c['policy_sample']
                                       for c in dist_res['gloo_2']['launches_fused']]},
                        launches_model_axis={
                            'path': '3 fused-policy flagship updates a process, (1, 2) mesh',
                            'gloo_2': [c['policy_sample']
                                       for c in model_axis['launches_fused']]},
                        bup=bt['kernels']['policy_sample']))
    gen_t = general['times']['250x250 N=2 vs=7 E=64 packed']
    kernels.append(dict(name='obs_general', route='cuda',
                        source='multigrid_tpu_torch/csrc/obs.cu',
                        replaces='multigrid_tpu/ops/obs_pallas.py:176',
                        serves='the shapes the JAX package serves through its XLA path '
                               '(multigrid_tpu/parallel/vector.py:113-147)',
                        launches=wide_launches,
                        launches_path='view-33 VectorEnv, reset + 8 steps',
                        max_abs_err=general['max_abs_err'], equal=general['max_abs_err'] == 0,
                        ms=gen_t['ms'], call_ms=gen_t['call_ms'], plain_ms=gen_t['plain_ms'],
                        bound_ms=gen_t['bound_ms'], bound_by=gen_t['bound_by'],
                        library_ms=None, shape='250x250 N=2 vs=7 E=64 packed',
                        times=general['times']))
    print(json.dumps({'kernels': kernels, 'trained_agent_steps_per_s': tt['rate'],
                      'variants_trained_agent_steps_per_s': vt['rates'],
                      'bup_trained_agent_steps_per_s': bt['rate'],
                      'bup_rollout_layers_ms': bt['layers'],
                      'zoo_reset_share': zoo_res['reset_share'],
                      'pool_layers_ms': pool['layers'], 'bup_pool_timing': pt,
                      'cnn_trained_agent_steps_per_s': {k: v['rate'] for k, v in cnn.items()},
                      'resume': resumed, 'cli_evaluate': cli_row, 'wrapped_step_ms': wt,
                      'gym_adapter': {k: v for k, v in adapters.items() if k != 'launches'},
                      'render_ms_a_frame': render_ms,
                      'distributed': {
                          **dist_res, 'nccl_1': dist_res['nccl_1']['trained_agent_steps_per_s'],
                          'gloo_2': {k: v for k, v in dist_res['gloo_2'].items()
                                     if not k.startswith('launches')}},
                      'model_axis': {k: v for k, v in model_axis.items()
                                     if not k.startswith('launches')},
                      'profile': profiles}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
