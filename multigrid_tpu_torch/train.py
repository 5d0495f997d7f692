"""Train PPO policies on a MultiGrid environment, on the card.

The counterpart of the JAX package's ``scripts/train.py``, with its
defaults: the cnn encoder, packed observations, the reserve pool on
procedural envs, a checkpoint every 20 updates. One policy shared by all
agents, or one per agent (``--per-agent-policies``), with each agent's own
value head or a centralized critic (``--critic centralized``):

    python -m multigrid_tpu_torch.train --env MultiGrid-Empty-16x16-v0 \\
        --num-agents 4 --num-envs 4096 --num-timesteps 10000000

Any registered environment trains; on one with missions
(``MultiGrid-BlockedUnlockPickup-v0``) the net conditions on the mission,
sized from the env's mission space. The JAX package's production recipe
there is ``--encoder mlp --num-agents 2 --num-envs 4096 --rollout-steps 128
--epochs 2 --minibatches 4``.

Checkpoints go to ``--save-dir`` (``step_<update>``, and ``best`` with
``--save-best``); ``--load-dir`` resumes from the latest one, exactly: the
parameters, the optimizer, the env batch with its pool, and the keys.
``--lr-anneal``
 decays the rate linearly to 0 over the run's
updates, read once per SGD step as optax reads it (so with E epochs of M
minibatches it reaches 0 after 1/(E·M) of the run, as in the JAX package);
``--ent-anneal`` lowers the entropy bonus in 4 stages.

``--mesh`` shards the env batch over the processes of a ``torchrun`` launch,
one card each (``LOCAL_RANK``'s), data-parallel (``--num-envs`` is the
global batch; NCCL between the processes); without a launcher it is a world
of one:

    python -m torch.distributed.run --nproc-per-node 4 \
        -m multigrid_tpu_torch.train --mesh --num-envs 16384 ...

Only the first process prints, logs and writes checkpoints, which hold the
global state (any number of processes resumes them).

The JAX CLI's compat flags ``--algo PPO``, ``--framework``, ``--num-workers``
and ``--num-gpus`` are accepted and ignored, as there.

Every ``--log-interval`` updates (and after the last) it prints one JSON row
of metrics, and appends it to ``--log-jsonl`` when given; the last line is
the phase timer's ``timing:``; with ``--stage-times`` a ``stages:`` line
follows it, the milliseconds an update took on the device by stage (the
stage counters of ``utils/profiling.py``: ``rollout`` with the env step's
stages, ``gae``, ``sgd``, ...), counted over every update after the first
(the first captures the counted graph). ``--device cpu`` runs on the CPU with the
kernels' plain versions. With ``MULTIGRID_FUSED_POLICY`` set (a shared mlp
policy, local critic), the rollout samples through the fused-policy kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import sys
import time

import torch

#: The entropy anneal's stages (scripts/train.py:183-190).
ENT_STAGES = 4


def ent_coef_at(ent_coef: float, update: int, num_updates: int) -> float:
    """The entropy bonus of ``update``'s stage under ``--ent-anneal``: the
    run's updates split into :data:`ENT_STAGES` stages, stage ``s`` at
    ``ent_coef · (1 - s / ENT_STAGES)`` (scripts/train.py:183-190)."""
    stage = min(update * ENT_STAGES // max(num_updates, 1), ENT_STAGES - 1)
    return ent_coef * (1.0 - stage / ENT_STAGES)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description='Train PPO policies on MultiGrid (PyTorch/CUDA).')
    # The JAX CLI's compat flags (scripts/train.py:35-47), accepted and ignored.
    p.add_argument('--algo', default='PPO', choices=['PPO'], help='RL algorithm (PPO only)')
    p.add_argument('--framework', default='torch', help='ignored')
    p.add_argument('--num-workers', type=int, default=None,
                   help='ignored: --num-envs sets the lockstep envs')
    p.add_argument('--num-gpus', type=int, default=0, help='ignored')
    p.add_argument('--env', default='MultiGrid-Empty-8x8-v0')
    p.add_argument('--env-config', type=json.loads, default={},
                   help='JSON dict of environment kwargs')
    p.add_argument('--num-agents', type=int, default=2)
    p.add_argument('--num-envs', type=int, default=1024,
                   help='lockstep parallel envs')
    p.add_argument('--num-timesteps', type=int, default=1_000_000,
                   help='agent-steps to train for')
    p.add_argument('--rollout-steps', type=int, default=16)
    p.add_argument('--epochs', type=int, default=1, help='PPO epochs per batch')
    p.add_argument('--minibatches', type=int, default=1,
                   help='SGD minibatches per epoch (1 = whole-batch updates)')
    p.add_argument('--lr', type=float, default=3e-4)
    p.add_argument('--gamma', type=float, default=0.99)
    p.add_argument('--ent-coef', type=float, default=0.01)
    p.add_argument('--hidden', type=int, default=128)
    p.add_argument('--encoder', default='cnn', choices=['cnn', 'mlp'],
                   help="'cnn' matches the reference example; 'mlp' is the one-hot "
                        'features through one wide layer, on the first-layer kernels')
    p.add_argument('--updates-per-call', type=int, default=1,
                   help='PPO updates per call of the train loop (metrics are their means)')
    p.add_argument('--per-agent-policies', action='store_true',
                   help="independent parameters per agent (the reference example's "
                        'policy_{i}); default is shared self-play')
    p.add_argument('--critic', default='local', choices=['local', 'centralized'],
                   help="'centralized' = MAPPO-style joint-observation value function "
                        '(actors stay partial)')
    p.add_argument('--lr-anneal', action='store_true',
                   help='linearly decay lr to 0 over the run (read per SGD step)')
    p.add_argument('--ent-anneal', action='store_true',
                   help=f'decay the entropy bonus to 0 over the run in {ENT_STAGES} stages')
    p.add_argument('--save-best', default=None, metavar='METRIC',
                   help="also keep the best checkpoint by this logged metric (e.g. "
                        "'success_rate') in <save-dir>/best")
    p.add_argument('--save-best-min-episodes', type=int, default=256,
                   help='ignore log windows with fewer finished episodes than this when '
                        'comparing success_rate or episode_reward for --save-best')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--save-dir', default='checkpoints',
                   help='checkpoint directory (saved every --save-interval updates)')
    p.add_argument('--save-interval', type=int, default=20)
    p.add_argument('--load-dir', default=None,
                   help='resume from the latest checkpoint in this directory')
    p.add_argument('--log-interval', type=int, default=10,
                   help='log metrics every N updates')
    p.add_argument('--log-jsonl', default=None,
                   help='append the logged metrics as JSON lines')
    p.add_argument('--mesh', action='store_true',
                   help='shard the env batch over the processes of a torchrun launch '
                        '(one card each; a world of one without a launcher)')
    p.add_argument('--no-packed-obs', action='store_true',
                   help='observations as (vs, vs, 3) channel triples instead of packed '
                        'int32 cells')
    p.add_argument('--device', default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument('--stage-times', action='store_true',
                   help='count device time by stage inside the update and print a '
                        "'stages:' line of ms an update by stage after the timing line")
    return p.parse_args(argv)


def train(args: argparse.Namespace) -> None:
    from multigrid_tpu_torch.parallel import distributed, make_mesh

    if not args.mesh:
        return _train(args, None)
    distributed.initialize(device=args.device)
    try:
        _train(args, make_mesh())
    finally:
        distributed.shutdown()


def _train(args: argparse.Namespace, mesh) -> None:
    from multigrid_tpu_torch.envs import make
    from multigrid_tpu_torch.learn import (
        PPOConfig,
        linear_schedule,
        make_train_loop,
        make_train_step,
        ppo_init,
    )
    from multigrid_tpu_torch.parallel import VectorEnv
    from multigrid_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )
    from multigrid_tpu_torch.utils import profiling

    env = make(args.env, agents=args.num_agents, device=args.device, **args.env_config)
    venv = VectorEnv(env, args.num_envs, packed_obs=not args.no_packed_obs, mesh=mesh)
    # Only the mesh's first process prints, logs and writes.
    lead = mesh is None or mesh.coords[0] == 0
    say = print if lead else (lambda *a, **k: None)
    config = PPOConfig(rollout_steps=args.rollout_steps, lr=args.lr,
                       gamma=args.gamma, ent_coef=args.ent_coef,
                       epochs=args.epochs, minibatches=args.minibatches,
                       per_agent_policies=args.per_agent_policies,
                       centralized_critic=args.critic == 'centralized')
    lr_schedule = None
    if args.lr_anneal:
        total_updates = max(1, args.num_timesteps // (
            args.num_envs * args.num_agents * args.rollout_steps))
        lr_schedule = linear_schedule(args.lr, 0.0, total_updates)
    state, net, config, tx = ppo_init(
        venv, args.seed, config=config,
        net_kwargs=dict(hidden=args.hidden, encoder=args.encoder), lr_schedule=lr_schedule)

    if args.load_dir:
        ckpt = latest_checkpoint(args.load_dir)
        if ckpt:
            try:
                state = restore_checkpoint(ckpt, state, venv)
            except (ValueError, RuntimeError, OSError, pickle.UnpicklingError) as exc:
                raise SystemExit(
                    f'failed to restore {ckpt}: {exc}\n'
                    'Hint: --per-agent-policies, --hidden, --encoder, --num-agents and '
                    '--num-envs must match the values the checkpoint was trained with.'
                ) from exc
            say(f'resumed from {ckpt} (update {state.update_count})', flush=True)

    upc = max(1, args.updates_per_call)

    def build_step(cfg):
        if upc > 1:
            return make_train_loop(venv, net, cfg, tx, upc)
        return make_train_step(venv, net, cfg, tx)

    steps_per_update = args.num_envs * args.num_agents * config.rollout_steps * upc
    num_updates = max(1, args.num_timesteps // steps_per_update)

    def stage_config(update):
        if not args.ent_anneal:
            return config
        return config.replace(ent_coef=ent_coef_at(args.ent_coef, update, num_updates))

    train_step = build_step(stage_config(0))
    current_ent = stage_config(0).ent_coef
    timer = profiling.PhaseTimer()
    kind = (torch.cuda.get_device_name(venv.device) if venv.device.type == 'cuda'
            else 'cpu')
    say(f'training {args.env}: {args.num_agents} agents x {args.num_envs} envs, '
          f'{num_updates} updates of {steps_per_update} agent-steps on {kind}',
          flush=True)

    log_f = open(args.log_jsonl, 'a') if args.log_jsonl and lead else None
    first, counted, stages = state.update_count // upc, 0, None
    counters = contextlib.ExitStack()
    if args.stage_times:
        counters.enter_context(profiling.stage_counters())
    try:
        t_start = time.perf_counter()
        t_last, steps_last = t_start, 0
        best_val = None
        for update in range(state.update_count // upc, num_updates):
            cfg = stage_config(update)
            if cfg.ent_coef != current_ent:
                current_ent = cfg.ent_coef
                train_step = build_step(cfg)
                say(f'ent-anneal stage: ent_coef -> {current_ent:g}', flush=True)
            last = update == num_updates - 1
            save = (update + 1) % args.save_interval == 0 or last
            log = (update + 1) % args.log_interval == 0 or last
            with timer.phase('update'):
                state, metrics = train_step(state)
                if save or log:
                    # The only waits for the card, as in the JAX CLI: between
                    # them the queue keeps it fed.
                    timer.sync(metrics)
            if args.stage_times:
                # Counted from the end of the first update, which captures.
                if update == first and num_updates - first > 1:
                    profiling.zero_stages()
                else:
                    counted += 1
            if save:
                path = save_checkpoint(os.path.join(args.save_dir, f'step_{update + 1}'),
                                       state, venv)
                say(f'checkpoint -> {path}', flush=True)
            if not log:
                continue
            values = {k: float(v) for k, v in metrics.items()}
            now = time.perf_counter()
            steps_done = (update + 1) * steps_per_update
            row = {
                'update': update + 1,
                'agent_steps': steps_done,
                'agent_steps_per_sec': round(steps_done / (now - t_start)),
                'steps_per_sec_window': round(
                    (steps_done - steps_last) / max(now - t_last, 1e-9)),
                'reward_per_step': values['reward_per_step'],
                'loss': values['loss'],
                'entropy': values['entropy'],
                'episode_reward': values['episode_reward'],
                'episodes_in_batch': values['episodes_in_batch'],
                'success_rate': values['success_rate'],
            }
            t_last, steps_last = now, steps_done
            say(json.dumps(row), flush=True)
            if log_f:
                log_f.write(json.dumps(row) + '\n')
                log_f.flush()
            if args.save_best:
                val = row.get(args.save_best)
                # Episode-rate metrics mean nothing on near-empty windows.
                if args.save_best in ('success_rate', 'episode_reward') and \
                        row['episodes_in_batch'] < args.save_best_min_episodes:
                    val = None
                # NaN-safe (success_rate is NaN where no episode ended).
                if val is not None and val == val and (best_val is None or val > best_val):
                    best_val = val
                    path = save_checkpoint(os.path.join(args.save_dir, 'best'), state, venv)
                    say(f'best {args.save_best}={val:.4f} -> {path}', flush=True)
        if args.stage_times:
            stages = profiling.stage_totals()[0]
    finally:
        counters.close()
        if log_f:
            log_f.close()
    say('timing:', json.dumps(timer.summary()), flush=True)
    if stages is not None:
        say('stages:', json.dumps({name: round(v['ns'] / 1e6 / max(counted, 1), 4)
                                   for name, v in stages.items()}), flush=True)


def main(argv=None) -> None:
    train(parse_args(argv))


if __name__ == '__main__':
    main(sys.argv[1:])
