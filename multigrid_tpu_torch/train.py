"""Train PPO policies on a MultiGrid environment, on the card.

The counterpart of the JAX package's ``scripts/train.py`` for the mlp
encoder on packed observations: one policy shared by all agents, or one per
agent (``--per-agent-policies``), with each agent's own value head or a
centralized critic (``--critic centralized``):

    python -m multigrid_tpu_torch.train --env MultiGrid-Empty-16x16-v0 \\
        --num-agents 4 --num-envs 4096 --num-timesteps 10000000

Any registered environment trains; on one with missions
(``MultiGrid-BlockedUnlockPickup-v0``) the net conditions on the mission,
sized from the env's mission space. The JAX package's production recipe
there is ``--num-agents 2 --num-envs 4096 --rollout-steps 128 --epochs 2
--minibatches 4``.

Every ``--log-interval`` updates (and after the last) it prints one JSON row
of metrics, and appends it to ``--log-jsonl`` when given. ``--device cpu``
runs on the CPU with the kernels' plain versions. With
``MULTIGRID_FUSED_POLICY`` set (a shared policy, local critic), the rollout
samples through the fused-policy kernel.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description='Train PPO policies on MultiGrid (PyTorch/CUDA).')
    p.add_argument('--env', default='MultiGrid-Empty-8x8-v0')
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
    p.add_argument('--per-agent-policies', action='store_true',
                   help="independent parameters per agent (the reference "
                        "example's policy_{i}); default is shared self-play")
    p.add_argument('--critic', default='local', choices=['local', 'centralized'],
                   help="'centralized' = MAPPO-style joint-observation value "
                        'function (actors stay partial)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--log-interval', type=int, default=10,
                   help='log metrics every N updates')
    p.add_argument('--log-jsonl', default=None,
                   help='append the logged metrics as JSON lines')
    p.add_argument('--device', default=None,
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def train(args: argparse.Namespace) -> None:
    from multigrid_tpu_torch.envs import make
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.parallel import VectorEnv

    env = make(args.env, agents=args.num_agents, device=args.device)
    venv = VectorEnv(env, args.num_envs, packed_obs=True)
    config = PPOConfig(rollout_steps=args.rollout_steps, lr=args.lr,
                       gamma=args.gamma, ent_coef=args.ent_coef,
                       epochs=args.epochs, minibatches=args.minibatches,
                       per_agent_policies=args.per_agent_policies,
                       centralized_critic=args.critic == 'centralized')
    state, net, config, tx = ppo_init(venv, args.seed, config=config,
                                      hidden=args.hidden)
    train_step = make_train_step(venv, net, config, tx)
    steps_per_update = args.num_envs * args.num_agents * config.rollout_steps
    num_updates = max(1, args.num_timesteps // steps_per_update)
    kind = (torch.cuda.get_device_name(venv.device) if venv.device.type == 'cuda'
            else 'cpu')
    print(f'training {args.env}: {args.num_agents} agents x {args.num_envs} envs, '
          f'{num_updates} updates of {steps_per_update} agent-steps on {kind}',
          flush=True)

    log_f = open(args.log_jsonl, 'a') if args.log_jsonl else None
    try:
        t_start = time.perf_counter()
        t_last, steps_last = t_start, 0
        for update in range(num_updates):
            state, metrics = train_step(state)
            if (update + 1) % args.log_interval and update != num_updates - 1:
                continue
            # Reading the metrics waits for the device: the rates below are
            # of finished work.
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
            print(json.dumps(row), flush=True)
            if log_f:
                log_f.write(json.dumps(row) + '\n')
                log_f.flush()
    finally:
        if log_f:
            log_f.close()


def main(argv=None) -> None:
    train(parse_args(argv))


if __name__ == '__main__':
    main(sys.argv[1:])
