"""Stage-level training throughput on the card: each nested stage of a PPO
update, at the flagship configuration by default.

  A. env-only rollout (random actions, no policy)
  B. rollout with the policy's forward and sampling, nothing stored
  C. the full rollout phase (the trajectory stored)
  E. the full update (rollout, GAE, loss, backward, optimizer)

The counterpart of the JAX package's ``scripts/profile_train.py``, with its
flags and its output, plus ``--device``: as there the net is
``ActorCritic(encoder=...)`` on ``(vs, vs, 3)`` images and each stage covers
``--updates-per-call`` updates' worth of steps a timed call. Each stage is
timed with the card synchronized before and after, as the median of 3
calls after a warm-up call (the JAX script's scan carries and host-transfer
barriers are TPU idioms). Prints one line a stage, then one
JSON object of agent-steps/s by stage:

    python -m multigrid_tpu_torch.profile_train --num-envs 4096 --agents 4
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .profile_env import timed


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='Stage-level PPO throughput (PyTorch/CUDA).')
    p.add_argument('--num-envs', type=int, default=4096)
    p.add_argument('--agents', type=int, default=4)
    p.add_argument('--env-id', default='MultiGrid-Empty-16x16-v0')
    p.add_argument('--encoder', default='mlp', choices=['mlp', 'cnn'])
    p.add_argument('--rollout-steps', type=int, default=16)
    p.add_argument('--updates-per-call', type=int, default=8)
    p.add_argument('--stages', default='ABCE', help='subset of stages to run')
    p.add_argument('--device', default=None, help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict[str, float]:
    """Time the stages ``--stages`` names; returns agent-steps/s by stage."""
    args = parse_args(argv)
    from multigrid_tpu_torch.envs import make
    from multigrid_tpu_torch.learn import PPOConfig, make_train_loop, make_train_step, ppo_init
    from multigrid_tpu_torch.parallel import VectorEnv

    env = make(args.env_id, agents=args.agents, device=args.device)
    venv = VectorEnv(env, args.num_envs)
    state, net, config, tx = ppo_init(venv, 0, config=PPOConfig(rollout_steps=args.rollout_steps),
                                      net_kwargs=dict(encoder=args.encoder))
    device, upc = venv.device, args.updates_per_call
    steps_per_call = config.rollout_steps * upc
    agent_steps = args.num_envs * args.agents * steps_per_call
    step = make_train_step(venv, net, config, tx)
    results = {}

    def emit(k, seconds):
        results[k] = agent_steps / seconds
        print(f'{k:28s} {results[k] / 1e6:8.1f} M agent-steps/s', flush=True)

    if 'A' in args.stages:
        env_state = venv.reset(seed=1)[1]
        emit('A_env_only', timed(
            lambda: venv.rollout_random(env_state, 1, steps_per_call)[1]['obs_sum'].item(),
            device))

    @torch.no_grad()
    def rollout_nostore():
        params = state.params
        prepped = step.prepare_policy(params)
        env_state, obs, key, acc = state.env_state, state.last_obs, state.key, 0.0
        for _ in range(steps_per_call):
            action, _, value, key = step.policy_step(params, prepped, obs, key)
            obs, env_state, reward, *_ = venv.step(env_state, action)
            acc = acc + reward.sum() + value.sum()
        return float(acc)

    if 'B' in args.stages:
        emit('B_rollout_policy_nostore', timed(rollout_nostore, device))

    def rollout_store():
        s, acc = state, 0.0
        for _ in range(upc):
            s, traj, last_value, _ = step.rollout_phase(s)
            acc = acc + traj.reward.sum() + traj.value.sum() + last_value.sum()
        return float(acc)

    if 'C' in args.stages:
        emit('C_rollout_stored', timed(rollout_store, device))
    if 'E' in args.stages:
        loop = make_train_loop(venv, net, config, tx, upc)
        emit('E_full_train', timed(lambda: float(loop(state)[1]['loss']), device))
    print(json.dumps({k: round(v) for k, v in results.items()}), flush=True)
    return results


if __name__ == '__main__':
    main(sys.argv[1:])
