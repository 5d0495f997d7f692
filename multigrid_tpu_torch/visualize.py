"""Visualize trained agents (or random policies) in MultiGrid environments.

The counterpart of the JAX package's ``scripts/visualize.py``, with its
flags (``--device`` in place of ``--platform``): it rolls out episodes of
one env on the card, through a ``VectorEnv(num_envs=1, auto_reset=False)``
(the observation kernel once a reset and once a step), renders a frame of
each state on the host, and optionally saves a GIF. The policy is uniform
random, or the one restored from a checkpoint of
``python -m multigrid_tpu_torch.train`` (``--load-dir`` or
``--checkpoint``; its parameters only, as ``evaluate`` restores them), which
then reads packed cells and samples its actions:

    python -m multigrid_tpu_torch.visualize --env MultiGrid-Empty-8x8-v0 \\
        --num-agents 2 --load-dir checkpoints --gif out.gif
    python -m multigrid_tpu_torch.visualize --env MultiGrid-BlockedUnlockPickup-v0 --gif bup
"""

from __future__ import annotations

import argparse
import pickle
import sys

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='Visualize MultiGrid agents (PyTorch/CUDA).')
    p.add_argument('--env', default='MultiGrid-Empty-8x8-v0')
    p.add_argument('--num-agents', type=int, default=2)
    p.add_argument('--num-episodes', type=int, default=2)
    p.add_argument('--max-steps', type=int, default=200)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--load-dir', default=None,
                   help='checkpoint directory from python -m multigrid_tpu_torch.train; '
                        'random policy when omitted')
    p.add_argument('--hidden', type=int, default=128)
    p.add_argument('--encoder', default='cnn', choices=['cnn', 'mlp'])
    p.add_argument('--per-agent-policies', action='store_true',
                   help='must match the flag the checkpoint was trained with')
    p.add_argument('--critic', default='local', choices=['local', 'centralized'],
                   help='must match the training run (it shapes the parameters)')
    p.add_argument('--checkpoint', default=None,
                   help='explicit checkpoint path (e.g. <save-dir>/best) '
                        'instead of the latest step_* under --load-dir')
    p.add_argument('--gif', default=None, help='output GIF path')
    p.add_argument('--tile-size', type=int, default=32)
    p.add_argument('--device', default=None, help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def restored_policy(venv, args):
    """``policy(obs) -> actions`` (1, N) of the checkpoint's actors on
    ``venv``'s packed cells, sampling from their logits."""
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.learn.ppo import sample_actions
    from multigrid_tpu_torch.utils import prng
    from multigrid_tpu_torch.utils.checkpoint import latest_checkpoint, restore_params

    config = PPOConfig(per_agent_policies=args.per_agent_policies,
                       centralized_critic=args.critic == 'centralized')
    # ppo_init sizes the mission conditioning from the env's mission space,
    # as the trainer did.
    tmp_state, net, config, tx = ppo_init(
        venv, args.seed, config=config,
        net_kwargs=dict(hidden=args.hidden, encoder=args.encoder))
    ckpt = args.checkpoint or (latest_checkpoint(args.load_dir) if args.load_dir else None)
    if not ckpt:
        raise SystemExit(f'no checkpoint under {args.load_dir}')
    try:
        # Parameters only: the optimizer's layout (--lr-anneal) and
        # --num-envs do not matter for a rollout.
        params = restore_params(ckpt, tmp_state.params)
    except (ValueError, RuntimeError, OSError, pickle.UnpicklingError) as exc:
        raise SystemExit(
            f'failed to restore {ckpt}: {exc}\n'
            'Hint: --per-agent-policies, --critic, --hidden, --encoder and --num-agents '
            'must match the training run (mission conditioning is sized automatically).'
        ) from exc
    print(f'loaded policy from {ckpt}', flush=True)
    step = make_train_step(venv, net, config, tx)

    @torch.no_grad()
    def policy(key, obs):
        # The actors only: with the centralized critic, step.actor takes
        # the actor.* parameters. categorical(key, logits) (visualize.py:100-114).
        logits, _ = step.actor(params, obs['image'], obs['direction'], obs.get('mission'))
        return sample_actions(logits, prng.gumbel(key, logits.shape))

    return policy


def visualize(args: argparse.Namespace) -> list[np.ndarray]:
    """Roll out ``--num-episodes`` episodes; returns the frames, one for
    each reset and each step, (H·t, W·t, 3) uint8."""
    from multigrid_tpu_torch.core.actions import NUM_ACTIONS
    from multigrid_tpu_torch.envs import make
    from multigrid_tpu_torch.parallel import VectorEnv
    from multigrid_tpu_torch.render import render_state
    from multigrid_tpu_torch.utils import prng

    env = make(args.env, agents=args.num_agents, device=args.device)
    restore = bool(args.load_dir or args.checkpoint)
    venv = VectorEnv(env, 1, auto_reset=False, packed_obs=restore)
    policy = restored_policy(venv, args) if restore else None
    # One key chain, as the JAX script's (visualize.py:117-129): a split for
    # each episode's reset and each step's actions.
    key = prng.key(args.seed, venv.device)

    frames: list[np.ndarray] = []
    for ep in range(args.num_episodes):
        key, reset_key = prng.split(key).unbind(0)
        obs, state = venv.reset(reset_key)
        frames.append(render_state(env, state, tile_size=args.tile_size))
        total = np.zeros(env.num_agents)
        for t in range(args.max_steps):
            key, act_key = prng.split(key).unbind(0)
            if policy is None:
                actions = prng.randint(act_key, (1, env.num_agents), 0, NUM_ACTIONS)
            else:
                actions = policy(act_key, obs)
            obs, state, rew, _, _, done, _ = venv.step(state, actions)
            frames.append(render_state(env, state, tile_size=args.tile_size))
            total += rew[0].cpu().numpy()
            if bool(done[0]):
                break
        print(f'episode {ep}: {t + 1} steps, rewards {total.tolist()}', flush=True)

    if args.gif:
        from PIL import Image
        path = args.gif if args.gif.endswith('.gif') else args.gif + '.gif'
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=100, loop=0)
        print(f'saved {len(frames)} frames -> {path}', flush=True)
    return frames


def main(argv=None) -> list[np.ndarray]:
    return visualize(parse_args(argv))


if __name__ == '__main__':
    main(sys.argv[1:])
