"""Evaluate a trained policy's exact task completion over many episodes.

The counterpart of the JAX package's ``scripts/evaluate.py``: it restores
only the parameters of a checkpoint written by
``python -m multigrid_tpu_torch.train`` (any encoder, per-agent policies or
a critic, which must match the training run's flags), rolls the policy,
sampling its actions, over a lockstep ``VectorEnv`` on the card in
iterations of 256 steps (with the reserve pool, ``refresh=False`` steps and
one ``refresh_pool(256)`` an iteration), and prints one JSON row: the
fraction of finished episodes whose final state met the env's success
predicate, their mean return, and the evaluation's agent-steps/s (timed
from the first iteration on, the graph's capture included). On the card
the body of the JAX script's jitted scan (scripts/evaluate.py:111-137) is
one CUDA graph of one step, captured once and replayed 256 times an
iteration with the env state carried in its buffers, as the probe does; a
graph of more steps costs a warm-up and a capture that grow with them
while a replay gains nothing, since the card is busy through the steps.
``disable_graphs()`` runs the same steps eagerly, to the same JSON but the
rate:

    python -m multigrid_tpu_torch.evaluate --env MultiGrid-LockedHallway-2Rooms-v0 \\
        --num-agents 2 --encoder mlp --checkpoint ckpt/lh2/best \\
        --num-envs 4096 --num-steps 100000000
"""

from __future__ import annotations

import argparse
import functools
import json
import pickle
import sys
import time

import torch

#: Steps of one evaluation iteration (scripts/evaluate.py:109).
STEPS_PER_ITER = 256


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description='Evaluate exact task completion of a trained policy (PyTorch/CUDA).')
    p.add_argument('--env', default='MultiGrid-Empty-8x8-v0')
    p.add_argument('--num-agents', type=int, default=2)
    p.add_argument('--env-config', type=json.loads, default={})
    p.add_argument('--num-envs', type=int, default=4096)
    p.add_argument('--num-steps', type=int, default=10_000_000,
                   help='total agent-steps of evaluation')
    p.add_argument('--checkpoint', default=None,
                   help='explicit checkpoint path (e.g. <save-dir>/best); with '
                        '--load-dir, the latest step_* is used')
    p.add_argument('--load-dir', default=None)
    p.add_argument('--hidden', type=int, default=128)
    p.add_argument('--encoder', default='cnn', choices=['cnn', 'mlp'])
    p.add_argument('--per-agent-policies', action='store_true')
    p.add_argument('--critic', default='local', choices=['local', 'centralized'],
                   help='must match the training run (it shapes the parameters)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None, help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def start(venv, state, key):
    """The carry an iteration starts from (scripts/evaluate.py:128-133):
    ``(state, its observations, the iteration's key, each env's return so
    far, (episodes, successes, banked return))``, the return and the sums
    zero."""
    dev = venv.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return (state, venv.observe(state), key, torch.zeros(venv.local_envs, device=dev),
            (zero, zero.clone(), torch.zeros((), device=dev)))


@torch.no_grad()
def scan_step(step, params, carry):
    """One step of the JAX script's scan body (scripts/evaluate.py:112-126)
    from ``carry`` (:func:`start`'s form): ``key, ka = split(key)``, the
    actor of ``step`` (a ``TrainStep``) with ``params`` sampling
    ``categorical(ka, logits)`` (the split and the noise one draw,
    ``split_first``), one step of ``step.venv``, and its
    finished episodes added to the sums. Returns the carry after it: the
    function the card captures."""
    from multigrid_tpu_torch.learn.ppo import sample_actions
    from multigrid_tpu_torch.utils import prng

    venv = step.venv
    state, obs, key, ep_acc, (episodes, successes, banked) = carry
    logits, _ = step.actor(params, obs['image'], obs['direction'], obs.get('mission'))
    key, noise = prng.gumbel(key, (venv.num_envs,) + tuple(logits.shape[1:]), rows=venv.rows,
                             split_first=True)
    action = sample_actions(logits, noise)
    obs, state, rew, _, _, done, success = venv.step(state, action,
                                                     refresh=not venv.reset_pool)
    ep_acc = ep_acc + rew.sum(-1)
    episodes = episodes + done.sum()
    successes = successes + (done & success).sum()
    banked = banked + torch.where(done, ep_acc, 0.0).sum()
    return state, obs, key, torch.where(done, 0.0, ep_acc), (episodes, successes, banked)


def evaluate(args: argparse.Namespace) -> dict:
    from multigrid_tpu_torch.envs import make
    from multigrid_tpu_torch.learn import PPOConfig, make_train_step, ppo_init
    from multigrid_tpu_torch.parallel import VectorEnv
    from multigrid_tpu_torch.utils import graphs, prng
    from multigrid_tpu_torch.utils.checkpoint import latest_checkpoint, restore_params

    env = make(args.env, agents=args.num_agents, device=args.device, **args.env_config)
    venv = VectorEnv(env, args.num_envs, packed_obs=True)
    config = PPOConfig(per_agent_policies=args.per_agent_policies,
                       centralized_critic=args.critic == 'centralized')
    tmp_state, net, config, tx = ppo_init(
        venv, args.seed, config=config,
        net_kwargs=dict(hidden=args.hidden, encoder=args.encoder))
    ckpt = args.checkpoint or (latest_checkpoint(args.load_dir) if args.load_dir else None)
    if not ckpt:
        raise SystemExit('pass --checkpoint or --load-dir (with a step_* checkpoint)')
    try:
        params = restore_params(ckpt, tmp_state.params)
    except (ValueError, RuntimeError, OSError, pickle.UnpicklingError) as exc:
        raise SystemExit(
            f'failed to restore {ckpt}: {exc}\n'
            'Hint: --per-agent-policies, --critic, --hidden, --encoder and --num-agents '
            'must match the training run.') from exc
    print(f'loaded policy from {ckpt}', flush=True)
    step = make_train_step(venv, net, config, tx)
    advance = functools.partial(scan_step, step, params)
    key, rk = prng.split(prng.key(args.seed + 1, venv.device)).unbind(0)
    _, env_state = venv.reset(rk)
    total = [0.0, 0.0, 0.0]
    steps_done = 0
    t0 = time.perf_counter()
    key, k = prng.split(key).unbind(0)
    carry = graphs.clone(start(venv, env_state, k))
    graph = None
    if venv.graphed():
        graph = graphs.Graph(lambda c: (advance(c), None), carry, carry=True)
    while steps_done < args.num_steps:
        if steps_done:
            key, k = prng.split(key).unbind(0)
            fresh = start(venv, venv.refresh_pool(carry[0], STEPS_PER_ITER), k)
            if graph is None:
                carry = fresh
            else:
                graphs.load(carry, fresh)
        for _ in range(STEPS_PER_ITER):
            if graph is None:
                carry = advance(carry)
            else:
                graph.replay()
        total = [t + float(a) for t, a in zip(total, carry[4])]
        steps_done += STEPS_PER_ITER * venv.num_envs * venv.num_agents
    dt = time.perf_counter() - t0
    episodes, successes, ret = total
    out = {
        'checkpoint': ckpt,
        'agent_steps': steps_done,
        'episodes': int(episodes),
        'success_rate_exact': round(successes / max(episodes, 1), 5),
        'mean_episode_return': round(ret / max(episodes, 1), 4),
        'eval_agent_steps_per_sec': round(steps_done / dt),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    return evaluate(parse_args(argv))


if __name__ == '__main__':
    main(sys.argv[1:])
