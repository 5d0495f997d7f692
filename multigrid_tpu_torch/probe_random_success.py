"""Probe random-policy success rates across sparse-reward envs, on the card.

The counterpart of the JAX package's ``scripts/probe_random_success.py``:
it counts, under uniform-random actions over a ``VectorEnv`` (the
observation kernel every step), the episodes that end in success (the
env's exact task-completion predicate on the final pre-reset state), in
failure, and by truncation: the base rate PPO exploration must amplify.
One JSON row an env. On the card the scan's body (the draws, the step, the
classification and the counts, carried on the device) is one CUDA graph
replayed ``steps`` times, as the JAX script jits its scan
(scripts/probe_random_success.py:48-55); a graph of all ``steps`` steps
would cost a capture that grows with them:

    python -m multigrid_tpu_torch.probe_random_success \\
        --envs MultiGrid-RedBlueDoors-6x6-v0 --num-envs 1024 --steps 2048

``--device cpu`` runs on the CPU with the kernel's plain version.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def classify(done: torch.Tensor, success: torch.Tensor, term: torch.Tensor,
             trunc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(wins, failures, truncations)`` among one step's finished envs
    (each an int64 count), as the JAX script classifies them
    (probe_random_success.py:43-45): a win is ``done & success``; a
    truncation a non-win that ended with some agent truncated and not every
    agent terminated; every other finished episode a failure. ``done`` and
    ``success`` are (E,), ``term`` and ``trunc`` (E, N)."""
    win = done & success
    tr = trunc.any(dim=-1) & ~term.all(dim=-1)
    return win.sum(), (done & ~win & ~tr).sum(), (done & tr).sum()


def scan_step(venv, carry):
    """One step of the probe's scan: ``carry`` = ``(state, key, counts)``,
    the counts (3,) of wins, failures and truncations so far. ``key, ak =
    split(key)``, uniform-random actions ``randint(ak, (E, N))``
    (probe_random_success.py:33-37; one draw, ``split_first``), one step,
    its finished episodes classified (:func:`classify`) and added."""
    from multigrid_tpu_torch.core.actions import NUM_ACTIONS
    from multigrid_tpu_torch.utils import prng

    state, key, counts = carry
    key, actions = prng.randint(key, (venv.num_envs, venv.num_agents), 0, NUM_ACTIONS,
                                rows=venv.rows, split_first=True)
    _, state, _, term, trunc, done, success = venv.step(state, actions)
    return state, key, counts + torch.stack(classify(done, success, term, trunc))


def probe(env_id: str, num_agents: int, num_envs: int, steps: int, seed: int,
          device: str | None = None) -> dict:
    """Random-policy episode outcomes of ``env_id`` over ``steps`` lockstep
    steps of ``num_envs`` envs."""
    from multigrid_tpu_torch.envs import make
    from multigrid_tpu_torch.parallel import VectorEnv
    from multigrid_tpu_torch.utils import graphs, prng

    env = make(env_id, agents=num_agents, device=device)
    venv = VectorEnv(env, num_envs)
    rkey, key = prng.split(prng.key(seed, env.device)).unbind(0)
    _, state = venv.reset(rkey)

    carry = (state, key, torch.zeros(3, dtype=torch.int64, device=venv.device))
    if venv.graphed() and steps:
        graph = graphs.Graph(lambda c: (scan_step(venv, c), None), graphs.clone(carry),
                             carry=True)
        for _ in range(steps):
            graph.replay()
        carry = graph.inputs
    else:
        for _ in range(steps):
            carry = scan_step(venv, carry)
    succ, fail, trunc_n = carry[2].tolist()
    total = succ + fail + trunc_n
    return {
        'env': env_id, 'agents': num_agents, 'episodes': total,
        'successes': succ, 'failures': fail, 'truncations': trunc_n,
        'success_rate': succ / max(total, 1),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description='Random-policy success rates (PyTorch/CUDA).')
    p.add_argument('--envs', nargs='*', default=[
        'MultiGrid-RedBlueDoors-6x6-v0',
        'MultiGrid-RedBlueDoors-8x8-v0',
        'MultiGrid-BlockedUnlockPickup-v0',
        'MultiGrid-LockedHallway-2Rooms-v0',
    ])
    p.add_argument('--num-agents', type=int, default=2)
    p.add_argument('--num-envs', type=int, default=1024)
    p.add_argument('--steps', type=int, default=2048)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    for env_id in args.envs:
        print(json.dumps(probe(env_id, args.num_agents, args.num_envs, args.steps,
                               args.seed, args.device)), flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
