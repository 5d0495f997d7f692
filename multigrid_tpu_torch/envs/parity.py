"""Host-side parity mode: bit-exact reproduction of the reference RNG streams.

The reference's randomness is split across streams with a parity-critical
quirk: the ``RandomMixin`` generator is captured at construction and *not*
re-seeded by ``reset(seed=...)``. The parity recipe injects a single
``np.random.default_rng(seed)`` into both the per-step agent-order shuffle
and the layout draws. This module mirrors that recipe: layout generation
runs on the host, consuming numpy draws in exactly the reference's program
order, and the per-step order permutation is drawn on the host and fed to
the deterministic step.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from ..core.constants import TYPE_EMPTY
from ..core.state import state_from_numpy


def parity_place_obj(
    G: np.random.Generator,
    grid: np.ndarray,
    agent_pos: np.ndarray,
    obj_enc: np.ndarray | None,
    top: tuple[int, int] | None = None,
    size: tuple[int, int] | None = None,
    reject_fn: Callable[[tuple[int, int]], bool] | None = None,
    max_tries: float = math.inf,
) -> np.ndarray:
    """Rejection-sample a placement, drawing from ``G`` in exactly the
    reference's order (multigrid/base.py:604-670).

    Mutates ``grid`` in place when ``obj_enc`` is given. Returns the (x, y).
    """
    w, h, _ = grid.shape
    if top is None:
        top = (0, 0)
    else:
        top = (max(top[0], 0), max(top[1], 0))
    if size is None:
        size = (w, h)

    num_tries = 0
    while True:
        if num_tries > max_tries:
            raise RecursionError("rejection sampling failed in place_obj")
        num_tries += 1
        x = int(G.integers(top[0], min(top[0] + size[0], w)))
        y = int(G.integers(top[1], min(top[1] + size[1], h)))
        if grid[x, y, 0] != TYPE_EMPTY:
            continue
        if bool(((agent_pos == (x, y)).all(axis=-1)).any()):
            continue
        if reject_fn is not None and reject_fn((x, y)):
            continue
        break

    if obj_enc is not None:
        grid[x, y] = obj_enc
    return np.array([x, y], dtype=np.int32)


def parity_place_agent(
    G: np.random.Generator,
    grid: np.ndarray,
    agent_pos: np.ndarray,
    agent_idx: int,
    top=None,
    size=None,
    rand_dir: bool = True,
    max_tries: float = math.inf,
) -> tuple[np.ndarray, int]:
    """Mirror of ``MultiGridEnv.place_agent`` (base.py:680-697): clear the
    agent's own position, rejection-sample, then draw a random direction."""
    agent_pos[agent_idx] = (-1, -1)
    pos = parity_place_obj(G, grid, agent_pos, None, top, size,
                           max_tries=max_tries)
    agent_pos[agent_idx] = pos
    direction = int(G.integers(0, 4)) if rand_dir else -1
    return pos, direction


class ParityRunner:
    """Drive one env (``E = 1``) with reference-identical RNG consumption.

    Resets generate layouts host-side via the env's ``_gen_grid_parity``;
    steps draw the agent-order permutation from the same generator
    (``G.random(N).argsort()``, base.py:396-399) and run the deterministic
    step.
    """

    def __init__(self, env, seed: int):
        self.env = env
        self.seed = seed
        self.G = np.random.default_rng(seed)
        self.state = None

    def reset(self) -> dict[int, dict[str, Any]]:
        data = self.env._gen_grid_parity(self.G)
        self.state = state_from_numpy(
            device=self.env.device, has_boxes=self.env.uses_boxes, **data)
        return self._split_obs(self.env.observe(self.state))

    def step(self, actions: dict[int, int]):
        n = self.env.cfg.num_agents
        if n == 1:
            order = np.zeros((1,), dtype=np.int64)
        else:
            order = np.argsort(self.G.random(n))

        action_arr = np.zeros((1, n), dtype=np.int32)
        mask = np.zeros((1, n), dtype=bool)
        for i, a in actions.items():
            action_arr[0, i] = int(a)
            mask[0, i] = True

        dev = self.env.device
        obs, self.state, rew, term, trunc = self.env.step_with_order(
            self.state, torch.as_tensor(action_arr, device=dev),
            torch.as_tensor(order[None], device=dev),
            torch.as_tensor(mask, device=dev))
        rew, term, trunc = (x[0].cpu().numpy() for x in (rew, term, trunc))
        observations = self._split_obs(obs)
        rewards = {i: float(rew[i]) for i in range(n)}
        terminations = {i: bool(term[i]) for i in range(n)}
        truncations = {i: bool(trunc[i]) for i in range(n)}
        return observations, rewards, terminations, truncations, {}

    def _split_obs(self, obs) -> dict[int, dict[str, Any]]:
        image = obs['image'][0].cpu().numpy()
        direction = obs['direction'][0].cpu().numpy()
        return {
            i: {'image': image[i], 'direction': int(direction[i])}
            for i in range(self.env.cfg.num_agents)
        }
