"""Lockstep batched environments with auto-reset on the device.

``VectorEnv`` runs ``num_envs`` instances of a
:class:`~multigrid_tpu_torch.envs.env.MultiGridEnv` in lockstep on one
device. Whenever an env is done (all agents terminated, or truncated —
multigrid/base.py:534-539), a fresh layout is swapped in with a per-env
select, so stepping never leaves the device.

Randomness (agent orders, random actions, random starts) comes from the
VectorEnv's own ``torch.Generator`` on the device, seeded by :meth:`reset`.
The loop runs eagerly, one step per Python call.
"""

from __future__ import annotations

import torch

from ..core.actions import NUM_ACTIONS
from ..core.constants import Color, State
from ..core.state import MultiGridState, where_state
from ..envs.env import MultiGridEnv
from ..ops.obs_cuda import gen_obs_batched
from ..ops.step import sample_order
from ..utils.device import resolve_device


class VectorEnv:
    """``num_envs`` lockstep copies of an environment.

    Usage::

        venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2), 4096)
        obs, state = venv.reset(seed=0)
        obs, state, rew, term, trunc, done, success = venv.step(state, actions)

    All returned tensors have a leading ``(num_envs, ...)`` axis. ``done``
    is ``(num_envs,)`` — True where the *previous* episode ended this step
    and the returned obs/state belong to a fresh episode; the rewards and
    terminations are the ending episode's. ``success`` is ``(num_envs,)`` —
    :meth:`MultiGridEnv.success` on the final *pre-reset* state.

    ``device=None`` takes the env's device (which itself defaults to the
    card); another device than the env's is an error.

    ``packed_obs=True`` gives images as the obs kernel's packed int32 cells
    ``type<<8 | color<<4 | state`` on a flat ``(E, N, vs·vs)`` cell axis
    (the training format: a third of the triples' bytes), bit-equal to the
    JAX package's ``VectorEnv(packed_obs=True)``.
    """

    def __init__(
        self,
        env: MultiGridEnv,
        num_envs: int,
        *,
        device: str | torch.device | None = None,
        packed_obs: bool = False,
    ):
        if packed_obs:
            # Observation wrappers work on (vs, vs, 3) channel triples, so
            # only an unwrapped env packs; 4-bit fields bound colors and states.
            if getattr(type(env), 'transform_obs', None) is not None:
                raise ValueError('packed_obs requires an unwrapped env '
                                 '(observation wrappers take channel triples)')
            if len(Color) > 16 or len(State) > 16:
                raise ValueError('packed_obs packs colors and states into 4 bits')
        if device is not None and resolve_device(device) != env.device:
            raise ValueError(
                f'VectorEnv on {device} needs an env on it, not on {env.device}')
        self.env = env
        self.num_envs = num_envs
        self.device = env.device
        self.packed_obs = packed_obs
        self.generator = torch.Generator(device=self.device)

    @property
    def num_agents(self) -> int:
        return self.env.num_agents

    def reset(self, seed: int = 0):
        """Seed the generator and reset all envs. Returns ``(obs, state)``."""
        self.generator.manual_seed(seed)
        state = self.env.reset_core(self.num_envs, self.generator).clone()
        return self.observe(state), state

    def step(self, state: MultiGridState, actions, *, order=None):
        """Step all envs; auto-reset finished episodes.

        ``order`` (E, N) fixes the agents' action order; by default it is
        drawn from the generator. Observations are made once, through the
        kernel, on the merged state: finished envs observe their fresh
        layout, running envs their post-action pre-hook state (base.py:337).

        Returns ``(obs, state, rewards, terminations, truncations, done,
        success)``.
        """
        e, n = self.num_envs, self.num_agents
        if order is None:
            order = sample_order(self.generator, e, n, self.device)
        obs_state, new_state, rew, term, trunc = self.env.step_core(
            state, actions, order)
        done = term.all(dim=-1) | trunc.any(dim=-1)
        # Task completion on the final state, before the reset erases it.
        success = self.env.success(new_state)
        # One exact reset for every env each step, kept where done.
        reset_state = self.env.reset_core(e, self.generator)
        merged = where_state(done, reset_state, new_state)
        obs_state = merged if obs_state is new_state \
            else where_state(done, reset_state, obs_state)
        new_state = merged
        return self.observe(obs_state), new_state, rew, term, trunc, done, success

    def observe(self, state: MultiGridState):
        """Observations of a batched state, through the kernel wrapper."""
        cfg = self.env.cfg
        image = gen_obs_batched(state, cfg.view_size, cfg.see_through_walls,
                                self.packed_obs)
        return self.env.attach_mission(
            {'image': image, 'direction': state.agent_dir}, state)

    def rollout_random(self, state: MultiGridState, steps: int):
        """Advance ``steps`` lockstep steps with uniform-random actions.

        The throughput benchmark core. Returns ``(state, summary)``: the
        reward sum (float32), the number of finished episodes (int32), and
        an observation checksum that wraps to int32 as the JAX package's
        does. The summary stays on the device until read.
        """
        e, n = self.num_envs, self.num_agents
        rew_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        episodes = torch.zeros((), dtype=torch.int64, device=self.device)
        obs_sum = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(steps):
            actions = torch.randint(
                0, NUM_ACTIONS, (e, n), generator=self.generator,
                device=self.device, dtype=torch.int32)
            obs, state, rew, _, _, done, _ = self.step(state, actions)
            rew_sum += rew.sum()
            episodes += done.sum()
            obs_sum += obs['image'].sum()
        wrapped = (obs_sum + 2**31) % 2**32 - 2**31
        return state, {
            'reward_sum': rew_sum,
            'episodes': episodes.to(torch.int32),
            'obs_sum': wrapped.to(torch.int32),
        }
