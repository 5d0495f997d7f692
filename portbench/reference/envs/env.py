"""Environment base class.

Counterpart of ``multigrid_tpu.envs.env``. An environment object holds only
static configuration and its device; episode state lives in a batched
:class:`MultiGridState` (leading env axis ``E``) that the methods take and
return:

    reset(keys)                                   -> (obs, state)
    step(state, actions)                          -> (obs, state, rewards, terms, truncs)
    step_with_order(state, actions, order)        -> the same, deterministic

The single-env API is the ``E = 1`` case: ``actions`` is ``(E, N)``.
``keys`` are threefry2x32 keys, ``(E, 2)`` (or one key ``(2,)``, or an int
seed, for one env; :mod:`~multigrid_tpu_torch.utils.prng`): env ``i``'s
layout and its state's ``rng`` come from key ``i`` as the JAX package's
``reset(key)`` makes them, and each step splits the state's ``rng`` for
the agents' order, bit-equal to the JAX package's streams. Subclasses
implement ``_gen_grid(keys)`` and may override ``post_step``.

On the card ``reset`` and ``step`` replay CUDA graphs, as the JAX package
jits them (env.py:193-232): the caller's state, keys and actions are copied
into the graph's buffers and the results cloned out, so a kept state is
never overwritten (:func:`~multigrid_tpu_torch.utils.graphs.call`); one
graph for each signature. ``step_with_order`` and ``observe`` run
eagerly, and so does an env whose reset runs on the host
(:attr:`MultiGridEnv.host_reset`).
"""

from __future__ import annotations

import abc

import torch

from ..core.config import EnvConfig
from ..core.state import MultiGridState
from ..ops.obs import gen_obs_batched_plain as gen_obs_batched
from ..ops.step import step_with_order
from ..utils import prng
from ..utils.device import resolve_device


class MultiGridEnv(abc.ABC):
    """Base class for batched multi-agent gridworld environments."""

    #: Mission string template; environments with placeholder arguments
    #: override :meth:`mission_of` and :attr:`mission_space` instead.
    mission: str = "maximize reward"

    #: True where ``_gen_grid`` does procedural generation (the RoomGrid
    #: families and RedBlueDoors): a ``VectorEnv`` then amortizes their
    #: auto-resets through its reserve pool by default, as the JAX package
    #: does (multigrid_tpu/parallel/vector.py:88-94).
    procedural_reset: bool = False

    #: Whether this environment's layouts can ever contain a Box; Box-free
    #: environments carry a zero-sized ``box_contents`` table.
    uses_boxes: bool = True

    #: True where ``reset_core`` generates on the host (the MiniGrid
    #: builder's imperative ``_gen_grid``): such an env's ``reset`` and a
    #: ``VectorEnv`` over it run eagerly, since a CUDA graph cannot hold
    #: host work.
    host_reset: bool = False

    def __init__(
        self,
        *,
        agents: int = 1,
        grid_size: int | None = None,
        width: int | None = None,
        height: int | None = None,
        max_steps: int = 100,
        see_through_walls: bool = False,
        agent_view_size: int = 7,
        allow_agent_overlap: bool = True,
        joint_reward: bool = False,
        success_termination_mode: str = 'any',
        failure_termination_mode: str = 'all',
        device: str | torch.device | None = None,
    ):
        width, height = (grid_size, grid_size) if grid_size else (width, height)
        assert width is not None and height is not None
        self.cfg = EnvConfig(
            width=width,
            height=height,
            num_agents=agents,
            max_steps=max_steps,
            see_through_walls=see_through_walls,
            view_size=agent_view_size,
            allow_agent_overlap=allow_agent_overlap,
            joint_reward=joint_reward,
            success_any=(success_termination_mode == 'any'),
            failure_any=(failure_termination_mode == 'any'),
        )
        self.device = resolve_device(device)
        #: Captured graphs of ``reset`` and ``step`` by signature.
        self._graphs: dict = {}

    # ------------------------------------------------------------------ API

    @property
    def num_agents(self) -> int:
        return self.cfg.num_agents

    @property
    def width(self) -> int:
        return self.cfg.width

    @property
    def height(self) -> int:
        return self.cfg.height

    @abc.abstractmethod
    def _gen_grid(self, keys: torch.Tensor) -> MultiGridState:
        """Fresh layouts, one from each key of ``keys`` (E, 2). The tensors
        may be broadcast views: callers copy before writing."""

    def mission_of(self, state: MultiGridState, env: int = 0) -> str | None:
        """Host-side mission string of env ``env`` of a state."""
        return self.mission

    @property
    def mission_space(self):
        """Space of mission strings (reference core/mission.py:45-136);
        environments with placeholder-parameterized missions override it."""
        from ..core.mission import MissionSpace
        return MissionSpace.from_string(self.mission)

    def mission_index(self, state: MultiGridState) -> torch.Tensor | None:
        """(E,) index into :attr:`mission_space` of each env's episode, or
        None when the mission is static. Mission-parameterized environments
        override it so that training can condition on the mission (the
        reference's obs carry the mission, base.py:368-376)."""
        return None

    def attach_mission(self, obs, state: MultiGridState):
        """Add the per-agent mission index to an observation dict (no-op for
        static-mission environments)."""
        mi = self.mission_index(state)
        if mi is None or not isinstance(obs, dict):
            return obs
        mission = torch.as_tensor(mi, dtype=torch.int32, device=state.device)
        return {**obs, 'mission': mission[:, None].expand(-1, self.num_agents)}

    def success(self, state: MultiGridState) -> torch.Tensor:
        """(E,) bool — whether each episode's *task* is complete: any agent
        terminated, which is exact where agents terminate only on success
        (Empty's goal cell, reference base.py:478-507; BlockedUnlockPickup's
        box pickup). Environments with failure terminations or terminations
        that bypass agent state override it with a predicate on the state
        and its extras."""
        return state.agent_terminated.any(dim=-1)

    def transform_obs(self, obs, state: MultiGridState):
        """Observation post-processing hook; identity for base environments.
        Observation wrappers compose through it, so that a ``VectorEnv``
        makes the raw observations once, through the kernel, and applies the
        wrapper chain after (env.py:149-156)."""
        return obs

    def transform_space(self, agent_space):
        """Per-agent observation-space hook; identity here. Observation
        wrappers compose through it, so that the adapters report the space
        wrapped observations inhabit (env.py:158-163)."""
        return agent_space

    def post_step(
        self,
        prev_state: MultiGridState,
        state: MultiGridState,
        actions: torch.Tensor,
        rewards: torch.Tensor,
        terminations: torch.Tensor,
        action_mask: torch.Tensor | None,
    ) -> tuple[MultiGridState, torch.Tensor, torch.Tensor]:
        """Env-specific post-step hook; runs *after* the observation state is
        taken (the reference's subclass ``step()`` bodies post-process the
        base class result). It reads and returns the state's extras, and
        writes no tensor in place. ``action_mask`` None means every agent
        acted."""
        return state, rewards, terminations

    # -------------------------------------------------------------- core fns

    def keys(self, keys) -> torch.Tensor:
        """``keys`` as an (E, 2) int64 tensor on this env's device: one key
        (2,) or an int seed is one env's."""
        return prng.as_key(keys, self.device).reshape(-1, 2)

    def reset_core(self, keys) -> MultiGridState:
        """Fresh episode states without observations (tensors may be
        broadcast views): ``gen_key, rng = split(key)`` for each env, the
        layout from ``gen_key`` and the state's ``rng`` the other
        (env.py:185-191)."""
        pair = prng.split(self.keys(keys))
        return self.reset_from(pair[:, 0], pair[:, 1])

    def reset_from(self, gen_keys: torch.Tensor, rngs: torch.Tensor) -> MultiGridState:
        """:meth:`reset_core` from keys already split: the layouts from
        ``gen_keys`` and ``rngs`` the states' keys (each (E, 2))."""
        state = self._gen_grid(gen_keys)
        return state.replace(rng=rngs, step_count=torch.zeros_like(state.step_count))

    def reset(self, keys=0):
        """Start new episodes, one from each key (by default one env from
        ``key(0)``). Returns ``(obs, state)`` (base.py:250-301). On the
        card, one graph replay."""
        return self._reset(self.keys(keys))

    def _reset(self, keys):
        state = self.reset_core(keys).clone()
        return self.observe(state), state

    def step(
        self,
        state: MultiGridState,
        actions,
        action_mask: torch.Tensor | None = None,
    ):
        """Advance one timestep, each env's agents in a random order drawn
        from its ``rng``, which the step splits (env.py:210-217). Returns
        ``(obs, state, rewards, terminations, truncations)``. On the card,
        one graph replay."""
        return self._step(state, actions, action_mask)

    def _step(self, state, actions, action_mask=None):
        order, rng, _, _ = prng.step_draws(state.rng, self.num_agents)
        return self.step_with_order(state.replace(rng=rng), actions, order, action_mask)


    def step_with_order(
        self,
        state: MultiGridState,
        actions,
        order,
        action_mask: torch.Tensor | None = None,
    ):
        """Deterministic step: the caller supplies the (E, N) agent order."""
        obs_state, state, rewards, terms, truncs = self.step_core(
            state, actions, order, action_mask)
        return self.observe(obs_state), state, rewards, terms, truncs

    def observe(self, state: MultiGridState):
        """``{'image': (E, N, vs, vs, 3), 'direction': (E, N)}`` for a state,
        through the observation kernel on the card (base.py:348-376)."""
        cfg = self.cfg
        image = gen_obs_batched(state, cfg.view_size, cfg.see_through_walls)
        return self.attach_mission(
            {'image': image, 'direction': state.agent_dir}, state)

    def step_core(self, state, actions, order, action_mask=None):
        """Dynamics and post-step hook WITHOUT observations.

        Returns ``(obs_state, state, rewards, terms, truncs)``: ``obs_state``
        is the post-action, *pre-hook* state that observations are made from
        (base.py:337 generates obs before subclass step() bodies run), and
        ``state`` the post-hook state carried on. They are the same object
        when the hook changes nothing.
        """
        dev = state.device
        actions = torch.as_tensor(actions, device=dev)
        order = torch.as_tensor(order, device=dev)
        prev_state = state
        state, rewards, terms, truncs = step_with_order(
            self.cfg, state, actions, order, action_mask)
        obs_state = state
        state, rewards, terms = self.post_step(
            prev_state, state, actions, rewards, terms, action_mask)
        return obs_state, state, rewards, terms, truncs

    # ---------------------------------------------------------------- helpers

    def is_done(self, terminations: torch.Tensor, truncations: torch.Tensor) -> torch.Tensor:
        """(E,) whether each episode is finished for all agents
        (base.py:534-539)."""
        return terminations.all(dim=-1) | truncations.any(dim=-1)

    def __repr__(self):
        return f'{self.__class__.__name__}({self.cfg}, device={self.device})'
