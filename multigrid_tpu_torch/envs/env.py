"""Environment base class.

Counterpart of ``multigrid_tpu.envs.env``. An environment object holds only
static configuration and its device; episode state lives in a batched
:class:`MultiGridState` (leading env axis ``E``) that the methods take and
return:

    reset(generator)                              -> (obs, state)
    step(state, actions, generator)               -> (obs, state, rewards, terms, truncs)
    step_with_order(state, actions, order)        -> the same, deterministic

The single-env API is the ``E = 1`` case: ``actions`` is ``(E, N)``.
Subclasses implement ``_gen_grid(num_envs, generator)`` and may override
``post_step``.
"""

from __future__ import annotations

import abc

import torch

from ..core.config import EnvConfig
from ..core.state import MultiGridState
from ..ops.obs_cuda import gen_obs_batched
from ..ops.step import sample_order, step_with_order
from ..utils.device import resolve_device


class MultiGridEnv(abc.ABC):
    """Base class for batched multi-agent gridworld environments."""

    #: Mission string.
    mission: str = "maximize reward"

    #: Whether this environment's layouts can ever contain a Box; Box-free
    #: environments carry a zero-sized ``box_contents`` table.
    uses_boxes: bool = True

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
    def _gen_grid(
        self, num_envs: int, generator: torch.Generator | None
    ) -> MultiGridState:
        """Fresh layouts for ``num_envs`` envs. The tensors may be broadcast
        views: callers copy before writing."""

    def mission_index(self, state: MultiGridState) -> torch.Tensor | None:
        """(E,) mission index, or None when the mission is static."""
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
        (Empty's goal cell, reference base.py:478-507)."""
        return state.agent_terminated.any(dim=-1)

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
        base class result)."""
        return state, rewards, terminations

    # -------------------------------------------------------------- core fns

    def reset_core(
        self, num_envs: int = 1, generator: torch.Generator | None = None
    ) -> MultiGridState:
        """Fresh episode states without observations (tensors may be
        broadcast views)."""
        return self._gen_grid(num_envs, generator)

    def reset(self, generator: torch.Generator | None = None, num_envs: int = 1):
        """Start new episodes. Returns ``(obs, state)`` (base.py:250-301)."""
        state = self.reset_core(num_envs, generator).clone()
        return self.observe(state), state

    def step(
        self,
        state: MultiGridState,
        actions,
        generator: torch.Generator | None = None,
        action_mask: torch.Tensor | None = None,
    ):
        """Advance one timestep with random agent orders drawn from
        ``generator``. Returns ``(obs, state, rewards, terminations,
        truncations)``."""
        order = sample_order(generator, state.num_envs, self.num_agents,
                             state.device)
        return self.step_with_order(state, actions, order, action_mask)

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
