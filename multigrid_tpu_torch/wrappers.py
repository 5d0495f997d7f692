"""Observation wrappers over the batched env API.

Counterparts of the JAX package's wrappers (multigrid_tpu/wrappers.py) and
of the reference's gym wrappers (multigrid/wrappers.py): each wrapper
delegates ``reset``/``step`` to the wrapped environment and maps the
observations through a transformation of ``(obs, state)`` in plain PyTorch
on the state's device. Every observation tensor carries the leading env
axis ``(E, N, ...)``. A :class:`~multigrid_tpu_torch.parallel.VectorEnv`
over a wrapped env makes the raw observations once, through the kernel,
then applies the wrapper chain (``transform_obs``).
"""

from __future__ import annotations

import torch

from .core.config import EnvConfig
from .core.constants import Color, State, Type
from .core.state import MultiGridState
from .envs.env import MultiGridEnv
from .ops.obs import overlay_agents

#: One-hot channel widths: type, color, max(state, direction)
#: (multigrid/wrappers.py:139-147) → 11 + 6 + 4 = 21 channels.
ONE_HOT_DIMS = (len(Type), len(Color), max(len(State), 4))


class ObservationWrapper:
    """Base wrapper: delegates everything, transforms observations
    (wrappers.py:26-105); the transformation is a function of ``(obs,
    state)`` so that batched execution can apply it after the kernel."""

    def __init__(self, env: MultiGridEnv):
        self.env = env

    # -- delegation ---------------------------------------------------------

    @property
    def cfg(self) -> EnvConfig:
        return self.env.cfg

    @property
    def num_agents(self) -> int:
        return self.env.num_agents

    @property
    def width(self) -> int:
        return self.env.width

    @property
    def height(self) -> int:
        return self.env.height

    def __getattr__(self, name):
        return getattr(self.env, name)

    # -- batched API ---------------------------------------------------------

    def observation(self, obs, state: MultiGridState):
        raise NotImplementedError

    def transform_obs(self, obs, state: MultiGridState):
        """Composed wrapper chain (inner transforms first): the hook that
        batched execution applies to the raw observations."""
        return self.observation(self.env.transform_obs(obs, state), state)

    def observation_space(self, agent_space):
        """Per-agent observation space for this wrapper alone (identity by
        default; the reference wrappers rewrite it in ``__init__``,
        multigrid/wrappers.py:41-58, 139-147)."""
        return agent_space

    def transform_space(self, agent_space):
        """Composed per-agent space transform (inner wrappers first), which
        the Gym/RLlib/PettingZoo adapters report."""
        return self.observation_space(self.env.transform_space(agent_space))

    def reset(self, keys):
        obs, state = self.env.reset(keys)
        return self.observation(obs, state), state

    def step(self, state: MultiGridState, actions, action_mask: torch.Tensor | None = None):
        obs, state, rew, term, trunc = self.env.step(state, actions, action_mask)
        return self.observation(obs, state), state, rew, term, trunc


    def step_with_order(self, state, actions, order, action_mask=None):
        obs, state, rew, term, trunc = self.env.step_with_order(
            state, actions, order, action_mask)
        return self.observation(obs, state), state, rew, term, trunc

    def observe(self, state: MultiGridState):
        return self.observation(self.env.observe(state), state)


def fully_obs_image(state: MultiGridState) -> torch.Tensor:
    """(E, W, H, 3) full-grid encoding with live agents overlaid
    (wrappers.py:41-55): agents drawn in index order, so the later agent
    wins a shared cell, terminated agents skipped."""
    return overlay_agents(state)


class FullyObsWrapper(ObservationWrapper):
    """Fully observable global image for every agent (wrappers.py:17-58):
    each agent's ``image`` is the ``(W, H, 3)`` grid encoding with all live
    agents overlaid, the same for every agent (a broadcast view)."""

    def observation(self, obs, state):
        img = fully_obs_image(state)
        image = img[:, None].expand(-1, self.num_agents, -1, -1, -1)
        return {**obs, 'image': image}

    def observation_space(self, agent_space):
        import numpy as np
        from gymnasium import spaces
        d = dict(agent_space.spaces)
        # The reference declares (height, width, 3) (wrappers.py:43-44) and
        # uint8; the arrays are grid-shaped (width, height, 3) int32, as the
        # JAX package declares them.
        d['image'] = spaces.Box(
            0, 255, (self.env.width, self.env.height, 3), dtype=np.int32)
        return spaces.Dict(d)


class ImgObsWrapper(ObservationWrapper):
    """Image-only observations as uint8 (wrappers.py:61-98)."""

    def observation(self, obs, state):
        return obs['image'].to(torch.uint8)

    def observation_space(self, agent_space):
        import numpy as np
        from gymnasium import spaces
        img = agent_space['image']
        # The reference keeps the image Box and forces uint8 (wrappers.py:86-89).
        return spaces.Box(img.low.min(), img.high.max(), img.shape, dtype=np.uint8)


def one_hot(image: torch.Tensor, dtype=torch.uint8) -> torch.Tensor:
    """(..., 3) int encodings → (..., 21) one-hot planes (wrappers.py:158-190).

    Each plane compares with an ``arange``, so an index outside a plane's
    width gives a zero row, as ``jax.nn.one_hot`` gives it (where
    ``torch.nn.functional.one_hot`` raises)."""
    planes = [
        (image[..., i, None] == torch.arange(n, device=image.device)).to(dtype)
        for i, n in enumerate(ONE_HOT_DIMS)
    ]
    return torch.cat(planes, dim=-1)


class OneHotObsWrapper(ObservationWrapper):
    """One-hot encode the image channels (wrappers.py:101-190):
    ``(vs, vs, 3)`` int → ``(vs, vs, 21)`` uint8, dims
    ``[len(Type)=11, len(Color)=6, max(len(State), len(Direction))=4]``."""

    def observation(self, obs, state):
        return {**obs, 'image': one_hot(obs['image'])}

    def observation_space(self, agent_space):
        import numpy as np
        from gymnasium import spaces
        d = dict(agent_space.spaces)
        vh, vw, _ = d['image'].shape
        # (wrappers.py:142-147): Box(0, 1, (vh, vw, 21), uint8).
        d['image'] = spaces.Box(0, 1, (vh, vw, sum(ONE_HOT_DIMS)), dtype=np.uint8)
        return spaces.Dict(d)


def _squeeze_agents(x):
    return x.squeeze(1)


class SingleAgentWrapper(ObservationWrapper):
    """Strip the agent axis from a single-agent environment
    (wrappers.py:193-233): obs ``(E, ...)``, rewards and terminations
    ``(E,)``. The agent axis is dim 1, behind the env axis."""

    def __init__(self, env: MultiGridEnv):
        assert env.num_agents == 1, 'SingleAgentWrapper requires 1 agent'
        super().__init__(env)

    def observation(self, obs, state):
        if isinstance(obs, dict):
            return {k: _squeeze_agents(v) for k, v in obs.items()}
        return _squeeze_agents(obs)

    def step(self, state, actions):
        actions = torch.as_tensor(actions, dtype=torch.int32, device=state.device)
        obs, state, rew, term, trunc = self.env.step(state, actions.reshape(state.num_envs, 1))
        return (self.observation(obs, state), state, _squeeze_agents(rew),
                _squeeze_agents(term), _squeeze_agents(trunc))
