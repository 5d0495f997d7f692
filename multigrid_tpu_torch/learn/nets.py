"""Policy/value network for gridworld observations (the mlp encoder).

Counterpart of ``multigrid_tpu.learn.nets`` for ``encoder='mlp'``. The
module keeps flax's layout and numerics so that the JAX package's weights
carry across (:func:`params_from_flax`, :func:`params_to_flax`):

- parameters are float32 and stored as flax stores them: ``img_kernel``
  (C·21, H) over the flattened one-hot features (feature ``cell·21 + ch``)
  and ``Dense_i.kernel`` (in, out), ``Dense_i.bias`` (out,);
- the trunk and heads compute in bfloat16 from those parameters (flax's
  ``dtype=bfloat16``); the heads' small outputs are promoted to float32;
- the direction enters as ``cos``/``sin`` of a bfloat16 ``theta``
  (nets.py:106-107) through ``Dense_0`` with a bias, added to the first
  layer's output (W·[x; d] == W_x·x + W_d·d).

On packed observations the first layer is ``one_hot(packed) @ img_kernel``
through :func:`~multigrid_tpu_torch.ops.fused_linear.onehot_linear`: a CUDA
kernel on the card (with a kernel for its weight gradient), the plain
one-hot product on the CPU.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.fused_linear import NCH, OBS_CHANNELS, one_hot_image, onehot_linear

#: The compute type of the trunk and heads (flax's ``dtype``).
DTYPE = torch.bfloat16

__all__ = ['OBS_CHANNELS', 'ActorCritic', 'direction_features', 'one_hot_image',
           'params_from_flax', 'params_to_flax']


def direction_features(direction: torch.Tensor) -> torch.Tensor:
    """(…) directions → (…, 2) ``[cos θ, sin θ]`` in bfloat16, θ = dir·π/2
    rounded to bfloat16 as flax computes it (``cos(bf16(π/2))`` is not 0)."""
    # bf16 × f32(π/2), rounded to bf16, equals flax's bf16 × bf16(π/2) for
    # the four directions (tests/test_torch_nets.py pins them); a Python
    # scalar makes no host-to-device copy.
    theta = direction.to(DTYPE) * (math.pi / 2)
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, variance 1/fan_in."""
    std = math.sqrt(1.0 / t.shape[0]) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense`` with ``dtype=bfloat16``: float32 ``kernel`` (in,
    out) and ``bias``, cast to bfloat16 for the product and the add."""

    def __init__(self, fan_in: int, features: int, generator: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(fan_in, features), generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(DTYPE) @ self.kernel.to(DTYPE) + self.bias.to(DTYPE)


class ActorCritic(nn.Module):
    """mlp encoder + categorical actor + value critic.

    ``image`` is (..., C) packed cells with ``packed_obs=True``, else (...,
    vs, vs, 3) triples (C = vs·vs); ``direction`` is (...). Returns float32
    ``(logits (..., num_actions), value (...))``. Parameters are made on the
    CPU from ``seed`` (the same weights on any device); move the module with
    ``.to(device)``.
    """

    def __init__(self, num_cells: int, *, num_actions: int = 7, hidden: int = 128,
                 packed_obs: bool = False, seed: int = 0):
        super().__init__()
        self.num_cells = num_cells
        self.num_actions = num_actions
        self.hidden = hidden
        self.packed_obs = packed_obs
        g = torch.Generator().manual_seed(seed)
        self.img_kernel = nn.Parameter(
            lecun_normal_(torch.empty(num_cells * NCH, hidden), g))
        self.Dense_0 = Dense(2, hidden, g)
        self.Dense_1 = Dense(hidden, hidden, g)
        self.Dense_2 = Dense(hidden, num_actions, g)
        self.Dense_3 = Dense(hidden, 1, g)

    def forward(self, image: torch.Tensor, direction: torch.Tensor):
        c = self.num_cells
        if self.packed_obs:
            lead = image.shape[:-1]
            h = onehot_linear(image.reshape(-1, c), self.img_kernel)
            h = h.reshape(lead + (self.hidden,))
        else:
            lead = image.shape[:-3]
            x = one_hot_image(image).reshape(lead + (c * NCH,))
            h = x @ self.img_kernel.to(DTYPE)
        x = torch.relu(h + self.Dense_0(direction_features(direction)))
        x = torch.relu(self.Dense_1(x))
        logits = self.Dense_2(x).float()
        value = self.Dense_3(x).float()
        return logits, value.squeeze(-1)


#: flax's parameter names of the mlp ``ActorCritic``, as state-dict keys.
PARAM_NAMES = ('img_kernel',) + tuple(
    f'Dense_{i}.{leaf}' for i in range(4) for leaf in ('kernel', 'bias'))


def params_from_flax(tree, device=None) -> dict[str, torch.Tensor]:
    """flax params of the mlp ``ActorCritic`` (``{'params': {...}}`` or the
    inner dict, leaves as numpy arrays) → a state dict of float32 tensors,
    keyed ``img_kernel`` and ``Dense_i.kernel``/``Dense_i.bias``."""
    tree = tree.get('params', tree)
    out = {}
    for name in PARAM_NAMES:
        leaf = tree
        for part in name.split('.'):
            leaf = leaf[part]
        out[name] = torch.tensor(leaf, dtype=torch.float32, device=device)
    return out


def params_to_flax(params: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_flax`: ``{'params': {...}}`` of numpy."""
    tree: dict = {}
    for name in PARAM_NAMES:
        *path, leaf = name.split('.')
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = params[name].detach().cpu().numpy()
    return {'params': tree}
