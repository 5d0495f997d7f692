"""Policy/value networks for gridworld observations.

Counterpart of ``multigrid_tpu.learn.nets``: the ``ActorCritic`` with the
mlp or the cnn encoder, and the MAPPO ``CentralizedCritic``. The modules
keep flax's numerics and parameter names, so that the JAX package's
weights carry across (:func:`params_from_flax`, :func:`params_to_flax`):

- parameters are float32 and stored as flax stores them: ``img_kernel``
  (C·21, H) over the flattened one-hot features (feature ``cell·21 + ch``)
  and ``Dense_i.kernel`` (in, out), ``Dense_i.bias`` (out,); only the cnn's
  ``Conv_i.kernel`` is kept in torch's (out, in, 3, 3) layout, flax's
  (3, 3, in, out) permuted on the way in and out;
- the trunk and heads compute in the module's ``dtype`` from those
  parameters (flax's ``dtype``, bfloat16 by default; float32 nets exist for
  tests); the heads' small outputs are promoted to float32;
- the direction enters as ``cos``/``sin`` of a bfloat16 ``theta``
  (nets.py:106-107), with the mission's one-hot concatenated after it where
  the net has ``num_missions`` (nets.py:108-112), through ``Dense_0``,
  added to the first layer's output (W·[x; d] == W_x·x + W_d·d): with a
  bias over the mlp's hidden units, without one over the cnn's first 16
  channels, broadcast over the image (nets.py:120-124).

On packed observations the mlp's first layer is ``one_hot(packed) @ W``
through :func:`~multigrid_tpu_torch.ops.fused_linear.onehot_linear`: on the
card a CUDA kernel (with a kernel for its weight gradient) whatever the
net's ``dtype``, as the JAX package's fused path takes its kernel; on the
CPU the kernel's plain version for a bf16 net, and for a float32 net (which
exists for the tests) the one-hot product in float32, as flax computes it
outside the kernel. The cnn runs its three VALID 3x3 convolutions through
``torch.nn.functional.conv2d`` (the JAX package computes them in XLA, not
in a Pallas kernel).

Per-agent policies stack every parameter on a leading agent axis; the JAX
package applies the net to them with ``jax.vmap``. For the mlp,
:func:`apply_per_agent` is that batched forward: the first layer of all
agents in one launch of the first-layer kernel's agent axis, ``Dense_0…3``
batched products over the stacked weights.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_linear import NCH, OBS_CHANNELS, one_hot_image, onehot_linear

#: The compute type of the trunk and heads (flax's ``dtype``).
DTYPE = torch.bfloat16

__all__ = ['CNN_MIN_VIEW', 'OBS_CHANNELS', 'ActorCritic', 'CentralizedCritic',
           'apply_per_agent', 'direction_features', 'dir_mission_features',
           'make_centralized_critic', 'one_hot_image', 'params_from_flax', 'params_to_flax']


def direction_features(direction: torch.Tensor, dtype=DTYPE) -> torch.Tensor:
    """(…) directions → (…, 2) ``[cos θ, sin θ]`` in ``dtype``, θ = dir·π/2
    rounded to ``dtype`` as flax computes it (``cos(bf16(π/2))`` is not 0)."""
    # bf16 × f32(π/2), rounded to bf16, equals flax's bf16 × bf16(π/2) for
    # the four directions (tests/test_torch_nets.py pins them); a Python
    # scalar makes no host-to-device copy.
    theta = direction.to(dtype) * (math.pi / 2)
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def dir_mission_features(direction: torch.Tensor, mission: torch.Tensor | None,
                         num_missions: int, dtype=DTYPE) -> torch.Tensor:
    """(…, 2 + M) direction features followed by the mission's one-hot
    (exact 0/1) where ``num_missions`` M is not 0 and a mission is given,
    else the (…, 2) direction features (nets.py:106-112)."""
    dirf = direction_features(direction, dtype)
    if num_missions and mission is not None:
        one_hot = torch.nn.functional.one_hot(mission.long(), num_missions).to(dtype)
        dirf = torch.cat([dirf, one_hot], dim=-1)
    return dirf


def lecun_normal_(t: torch.Tensor, generator: torch.Generator,
                  fan_in: int | None = None) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, variance 1/fan_in
    (by default the first dimension, the ``in`` of an (in, out) kernel)."""
    std = math.sqrt(1.0 / (fan_in or t.shape[0])) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: float32 ``kernel`` (in, out) and ``bias`` (none
    with ``use_bias=False``), cast to ``dtype`` for the product and the add."""

    def __init__(self, fan_in: int, features: int, generator: torch.Generator,
                 dtype=DTYPE, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(fan_in, features), generator))
        self.register_parameter('bias', nn.Parameter(torch.zeros(features)) if use_bias
                                else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3), padding='VALID')`` on NCHW data: a
    float32 ``kernel`` (features, in, 3, 3) and ``bias``, cast to ``dtype``;
    the bias is added to the rounded product, as flax adds it."""

    def __init__(self, in_channels: int, features: int, generator: torch.Generator,
                 dtype=DTYPE):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(features, in_channels, 3, 3), generator, 9 * in_channels))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.kernel.to(self.dtype))
        return y + self.bias.to(self.dtype)[:, None, None]


#: The smallest view the cnn takes: three VALID 3x3 convolutions leave
#: (vs - 6)² positions.
CNN_MIN_VIEW = 7


class ActorCritic(nn.Module):
    """Encoder + categorical actor + value critic.

    ``encoder='cnn'`` (the default, as in the JAX package) is the reference
    example's 3×Conv+ReLU network over the one-hot planes (16, 32 and 64
    channels, VALID), the direction and mission features added to the first
    convolution's channels, then ``Dense_1`` (hidden) over the flattened (h,
    w, c) map (nets.py:120-133); it needs views of at least 7.
    ``encoder='mlp'`` is the one-hot features through one wide dense layer
    (``img_kernel``).

    ``image`` is (..., C) packed cells with ``packed_obs=True``, else (...,
    vs, vs, 3) triples (C = vs·vs); ``direction`` is (...), and ``mission``
    (...) the episode's mission index, which a net with ``num_missions``
    (the size of the env's mission space; 0 turns conditioning off) takes.
    Returns float32 ``(logits (..., num_actions), value (...))``. Parameters
    are made on the CPU from ``seed`` (the same weights on any device); move
    the module with ``.to(device)``. ``dtype`` is the compute type (flax's
    ``dtype``).
    """

    def __init__(self, num_cells: int, *, num_actions: int = 7, hidden: int = 128,
                 packed_obs: bool = False, seed: int = 0, dtype=DTYPE,
                 num_missions: int = 0, encoder: str = 'cnn'):
        super().__init__()
        if encoder not in ('mlp', 'cnn'):
            raise ValueError(f"encoder must be 'mlp' or 'cnn', not {encoder!r}")
        self.num_cells = num_cells
        self.num_actions = num_actions
        self.hidden = hidden
        self.packed_obs = packed_obs
        self.dtype = dtype
        self.num_missions = num_missions
        self.encoder = encoder
        self.view_size = math.isqrt(num_cells)
        g = torch.Generator().manual_seed(seed)
        features = 2 + num_missions
        if encoder == 'mlp':
            self.img_kernel = nn.Parameter(
                lecun_normal_(torch.empty(num_cells * NCH, hidden), g))
            self.Dense_0 = Dense(features, hidden, g, dtype)
            self.Dense_1 = Dense(hidden, hidden, g, dtype)
        else:
            vs = self.view_size
            if vs * vs != num_cells or vs < CNN_MIN_VIEW:
                # The JAX package's flax init fails on such views with a
                # ZeroDivisionError (a kernel of no input features).
                raise ZeroDivisionError(
                    f'the cnn encoder needs a square view of at least {CNN_MIN_VIEW}, '
                    f'not {num_cells} cells: three VALID 3x3 convolutions leave nothing')
            self.Conv_0 = Conv(NCH, 16, g, dtype)
            self.Dense_0 = Dense(features, 16, g, dtype, use_bias=False)
            self.Conv_1 = Conv(16, 32, g, dtype)
            self.Conv_2 = Conv(32, 64, g, dtype)
            self.Dense_1 = Dense((vs - 6) ** 2 * 64, hidden, g, dtype)
        self.Dense_2 = Dense(hidden, num_actions, g, dtype)
        self.Dense_3 = Dense(hidden, 1, g, dtype)

    def forward(self, image: torch.Tensor, direction: torch.Tensor,
                mission: torch.Tensor | None = None):
        lead = image.shape[:-1] if self.packed_obs else image.shape[:-3]
        d = dir_mission_features(direction, mission, self.num_missions, self.dtype)
        if self.encoder == 'mlp':
            h = _first_layer(image, self.img_kernel, self.num_cells, lead, self.packed_obs,
                             self.dtype)
            x = torch.relu(h + self.Dense_0(d))
        else:
            x = self._cnn(image, d, lead)
        x = torch.relu(self.Dense_1(x))
        logits = self.Dense_2(x).float()
        value = self.Dense_3(x).float()
        return logits, value.squeeze(-1)

    def _cnn(self, image, d, lead):
        """The cnn's features (*lead, (vs-6)²·64) in flax's (h, w, c) order."""
        vs = self.view_size
        if self.packed_obs:
            image = image.reshape(lead + (vs, vs))
        x = one_hot_image(image, self.dtype, packed=self.packed_obs)
        x = x.reshape((-1, vs, vs, NCH)).permute(0, 3, 1, 2)  # NHWC → NCHW
        x = torch.relu(self.Conv_0(x) + self.Dense_0(d).reshape(-1, 16, 1, 1))
        x = torch.relu(self.Conv_1(x))
        x = torch.relu(self.Conv_2(x))
        return x.permute(0, 2, 3, 1).reshape(lead + (-1,))


def _first_layer(image, w, cells, lead, packed, dtype):
    """``one_hot(image) @ w`` over ``cells`` cells → (*lead, H) in ``dtype``:
    the first-layer kernel for packed cells on the card or a bf16 net, else
    the one-hot product in ``dtype``."""
    if packed and (image.is_cuda or dtype == torch.bfloat16):
        h = onehot_linear(image.reshape(-1, cells), w).reshape(lead + (w.shape[1],))
        return h.to(dtype)
    x = one_hot_image(image, dtype, packed=packed).reshape(lead + (cells * NCH,))
    return x @ w.to(dtype)


def apply_per_agent(net: ActorCritic, params: dict[str, torch.Tensor], image: torch.Tensor,
                    direction: torch.Tensor, mission: torch.Tensor | None = None):
    """The mlp ``net`` with per-agent parameters (every leaf stacked (N,
    ...)), agent ``i``'s slice on agent ``i``'s observations, all agents at
    once: the counterpart of the JAX package's ``jax.vmap(net.apply)`` over
    the agent axis (multigrid_tpu/learn/ppo.py:269-285).

    ``image`` (..., N, C) packed cells or (..., N, vs, vs, 3) triples,
    ``direction`` and ``mission`` (..., N). The first layer is one call of
    :func:`~multigrid_tpu_torch.ops.fused_linear.onehot_linear` on (N, B,
    C) cells (one launch on the card) where :func:`_first_layer` would take
    the kernel, else the one-hot product; ``Dense_0…3`` are batched products
    over the stacked weights, in the net's ``dtype`` as ``Dense`` computes
    them. Returns float32 ``(logits (..., N, A), value (..., N))``.
    """
    if net.encoder != 'mlp':
        raise ValueError(f'apply_per_agent batches the mlp, not the {net.encoder}')
    n, lead, dt = direction.shape[-1], direction.shape[:-1], net.dtype
    axis = image.dim() - (2 if net.packed_obs else 4)
    # Agent axis first, copied once, each agent's rows contiguous.
    x = image.movedim(axis, 0).contiguous()
    x = x.reshape((n, -1) + x.shape[len(lead) + 1:])
    d = dir_mission_features(direction, mission, net.num_missions, dt)
    d = d.movedim(-2, 0).reshape(n, -1, d.shape[-1])
    w = params['img_kernel']
    if net.packed_obs and (x.is_cuda or dt == torch.bfloat16):
        h = onehot_linear(x, w).to(dt)
    else:
        h = torch.bmm(one_hot_image(x, dt, packed=net.packed_obs).reshape(n, x.shape[1], -1),
                      w.to(dt))

    def dense(x, name):
        y = torch.bmm(x.to(dt), params[f'{name}.kernel'].to(dt))
        return y + params[f'{name}.bias'].to(dt)[:, None]

    x = torch.relu(h + dense(d, 'Dense_0'))
    x = torch.relu(dense(x, 'Dense_1'))
    logits = dense(x, 'Dense_2').float().reshape((n,) + lead + (-1,))
    value = dense(x, 'Dense_3').float().reshape((n,) + lead)
    return logits.movedim(0, -2), value.movedim(0, -1)


class CentralizedCritic(nn.Module):
    """Joint-observation value function for MAPPO-style training:
    V(o_1..o_N) from every agent's observation and direction (the actors
    stay partial). Counterpart of flax ``CentralizedCritic`` (nets.py:172),
    with its parameter names: ``Dense_0`` (N·C·21, H) with a bias over the
    joint one-hot, ``Dense_1`` (2N + M, H) without one over the direction
    features and the mission's one-hot (M = ``num_missions``), ``Dense_2``
    the trunk, ``Dense_3`` the value.

    ``images`` (..., N, C) packed or (..., N, vs, vs, 3) triples,
    ``directions`` (..., N), ``missions`` (..., N) (agent 0's is used: an
    episode has one); returns the float32 value (...). The first
    layer takes the one-hot over all N·C cells as one row of cells, so a
    bf16 critic on packed cells runs the first-layer kernel (and its weight
    gradient) on (..., N·C).
    """

    def __init__(self, num_cells: int, num_agents: int, *, hidden: int = 128,
                 packed_obs: bool = False, seed: int = 0, dtype=DTYPE,
                 num_missions: int = 0):
        super().__init__()
        self.num_cells, self.num_agents = num_cells, num_agents
        self.hidden, self.packed_obs, self.dtype = hidden, packed_obs, dtype
        self.num_missions = num_missions
        g = torch.Generator().manual_seed(seed)
        self.Dense_0 = Dense(num_agents * num_cells * NCH, hidden, g, dtype)
        self.Dense_1 = Dense(2 * num_agents + num_missions, hidden, g, dtype,
                             use_bias=False)
        self.Dense_2 = Dense(hidden, hidden, g, dtype)
        self.Dense_3 = Dense(hidden, 1, g, dtype)

    def forward(self, images: torch.Tensor, directions: torch.Tensor,
                missions: torch.Tensor | None = None) -> torch.Tensor:
        n = self.num_agents
        lead = directions.shape[:-1]
        h = _first_layer(images, self.Dense_0.kernel, n * self.num_cells, lead,
                         self.packed_obs, self.dtype) + self.Dense_0.bias.to(self.dtype)
        d = direction_features(directions, self.dtype).reshape(lead + (2 * n,))
        if self.num_missions and missions is not None:
            d = torch.cat([d, torch.nn.functional.one_hot(
                missions[..., 0].long(), self.num_missions).to(self.dtype)], dim=-1)
        x = torch.relu(h + self.Dense_1(d))
        x = torch.relu(self.Dense_2(x))
        return self.Dense_3(x).float().squeeze(-1)


def make_centralized_critic(net: ActorCritic, num_agents: int, seed: int = 0):
    """The joint-observation critic matched to an actor net's attributes."""
    return CentralizedCritic(net.num_cells, num_agents, hidden=net.hidden,
                             packed_obs=net.packed_obs, seed=seed, dtype=net.dtype,
                             num_missions=net.num_missions)


#: flax's parameter names of the mlp ``ActorCritic``, as state-dict keys.
PARAM_NAMES = ('img_kernel',) + tuple(
    f'Dense_{i}.{leaf}' for i in range(4) for leaf in ('kernel', 'bias'))

#: Key prefixes of the two groups of an actor/critic parameter dict.
ACTOR, CRITIC = 'actor.', 'critic.'


def params_from_flax(tree, device=None) -> dict[str, torch.Tensor]:
    """flax params → a state dict of float32 tensors keyed by the flax path
    joined with dots (``img_kernel``, ``Dense_i.kernel``, ``Dense_i.bias``).

    Takes the tree of an ``ActorCritic`` or a ``CentralizedCritic``
    (``{'params': {...}}`` or the inner dict, leaves as arrays), a stacked
    tree of per-agent policies (the leading agent axis stays), or
    ``{'actor': ..., 'critic': ...}`` (keys prefixed ``actor.`` and
    ``critic.``). Conv kernels go from flax's (3, 3, in, out) to torch's
    (out, in, 3, 3)."""
    if 'actor' in tree:
        return {prefix + k: v for prefix, part in ((ACTOR, 'actor'), (CRITIC, 'critic'))
                for k, v in params_from_flax(tree[part], device).items()}
    out = {}

    def walk(node, path):
        for key, leaf in node.items():
            if isinstance(leaf, Mapping):
                walk(leaf, path + key + '.')
            else:
                a = np.asarray(leaf)
                if _is_conv_kernel(path + key):
                    nd = a.ndim
                    a = a.transpose(*range(nd - 4), nd - 1, nd - 2, nd - 4, nd - 3)
                out[path + key] = torch.tensor(a, dtype=torch.float32, device=device)

    walk(tree.get('params', tree), '')
    return out


def params_to_flax(params: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_flax`: ``{'params': {...}}`` of numpy,
    or ``{'actor': {'params': ...}, 'critic': {'params': ...}}``."""
    if any(k.startswith(ACTOR) for k in params):
        return {part: params_to_flax({k[len(prefix):]: v for k, v in params.items()
                                      if k.startswith(prefix)})
                for prefix, part in ((ACTOR, 'actor'), (CRITIC, 'critic'))}
    tree: dict = {}
    for name, value in params.items():
        *path, leaf = name.split('.')
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        a = value.detach().cpu().numpy()
        if _is_conv_kernel(name):
            nd = a.ndim
            a = a.transpose(*range(nd - 4), nd - 2, nd - 1, nd - 3, nd - 4)
        node[leaf] = a
    return {'params': tree}


def _is_conv_kernel(name: str) -> bool:
    """Whether a parameter name is a cnn kernel (``Conv_i.kernel``)."""
    *path, leaf = name.split('.')
    return leaf == 'kernel' and bool(path) and path[-1].startswith('Conv_')
