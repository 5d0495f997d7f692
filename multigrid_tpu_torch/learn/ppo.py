"""PPO: rollout, GAE and clipped-surrogate updates.

Counterpart of ``multigrid_tpu.learn.ppo`` for the ``ActorCritic`` with the
mlp or the cnn encoder: one policy shared by all agents, or per-agent policies
(``PPOConfig.per_agent_policies``, the reference's ``policy_{i}``: every
parameter has a leading agent axis), each with an optional MAPPO
centralized critic (``PPOConfig.centralized_critic``). An update
(:class:`TrainStep`) runs ``rollout_steps`` lockstep steps of the vector env
with actions sampled from the policy, computes GAE, and takes ``epochs`` ×
``minibatches`` SGD steps. On the card the rollout's first layer is the
``onehot_linear`` kernel (per-agent mlp policies: one launch over all
agents, :func:`~multigrid_tpu_torch.learn.nets.apply_per_agent`), or, with
``MULTIGRID_FUSED_POLICY`` set for a shared policy without the critic, the
whole policy step is the fused-policy kernel; a cnn actor runs through
autograd and ``conv2d`` (the kernels are the mlp's; per-agent cnn actors
one ``conv2d`` a layer over all agents, of a block-diagonal kernel). Envs with missions
(BlockedUnlockPickup) give the nets the episode's mission, sized from the
env's mission space, as a one-hot after the direction features: the
kernels' direction-feature operand (F = 2 + missions). The learner is the fused
PPO-loss kernel (per-agent policies: one launch over all agents) where
:func:`~multigrid_tpu_torch.ops.fused_ppo.supports` holds and there is no
centralized critic and the actor is the mlp, else autograd of
:meth:`TrainStep.loss_fn` (whose mlp first layers' weight gradients are the
``onehot_linear`` gradient kernel). On the CPU the same code takes the
plain versions. Where the vector env has a reserve pool, the rollout steps
with ``refresh=False`` and refreshes the pool once at its end
(ppo.py:405, 439-442).

Parameters and optimizer state are plain dicts of tensors, updated
functionally: no tensor of a ``TrainState`` is written in place, so a caller
can keep one and run from it again. Randomness comes from threefry2x32 keys
(:mod:`~multigrid_tpu_torch.utils.prng`), as in the JAX package: the env
state's (agent orders, resets) and the train state's ``key`` (a step's
``key, k_act = split(key)`` for its actions, an update's ``key, k_perm =
split(key)`` for its minibatch shuffles, ppo.py:397-400, 667-675), bit-equal
to ``jax.random``'s draws from the same keys (Gumbel noise up to the ulp
of ``log``). Each such split and the draw from its second key are one draw
(``split_first``: one launch on the card).

On a vector env sharded over a process mesh (``VectorEnv(mesh=...)``) the
update is data-parallel with the semantics of the JAX package's sharded
``train_step``: every process holds the same parameters and key, draws
its rows of the noise of the global batch's shape, normalizes
advantages over the global batch, and averages its gradients with the other
processes' before the clip, so the update is the one-process update of the
global batch up to the order of float sums. Minibatches hold the global
envs one process would give them; the metrics are global. Under NCCL the
update with its collectives is one graph on every process, as the JAX
package jits its sharded update; under gloo it runs eagerly.

Under a mesh with a ``'model'`` axis each process holds only its column
slice of every 2-D ``Dense_0…kernel`` and of that kernel's Adam moments
(:func:`~multigrid_tpu_torch.parallel.mesh.shard_params`), as the JAX dry
run places them (``__graft_entry__.py:85-92``). An update gathers the full
kernels over the model group at its start and after every SGD step, so that
the rollout, the loss and its kernels (whose direction-feature operand is
that kernel, whole) see the one-process parameters; the clip norm comes
from the full gradient, which every process of a model group holds, and
Adam then updates this process's columns only. With one env shard the
update is the one-process update bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import warnings
from collections.abc import Callable
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from ..core.state import MultiGridState
from ..ops import fused_policy, fused_ppo
from ..parallel import distributed
from ..parallel.mesh import gather_params, shard_params
from ..parallel.vector import VectorEnv
from ..utils import graphs, prng, profiling
from .nets import (
    ACTOR,
    CRITIC,
    ActorCritic,
    apply_per_agent,
    dir_mission_features,
    make_centralized_critic,
)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    rollout_steps: int = 16
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    epochs: int = 1
    #: SGD minibatches per epoch: contiguous env blocks, with a fresh
    #: T-permutation and env-axis roll each epoch (ppo.py:58-63).
    minibatches: int = 1
    #: Independent parameters per agent (the reference's ``policy_{i}``): a
    #: leading agent axis on every parameter, gradients clipped per agent.
    per_agent_policies: bool = False
    #: MAPPO-style centralized critic: the value conditions on all agents'
    #: observations; the actors stay partial (ppo.py:66-71).
    centralized_critic: bool = False

    def replace(self, **changes) -> 'PPOConfig':
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class OptState:
    """Adam's state. The counts are 0-d int32 tensors on the parameters'
    device, as optax carries them, so that a captured update reads and
    advances them there."""
    count: torch.Tensor
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    #: The learning-rate schedule's own count (optax's
    #: ``ScaleByScheduleState``), None for a constant rate.
    schedule_count: torch.Tensor | None = None


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable:
    """``optax.linear_schedule``: ``count -> init + (end - init) ·
    min(count, N) / N``, computed in float32 as optax computes it
    (``(init - end) · (1 - count / N) + end``, the difference rounded once).
    An int count gives a float; a tensor count (the optimizer's, on the
    device) a 0-d float32 tensor beside it."""
    diff, end = np.float32(init_value - end_value), np.float32(end_value)
    n = np.float32(transition_steps)

    def schedule(count):
        if isinstance(count, torch.Tensor):
            if transition_steps <= 0:
                return torch.full((), float(np.float32(init_value)), device=count.device)
            frac = 1 - count.clamp(0, transition_steps).to(torch.float32) / float(n)
            return frac * float(diff) + float(end)
        if transition_steps <= 0:
            return float(np.float32(init_value))
        frac = np.float32(1) - np.float32(min(max(count, 0), transition_steps)) / n
        return float(diff * frac + end)

    return schedule


class Optimizer:
    """``optax.chain(clip, adam(lr))``, the clip as the JAX package builds it
    (ppo.py:192-221):

    - ``optax.clip_by_global_norm(max_grad_norm)``: scales by
      ``max_norm / norm`` only where ``norm >= max_norm``, with no epsilon
      (torch's ``clip_grad_norm_`` divides by ``norm + 1e-6``);
    - ``per_agent=True``, ``clip_by_global_norm_per_agent``: one norm per
      leading-axis (agent) slice, ``scale = min(1, max_norm / (norm +
      1e-16))`` (ppo.py:113-137);
    - ``critic=True`` (keys ``actor.*`` and ``critic.*``), optax's
      ``multi_transform``: the actor's group clipped as above, the critic's
      by its own global norm.

    Adam's ``eps`` is outside the square root of the bias-corrected second
    moment. ``lr`` is a rate or a schedule (:func:`linear_schedule`), which
    optax's ``adam(schedule)`` reads once per optimizer update, so once per
    SGD minibatch step, from a count of its own that starts at 0 (Adam's
    bias correction counts from 1). ``update`` returns the updates to add
    to the parameters.
    """

    def __init__(self, lr: float | Callable[[int], float], max_grad_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, *,
                 per_agent: bool = False, critic: bool = False):
        self.lr, self.max_grad_norm = lr, max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.per_agent, self.critic = per_agent, critic

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        device = next(iter(params.values())).device
        count = torch.zeros((), dtype=torch.int32, device=device)
        return OptState(count, {k: torch.zeros_like(v) for k, v in params.items()},
                        {k: torch.zeros_like(v) for k, v in params.items()},
                        count.clone() if callable(self.lr) else None)

    def _clip_group(self, grads: dict[str, torch.Tensor], per_agent: bool):
        if per_agent:
            sq = sum(torch.sum(g * g, dim=tuple(range(1, g.dim()))) for g in grads.values())
            scale = torch.clamp(self.max_grad_norm / (torch.sqrt(sq) + 1e-16), max=1.0)
            return {k: g * scale.reshape((-1,) + (1,) * (g.dim() - 1))
                    for k, g in grads.items()}
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.max_grad_norm
        return {k: torch.where(keep, g, g / norm * self.max_grad_norm)
                for k, g in grads.items()}

    def clip(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        if not self.critic:
            return self._clip_group(grads, self.per_agent)
        clipped = {}
        for prefix, per_agent in ((ACTOR, self.per_agent), (CRITIC, False)):
            clipped.update(self._clip_group(
                {k: g for k, g in grads.items() if k.startswith(prefix)}, per_agent))
        return {k: clipped[k] for k in grads}

    def update(self, grads: dict[str, torch.Tensor], state: OptState):
        return self.step(self.clip(grads), state)

    def step(self, grads: dict[str, torch.Tensor], state: OptState):
        """Adam on clipped gradients (of all the parameters, or of a
        process's part of them, moments alike): ``(updates, state)``."""
        count = state.count + 1
        mu = {k: (1 - self.b1) * g + self.b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - self.b2) * (g * g) + self.b2 * state.nu[k] for k, g in grads.items()}
        # The bias corrections in float32 on the device, as optax computes
        # them from its int32 count.
        c1 = 1 - torch.pow(self.b1, count)
        c2 = 1 - torch.pow(self.b2, count)
        sc = state.schedule_count
        lr = self.lr if sc is None else self.lr(sc)
        updates = {k: -lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps))
                   for k in grads}
        return updates, OptState(count, mu, nu, None if sc is None else sc + 1)


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: OptState
    env_state: MultiGridState
    last_obs: dict[str, torch.Tensor]
    #: (2,) int64 threefry2x32 key: draws the actions and the minibatch
    #: shuffles (the JAX ``TrainState.key``).
    key: torch.Tensor
    update_count: int = 0
    #: (E,) return of each env's running episode (all agents summed),
    #: carried across updates so ``episode_reward`` is exact.
    ep_return_acc: torch.Tensor | None = None

    def replace(self, **changes) -> 'TrainState':
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class Rollout:
    """(T, E, N, ...) trajectory slices; ``mission`` is None for envs
    without missions."""
    image: torch.Tensor
    direction: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    mission: torch.Tensor | None = None

    def map(self, fn) -> 'Rollout':
        return Rollout(*(None if (x := getattr(self, f.name)) is None else fn(x)
                         for f in dataclasses.fields(self)))


def _select_log_prob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``log_softmax(logits)[action]``."""
    log_probs = torch.log_softmax(logits, dim=-1)
    return log_probs.gather(-1, action.long()[..., None]).squeeze(-1)


def sample_actions(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Gumbel-max sampling, ``argmax(logits + gumbel)`` (first index on
    ties), as ``jax.random.categorical`` computes it from its own noise."""
    return (logits + gumbel).argmax(dim=-1).to(torch.int32)


def _seed_of(key: torch.Tensor) -> int:
    """A torch seed from a key's two words, for the nets' initialization,
    which stays torch's."""
    words = key.tolist()
    return (int(words[0]) << 32) | int(words[1])


def params_digest(params: dict[str, torch.Tensor]) -> int:
    """A 63-bit digest of the parameters' names, shapes, dtypes and bytes."""
    h = hashlib.sha256()
    for k in sorted(params):
        v = params[k].detach().cpu().contiguous()
        h.update(f'{k}{tuple(v.shape)}{v.dtype}'.encode())
        h.update(v.reshape(-1).view(torch.uint8).numpy().tobytes())
    return int.from_bytes(h.digest()[:8], 'little') >> 1


def check_replicated(params: dict[str, torch.Tensor], group) -> None:
    """Raise unless every process of ``group`` holds the same parameters
    (by :func:`params_digest`, one all-reduce)."""
    if group is None:
        return
    d = params_digest(params)
    if not distributed.agree(d, group, next(iter(params.values())).device):
        raise RuntimeError(f'parameters differ across processes (digest {d} on process '
                           f'{distributed.process_index()})')


def ppo_init(venv: VectorEnv, key=0, *, config: PPOConfig | None = None,
             hidden: int = 128, dtype=torch.bfloat16, net: ActorCritic | None = None,
             net_kwargs: dict | None = None,
             lr_schedule: Callable[[int], float] | None = None,
             per_agent_policies: bool | None = None):
    """``(train_state, net, config, optimizer)`` for training on ``venv``.

    ``key`` (a key or an int seed) splits as the JAX package's does:
    ``k_env, k_net, k_train = split(key, 3)`` (ppo.py:169), the env reset
    from ``k_env``, the train state's key ``k_train``; the net's weights are
    torch's initialization seeded from ``k_net`` (per-agent policies: from
    the keys of ``split(k_net, N)``; the critic from ``fold_in(k_net, 1)``),
    so they differ from flax's (``params_from_flax`` carries those across).
    ``net_kwargs`` (``hidden``,
    ``dtype``, ``encoder``: ``'cnn'``, the default, as in the JAX package,
    or ``'mlp'``) build the net, over ``hidden`` and ``dtype`` (the nets'
    compute type). The net conditions on the mission where the env has
    missions, with ``num_missions`` the size of the env's mission space
    (ppo.py:170-201).
    A ``net`` passed in is taken as it is (its weights start the training;
    its attributes are its own), with a warning where the env has missions
    and the net none. With the centralized critic (always the mlp) the
    parameters are keyed ``actor.*`` and ``critic.*``. ``lr_schedule``
    (:func:`linear_schedule`) replaces the constant ``config.lr``.
    ``per_agent_policies`` is the JAX package's deprecated alias for the
    config field.

    On a sharded vector env every process derives the same keys, so its
    parameters and keys start alike; a digest all-reduce checks the
    parameters. Under a ``'model'`` axis each process then keeps its
    columns of the ``Dense_0`` kernels, and its moments start as those.
    """
    config = config or PPOConfig()
    if per_agent_policies is not None:
        config = config.replace(per_agent_policies=per_agent_policies)
    k_env, k_net, k_train = prng.split(prng.as_key(key, venv.device), 3).unbind(0)
    net_seed = _seed_of(k_net)
    obs, env_state = venv.reset(k_env)
    num_missions = len(venv.env.mission_space) if 'mission' in obs else 0
    vs = venv.env.cfg.view_size
    if net is None:
        kw = {'hidden': hidden, 'dtype': dtype, **(net_kwargs or {}),
              'packed_obs': venv.packed_obs, 'num_missions': num_missions}
        net = ActorCritic(vs * vs, seed=net_seed, **kw).to(venv.device)
    else:
        if net_kwargs:
            raise ValueError('pass either net or net_kwargs, not both')
        if num_missions and net.num_missions == 0:
            warnings.warn(
                f'{type(venv.env).__name__} surfaces a mission index but the '
                'supplied net has num_missions=0: mission conditioning is OFF. '
                'Let ppo_init build the net to size it.', stacklevel=2)
        if net.packed_obs != venv.packed_obs:
            raise ValueError(f'net.packed_obs={net.packed_obs} does not match '
                             f'VectorEnv(packed_obs={venv.packed_obs})')
        kw = dict(hidden=net.hidden, packed_obs=net.packed_obs, dtype=net.dtype,
                  num_missions=net.num_missions, encoder=net.encoder)
    if config.per_agent_policies:
        seeds = [_seed_of(k) for k in prng.split(k_net, venv.num_agents)]
        nets = [ActorCritic(vs * vs, seed=s, **kw).state_dict() for s in seeds]
        params = {k: torch.stack([sd[k] for sd in nets]).to(venv.device) for k in nets[0]}
    else:
        params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    if config.centralized_critic:
        critic = make_centralized_critic(net, venv.num_agents,
                                         _seed_of(prng.fold_in(k_net, 1)))
        params = {**{ACTOR + k: v for k, v in params.items()},
                  **{CRITIC + k: v.detach().to(venv.device)
                     for k, v in critic.state_dict().items()}}
    tx = Optimizer(config.lr if lr_schedule is None else lr_schedule, config.max_grad_norm,
                   per_agent=config.per_agent_policies, critic=config.centralized_critic)
    if venv.mesh is not None:
        check_replicated(params, venv.mesh.mesh_group)
        params = shard_params(params, venv.mesh)
    state = TrainState(
        params=params, opt_state=tx.init(params), env_state=env_state,
        last_obs=obs, key=k_train.clone(),
        ep_return_acc=torch.zeros(venv.local_envs, device=venv.device))
    return state, net, config, tx


class TrainStep:
    """One PPO update, ``state -> (state, metrics)``, and its phases
    (``rollout_phase``, ``compute_gae``, ``sgd_step``), which the tests and
    ``chip_smoke.py`` call one by one.

    The learner's kernel gate is :func:`fused_ppo.supports`, and the fully
    fused rollout policy's is ``MULTIGRID_FUSED_POLICY`` (any non-empty
    value) with :func:`fused_policy.supports`; both are read when the step
    is built (as the JAX package reads them). Under a mesh they see this
    process's rows.
    """

    def __init__(self, venv: VectorEnv, net: ActorCritic, config: PPOConfig,
                 tx: Optimizer):
        self.venv, self.net, self.config, self.tx = venv, net, config, tx
        #: The update's captured graphs by signature.
        self._graphs: dict = {}
        #: The mesh's env-axis process group (None in one process), and
        #: whether this process holds only part of the env batch.
        self.group = None if venv.mesh is None else venv.mesh.group
        self.split = venv.local_envs != venv.num_envs
        self._loss_kernel_ok = fused_ppo.supports
        self.critic = (make_centralized_critic(net, venv.num_agents).to(venv.device)
                       if config.centralized_critic else None)
        #: Whether the rollout samples through the fused-policy kernel:
        #: opt-in, for a shared mlp policy without the centralized critic,
        #: whose value the kernel does not compute (ppo.py:342-349).
        self.fused_policy = bool(
            os.environ.get('MULTIGRID_FUSED_POLICY') and net.packed_obs
            and net.encoder == 'mlp'
            and not config.per_agent_policies and not config.centralized_critic
            and fused_policy.supports(venv.local_envs * venv.num_agents, net.hidden,
                                      net.num_actions))

    def actor_params(self, params):
        """The actor's parameters (without the ``actor.`` prefix)."""
        if self.critic is None:
            return params
        return {k[len(ACTOR):]: v for k, v in params.items() if k.startswith(ACTOR)}

    def actor(self, params, image, direction, mission=None):
        """The actor's ``(logits, value)`` for (..., N, ...) observations.
        Per-agent policies apply agent i's parameter slice to agent i's
        observations, all agents at once (:func:`apply_per_agent`, as the
        JAX package ``vmap``s it): the mlp's first layer in one launch, the
        cnn's convolutions each one over all agents."""
        ap = self.actor_params(params)
        if not self.config.per_agent_policies:
            return functional_call(self.net, ap, (image, direction, mission))
        return apply_per_agent(self.net, ap, image, direction, mission)

    def central_value(self, params, image, direction, mission=None):
        """The centralized critic's value of the joint observation,
        broadcast to every agent: (..., N)."""
        cp = {k[len(CRITIC):]: v for k, v in params.items() if k.startswith(CRITIC)}
        value = functional_call(self.critic, cp, (image, direction, mission))
        return value[..., None].expand(direction.shape)

    def policy(self, params, obs):
        """``(logits, value)`` for (E, N, ...) observations (a dict with
        ``image``, ``direction`` and, for envs with missions, ``mission``);
        the value is the centralized critic's where there is one."""
        args = (obs['image'], obs['direction'], obs.get('mission'))
        logits, value = self.actor(params, *args)
        if self.critic is not None:
            value = self.central_value(params, *args)
        return logits, value

    def dir_features(self, direction, mission):
        """The kernels' float32 direction features: ``[cos, sin]`` of the
        direction, then the mission's one-hot where the net has missions
        (ppo.py:351-372)."""
        return dir_mission_features(direction, mission, self.net.num_missions,
                                    self.net.dtype).float()

    def prepare_policy(self, params):
        """The fused-policy kernel's weight operands
        (:func:`fused_policy.prepare`), made once per rollout, where the
        rollout takes that kernel; else None."""
        return fused_policy.prepare(params) if self.fused_policy else None

    def policy_step(self, params, prepped, obs, key: torch.Tensor):
        """One rollout step from the rollout's ``key``: ``(action, log_prob,
        value, key')``, the first three (E, N). ``key', k_act = split(key)``
        and the noise ``gumbel(k_act, (E, N, A))`` of the global batch, this
        process's rows only, are one draw (ppo.py:364-381, 397-400). The
        fused-policy kernel samples on ``prepped`` (from
        :meth:`prepare_policy`) where it is not None, else :meth:`policy`
        and Gumbel-max sampling (``jax.random.categorical``), both from
        that noise."""
        lead, a = obs['direction'].shape, self.net.num_actions
        venv = self.venv
        key, gumbel = prng.gumbel(key, (venv.num_envs,) + lead[1:] + (a,), rows=venv.rows,
                                  split_first=True)
        if prepped is None:
            logits, value = self.policy(params, obs)
            action = sample_actions(logits, gumbel)
            return action, _select_log_prob(logits, action), value, key
        b = obs['direction'].numel()
        dirf = self.dir_features(obs['direction'], obs.get('mission'))
        out = fused_policy.policy_sample_prepared(
            prepped, obs['image'].reshape(b, -1), dirf.reshape(b, -1),
            gumbel.reshape(b, a), num_actions=a)
        return (*(x.reshape(lead) for x in out), key)

    @torch.no_grad()
    def rollout_phase(self, state: TrainState, params=None):
        """``rollout_steps`` env steps under the policy (``params``: the
        full parameters, by default gathered from the state's part). Returns
        ``(state, traj, last_value, (ep_sum, ep_cnt, ep_suc))``."""
        venv = self.venv
        params = gather_params(state.params, venv.mesh) if params is None else params
        env_state, obs, key = state.env_state, state.last_obs, state.key
        ep_acc = state.ep_return_acc
        ep_sum = torch.zeros((), device=venv.device)
        ep_cnt = torch.zeros((), dtype=torch.int64, device=venv.device)
        ep_suc = torch.zeros((), dtype=torch.int64, device=venv.device)
        steps = []
        prepped = self.prepare_policy(params)
        for _ in range(self.config.rollout_steps):
            action, log_prob, value, key = self.policy_step(params, prepped, obs, key)
            # With the pool, its refresh runs once a rollout (below).
            next_obs, env_state, reward, term, _, done, success = venv.step(
                env_state, action, refresh=not venv.reset_pool)
            ep_acc = ep_acc + reward.sum(-1)
            ep_sum = ep_sum + torch.where(done, ep_acc, 0.0).sum()
            ep_cnt = ep_cnt + done.sum()
            ep_suc = ep_suc + (done & success).sum()
            ep_acc = torch.where(done, 0.0, ep_acc)
            steps.append(Rollout(obs['image'], obs['direction'], action, log_prob,
                                 value, reward, done[:, None] | term, obs.get('mission')))
            obs = next_obs
        traj = Rollout(*(None if getattr(steps[0], f.name) is None
                         else torch.stack([getattr(s, f.name) for s in steps])
                         for f in dataclasses.fields(Rollout)))
        env_state = venv.refresh_pool(env_state, self.config.rollout_steps)
        last_value = self.policy(params, obs)[1]
        state = state.replace(env_state=env_state, last_obs=obs, key=key, ep_return_acc=ep_acc)
        return state, traj, last_value, (ep_sum, ep_cnt, ep_suc)

    @torch.no_grad()
    def compute_gae(self, traj: Rollout, last_value: torch.Tensor):
        """``(advantages, targets)``, each (T, E, N), by the reverse scan."""
        cfg = self.config
        f32 = torch.float32
        # γ and γ·λ rounded to float32 as the JAX package's traced scalars.
        gamma = float(np.float32(cfg.gamma))
        gl = float(np.float32(cfg.gamma) * np.float32(cfg.gae_lambda))
        gae = torch.zeros_like(last_value)
        next_value = last_value
        advantages = torch.empty_like(traj.value)
        for t in reversed(range(traj.value.shape[0])):
            not_done = 1.0 - traj.done[t].to(f32)
            delta = traj.reward[t] + gamma * next_value * not_done - traj.value[t]
            gae = delta + gl * not_done * gae
            advantages[t] = gae
            next_value = traj.value[t]
        return advantages, advantages + traj.value

    def moments(self, x: torch.Tensor, dims: tuple[int, ...] | None = None):
        """``(mean, std)`` of ``x`` over ``dims`` (kept; None: all) across
        the mesh's processes, the std without correction. With one env
        shard they are the local moments; else two all-reduces, of the sums
        and of the squared deviations' sums."""
        if not self.split:
            if dims is None:
                return x.mean(), x.std(correction=0)
            return x.mean(dims, keepdim=True), x.std(dims, correction=0, keepdim=True)
        kw = {} if dims is None else dict(dim=dims, keepdim=True)
        count = (x.numel() if dims is None else math.prod(x.shape[d] for d in dims)) \
            * self.venv.mesh.env_shards
        mu = distributed.all_reduce(x.sum(**kw), self.group) / count
        var = distributed.all_reduce(torch.square(x - mu).sum(**kw), self.group) / count
        return mu, torch.sqrt(var)

    def loss_fn(self, params, traj: Rollout, advantages, targets):
        """``(loss, metrics)`` of the clipped-PPO objective through the net."""
        cfg = self.config
        logits, value = self.policy(params, {'image': traj.image,
                                             'direction': traj.direction,
                                             'mission': traj.mission})
        log_probs = torch.log_softmax(logits, dim=-1)
        ratio = torch.exp(_select_log_prob(logits, traj.action) - traj.log_prob)
        if cfg.per_agent_policies:
            # Each agent's own statistics, over all axes but the agent axis
            # (ppo.py:499-511), so the policies do not couple through them.
            mu, sd = self.moments(advantages, tuple(range(advantages.dim() - 1)))
        else:
            mu, sd = self.moments(advantages)
        adv = (advantages - mu) / (sd + 1e-8)
        pg_loss = -torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).mean()
        vf_loss = 0.5 * torch.square(value - targets).mean()
        entropy = -(torch.exp(log_probs) * log_probs).sum(-1).mean()
        loss = pg_loss + cfg.vf_coef * vf_loss - cfg.ent_coef * entropy
        return loss, {'loss': loss, 'pg_loss': pg_loss, 'vf_loss': vf_loss,
                      'entropy': entropy}

    def kernel_inputs(self, traj: Rollout, advantages, targets) -> list[torch.Tensor]:
        """The fused PPO-loss kernel's per-sample arguments for a (T, E, N)
        trajectory: packed cells, direction features, actions, old
        log-probs, normalized advantages and targets. A shared policy's are
        flattened to B rows; per-agent policies' to (N, T·E) rows, each
        agent's contiguous, with advantages normalized per agent
        (ppo.py:540-565)."""
        dirf = self.dir_features(traj.direction, traj.mission)
        if not self.config.per_agent_policies:
            b = traj.direction.numel()

            def flat(x):
                return x.reshape((b,) + x.shape[3:]).contiguous()

            mu, sd = self.moments(advantages)
            adv = flat((advantages - mu) / (sd + 1e-8))
        else:
            n = traj.direction.shape[-1]
            b = traj.direction.numel() // n

            def flat(x):  # (T, E, N, ...) → (N, T·E, ...), one copy
                return x.movedim(2, 0).reshape((n, b) + x.shape[3:]).contiguous()

            adv = flat(advantages)
            mu, sd = self.moments(adv, (1,))
            adv = (adv - mu) / (sd + 1e-8)
        return [flat(traj.image), flat(dirf), flat(traj.action.to(torch.int32)),
                flat(traj.log_prob), adv, flat(targets)]

    def loss_grads(self, params, traj: Rollout, advantages, targets):
        """``(grads, metrics)``: the fused PPO-loss kernel where its gate
        holds, the actor is the mlp and there is no centralized critic (the
        kernel computes the actor's own value head), one launch over all
        agents with per-agent policies; else autograd of :meth:`loss_fn`
        (ppo.py:583-637)."""
        cfg, net = self.config, self.net
        b, n = traj.direction.numel(), traj.direction.shape[-1]
        kw = dict(clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef,
                  num_actions=net.num_actions)
        if net.packed_obs and net.encoder == 'mlp' and self.critic is None:
            if cfg.per_agent_policies and self._loss_kernel_ok(
                    b // n, net.hidden, net.num_actions):
                grads, metrics = fused_ppo.ppo_mlp_grads_agents(
                    params, *self.kernel_inputs(traj, advantages, targets), **kw)
                # Each agent's loss means over its T·E samples; autograd of
                # loss_fn means over all N·T·E (ppo.py:575-579).
                return ({k: g / n for k, g in grads.items()},
                        {k: m.mean() for k, m in metrics.items()})
            if not cfg.per_agent_policies and self._loss_kernel_ok(
                    b, net.hidden, net.num_actions):
                return fused_ppo.ppo_mlp_grads(
                    params, *self.kernel_inputs(traj, advantages, targets), **kw)
        names = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            loss, metrics = self.loss_fn(leaves, traj, advantages, targets)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        # With the centralized critic the actor's own value head is out of
        # the loss: its gradient is 0, and counts in the actor's clip norm.
        return ({k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(names, grads)},
                {k: v.detach() for k, v in metrics.items()})

    def mean_over_processes(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Each tensor's mean over the mesh's processes, in one all-reduce
        (every process holds as many samples, so the mean of their means is
        the global mean); ``tree`` itself in one process."""
        if self.group is None:
            return tree
        flat = torch.cat([v.reshape(-1).to(torch.float64) for v in tree.values()])
        flat = distributed.all_reduce(flat, self.group) / self.venv.mesh.env_shards
        out = dict(zip(tree, flat.split([v.numel() for v in tree.values()])))
        return {k: out[k].reshape(v.shape).to(v.dtype) for k, v in tree.items()}

    @torch.no_grad()
    def sgd_step(self, params, opt_state: OptState, traj: Rollout, advantages, targets):
        """One optimizer step on a (minibatch) trajectory from the full
        ``params``, its gradients averaged over the env axis's processes
        before the clip; under a ``'model'`` axis Adam updates this
        process's columns (``opt_state`` holds their moments) and the new
        columns are gathered. Returns ``(params, opt_state, metrics)``: the
        full parameters and this process's metrics."""
        mesh = self.venv.mesh
        grads, metrics = self.loss_grads(params, traj, advantages, targets)
        grads = shard_params(self.tx.clip(self.mean_over_processes(grads)), mesh)
        updates, opt_state = self.tx.step(grads, opt_state)
        own = shard_params(params, mesh)
        return (gather_params({k: own[k] + updates[k] for k in own}, mesh), opt_state,
                metrics)

    def __call__(self, state: TrainState, shuffle=None):
        """One update. ``shuffle`` fixes each epoch's minibatch shuffle as a
        list of ``(perm_t, off_e)`` (a T-permutation and an env-axis roll
        of the global batch); by default they are drawn from ``state.key``
        as the JAX package draws them. Under a mesh of several env shards, minibatches
        need the global batch: every process gathers it once an update and
        takes its share of each minibatch's envs.

        On the card (where :meth:`VectorEnv.graphed` holds: outside
        ``disable_graphs()``, without a mesh or under an NCCL one) the
        update is one CUDA graph, captured at the first call for the
        state's signature (a new config is a new
        ``TrainStep``, so a new capture, as ``jit`` recompiles), with the
        state copied in and cloned out. Under a mesh the graph holds the
        update's collectives: the column gathers, the advantage moments,
        the gradients' and metrics' means, the batch's gather and the
        episode sums."""
        state, rows = self.run(state, 1, shuffle)
        return state, rows[0]

    def run(self, state: TrainState, updates: int, shuffle=None):
        """``updates`` updates from ``state``: ``(state, [metrics of each
        update])``. On the card, replays of one carry graph, the train state
        staying in the graph's buffers from one update to the next."""
        with profiling.trace_annotation('mgt.update'):
            return self._run(state, updates, shuffle)

    def _run(self, state: TrainState, updates: int, shuffle=None):
        """:meth:`run`'s body."""
        if not self.venv.graphed():
            rows = []
            for _ in range(updates):
                state, metrics = self.update(state, shuffle)
                rows.append(metrics)
            return state, rows
        if shuffle is not None:
            shuffle = [(torch.as_tensor(p, device=self.venv.device),
                        torch.as_tensor(o, device=self.venv.device)) for p, o in shuffle]
        args = (self._carry(state), shuffle)
        key = ('update', graphs.signature(args), profiling.counting())
        if key not in self._graphs:
            buffers = graphs.clone(args)
            self._graphs[key] = graphs.Graph(
                self._update_carry, buffers, carry=True,
                group=self.venv.capture_group, key=key)
        graph = self._graphs[key]
        graphs.load(graph.inputs, args)
        rows = [graphs.clone(graph.replay()) for _ in range(updates)]
        params, opt_state, env_state, last_obs, ep_acc, key = graphs.clone(graph.inputs[0])
        return state.replace(params=params, opt_state=opt_state, env_state=env_state,
                             last_obs=last_obs, ep_return_acc=ep_acc, key=key,
                             update_count=state.update_count + updates), rows

    @staticmethod
    def _carry(state: TrainState):
        return (state.params, state.opt_state, state.env_state, state.last_obs,
                state.ep_return_acc, state.key)

    def _update_carry(self, args):
        """:meth:`update` on a carried tree: the captured function."""
        carry, shuffle = args
        params, opt_state, env_state, last_obs, ep_acc, key = carry
        state = TrainState(params, opt_state, env_state, last_obs, key,
                           ep_return_acc=ep_acc)
        state, metrics = self.update(state, shuffle)
        return (self._carry(state), shuffle), metrics

    def update(self, state: TrainState, shuffle=None):
        """One update, eagerly: :meth:`__call__`'s body. Under the stage
        counters (:mod:`~multigrid_tpu_torch.utils.profiling`) it marks the
        stages ``rollout`` (with the env step's stages inside it), ``gae``
        and ``sgd``."""
        cfg = self.config
        params, opt_state = gather_params(state.params, self.venv.mesh), state.opt_state
        with profiling.stage('rollout'):
            state, traj, last_value, (ep_sum, ep_cnt, ep_suc) = self.rollout_phase(
                state, params)
        with profiling.stage('gae'):
            advantages, targets = self.compute_gae(traj, last_value)
        with profiling.stage('sgd'):
            if cfg.minibatches == 1:
                for _ in range(cfg.epochs):
                    params, opt_state, metrics = self.sgd_step(
                        params, opt_state, traj, advantages, targets)
            else:
                t, e = advantages.shape[0], self.venv.num_envs
                if e % cfg.minibatches:
                    raise ValueError(f'env batch {e} not divisible by '
                                     f'{cfg.minibatches} minibatches')
                batch, shard, shards = (traj, advantages, targets), 0, 1
                if self.split:
                    mesh = self.venv.mesh
                    shard, shards = mesh.coords[0], mesh.env_shards
                    batch = tuple(x.map(self._gather) if isinstance(x, Rollout)
                                  else self._gather(x) for x in batch)
                # key, k_perm = split(key); the epoch keys split(k_perm, epochs).
                key, epoch_keys = prng.split(state.key, cfg.epochs, split_first=True)
                state = state.replace(key=key)
                for epoch in range(cfg.epochs):
                    if shuffle is None:
                        # k_t, k_e = split(epoch key), the roll randint(k_e)
                        # (ppo.py:673-675), stays on the device (a 0-d tensor).
                        k_t, off_e = prng.randint(epoch_keys[epoch], (), 0, e, split_first=True)
                        perm_t = prng.permutation(k_t, t)
                    else:
                        perm_t, off_e = shuffle[epoch]
                    for tr, adv, tg in minibatches(batch, cfg.minibatches, perm_t, off_e,
                                                   shard, shards):
                        params, opt_state, metrics = self.sgd_step(
                            params, opt_state, tr, adv, tg)
        metrics = self.mean_over_processes({**metrics, 'reward_per_step': traj.reward.mean()})
        if self.group is not None:
            sums = distributed.all_reduce(torch.stack([ep_sum.double(), ep_cnt.double(),
                                                       ep_suc.double()]), self.group)
            ep_sum, ep_cnt, ep_suc = (sums[0].to(ep_sum.dtype), sums[1].to(ep_cnt.dtype),
                                      sums[2].to(ep_suc.dtype))
        nan = torch.full((), float('nan'), device=ep_sum.device)
        done_any = ep_cnt > 0
        metrics['episodes_in_batch'] = ep_cnt.float()
        metrics['episode_reward'] = torch.where(done_any, ep_sum / ep_cnt.clamp_min(1), nan)
        metrics['success_rate'] = torch.where(done_any, ep_suc / ep_cnt.clamp_min(1), nan)
        state = state.replace(params=shard_params(params, self.venv.mesh),
                              opt_state=opt_state, update_count=state.update_count + 1)
        return state, metrics

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of this process's (T, E/R, ...) rows."""
        return distributed.all_gather_rows(x, self.group, dim=1)


def minibatches(batch: tuple[Rollout, torch.Tensor, torch.Tensor], count: int,
                perm_t, off_e, shard: int = 0, shards: int = 1):
    """Split ``(traj, advantages, targets)`` (T, E, ...) into ``count``
    minibatches: permute T by ``perm_t``, roll the env axis by ``off_e``
    (an int or a 0-d device tensor: the rows are gathered at indices
    computed on the device), then take contiguous env blocks
    (ppo.py:671-698). With ``shards``, each minibatch's block is split in
    as many contiguous parts and only part ``shard`` is yielded (a
    process's share of the minibatch)."""
    traj, adv, tg = batch
    e = adv.shape[1]
    c = e // count
    if c % shards:
        raise ValueError(f'a minibatch of {c} envs does not split over {shards} processes')
    part = c // shards
    perm_t = torch.as_tensor(perm_t, device=adv.device)
    traj, adv, tg = traj.map(lambda x: x[perm_t]), adv[perm_t], tg[perm_t]
    for m in range(count):
        # Rolled position j holds env (j - off_e) mod E.
        start = m * c + shard * part
        src = (torch.arange(start, start + part, device=adv.device) - off_e) % e
        yield traj.map(lambda x: x[:, src]), adv[:, src], tg[:, src]


def make_train_step(venv: VectorEnv, net: ActorCritic, config: PPOConfig,
                    tx: Optimizer, per_agent_policies: bool | None = None) -> TrainStep:
    """The PPO update for ``venv`` (see :class:`TrainStep`).
    ``per_agent_policies`` is the JAX package's deprecated alias for the
    config field (multigrid_tpu/learn/ppo.py:235-247)."""
    if per_agent_policies is not None:
        config = config.replace(per_agent_policies=per_agent_policies)
    return TrainStep(venv, net, config, tx)


def make_train_loop(venv: VectorEnv, net: ActorCritic, config: PPOConfig,
                    tx: Optimizer, updates_per_call: int,
                    per_agent_policies: bool | None = None):
    """``updates_per_call`` updates per call (on the card, that many
    replays of the update's graph, as the JAX package scans them in one
    jitted call, ppo.py:736-765); the metrics are their means (NaN-skipping:
    ``episode_reward`` is NaN where no episode ended). ``per_agent_policies``
    as in :func:`make_train_step`."""
    train_step = make_train_step(venv, net, config, tx, per_agent_policies)

    def train_loop(state: TrainState) -> tuple[TrainState, dict[str, Any]]:
        state, rows = train_step.run(state, updates_per_call)
        return state, {k: torch.nanmean(torch.stack([r[k].float() for r in rows]))
                       for k in rows[0]}

    return train_loop


__all__ = ['OptState', 'Optimizer', 'PPOConfig', 'Rollout', 'TrainState',
           'TrainStep', 'linear_schedule', 'make_train_loop',
           'make_train_step', 'minibatches', 'ppo_init', 'sample_actions']
