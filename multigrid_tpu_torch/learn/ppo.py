"""PPO with a shared policy: rollout, GAE and clipped-surrogate updates.

Counterpart of ``multigrid_tpu.learn.ppo`` for one policy shared by all
agents, the mlp ``ActorCritic``, and optax's ``clip_by_global_norm`` then
``adam``. An update (:class:`TrainStep`) runs ``rollout_steps`` lockstep
steps of the vector env with actions sampled from the policy, computes GAE,
and takes ``epochs`` × ``minibatches`` SGD steps. On the card the rollout's
first layer is the ``onehot_linear`` kernel, and the learner is the fused
PPO-loss kernel where :func:`~multigrid_tpu_torch.ops.fused_ppo.supports`
holds, else autograd of :meth:`TrainStep.loss_fn` (whose first layer's
weight gradient is the ``onehot_linear`` gradient kernel). On the CPU the
same code takes the plain versions.

Parameters and optimizer state are plain dicts of tensors, updated
functionally: no tensor of a ``TrainState`` is written in place, so a caller
can keep one and run from it again, after restoring the generators' states.
Randomness comes from ``torch.Generator``s: the vector env's (agent orders,
resets) and the train state's (actions, minibatch shuffles); they give other
numbers than ``jax.random``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from ..core.state import MultiGridState
from ..ops import fused_ppo
from ..parallel.vector import VectorEnv
from .nets import PARAM_NAMES, ActorCritic, direction_features


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

    def replace(self, **changes) -> 'PPOConfig':
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class OptState:
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))``.

    The clip scales by ``max_norm / norm`` only where ``norm >= max_norm``,
    with no epsilon (torch's ``clip_grad_norm_`` divides by ``norm + 1e-6``);
    Adam's ``eps`` is outside the square root of the bias-corrected second
    moment. ``update`` returns the updates to add to the parameters.
    """

    def __init__(self, lr: float, max_grad_norm: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.max_grad_norm = lr, max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        return OptState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                        {k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: dict[str, torch.Tensor], state: OptState):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.max_grad_norm
        grads = {k: torch.where(keep, g, g / norm * self.max_grad_norm)
                 for k, g in grads.items()}
        count = state.count + 1
        mu = {k: (1 - self.b1) * g + self.b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - self.b2) * (g * g) + self.b2 * state.nu[k] for k, g in grads.items()}
        # The bias corrections in float32, as Python numbers (no copy to
        # the device).
        c1 = float(np.float32(1) - np.float32(self.b1) ** count)
        c2 = float(np.float32(1) - np.float32(self.b2) ** count)
        updates = {k: -self.lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps))
                   for k in grads}
        return updates, OptState(count, mu, nu)


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: OptState
    env_state: MultiGridState
    last_obs: dict[str, torch.Tensor]
    #: Draws the actions and the minibatch shuffles.
    generator: torch.Generator
    update_count: int = 0
    #: (E,) return of each env's running episode (all agents summed),
    #: carried across updates so ``episode_reward`` is exact.
    ep_return_acc: torch.Tensor | None = None

    def replace(self, **changes) -> 'TrainState':
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class Rollout:
    """(T, E, N, ...) trajectory slices."""
    image: torch.Tensor
    direction: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor

    def map(self, fn) -> 'Rollout':
        return Rollout(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


def _select_log_prob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``log_softmax(logits)[action]``."""
    log_probs = torch.log_softmax(logits, dim=-1)
    return log_probs.gather(-1, action.long()[..., None]).squeeze(-1)


def sample_actions(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Gumbel-max sampling, ``argmax(logits + gumbel)`` (first index on
    ties), as ``jax.random.categorical`` computes it from its own noise."""
    return (logits + gumbel).argmax(dim=-1).to(torch.int32)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def ppo_init(venv: VectorEnv, seed: int = 0, *, config: PPOConfig | None = None,
             hidden: int = 128):
    """``(train_state, net, config, optimizer)`` for training on ``venv``.

    The env, the net's weights and the train state's generator get
    independent seeds derived from ``seed``.
    """
    config = config or PPOConfig()
    env_seed, net_seed, train_seed = (
        int(s) for s in np.random.SeedSequence(seed).generate_state(3))
    obs, env_state = venv.reset(seed=env_seed)
    if 'mission' in obs:
        raise NotImplementedError(
            'mission-conditioned envs are not ported yet: the net has no '
            'mission input')
    vs = venv.env.cfg.view_size
    net = ActorCritic(vs * vs, hidden=hidden, packed_obs=venv.packed_obs,
                      seed=net_seed).to(venv.device)
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    tx = Optimizer(config.lr, config.max_grad_norm)
    state = TrainState(
        params=params, opt_state=tx.init(params), env_state=env_state,
        last_obs=obs,
        generator=torch.Generator(device=venv.device).manual_seed(train_seed),
        ep_return_acc=torch.zeros(venv.num_envs, device=venv.device))
    return state, net, config, tx


class TrainStep:
    """One PPO update, ``state -> (state, metrics)``, and its phases
    (``rollout_phase``, ``compute_gae``, ``sgd_step``), which the tests and
    ``chip_smoke.py`` call one by one.

    The learner's kernel gate is :func:`fused_ppo.supports`, read when the
    step is built (as the JAX package reads it).
    """

    def __init__(self, venv: VectorEnv, net: ActorCritic, config: PPOConfig,
                 tx: Optimizer):
        self.venv, self.net, self.config, self.tx = venv, net, config, tx
        self._loss_kernel_ok = fused_ppo.supports

    def policy(self, params, obs):
        """``(logits, value)`` for (E, N, ...) observations."""
        return functional_call(self.net, params, (obs['image'], obs['direction']))

    @torch.no_grad()
    def rollout_phase(self, state: TrainState):
        """``rollout_steps`` env steps under the policy. Returns ``(state,
        traj, last_value, (ep_sum, ep_cnt, ep_suc))``."""
        venv, params = self.venv, state.params
        env_state, obs = state.env_state, state.last_obs
        ep_acc = state.ep_return_acc
        ep_sum = torch.zeros((), device=venv.device)
        ep_cnt = torch.zeros((), dtype=torch.int64, device=venv.device)
        ep_suc = torch.zeros((), dtype=torch.int64, device=venv.device)
        steps = []
        for _ in range(self.config.rollout_steps):
            logits, value = self.policy(params, obs)
            action = sample_actions(
                logits, gumbel_noise(logits.shape, state.generator, venv.device))
            log_prob = _select_log_prob(logits, action)
            next_obs, env_state, reward, term, _, done, success = venv.step(
                env_state, action)
            ep_acc = ep_acc + reward.sum(-1)
            ep_sum = ep_sum + torch.where(done, ep_acc, 0.0).sum()
            ep_cnt = ep_cnt + done.sum()
            ep_suc = ep_suc + (done & success).sum()
            ep_acc = torch.where(done, 0.0, ep_acc)
            steps.append(Rollout(obs['image'], obs['direction'], action, log_prob,
                                 value, reward, done[:, None] | term))
            obs = next_obs
        traj = Rollout(*(torch.stack([getattr(s, f.name) for s in steps])
                         for f in dataclasses.fields(Rollout)))
        last_value = self.policy(params, obs)[1]
        state = state.replace(env_state=env_state, last_obs=obs, ep_return_acc=ep_acc)
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

    def loss_fn(self, params, traj: Rollout, advantages, targets):
        """``(loss, metrics)`` of the clipped-PPO objective through the net."""
        cfg = self.config
        logits, value = self.policy(params, {'image': traj.image,
                                             'direction': traj.direction})
        log_probs = torch.log_softmax(logits, dim=-1)
        ratio = torch.exp(_select_log_prob(logits, traj.action) - traj.log_prob)
        adv = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
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
        log-probs, normalized advantages and targets, flattened to B rows."""
        b = traj.direction.numel()

        def flat(x):
            return x.reshape((b,) + x.shape[3:]).contiguous()

        mu, sd = advantages.mean(), advantages.std(correction=0)
        return [flat(traj.image), flat(direction_features(traj.direction).float()),
                flat(traj.action.to(torch.int32)), flat(traj.log_prob),
                flat((advantages - mu) / (sd + 1e-8)), flat(targets)]

    def loss_grads(self, params, traj: Rollout, advantages, targets):
        """``(grads, metrics)``: the fused PPO-loss kernel where its gate
        holds, else autograd of :meth:`loss_fn`."""
        cfg, net = self.config, self.net
        if net.packed_obs and self._loss_kernel_ok(
                traj.direction.numel(), net.hidden, net.num_actions):
            return fused_ppo.ppo_mlp_grads(
                params, *self.kernel_inputs(traj, advantages, targets),
                clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef,
                num_actions=net.num_actions)
        leaves = {k: params[k].detach().requires_grad_(True) for k in PARAM_NAMES}
        with torch.enable_grad():
            loss, metrics = self.loss_fn(leaves, traj, advantages, targets)
            grads = torch.autograd.grad(loss, [leaves[k] for k in PARAM_NAMES])
        return (dict(zip(PARAM_NAMES, grads)),
                {k: v.detach() for k, v in metrics.items()})

    @torch.no_grad()
    def sgd_step(self, params, opt_state: OptState, traj: Rollout, advantages, targets):
        """One optimizer step on a (minibatch) trajectory. Returns
        ``(params, opt_state, metrics)``."""
        grads, metrics = self.loss_grads(params, traj, advantages, targets)
        updates, opt_state = self.tx.update(grads, opt_state)
        return {k: params[k] + updates[k] for k in params}, opt_state, metrics

    def __call__(self, state: TrainState, shuffle=None):
        """One update. ``shuffle`` fixes each epoch's minibatch shuffle as a
        list of ``(perm_t, off_e)`` (a T-permutation and an env-axis roll);
        by default they are drawn from ``state.generator``."""
        cfg = self.config
        state, traj, last_value, (ep_sum, ep_cnt, ep_suc) = self.rollout_phase(state)
        advantages, targets = self.compute_gae(traj, last_value)
        params, opt_state = state.params, state.opt_state
        if cfg.minibatches == 1:
            for _ in range(cfg.epochs):
                params, opt_state, metrics = self.sgd_step(
                    params, opt_state, traj, advantages, targets)
        else:
            t, e = advantages.shape[:2]
            if e % cfg.minibatches:
                raise ValueError(f'env batch {e} not divisible by '
                                 f'{cfg.minibatches} minibatches')
            for epoch in range(cfg.epochs):
                if shuffle is None:
                    perm_t = torch.randperm(t, generator=state.generator,
                                            device=state.generator.device)
                    off_e = int(torch.randint(e, (), generator=state.generator,
                                              device=state.generator.device))
                else:
                    perm_t, off_e = shuffle[epoch]
                for tr, adv, tg in minibatches((traj, advantages, targets),
                                               cfg.minibatches, perm_t, off_e):
                    params, opt_state, metrics = self.sgd_step(
                        params, opt_state, tr, adv, tg)
        nan = torch.full((), float('nan'), device=ep_sum.device)
        done_any = ep_cnt > 0
        metrics = dict(metrics)
        metrics['reward_per_step'] = traj.reward.mean()
        metrics['episodes_in_batch'] = ep_cnt.float()
        metrics['episode_reward'] = torch.where(done_any, ep_sum / ep_cnt.clamp_min(1), nan)
        metrics['success_rate'] = torch.where(done_any, ep_suc / ep_cnt.clamp_min(1), nan)
        state = state.replace(params=params, opt_state=opt_state,
                              update_count=state.update_count + 1)
        return state, metrics


def minibatches(batch: tuple[Rollout, torch.Tensor, torch.Tensor], count: int,
                perm_t, off_e: int):
    """Split ``(traj, advantages, targets)`` (T, E, ...) into ``count``
    minibatches: permute T by ``perm_t``, roll the env axis by ``off_e``,
    then take contiguous env blocks (ppo.py:671-698)."""
    traj, adv, tg = batch
    e = adv.shape[1]
    c = e // count
    perm_t = torch.as_tensor(perm_t, device=adv.device)

    def shuffle(x):
        return torch.roll(x[perm_t], off_e, dims=1)

    traj, adv, tg = traj.map(shuffle), shuffle(adv), shuffle(tg)
    for m in range(count):
        block = slice(m * c, (m + 1) * c)
        yield traj.map(lambda x: x[:, block]), adv[:, block], tg[:, block]


def make_train_step(venv: VectorEnv, net: ActorCritic, config: PPOConfig,
                    tx: Optimizer) -> TrainStep:
    """The PPO update for ``venv`` (see :class:`TrainStep`)."""
    return TrainStep(venv, net, config, tx)


def make_train_loop(venv: VectorEnv, net: ActorCritic, config: PPOConfig,
                    tx: Optimizer, updates_per_call: int):
    """``updates_per_call`` updates per call; the metrics are their means
    (NaN-skipping: ``episode_reward`` is NaN where no episode ended)."""
    train_step = make_train_step(venv, net, config, tx)

    def train_loop(state: TrainState) -> tuple[TrainState, dict[str, Any]]:
        rows = []
        for _ in range(updates_per_call):
            state, metrics = train_step(state)
            rows.append(metrics)
        return state, {k: torch.nanmean(torch.stack([r[k].float() for r in rows]))
                       for k in rows[0]}

    return train_loop


__all__ = ['OptState', 'Optimizer', 'PPOConfig', 'Rollout', 'TrainState',
           'TrainStep', 'gumbel_noise', 'make_train_loop', 'make_train_step',
           'minibatches', 'ppo_init', 'sample_actions']
