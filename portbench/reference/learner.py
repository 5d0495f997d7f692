"""A plain PPO update of the mlp actor-critic on packed observations.

The JAX package's learner (multigrid_tpu/learn/ppo.py) restated in plain
PyTorch over :class:`~portbench.reference.vector.PlainVectorEnv`, one
policy shared by the agents, the local critic: ``rollout_steps`` steps
with actions drawn by Gumbel-max from ``gumbel(k_act, (E, N, A))`` (``key,
k_act = split(key)`` a step), GAE by the reverse scan, then ``epochs`` ×
``minibatches`` steps of Adam on the clipped-PPO loss (autograd), the
gradients clipped by their global norm (optax's ``clip_by_global_norm``:
scaled by ``max / norm`` where ``norm >= max``). With several minibatches
each epoch permutes the steps by ``permutation(k_t, T)`` and rolls the env
axis by ``randint(k_e, (), 0, E)`` (``key, k_perm = split(key)``, the
epochs' keys ``split(k_perm, epochs)``, each ``k_t, k_e = split``), then
takes contiguous env blocks.

The net (flax's numerics): float32 parameters ``img_kernel`` (C·21, H)
over the one-hot of the packed cells, ``Dense_0`` over ``[cos θ, sin θ]``
of the direction (θ = dir·π/2 in the compute type) and the mission's
one-hot, ``Dense_1`` (H, H), ``Dense_2`` (H, A) the logits and ``Dense_3``
(H, 1) the value; every product in the compute type (bfloat16) with
float32 accumulation, the first layer's sum in float32 over bfloat16
weights, the heads' outputs promoted to float32.

``lowp`` rounds every product's operands through a lower precision (the
benchmark's control, float8 e4m3 for a bfloat16 net).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .utils import prng

#: One-hot channels of a packed cell: 11 types, 6 colors, 4 states.
TYPES, COLORS, STATES = 11, 6, 4
NCH = TYPES + COLORS + STATES


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    rollout_steps: int
    epochs: int
    minibatches: int
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5


@dataclasses.dataclass
class TrainState:
    params: dict
    mu: dict
    nu: dict
    count: int
    env_state: object
    last_obs: dict
    key: torch.Tensor


def one_hot_features(packed: torch.Tensor) -> torch.Tensor:
    """(B, C) packed cells → (B, C·21) float32 one-hot: type, then color
    and state, each field matched against its channel's values."""
    t, c, s = packed >> 8, (packed >> 4) & 15, packed & 15
    ar = torch.arange
    dev = packed.device
    parts = [t[..., None] == ar(TYPES, device=dev), c[..., None] == ar(COLORS, device=dev),
             s[..., None] == ar(STATES, device=dev)]
    return torch.cat(parts, -1).flatten(1).float()


def _keep(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).to(x.dtype)


class Net:
    """The mlp actor-critic, functional over a dict of parameters."""

    def __init__(self, num_missions: int, dtype=torch.bfloat16, lowp: bool = False):
        self.num_missions = num_missions
        self.dtype = dtype
        self.q = _fp8 if lowp else _keep

    def features(self, direction, mission):
        theta = direction.to(self.dtype) * (math.pi / 2)
        d = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
        if self.num_missions and mission is not None:
            onehot = mission.long()[..., None] == torch.arange(self.num_missions,
                                                               device=mission.device)
            d = torch.cat([d, onehot.to(self.dtype)], dim=-1)
        return d

    def dense(self, p, name, x):
        y = self.q(x.to(self.dtype)) @ self.q(p[f'{name}.kernel'].to(self.dtype))
        return y + p[f'{name}.bias'].to(self.dtype)

    def __call__(self, p, image, direction, mission=None):
        lead = image.shape[:-1]
        w = self.q(p['img_kernel'].to(torch.bfloat16)).float()
        x1 = (one_hot_features(image.reshape(-1, image.shape[-1])) @ w).to(torch.bfloat16)
        x1 = x1.to(self.dtype).reshape(lead + (w.shape[1],))
        x = torch.relu(x1 + self.dense(p, 'Dense_0', self.features(direction, mission)))
        x = torch.relu(self.dense(p, 'Dense_1', x))
        return self.dense(p, 'Dense_2', x).float(), self.dense(p, 'Dense_3', x).float()[..., 0]


def log_prob(logits, action):
    return torch.log_softmax(logits, -1).gather(-1, action.long()[..., None])[..., 0]


class Learner:
    def __init__(self, venv, net: Net, config: PPOConfig):
        self.venv, self.net, self.cfg = venv, net, config

    def init(self, params: dict, key) -> TrainState:
        """``k_env, k_net, k_train = split(key, 3)``: the envs reset from
        ``k_env``; ``params`` are the run's (made by the benchmark)."""
        k_env, _, k_train = prng.split(prng.as_key(key, self.venv.device), 3).unbind(0)
        obs, env_state = self.venv.reset(k_env)
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        return TrainState({k: v.clone() for k, v in params.items()}, zeros,
                          {k: v.clone() for k, v in zeros.items()}, 0, env_state, obs,
                          k_train.clone())

    def sample(self, logits, gumbel):
        """Gumbel-max: ``argmax(logits + gumbel)``, the first on ties."""
        return (logits + gumbel).argmax(-1).to(torch.int32)

    @torch.no_grad()
    def rollout(self, s: TrainState):
        venv, net = self.venv, self.net
        e, n = venv.num_envs, venv.num_agents
        obs, env_state, key = s.last_obs, s.env_state, s.key
        steps = []
        for _ in range(self.cfg.rollout_steps):
            key, g = prng.gumbel(key, (e, n, 7), split_first=True)
            logits, value = net(s.params, obs['image'], obs['direction'], obs.get('mission'))
            action = self.sample(logits, g)
            nxt, env_state, reward, term, _, done, _ = venv.step(
                env_state, action, refresh=not venv.reset_pool)
            steps.append(dict(image=obs['image'], direction=obs['direction'],
                              mission=obs.get('mission'), action=action,
                              log_prob=log_prob(logits, action), value=value, reward=reward,
                              done=done[:, None] | term))
            obs = nxt
        traj = {k: None if steps[0][k] is None else torch.stack([x[k] for x in steps])
                for k in steps[0]}
        if env_state.pool is not None:
            env_state = env_state.replace(pool=venv._refresh(env_state.pool,
                                                             self.cfg.rollout_steps))
        last_value = net(s.params, obs['image'], obs['direction'], obs.get('mission'))[1]
        return dataclasses.replace(s, env_state=env_state, last_obs=obs, key=key), traj, \
            last_value

    @torch.no_grad()
    def gae(self, traj, last_value):
        gamma = float(np.float32(self.cfg.gamma))
        gl = float(np.float32(self.cfg.gamma) * np.float32(self.cfg.gae_lambda))
        adv = torch.empty_like(traj['value'])
        running, nxt = torch.zeros_like(last_value), last_value
        for t in reversed(range(adv.shape[0])):
            not_done = 1.0 - traj['done'][t].float()
            delta = traj['reward'][t] + gamma * nxt * not_done - traj['value'][t]
            running = delta + gl * not_done * running
            adv[t] = running
            nxt = traj['value'][t]
        return adv, adv + traj['value']

    def loss(self, params, traj, adv, targets):
        cfg = self.cfg
        logits, value = self.net(params, traj['image'], traj['direction'], traj['mission'])
        logp_all = torch.log_softmax(logits, -1)
        ratio = torch.exp(log_prob(logits, traj['action']) - traj['log_prob'])
        a = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg = -torch.minimum(ratio * a, torch.clamp(ratio, 1 - cfg.clip_eps,
                                                   1 + cfg.clip_eps) * a).mean()
        vf = 0.5 * torch.square(value - targets).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        scale = pg.abs() + cfg.vf_coef * vf + cfg.ent_coef * entropy
        return pg + cfg.vf_coef * vf - cfg.ent_coef * entropy, scale.detach()

    def sgd(self, s: TrainState, traj, adv, targets):
        """One Adam step: ``(state, (loss, its terms' magnitudes), grads)``."""
        cfg = self.cfg
        leaves = {k: v.detach().requires_grad_(True) for k, v in s.params.items()}
        with torch.enable_grad():
            loss, scale = self.loss(leaves, traj, adv, targets)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < cfg.max_grad_norm
        grads = {k: torch.where(keep, g, g / norm * cfg.max_grad_norm) for k, g in grads.items()}
        count = s.count + 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        mu = {k: (1 - b1) * g + b1 * s.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * s.nu[k] for k, g in grads.items()}
        c1 = 1 - torch.pow(torch.tensor(b1), torch.tensor(count, dtype=torch.int32))
        c2 = 1 - torch.pow(torch.tensor(b2), torch.tensor(count, dtype=torch.int32))
        c1, c2 = c1.to(norm.device), c2.to(norm.device)
        params = {k: v - cfg.lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
                  for k, v in s.params.items()}
        return dataclasses.replace(s, params=params, mu=mu, nu=nu, count=count), \
            (loss.detach(), scale), grads

    def update(self, s: TrainState):
        """One update: ``(state, (loss, the sum of its terms' magnitudes)
        of its last step, grads of its first)``."""
        cfg = self.cfg
        s, traj, last_value = self.rollout(s)
        adv, targets = self.gae(traj, last_value)
        first = None
        if cfg.minibatches == 1:
            for _ in range(cfg.epochs):
                s, loss, grads = self.sgd(s, traj, adv, targets)
                first = first or grads
            return s, loss, first
        t, e = adv.shape[0], self.venv.num_envs
        key, epoch_keys = prng.split(s.key, cfg.epochs, split_first=True)
        s = dataclasses.replace(s, key=key)
        c = e // cfg.minibatches
        for epoch in range(cfg.epochs):
            k_t, off_e = prng.randint(epoch_keys[epoch], (), 0, e, split_first=True)
            perm = prng.permutation(k_t, t)
            tr = {k: None if v is None else v[perm] for k, v in traj.items()}
            a, tg = adv[perm], targets[perm]
            for m in range(cfg.minibatches):
                src = (torch.arange(m * c, (m + 1) * c, device=a.device) - off_e) % e
                s, loss, grads = self.sgd(
                    s, {k: None if v is None else v[:, src] for k, v in tr.items()},
                    a[:, src], tg[:, src])
                first = first or grads
        return s, loss, first
