"""The comparison that decides ``correct`` in the env cells.

The program's states are read by their field names (it is never
imported), copied into the reference's state type, and held against what
the plain reference (:mod:`portbench.reference`) computes from the same
keys:

- the start: every env's reset state and first observation against the
  reference's reset from the same key;
- one rollout call of the window, drawn from the seed among the calls in
  which the envs reach ``max_steps`` (so that it holds auto-resets): the
  reference steps the program's state before that call with the call's
  key, and every env's state after it, the reserve pool, the finished
  episodes, the observations' sum and the reward sum must be the
  program's, bit for bit.

A state is integer arithmetic and keyed draws, exact on both sides, and
the reward sum adds the same float32 rewards in the same order with the
same reduction, so every limit is 0.
"""

from __future__ import annotations

import dataclasses

import torch

from .harness import Check
from .reference.core.state import STATE_FIELDS, MultiGridState, ResetPool
from .reference.envs import make
from .reference.utils import prng
from .reference.vector import PlainVectorEnv



def reference_env(config: dict, device, break_guarantee: str | None = None) -> PlainVectorEnv:
    env = make(config['env_id'], agents=config['agents'],
               agent_view_size=config['agent_view_size'], max_steps=config['max_steps'],
               device=device)
    return PlainVectorEnv(env, config['num_envs'], packed_obs=config['packed_obs'],
                          reset_pool=config['reset_pool'], break_guarantee=break_guarantee)


def keys_of(seed: int, count: int):
    """The run's keys from its seed, on the host: the reset's key and
    ``count`` rollout keys (``k_reset, k_calls = split(key(seed))``, the
    calls' ``split(k_calls, count)``); seeds past 32 bits take the JAX
    convention of ``key(seed)``."""
    k_reset, k_calls = prng.split(prng.key(seed)).unbind(0)
    return k_reset, prng.split(k_calls, count)


def as_reference(s) -> MultiGridState:
    """A copy of a state read by its fields' names, as the reference's
    state type."""
    pool = None
    if getattr(s, 'pool', None) is not None:
        pool = ResetPool(as_reference(s.pool.reserve), s.pool.step.clone(),
                         s.pool.keys.clone())
    return MultiGridState(**{f: getattr(s, f).clone() for f in STATE_FIELDS},
                          extras={k: v.clone() for k, v in s.extras.items()}, pool=pool)


def envs_differ(a, b) -> int:
    """How many envs (rows) differ between two states in any field or
    extra."""
    rows = torch.zeros(a.grid.shape[0], dtype=torch.bool, device=a.grid.device)
    pairs = [(getattr(a, f), getattr(b, f)) for f in STATE_FIELDS]
    if a.extras.keys() != b.extras.keys():
        return a.grid.shape[0]
    pairs += [(a.extras[k], b.extras[k]) for k in a.extras]
    for x, y in pairs:
        if x.shape != y.shape:
            return a.grid.shape[0]
        rows |= (x != y.to(x.device)).reshape(x.shape[0], -1).any(-1)
    return int(rows.sum())


def pool_differs(a, b) -> int:
    """Reserve slots that differ, plus 1 where the global step differs."""
    if a.pool is None or b.pool is None:
        return int((a.pool is None) != (b.pool is None))
    return (envs_differ(a.pool.reserve, b.pool.reserve)
            + int(not torch.equal(a.pool.step.cpu(), b.pool.step.cpu()))
            + int(not torch.equal(a.pool.keys.cpu(), b.pool.keys.cpu())))


def state_tensors(s) -> list:
    """A state's tensors in a fixed order: its fields, its extras by name
    and, where it has a pool, the reserve's, the pool's step and keys."""
    out = [getattr(s, f) for f in STATE_FIELDS] + [s.extras[k] for k in sorted(s.extras)]
    if getattr(s, 'pool', None) is not None:
        out += state_tensors(s.pool.reserve) + [s.pool.step, s.pool.keys]
    return out


def copy_into(dst, src) -> None:
    """Copy state ``src`` into the tensors of ``dst`` (of its shapes)."""
    for d, s in zip(state_tensors(dst), state_tensors(src), strict=True):
        d.copy_(s)


@dataclasses.dataclass
class Sample:
    """One rollout call of the window: the state it started from, its key,
    the program's state and summary after it."""
    before: object
    key: torch.Tensor
    after: object
    summary: dict


def compare(ref: PlainVectorEnv, reset_key, reset_obs, reset_state, sample: Sample,
            steps: int) -> list[Check]:
    """The checks of a run: the program's reset (obs and state) and one
    sampled call against the reference's."""
    dev = ref.device
    r_obs, r_state = ref.reset(reset_key.to(dev))
    start = envs_differ(as_reference(reset_state), r_state)
    start_obs = (reset_obs['image'].to(dev) != r_obs['image']).reshape(
        r_obs['image'].shape[0], -1).any(-1)
    start_pool = pool_differs(as_reference(reset_state), r_state)
    r_after, r_sum = ref.rollout_random(as_reference(sample.before), sample.key.to(dev), steps)
    after = as_reference(sample.after)
    p_sum = {k: v.to(dev) for k, v in sample.summary.items()}
    rew_gap = abs(float(p_sum['reward_sum']) - float(r_sum['reward_sum']))
    return [
        Check('reset_envs_differ', start + int(start_obs.sum()) + start_pool, 0),
        Check('envs_differ', envs_differ(after, r_after), 0),
        Check('pool_differs', pool_differs(after, r_after), 0),
        Check('episodes_gap', abs(int(p_sum['episodes']) - int(r_sum['episodes'])), 0),
        Check('obs_sum_gap', abs(int(p_sum['obs_sum']) - int(r_sum['obs_sum'])), 0),
        Check('reward_sum_gap', rew_gap, 0),
    ]
