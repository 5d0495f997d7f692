"""A plain vector env: ``E`` lockstep envs with auto-reset, one process,
eager, every stage in plain PyTorch.

The port's ``VectorEnv`` (one process, no mesh) restated over the frozen
copies of this package: the step's draws split each env's key for its
agents' order and its fresh episode's keys; a finished env takes slot
``(i + g) mod E`` of the reserve pool where the env's layouts are
procedural, else an exact reset from its key; the reserve is stored packed
(``type<<8 | color<<4 | state`` a cell, a Box's contents in bits 12–23) and
regenerated ``ceil(E / period)`` slots a step from ``fold_in(slot key,
g)``. ``rollout_random`` draws each step's actions as ``key, sub =
split(key)``, ``randint(sub, (E, N), 0, 7)``, in chunks of
:data:`REFRESH_CHUNK` steps with one refresh of the pool after each chunk.

``break_guarantee`` names one guarantee to break (the benchmark's
control): ``'occlusion'`` makes every observation see through walls.
"""

from __future__ import annotations

import torch

from .core.constants import Color, State, Type
from .core.state import STATE_FIELDS, ResetPool, where_state
from .utils import prng
from .utils.device import constant

NUM_ACTIONS = 7
REFRESH_CHUNK = 16
_LANES = [8, 4, 0]


class PlainVectorEnv:
    def __init__(self, env, num_envs: int, *, packed_obs: bool = True,
                 reset_pool: bool | None = None, break_guarantee: str | None = None):
        if break_guarantee not in (None, 'occlusion'):
            raise ValueError(f'no guarantee named {break_guarantee!r}')
        self.env = env
        self.num_envs = num_envs
        self.device = env.device
        self.packed_obs = packed_obs
        self.reset_pool = env.procedural_reset if reset_pool is None else reset_pool
        self.reset_pool_period = min(128, max(1, env.cfg.max_steps))
        self.pool_packed = len(Color) <= 16 and len(State) <= 16 and len(Type) <= 16
        self.see_through_walls = env.cfg.see_through_walls or break_guarantee == 'occlusion'
        self._slots = torch.arange(num_envs, device=self.device)

    @property
    def num_agents(self) -> int:
        return self.env.num_agents

    def reset(self, key):
        key, pool_key = prng.split(prng.as_key(key, self.device)).unbind(0)
        state = self.env.reset_core(prng.split(key, self.num_envs)).clone()
        if self.reset_pool:
            state = state.replace(pool=self.new_pool(pool_key))
        return self.observe(state), state

    def new_pool(self, key) -> ResetPool:
        k_res, k_stream = prng.split(key).unbind(0)
        reserve = self.env.reset_core(prng.split(k_res, self.num_envs))
        return ResetPool(self.pool_pack(reserve).clone(), 0, prng.split(k_stream, self.num_envs))

    def pool_pack(self, state):
        if not self.pool_packed:
            return state
        g = state.grid
        lanes = constant(_LANES, g.device, torch.int32)
        p = (g << lanes).sum(-1, dtype=torch.int32).reshape(g.shape[0], -1)
        if state.box_contents.numel():
            b = state.box_contents
            p = p | ((b << lanes).sum(-1, dtype=torch.int32).reshape(p.shape) << 12)
            state = state.replace(box_contents=b.new_zeros((b.shape[0], 0, 0, 3)))
        return state.replace(grid=p)

    def pool_unpack(self, state):
        if not self.pool_packed:
            return state
        p, e = state.grid, state.grid.shape[0]
        boxes = self.env.uses_boxes
        lanes = constant(_LANES + ([lane + 12 for lane in _LANES] if boxes else []), p.device,
                         torch.int32)
        cells = ((p[..., None] >> lanes) & 15).reshape(e, self.env.width, self.env.height, -1)
        state = state.replace(grid=cells[..., :3])
        if boxes:
            state = state.replace(box_contents=cells[..., 3:])
        return state

    def observe(self, state):
        from .ops.obs import gen_obs_batched_plain
        cfg = self.env.cfg
        image = gen_obs_batched_plain(state, cfg.view_size, self.see_through_walls,
                                      self.packed_obs)
        return self.env.attach_mission({'image': image, 'direction': state.agent_dir}, state)

    def step(self, state, actions, *, refresh: bool = True):
        pool = state.pool
        mode = prng.STEP_EXACT if pool is None else prng.STEP_POOL
        order, rng, gen, fresh_rng = prng.step_draws(state.rng, self.num_agents, mode)
        obs_state, new_state, rew, term, trunc = self.env.step_core(
            state.replace(pool=None, rng=rng), actions, order)
        done = term.all(dim=-1) | trunc.any(dim=-1)
        success = self.env.success(new_state)
        fresh = (self.env.reset_from(gen, fresh_rng) if pool is None
                 else self.consume(pool).replace(rng=fresh_rng))
        merged = where_state(done, fresh, new_state)
        obs_state = merged if obs_state is new_state else where_state(done, fresh, obs_state)
        obs = self.observe(obs_state)
        if pool is not None:
            if refresh:
                pool = self._refresh(pool, 1)
            merged = merged.replace(pool=ResetPool(pool.reserve, pool.step + 1, pool.keys))
        return obs, merged, rew, term, trunc, done, success

    def consume(self, pool: ResetPool):
        idx = (self._slots + pool.step) % self.num_envs
        r = pool.reserve
        return self.pool_unpack(r.replace(
            **{f: getattr(r, f).index_select(0, idx) for f in STATE_FIELDS},
            extras={k: v.index_select(0, idx) for k, v in r.extras.items()}))

    def refresh_slots(self, step, chunk: int = 1):
        e = self.num_envs
        count = min(e, -(-e // self.reset_pool_period) * chunk)
        cursor = step if chunk == 1 else step // chunk
        start = (cursor % -(-e // count)) * count
        if isinstance(start, torch.Tensor):
            return start.clamp(max=e - count), count
        return min(start, e - count), count

    def _refresh(self, pool: ResetPool, chunk: int) -> ResetPool:
        start, count = self.refresh_slots(pool.step, chunk)
        if count == self.num_envs:
            fresh = self.env.reset_core(prng.fold_in(pool.keys, pool.step))
            return ResetPool(self.pool_pack(fresh).clone(), pool.step, pool.keys)
        idx = self._slots[:count] + start
        fresh = self.pool_pack(self.env.reset_core(
            prng.fold_in(pool.keys.index_select(0, idx), pool.step)))
        r = pool.reserve

        def put(old, new):
            return old.index_copy(0, idx, new)
        reserve = r.replace(**{f: put(getattr(r, f), getattr(fresh, f)) for f in STATE_FIELDS},
                            extras={k: put(v, fresh.extras[k]) for k, v in r.extras.items()})
        return ResetPool(reserve, pool.step, pool.keys)

    def rollout_random(self, state, key, steps: int):
        """``(state, summary)`` after ``steps`` random steps from ``key``:
        the reward sum (float32), the finished episodes and the
        observations' sum (wrapped to int32)."""
        dev = self.device
        key = prng.as_key(key, dev)
        rew_sum = torch.zeros((), dtype=torch.float32, device=dev)
        episodes = torch.zeros((), dtype=torch.int64, device=dev)
        obs_sum = torch.zeros((), dtype=torch.int64, device=dev)
        chunks = steps // REFRESH_CHUNK if self.reset_pool else 0
        plan = [(REFRESH_CHUNK, False)] * chunks + [(steps - chunks * REFRESH_CHUNK, True)]
        e, n = self.num_envs, self.num_agents
        for count, refresh in plan:
            for _ in range(count):
                key, actions = prng.randint(key, (e, n), 0, NUM_ACTIONS, split_first=True)
                obs, state, rew, _, _, done, _ = self.step(state, actions, refresh=refresh)
                rew_sum = rew_sum + rew.sum()
                episodes = episodes + done.sum()
                obs_sum = obs_sum + obs['image'].sum()
            if not refresh and state.pool is not None:
                state = state.replace(pool=self._refresh(state.pool, count))
        wrapped = (obs_sum + 2**31) % 2**32 - 2**31
        return state, {'reward_sum': rew_sum, 'episodes': episodes.to(torch.int32),
                       'obs_sum': wrapped.to(torch.int32)}
