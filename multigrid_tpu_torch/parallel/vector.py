"""Lockstep batched environments with auto-reset on the device.

``VectorEnv`` runs ``num_envs`` instances of a
:class:`~multigrid_tpu_torch.envs.env.MultiGridEnv` in lockstep on one
device. Whenever an env is done (all agents terminated, or truncated —
multigrid/base.py:534-539), a fresh layout is swapped in with a per-env
select (on the card, one launch of the reset-merge kernel that writes only
the finished envs' rows, :mod:`~multigrid_tpu_torch.ops.merge_cuda`), so
stepping never leaves the device.

Procedurally generated layouts (``env.procedural_reset``: the RoomGrid
families and RedBlueDoors) go through the reserve pool by default, as in
the JAX package (multigrid_tpu/parallel/vector.py:199-470): each env slot
holds one pregenerated layout, a finished env takes slot ``(i + g) mod E``
at global step ``g``, and a rotating slice of slots is regenerated each
step or, in rollout loops, once a chunk of steps.

Randomness comes from threefry2x32 keys, as in the JAX package
(:mod:`~multigrid_tpu_torch.utils.prng`): :meth:`reset` splits its key
into one key an env (``split(key, E)``, vector.py:186-191) and the pool's;
each step splits every env's ``state.rng`` for its agents' order and folds
it for the auto-reset (vector.py:377-411); a reserve slot is regenerated
from ``fold_in(slot key, g)`` (vector.py:265-320); the random rollout draws
its actions from the key it is given (vector.py:531-551). The streams are
the JAX package's, bit for bit: the same key gives the same states.

On the card :meth:`step` and :meth:`rollout_random` replay CUDA graphs
(:mod:`~multigrid_tpu_torch.utils.graphs`), as the JAX package jits them:
a step is one graph (the caller's state copied in, the results cloned
out), a random rollout one graph of :attr:`REFRESH_CHUNK` steps and a pool
refresh replayed chunk after chunk on the device, then a one-step graph
for the rest. The pool's global step lives on the device, so that every
replay reads its own. The results are bit-equal to the eager loop's from
the same keys, which runs on the CPU, inside
:func:`~multigrid_tpu_torch.utils.graphs.disable_graphs`, for an env
whose reset runs on the host (``env.host_reset``) and under a mesh over
gloo (whose collectives run on the host).

Under a process mesh (``mesh=``, :mod:`~multigrid_tpu_torch.parallel.mesh`)
``num_envs`` is the global batch and each process steps its own rows. Each
process makes only its own rows' draws over the env axis (``rows=`` of the
global draw: its envs' keys, its random actions), so a sharded run's envs
are the unsharded run's, bit for bit, as the JAX package's partitionable
threefry computes each device's rows alone. The reserve pool is sharded
over the env axis as the JAX package places it (``P('env')`` on the whole
state, vector.py:180-183): a process holds the slots of its own rows and
their keys, and a finished env takes slot ``(i + g) mod E`` of the global
reserve through a barrel shift of the packed rows between the env shards
(:meth:`VectorEnv.consume`). Under NCCL every process replays the same
graphs (:attr:`capture_group` checks their keys at the capture); the
rollout's summary is summed over the processes after the replays.

Under the stage counters (:mod:`~multigrid_tpu_torch.utils.profiling`) a
step marks its stages on the device: ``draws.actions`` (the random
rollout's actions), ``draws.step``, ``dynamics``, ``reset``, ``merge``,
``observe``, ``pool`` and the rollout's ``summary``, and counts the fresh
layouts made (``layouts.made``: each exact reset's, each refresh's slots)
and those taken by finished envs (``layouts.used``).

The reserve is stored bit-packed, as the JAX package stores it
(vector.py:199-240, ``_pool_pack``): each slot's grid is one int32 plane
of ``W·H`` cells ``type<<8 | color<<4 | state``, a Box's contents in bits
12–23 of the same cell (:meth:`VectorEnv.pool_pack`), so that a consume
reads 4 bytes a cell in place of 12 or 24.
"""

from __future__ import annotations

import math

import torch

from ..core.actions import NUM_ACTIONS
from ..core.constants import Color, State, Type
from ..core.state import STATE_FIELDS, MultiGridState, ResetPool, where_state
from ..envs.env import MultiGridEnv
from ..ops import merge_cuda
from ..ops.obs_cuda import gen_obs_batched
from ..utils import graphs, prng, profiling
from ..utils.device import constant, resolve_device
from . import distributed
from .mesh import Mesh, env_peer, env_rows, make_mesh, shard_batch


#: The bit offsets of a packed cell's type, color and state
#: (``type<<8 | color<<4 | state``).
_LANES = [8, 4, 0]


def _row_parts(state: MultiGridState) -> list[torch.Tensor]:
    return [getattr(state, f) for f in STATE_FIELDS] + [
        state.extras[k] for k in sorted(state.extras)]


def _row_width(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:]) * (2 if t.dtype == torch.int64 else 1)


def _rows(state: MultiGridState) -> torch.Tensor:
    """A batch of reserve slots as one int32 row a slot: every field and
    extra flattened (booleans as 0/1, int64 keys as their two words), in
    :data:`STATE_FIELDS` order, then the extras by name."""
    def cols(t):
        t = t.contiguous().reshape(t.shape[0], math.prod(t.shape[1:]))
        return t.view(torch.int32) if t.dtype == torch.int64 else t.to(torch.int32)
    return torch.cat([cols(t) for t in _row_parts(state)], dim=1)


def _from_rows(rows: torch.Tensor, like: MultiGridState) -> MultiGridState:
    """The inverse of :func:`_rows`, the fields' shapes and types from
    ``like``."""
    out, i = [], 0
    for t in _row_parts(like):
        c = rows[:, i:i + _row_width(t)]
        i += _row_width(t)
        if t.dtype == torch.int64:
            c = c.contiguous().view(torch.int64)
        out.append(c.reshape((rows.shape[0],) + t.shape[1:]).to(t.dtype))
    fields = dict(zip(STATE_FIELDS, out))
    return like.replace(**fields, extras=dict(zip(sorted(like.extras), out[len(fields):])))


class VectorEnv:
    """``num_envs`` lockstep copies of an environment.

    Usage::

        venv = VectorEnv(make('MultiGrid-Empty-8x8-v0', agents=2), 4096)
        obs, state = venv.reset(prng.key(0))   # or reset(seed=0)
        obs, state, rew, term, trunc, done, success = venv.step(state, actions)

    All returned tensors have a leading ``(num_envs, ...)`` axis. ``done``
    is ``(num_envs,)`` — True where the *previous* episode ended this step
    and the returned obs/state belong to a fresh episode; the rewards and
    terminations are the ending episode's. ``success`` is ``(num_envs,)`` —
    :meth:`MultiGridEnv.success` on the final *pre-reset* state.

    ``auto_reset=False`` leaves a finished env as it ended. ``reset_pool``
    (None: ``env.procedural_reset``; only with ``auto_reset``) resets
    finished envs from the reserve pool instead of an exact reset of every
    env each step; ``reset_pool_period`` (None: ``min(128, max_steps)``) is
    the number of steps in which every slot is regenerated.

    ``device=None`` takes the env's device (which itself defaults to the
    card); another device than the env's is an error.

    ``packed_obs=True`` gives images as the obs kernel's packed int32 cells
    ``type<<8 | color<<4 | state`` on a flat ``(E, N, vs·vs)`` cell axis
    (the training format: a third of the triples' bytes), bit-equal to the
    JAX package's ``VectorEnv(packed_obs=True)``.

    ``mesh`` shards the env axis over its processes: ``num_envs`` is the
    global batch, which the env shards must divide, and the returned
    tensors hold this process's :attr:`local_envs` rows (:attr:`rows` of
    the global batch).
    """

    #: Steps a rollout loop runs with ``refresh=False`` before one
    #: :meth:`refresh_pool` (vector.py:529).
    REFRESH_CHUNK = 16

    def __init__(
        self,
        env: MultiGridEnv,
        num_envs: int,
        *,
        auto_reset: bool = True,
        reset_pool: bool | None = None,
        reset_pool_period: int | None = None,
        packed_obs: bool = False,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ):
        if packed_obs:
            # Observation wrappers work on (vs, vs, 3) channel triples, so
            # only an unwrapped env packs; 4-bit fields bound colors and states.
            if type(env).transform_obs is not MultiGridEnv.transform_obs:
                raise ValueError('packed_obs requires an unwrapped env '
                                 '(observation wrappers take channel triples)')
            if len(Color) > 16 or len(State) > 16:
                raise ValueError('packed_obs packs colors and states into 4 bits')
        if device is not None and resolve_device(device) != env.device:
            raise ValueError(
                f'VectorEnv on {device} needs an env on it, not on {env.device}')
        if reset_pool is None:
            reset_pool = env.procedural_reset
        if reset_pool_period is None:
            # The longest period with no replay for episodes of at least
            # ``period`` steps, capped so that early-terminating envs do
            # not grow stale (vector.py:102-110).
            reset_pool_period = min(128, max(1, env.cfg.max_steps))
        if reset_pool_period < 1:
            raise ValueError(f'reset_pool_period must be at least 1, not {reset_pool_period}')
        self.env = env
        self.num_envs = num_envs
        self.device = env.device
        self.packed_obs = packed_obs
        self.auto_reset = auto_reset
        self.reset_pool = bool(reset_pool) and auto_reset
        self.reset_pool_period = reset_pool_period
        self.mesh = mesh
        #: This process's rows of the global batch (all of it without a mesh).
        self.rows = slice(0, num_envs) if mesh is None else env_rows(num_envs, mesh)
        self.local_envs = self.rows.stop - self.rows.start
        #: The processes that capture this env's graphs together: the
        #: mesh's (None in one process).
        self.capture_group = None if mesh is None else mesh.mesh_group
        #: Whether the reserve is stored bit-packed (:meth:`pool_pack`):
        #: every field fits its 4-bit lane (vector.py:97-104).
        self.pool_packed = len(Color) <= 16 and len(State) <= 16 and len(Type) <= 16
        # The env axis's group, over which the reserve's rows move to the
        # envs that consume them (None: the whole reserve is here), and the
        # barrel shift's peers (:meth:`_window`): stage b receives from the
        # shard 2^b after this one, the last stage from the next shard.
        self._pool_group = None if mesh is None else mesh.group
        self._shifts = [] if self._pool_group is None else [
            (env_peer(mesh, s), env_peer(mesh, -s))
            for s in [2 ** b for b in range((mesh.env_shards - 1).bit_length())] + [1]]
        # This process's envs' indices in the global batch, and slot offsets.
        self._envs = torch.arange(self.rows.start, self.rows.stop, device=self.device)
        self._slots = torch.arange(num_envs, device=self.device)
        #: Captured graphs by signature (:func:`graphs.call`).
        self._graphs: dict = {}

    @classmethod
    def sharded(cls, env: MultiGridEnv, num_envs: int, **kwargs) -> 'VectorEnv':
        """A VectorEnv over every process of the run (env axis = the whole
        mesh)."""
        return cls(env, num_envs, mesh=make_mesh(), **kwargs)

    @property
    def num_agents(self) -> int:
        return self.env.num_agents

    def local(self, tree):
        """This process's rows of a global ``(E, ...)`` tensor or state; the
        tree itself without a mesh of several env shards."""
        if self.local_envs == self.num_envs:
            return tree
        return shard_batch(tree, self.mesh)

    def reset(self, key=None, *, seed: int | None = None):
        """Reset all envs from ``key`` (a key, or an int seed; ``seed=`` is
        ``key(seed)``, the default ``key(0)``): ``key, pool_key =
        split(key)``, env ``i`` from key ``i`` of ``split(key, E)`` (this
        process's rows only), then, where the pool is on, the reserve from
        ``pool_key`` (vector.py:186-196, 265-280). Returns ``(obs, state)``."""
        if key is None:
            key = 0 if seed is None else seed
        with profiling.trace_annotation('mgt.reset'):
            key, pool_key = prng.split(prng.as_key(key, self.device)).unbind(0)
            state = self.env.reset_core(prng.split(key, self.num_envs, rows=self.rows)).clone()
            if self.reset_pool:
                state = state.replace(pool=self.new_pool(pool_key))
            return self.observe(state), state

    def new_pool(self, key: torch.Tensor) -> ResetPool:
        """The reserve pool drawn from ``key``: ``k_res, k_stream =
        split(key)``, slot ``i`` from key ``i`` of ``split(k_res, E)`` and
        its key stream key ``i`` of ``split(k_stream, E)`` (vector.py:265-280),
        packed (:meth:`pool_pack`), the global step 0. Under a mesh this
        process draws only the slots of its rows."""
        with profiling.trace_annotation('mgt.pool.new'):
            k_res, k_stream = prng.split(key).unbind(0)
            reserve = self.env.reset_core(prng.split(k_res, self.num_envs, rows=self.rows))
            return ResetPool(self.pool_pack(reserve).clone(), 0,
                             prng.split(k_stream, self.num_envs, rows=self.rows))

    def pool_pack(self, state: MultiGridState) -> MultiGridState:
        """The reserve's storage form of a batch of layouts (vector.py:209-222):
        ``grid`` one int32 plane (E, W·H) of ``type<<8 | color<<4 | state``
        and, where the env holds Boxes, their contents' cells in bits 12–23
        of it, ``box_contents`` then zero-sized; the rest as it is. The
        state itself where :attr:`pool_packed` is false."""
        if not self.pool_packed:
            return state
        g = state.grid
        # The fields' bits are disjoint, so a sum is their OR.
        lanes = constant(_LANES, g.device, torch.int32)
        p = (g << lanes).sum(-1, dtype=torch.int32).reshape(g.shape[0], -1)
        if state.box_contents.numel():
            b = state.box_contents
            p = p | ((b << lanes).sum(-1, dtype=torch.int32).reshape(p.shape) << 12)
            state = state.replace(box_contents=b.new_zeros((b.shape[0], 0, 0, 3)))
        return state.replace(grid=p)

    def pool_unpack(self, state: MultiGridState) -> MultiGridState:
        """The inverse of :meth:`pool_pack` (vector.py:224-240): the grid's
        and the Boxes' (W, H, 3) triples of packed layouts, every field of a
        cell in one shift and one mask (two elementwise launches; the two
        triples are views of their result)."""
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

    def graphed(self) -> bool:
        """Whether this env's entry points replay CUDA graphs now: on the
        card, outside ``disable_graphs()``, with a reset that runs on the
        device, and without a mesh or under one whose collectives a graph
        holds (NCCL's; a mesh over gloo runs eagerly,
        :attr:`Mesh.capturable`)."""
        return graphs.graphs_on(self.device) and not self.env.host_reset \
            and (self.mesh is None or self.mesh.capturable)

    def step(self, state: MultiGridState, actions, *, order=None, refresh: bool = True):
        """Step all envs; auto-reset finished episodes.

        ``order`` (E, N) fixes the agents' action order; by default it is
        drawn from each env's ``rng`` (which is split either way).
        Observations are made once, through the
        kernel, on the merged state: finished envs observe their fresh
        layout, running envs their post-action pre-hook state (base.py:337).
        With the pool, ``refresh=False`` skips this step's regeneration of
        reserve slots (the global step still advances); the caller then
        owes one :meth:`refresh_pool` a chunk of such steps.

        Returns ``(obs, state, rewards, terminations, truncations, done,
        success)``. On the card, one graph replay (:meth:`graphed`).
        """
        if self.graphed():
            args = (state, torch.as_tensor(actions, device=self.device),
                    None if order is None else torch.as_tensor(order, device=self.device))
            return graphs.call(self._graphs, ('step', refresh, self.auto_reset), args,
                               lambda a: self._step(*a, refresh=refresh),
                               group=self.capture_group)
        return self._step(state, actions, order, refresh=refresh)

    def _step(self, state: MultiGridState, actions, order=None, *, refresh: bool = True):
        """:meth:`step`'s eager body."""
        pool = state.pool
        obs_state, new_state, rew, term, trunc, done, success, fresh = self.step_dynamics(
            state, actions, order=order)
        if self.auto_reset:
            # The kernel writes the stepped states in place on the card:
            # never the caller's state, nor a tensor this step returns
            # (``term`` is the stepped ``agent_terminated``).
            obs_state, new_state = self.reset_done(
                done, obs_state, new_state, fresh, pool,
                protected=merge_cuda.state_tensors(state) + [rew, term, trunc, done, success])
        obs = self.observe(obs_state)
        if pool is not None:
            new_state = new_state.replace(pool=self.next_pool(pool, refresh))
        return obs, new_state, rew, term, trunc, done, success

    def step_dynamics(self, state: MultiGridState, actions, *, order=None):
        """The first stage of :meth:`step`: every env's step draws (one
        launch of the step-draws kernel on the card: the split of its
        ``rng``, its agents' order and the auto-reset's fresh keys), the
        env's dynamics and hook, and each env's ``done`` and ``success``, on
        the state without its pool. Returns ``(obs_state, new_state,
        rewards, terminations, truncations, done, success, fresh)``, where
        ``fresh`` is ``(gen_key, rng)`` of the episodes an auto-reset would
        start (``gen_key`` None with the pool; both None without
        ``auto_reset``)."""
        mode = (prng.STEP_ONLY if not self.auto_reset
                else prng.STEP_EXACT if state.pool is None else prng.STEP_POOL)
        with profiling.stage('draws.step'):
            drawn, rng, gen, fresh_rng = prng.step_draws(state.rng, self.num_agents, mode)
        with profiling.stage('dynamics'):
            obs_state, new_state, rew, term, trunc = self.env.step_core(
                state.replace(pool=None, rng=rng), actions, drawn if order is None else order)
            done = term.all(dim=-1) | trunc.any(dim=-1)
            # Task completion on the final state, before the reset erases it.
            success = self.env.success(new_state)
        return obs_state, new_state, rew, term, trunc, done, success, (gen, fresh_rng)

    def reset_done(self, done: torch.Tensor, obs_state: MultiGridState,
                   new_state: MultiGridState, fresh, pool: ResetPool | None = None, *,
                   protected: list[torch.Tensor]):
        """The second stage of :meth:`step` (with ``auto_reset``): the fresh
        episodes, kept where ``done``, with their extras (mission, doors)
        and keys (``fresh`` from :meth:`step_dynamics`). From ``pool`` where
        there is one (:meth:`consume`, its slots' keys replaced by the
        folded ones), else one exact reset of this process's envs from
        their keys (the JAX package's ``reset_pool=False``). Returns
        ``(obs_state, state)``.

        On the card one launch of the reset-merge kernel
        (:mod:`~multigrid_tpu_torch.ops.merge_cuda`) writes the finished
        envs' rows, from the packed reserve itself (or this process's
        window of it, or the exact reset), into the stepped states in
        place, except a tensor that shares memory with one of
        ``protected`` (the step's input state and the tensors it returns),
        which it fills anew. On the CPU, the plain version
        (``protected`` unused): :meth:`consume` and
        :func:`~multigrid_tpu_torch.core.state.where_state`."""
        gen, rng = fresh
        card, step = done.device.type == 'cuda', None
        with profiling.stage('reset'):
            if pool is None:
                fresh = self.env.reset_from(gen, rng)
                profiling.count('layouts.made', done.shape[0], done.device)
            elif not card:
                fresh = self.consume(pool).replace(rng=rng)
            elif self._pool_group is not None:
                fresh = self._window(pool)
            else:
                fresh, step = pool.reserve, pool.step
        with profiling.stage('merge'):
            profiling.count('layouts.used', done)
            if card:
                return merge_cuda.reset_merge(
                    done, obs_state, new_state, fresh, rng, step=step,
                    packed=pool is not None and self.pool_packed, inputs=protected)
            merged = where_state(done, fresh, new_state)
            obs_state = merged if obs_state is new_state \
                else where_state(done, fresh, obs_state)
        return obs_state, merged

    def consume(self, pool: ResetPool) -> MultiGridState:
        """The reserve as the envs read it at the pool's step ``g``: env
        ``i`` gets slot ``(i + g) mod E``, so an env never replays the
        layout it just played (vector.py:392-405), ``i`` counting in the
        global batch; unpacked (:meth:`pool_unpack`) after the packed rows
        are gathered. Where the whole reserve is here, one gather a tensor
        at indices computed on the device; under a mesh's env group the
        window crosses the shards (:meth:`_window`)."""
        if self._pool_group is not None:
            return self.pool_unpack(self._window(pool))
        idx = (self._envs + pool.step) % self.num_envs
        r = pool.reserve
        return self.pool_unpack(r.replace(
            **{f: getattr(r, f).index_select(0, idx) for f in STATE_FIELDS},
            extras={k: v.index_select(0, idx) for k, v in r.extras.items()}))

    def _window(self, pool: ResetPool) -> MultiGridState:
        """This process's envs' slots, packed, from a reserve sharded over
        the env group's ``P`` processes of ``L`` slots each. With ``m = g
        mod E``, shard ``q``'s envs read rows ``[o, L)`` of shard ``a = q +
        k`` and rows ``[0, o)`` of shard ``a + 1`` (mod ``P``), ``k = m // L``
        and ``o = m mod L``: ``k`` is reached by a barrel shift of the
        slots' rows (one int32 row a slot, :func:`_rows`), stage ``b``
        taking the rows of the shard ``2^b`` after where bit ``b`` of ``k``
        is set, then one more shift gives shard ``a + 1``, and one gather
        the window. Fixed peers and sizes, every value on the device, so a
        graph holds it; ``(⌈log2 P⌉ + 1)·L`` rows move a step, never the
        global reserve."""
        group, n = self._pool_group, self.local_envs
        m = pool.step % self.num_envs
        k, o = m // n, m % n
        buf = _rows(pool.reserve)
        for b, (src, dst) in enumerate(self._shifts[:-1]):
            got = distributed.shift_rows(buf, group, src, dst)
            buf = torch.where(((k >> b) & 1).bool(), got, buf)
        after = distributed.shift_rows(buf, group, *self._shifts[-1])
        window = torch.cat([buf, after]).index_select(0, self._slots[:n] + o)
        return _from_rows(window, pool.reserve)

    def next_pool(self, pool: ResetPool, refresh: bool = True) -> ResetPool:
        """The last stage of :meth:`step` with a pool: this step's slots
        regenerated where ``refresh``, then the global step advanced."""
        with profiling.stage('pool'):
            if refresh:
                pool = self._refresh(pool, 1)
            return ResetPool(pool.reserve, pool.step + 1, pool.keys)

    def refresh_slots(self, step, chunk: int = 1):
        """``(start, count)`` of the slots a refresh at global step ``step``
        regenerates: ``chunk`` steps' worth, ``min(E, ceil(E / period) ·
        chunk)`` slots from cursor ``step // chunk`` (``step`` itself for
        one step), the last slice clamped to end at ``E`` as
        ``dynamic_slice`` clamps it (vector.py:307-316). ``start`` is an int
        for an int ``step`` and a device tensor for the pool's."""
        e = self.num_envs
        count = min(e, -(-e // self.reset_pool_period) * chunk)
        cursor = step if chunk == 1 else step // chunk
        start = (cursor % -(-e // count)) * count
        if isinstance(start, torch.Tensor):
            return start.clamp(max=e - count), count
        return min(start, e - count), count

    def _refresh(self, pool: ResetPool, chunk: int) -> ResetPool:
        """The pool with ``chunk`` steps' worth of slots regenerated, slot
        ``s`` from ``fold_in(pool.keys[s], g)`` at the pool's step ``g``
        (vector.py:316-320), packed and scattered at indices computed on the
        device; the tensors of ``pool`` are left as they are. A process
        holding ``L`` of the ``E`` slots regenerates a slice of ``min(count,
        L)`` of its own at an offset clamped on the device, and keeps the
        old layout of those outside ``[start, start + count)``."""
        if pool.keys is None:
            raise ValueError('a pool without slot keys cannot be refreshed')
        start, count = self.refresh_slots(pool.step, chunk)
        if count == self.num_envs:
            fresh = self.env.reset_core(prng.fold_in(pool.keys, pool.step))
            profiling.count('layouts.made', pool.keys.shape[0], pool.keys.device)
            return ResetPool(self.pool_pack(fresh).clone(), pool.step, pool.keys)
        n = self.local_envs
        if n == self.num_envs:
            idx = self._slots[:count] + start
        else:
            c = min(count, n)
            idx = self._slots[:c] + (start - self.rows.start).clamp(0, n - c)
        profiling.count('layouts.made', idx.shape[0], idx.device)
        fresh = self.pool_pack(self.env.reset_core(
            prng.fold_in(pool.keys.index_select(0, idx), pool.step)))
        r = pool.reserve
        if n != self.num_envs:
            slot = idx + self.rows.start
            old = r.replace(**{f: getattr(r, f).index_select(0, idx) for f in STATE_FIELDS},
                            extras={k: v.index_select(0, idx) for k, v in r.extras.items()})
            fresh = where_state((slot >= start) & (slot < start + count), fresh, old)

        def put(old, new):
            return old.index_copy(0, idx, new)
        reserve = r.replace(**{f: put(getattr(r, f), getattr(fresh, f)) for f in STATE_FIELDS},
                            extras={k: put(v, fresh.extras[k]) for k, v in r.extras.items()})
        return ResetPool(reserve, pool.step, pool.keys)


    def refresh_pool(self, state: MultiGridState, chunk: int) -> MultiGridState:
        """Regenerate ``chunk`` steps' worth of reserve slots in one burst,
        leaving the global step alone (vector.py:330-344): after ``chunk``
        steps with ``refresh=False`` it keeps the pool's contract (every
        slot regenerated within ``reset_pool_period`` steps) at one reset
        a chunk. A state without a pool is returned as it is."""
        if state.pool is None:
            return state
        with profiling.stage('pool'):
            return state.replace(pool=self._refresh(state.pool, chunk))

    def observe(self, state: MultiGridState):
        """Observations of a batched state, through the kernel wrapper, with
        each env's mission index (E, N) where the env has missions, then the
        env's observation wrappers (``transform_obs``, vector.py:443-444)."""
        cfg = self.env.cfg
        with profiling.stage('observe'):
            image = gen_obs_batched(state, cfg.view_size, cfg.see_through_walls,
                                    self.packed_obs)
            obs = self.env.attach_mission(
                {'image': image, 'direction': state.agent_dir}, state)
            return self.env.transform_obs(obs, state)

    def rollout_random(self, state: MultiGridState, key, steps: int):
        """Advance ``steps`` lockstep steps with uniform-random actions,
        drawn from ``key`` (a key or an int seed) as the JAX package draws
        them: ``key, ak = split(key)``, then ``randint(ak, (E, N))`` a step
        (vector.py:547-553; this process's rows only), the two one draw
        (``split_first``).

        The throughput benchmark core. With the pool, steps run in chunks
        of :attr:`REFRESH_CHUNK` with ``refresh=False``, each followed by
        one :meth:`refresh_pool`; the rest refresh every step
        (vector.py:529-590). Returns ``(state, summary)``: the reward sum
        (float32), the number of finished episodes (int32), and an
        observation checksum that wraps to int32 as the JAX package's
        does, each summed over the mesh's processes. The summary stays on
        the device until read.

        On the card (:meth:`graphed`) the loop replays a graph of one
        chunk, steps carried on the device from replay to replay, and a
        graph of one step for the rest (or every step, without the pool).
        """
        with profiling.trace_annotation('mgt.rollout'):
            return self._rollout(state, key, steps)

    def _rollout(self, state: MultiGridState, key, steps: int):
        """:meth:`rollout_random`'s body."""
        dev = self.device
        carry = (state, prng.as_key(key, dev),
                 (torch.zeros((), dtype=torch.float32, device=dev),
                  torch.zeros((), dtype=torch.int64, device=dev),
                  torch.zeros((), dtype=torch.int64, device=dev)))
        chunk = self.REFRESH_CHUNK
        chunks = steps // chunk if self.reset_pool else 0
        rest = steps - chunks * chunk
        if self.graphed():
            carry = self._rollout_graphed(carry, chunks, rest)
        else:
            for _ in range(chunks):
                carry = self._random_steps(carry, chunk, refresh=False)
            carry = self._random_steps(carry, rest, refresh=True)
        state, _, (rew_sum, episodes, obs_sum) = carry
        if self.mesh is not None:
            group = self.mesh.group
            rew_sum = distributed.all_reduce(rew_sum, group)
            counts = distributed.all_reduce(torch.stack([episodes, obs_sum]), group)
            episodes, obs_sum = counts[0], counts[1]
        wrapped = (obs_sum + 2**31) % 2**32 - 2**31
        return state, {
            'reward_sum': rew_sum,
            'episodes': episodes.to(torch.int32),
            'obs_sum': wrapped.to(torch.int32),
        }

    def _random_steps(self, carry, steps: int, *, refresh: bool):
        """``steps`` random steps from ``carry`` = ``(state, key, (reward
        sum, episodes, obs sum))``, then, with ``refresh=False``, one
        :meth:`refresh_pool` of them: the body of :meth:`rollout_random`."""
        state, key, (rew_sum, episodes, obs_sum) = carry
        e, n = self.num_envs, self.num_agents
        for _ in range(steps):
            with profiling.stage('draws.actions'):
                key, actions = prng.randint(key, (e, n), 0, NUM_ACTIONS, rows=self.rows,
                                            split_first=True)
            obs, state, rew, _, _, done, _ = self._step(state, actions, refresh=refresh)
            with profiling.stage('summary'):
                rew_sum = rew_sum + rew.sum()
                episodes = episodes + done.sum()
                obs_sum = obs_sum + obs['image'].sum()
        if not refresh:
            state = self.refresh_pool(state, steps)
        return state, key, (rew_sum, episodes, obs_sum)

    def _rollout_graphed(self, carry, chunks: int, rest: int):
        """:meth:`rollout_random`'s loop as replays of two carry graphs on
        one set of buffers: a chunk (``refresh=False``) and one step."""
        key = ('rollout', self.auto_reset, graphs.signature(carry), profiling.counting())
        if key not in self._graphs:
            self._graphs[key] = (graphs.clone(carry), {})
        buffers, by_refresh = self._graphs[key]
        graphs.load(buffers, carry)
        for refresh, replays in ((False, chunks), (True, rest)):
            if not replays:
                continue
            if refresh not in by_refresh:
                steps = 1 if refresh else self.REFRESH_CHUNK
                by_refresh[refresh] = graphs.Graph(
                    lambda c, k=steps, r=refresh: (self._random_steps(c, k, refresh=r), None),
                    buffers, carry=True, group=self.capture_group, key=key + (refresh,))
            for _ in range(replays):
                by_refresh[refresh].replay()
        return graphs.clone(buffers)
