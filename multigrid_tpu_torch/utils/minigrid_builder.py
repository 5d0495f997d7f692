"""Imperative MiniGrid-style environment authoring.

Counterpart of the JAX package's ``multigrid_tpu/utils/minigrid_builder.py``.
The reference's compat story (multigrid/utils/minigrid_interface.py:12-39)
is "inherit from ``MiniGridInterface`` instead of ``minigrid.MiniGridEnv``
and swap the Grid/WorldObj imports" — ported envs keep their imperative
``_gen_grid(self, width, height)`` bodies that mutate ``self.grid`` and call
``place_obj``/``place_agent``/``_rand_int``.

This module provides that surface over the dense-state core: a host-side
numpy :class:`Grid`, lightweight :class:`WorldObj` constructors that encode
to (type, color, state) triples, and :class:`MiniGridCompatEnv`, whose reset
runs the user's imperative generator on the host and uploads the dense
arrays to the env's device in one call. Step dynamics and observations then
run through the batched step and the observation kernel.

Host-side generation means a ported env is for the Gymnasium adapter and
:class:`~multigrid_tpu_torch.utils.minigrid_interface.MiniGridInterface`
(single-env, the reference's usage); under a ``VectorEnv`` every reset runs
the generator once per env on the host — re-implement ``_gen_grid(keys)`` on
the device for batched speed (see envs/empty.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.constants import (
    COLOR_GREEN,
    COLOR_GREY,
    COLOR_RED,
    EMPTY_ENCODING,
    STATE_CLOSED,
    STATE_LOCKED,
    STATE_OPEN,
    TYPE_BALL,
    TYPE_BOX,
    TYPE_DOOR,
    TYPE_EMPTY,
    TYPE_FLOOR,
    TYPE_GOAL,
    TYPE_KEY,
    TYPE_LAVA,
    TYPE_UNSEEN,
    TYPE_WALL,
    Color,
)
from ..core.state import MultiGridState, state_from_arrays
from ..envs import layout
from ..envs.env import MultiGridEnv
from . import prng



def _color_index(color) -> int:
    """Accept a Color enum member, color-name string, or raw index."""
    if isinstance(color, str):
        return Color(color).to_index() if not color.isdigit() else int(color)
    if isinstance(color, Color):
        return color.to_index()
    return int(color)


class WorldObj:
    """Minimal stand-in for the reference WorldObj hierarchy
    (multigrid/core/world_object.py:66-617): carries only the encoding
    triple — behavior lives in the batched step (ops/step.py)."""

    type_idx: int = TYPE_EMPTY

    def __init__(self, color=COLOR_RED, state: int = 0):
        self.color = _color_index(color)
        self.state = int(state)

    def encode(self) -> np.ndarray:
        return layout.encode(self.type_idx, self.color, self.state)

    def __repr__(self):
        return f'{type(self).__name__}(color={self.color}, state={self.state})'


class Wall(WorldObj):
    type_idx = TYPE_WALL

    def __init__(self, color=COLOR_GREY):
        super().__init__(color)


class Floor(WorldObj):
    type_idx = TYPE_FLOOR

    def __init__(self, color='blue'):
        super().__init__(color)


class Goal(WorldObj):
    type_idx = TYPE_GOAL

    def __init__(self, color=COLOR_GREEN):
        super().__init__(color)


class Lava(WorldObj):
    type_idx = TYPE_LAVA

    def __init__(self):
        super().__init__(COLOR_RED)


class Key(WorldObj):
    type_idx = TYPE_KEY

    def __init__(self, color='blue'):
        super().__init__(color)


class Ball(WorldObj):
    type_idx = TYPE_BALL

    def __init__(self, color='blue'):
        super().__init__(color)


class Box(WorldObj):
    type_idx = TYPE_BOX

    def __init__(self, color, contains: WorldObj | None = None):
        super().__init__(color)
        self.contains = contains


class Door(WorldObj):
    type_idx = TYPE_DOOR

    def __init__(self, color, is_open: bool = False, is_locked: bool = False):
        state = (
            STATE_LOCKED if is_locked
            else (STATE_OPEN if is_open else STATE_CLOSED)
        )
        super().__init__(color, state)


class Grid:
    """Host-side dense grid with the reference Grid's mutation surface
    (multigrid/core/grid.py:42-195)."""

    def __init__(self, width: int, height: int):
        assert width >= 3 and height >= 3
        self.width = width
        self.height = height
        self.data = layout.empty_grid(width, height)
        self.contents = layout.empty_grid(width, height)  # Box side table

    def set(self, x: int, y: int, obj: WorldObj | None) -> None:
        enc = layout.EMPTY if obj is None else obj.encode()
        self.data[x, y] = enc
        if isinstance(obj, Box) and obj.contains is not None:
            self.contents[x, y] = obj.contains.encode()
        else:
            self.contents[x, y] = layout.EMPTY

    def get(self, x: int, y: int) -> np.ndarray | None:
        enc = self.data[x, y]
        return None if enc[0] == TYPE_EMPTY else enc.copy()

    def horz_wall(self, x: int, y: int, length: int | None = None,
                  obj_type=Wall) -> None:
        layout.horz_wall(self.data, x, y, length, cell=obj_type().encode())

    def vert_wall(self, x: int, y: int, length: int | None = None,
                  obj_type=Wall) -> None:
        layout.vert_wall(self.data, x, y, length, cell=obj_type().encode())

    def wall_rect(self, x: int, y: int, w: int, h: int) -> None:
        layout.wall_rect(self.data, x, y, w, h)

    def encode(self, vis_mask: np.ndarray | None = None) -> np.ndarray:
        """(W, H, 3) int encoding; invisible cells become ``unseen``
        (multigrid/core/grid.py:310-325 — note the reference's masked write
        lands on a boolean-indexed *copy* and is a silent no-op; this
        implements the documented intent, matching Farama minigrid)."""
        enc = self.data.copy()
        if vis_mask is not None:
            enc[~np.asarray(vis_mask, dtype=bool)] = (TYPE_UNSEEN, 0, 0)
        return enc

    @classmethod
    def decode(cls, array: np.ndarray) -> tuple['Grid', np.ndarray]:
        """Encoding → (Grid, vis_mask) (multigrid/core/grid.py:327-347)."""
        array = np.asarray(array)
        width, height, dim = array.shape
        assert dim == 3, f'expected (W, H, 3) encoding, got {array.shape}'
        vis_mask = array[..., 0] != TYPE_UNSEEN
        grid = cls(width, height)
        grid.data[vis_mask] = array[vis_mask]
        return grid, vis_mask

    def slice(self, top_x: int, top_y: int, width: int, height: int) -> 'Grid':
        """Rectangular sub-grid; out-of-bounds cells read as walls (the
        Farama minigrid ``Grid.slice`` contract used by ported envs)."""
        out = Grid(width, height)
        for i in range(width):
            for j in range(height):
                x, y = top_x + i, top_y + j
                if 0 <= x < self.width and 0 <= y < self.height:
                    out.data[i, j] = self.data[x, y]
                    out.contents[i, j] = self.contents[x, y]
                else:
                    out.data[i, j] = Wall().encode()
        return out


class MiniGridCompatEnv(MultiGridEnv):
    """Base class for ported single-agent MiniGrid environments.

    Subclasses keep their imperative ``_gen_grid(self, width, height)``
    (overriding the batched ``_gen_grid(keys)`` slot — this
    class bridges in :meth:`reset_core`), their ``_rand_*`` calls, and their
    ``place_obj``/``put_obj``/``place_agent`` calls, exactly as written
    against ``minigrid.MiniGridEnv``.
    """

    #: Layouts are built on the host (:meth:`reset_core`), so resets and
    #: vector envs over this env run eagerly.
    host_reset = True

    def __init__(self, mission_space=None, **kwargs):
        kwargs.setdefault('agents', 1)
        super().__init__(**kwargs)
        if mission_space is not None:
            self._mission_space = mission_space
        self._np_random = np.random.default_rng()
        self.grid: Grid | None = None
        self._build_agent_pos: np.ndarray | None = None
        self._build_agent_dir: int | None = None

    # ------------------------------------------------ minigrid RNG helpers
    # (multigrid/utils/random.py:9-103)

    @property
    def np_random(self) -> np.random.Generator:
        return self._np_random

    def _rand_int(self, low: int, high: int) -> int:
        return int(self._np_random.integers(low, high))

    def _rand_float(self, low: float, high: float) -> float:
        return float(self._np_random.uniform(low, high))

    def _rand_bool(self) -> bool:
        return bool(self._np_random.integers(0, 2))

    def _rand_elem(self, iterable):
        lst = list(iterable)
        return lst[self._rand_int(0, len(lst))]

    def _rand_subset(self, iterable, num_elems: int):
        lst = list(iterable)
        out = []
        while len(out) < num_elems:
            elem = self._rand_elem(lst)
            lst.remove(elem)
            out.append(elem)
        return out

    def _rand_perm(self, iterable):
        lst = list(iterable)
        self._np_random.shuffle(lst)
        return lst

    def _rand_color(self) -> str:
        # The reference returns a Color member (utils/random.py:85-91) whose
        # str-mixin renders as the bare name in f-strings; the stdlib enum
        # renders 'Color.red', so return the plain name — ported envs embed
        # it in mission text ("pick up the {color} ball") and WorldObj
        # constructors accept names.
        return self._rand_elem(Color).value

    def _rand_pos(self, x_low, x_high, y_low, y_high):
        return (self._rand_int(x_low, x_high), self._rand_int(y_low, y_high))

    # ------------------------------------------- imperative build helpers
    # (multigrid/base.py:604-697)

    def put_obj(self, obj: WorldObj, x: int, y: int) -> None:
        self.grid.set(x, y, obj)

    def place_obj(self, obj: WorldObj | None = None, top=None, size=None,
                  reject_fn=None, max_tries: float = math.inf):
        """Rejection-sample an empty position (base.py:604-670)."""
        top = (0, 0) if top is None else (max(top[0], 0), max(top[1], 0))
        size = (self.grid.width, self.grid.height) if size is None else size
        tries = 0
        while True:
            if tries > max_tries:
                raise RecursionError('rejection sampling failed in place_obj')
            tries += 1
            x = self._rand_int(top[0], min(top[0] + size[0], self.grid.width))
            y = self._rand_int(top[1], min(top[1] + size[1], self.grid.height))
            if self.grid.data[x, y, 0] != TYPE_EMPTY:
                continue
            if (self._build_agent_pos is not None
                    and np.array_equal(self._build_agent_pos, (x, y))):
                continue
            if reject_fn is not None and reject_fn(self, (x, y)):
                continue
            break
        if obj is not None:
            self.grid.set(x, y, obj)
        return (x, y)

    def place_agent(self, top=None, size=None, rand_dir: bool = True,
                    max_tries: float = math.inf):
        """Place the (single) agent (base.py:680-697)."""
        self._build_agent_pos = None
        pos = self.place_obj(None, top, size, max_tries=max_tries)
        self._build_agent_pos = np.asarray(pos, dtype=np.int32)
        if rand_dir or self._build_agent_dir is None:
            self._build_agent_dir = self._rand_int(0, 4)
        return pos

    # ---------------------------------------------------- batched bridge

    def build_layout(self, np_random: np.random.Generator) -> dict[str, np.ndarray]:
        """One layout from the user's imperative ``_gen_grid(width,
        height)``, drawing from ``np_random``: the numpy arrays ``grid``,
        ``box_contents``, ``agent_pos`` (1, 2) and ``agent_dir`` (1,)."""
        self._np_random = np_random
        self.grid = None
        self._build_agent_pos = None
        self._build_agent_dir = None
        self._gen_grid(self.cfg.width, self.cfg.height)
        assert self.grid is not None, '_gen_grid must set self.grid'
        assert self._build_agent_pos is not None, (
            '_gen_grid must call place_agent (or set agent_pos)')
        return dict(grid=self.grid.data.copy(), box_contents=self.grid.contents.copy(),
                    agent_pos=self._build_agent_pos.reshape(1, 2),
                    agent_dir=np.asarray([self._build_agent_dir], dtype=np.int32))

    def reset_core(self, keys) -> MultiGridState:
        """Host-side generation: one numpy stream per env, seeded with its
        key's two words, its state's ``rng`` the second key of
        ``split(key)``, as the JAX package's (minigrid_builder.py:319-338)."""
        keys = self.keys(keys)
        return self.reset_from(keys, prng.split(keys)[:, 1])

    def reset_from(self, gen_keys, rngs) -> MultiGridState:
        """:meth:`build_layout` for each env from a numpy stream seeded
        with the two words of its key of ``gen_keys``, ``rngs`` the states'
        keys; the stacked arrays uploaded in one ``state_from_arrays``
        call."""
        words = gen_keys.tolist()
        rows = [self.build_layout(np.random.default_rng([int(w) for w in k])) for k in words]
        e = len(words)
        empty = np.broadcast_to(EMPTY_ENCODING, (e, 1, 3))
        fields = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        return state_from_arrays(dict(
            **fields,
            agent_color=np.zeros((e, 1), np.int32),
            agent_terminated=np.zeros((e, 1), bool),
            agent_carrying=empty,
            agent_carrying_contents=empty,
            step_count=np.zeros((e,), np.int32),
            rng=prng.key_data(rngs),
        ), self.device)


    def mission_of(self, state: MultiGridState, env: int = 0) -> str | None:
        return getattr(self, 'mission', None) or type(self).mission

    @property
    def mission_space(self):
        if getattr(self, '_mission_space', None) is not None:
            return self._mission_space
        return MultiGridEnv.mission_space.fget(self)

    # The batched `_gen_grid(keys)` slot is intentionally NOT
    # implemented: subclasses override `_gen_grid(self, width, height)`
    # imperatively, and `build_layout` above calls it with (width, height).
    # If something calls the batched form on a compat env, fail loudly.
    def _gen_grid(self, *args):  # pragma: no cover - overridden by subclass
        raise NotImplementedError(
            'MiniGridCompatEnv subclasses must define '
            '_gen_grid(self, width, height)')
