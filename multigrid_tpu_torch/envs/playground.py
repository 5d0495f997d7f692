"""Playground environment (reference: multigrid/envs/playground.py:8).

A 3×3 room lattice connected by randomly placed doors (``connect_all``) and
strewn with random objects. No rewards; truncation-only termination.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import (
    NUM_BASE_COLORS,
    STATE_CLOSED,
    TYPE_DOOR,
    TYPE_EMPTY,
    TYPE_KEY,
)
from ..core.state import MultiGridState
from . import layout
from ..ops.place import argmax_bits
from ..utils import prng
from .roomgrid import RoomGrid, front_ok_mask, next_to_agent_mask


class PlaygroundEnv(RoomGrid):
    """Rooms, random doors, random objects, no goals
    (envs/playground.py:52-137). Registered: ``MultiGrid-Playground-v0``.
    """

    mission = ""

    def __init__(
        self,
        room_size: int = 7,
        num_rows: int = 3,
        num_cols: int = 3,
        max_steps: int = 100,
        **kwargs,
    ):
        super().__init__(room_size=room_size, num_rows=num_rows, num_cols=num_cols,
                         max_steps=max_steps, **kwargs)
        self._tables = None

    # ------------------------------------------------------- batched gen

    def _slot_tables(self):
        """Static tables for connect_all: interior walls and door slots.

        Every interior wall gets an id; a door proposal on wall ``w`` at
        offset ``o`` maps to slot ``w * (room_size - 2) + (o - 1)``, whose
        grid cell is a fixed position. Returns ``(wall_id (C, R, 4), slot
        positions (S, 2), number of walls)``.
        """
        geom = self.geometry
        C, R, rs = geom.num_cols, geom.num_rows, geom.room_size
        wall_id = np.full((C, R, 4), -1, dtype=np.int32)
        positions = []
        wid = 0
        for c in range(C):
            for r in range(R):
                for d, (nc, nr) in ((0, (c + 1, r)), (1, (c, r + 1))):
                    if not geom.has_neighbor(c, r, d):
                        continue
                    wall_id[c, r, d] = wid
                    wall_id[nc, nr, (d + 2) % 4] = wid
                    top = geom.room_top(c, r)
                    for off in range(1, rs - 1):
                        if d == 0:       # right wall
                            positions.append((top[0] + rs - 1, top[1] + off))
                        else:            # bottom wall
                            positions.append((top[0] + off, top[1] + rs - 1))
                    wid += 1
        return wall_id, np.asarray(positions, dtype=np.int32), wid

    def _device_tables(self):
        """The slot tables and each wall's (C, R, 4) edge pair, on the
        device, made once."""
        if self._tables is None:
            geom = self.geometry
            wall_id, slot_pos, num_walls = self._slot_tables()
            edges = np.zeros((num_walls, geom.num_cols * geom.num_rows * 4), np.float32)
            for flat, w in enumerate(wall_id.reshape(-1)):
                if w >= 0:
                    edges[w, flat] = 1.0
            dev = self.device
            self._tables = dict(
                wall_id=torch.as_tensor(wall_id, device=dev).long(),
                slot_x=torch.as_tensor(slot_pos[:, 0], device=dev).long(),
                slot_y=torch.as_tensor(slot_pos[:, 1], device=dev).long(),
                num_walls=num_walls,
                edges=torch.as_tensor(edges, device=dev))
        return self._tables

    def _connect_all_device(self, grid: torch.Tensor, keys: torch.Tensor,
                            max_itrs: int = 256) -> torch.Tensor:
        """Batched ``connect_all`` (core/roomgrid.py:406-452): keep adding
        doors between random room pairs until every room is reachable from
        room (0, 0).

        No loop over proposals and no host sync. The sequential rule
        ("accept proposal k iff its wall is fresh and the rooms are not yet
        all connected by proposals < k") is recovered from batched draws:
        connectivity only grows with the door set, so reachability is
        evaluated for the door set after each count of accepted walls at
        once, the first count that connects everything found, and proposal
        k accepted iff it is a fresh wall of rank at most that count.
        Accepted doors land through the fixed per-wall slots.
        """
        geom = self.geometry
        C, R, rs = geom.num_cols, geom.num_rows, geom.room_size
        e, K, dev = grid.shape[0], max_itrs, grid.device
        tab = self._device_tables()
        num_walls, offs = tab['num_walls'], rs - 2

        # The proposals' draws, each from a key of split(keys, 5)
        # (playground.py:124-129).
        k = prng.split(keys, 5)
        cols = prng.randint(k[:, 0], (K,), 0, C).long()
        rows = prng.randint(k[:, 1], (K,), 0, R).long()
        ds = prng.randint(k[:, 2], (K,), 0, 4).long()
        colors = prng.randint(k[:, 3], (K,), 0, NUM_BASE_COLORS)
        offsets = prng.randint(k[:, 4], (K,), 1, rs - 1)

        wid = tab['wall_id'][cols, rows, ds]                      # (E, K), -1: no wall
        # The first proposal of each wall wins (later ones find a door).
        occ = torch.arange(num_walls, device=dev) == wid[..., None]   # (E, K, walls)
        fresh = occ & (occ.cumsum(1) == 1)
        valid = fresh.any(-1)                                      # (E, K)
        rank = valid.cumsum(1)                                     # (E, K), 1-based
        # Each wall's acceptance rank (num_walls + 1 if never proposed).
        wall_rank = torch.where(fresh, rank[..., None], 0).sum(1)
        wall_rank = torch.where(wall_rank == 0, num_walls + 1, wall_rank)
        # The door set after the first w accepted walls, w = 0..num_walls.
        w1 = num_walls + 1
        incl = wall_rank[:, None, :] <= torch.arange(w1, device=dev)[:, None]  # (E, W1, walls)
        doors = (incl.float() @ tab['edges']).reshape(e, w1, C, R, 4) > 0

        reach = torch.zeros((e, w1, C, R), dtype=torch.bool, device=dev)
        reach[:, :, 0, 0].fill_(True)
        pad = torch.nn.functional.pad
        for _ in range(C * R - 1):
            reach = (reach
                     | pad((reach & doors[..., 0])[:, :, :-1, :], (0, 0, 1, 0))
                     | pad((reach & doors[..., 1])[:, :, :, :-1], (1, 0))
                     | pad((reach & doors[..., 2])[:, :, 1:, :], (0, 0, 0, 1))
                     | pad((reach & doors[..., 3])[:, :, :, 1:], (0, 1)))
        connected = reach.flatten(2).all(-1)                       # (E, W1)
        # The least wall count that connects every room; past the proposal
        # cap (a wall door-less after 256 proposals has p ~ 5e-7; the
        # reference raises after 5000 tries), every valid proposal.
        wstar = torch.where(connected.any(-1), connected.to(torch.int8).argmax(-1),
                            num_walls)
        accepted = valid & (rank <= wstar[:, None])

        # Accepted walls are distinct, so their slots are too.
        slot = torch.where(accepted, wid * offs + (offsets - 1).long(), 0)
        slot_vals = torch.zeros((e, num_walls * offs), dtype=torch.int32, device=dev)
        slot_vals.scatter_add_(1, slot, torch.where(accepted, colors + 1, 0))
        cells = grid[:, tab['slot_x'], tab['slot_y']]              # (E, S, 3)
        door = torch.stack([torch.full_like(slot_vals, TYPE_DOOR), slot_vals - 1,
                            torch.full_like(slot_vals, STATE_CLOSED)], -1)
        grid = grid.clone(memory_format=torch.contiguous_format)
        grid[:, tab['slot_x'], tab['slot_y']] = torch.where(
            (slot_vals > 0)[..., None], door, cells)
        return grid

    def _gen_grid(self, keys: torch.Tensor) -> MultiGridState:
        """Batched layouts (envs/playground.py:121-137): connect all rooms,
        scatter 12 random objects, place agents anywhere with the front-cell
        retry. Each placement is uniform over its valid cells, as the
        reference's rejection loops are; the valid set is kept as one mask
        that each placement takes its cell out of. The draws are the JAX
        package's, from the same splits of each env's key
        (playground.py:249-335)."""
        geom, cfg, dev, e = self.geometry, self.cfg, self.device, keys.shape[0]
        rs, W, H = geom.room_size, cfg.width, cfg.height
        k_connect, k_objs, k_agents = prng.split(keys, 3).unbind(1)

        state = self._init_room_state(e)
        grid = self._connect_all_device(state.grid, k_connect)

        # The 12 objects' draws (playground.py:130-133).
        kc, kr, kk, kcol, kp = prng.split(k_objs, 5).unbind(1)
        cols = prng.randint(kc, (12,), 0, geom.num_cols)
        rows = prng.randint(kr, (12,), 0, geom.num_rows)
        kinds = TYPE_KEY + prng.randint(kk, (12,), 0, 3)
        colors = prng.randint(kcol, (12,), 0, NUM_BASE_COLORS)
        prio = prng.bits(kp, (12, W, H)).reshape(e, 12, W * H)
        gx = torch.arange(W, device=dev)[None, None, :, None]
        gy = torch.arange(H, device=dev)[None, None, None, :]

        def rooms(c, r):  # (E, K, W, H) masks of the rooms at (c, r)
            tx, ty = (c * (rs - 1))[..., None, None], (r * (rs - 1))[..., None, None]
            return (gx >= tx) & (gx < tx + rs) & (gy >= ty) & (gy < ty + rs)

        rect = rooms(cols, rows).reshape(e, 12, W * H)
        # Empty, not next to an agent (agents wait at the middle room's
        # center while objects are placed).
        valid = ((grid[..., 0] == TYPE_EMPTY)
                 & ~next_to_agent_mask(state.agent_pos, W, H)).reshape(e, W * H)
        placed = torch.zeros((e, W * H), dtype=torch.int32, device=dev)  # kind<<4|color, +1
        iota = torch.arange(W * H, device=dev)
        for i in range(12):
            pick = argmax_bits(prio[:, i], valid & rect[:, i])
            oh = iota == pick[:, None]
            placed = torch.where(oh, ((kinds[:, i] << 4) | colors[:, i])[:, None] + 1, placed)
            valid = valid & ~oh
        obj = torch.stack([(placed - 1) >> 4, (placed - 1) & 15, torch.zeros_like(placed)], -1)
        grid = torch.where((placed > 0)[..., None], obj, grid.reshape(e, W * H, 3)) \
            .reshape(e, W, H, 3)

        # Agents: a random room each, then uniform over its valid (cell,
        # direction) pairs with the front-cell predicate
        # (core/roomgrid.py:373-404). Placed agents, and the middle cell
        # where the agents not yet placed wait, block cells.
        n = cfg.num_agents
        kar, kap = prng.split(k_agents).unbind(1)
        room = prng.randint(kar, (n, 2), 0, [geom.num_cols, geom.num_rows])
        acols, arows = room[..., 0], room[..., 1]
        aprio = prng.bits(kap, (n, W, H, 4)).reshape(e, n, W * H * 4)
        front = front_ok_mask(grid).reshape(e, W * H, 4)
        arect = rooms(acols, arows).reshape(e, n, W * H)
        mid = geom.middle_pos()
        mid_flat = mid[0] * H + mid[1]
        agent_pos = torch.empty((e, n, 2), dtype=torch.int32, device=dev)
        agent_dir = torch.empty((e, n), dtype=torch.int32, device=dev)
        taken = torch.zeros((e, W * H), dtype=torch.bool, device=dev)
        for a in range(n):
            vpos = valid & arect[:, a] & ~taken
            if a < n - 1:  # agents after a still wait at the middle cell
                vpos[:, mid_flat].fill_(False)
            v4 = (vpos[..., None] & front).reshape(e, -1)
            flat = argmax_bits(aprio[:, a], v4)
            taken = taken | (iota == (flat // 4)[:, None])
            agent_pos[:, a] = torch.stack([flat // (H * 4), (flat // 4) % H], -1).to(torch.int32)
            agent_dir[:, a] = (flat % 4).to(torch.int32)
        return state.replace(grid=grid, agent_pos=agent_pos, agent_dir=agent_dir)

    # ------------------------------------------------------------ parity mode

    def _gen_grid_parity(self, G: np.random.Generator) -> dict:
        """Host-side layout consuming draws in reference order
        (playground.py:121-137 + core/roomgrid.py:406-452)."""
        geom = self.geometry
        data = self._parity_init()
        grid, agent_pos, agent_dir = data['grid'], data['agent_pos'], data['agent_dir']

        # connect_all (core/roomgrid.py:406-452): BFS reachability and random
        # door insertion; doors are never locked here, so the locked-room
        # skip cannot fire.
        doors = np.zeros((geom.num_cols, geom.num_rows, 4), dtype=bool)

        def all_reachable():
            seen = {(0, 0)}
            stack = [(0, 0)]
            while stack:
                c, r = stack.pop()
                for d in range(4):
                    if doors[c, r, d]:
                        nb = geom.neighbor(c, r, d)
                        if nb not in seen:
                            seen.add(nb)
                            stack.append(nb)
            return len(seen) == geom.num_rows * geom.num_cols

        for _ in range(5000):
            if all_reachable():
                break
            col = int(G.integers(0, geom.num_cols))
            row = int(G.integers(0, geom.num_rows))
            d = int(G.integers(0, 4))  # _rand_elem(Direction)
            if not geom.has_neighbor(col, row, d) or doors[col, row, d]:
                continue
            color = int(G.integers(0, NUM_BASE_COLORS))
            # add_door with rand_pos=True: the position comes from the gym
            # stream (the same injected G) via set_door_pos
            # (core/roomgrid.py:324).
            axis, fixed, lo, hi = geom.door_wall_span(col, row, d)
            v = int(G.integers(lo, hi))
            pos = (fixed, v) if axis == 'x' else (v, fixed)
            grid[pos[0], pos[1]] = layout.door(color, STATE_CLOSED)
            doors[col, row, d] = True
            nc, nr = geom.neighbor(col, row, d)
            doors[nc, nr, (d + 2) % 4] = True
        else:
            raise RecursionError('connect_all failed')

        # 12 random objects (playground.py:130-133): col and row, then kind,
        # then color, then rejection placement with the next-to-agent filter.
        for _ in range(12):
            col = int(G.integers(0, geom.num_cols))
            row = int(G.integers(0, geom.num_rows))
            kind = TYPE_KEY + int(G.integers(0, 3))
            color = int(G.integers(0, NUM_BASE_COLORS))
            self._parity_place_in_room(G, grid, agent_pos, layout.encode(kind, color), col, row)

        for a in range(self.cfg.num_agents):
            self._parity_place_agent_in_room(G, grid, agent_pos, agent_dir, a)

        return dict(grid=grid, agent_pos=agent_pos, agent_dir=agent_dir)
