"""ASCII pretty-printing of environment states.

Counterpart of the JAX package's ``multigrid_tpu/utils/pprint.py`` and of
the reference ``MultiGridEnv.__str__`` (multigrid/base.py: the
2-character-per-cell map): object type glyph + color letter, agents as
direction arrows, door state variants.
"""

from __future__ import annotations

from ..core.constants import (
    STATE_LOCKED,
    STATE_OPEN,
    Color,
    Type,
)
from ..core.state import MultiGridState

#: Object type → glyph (reference base.py OBJECT_TO_STR equivalent).
_TYPE_GLYPH = {
    Type.wall.to_index(): 'W',
    Type.floor.to_index(): 'F',
    Type.key.to_index(): 'K',
    Type.ball.to_index(): 'A',
    Type.box.to_index(): 'B',
    Type.goal.to_index(): 'G',
    Type.lava.to_index(): 'V',
}

#: Agent direction → arrow (right, down, left, up).
_DIR_GLYPH = ['>', 'V', '<', '^']


def state_to_string(state: MultiGridState, index: int = 0) -> str:
    """Env ``index`` of a batched state as a 2-chars-per-cell ASCII map
    (one copy to the host per field)."""
    grid = state.grid[index].cpu().numpy()
    pos = state.agent_pos[index].cpu().numpy()
    dirs = state.agent_dir[index].cpu().numpy()
    terminated = state.agent_terminated[index].cpu().numpy()
    w, h, _ = grid.shape

    agent_at = {}
    for a in range(state.num_agents):
        if not terminated[a]:
            agent_at[(int(pos[a, 0]), int(pos[a, 1]))] = a

    door_idx = Type.door.to_index()
    empty_idx = Type.empty.to_index()
    rows = []
    for y in range(h):
        row = []
        for x in range(w):
            if (x, y) in agent_at:
                a = agent_at[(x, y)]
                row.append(_DIR_GLYPH[int(dirs[a]) % 4] * 2)
                continue
            t, c, s = (int(v) for v in grid[x, y])
            color_letter = Color.from_index(c).value[0].upper() \
                if 0 <= c < len(Color) else '?'
            if t == empty_idx or t == Type.unseen.to_index():
                row.append('  ')
            elif t == door_idx:
                glyph = '_' if s == STATE_OPEN else (
                    'L' if s == STATE_LOCKED else 'D')
                row.append(glyph + color_letter)
            elif t in _TYPE_GLYPH:
                row.append(_TYPE_GLYPH[t] + color_letter)
            else:
                row.append('??')
        rows.append(''.join(row))
    return '\n'.join(rows)
