"""Small helpers (reference: multigrid/utils/misc.py).

``front_pos`` mirrors the reference helper, the host-side form of what the
batched step computes with direction vectors (ops/step.py).
"""

from __future__ import annotations

from ..core.constants import DIR_TO_VEC


def front_pos(agent_x: int, agent_y: int, agent_dir: int) -> tuple[int, int]:
    """The (x, y) cell directly in front of an agent (utils/misc.py:7-13)."""
    dx, dy = DIR_TO_VEC[int(agent_dir)]
    return (int(agent_x) + int(dx), int(agent_y) + int(dy))
