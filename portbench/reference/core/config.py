"""Static environment configuration.

The reference configures environments through constructor kwargs
(multigrid/base.py:85-103). Here the equivalent is a frozen, hashable
dataclass shared by the step and observation functions — every field
affects trace-time control flow or array shapes, never runtime values.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static configuration shared by all MultiGrid environments.

    Mirrors the reference ``MultiGridEnv.__init__`` parameters
    (multigrid/base.py:85-103) that affect dynamics and observations.
    """

    width: int
    height: int
    num_agents: int = 1
    max_steps: int = 100
    see_through_walls: bool = False
    view_size: int = 7
    allow_agent_overlap: bool = True
    joint_reward: bool = False
    #: Terminate everyone on success ('any') vs. only the succeeding agent ('all').
    success_any: bool = True
    #: Terminate everyone on failure ('any') vs. only the failing agent ('all').
    failure_any: bool = False

    def __post_init__(self):
        assert self.view_size % 2 == 1 and self.view_size >= 3
        assert self.width >= 3 and self.height >= 3
        assert isinstance(self.max_steps, int)
