"""Agent actions (reference: multigrid/core/actions.py:5-16)."""

from __future__ import annotations

import enum


class Action(enum.IntEnum):
    """Enumeration of possible actions."""
    left = 0      #: Turn left
    right = 1     #: Turn right
    forward = 2   #: Move forward
    pickup = 3    #: Pick up an object
    drop = 4      #: Drop an object
    toggle = 5    #: Toggle / activate an object
    done = 6      #: Done completing task


NUM_ACTIONS = len(Action)
