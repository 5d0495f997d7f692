"""Mission statements and mission spaces.

Counterpart of the reference's ``Mission``/``MissionSpace``
(multigrid/core/mission.py:9-136). Mission *strings* are host-side API
surface; inside the tensor code a mission is just its integer index, carried in
``state.extras['mission']`` when an environment parameterizes missions.

``MissionSpace`` enumerates the full cross product of placeholder arguments so
every concrete mission string has a stable index — the dense encoding the
reference builds through ``spaces.MultiDiscrete`` (mission.py:84-93).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Sequence

import numpy as np


class Mission(str):
    """A mission string that knows its index in its space
    (reference mission.py:9-42 wraps the same pair in an ndarray subclass)."""

    index: int

    def __new__(cls, string: str, index: int = 0):
        self = super().__new__(cls, string)
        self.index = index
        return self


class MissionSpace:
    """Space of mission strings generated by a function of placeholder args.

    Mirrors the reference API (mission.py:45-136): ``mission_func`` +
    ``ordered_placeholders``. Also usable as a plain container:
    ``len``, ``__getitem__`` by index, ``sample``.

    Examples
    --------
    >>> space = MissionSpace(
    ...     mission_func=lambda color: f"pick up the {color} ball",
    ...     ordered_placeholders=[['red', 'green']])
    >>> space.get('green')
    'pick up the green ball'
    >>> space.get('green').index
    1
    """

    def __init__(
        self,
        mission_func: Callable[..., str],
        ordered_placeholders: Sequence[Sequence[Any]] | None = None,
        seed: int | None = None,
    ):
        self.mission_func = mission_func
        self.ordered_placeholders = [
            list(p) for p in (ordered_placeholders or [])
        ]
        self._rng = np.random.default_rng(seed)
        if self.ordered_placeholders:
            self._combos = list(itertools.product(*self.ordered_placeholders))
        else:
            self._combos = [()]

    @classmethod
    def from_string(cls, string: str) -> 'MissionSpace':
        """Singleton space of one fixed mission (mission.py:126-136)."""
        return cls(mission_func=lambda: string)

    def seed(self, seed: int | None = None) -> None:
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._combos)

    def __getitem__(self, index: int) -> Mission:
        combo = self._combos[index]
        return Mission(self.mission_func(*combo), index=index)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def get(self, *args) -> Mission:
        """Mission for specific placeholder values (mission.py:112-124)."""
        index = self._combos.index(tuple(args))
        return self[index]

    def sample(self) -> Mission:
        """Draw a random mission (mission.py:105-110)."""
        return self[int(self._rng.integers(0, len(self)))]

    def contains(self, x: Any) -> bool:
        return isinstance(x, str) and any(str(m) == str(x) for m in self)

    def __repr__(self):
        return f'MissionSpace({len(self)} missions)'
