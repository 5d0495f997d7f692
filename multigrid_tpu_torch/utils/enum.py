"""Extensible indexed enumerations.

Equivalent of the reference's aenum-based ``IndexedEnum``
(reference: multigrid/utils/enum.py:42-89). Built on the stdlib ``enum``
module plus a small ``extend_enum`` implementation, since ``aenum`` is not a
dependency of this framework. Each member has a stable integer index — the
index order *is* the wire format used by the dense grid encodings, so it must
never change for the core types.
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np


def extend_enum(cls: type[enum.Enum], name: str, value: Any) -> enum.Enum:
    """Dynamically add a new member to an existing Enum class.

    Minimal equivalent of ``aenum.extend_enum`` covering the needs of
    :meth:`IndexedEnum.add_item` (reference multigrid/utils/enum.py:62).
    """
    if name in cls._member_map_:
        raise ValueError(f"member {name!r} already exists in {cls.__name__}")

    member_type = cls._member_type_
    if member_type is object:
        member = object.__new__(cls)
    else:
        member = member_type.__new__(cls, value)
    member._name_ = name
    member._value_ = value
    # Bypass EnumMeta.__setattr__, which forbids assigning members.
    type.__setattr__(cls, name, member)
    cls._member_map_[name] = member
    cls._member_names_.append(name)
    try:
        cls._value2member_map_[value] = member
    except TypeError:
        pass
    return member


class IndexedEnum(enum.Enum):
    """Enum where each member has a corresponding stable integer index.

    API-parity with the reference ``IndexedEnum``
    (multigrid/utils/enum.py:42-89): ``to_index``, ``from_index`` (vectorized
    over arrays), ``add_item``, and ``int()`` conversion. The index of a
    member is its position in definition order — the wire format of the
    dense grid encodings, so extension only ever *appends*.

    Index/value tables are built lazily per class and stored on the class
    itself (name-mangled so subclasses never inherit a parent's stale
    table), rebuilt after :meth:`add_item`.
    """

    def __int__(self) -> int:
        return self.to_index()

    @classmethod
    def _tables(cls) -> tuple[dict[enum.Enum, int], np.ndarray]:
        # Vars() (not getattr) so a subclass builds its own entry instead of
        # reading one inherited from a parent enum class.
        cached = vars(cls).get('_indexed_tables_')
        if cached is None:
            cached = (
                {member: i for i, member in enumerate(cls)},
                np.asarray([member.value for member in cls]),
            )
            type.__setattr__(cls, '_indexed_tables_', cached)
        return cached

    @classmethod
    def add_item(cls, name: str, value: Any):
        """Append a new item to the enumeration (rebuilds the index table)."""
        extend_enum(cls, name, value)
        type.__setattr__(cls, '_indexed_tables_', None)

    @classmethod
    def from_index(cls, index):
        """Return the enum member at ``index`` — or, given an array of
        indices, the array of member *values* (vectorized lookup)."""
        values = cls._tables()[1][index]
        return cls(values) if np.ndim(values) == 0 else values

    def to_index(self) -> int:
        """Return the integer index of this enum member."""
        return self._tables()[0][self]
