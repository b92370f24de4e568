"""Strongly-named scalar wrappers (reference: src/v/utils/named_type.h).

The reference gives every domain scalar (offset, term, node id…) a
distinct C++ type to stop unit mix-ups at compile time. Python can't do
that statically, but thin int subclasses keep repr/debugging honest and
give each domain value a nominal type for isinstance checks, while
remaining directly usable as ints (indexing, arithmetic, struct pack).
"""

from __future__ import annotations


class NamedInt(int):
    """Base for named integral types; subclass to mint a new name."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}({int(self)})"


def named_int(name: str) -> type[NamedInt]:
    return type(name, (NamedInt,), {"__slots__": ()})
