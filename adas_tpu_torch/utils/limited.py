"""Bounded history container used by temporal state machines and tracks.

Equivalent of the reference ``LimitedList`` (taskConditions.py:14-37,
ObjectTracker/byteTrack/dtypes/strack.py:8-31) built on
``collections.deque`` for O(1) eviction instead of list slicing.
"""
from collections import deque
from typing import Iterable


class LimitedList:
    """Fixed-capacity FIFO with a ``full()`` flag.

    Behaves like a list for indexing/iteration; appending beyond capacity
    evicts the oldest element.
    """

    def __init__(self, maxlen: int):
        self._maxlen = maxlen
        self._items: deque = deque(maxlen=maxlen)

    def full(self) -> bool:
        return len(self._items) >= self._maxlen

    def append(self, element) -> None:
        self._items.append(element)

    def extend(self, elements: Iterable) -> None:
        for e in elements:
            self._items.append(e)

    def clear(self) -> None:
        self._items.clear()

    def copy(self) -> list:
        return list(self._items)

    def count(self, value) -> int:
        return sum(1 for v in self._items if _eq(v, value))

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._items)[idx]
        return self._items[idx]

    def __iter__(self):
        return iter(self._items)

    def __repr__(self) -> str:
        return f"LimitedList(maxlen={self._maxlen}, {list(self._items)!r})"


def _eq(a, b) -> bool:
    try:
        result = a == b
    except Exception:
        return False
    if hasattr(result, "all"):
        return bool(result.all())
    if isinstance(result, (list, tuple)):
        return all(result)
    return bool(result)
