"""Bounded event log with visible truncation (DESIGN.md §18).

Every long-lived event log in the repo — the prefetcher's promote log, the
gateways' migrate logs, the fault injector's ledger — used to bound itself
with an inline ``if len(log) > N: del log[:N//2]`` (or not at all, and grow
forever).  This is the ONE ring-buffer helper they all share: appends past
capacity drop the OLDEST entries and COUNT them in ``dropped_events``, so a
truncated audit trail is visible in metrics instead of silent.

List-compatible on the read side (iteration, ``len``, indexing, slicing,
``==`` against lists/tuples/other rings) because golden tests pin log
contents with plain list literals.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator


class BoundedLog:
    """Append-only ring buffer: keeps the newest `capacity` items, counts
    what it dropped."""

    __slots__ = ("_buf", "capacity", "dropped_events")

    def __init__(self, capacity: int = 4096, items: Iterable = ()):
        assert capacity > 0
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self.dropped_events = 0
        for it in items:
            self.append(it)

    def append(self, item) -> None:
        if len(self._buf) == self.capacity:
            self.dropped_events += 1
        self._buf.append(item)

    def extend(self, items: Iterable) -> None:
        for it in items:
            self.append(it)

    def clear(self) -> None:
        """Drop the contents (a fresh replay), keeping the drop counter —
        events already lost stay counted."""
        self._buf.clear()

    def tail(self, n: int) -> list:
        """The newest `n` items, oldest-first (the flight-recorder view)."""
        if n <= 0:
            return []
        return list(self._buf)[-n:]

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator:
        return iter(self._buf)

    def __bool__(self) -> bool:
        return bool(self._buf)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._buf)[i]
        return self._buf[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, BoundedLog):
            return list(self._buf) == list(other._buf)
        if isinstance(other, (list, tuple)):
            return list(self._buf) == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return (f"BoundedLog(capacity={self.capacity}, "
                f"n={len(self._buf)}, dropped={self.dropped_events})")
