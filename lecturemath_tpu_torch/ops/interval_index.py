"""1-D interval index with pairwise overlap sweep.

API-compatible utility matching the reference IntervalIndex
(reference: AccessMath/preprocessing/tools/interval_index.py:15-99). The
pipeline itself replaces the dual-index sweep with one vectorized bbox
intersection (data/cc.py bbox_intersections — same candidate set, one
numpy expression); this class exists for code that wants the incremental
add/remove interface.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterator, List, Tuple


class IntervalIndex:
    def __init__(self, allow_duplicates: bool = True):
        self.allow_duplicates = allow_duplicates
        self._starts: List[int] = []                # sorted interval starts
        self._entries: Dict[int, List[Tuple[int, object]]] = {}

    def add(self, start: int, end: int, value) -> None:
        """Add [start, end) with an associated value."""
        if start not in self._entries:
            bisect.insort(self._starts, start)
            self._entries[start] = []
        self._entries[start].append((end, value))

    def remove(self, start: int, end: int, value) -> bool:
        bucket = self._entries.get(start)
        if not bucket:
            return False
        try:
            bucket.remove((end, value))
        except ValueError:
            return False
        if not bucket:
            del self._entries[start]
            self._starts.remove(start)
        return True

    def __iter__(self) -> Iterator[Tuple[int, int, object]]:
        for start in self._starts:
            for end, value in self._entries[start]:
                yield start, end, value

    def __len__(self) -> int:
        return sum(len(bucket) for bucket in self._entries.values())

    def find_matches(self, other: "IntervalIndex") -> List[Tuple[object, object]]:
        """All (self_value, other_value) pairs whose intervals intersect —
        a simultaneous sweep over both sorted indexes, linear in intervals
        plus output size."""
        mine = [(start, end, value) for start, end, value in self]
        theirs = [(start, end, value) for start, end, value in other]

        events = []  # (position, kind, end, value) kind: 0=open-mine, 1=open-theirs
        for start, end, value in mine:
            events.append((start, 0, end, value))
        for start, end, value in theirs:
            events.append((start, 1, end, value))
        events.sort(key=lambda e: (e[0], e[1]))

        active_mine: List[Tuple[int, object]] = []
        active_theirs: List[Tuple[int, object]] = []
        matches: List[Tuple[object, object]] = []

        for position, kind, end, value in events:
            active_mine = [(e, v) for e, v in active_mine if e > position]
            active_theirs = [(e, v) for e, v in active_theirs if e > position]
            if kind == 0:
                for _, other_value in active_theirs:
                    matches.append((value, other_value))
                active_mine.append((end, value))
            else:
                for _, my_value in active_mine:
                    matches.append((my_value, value))
                active_theirs.append((end, value))

        return matches
