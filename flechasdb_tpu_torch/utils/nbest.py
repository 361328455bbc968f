"""Streaming n-best selection.

Reference (``src/nbest.rs``): ``NBestByKey`` keeps the n best items seen so
far by swapping out the current worst on each push (O(n) per push, result
unordered); ``TakeNBestByKey`` blankets any iterator. On device this role is
played by a top-k; host-side consumers (e.g. merging candidate lists
from lazily-loaded partitions) get this utility.

A copy of the JAX package's ``utils/nbest.py`` (for the reason given in
:mod:`..errors`); ``tests/test_torch_asyncdb.py`` holds it against the
original.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, TypeVar

T = TypeVar("T")


class NBestByKey:
    """Keeps the ``n`` smallest-keyed items pushed so far (unordered)."""

    def __init__(self, n: int, key: Callable[[T], object]) -> None:
        if n <= 0:
            raise ValueError(f"n must be positive: {n}")
        self._n = n
        self._key = key
        self._items: List[T] = []
        self._worst: int = -1          # index of current worst, -1 = dirty

    def push(self, item: T) -> None:
        if len(self._items) < self._n:
            self._items.append(item)
            self._worst = -1
            return
        if self._worst < 0:
            self._worst = max(range(self._n),
                              key=lambda i: self._key(self._items[i]))
        if self._key(item) < self._key(self._items[self._worst]):
            self._items[self._worst] = item
            self._worst = -1

    def __iter__(self):
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def to_list(self) -> List[T]:
        return list(self._items)


def n_best_by_key(iterable: Iterable[T], n: int,
                  key: Callable[[T], object]) -> List[T]:
    """The ``TakeNBestByKey`` blanket impl (``nbest.rs:122-137``):
    returns the n smallest-keyed items, unordered."""
    nb = NBestByKey(n, key)
    for item in iterable:
        nb.push(item)
    return nb.to_list()
