"""Bounded LRU memo for the captured epochs (the JAX package's
``utils/memo.py``).

The JAX package memoizes its jitted step builders, because each compiled
executable pins device memory. Here the memos hold the CUDA graphs of the
training step and the eval epochs (``train/svi.py``): each graph pins a
private memory pool and its static buffers on the card. The key space in a
real process is tiny (one train graph and four eval graphs a recipe), but a
process that walks a grid of recipes (tests, sweeps of learning rates,
``chip_smoke.py``'s workloads and backends) would grow without bound. A small
LRU keeps repeat builds of one recipe free, and eviction drops the oldest
graph, and with it its pool, once nothing else holds it.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Any, Hashable

_MEMOS: "weakref.WeakSet[BoundedMemo]" = weakref.WeakSet()


class BoundedMemo:
    """An OrderedDict-backed LRU with dict-ish get/set/clear surface."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = int(maxsize)
        self._d: OrderedDict = OrderedDict()
        _MEMOS.add(self)

    def get(self, key: Hashable, default: Any = None) -> Any:
        try:
            self._d.move_to_end(key)
        except KeyError:
            return default
        return self._d[key]

    def __setitem__(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d

    def clear(self) -> None:
        self._d.clear()


def clear_all() -> None:
    """Empty every memo, dropping the graphs they hold: a process group
    whose collectives a graph captured is destroyed only after the graph
    (``parallel/launch.py``)."""
    for memo in list(_MEMOS):
        memo.clear()
