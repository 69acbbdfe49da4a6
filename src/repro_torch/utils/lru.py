"""A small LRU cache with hit/miss/eviction counters.

Counterpart of :mod:`repro.utils.lru` (a copy: the port imports nothing
of the JAX package).  The session layer and the serving subsystem both
keep bounded caches of warm state (device-stacked fleet containers, the
server's program slots); :class:`LRUCache` gives them one mechanism —
least-recently-*used* eviction plus the counters surfaced in
:attr:`repro_torch.api.Session.cache_stats` and ``Server.stats()``.

Not thread-safe on its own: callers that share a cache across threads
(the serving scheduler) hold their own lock around access.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, Iterator

__all__ = ["LRUCache"]

_MISSING = object()


class LRUCache:
    """Bounded mapping with least-recently-used eviction.

    ``get`` and ``put`` refresh recency and bump the ``hits`` / ``misses``
    counters; inserting past ``capacity`` evicts the least recently used
    entry (``evictions`` counts them).  ``pop`` / ``clear`` are bookkeeping
    removals and touch no counter.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"LRUCache capacity must be >= 1, got "
                             f"{capacity}")
        self.capacity = int(capacity)
        self._data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ---- counted access ----------------------------------------------------
    def get(self, key: Hashable, default: Any = None) -> Any:
        """Counted lookup: a present key moves to most-recently-used."""
        value = self._data.get(key, _MISSING)
        if value is _MISSING:
            self.misses += 1
            return default
        self._data.move_to_end(key)
        self.hits += 1
        return value

    def put(self, key: Hashable, value: Any) -> tuple | None:
        """Insert/update ``key`` as most-recently-used.  Returns the evicted
        ``(key, value)`` pair when this push went past capacity."""
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        if len(self._data) > self.capacity:
            evicted = self._data.popitem(last=False)
            self.evictions += 1
            return evicted
        return None

    # ---- uncounted bookkeeping --------------------------------------------
    def peek(self, key: Hashable, default: Any = None) -> Any:
        """Uncounted, recency-preserving lookup."""
        return self._data.get(key, default)

    def pop(self, key: Hashable, default: Any = None) -> Any:
        return self._data.pop(key, default)

    def clear(self) -> None:
        self._data.clear()

    def keys(self):
        return list(self._data.keys())

    def items(self):
        return list(self._data.items())

    def values(self):
        return list(self._data.values())

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self) -> Iterator:
        return iter(list(self._data))

    # ---- observability -----------------------------------------------------
    def stats(self) -> dict:
        """Counters snapshot (what the session / server stats expose)."""
        total = self.hits + self.misses
        return {
            "size": len(self._data),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": (self.hits / total) if total else 0.0,
        }
