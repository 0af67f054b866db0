"""Bounded LRU + TTL map: the one eviction policy every cache layer shares.

Kept deliberately free of cache-layer semantics: keys and values are opaque,
time comes from an injectable monotonic clock (tests pass a fake), and the
counters record only what this container can observe (hits, misses,
evictions, expirations).  Layer-level notions -- bypasses, invalidation
epochs, what a "hit" means for a semantic entry -- live in ``layers.py``.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable

_MISS = object()  # sentinel: None is a legal cached value


class LruTtlCache:
    """OrderedDict-backed LRU with optional per-entry TTL.

    cap    : max live entries; inserting past it evicts the LRU entry.
    ttl_s  : entry lifetime in seconds (None = entries never expire).
    clock  : monotonic time source; injectable so tests control expiry.
    """

    def __init__(self, cap: int, ttl_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError(f"ttl_s must be None or > 0, got {ttl_s}")
        self.cap = cap
        self.ttl_s = ttl_s
        self.clock = clock
        self._d: OrderedDict[Any, tuple[float, Any]] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return self.peek(key) is not _MISS

    def peek(self, key):
        """Like get() but without touching recency or hit/miss counters
        (expired entries are still dropped)."""
        ent = self._d.get(key)
        if ent is None:
            return _MISS
        t, value = ent
        if self.ttl_s is not None and self.clock() - t > self.ttl_s:
            del self._d[key]
            self.expirations += 1
            return _MISS
        return value

    def get(self, key, default=None):
        value = self.peek(key)
        if value is _MISS:
            self.misses += 1
            return default
        self._d.move_to_end(key)
        self.hits += 1
        return value

    def put(self, key, value) -> None:
        if key in self._d:
            del self._d[key]
        elif len(self._d) >= self.cap:
            self._d.popitem(last=False)
            self.evictions += 1
        self._d[key] = (self.clock(), value)

    def pop(self, key, default=None):
        ent = self._d.pop(key, None)
        return default if ent is None else ent[1]

    def clear(self) -> int:
        n = len(self._d)
        self._d.clear()
        return n

    def stats(self) -> dict:
        return {"size": len(self._d), "cap": self.cap, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "expirations": self.expirations}

    def reset_counters(self) -> None:
        """Zero the hit/miss/eviction/expiration counters; entries survive
        (the registry reset cascade zeroes accounting, not state)."""
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
