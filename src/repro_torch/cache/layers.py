"""The three serving-cache layers, all keyed by canonical filter signatures.

SelectivityCache    signature -> p_hat (float).  The sample estimator is
                    deterministic, so hits are bit-identical to recomputing.
CandidateCache      signature -> sorted matching-ID array.  Admission is
                    gated on exact selectivity (p <= p_max) and entry size,
                    because only brute-routed (low-selectivity) filters win
                    from scanning a candidate block instead of the corpus.
SemanticResultCache (signature, opts) -> [(query vector, top-k, route), ...]
                    redisvl-style: a lookup scans the per-key entry list for
                    a cached query vector within ``threshold`` L2 distance.
                    threshold 0.0 serves only exact repeats (lossless).

Each layer wraps one ``LruTtlCache`` and adds its own admission/matching
semantics plus a ``bypass`` counter for lookups the layer declined to serve
by policy (disabled layer, over-cap entry, no corpus access) -- distinct
from a miss, which is demand the layer could have served with a warmer
cache.

The candidate and semantic layers additionally take an optional integer
``scope`` (tenant/session id, 0 = unscoped): the scope joins the cache key,
so tenant A's entries can never serve tenant B -- the isolation contract the
multi-tenant front-end relies on -- and per-scope hit/miss counters surface
in ``stats()["by_scope"]``.  The selectivity layer stays global: p_hat is a
property of the data, not of who asked.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..core.options import CacheSpec
from .lru import LruTtlCache, _MISS


class _ScopeCounters:
    """Per-scope hit/miss accounting shared by the scoped layers."""

    def __init__(self):
        self._counts: dict[int, list] = {}

    def count(self, scope: int, hit: bool) -> None:
        row = self._counts.setdefault(int(scope), [0, 0])
        row[0 if hit else 1] += 1

    def stats(self) -> dict:
        out = {}
        for scope, (h, m) in sorted(self._counts.items()):
            out[scope] = {"hits": h, "misses": m,
                          "hit_rate": h / (h + m) if h + m else 0.0}
        return out

    def reset(self) -> None:
        self._counts.clear()


class SelectivityCache:
    """signature -> p_hat; skips backend.estimate for repeat filters."""

    def __init__(self, spec: CacheSpec, clock=time.monotonic):
        self.enabled = spec.selectivity
        self._lru = LruTtlCache(spec.selectivity_cap, spec.ttl_s, clock)
        self.bypasses = 0

    def get(self, sig: str) -> float | None:
        if not self.enabled:
            self.bypasses += 1
            return None
        return self._lru.get(sig)

    def peek(self, sig: str) -> float | None:
        """Non-counting read for other layers' admission heuristics."""
        if not self.enabled:
            return None
        v = self._lru.peek(sig)
        return None if v is _MISS else v

    def put(self, sig: str, p_hat: float) -> None:
        if self.enabled:
            self._lru.put(sig, float(p_hat))

    def clear(self) -> int:
        return self._lru.clear()

    def reset_counters(self) -> None:
        self._lru.reset_counters()
        self.bypasses = 0

    def stats(self) -> dict:
        return {**self._lru.stats(), "bypasses": self.bypasses,
                "enabled": self.enabled}


class CandidateCache:
    """signature -> matching-ID block for hot low-selectivity filters.

    Blocks store the *base-corpus* extension only; under a live index the
    backend composes tombstones and delta rows over the block at hit time
    (counted in ``composed``), so entries survive vector-only mutations.

    ``scope`` joins the key: the same signature admitted under two tenants
    stores two entries (isolation costs sharing, by design)."""

    def __init__(self, spec: CacheSpec, clock=time.monotonic):
        self.enabled = spec.candidates
        self.p_max = spec.candidate_p_max
        self.max_ids = spec.candidate_max_ids
        self._lru = LruTtlCache(spec.candidate_cap, spec.ttl_s, clock)
        self.bypasses = 0
        self.composed = 0   # hits served through live-state composition
        self._by_scope = _ScopeCounters()

    def get(self, sig: str, scope: int = 0) -> np.ndarray | None:
        if not self.enabled:
            self.bypasses += 1
            return None
        out = self._lru.get((scope, sig))
        self._by_scope.count(scope, out is not None)
        return out

    def admit(self, sig: str, ids: np.ndarray, n_rows: int,
              scope: int = 0) -> bool:
        """Admission-controlled insert; True when the entry was stored."""
        if not self.enabled:
            return False
        if len(ids) > self.max_ids or len(ids) > self.p_max * n_rows:
            self.bypasses += 1
            return False
        self._lru.put((scope, sig), np.ascontiguousarray(ids, np.int64))
        return True

    def clear(self) -> int:
        return self._lru.clear()

    def reset_counters(self) -> None:
        self._lru.reset_counters()
        self.bypasses = 0
        self.composed = 0
        self._by_scope.reset()

    def stats(self) -> dict:
        return {**self._lru.stats(), "bypasses": self.bypasses,
                "composed": self.composed, "enabled": self.enabled,
                "by_scope": self._by_scope.stats()}


@dataclass
class _SemanticEntry:
    query: np.ndarray          # (d,) float32
    ids: np.ndarray            # (k,) int64
    dists: np.ndarray          # (k,) float32
    p_hat: float
    routed_brute: bool
    t: float = 0.0             # insert time (per-entry TTL)


class SemanticResultCache:
    """(signature, opts) -> cached query vectors with their exact top-k.

    TTL is enforced **per entry**, not per key: a hot key that keeps
    receiving fresh queries must not keep serving results computed before
    the TTL horizon (the key-level LruTtlCache timestamp refreshes on every
    put, so it only bounds idle keys)."""

    def __init__(self, spec: CacheSpec, clock=time.monotonic):
        self.enabled = spec.semantic
        self.threshold = spec.semantic_threshold
        self.per_key = spec.semantic_per_key
        self.ttl_s = spec.ttl_s
        self._clock = clock
        self._lru = LruTtlCache(spec.semantic_cap, spec.ttl_s, clock)
        self.bypasses = 0
        self._by_scope = _ScopeCounters()

    def _prune(self, entries: list) -> list:
        """Drop entries older than the TTL (counted as expirations)."""
        if self.ttl_s is None:
            return entries
        now = self._clock()
        live = [e for e in entries if now - e.t <= self.ttl_s]
        self._lru.expirations += len(entries) - len(live)
        return live

    def get(self, sig: str, opts, query: np.ndarray,
            scope: int = 0) -> _SemanticEntry | None:
        """Nearest cached entry for (scope, sig, opts) within threshold, else
        None.  Counts one hit or one miss on the underlying LRU either way."""
        if not self.enabled:
            self.bypasses += 1
            return None
        key = (scope, sig, opts)
        entries = self._lru.peek(key)
        if entries is _MISS:
            self._lru.misses += 1
            self._by_scope.count(scope, False)
            return None
        entries[:] = self._prune(entries)
        q = np.asarray(query, np.float32)
        best, best_d = None, np.inf
        for e in entries:
            d = float(np.sqrt(np.sum((e.query - q) ** 2, dtype=np.float32)))
            if d <= self.threshold and d < best_d:
                best, best_d = e, d
        self._by_scope.count(scope, best is not None)
        if best is None:
            self._lru.misses += 1
            return None
        self._lru.get(key)  # touch recency + count the hit
        return best

    def put(self, sig: str, opts, query: np.ndarray, ids, dists,
            p_hat: float, routed_brute: bool, scope: int = 0) -> None:
        if not self.enabled:
            return
        key = (scope, sig, opts)
        entries = self._lru.peek(key)
        if entries is _MISS:
            entries = []
        entries = self._prune(entries)
        q = np.asarray(query, np.float32).copy()
        entry = _SemanticEntry(q, np.asarray(ids, np.int64).copy(),
                               np.asarray(dists, np.float32).copy(),
                               float(p_hat), bool(routed_brute),
                               t=self._clock())
        # replace an entry the new query would already hit (dedupe: batch
        # padding repeats the same query several times per batch)
        for i, e in enumerate(entries):
            d = float(np.sqrt(np.sum((e.query - q) ** 2, dtype=np.float32)))
            if d <= self.threshold:
                entries[i] = entry
                self._lru.put(key, entries)
                return
        entries.append(entry)
        if len(entries) > self.per_key:
            entries = entries[-self.per_key:]
        self._lru.put(key, entries)

    def clear(self) -> int:
        return self._lru.clear()

    def reset_counters(self) -> None:
        self._lru.reset_counters()
        self.bypasses = 0
        self._by_scope.reset()

    def stats(self) -> dict:
        return {**self._lru.stats(), "bypasses": self.bypasses,
                "enabled": self.enabled, "threshold": self.threshold,
                "by_scope": self._by_scope.stats()}
