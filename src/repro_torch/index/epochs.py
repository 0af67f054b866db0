"""Scoped data epochs: per-component version counters for live indexes.

``Backend.version()`` stays a single monotonic int (the aggregate), but live
backends additionally expose ``versions()`` -> one counter per component so
cache layers can invalidate only what a mutation actually touched:

  vectors    -- the set of live rows changed (delta append, tombstone).  The
                base arrays themselves are untouched; caches that compose
                the delta/tombstones at serve time may keep their entries.
  attributes -- estimator-visible attribute data changed (attribute rewrite,
                resample).  Selectivity estimates are stale.
  graph      -- the base index arrays were rebuilt (merge, reshard): any
                cached view of base rows is stale.

A vector-only upsert bumps ``vectors`` alone, which is exactly what lets the
selectivity cache stay warm across streaming ingestion (the estimator runs
over a fixed build-time sample that appends and tombstones do not touch).
"""
from __future__ import annotations

COMPONENTS = ("vectors", "attributes", "graph")


class ComponentEpochs:
    """Monotonic per-component counters; ``total`` is the legacy aggregate."""

    __slots__ = ("vectors", "attributes", "graph")

    def __init__(self, vectors: int = 0, attributes: int = 0, graph: int = 0):
        self.vectors = int(vectors)
        self.attributes = int(attributes)
        self.graph = int(graph)

    @property
    def total(self) -> int:
        """Aggregate epoch: any component bump changes it, so component-blind
        consumers of ``version()`` still invalidate correctly (just more
        often than they need to)."""
        return self.vectors + self.attributes + self.graph

    def bump(self, *components: str) -> int:
        for c in components:
            if c not in COMPONENTS:
                raise ValueError(f"unknown epoch component {c!r}; "
                                 f"expected one of {COMPONENTS}")
            setattr(self, c, getattr(self, c) + 1)
        return self.total

    def bump_all(self) -> int:
        return self.bump(*COMPONENTS)

    def as_dict(self) -> dict:
        return {c: getattr(self, c) for c in COMPONENTS}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ComponentEpochs(vectors={self.vectors}, "
                f"attributes={self.attributes}, graph={self.graph})")
