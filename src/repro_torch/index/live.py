"""LiveState: the shared mutation state machine behind every live backend.

Owns id allocation, the base-row tombstone mask and the DeltaSegment; the
backend threads the resulting tombstones onto its device arrays (+inf norms
for the brute scans, an ``alive`` mask for the graph traversal).

ID semantics (positional-id discipline): search results identify rows by
position, so ids ARE row positions.  A fresh upsert gets
``id = base_n + delta_slot``, which is exactly the row the slot lands on
when ``merge()`` appends delta slots to the base in order -- merge never
renumbers a surviving row.  Replacing an existing id therefore *retires* it
(the old row is tombstoned) and issues a fresh id for the new row; callers
get the new handles back from ``upsert``.

``LiveView`` is the host-side read view cache layers use to compose
tombstones and delta rows onto cached candidate blocks at serve time.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .delta import DeltaSegment


@dataclass
class LiveView:
    """Host-side view of the mutation state (for cache-layer composition)."""
    base_n: int
    base_alive: np.ndarray | None   # (base_n,) bool; None -> no tombstones
    delta: DeltaSegment


class LiveState:
    """Tombstones + delta + id allocation over a base index of ``base_n``
    rows.  Pure host state; device threading is the owning backend's job."""

    def __init__(self, base_n: int, dim: int, m_i: int, m_f: int):
        self.base_n = int(base_n)
        self.delta = DeltaSegment(dim, m_i, m_f)
        self.base_alive: np.ndarray | None = None   # lazy: None == all alive
        self.counters = {"upserts": 0, "deletes": 0, "replaced": 0,
                         "missing_deletes": 0}

    # -- helpers --------------------------------------------------------------
    def _base_mask(self) -> np.ndarray:
        if self.base_alive is None:
            self.base_alive = np.ones((self.base_n,), bool)
        return self.base_alive

    def _retire(self, id_: int) -> tuple[bool, int]:
        """Tombstone one live id; returns (found, base_row | -1)."""
        id_ = int(id_)
        if self.delta.kill(id_):
            return True, -1
        if 0 <= id_ < self.base_n:
            mask = self._base_mask()
            if mask[id_]:
                mask[id_] = False
                return True, id_
        return False, -1

    # -- mutation API ---------------------------------------------------------
    def upsert(self, vectors: np.ndarray, ints, floats,
               replace=None) -> tuple[np.ndarray, np.ndarray]:
        """Append rows; optionally retire ``replace`` ids first.

        Returns (fresh ids (B,) int64, newly-dead base rows (m,) int64).
        """
        vectors = np.ascontiguousarray(vectors, np.float32)
        b = vectors.shape[0]
        dead_base: list[int] = []
        if replace is not None:
            replace = np.atleast_1d(np.asarray(replace, np.int64))
            if replace.shape[0] != b:
                raise ValueError(f"replace must name one id per row: got "
                                 f"{replace.shape[0]} ids for {b} rows")
            for r in replace:
                found, row = self._retire(r)
                if found:
                    self.counters["replaced"] += 1
                    if row >= 0:
                        dead_base.append(row)
        ids = self.base_n + self.delta.append(
            vectors,
            np.zeros((b, self.delta.m_i), np.int32) if ints is None else ints,
            np.zeros((b, self.delta.m_f), np.float32) if floats is None
            else floats,
            self.base_n + np.arange(self.delta.count,
                                    self.delta.count + b, dtype=np.int64))
        self.counters["upserts"] += b
        return ids.astype(np.int64), np.asarray(dead_base, np.int64)

    def delete(self, ids) -> tuple[int, np.ndarray]:
        """Tombstone ids; returns (found count, newly-dead base rows)."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        dead_base: list[int] = []
        n = 0
        for i in ids:
            found, row = self._retire(i)
            if found:
                n += 1
                if row >= 0:
                    dead_base.append(row)
            else:
                self.counters["missing_deletes"] += 1
        self.counters["deletes"] += n
        return n, np.asarray(dead_base, np.int64)

    # -- merge support --------------------------------------------------------
    def merged_alive(self) -> np.ndarray:
        """(base_n + delta.count,) alive mask of the post-merge index (delta
        slots appended in order; dead slots carried as tombstoned rows)."""
        base = (self.base_alive if self.base_alive is not None
                else np.ones((self.base_n,), bool))
        return np.concatenate([base, self.delta.alive[: self.delta.count]])

    def reset_after_merge(self, new_base_n: int,
                          new_alive: np.ndarray | None, *,
                          from_slot: int | None = None) -> None:
        """Fold-complete: the delta is now part of the base.  Cumulative
        counters survive; id allocation continues from the new row count.

        ``from_slot`` supports background merges: the merge built from a
        snapshot of the first ``from_slot`` delta slots, so slots that
        arrived during the build carry into the fresh delta with their OLD
        ids.  The positional-id invariant keeps those ids valid: a carried
        slot ``s`` had ``id = old_base_n + s``, and since the merge appended
        exactly ``from_slot`` rows (``new_base_n = old_base_n + from_slot``),
        that id equals ``new_base_n + (s - from_slot)`` -- exactly its slot
        in the fresh segment.  Slots that died mid-build are re-killed so
        they stay positional tombstones."""
        old = self.delta
        self.base_n = int(new_base_n)
        self.base_alive = (None if new_alive is None
                           else np.asarray(new_alive, bool).copy())
        fresh = DeltaSegment(old.dim, old.m_i, old.m_f)
        if from_slot is not None and int(from_slot) < old.count:
            sl = slice(int(from_slot), old.count)
            fresh.append(old.vectors[sl], old.ints[sl], old.floats[sl],
                         old.ids[sl])
            for s in range(int(from_slot), old.count):
                if not old.alive[s]:
                    fresh.kill(int(old.ids[s]))
        self.delta = fresh

    # -- read views -----------------------------------------------------------
    def view(self) -> LiveView:
        return LiveView(self.base_n, self.base_alive, self.delta)

    @property
    def has_tombstones(self) -> bool:
        return self.base_alive is not None and not self.base_alive.all()

    def stats(self) -> dict:
        dead_base = (0 if self.base_alive is None
                     else int((~self.base_alive).sum()))
        return {"base_rows": self.base_n, "dead_base_rows": dead_base,
                "delta_rows": self.delta.live_count,
                "delta_slots": self.delta.count, **self.counters}
