"""DeltaSegment: the append-only buffer fresh rows land in before a merge.

Freshly upserted vectors+attributes are held host-side in growable arrays
and mirrored to the device as a pow-2-capacity padded block.  Per query the
segment is brute-scanned with the PreFBF scan (``prefbf.prefbf_topk``, the
``filtered_topk`` kernel on the card, its plain scan on the CPU) -- exact
float32 always, even when the base route streams PQ/SQ codes.

Dead slots (a delta row replaced or deleted before it was merged) and unused
capacity reuse the padded-row convention end to end: +inf norms make the
scan drop them, so they can never win a top-k slot -- no kernel change, no
compaction.

``compose_topk`` (host) and ``compose_topk_dev`` (device) fold base-index
results and delta results into one (ids, dists) answer.  Their stable sort
over base entries concatenated before delta entries prefers base rows on
exact ties.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import prefbf
from ..kernels._common import stable_topk

_MIN_CAPACITY = 64


def compose_topk(base_ids: np.ndarray, base_d: np.ndarray,
                 extra_ids: np.ndarray, extra_d: np.ndarray,
                 k: int) -> tuple[np.ndarray, np.ndarray]:
    """Merge two (B, *) id/dist blocks into the global top-k (B, k).

    Missing entries follow the SearchResult contract (-1 / +inf) on both
    inputs and the output; ids come back int64.
    """
    ids = np.concatenate([np.asarray(base_ids, np.int64),
                          np.asarray(extra_ids, np.int64)], axis=1)
    d = np.concatenate([np.asarray(base_d, np.float32),
                        np.asarray(extra_d, np.float32)], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    out_d = np.take_along_axis(d, order, axis=1)
    out_i = np.take_along_axis(ids, order, axis=1)
    return np.where(np.isfinite(out_d), out_i, -1), out_d


def compose_topk_dev(base_ids, base_d, extra_ids, extra_d, k: int):
    """Device-side ``compose_topk`` on tensors: the same stable sort-merge
    (base entries first, so base rows win exact ties) without a host sync.
    Returns (ids (B, k) int64, dists (B, k) f32)."""
    out_d, out_i = stable_topk(
        [base_d.to(torch.float32), extra_d.to(torch.float32)], k,
        [base_ids.to(torch.int64), extra_ids.to(torch.int64)])
    return torch.where(torch.isfinite(out_d), out_i, -1), out_d


class DeltaSegment:
    """Append-only (vectors, attributes, global ids) buffer with an alive
    mask, scannable on the device.

    Slots are never reused or compacted: a slot's position is stable for the
    segment's lifetime, which is what lets ``merge()`` append slots to the
    base index *in slot order* and keep every live row's global id equal to
    its final row position (ids are positional in this system).
    """

    def __init__(self, dim: int, m_i: int, m_f: int,
                 min_capacity: int = _MIN_CAPACITY):
        self.dim = int(dim)
        self.m_i = int(m_i)
        self.m_f = int(m_f)
        self.count = 0        # slots used (live + dead)
        self.live_count = 0
        self._cap = 0
        self._min_cap = max(1, int(min_capacity))
        self.vectors = np.zeros((0, self.dim), np.float32)
        self.norms = np.zeros((0,), np.float32)
        self.ints = np.zeros((0, self.m_i), np.int32)
        self.floats = np.zeros((0, self.m_f), np.float32)
        self.ids = np.full((0,), -1, np.int64)
        self.alive = np.zeros((0,), bool)
        self._slot_of: dict[int, int] = {}   # live id -> slot
        self._dev = None                     # (device, padded device arrays)

    # -- capacity -------------------------------------------------------------
    def _grow(self, need: int) -> None:
        cap = max(self._cap, self._min_cap)
        while cap < need:
            cap *= 2
        if cap == self._cap:
            return

        def ext(a, fill, shape_tail=()):
            out = np.full((cap, *shape_tail), fill, a.dtype)
            out[: self.count] = a[: self.count]
            return out

        self.vectors = ext(self.vectors, 0.0, (self.dim,))
        self.norms = ext(self.norms, 0.0)
        self.ints = ext(self.ints, -1, (self.m_i,))
        self.floats = ext(self.floats, np.nan, (self.m_f,))
        self.ids = ext(self.ids, -1)
        self.alive = ext(self.alive, False)
        self._cap = cap

    # -- mutation -------------------------------------------------------------
    def append(self, vectors: np.ndarray, ints: np.ndarray,
               floats: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Append rows (already carrying their global ids); returns slots."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        b = vectors.shape[0]
        if vectors.shape[1] != self.dim:
            raise ValueError(f"delta rows must be dim={self.dim}, "
                             f"got {vectors.shape[1]}")
        self._grow(self.count + b)
        sl = np.arange(self.count, self.count + b)
        self.vectors[sl] = vectors
        self.norms[sl] = np.einsum("nd,nd->n", vectors, vectors)
        self.ints[sl] = np.asarray(ints, np.int32).reshape(b, self.m_i)
        self.floats[sl] = np.asarray(floats, np.float32).reshape(b, self.m_f)
        self.ids[sl] = np.asarray(ids, np.int64)
        self.alive[sl] = True
        for s, i in zip(sl, np.asarray(ids, np.int64)):
            self._slot_of[int(i)] = int(s)
        self.count += b
        self.live_count += b
        self._dev = None
        return sl

    def kill(self, id_: int) -> bool:
        """Tombstone a live delta row by global id (no compaction)."""
        slot = self._slot_of.pop(int(id_), None)
        if slot is None:
            return False
        self.alive[slot] = False
        self.live_count -= 1
        self._dev = None
        return True

    def has(self, id_: int) -> bool:
        return int(id_) in self._slot_of

    # -- device scan ----------------------------------------------------------
    def _device_view(self, device) -> dict:
        """Padded copy on ``device``, rebuilt lazily after any mutation.
        Norms of dead and unused slots are +inf (the padded-row convention),
        so one where() is the whole tombstone mechanism for this buffer."""
        if self._dev is None or self._dev[0] != device:
            self._grow(max(self._cap, self._min_cap))
            norms = np.where(self.alive, self.norms, np.inf).astype(np.float32)
            self._dev = (device, {
                "vectors": torch.tensor(self.vectors, device=device),
                "norms": torch.tensor(norms, device=device),
                "ints": torch.tensor(self.ints, device=device),
                "floats": torch.tensor(self.floats, device=device),
                "ids": torch.tensor(self.ids, device=device),
            })
        return self._dev[1]

    def scan(self, queries, programs: dict, *, k: int,
             valid=None) -> tuple[np.ndarray, np.ndarray]:
        """Exact filtered top-k over the live delta rows; host (ids (B, k)
        int64 global ids, dists (B, k) f32) under the -1 / +inf contract."""
        ids, d = self.scan_dev(queries, programs, k=k, valid=valid)
        return ids.cpu().numpy(), d.cpu().numpy()

    def scan_dev(self, queries, programs: dict, *, k: int, valid=None):
        """``scan`` staying on the queries' device: (global ids (B, k)
        int64, dists (B, k) f32) tensors, for ``compose_topk_dev``.  The scan
        is ``prefbf.prefbf_topk``: on the card it launches the
        ``filtered_topk`` kernel (the JAX package runs the same function in
        plain jnp here)."""
        b, dev = int(queries.shape[0]), queries.device
        if self.live_count == 0:
            return (torch.full((b, k), -1, dtype=torch.int64, device=dev),
                    torch.full((b, k), float("inf"), dtype=torch.float32,
                               device=dev))
        dv = self._device_view(dev)
        slots, d = prefbf.prefbf_topk(
            dv["vectors"], dv["norms"], dv["ints"], dv["floats"], queries,
            programs, k=k, chunk=self._cap, valid=valid)
        gids = torch.where(slots >= 0, dv["ids"][slots.clamp(min=0).long()],
                           -1)
        return gids, d

    # -- accounting -----------------------------------------------------------
    def stats(self) -> dict:
        return {"slots": self.count, "live": self.live_count,
                "dead": self.count - self.live_count, "capacity": self._cap}
