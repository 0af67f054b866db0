"""Pure numpy/python oracle implementations (exact paper semantics).

These are the correctness references for the torch/CUDA production path:
 * ``favor_search``       -- Algorithms 2 + 3 with real unbounded heaps,
                             exclusion distance (Eq. 2) and the optimized
                             termination condition (section 5.4).
 * ``rsf_search``         -- Result-Set Filtering baseline (section 2.3.1):
                             identical to HNSW except only TD may enter R.
 * ``acorn_search``       -- ACORN-esque baseline: the search path extends
                             only through TD neighbors (distances computed for
                             TD only), with optional 2-hop expansion when the
                             1-hop neighborhood has no TD (ACORN-1 style).
 * ``postfilter_search``  -- vanilla HNSW with inflated ef, filter applied to
                             the result set afterwards.
 * ``bruteforce_filtered``-- exact ground truth (recall denominators).

All searches return (ids, dists) of the k nearest *target* points, ascending,
plus a stats dict (distance computations, hops, TD-on-path proportion) used by
the verification benchmarks (paper Figs. 12/13).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from .hnsw import HnswIndex


@dataclass
class SearchStats:
    dist_comps: int = 0
    hops: int = 0
    path_td: int = 0  # TD points among path-extension nodes
    terminated_early: bool = False

    @property
    def path_td_fraction(self) -> float:
        return self.path_td / max(1, self.hops)


def _dists(index: HnswIndex, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
    v = index.vectors[ids]
    d2 = index.norms[ids] - 2.0 * (v @ q) + float(q @ q)
    return np.sqrt(np.maximum(d2, 0.0))


def _descend(index: HnswIndex, q: np.ndarray, stats: SearchStats) -> tuple[float, int]:
    """Upper-layer greedy descent, ef=1, no filtering (Algorithm 2 lines 5-7)."""
    ep = index.entry_point
    d = float(_dists(index, q, np.asarray([ep]))[0])
    stats.dist_comps += 1
    for level in range(index.max_level, 0, -1):
        improved = True
        while improved:
            improved = False
            nbrs = index.neighbors(ep, level)
            if len(nbrs) == 0:
                break
            ds = _dists(index, q, nbrs)
            stats.dist_comps += len(nbrs)
            j = int(np.argmin(ds))
            if ds[j] < d:
                d, ep = float(ds[j]), int(nbrs[j])
                improved = True
    return d, ep


def bruteforce_filtered(vectors: np.ndarray, mask: np.ndarray, q: np.ndarray,
                        k: int) -> tuple[np.ndarray, np.ndarray]:
    ids = np.nonzero(mask)[0]
    if len(ids) == 0:
        return np.empty((0,), np.int64), np.empty((0,), np.float64)
    d = np.linalg.norm(vectors[ids] - q[None, :], axis=1)
    order = np.argsort(d, kind="stable")[:k]
    return ids[order], d[order]


# ---------------------------------------------------------------------------
# FAVOR (Algorithms 2 + 3)
# ---------------------------------------------------------------------------
def favor_search(index: HnswIndex, q: np.ndarray, mask: np.ndarray, k: int,
                 ef: int, D: float, *, pbar_min: float = 0.5,
                 gamma: float = 1.0) -> tuple[np.ndarray, np.ndarray, SearchStats]:
    """OptiGreedySearch with exclusion distance.

    mask : (N,) bool -- True for TD (attributes satisfy the filter).
    D    : exclusion distance added to every NTD (Eq. 2).
    pbar_min : TD-fraction termination threshold (0 disables the section 5.4
               optimization and recovers the plain adjusted-distance rule).
    Distances stored in C and R are the *adjusted* Dis_bar values; the final
    S is the k nearest TD in R under true distance ordering (identical to
    Dis_bar ordering for TD since their distance is unmodified).
    """
    stats = SearchStats()
    _, ep = _descend(index, q, stats)

    d_ep = float(_dists(index, q, np.asarray([ep]))[0])
    dbar_ep = d_ep + (0.0 if mask[ep] else D)
    visited = {ep}
    cand = [(dbar_ep, ep)]              # min-heap over Dis_bar
    res: list[tuple[float, int]] = [(-dbar_ep, ep)]  # max-heap over Dis_bar
    n_td = 1 if mask[ep] else 0

    while cand:
        dbar_a, v_a = heapq.heappop(cand)
        worst = -res[0][0]
        if dbar_a > gamma * worst and len(res) >= ef:
            pbar = n_td / len(res)
            if pbar_min <= 0.0 or pbar > pbar_min:
                stats.terminated_early = True
                break
            # conservative strategy: keep exploring until enough TD in R
        stats.hops += 1
        if mask[v_a]:
            stats.path_td += 1
        nbrs = [u for u in index.neighbors(v_a, 0) if u not in visited]
        if not nbrs:
            continue
        visited.update(nbrs)
        ids = np.asarray(nbrs, np.int64)
        ds = _dists(index, q, ids)
        stats.dist_comps += len(nbrs)
        dbars = ds + np.where(mask[ids], 0.0, D)
        for dbar, u in zip(dbars.tolist(), nbrs):
            worst = -res[0][0]
            if dbar < worst or len(res) < ef:
                heapq.heappush(cand, (dbar, u))
                heapq.heappush(res, (-dbar, u))
                if mask[u]:
                    n_td += 1
                if len(res) > ef:
                    _, evicted = heapq.heappop(res)
                    if mask[evicted]:
                        n_td -= 1

    pairs = sorted((-nd, u) for nd, u in res)
    td = [(d, u) for d, u in pairs if mask[u]][:k]
    ids = np.asarray([u for _, u in td], np.int64)
    return ids, _dists(index, q, ids) if len(ids) else np.empty((0,)), stats


# ---------------------------------------------------------------------------
# Result-Set Filtering (RSF) baseline
# ---------------------------------------------------------------------------
def rsf_search(index: HnswIndex, q: np.ndarray, mask: np.ndarray, k: int,
               ef: int) -> tuple[np.ndarray, np.ndarray, SearchStats]:
    """hnswlib-style result-set filtering: C takes everything, R only TD."""
    stats = SearchStats()
    _, ep = _descend(index, q, stats)

    d_ep = float(_dists(index, q, np.asarray([ep]))[0])
    visited = {ep}
    cand = [(d_ep, ep)]
    res: list[tuple[float, int]] = []
    if mask[ep]:
        heapq.heappush(res, (-d_ep, ep))

    while cand:
        d_a, v_a = heapq.heappop(cand)
        if len(res) >= ef and d_a > -res[0][0]:
            stats.terminated_early = True
            break
        stats.hops += 1
        if mask[v_a]:
            stats.path_td += 1
        nbrs = [u for u in index.neighbors(v_a, 0) if u not in visited]
        if not nbrs:
            continue
        visited.update(nbrs)
        ids = np.asarray(nbrs, np.int64)
        ds = _dists(index, q, ids)
        stats.dist_comps += len(nbrs)
        for d, u in zip(ds.tolist(), nbrs):
            if len(res) < ef or d < -res[0][0]:
                heapq.heappush(cand, (d, u))
                if mask[u]:
                    heapq.heappush(res, (-d, u))
                    if len(res) > ef:
                        heapq.heappop(res)

    pairs = sorted((-nd, u) for nd, u in res)[:k]
    ids = np.asarray([u for _, u in pairs], np.int64)
    ds = np.asarray([d for d, _ in pairs])
    return ids, ds, stats


# ---------------------------------------------------------------------------
# ACORN-esque predicate-first baseline
# ---------------------------------------------------------------------------
def acorn_search(index: HnswIndex, q: np.ndarray, mask: np.ndarray, k: int,
                 ef: int, *, two_hop: bool = True
                 ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
    """Search-path extension restricted to TD; distances computed on TD only.

    Emulates ACORN-1 on a conventional graph: neighbor lists are filtered by
    the predicate *before* distance computation; if no 1-hop TD neighbor
    exists, expand to the 2-hop neighborhood (ACORN's neighbor expansion)."""
    stats = SearchStats()
    _, ep0 = _descend(index, q, stats)

    # walk to a TD entry if the descent landed on NTD
    start = None
    frontier = [ep0]
    seen = {ep0}
    for _ in range(64):
        tds = [u for u in frontier if mask[u]]
        if tds:
            start = tds
            break
        nxt = []
        for u in frontier:
            for w in index.neighbors(u, 0):
                if w not in seen:
                    seen.add(w)
                    nxt.append(w)
        if not nxt:
            break
        frontier = nxt
    if start is None:
        return np.empty((0,), np.int64), np.empty((0,)), stats

    ids0 = np.asarray(start, np.int64)
    ds0 = _dists(index, q, ids0)
    stats.dist_comps += len(ids0)
    visited = set(start)
    cand = [(float(d), int(u)) for d, u in zip(ds0, ids0)]
    heapq.heapify(cand)
    res = [(-d, u) for d, u in cand]
    heapq.heapify(res)
    while len(res) > ef:
        heapq.heappop(res)

    while cand:
        d_a, v_a = heapq.heappop(cand)
        if len(res) >= ef and d_a > -res[0][0]:
            stats.terminated_early = True
            break
        stats.hops += 1
        stats.path_td += 1  # path is TD-only by construction
        nbrs1 = index.neighbors(v_a, 0)
        td_nbrs = [u for u in nbrs1 if mask[u] and u not in visited]
        if not td_nbrs and two_hop:
            for u in nbrs1:
                for w in index.neighbors(u, 0):
                    if mask[w] and w not in visited:
                        td_nbrs.append(int(w))
        if not td_nbrs:
            continue
        visited.update(td_nbrs)
        ids = np.asarray(td_nbrs, np.int64)
        ds = _dists(index, q, ids)
        stats.dist_comps += len(ids)
        for d, u in zip(ds.tolist(), td_nbrs):
            if len(res) < ef or d < -res[0][0]:
                heapq.heappush(cand, (d, u))
                heapq.heappush(res, (-d, u))
                if len(res) > ef:
                    heapq.heappop(res)

    pairs = sorted((-nd, u) for nd, u in res)[:k]
    ids = np.asarray([u for _, u in pairs], np.int64)
    ds = np.asarray([d for d, _ in pairs])
    return ids, ds, stats


# ---------------------------------------------------------------------------
# Post-filtering baseline
# ---------------------------------------------------------------------------
def postfilter_search(index: HnswIndex, q: np.ndarray, mask: np.ndarray, k: int,
                      ef: int) -> tuple[np.ndarray, np.ndarray, SearchStats]:
    """Vanilla HNSW search with beam ef, filter applied to R afterwards."""
    stats = SearchStats()
    _, ep = _descend(index, q, stats)
    d_ep = float(_dists(index, q, np.asarray([ep]))[0])
    visited = {ep}
    cand = [(d_ep, ep)]
    res = [(-d_ep, ep)]
    while cand:
        d_a, v_a = heapq.heappop(cand)
        if d_a > -res[0][0] and len(res) >= ef:
            break
        stats.hops += 1
        if mask[v_a]:
            stats.path_td += 1
        nbrs = [u for u in index.neighbors(v_a, 0) if u not in visited]
        if not nbrs:
            continue
        visited.update(nbrs)
        ids = np.asarray(nbrs, np.int64)
        ds = _dists(index, q, ids)
        stats.dist_comps += len(nbrs)
        for d, u in zip(ds.tolist(), nbrs):
            if len(res) < ef or d < -res[0][0]:
                heapq.heappush(cand, (d, u))
                heapq.heappush(res, (-d, u))
                if len(res) > ef:
                    heapq.heappop(res)
    pairs = sorted((-nd, u) for nd, u in res)
    td = [(d, u) for d, u in pairs if mask[u]][:k]
    ids = np.asarray([u for _, u in td], np.int64)
    ds = np.asarray([d for d, _ in td])
    return ids, ds, stats


def recall_at_k(found: np.ndarray, truth: np.ndarray, k: int) -> float:
    if len(truth) == 0:
        return 1.0
    t = set(truth[:k].tolist())
    return len(t.intersection(set(found[:k].tolist()))) / min(k, len(t))
