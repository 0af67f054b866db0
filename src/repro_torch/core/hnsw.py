"""Offline HNSW construction (paper Section 2.2) with Delta_d recording.

FAVOR deliberately uses a *conventional* proximity graph (guideline G.1): the
index is a vanilla HNSW built with the standard insertion algorithm and the
select-neighbors heuristic -- no attribute-aware edges.  Construction is an
offline, host-side phase (the paper builds on CPU too), so this module is
plain numpy; the *search* phase is the device-side torch/CUDA code in
search.py.

During construction we record, for every inserted node, the distance to its
alpha-th and beta-th (= efc-th) nearest candidates (paper section 6.3.1 uses
the efc-range candidates as approximate alpha/beta-th nearest neighbors) and
store the dataset-global Delta_d (Eq. 5) in the index metadata.

The finalized index is a set of flat, padded int32 neighbor arrays -- exactly
the layout the device search consumes.  The ``.npz`` layout of ``save`` is
the JAX package's, so indexes move between the two packages unchanged.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np



@dataclass
class HnswParams:
    M: int = 16            # max degree at levels > 0
    M0: int | None = None  # max degree at base layer (default 2M)
    efc: int = 100         # construction beam width
    ml: float | None = None  # level sampling scale (default 1/ln M)
    alpha: int = 10        # Delta_d curve anchor (paper: alpha=10, beta=efc)
    heuristic: bool = True  # select-neighbors heuristic vs simple closest
    seed: int = 0

    def __post_init__(self):
        if self.M0 is None:
            self.M0 = 2 * self.M
        if self.ml is None:
            self.ml = 1.0 / math.log(self.M)


@dataclass
class HnswIndex:
    vectors: np.ndarray          # (N, d) float32
    levels: list[np.ndarray]     # levels[l]: (N, M_l) int32 neighbor ids, -1 pad
    node_level: np.ndarray       # (N,) int16 topmost level of each node
    entry_point: int             # -1 when the graph has no linked node
    max_level: int
    delta_d: float
    params: HnswParams
    norms: np.ndarray = field(default=None)  # (N,) |v|^2 cache
    # persisted quantization state (save/load round-trips it alongside the
    # graph arrays): {"kind": "pq"|"sq", "codes": (N, *) uint8, "dim": int,
    # plus the codebook tables} -- None when the index carries no codes
    quant_state: dict | None = field(default=None, repr=False)

    def __post_init__(self):
        if self.norms is None:
            self.norms = np.einsum("nd,nd->n", self.vectors, self.vectors)

    @property
    def n(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    def neighbors(self, node: int, level: int) -> np.ndarray:
        row = self.levels[level][node]
        return row[row >= 0]

    def storage_bytes(self) -> int:
        b = self.vectors.nbytes + self.node_level.nbytes
        for lv in self.levels:
            b += lv.nbytes
        return b

    def save(self, path: str, quant: dict | None = None) -> None:
        """Persist the index; ``quant`` (or ``self.quant_state``) rides along
        under ``quant_*`` keys so a reloaded index can serve the compressed
        routes without re-training or re-encoding."""
        arrs = {f"level_{l}": lv for l, lv in enumerate(self.levels)}
        q = quant if quant is not None else self.quant_state
        if q is not None:
            arrs.update({f"quant_{k}": np.asarray(v) for k, v in q.items()})
        np.savez_compressed(
            path, vectors=self.vectors, node_level=self.node_level,
            entry_point=self.entry_point, max_level=self.max_level,
            delta_d=self.delta_d, n_levels=len(self.levels),
            params=np.array([self.params.M, self.params.M0, self.params.efc,
                             self.params.alpha, self.params.seed], np.int64),
            ml=self.params.ml, **arrs)

    @staticmethod
    def load(path: str) -> "HnswIndex":
        z = np.load(path)
        n_levels = int(z["n_levels"])
        M, M0, efc, alpha, seed = (int(x) for x in z["params"])
        params = HnswParams(M=M, M0=M0, efc=efc, alpha=alpha, seed=seed,
                            ml=float(z["ml"]))
        quant_state = None
        qkeys = [k for k in z.files if k.startswith("quant_")]
        if qkeys:
            quant_state = {}
            for k in qkeys:
                v = z[k]
                name = k[len("quant_"):]
                if name == "kind":
                    quant_state[name] = str(v)
                elif name == "dim":
                    quant_state[name] = int(v)
                else:
                    quant_state[name] = v
        return HnswIndex(
            vectors=z["vectors"],
            levels=[z[f"level_{l}"] for l in range(n_levels)],
            node_level=z["node_level"],
            entry_point=int(z["entry_point"]),
            max_level=int(z["max_level"]),
            delta_d=float(z["delta_d"]),
            params=params,
            quant_state=quant_state,
        )


class _Builder:
    """Insertion-based construction with list-of-list adjacency."""

    def __init__(self, dim: int, params: HnswParams, capacity: int):
        self.p = params
        self.dim = dim
        self.vectors = np.zeros((capacity, dim), np.float32)
        self.norms = np.zeros((capacity,), np.float32)
        self.adj: list[list[list[int]]] = []  # adj[node][level] -> neighbor ids
        self.node_level: list[int] = []
        self.entry_point = -1
        self.max_level = -1
        self.n = 0
        self.rng = np.random.default_rng(params.seed)
        self._d_alpha_sum = 0.0
        self._d_beta_sum = 0.0
        self._d_span_sum = 0.0
        self._d_count = 0

    # -- distances ----------------------------------------------------------
    def _dist_many(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        v = self.vectors[ids]
        d2 = self.norms[ids] - 2.0 * (v @ q) + q @ q
        return np.sqrt(np.maximum(d2, 0.0))

    # -- greedy layer search --------------------------------------------------
    def _search_layer(self, q: np.ndarray, eps: list[tuple[float, int]], ef: int,
                      level: int) -> list[tuple[float, int]]:
        """GreedySearch (Algorithm 1).  Returns ascending (dist, id) list."""
        visited = set()
        cand: list[tuple[float, int]] = []   # min-heap
        res: list[tuple[float, int]] = []    # max-heap via negated dist
        for d, e in eps:
            if e in visited:
                continue
            visited.add(e)
            heapq.heappush(cand, (d, e))
            heapq.heappush(res, (-d, e))
        while cand:
            d_a, v_a = heapq.heappop(cand)
            if d_a > -res[0][0]:
                break
            nbrs = [u for u in self.adj[v_a][level] if u not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            ids = np.asarray(nbrs, np.int64)
            ds = self._dist_many(q, ids)
            for d, u in zip(ds.tolist(), nbrs):
                if len(res) < ef or d < -res[0][0]:
                    heapq.heappush(cand, (d, u))
                    heapq.heappush(res, (-d, u))
                    if len(res) > ef:
                        heapq.heappop(res)
        out = sorted((-nd, u) for nd, u in res)
        return out

    # -- neighbor selection ---------------------------------------------------
    def _select_arrays(self, ids: np.ndarray, ds: np.ndarray, m: int) -> list[int]:
        """select_neighbors_heuristic: keep c iff it is closer to q than to any
        already-kept neighbor (relative-neighborhood pruning).  ``ids``/``ds``
        must be ascending by distance.  One (c x c) GEMM, then a cheap greedy."""
        c = len(ids)
        if not self.p.heuristic or c <= m:
            return [int(u) for u in ids[:m]]
        v = self.vectors[ids]
        nn = self.norms[ids]
        dc2 = nn[:, None] + nn[None, :] - 2.0 * (v @ v.T)  # squared cand-cand
        ds2 = ds * ds
        # greedy RNG prune: i is dominated once some kept j has d(i,j) <= d(q,i);
        # one vectorized update per KEPT element.
        dom = np.zeros(c, bool)
        kept: list[int] = []
        for i in range(c):
            if len(kept) >= m:
                break
            if dom[i]:
                continue
            kept.append(i)
            dom |= dc2[:, i] <= ds2
        if len(kept) < m:  # backfill with closest pruned candidates
            chosen = np.zeros(c, bool)
            chosen[kept] = True
            for i in range(c):
                if len(kept) >= m:
                    break
                if not chosen[i]:
                    kept.append(i)
        return [int(ids[i]) for i in kept]

    def _select(self, cands: list[tuple[float, int]], m: int) -> list[int]:
        ids = np.asarray([u for _, u in cands], np.int64)
        ds = np.asarray([d for d, _ in cands])
        return self._select_arrays(ids, ds, m)

    def _shrink(self, node: int, level: int, m: int) -> None:
        lst = self.adj[node][level]
        if len(lst) <= m:
            return
        ids = np.asarray(lst, np.int64)
        ds = self._dist_many(self.vectors[node], ids)
        order = np.argsort(ds, kind="stable")
        self.adj[node][level] = self._select_arrays(ids[order], ds[order], m)

    # -- insertion ------------------------------------------------------------
    def _register(self, q: np.ndarray, lvl: int) -> int:
        """Allocate a node row (vector + empty adjacency) without linking."""
        node = self.n
        self.vectors[node] = q
        self.norms[node] = float(q @ q)
        self.adj.append([[] for _ in range(lvl + 1)])
        self.node_level.append(lvl)
        self.n += 1
        return node

    def record_curve(self, curve: np.ndarray) -> None:
        """Eq. 5 slope from one node's ascending candidate-distance curve
        (approximate alpha-th / beta-th nearest neighbors, section 6.3.1).
        Shared by the sequential insert loop and the bulk-build path."""
        if len(curve) < 2:
            return
        a = min(self.p.alpha, len(curve)) - 1
        b = len(curve) - 1
        if b > a:
            self._d_alpha_sum += float(curve[a])
            self._d_beta_sum += float(curve[b])
            self._d_span_sum += float(b - a)
            self._d_count += 1

    def draw_level(self) -> int:
        return int(-math.log(max(self.rng.random(), 1e-12)) * self.p.ml)

    def _link_node(self, node: int, q: np.ndarray, lvl: int) -> None:
        """Descend + per-level candidate search + reciprocal linking for an
        already-registered node (the body of the standard insert)."""
        if self.entry_point < 0:
            self.entry_point = node
            self.max_level = lvl
            return

        ep = self.entry_point
        d_ep = float(self._dist_many(q, np.asarray([ep]))[0])
        eps = [(d_ep, ep)]
        for level in range(self.max_level, lvl, -1):
            eps = self._search_layer(q, eps, 1, level)[:1]

        for level in range(min(lvl, self.max_level), -1, -1):
            cands = self._search_layer(q, eps, self.p.efc, level)
            if level == 0:
                self.record_curve(np.asarray([d for d, _ in cands]))
            m = self.p.M0 if level == 0 else self.p.M
            sel = self._select(cands, m)
            self.adj[node][level] = list(sel)
            for u in sel:
                self.adj[u][level].append(node)
                self._shrink(u, level, m)
            eps = cands
        if lvl > self.max_level:
            self.max_level = lvl
            self.entry_point = node

    def insert(self, q: np.ndarray) -> int:
        node = self._register(q, self.draw_level())
        self._link_node(node, q, self.node_level[node])
        return node

    # -- finalize --------------------------------------------------------------
    def finalize(self) -> HnswIndex:
        n = self.n
        levels: list[np.ndarray] = []
        # always emit level 0, even for an empty or all-unlinked builder:
        # downstream consumers (graph_arrays, the sharded flatten) index
        # levels[0] unconditionally
        for level in range(max(self.max_level, 0) + 1):
            m = self.p.M0 if level == 0 else self.p.M
            arr = np.full((n, m), -1, np.int32)
            for v in range(n):
                if level < len(self.adj[v]):
                    nb = self.adj[v][level][:m]
                    arr[v, : len(nb)] = nb
            levels.append(arr)
        if self._d_count:
            # Eq. 5: Delta_d = (mean d_beta - mean d_alpha) / (beta - alpha)
            delta_d = (self._d_beta_sum - self._d_alpha_sum) / max(
                self._d_span_sum, 1e-12)
        else:
            delta_d = 0.0
        return HnswIndex(
            vectors=self.vectors[:n].copy(),
            levels=levels,
            node_level=np.asarray(self.node_level, np.int16),
            entry_point=self.entry_point,
            max_level=self.max_level,
            delta_d=float(delta_d),
            params=self.p,
            norms=self.norms[:n].copy(),
        )


def build_hnsw(vectors: np.ndarray, params: HnswParams | None = None,
               progress_every: int = 0) -> HnswIndex:
    """Build an HNSW index over ``vectors`` (N, d) float32."""
    params = params or HnswParams()
    vectors = np.ascontiguousarray(vectors, np.float32)
    b = _Builder(vectors.shape[1], params, vectors.shape[0])
    for i in range(vectors.shape[0]):
        b.insert(vectors[i])
        if progress_every and (i + 1) % progress_every == 0:
            print(f"  hnsw build {i + 1}/{vectors.shape[0]}")
    return b.finalize()
