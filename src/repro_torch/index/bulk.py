"""HNSW bulk build: the candidate search of each wave runs on the device.

The sequential builder (core/hnsw.py) spends essentially all of its time in
``_search_layer`` -- a host-side heap walk, one query at a time.  This
module reuses ``favor_graph_search`` as the candidate generator:

 * new nodes are processed in *waves*; each wave runs ONE batched device
   search (an always-true filter program, D = 0, ef = efc, pbar guard off)
   over a snapshot of the graph built so far -- a plain beam search, the
   same Algorithm-1 candidates the host ``_search_layer(ef=efc)`` returns.
   On the card its neighbour blocks go through the ``gather_distance``
   kernel;
 * linking stays on the host: per node the returned ascending candidate row
   is fed through the builder's own ``_select_arrays`` heuristic +
   reciprocal ``_shrink``, and its Delta_d curve (Eq. 5) is recorded from
   the same row;
 * nodes that drew an upper level (~1/M of them) and the small-graph seed
   phase take the sequential ``_link_node`` path unchanged.

The graph snapshot is padded to a power-of-two row count (padded rows are
unreachable -- no edge points at them) and waves are power-of-two sized
with a ``valid`` lane mask on the ragged tail, as in the JAX package, so
the builder draws the same levels and links the same rows for one seed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.hnsw import HnswIndex, HnswParams, _Builder
from ..core.search import SearchConfig, favor_graph_search
from ..device import resolve_device

_MIN_PAD = 64     # smallest padded graph snapshot
_SEED_SEQ = 32    # graph smaller than this links sequentially (wave <= n rule)


def _builder_from_index(index: HnswIndex, capacity: int) -> _Builder:
    """Re-open a finalized index as a mutable builder with room for
    ``capacity`` total rows.  The Delta_d accumulator is primed with
    pseudo-sums reproducing the stored slope, so Eq. 5 over the grown index
    is the count-weighted blend of the old estimate and the new curves."""
    n = index.n
    p = index.params
    b = _Builder(index.dim, p, capacity)
    b.vectors[:n] = index.vectors
    b.norms[:n] = index.norms.astype(np.float32)
    b.adj = [
        [[int(u) for u in index.levels[lv][v] if u >= 0]
         for lv in range(int(index.node_level[v]) + 1)]
        for v in range(n)
    ]
    b.node_level = [int(x) for x in index.node_level]
    b.entry_point = int(index.entry_point)
    b.max_level = int(index.max_level)
    b.n = n
    # fresh stream, offset so repeated merges don't replay the build's draws
    b.rng = np.random.default_rng(p.seed + n + 1)
    if n > 0:
        span = float(n) * float(max(p.efc - p.alpha, 1))
        b._d_alpha_sum = 0.0
        b._d_beta_sum = float(index.delta_d) * span
        b._d_span_sum = span
        b._d_count = n
    return b


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _graph_view(b: _Builder, npad: int, device) -> dict:
    """The builder's current adjacency as a padded graph dict on ``device``
    (dummy always-pass attributes: one int column, no float column)."""
    n = b.n
    p = b.p
    vecs = np.zeros((npad, b.dim), np.float32)
    vecs[:n] = b.vectors[:n]
    norms = np.full((npad,), np.inf, np.float32)
    norms[:n] = b.norms[:n]
    nb0 = np.full((npad, p.M0), -1, np.int32)
    for v in range(n):
        row = b.adj[v][0][: p.M0]
        nb0[v, : len(row)] = row
    if b.max_level >= 1:
        upper = np.full((b.max_level, npad, p.M), -1, np.int32)
        for v in range(n):
            for lv in range(1, len(b.adj[v])):
                row = b.adj[v][lv][: p.M]
                upper[lv - 1, v, : len(row)] = row
    else:
        upper = np.zeros((0, npad, p.M), np.int32)
    return {
        "vectors": torch.as_tensor(vecs, device=device),
        "norms": torch.as_tensor(norms, device=device),
        "neighbors0": torch.as_tensor(nb0, device=device),
        "upper": torch.as_tensor(upper, device=device),
        "entry": int(b.entry_point),
        "attrs_int": torch.zeros((npad, 1), dtype=torch.int32, device=device),
        "attrs_float": torch.zeros((npad, 0), dtype=torch.float32,
                                   device=device),
    }


def _true_programs(batch: int, device) -> dict:
    """Always-true filter program batch matching the dummy attribute shapes
    of ``_graph_view`` (one int column, full-vocab mask; no float columns)."""
    return {
        "valid": torch.ones((batch, 1), dtype=torch.float32, device=device),
        "imask": torch.full((batch, 1, 1), 0xFFFFFFFF, dtype=torch.int64,
                            device=device),
        "flo": torch.zeros((batch, 1, 0), dtype=torch.float32, device=device),
        "fhi": torch.zeros((batch, 1, 0), dtype=torch.float32, device=device),
    }


def _link_from_row(b: _Builder, node: int, ids: np.ndarray,
                   ds: np.ndarray) -> None:
    """Host-side level-0 linking from one ascending device candidate row."""
    b.record_curve(ds)
    sel = b._select_arrays(ids.astype(np.int64), ds, b.p.M0)
    b.adj[node][0] = list(sel)
    for u in sel:
        b.adj[u][0].append(node)
        b._shrink(u, 0, b.p.M0)


def bulk_add(index: HnswIndex, new_vectors: np.ndarray, *,
             wave: int = 512, link: np.ndarray | None = None,
             device=None) -> HnswIndex:
    """Append ``new_vectors`` to a finalized index and return the grown one.

    ``link`` (optional bool mask per new row) marks which rows participate
    in the graph: False rows are *registered* -- they occupy their row
    position, keeping ids positional -- but never linked, which is how
    ``merge()`` carries already-tombstoned delta slots.  Rows keep their
    order: new row j becomes node ``index.n + j``.

    The candidate searches run on ``device`` (None = the CUDA device,
    which raises without a card; pass "cpu" for the plain versions).
    """
    device = resolve_device(device)
    new_vectors = np.ascontiguousarray(new_vectors, np.float32)
    m = new_vectors.shape[0]
    if m and new_vectors.shape[1] != index.dim:
        raise ValueError(f"bulk_add rows must be dim={index.dim}, "
                         f"got {new_vectors.shape[1]}")
    link = (np.ones((m,), bool) if link is None
            else np.asarray(link, bool).reshape(m))
    b = _builder_from_index(index, index.n + m)
    cfg = SearchConfig(k=b.p.efc, ef=b.p.efc, pbar_min=0.0, gamma=1.0)

    i = 0
    while i < m:
        # sequential seed / trickle: tiny graphs
        if b.n < _SEED_SEQ:
            node = b._register(new_vectors[i], b.draw_level() if link[i] else 0)
            if link[i]:
                b._link_node(node, new_vectors[i], b.node_level[node])
            i += 1
            continue

        # wave size: pow-2, never larger than the current graph (so every
        # node still links against a graph at least its wave's size)
        w = _pow2_at_least(min(wave, b.n, m - i) + 1) // 2
        w = max(w, 1)
        batch = new_vectors[i: i + w]
        lanes = link[i: i + w]
        wb = batch.shape[0]

        if not lanes.any():
            for j in range(wb):
                b._register(batch[j], 0)
            i += wb
            continue

        # one batched candidate search over the pre-wave snapshot
        npad = _pow2_at_least(max(b.n, _MIN_PAD))
        g = _graph_view(b, npad, device)
        qpad = np.zeros((w, b.dim), np.float32)
        qpad[:wb] = batch
        lane_valid = np.zeros((w,), bool)
        lane_valid[:wb] = lanes
        out = favor_graph_search(
            g, torch.as_tensor(qpad, device=device),
            _true_programs(w, device),
            torch.zeros((w,), dtype=torch.float32, device=device), cfg,
            valid=lane_valid)
        cand_i = out["ids"].cpu().numpy()
        cand_d = out["dists"].cpu().numpy()

        for j in range(wb):
            if not lanes[j]:
                b._register(batch[j], 0)
                continue
            lvl = b.draw_level()
            node = b._register(batch[j], lvl)
            row = cand_i[j]
            keep = (row >= 0) & np.isfinite(cand_d[j])
            if lvl > 0 or not keep.any():
                # upper-level node (needs per-level descent) or a lane the
                # device search came back empty for: sequential path
                b._link_node(node, batch[j], lvl)
            else:
                _link_from_row(b, node, row[keep], cand_d[j][keep])
        i += wb

    return b.finalize()


def build_hnsw_bulk(vectors: np.ndarray, params: HnswParams | None = None,
                    *, wave: int = 512, device=None) -> HnswIndex:
    """Build an index from scratch through the wave pipeline (a from-zero
    ``bulk_add``)."""
    params = params or HnswParams()
    vectors = np.ascontiguousarray(vectors, np.float32)
    empty = HnswIndex(
        vectors=np.zeros((0, vectors.shape[1]), np.float32),
        levels=[np.zeros((0, params.M0), np.int32)],
        node_level=np.zeros((0,), np.int16),
        entry_point=-1, max_level=-1, delta_d=0.0, params=params,
        norms=np.zeros((0,), np.float32))
    return bulk_add(empty, vectors, wave=wave, device=device)
