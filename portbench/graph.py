"""The HNSW graph, built on the device from exact candidates.

The port builds its graph on the host, one row at a time
(``repro_torch.core.hnsw.build_hnsw``, 3.1-5.2 ms a row on the card's
host), which does not fit a run's set-up at a million rows.  The port
serves a graph built elsewhere (``repro_torch.convert.from_reference_arrays``
is the loader ``FavorIndex.load`` uses), and the paper builds offline.  So
the benchmark builds the graph itself, in plain torch, with the port's
parameters and rules, and measures the serving.

Per level l, over the nodes whose drawn level is at least l:

* levels are drawn as floor(-ln U * ml), ml = 1 / ln M (HNSW's rule);
* candidates: each node's ``efc`` nearest among the nodes of the level
  inserted before it, HNSW's insertion in id order (ids are in random
  order): a node's candidates are drawn from the graph as it stood when
  the node came, so early nodes get the long links a sequential build
  gives them.  They come from row blocks of the distance matrix and a
  top-k, with squared distances formed as |v|^2 - 2 q.v + |q|^2.  The
  sequential build finds the candidates by a beam search with ef = efc
  instead of exactly;
* selection: the select-neighbours heuristic of ``core/hnsw.py``
  (``_Builder._select_arrays``): walk the candidates nearest first, keep
  one unless an already kept neighbour lies closer to it than the node
  does, stop at ``M0`` (level 0) or ``M`` kept, backfill with the nearest
  pruned ones.  The candidate-to-candidate distances come from the
  gathered rows' Gram matrices;
* reciprocal links: every selected edge is added in both directions, and
  each node's union of its own and its reverse edges (the nearest ``efc``
  of it) goes through the same heuristic to ``M0`` / ``M``, as HNSW
  shrinks a list that overflows;
* the entry point is the lowest id on the top level (the first node that
  reached it); Delta_d is Eq. 5 on the level-0 candidate curves, alpha-th
  against the last (beta = efc), accumulated as the port's builder does.

Every matmul runs in IEEE float32 (TF32 off): the build's own distances
are as exact as the reference's, and at this size cost no more than on
TF32 (the top-k over each block, not its dots, takes the time).

The result is the JAX package's ``HnswIndex`` layout as numpy arrays:
``levels[l]`` (N, M_l) int32 with -1 padding, ``node_level`` (N,) int16.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .reference import ieee_f32

ROW_BLOCK = 1024      # query rows of one distance block
GRAM_BLOCK = 256      # nodes of one gathered-Gram block (fits the L2)
SELECT_BLOCK = 4096   # nodes whose heuristic walk runs as one batch


def draw_levels(n: int, ml: float, gen: torch.Generator, device) -> torch.Tensor:
    """(n,) int64 levels, floor(-ln U * ml) with U in (0, 1]."""
    u = 1.0 - torch.rand((n,), generator=gen, device=device, dtype=torch.float64)
    return torch.floor(-torch.log(u.clamp(min=1e-12)) * ml).to(torch.int64)


def knn(vectors: torch.Tensor, norms: torch.Tensor, c: int):
    """Each row's ``c`` nearest rows among the rows before it (HNSW inserts
    in id order, and a node's candidates are the nodes already in the
    graph): (ids (n, c) int64 ascending by distance, -1 where a row has
    fewer rows before it; distances (n, c) f32, +inf there)."""
    n = vectors.shape[0]
    dev = vectors.device
    ids = torch.full((n, c), -1, dtype=torch.int64, device=dev)
    dist = torch.full((n, c), float("inf"), dtype=torch.float32, device=dev)
    for s in range(0, n, ROW_BLOCK):
        e = min(n, s + ROW_BLOCK)
        if e == 1:
            continue
        block = torch.addmm(norms[None, :e], vectors[s:e], vectors[:e].T,
                            beta=1.0, alpha=-2.0)
        rows = torch.arange(s, e, device=dev)
        later = rows[None, :] >= rows[:, None]        # itself and after
        block[:, s:] = torch.where(later, float("inf"), block[:, s:])
        kk = min(c, e - 1)
        val, pos = torch.topk(block, kk, dim=1, largest=False, sorted=True)
        found = torch.isfinite(val)
        ids[s:e, :kk] = torch.where(found, pos, -1)
        dist[s:e, :kk] = torch.where(
            found, torch.sqrt(torch.clamp(val + norms[s:e, None], min=0.0)),
            float("inf"))
        del block
    return ids, dist


def delta_d(cand_d: torch.Tensor, alpha: int) -> float:
    """Eq. 5 over the level-0 candidate curves, as the port's builder
    accumulates them (``_Builder.record_curve``): per node the alpha-th and
    the last (efc-th) candidate distance, summed over the nodes whose curve
    is long enough, the difference of the sums over the summed spans."""
    length = torch.isfinite(cand_d).sum(1)
    a = torch.clamp(length.clamp(max=alpha) - 1, min=0)
    b = length - 1
    use = b > a
    if not bool(use.any()):
        return 0.0
    d = cand_d.double()
    da = d.gather(1, a[:, None])[:, 0][use].sum()
    db = d.gather(1, b.clamp(min=0)[:, None])[:, 0][use].sum()
    return float((db - da) / (b - a)[use].sum().double().clamp(min=1e-12))


def select(vectors: torch.Tensor, cand: torch.Tensor, cand_d: torch.Tensor,
           m: int):
    """The select-neighbours heuristic over each row's ascending candidate
    list (-1 padded): (ids (n, m) int64 with -1 padding, their distances,
    the number of slots filled by the backfill)."""
    n, c = cand.shape
    dev = vectors.device
    kept = torch.zeros((n, c), dtype=torch.bool, device=dev)
    for s in range(0, n, SELECT_BLOCK):
        e = min(n, s + SELECT_BLOCK)
        ok = cand[s:e] >= 0
        dc2 = torch.empty((e - s, c, c), dtype=torch.float32, device=dev)
        for g0 in range(s, e, GRAM_BLOCK):
            g1 = min(e, g0 + GRAM_BLOCK)
            rows = vectors[cand[g0:g1].clamp(min=0)]        # (b, c, d)
            gram = torch.bmm(rows, rows.transpose(1, 2))
            nn = torch.diagonal(gram, dim1=1, dim2=2)
            dc2[g0 - s:g1 - s] = nn[:, :, None] + nn[:, None, :] - 2.0 * gram
        ds2 = cand_d[s:e].square()
        dom = torch.zeros_like(ok)
        keep = torch.zeros_like(ok)
        count = torch.zeros((e - s,), dtype=torch.int64, device=dev)
        for i in range(c):
            take = ok[:, i] & ~dom[:, i] & (count < m)
            keep[:, i] = take
            count += take.to(torch.int64)
            dom |= take[:, None] & (dc2[:, :, i] <= ds2)
        kept[s:e] = keep
        del dc2
    # kept ones first, then the backfill: the nearest pruned ones
    rank = torch.arange(c, device=dev).expand(n, c)
    key = torch.where(cand >= 0, rank + (~kept).to(torch.int64) * c, 2 * c)
    order = torch.sort(key, dim=1, stable=True).indices[:, :m]
    out = cand.gather(1, order)
    out_d = cand_d.gather(1, order)
    pad = key.gather(1, order) >= 2 * c
    backfill = int(((key.gather(1, order) >= c) & ~pad).sum())
    out = torch.where(pad, -1, out)
    return out, torch.where(pad, float("inf"), out_d), backfill


def union(sel: torch.Tensor, sel_d: torch.Tensor, cap: int):
    """Every selected edge in both directions: each row's union of its own
    and its reverse edges, nearest first, the nearest ``cap`` kept:
    (ids (n, cap) int64 -1 padded, distances (n, cap), +inf padded)."""
    n = sel.shape[0]
    dev = sel.device
    src = torch.arange(n, device=dev)[:, None].expand_as(sel)
    ok = sel >= 0
    a = torch.cat([src[ok], sel[ok]])
    b = torch.cat([sel[ok], src[ok]])
    d = torch.cat([sel_d[ok], sel_d[ok]])
    # one copy of each (a, b) pair, then per a its edges nearest first
    pair, first = torch.sort(a * n + b, stable=True)
    a, b, d = a[first], b[first], d[first]
    uniq = torch.ones_like(pair, dtype=torch.bool)
    uniq[1:] = pair[1:] != pair[:-1]
    a, b, d = a[uniq], b[uniq], d[uniq]
    order = torch.sort(d, stable=True).indices
    a, b, d = a[order], b[order], d[order]
    order = torch.sort(a, stable=True).indices
    a, b, d = a[order], b[order], d[order]
    start = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(torch.bincount(a, minlength=n), 0)
    pos = torch.arange(a.shape[0], device=dev) - start[a]
    keep = pos < cap
    ids = torch.full((n, cap), -1, dtype=torch.int64, device=dev)
    dist = torch.full((n, cap), float("inf"), dtype=torch.float32, device=dev)
    ids[a[keep], pos[keep]] = b[keep]
    dist[a[keep], pos[keep]] = d[keep]
    return ids, dist


def build(vectors: torch.Tensor, *, M: int, M0: int, efc: int, alpha: int,
          gen: torch.Generator) -> dict:
    """The graph of ``vectors`` (N, d) f32 on their device; see the module
    note.  Returns the arrays ``from_reference_arrays`` takes, as numpy
    (``levels``, ``node_level``, ``entry_point``, ``max_level``,
    ``delta_d``), and ``stats`` (seconds per part, and ``backfill``: the
    slots the first selection filled from pruned candidates)."""
    with ieee_f32():
        return _build(vectors, M=M, M0=M0, efc=efc, alpha=alpha, gen=gen)


def _build(vectors, *, M, M0, efc, alpha, gen) -> dict:
    n = vectors.shape[0]
    dev = vectors.device
    ml = 1.0 / math.log(M)
    stats = {"knn_s": 0.0, "select_s": 0.0, "link_s": 0.0, "backfill": 0}
    level = draw_levels(n, ml, gen, dev)
    max_level = int(level.max())
    norms = (vectors * vectors).sum(dim=1)
    levels = []
    dd = 0.0
    for lv in range(max_level + 1):
        m = M0 if lv == 0 else M
        arr = np.full((n, m), -1, np.int32)
        members = torch.nonzero(level >= lv)[:, 0]
        k = members.shape[0]
        if k > 1:
            sub = vectors if lv == 0 else vectors[members].contiguous()
            subn = norms if lv == 0 else norms[members]
            c = min(efc, k - 1)
            t = _sync_now(dev)
            cand, cand_d = knn(sub, subn, c)
            t = _lap(stats, "knn_s", t, dev)
            if lv == 0:
                dd = delta_d(cand_d, alpha)
            sel, sel_d, filled = select(sub, cand, cand_d, m)
            stats["backfill"] += filled
            del cand, cand_d
            t = _lap(stats, "select_s", t, dev)
            both, both_d = union(sel, sel_d, efc)
            local = select(sub, both, both_d, m)[0]
            del both, both_d
            glob = torch.where(local >= 0, members[local.clamp(min=0)], -1)
            arr[members.cpu().numpy()] = glob.to(torch.int32).cpu().numpy()
            _lap(stats, "link_s", t, dev)
        levels.append(arr)
    top = torch.nonzero(level == max_level)[:, 0]
    return {"levels": levels,
            "node_level": level.to(torch.int16).cpu().numpy(),
            "entry_point": int(top[0]), "max_level": max_level,
            "delta_d": dd, "stats": stats}


def _sync_now(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _lap(stats: dict, key: str, t0: float, dev) -> float:
    t1 = _sync_now(dev)
    stats[key] += t1 - t0
    return t1
