"""Neighbor sampler for sampled-subgraph GNN training (minibatch_lg cell).

A real fanout sampler (GraphSAGE, arXiv:1706.02216): CSR adjacency built
once; per batch, seed nodes expand layer by layer with per-node uniform
neighbor sampling (fanout_l at layer l), producing a *padded static-shape*
subgraph (node list, remapped edge index, features) that the standard GCN
forward consumes unchanged.  Static shapes = one compiled program for every
batch; padding edges carry (-1, -1).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (E,)

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @staticmethod
    def from_edges(edges: np.ndarray, n_nodes: int) -> "CSRGraph":
        src, dst = edges[0], edges[1]
        order = np.argsort(dst, kind="stable")  # CSR over incoming edges
        s = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return CSRGraph(indptr, s.astype(np.int32))

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator) -> np.ndarray:
        """(B,) -> (B, fanout) sampled in-neighbors, -1 padded."""
        out = np.full((len(nodes), fanout), -1, np.int32)
        for i, v in enumerate(nodes):
            lo, hi = self.indptr[v], self.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(fanout, deg)
            sel = rng.choice(deg, size=take, replace=deg < fanout)
            out[i, :take] = self.indices[lo + sel]
        return out


def sample_subgraph(csr: CSRGraph, feats: np.ndarray, labels: np.ndarray,
                    seeds: np.ndarray, fanouts: tuple, rng) -> dict:
    """Layered fanout expansion -> padded block-diagonal-free subgraph.

    Returns dict with x (Nmax, F), edges (2, Emax), deg, labels (Nmax,),
    mask (Nmax,) -- True only at seed rows -- with STATIC shapes given by
    (len(seeds), fanouts)."""
    n_max = len(seeds)
    e_max = 0
    layer_sizes = [len(seeds)]
    for f in fanouts:
        e_max += layer_sizes[-1] * f
        layer_sizes.append(layer_sizes[-1] * f)
        n_max += layer_sizes[-1]

    node_ids = np.full(n_max, -1, np.int64)
    node_ids[: len(seeds)] = seeds
    local = {int(v): i for i, v in enumerate(seeds)}
    n_used = len(seeds)

    edges = np.full((2, e_max + n_max), -1, np.int32)  # + self loops
    e_used = 0
    frontier = np.asarray(seeds)
    for f in fanouts:
        nbrs = csr.sample_neighbors(frontier, f, rng)   # (B, f)
        next_frontier = []
        for i, v in enumerate(frontier):
            vi = local[int(v)]
            for u in nbrs[i]:
                if u < 0:
                    continue
                ui = local.get(int(u))
                if ui is None:
                    ui = n_used
                    local[int(u)] = ui
                    node_ids[ui] = u
                    n_used += 1
                edges[0, e_used] = ui
                edges[1, e_used] = vi
                e_used += 1
                next_frontier.append(u)
        frontier = np.asarray(next_frontier, np.int64) if next_frontier else frontier[:0]
        if len(frontier) == 0:
            break
    # self-loops on used nodes
    for i in range(n_used):
        edges[0, e_used] = i
        edges[1, e_used] = i
        e_used += 1

    ids_safe = np.maximum(node_ids, 0)
    x = feats[ids_safe].astype(np.float32)
    x[node_ids < 0] = 0.0
    lab = labels[ids_safe].astype(np.int32)
    deg = np.zeros(n_max, np.float32)
    valid_e = edges[1] >= 0
    np.add.at(deg, edges[1][valid_e], 1.0)
    mask = np.zeros(n_max, bool)
    mask[: len(seeds)] = True
    return {"x": x, "edges": edges, "deg": deg, "labels": lab, "mask": mask,
            "n_used": n_used}


def minibatch_shapes(batch_nodes: int, fanouts: tuple, d_feat: int):
    """Static shapes of a sampled subgraph (for the dry-run input specs)."""
    n_max = batch_nodes
    e_max = 0
    sz = batch_nodes
    for f in fanouts:
        e_max += sz * f
        sz *= f
        n_max += sz
    return {"n": n_max, "e": e_max + n_max, "d": d_feat}
