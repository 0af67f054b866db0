"""Deterministic synthetic data (no downloads): numpy from a seed, the same
bits as the JAX package's generators for the same seed -- FAVOR's vector
datasets, and the token, recsys and graph pipelines of the model zoo.

Every pipeline is a pure function of (seed, step): checkpointable by
storing the integer state, and resumable bitwise.

Vector datasets follow the paper's section 6.1.2 generation: Gaussian-mixture
vectors (clustered, like SIFT/GIST structure) + attributes (bool equiprob,
int U{0..9}, float U[0,100]).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import filters as F


# ---------------------------------------------------------------------------
# Vectors (FAVOR datasets)
# ---------------------------------------------------------------------------
def make_vector_dataset(n: int, dim: int, *, n_clusters: int = 32,
                        cluster_std: float = 0.35, seed: int = 0):
    """Gaussian-mixture vectors: cluster structure makes graph ANNS
    non-trivial (pure iid uniform is the easy case)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + cluster_std * rng.normal(size=(n, dim)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32)


def make_paper_dataset(n: int, dim: int, seed: int = 0):
    vecs = make_vector_dataset(n, dim, seed=seed)
    schema = F.paper_schema()
    attrs = F.random_attributes(schema, n, seed=seed + 1)
    return vecs, attrs, schema


def make_queries(n: int, dim: int, dataset_seed: int = 0, *, n_clusters: int = 32,
                 cluster_std: float = 0.35, seed: int = 100):
    """Queries from the SAME mixture as ``make_vector_dataset(dataset_seed)``:
    identical centers (same seed), fresh assignments/noise.  In-distribution
    queries are the realistic (and HNSW-meaningful) workload -- with foreign
    centers the nearest neighbor sits outside every cluster and recall
    saturates low for any graph method."""
    rng_c = np.random.default_rng(dataset_seed)
    centers = rng_c.normal(size=(n_clusters, dim)).astype(np.float32)
    rng = np.random.default_rng(seed + dataset_seed * 7919)
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + cluster_std * rng.normal(size=(n, dim)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32)


# ---------------------------------------------------------------------------
# Token stream (LM training)
# ---------------------------------------------------------------------------
@dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0

    def init_state(self) -> int:
        return 0

    def __call__(self, state: int):
        """Markov-ish synthetic tokens: next-token structure so the LM loss
        actually decreases (pure iid uniform has no learnable signal)."""
        rng = np.random.default_rng((self.seed, state))
        b, s, v = self.batch, self.seq_len, self.vocab
        base = rng.integers(0, v, size=(b, 1), dtype=np.int32)
        drift = rng.integers(0, 7, size=(b, s), dtype=np.int32)
        toks = (base + np.cumsum(drift, axis=1)) % v
        tokens = toks.astype(np.int32)
        labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)],
                                axis=1)
        return {"tokens": tokens, "labels": labels}, state + 1


# ---------------------------------------------------------------------------
# RecSys batches
# ---------------------------------------------------------------------------
@dataclass
class RecsysPipeline:
    n_sparse: int
    vocab: int
    batch: int
    n_dense: int = 0
    seq_len: int = 0          # DIEN behavior history
    seed: int = 0

    def init_state(self) -> int:
        return 0

    def __call__(self, state: int):
        rng = np.random.default_rng((self.seed, state))
        b = self.batch
        # zipf-ish id distribution (hot items) like production traffic
        raw = rng.zipf(1.2, size=(b, self.n_sparse)) if self.n_sparse else None
        out = {}
        if self.n_sparse:
            out["ids"] = np.minimum(raw, self.vocab - 1).astype(np.int32)
        if self.n_dense:
            out["dense"] = rng.normal(size=(b, self.n_dense)).astype(np.float32)
        if self.seq_len:
            hist = np.minimum(rng.zipf(1.2, size=(b, self.seq_len)),
                              self.vocab - 1).astype(np.int32)
            lens = rng.integers(1, self.seq_len + 1, size=b)
            pad = np.arange(self.seq_len)[None, :] >= lens[:, None]
            hist[pad] = -1
            out["hist"] = hist
            out["target"] = np.minimum(rng.zipf(1.2, size=b),
                                       self.vocab - 1).astype(np.int32)
        # learnable labels: logistic of a fixed random hash of the ids
        key_vec = np.random.default_rng(self.seed + 999).normal(
            size=(self.n_sparse or 1,))
        sig = (out.get("ids", np.zeros((b, 1))) % 97 / 97.0) @ key_vec[:, None]
        prob = 1.0 / (1.0 + np.exp(-(sig[:, 0] - sig.mean())))
        out["labels"] = (rng.random(b) < prob).astype(np.float32)
        return out, state + 1


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------
def make_random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                      seed: int = 0, power_law: bool = True):
    """Random graph with power-law-ish degrees + self-loops + features whose
    class signal propagates over edges (so GCN accuracy is learnable)."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = 1.0 / np.arange(1, n_nodes + 1) ** 0.8
        p = w / w.sum()
        src = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    else:
        src = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    # undirected + self loops
    loops = np.arange(n_nodes, dtype=np.int32)
    s = np.concatenate([src, dst, loops])
    d = np.concatenate([dst, src, loops])
    edges = np.stack([s, d]).astype(np.int32)

    labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    x = centers[labels] + rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    deg = np.zeros(n_nodes, np.float32)
    np.add.at(deg, d, 1.0)
    train_mask = rng.random(n_nodes) < 0.3
    return {"x": x, "edges": edges, "deg": deg, "labels": labels,
            "mask": train_mask}


def make_molecule_batch(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                        n_classes: int = 2, seed: int = 0):
    """Block-diagonal batch of small graphs for the molecule cell."""
    rng = np.random.default_rng(seed)
    xs, es, gids = [], [], []
    for g in range(batch):
        off = g * n_nodes
        src = rng.integers(0, n_nodes, size=n_edges) + off
        dst = rng.integers(0, n_nodes, size=n_edges) + off
        loops = np.arange(n_nodes) + off
        es.append(np.stack([np.concatenate([src, dst, loops]),
                            np.concatenate([dst, src, loops])]))
        xs.append(rng.normal(size=(n_nodes, d_feat)).astype(np.float32))
        gids.append(np.full(n_nodes, g, np.int32))
    x = np.concatenate(xs)
    edges = np.concatenate(es, axis=1).astype(np.int32)
    deg = np.zeros(batch * n_nodes, np.float32)
    np.add.at(deg, edges[1], 1.0)
    labels = rng.integers(0, n_classes, size=batch).astype(np.int32)
    return {"x": x, "edges": edges, "deg": deg,
            "graph_ids": np.concatenate(gids), "labels": labels,
            "mask": np.ones(batch, bool)}
