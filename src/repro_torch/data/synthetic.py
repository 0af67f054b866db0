"""Deterministic synthetic vector datasets (no downloads): numpy from a seed,
the same bits as the JAX package's generator for the same seed.

Vector datasets follow the paper's section 6.1.2 generation: Gaussian-mixture
vectors (clustered, like SIFT/GIST structure) + attributes (bool equiprob,
int U{0..9}, float U[0,100]).
"""
from __future__ import annotations


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
