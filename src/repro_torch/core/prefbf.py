"""Pre-filtering brute-force search (paper Sections 3.2.1 and 4.1).

On CPU the paper gathers the predicate-passing rows and scans them.  On the
device the scan visits *all* rows of the DB and masks the predicate failures
to +inf -- the arithmetic (and the results) are identical to pre-filtering,
with the filter evaluated as the compiled DNF program.  This is the fused
distance + mask + top-k scan of kernels/filtered_topk: the hand-written
kernel on CUDA tensors, its plain chunked scan (the counterpart of the JAX
package's ``lax.scan``) on CPU tensors.
"""
from __future__ import annotations

import numpy as np

from ..kernels.filtered_topk import ops as ft_ops


def pad_db(vectors: np.ndarray, norms: np.ndarray, ints: np.ndarray,
           floats: np.ndarray, chunk: int):
    """Pad the DB row count to a multiple of ``chunk``; padded rows get +inf
    norms so their distance is +inf and an all-False filter row."""
    n = vectors.shape[0]
    pad = (-n) % chunk
    if pad == 0:
        return vectors, norms, ints, floats
    return (
        np.concatenate([vectors, np.zeros((pad, vectors.shape[1]), vectors.dtype)]),
        np.concatenate([norms, np.full((pad,), np.inf, norms.dtype)]),
        np.concatenate([ints, np.full((pad, ints.shape[1]), -1, ints.dtype)]),
        np.concatenate([floats, np.full((pad, floats.shape[1]), np.nan, floats.dtype)]),
    )


def prefbf_topk(vectors, norms, ints, floats, queries, programs, *,
                k: int, chunk: int = 16384, valid=None):
    """Fused filtered brute-force top-k: one call to the ``filtered_topk``
    wrapper, which launches the kernel on CUDA tensors and runs its plain
    chunked scan (``chunk`` DB rows at a time) on CPU tensors.

    vectors (N, d), norms (N,), ints (N, m_i), floats (N, m_f);
    queries (B, d); programs batched filter programs; ``valid`` an optional
    (B,) bool query mask (bucket padding) -- False rows return -1 / +inf.
    Returns ids (B, k) int32 (-1 for missing) and dists (B, k) (+inf missing).
    """
    return ft_ops.filtered_topk(vectors, norms, ints, floats, queries,
                                programs, k=k, valid=valid, chunk=chunk)
