"""Pre-filtering brute-force search (paper Sections 3.2.1 and 4.1).

The paper gathers the predicate-passing rows and computes their distances.
The device scan is the fused filter + distance + top-k of
kernels/filtered_topk, with the filter evaluated as the compiled DNF
program: the hand-written kernel on CUDA tensors, its plain chunked scan
(the counterpart of the JAX package's ``lax.scan``, which computes every
row's distance and masks the failures to +inf) on CPU tensors.  On the
card the kernel counts each query's passing rows first and serves a query
under its break-even share the paper's way -- the filter first, then an
exact distance for the passing rows only -- and a denser one with a TF32
screen of every row before the filter; both give the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.filtered_topk import ops as ft_ops
from ..obs.trace import open_span, trace_add


# pad_db's fill for each array: vectors, norms, ints, floats
PAD_FILL = (0, np.inf, -1, np.nan)


def pad_rows(a: np.ndarray, chunk: int, fill) -> np.ndarray:
    """``a`` with rows of ``fill`` appended up to a multiple of ``chunk``
    (``a`` itself when none are needed)."""
    pad = (-a.shape[0]) % chunk
    if pad == 0:
        return a
    return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])


def pad_db(vectors: np.ndarray, norms: np.ndarray, ints: np.ndarray,
           floats: np.ndarray, chunk: int):
    """Pad the DB row count to a multiple of ``chunk``; padded rows get +inf
    norms so their distance is +inf and an all-False filter row."""
    return tuple(pad_rows(a, chunk, f) for a, f in
                 zip((vectors, norms, ints, floats), PAD_FILL))


def prefbf_topk(vectors, norms, ints, floats, queries, programs, *,
                k: int, chunk: int = 16384, valid=None):
    """Fused filtered brute-force top-k: one call to the ``filtered_topk``
    wrapper, which launches the kernel on CUDA tensors and runs its plain
    chunked scan (``chunk`` DB rows at a time) on CPU tensors.

    vectors (N, d), norms (N,), ints (N, m_i), floats (N, m_f);
    queries (B, d); programs batched filter programs; ``valid`` an optional
    (B,) bool query mask (bucket padding) -- False rows return -1 / +inf.
    Inside a sampled trace's open span (the router's ``brute``/``search``),
    on the card, the span's ``prefiltered_queries`` gets the valid queries
    the kernel served filter first added to it (a delta or a shard scan
    under the same span adds its own), a device scalar read when the trace
    finishes.  Untraced, or on CPU tensors, no op is added.
    Returns ids (B, k) int32 (-1 for missing) and dists (B, k) (+inf missing).
    """
    routes = None
    if queries.is_cuda and open_span() is not None:
        dev = queries.device
        routes = torch.empty((queries.shape[0],), dtype=torch.int32,
                             device=dev)
        if valid is not None:   # the one copy up the wrapper would make
            valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    out = ft_ops.filtered_topk(vectors, norms, ints, floats, queries,
                               programs, k=k, valid=valid, chunk=chunk,
                               routes=routes)
    if routes is not None:      # summed over the scans under the span
        trace_add("prefiltered_queries",
                  (routes if valid is None else routes * valid).sum())
    return out
