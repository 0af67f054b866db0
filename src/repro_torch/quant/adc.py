"""Asymmetric distance computation: compressed filtered scans + exact
re-rank.

Each query builds one table of squared sub-distances to every centroid
(``build_luts``: (B, M, K)); scanning the DB then reads only the uint8
codes: an ADC distance is M table lookups + adds per row instead of a d-dim
dot product.  The scan keeps R = max(k, rerank * k) candidates per query
under the same DNF filter programs and padding rules as the f32 brute route,
and the answer is an exact float32 re-rank of those R rows.

``pq_prefbf_topk`` is one call to the ``pq_adc_topr`` wrapper on every
device: the hand-written kernel on CUDA tensors, its plain chunked scan on
CPU tensors.  Inside a sampled trace's open span (``obs.trace.open_span``:
the router's ``search`` span under ``brute``) its three stages are spans
``luts``, ``screen`` and ``rerank`` (``obs.trace.stage_span``: on the
host's clock; profiler ranges ``favor/brute/search/<stage>`` under kernel
annotations), and on the card the ``screen`` span gets the kernel's
counters summed over the batch: ``screen_pairs`` (pairs through the 8-bit
screen) and ``rescored_pairs`` (passing pairs whose exact key it
computed), device scalars read when the trace finishes.  Untraced, it
runs the ops it ran before it had spans.
``sq_prefbf_topk`` has no kernel in the JAX package either and stays plain
torch.
"""
from __future__ import annotations

import torch

from ..core import filters as F
from ..kernels._common import no_tf32, rows_mm, stable_topk
from ..kernels.pq_adc import ops as pq_ops
from ..obs.trace import open_span, stage_span, trace_add

INF = float("inf")


def build_luts(centroids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Per-query squared-distance tables.

    centroids (M, K, dsub); queries (B, d) with d <= M * dsub -- the query is
    zero-padded on the feature tail exactly like the encoded vectors.
    Returns (B, M, K) float32.  The dots are dsub elementwise multiply-adds
    in subspace-coordinate order, each rounded on its own: a query's table
    does not depend on the batch width (a batched GEMM picks its kernel,
    and so its summation order, by shape), bucket padding relies on that,
    and no (B, M, K, dsub) product is held.
    """
    m, _, dsub = centroids.shape
    b, d = queries.shape
    pad = m * dsub - d
    if pad:
        queries = torch.cat([queries, queries.new_zeros((b, pad))], dim=1)
    qs = queries.reshape(b, m, dsub)
    qn = (qs * qs).sum(dim=-1)                     # (B, M)
    cn = (centroids * centroids).sum(dim=-1)       # (M, K)
    dot = qs[:, :, None, 0] * centroids[None, :, :, 0]
    for j in range(1, dsub):
        dot = dot + qs[:, :, None, j] * centroids[None, :, :, j]
    return torch.clamp(qn[:, :, None] + cn[None, :, :] - 2.0 * dot, min=0.0)


def _exact_rerank(vectors, norms, queries, cand_i, *, k: int, valid=None):
    """Exact float32 top-k over the (B, R) candidate lists: gather,
    multiply + reduce (each pair on its own, so the result does not depend
    on the batch width), stable sort.  ``valid`` is the optional (B,) bool
    query mask: False rows return -1 / +inf."""
    safe = cand_i.clamp(min=0).long()
    v = vectors[safe]                                      # (B, R, d)
    qn = (queries * queries).sum(dim=-1)
    dot = (queries[:, None, :] * v).sum(dim=-1)
    dist = torch.sqrt(torch.clamp(norms[safe] + qn[:, None] - 2.0 * dot,
                                  min=0.0))
    dist = torch.where(cand_i >= 0, dist, INF)
    out_d, out_i = stable_topk(dist, k, cand_i)
    if valid is not None:
        vmask = torch.as_tensor(valid, dtype=torch.bool,
                                device=out_d.device)[:, None]
        out_d = torch.where(vmask, out_d, INF)
    return torch.where(torch.isfinite(out_d), out_i, -1), out_d


def pq_prefbf_topk(codes, norms, ints, floats, queries, programs, centroids,
                   vectors, *, k: int, rerank: int = 4, chunk: int = 8192,
                   valid=None):
    """Compressed filtered brute-force top-k with exact re-rank.

    codes (N, M) uint8; norms/ints/floats/vectors: the padded DB arrays from
    ``prefbf.pad_db`` (norms also gate out padded rows, since a padded code
    row is a legal code word); queries (B, d); programs batched filter
    programs; centroids (M, K, dsub); ``valid`` an optional (B,) bool query
    mask -- False rows return -1 / +inf.  ``chunk`` is the plain scan's
    chunk on CPU tensors.

    Same contract as ``prefbf_topk``: ids (B, k) int32 (-1 missing) and exact
    float32 dists (B, k) (+inf missing).
    """
    r = max(k, rerank * k)
    with stage_span("luts"):
        luts = build_luts(centroids, queries)
    # the kernel's counters, on the card inside a trace (the plain scan
    # has no screen to count)
    screened = rescored = None
    if luts.is_cuda and open_span() is not None:
        screened, rescored = torch.zeros((2, luts.shape[0]),
                                         dtype=torch.int32, device=luts.device)
    with stage_span("screen"):
        cand_i, _ = pq_ops.pq_adc_topr(codes, norms, ints, floats, luts,
                                       programs, r=r, valid=valid,
                                       chunk=chunk, screen_counts=screened,
                                       rescore_counts=rescored)
        if screened is not None:
            trace_add("screen_pairs", screened.sum())
            trace_add("rescored_pairs", rescored.sum())
    with stage_span("rerank"):
        return _exact_rerank(vectors, norms, queries, cand_i, k=k,
                             valid=valid)


def sq_prefbf_topk(codes, lo, scale, norms, ints, floats, queries, programs,
                   vectors, *, k: int, rerank: int = 4, chunk: int = 8192,
                   valid=None):
    """Scalar-quantization fallback scan: per-chunk dequantize + matmuls of
    fixed row count (``rows_mm``), then the same exact re-rank as the PQ
    path.  codes (N, d) uint8;
    ``valid`` the optional (B,) bool query mask."""
    no_tf32(queries.device)
    r = max(k, rerank * k)
    n = codes.shape[0]
    b = queries.shape[0]
    dev = queries.device
    qn = (queries * queries).sum(dim=-1)
    best_d = torch.full((b, r), INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, r), -1, dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        deq = codes[s:s + chunk].to(torch.float32) * scale[None, :] + lo[None, :]
        dn = (deq * deq).sum(dim=-1)
        d2 = torch.clamp(dn[None, :] + qn[:, None]
                         - 2.0 * rows_mm(queries, deq), min=0.0)
        mask = F.eval_program_batched(programs, ints[s:s + chunk],
                                      floats[s:s + chunk])
        ok = mask & torch.isfinite(norms[s:s + chunk])[None, :]
        d2 = torch.where(ok, d2, INF)
        ids = torch.arange(s, s + deq.shape[0], dtype=torch.int32,
                           device=dev).expand(b, -1)
        best_d, best_i = stable_topk([best_d, d2], r, [best_i, ids])
    cand_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return _exact_rerank(vectors, norms, queries, cand_i, k=k, valid=valid)
