"""Wrapper and plain version of the fused filtered top-k kernel
(``csrc/filtered_topk.cu``; replaces the TPU kernel
``src/repro/kernels/filtered_topk/kernel.py:filtered_topk_pallas``).

On CUDA tensors a call in PreFBF mode first counts, per query on the card,
the rows its filter passes; a query under the kernel's break-even share
takes the filter-first path (the filter, then an exact distance for the
passing pairs only), the others and every query in exclusion mode the
TF32 screen.  Both return the same bits; the choice moves only time, and
the call reads nothing back to the host.

Contract of the JAX package's ``ops.filtered_topk``: ids (B, k) int32 with -1
for missing, dists (B, k) f32 with +inf for missing, ordered by (distance,
id); ``valid`` an optional (B,) bool query mask whose False rows return
-1 / +inf.  PreFBF mode (``exclude=False``) drops rows that fail the filter;
exclusion mode adds the per-query ``dvec`` to them (Eq. 2).  Rows whose norm
is +inf or >= BIG (``prefbf.pad_db`` padding) are never returned, in either
mode.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _common as C
from .. import check_status, count_launch, counted, library
from ...core import filters as F

NAME = "filtered_topk"
_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_float]
             + [ctypes.c_void_p] * 9)

# The TF32 screen's margin (csrc/filtered_topk.cu, "The screen"): the
# tensor cores read an f32 operand's upper 19 bits (truncation: relative
# error below 2^-10; round-to-nearest would give 2^-11), form each product
# exactly and accumulate in f32 with truncation, at most 9 ulps of 2^-23
# per eight-term mma step, bounded here by d * 2^-22; the exact dot the
# kernel returns is one f32 FMA chain, within 1.01 * d * 2^-24.  Each term
# is relative to sum |q_i v_i| <= |q| |v|.
TF32_UNIT = 2.0 ** -10
SCREEN_SAFETY = 2.0


def screen_eps(d: int) -> float:
    """epsilon of the screen's margin e(q, v) = epsilon * |q| * |v|: an upper
    bound on |TF32 dot - exact kernel dot| over |q| |v| for d-long vectors,
    times a safety factor that also covers the f32 rounding of |q|, |v|, e
    and the bound itself (each O(d * 2^-24) relative)."""
    u = TF32_UNIT
    inputs = 2.0 * u + u * u
    accumulate = d * 2.0 ** -22 * (1.0 + u) ** 2
    exact_chain = 1.01 * d * 2.0 ** -24
    return SCREEN_SAFETY * (inputs + accumulate + exact_chain)


def _fn():
    lib = library(NAME)
    fn = lib.filtered_topk_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        for f in (lib.filtered_topk_max_k, lib.filtered_topk_query_tile,
                  lib.filtered_topk_tile_rows):
            f.restype = ctypes.c_int
    return lib, fn


def _splits(b: int, n: int, sms: int, q_tile: int, tile_rows: int) -> int:
    """DB splits: about one block per SM over the whole grid (a block holds
    one tile of ``q_tile`` queries for its whole run, so long splits let
    each query's threshold tighten early), at least one row tile each."""
    q_tiles = -(-b // q_tile)
    return max(1, min(sms // q_tiles, -(-n // tile_rows), 65535))


def filtered_topk_work(vectors, norms, ints, floats, queries, programs, *,
                       k: int = 10, dvec=None, exclude: bool = False,
                       valid=None, after=None, **_):
    """(FLOPs, bytes) of one call: the DB rows, queries, programs (and D in
    exclusion mode, the lane mask, the lower bound) read once, k ids and
    distances a query written once; every pair's d-long dot in f32."""
    b, d = queries.shape
    return 2 * b * vectors.shape[0] * d, (
        C.nbytes(vectors, norms, ints, floats, queries, programs,
                 dvec if exclude else None, valid, after) + b * k * 8)


@counted(NAME, filtered_topk_work)
def filtered_topk(vectors, norms, ints, floats, queries, programs, *,
                  k: int = 10, dvec=None, exclude: bool = False, valid=None,
                  chunk: int = 8192, after=None, screen_counts=None,
                  rescore_counts=None, routes=None):
    """Fused filtered brute-force top-k over the DB.

    vectors (N, d) f32, norms (N,) f32, ints (N, m_i) int32, floats (N, m_f)
    f32, queries (B, d) f32, programs {valid (B, W) f32, imask (B, W, m_i)
    int64, flo/fhi (B, W, m_f) f32}, dvec (B,) f32 (exclusion mode);
    ``after`` an optional per-query lower bound (after_d (B,) f32, after_i
    (B,) int32): only pairs strictly after it in (distance, id) order are
    returned.  CPU tensors run ``filtered_topk_plain`` (scan chunk
    ``chunk``); CUDA tensors launch the kernel, in chained passes of its
    list length when k is larger (``_common.chain_topk``).
    ``screen_counts`` and ``rescore_counts``, optional (B,) int32 CUDA
    tensors, get each query's count of pairs that passed the kernel's TF32
    screen (on the filter-first path: the non-pad rows, whose filter it
    evaluated), and of pairs whose distance it then computed exactly (there:
    the passing ones), added to them.  ``routes``, an optional (B,) int32
    CUDA tensor, is set to 1 where the query took the filter-first path and
    0 where it took the screen.  Returns (ids, dists).
    """
    if not C.on_cuda(queries):
        return filtered_topk_plain(vectors, norms, ints, floats, queries,
                                   programs, k=k, dvec=dvec, exclude=exclude,
                                   valid=valid, chunk=chunk, after=after)
    C.require_cuda(NAME)
    dev = queries.device
    b, d = queries.shape
    n = vectors.shape[0]
    mi, mf = ints.shape[1], floats.shape[1]
    C.check(NAME, "queries", queries, torch.float32, (b, d), dev)
    C.check(NAME, "vectors", vectors, torch.float32, (n, d), dev)
    C.check(NAME, "norms", norms, torch.float32, (n,), dev)
    C.check(NAME, "ints", ints, torch.int32, (n, mi), dev)
    C.check(NAME, "floats", floats, torch.float32, (n, mf), dev)
    w = C.check_programs(NAME, programs, b, mi, mf, dev)
    if dvec is None:
        dvec = torch.zeros((b,), dtype=torch.float32, device=dev)
    C.check(NAME, "dvec", dvec, torch.float32, (b,), dev)
    if after is not None:
        C.check(NAME, "after_d", after[0], torch.float32, (b,), dev)
        C.check(NAME, "after_i", after[1], torch.int32, (b,), dev)
    for label, cnt in (("screen_counts", screen_counts),
                       ("rescore_counts", rescore_counts),
                       ("routes", routes)):
        if cnt is not None:
            C.check(NAME, label, cnt, torch.int32, (b,), dev)
    if k < 1:
        raise ValueError(f"{NAME}: k={k} must be at least 1")
    lib, fn = _fn()
    if not (b and n):
        if routes is not None:      # nothing to scan: no query was served
            routes.zero_()
        return C.apply_missing(
            torch.full((b, k), -1, dtype=torch.int32, device=dev),
            torch.full((b, k), C.BIG, dtype=torch.float32, device=dev), valid)
    splits = _splits(b, n, torch.cuda.get_device_properties(
        dev).multi_processor_count, lib.filtered_topk_query_tile(),
        lib.filtered_topk_tile_rows())
    eps = screen_eps(d)

    def one_pass(kk, aft):
        out_d = torch.empty((b, kk), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, kk), dtype=torch.int32, device=dev)
        part_d = torch.empty((b, splits, kk), dtype=torch.float32, device=dev)
        part_i = torch.empty((b, splits, kk), dtype=torch.int32, device=dev)
        # the count pass's partial counts, written whole by its kernel
        pcount = (None if exclude else
                  torch.empty((b, splits), dtype=torch.int32, device=dev))
        ad, ai = (None, None) if aft is None else (C.ptr(aft[0]),
                                                   C.ptr(aft[1]))
        status = fn(C.ptr(queries), C.ptr(vectors), C.ptr(norms), C.ptr(ints),
                    C.ptr(floats), C.ptr(programs["valid"]),
                    C.ptr(programs["imask"]), C.ptr(programs["flo"]),
                    C.ptr(programs["fhi"]), C.ptr(dvec), ad, ai, b, n, d, mi,
                    mf, w, kk, int(bool(exclude)), splits, eps,
                    None if screen_counts is None else C.ptr(screen_counts),
                    None if rescore_counts is None else C.ptr(rescore_counts),
                    None if routes is None else C.ptr(routes),
                    None if pcount is None else C.ptr(pcount), C.ptr(part_d),
                    C.ptr(part_i), C.ptr(out_d), C.ptr(out_i),
                    C.stream_ptr(dev))
        check_status(NAME, status)
        count_launch(NAME)
        return out_i, out_d

    out_i, out_d = C.chain_topk(one_pass, k, lib.filtered_topk_max_k(), after)
    return C.apply_missing(out_i, out_d, valid)


def filtered_topk_plain(vectors, norms, ints, floats, queries, programs, *,
                        k: int = 10, dvec=None, exclude: bool = False,
                        valid=None, chunk: int = 8192, after=None):
    """The kernel's function in plain torch: per DB chunk, matmuls of fixed
    row count for the dots (``rows_mm``: a row's result does not depend on
    the batch width), the filter program, the mask or exclusion, the lower
    bound ``after`` (pairs not strictly after it in (distance, id) order
    are dropped), then a stable sort of [carried top-k, chunk] -- carried
    entries and lower ids win ties."""
    dev = queries.device
    C.no_tf32(dev)
    b = queries.shape[0]
    n = vectors.shape[0]
    if dvec is None:
        dvec = torch.zeros((b,), dtype=torch.float32, device=dev)
    qn = (queries * queries).sum(dim=-1)
    best_d = torch.full((b, k), C.BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        v, vn = vectors[s:s + chunk], norms[s:s + chunk]
        dot = C.rows_mm(queries, v)
        dist = torch.sqrt(torch.clamp(vn[None, :] + qn[:, None] - 2.0 * dot,
                                      min=0.0))
        mask = F.eval_program_batched(programs, ints[s:s + chunk],
                                      floats[s:s + chunk])
        if exclude:
            dist = dist + torch.where(mask, 0.0, dvec[:, None])
        else:
            dist = torch.where(mask, dist, C.BIG)
        # pad rows (norm +inf / >= BIG) are never results
        dist = torch.where((vn < C.BIG)[None, :], dist, C.BIG)
        dist = torch.clamp(dist, max=C.BIG)
        ids = torch.arange(s, s + v.shape[0], dtype=torch.int32,
                           device=dev).expand(b, -1)
        dist = torch.where(C.after_mask(dist, ids, after), dist, C.BIG)
        best_d, best_i = C.stable_topk([best_d, dist], k, [best_i, ids])
    return C.apply_missing(best_i, best_d, valid)
