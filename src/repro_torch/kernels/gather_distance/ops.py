"""Wrapper and plain version of the neighbour-gather distance kernel
(``csrc/gather_distance.cu``; replaces the TPU kernel
``src/repro/kernels/gather_distance/kernel.py:gather_distance_pallas``).

Contract of the JAX package's ``ops.gather_distance``: dbar (B, M) f32 with
+inf where the id is -1, td (B, M) bool; ``valid`` an optional (B,) bool
query mask whose False rows return all +inf and no TD hits.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _common as C
from .. import check_status, count_launch, counted, library
from ...core import filters as F

NAME = "gather_distance"
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
             + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)


def _fn():
    fn = library(NAME).gather_distance_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def gather_distance_work(vectors, norms, ints, floats, queries, nbr_ids,
                         programs, dvec, *, valid=None):
    """(FLOPs, bytes) of one call: each valid id's row, norm and
    attributes, the ids, queries, programs, D and lane mask read once, dbar
    and the TD byte written once; one d-long multiply-add per valid id."""
    d = queries.shape[1]
    n = C.n_valid(nbr_ids)
    row = (d + 1) * 4 + C.nbytes(ints[:1], floats[:1])
    return 2 * n * d, (C.nbytes(nbr_ids, queries, programs, dvec, valid)
                       + nbr_ids.numel() * 5 + n * row)


@counted(NAME, gather_distance_work)
def gather_distance(vectors, norms, ints, floats, queries, nbr_ids, programs,
                    dvec, *, valid=None):
    """Graph-expansion distance evaluation.

    nbr_ids (B, M) int32 or int64 (-1 pad); queries (B, d) f32; DB arrays as
    in ``filtered_topk``; dvec (B,) f32.  CPU tensors run
    ``gather_distance_plain``; CUDA tensors launch the kernel, which also
    applies the +inf / ``valid`` epilogue, so a CUDA call dispatches no torch
    op but its two output allocations.
    Returns (dbar (B, M) f32, td (B, M) bool).
    """
    if not C.on_cuda(queries):
        return gather_distance_plain(vectors, norms, ints, floats, queries,
                                     nbr_ids, programs, dvec, valid=valid)
    C.require_cuda(NAME)
    dev = queries.device
    b, d = queries.shape
    m = nbr_ids.shape[1]
    n = vectors.shape[0]
    mi, mf = ints.shape[1], floats.shape[1]
    C.check(NAME, "nbr_ids", nbr_ids, C.id_dtype(nbr_ids), (b, m), dev)
    C.check(NAME, "queries", queries, torch.float32, (b, d), dev)
    C.check(NAME, "vectors", vectors, torch.float32, (n, d), dev)
    C.check(NAME, "norms", norms, torch.float32, (n,), dev)
    C.check(NAME, "ints", ints, torch.int32, (n, mi), dev)
    C.check(NAME, "floats", floats, torch.float32, (n, mf), dev)
    C.check(NAME, "dvec", dvec, torch.float32, (b,), dev)
    w = C.check_programs(NAME, programs, b, mi, mf, dev)
    lane_ok = C.lane_mask(NAME, valid, b, dev)
    out_d = torch.empty((b, m), dtype=torch.float32, device=dev)
    out_td = torch.empty((b, m), dtype=torch.bool, device=dev)
    if b * m:
        status = _fn()(C.ptr(nbr_ids), int(nbr_ids.dtype == torch.int64),
                       C.ptr(queries), C.ptr(vectors), C.ptr(norms),
                       C.ptr(ints), C.ptr(floats), C.ptr(programs["valid"]),
                       C.ptr(programs["imask"]), C.ptr(programs["flo"]),
                       C.ptr(programs["fhi"]), C.ptr(dvec),
                       None if lane_ok is None else C.ptr(lane_ok), b, m, d,
                       mi, mf, w, C.ptr(out_d), C.ptr(out_td),
                       C.stream_ptr(dev))
        check_status(NAME, status)
        count_launch(NAME, (b, m))
    return out_d, out_td


def _finish(dbar, td, valid):
    dbar = torch.where(dbar >= C.BIG, float("inf"), dbar)
    if valid is not None:
        vmask = torch.as_tensor(valid, dtype=torch.bool,
                                device=dbar.device)[:, None]
        dbar = torch.where(vmask, dbar, float("inf"))
        td = td & vmask
    return dbar, td


def gather_distance_plain(vectors, norms, ints, floats, queries, nbr_ids,
                          programs, dvec, *, valid=None):
    """The kernel's function in plain torch: gather, multiply + reduce."""
    safe = nbr_ids.clamp(min=0).long()
    v = vectors[safe]                                  # (B, M, d)
    qn = (queries * queries).sum(dim=-1)
    dot = (queries[:, None, :] * v).sum(dim=-1)
    dist = torch.sqrt(torch.clamp(norms[safe] + qn[:, None] - 2.0 * dot,
                                  min=0.0))
    td = F.eval_program_gathered(programs, ints[safe], floats[safe])
    dbar = dist + torch.where(td, 0.0, dvec[:, None])
    invalid = nbr_ids < 0
    dbar = torch.where(invalid, C.BIG, dbar)
    return _finish(dbar, td & ~invalid, valid)
