"""Wrapper and plain version of the fused filtered top-k kernel
(``csrc/filtered_topk.cu``; replaces the TPU kernel
``src/repro/kernels/filtered_topk/kernel.py:filtered_topk_pallas``).

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
from .. import check_status, count_launch, library
from ...core import filters as F

NAME = "filtered_topk"
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
             + [ctypes.c_void_p] * 5)


def _fn():
    lib = library(NAME)
    fn = lib.filtered_topk_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.filtered_topk_max_k.restype = ctypes.c_int
        lib.filtered_topk_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.filtered_topk_smem_bytes.restype = ctypes.c_size_t
    return lib, fn


def _splits(b: int, n: int, sms: int) -> int:
    """DB splits: about sixteen blocks (of 256 queries) per SM over the whole
    grid, with at least 16 rows (one tile) per split."""
    q_tiles = -(-b // 256)
    want = max(1, -(-16 * sms // q_tiles))
    return max(1, min(want, -(-n // 16), 65535))


def filtered_topk(vectors, norms, ints, floats, queries, programs, *,
                  k: int = 10, dvec=None, exclude: bool = False, valid=None,
                  chunk: int = 8192):
    """Fused filtered brute-force top-k over the DB.

    vectors (N, d) f32, norms (N,) f32, ints (N, m_i) int32, floats (N, m_f)
    f32, queries (B, d) f32, programs {valid (B, W) f32, imask (B, W, m_i)
    int64, flo/fhi (B, W, m_f) f32}, dvec (B,) f32 (exclusion mode).
    CPU tensors run ``filtered_topk_plain`` (scan chunk ``chunk``); CUDA
    tensors launch the kernel.  Returns (ids, dists).
    """
    if not C.on_cuda(queries):
        return filtered_topk_plain(vectors, norms, ints, floats, queries,
                                   programs, k=k, dvec=dvec, exclude=exclude,
                                   valid=valid, chunk=chunk)
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
    lib, fn = _fn()
    if not 1 <= k <= lib.filtered_topk_max_k():
        raise ValueError(f"{NAME}: k={k} outside [1, "
                         f"{lib.filtered_topk_max_k()}]")
    smem = lib.filtered_topk_smem_bytes(d, mi, mf)
    if smem > 227 * 1024:
        raise ValueError(f"{NAME}: d={d} needs {smem} bytes of shared memory "
                         "per block, above the card's 227 KB")
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b and n:
        splits = _splits(b, n, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        part_d = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
        # the kernel reads the queries transposed, (d, B): coalesced
        qt = queries.t().contiguous()
        status = fn(C.ptr(qt), C.ptr(vectors), C.ptr(norms), C.ptr(ints),
                    C.ptr(floats), C.ptr(programs["valid"]),
                    C.ptr(programs["imask"]), C.ptr(programs["flo"]),
                    C.ptr(programs["fhi"]), C.ptr(dvec), b, n, d, mi, mf, w,
                    k, int(bool(exclude)), splits, C.ptr(part_d),
                    C.ptr(part_i), C.ptr(out_d), C.ptr(out_i),
                    C.stream_ptr(dev))
        check_status(NAME, status)
        count_launch(NAME)
    else:
        out_d.fill_(C.BIG)
        out_i.fill_(-1)
    return C.apply_missing(out_i, out_d, valid)


def filtered_topk_plain(vectors, norms, ints, floats, queries, programs, *,
                        k: int = 10, dvec=None, exclude: bool = False,
                        valid=None, chunk: int = 8192):
    """The kernel's function in plain torch: per DB chunk, matmuls of fixed
    row count for the dots (``rows_mm``: a row's result does not depend on
    the batch width), the filter program, the mask or exclusion, then a
    stable sort of [carried top-k, chunk] -- carried entries and lower ids
    win ties."""
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
        md = torch.cat([best_d, dist], dim=1)
        mi = torch.cat([best_i, ids], dim=1)
        order = torch.sort(md, dim=1, stable=True).indices[:, :k]
        best_d = torch.gather(md, 1, order)
        best_i = torch.gather(mi, 1, order)
    return C.apply_missing(best_i, best_d, valid)
