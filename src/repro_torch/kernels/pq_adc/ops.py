"""Wrappers and plain versions of the PQ ADC kernels (``csrc/pq_adc.cu``;
replace the TPU kernels ``src/repro/kernels/pq_adc/kernel.py:pq_adc_pallas``
and ``pq_adc_gather_pallas``).

Contract of the JAX package's ``ops``: ``pq_adc_topr`` returns ids (B, R)
int32 with -1 for missing and squared ADC distances (B, R) f32 with +inf for
missing, ordered by (distance, id); ``pq_adc_gather`` returns squared ADC
distances (B, M0) with +inf where the id is -1.  ``valid`` is an optional
(B,) bool query mask whose False rows return -1 / +inf.

An ADC distance is the sum of a query's M table entries at a row's codes,
taken in subspace order from 0 -- the sequence the Pallas kernels' exact
one-hot products accumulate -- so the kernels, the plain versions below and
the Pallas interpret mode agree bit for bit.  LUTs may be f32 or bf16; the
sum is f32 either way.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _common as C
from .. import check_status, count_launch, library
from ...core import filters as F

TOPR, GATHER = "pq_adc_topr", "pq_adc_gather"
LUT_DTYPES = (torch.float32, torch.bfloat16)
_SMEM_TWO_BLOCKS = 112 * 1024    # two scan blocks per SM
_SMEM_MAX = 226 * 1024           # one block per SM


def _lib():
    lib = library(TOPR)
    if lib.pq_adc_topr_launch.argtypes is None:
        lib.pq_adc_topr_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
            + [ctypes.c_void_p] * 5)
        lib.pq_adc_topr_launch.restype = ctypes.c_int
        lib.pq_adc_gather_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 8
            + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3)
        lib.pq_adc_gather_launch.restype = ctypes.c_int
        lib.pq_adc_topr_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.pq_adc_topr_smem_bytes.restype = ctypes.c_size_t
        for fn in (lib.pq_adc_max_r, lib.pq_adc_max_qt, lib.pq_adc_tile_rows):
            fn.restype = ctypes.c_int
    return lib


def _check_luts(name, luts, b, m, dev):
    if luts.dtype not in LUT_DTYPES:
        raise ValueError(f"{name}: luts has dtype {luts.dtype}, expected one "
                         f"of {LUT_DTYPES}")
    C.check(name, "luts", luts, luts.dtype, (b, m, None), dev)


def _query_tile(lib, b: int, m: int, ksub: int, r: int) -> tuple[int, bool]:
    """(queries per scan block, LUTs read from global memory): as many
    queries as two blocks per SM can hold in shared memory with their LUTs,
    else as many as one block can; when not even one query's LUT fits
    beside its top-r list, the LUTs stay in global memory and only the
    lists are staged."""
    cap = min(b, lib.pq_adc_max_qt())
    for lut_global in (False, True):
        for budget in (_SMEM_TWO_BLOCKS, _SMEM_MAX):
            for qt in range(cap, 0, -1):
                if lib.pq_adc_topr_smem_bytes(m, ksub, r, qt,
                                              int(lut_global)) <= budget:
                    return qt, lut_global
    raise AssertionError(f"{TOPR}: a top-{r} list of at most "
                         f"{lib.pq_adc_max_r()} entries always fits")


def _splits(q_tiles: int, n: int, sms: int, tile: int) -> int:
    """DB splits: about sixteen blocks per SM over the whole grid, with at
    least eight tiles of rows per split."""
    want = max(1, -(-16 * sms // q_tiles))
    return max(1, min(want, -(-n // (8 * tile)), 65535))


def pq_adc_topr(codes, norms, ints, floats, luts, programs, *, r: int = 40,
                valid=None, chunk: int = 8192, after=None):
    """Fused compressed filtered top-R candidate scan.

    codes (N, M) uint8; norms (N,) f32 (rows with norm +inf or >= BIG are
    padding and never returned); ints (N, m_i) int32, floats (N, m_f) f32;
    luts (B, M, K) f32 or bf16 from ``quant.adc.build_luts``; programs
    {valid (B, W) f32, imask (B, W, m_i) int64, flo/fhi (B, W, m_f) f32};
    ``after`` an optional per-query lower bound (after_d (B,) f32, after_i
    (B,) int32): only pairs strictly after it in (distance, id) order are
    returned.  CPU tensors run ``pq_adc_topr_plain`` (scan chunk
    ``chunk``); CUDA tensors launch the kernel, in chained passes of its
    longest list when R is larger (``_common.chain_topk``).  Returns (ids
    (B, R), adc2 (B, R)).
    """
    if not C.on_cuda(luts):
        return pq_adc_topr_plain(codes, norms, ints, floats, luts, programs,
                                 r=r, valid=valid, chunk=chunk, after=after)
    C.require_cuda(TOPR)
    dev = luts.device
    b, m, ksub = luts.shape
    n = codes.shape[0]
    mi, mf = ints.shape[1], floats.shape[1]
    _check_luts(TOPR, luts, b, m, dev)
    C.check(TOPR, "codes", codes, torch.uint8, (n, m), dev)
    C.check(TOPR, "norms", norms, torch.float32, (n,), dev)
    C.check(TOPR, "ints", ints, torch.int32, (n, mi), dev)
    C.check(TOPR, "floats", floats, torch.float32, (n, mf), dev)
    w = C.check_programs(TOPR, programs, b, mi, mf, dev)
    if after is not None:
        C.check(TOPR, "after_d", after[0], torch.float32, (b,), dev)
        C.check(TOPR, "after_i", after[1], torch.int32, (b,), dev)
    if r < 1:
        raise ValueError(f"{TOPR}: r={r} must be at least 1")
    if ksub > 256:
        raise ValueError(f"{TOPR}: K={ksub} codes do not fit in uint8")
    lib = _lib()
    if not (b and n):
        return C.apply_missing(
            torch.full((b, r), -1, dtype=torch.int32, device=dev),
            torch.full((b, r), C.BIG, dtype=torch.float32, device=dev), valid)
    rmax = lib.pq_adc_max_r()
    qt, lut_global = _query_tile(lib, b, m, ksub, min(r, rmax))
    if lut_global:          # the kernel reads f32 tables from global memory
        luts = luts.float()  # (exact: the kernel widens bf16 anyway)
    q_tiles = -(-b // qt)
    splits = _splits(q_tiles, n, torch.cuda.get_device_properties(
        dev).multi_processor_count, lib.pq_adc_tile_rows())

    def one_pass(rr, aft):
        out_d = torch.empty((b, rr), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, rr), dtype=torch.int32, device=dev)
        part_d = torch.empty((b, splits, rr), dtype=torch.float32, device=dev)
        part_i = torch.empty((b, splits, rr), dtype=torch.int32, device=dev)
        ad, ai = (None, None) if aft is None else (C.ptr(aft[0]),
                                                   C.ptr(aft[1]))
        status = lib.pq_adc_topr_launch(
            C.ptr(luts), int(luts.dtype == torch.bfloat16), int(lut_global),
            C.ptr(codes), C.ptr(norms), C.ptr(ints), C.ptr(floats),
            C.ptr(programs["valid"]), C.ptr(programs["imask"]),
            C.ptr(programs["flo"]), C.ptr(programs["fhi"]), ad, ai, b, n, m,
            ksub, mi, mf, w, rr, qt, splits, C.ptr(part_d), C.ptr(part_i),
            C.ptr(out_d), C.ptr(out_i), C.stream_ptr(dev))
        check_status(TOPR, status)
        count_launch(TOPR)
        return out_i, out_d

    out_i, out_d = C.chain_topk(one_pass, r, rmax, after)
    return C.apply_missing(out_i, out_d, valid)


def _adc_sum(lookup, m: int):
    """Sum over subspaces, in order from 0, of ``lookup(mm)`` (subspace
    ``mm``'s LUT entries at the rows' codes), in f32."""
    acc = lookup(0).to(torch.float32)              # 0 + first term, exactly
    for mm in range(1, m):
        acc = acc + lookup(mm).to(torch.float32)
    return acc


def pq_adc_topr_plain(codes, norms, ints, floats, luts, programs, *,
                      r: int = 40, valid=None, chunk: int = 8192,
                      after=None):
    """The kernel's function in plain torch: per DB chunk, the ADC sums
    (one gathered LUT column per subspace, added in order), the filter
    program, the pad-row gate, the lower bound ``after`` (pairs not
    strictly after it in (distance, id) order are dropped), then a stable
    sort of [carried top-R, chunk] -- carried entries and lower ids win
    ties."""
    dev = luts.device
    b, m, ksub = luts.shape
    n = codes.shape[0]
    flat = luts.reshape(b, m * ksub)
    best_d = torch.full((b, r), C.BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((b, r), -1, dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        cc = codes[s:s + chunk].long()
        adc = _adc_sum(lambda mm: flat.index_select(
            1, cc[:, mm] + mm * ksub), m)
        mask = F.eval_program_batched(programs, ints[s:s + chunk],
                                      floats[s:s + chunk])
        ok = mask & (norms[s:s + chunk] < C.BIG)[None, :]
        dist = torch.clamp(torch.where(ok, adc, C.BIG), max=C.BIG)
        ids = torch.arange(s, s + cc.shape[0], dtype=torch.int32,
                           device=dev).expand(b, -1)
        dist = torch.where(C.after_mask(dist, ids, after), dist, C.BIG)
        md = torch.cat([best_d, dist], dim=1)
        mid = torch.cat([best_i, ids], dim=1)
        order = torch.sort(md, dim=1, stable=True).indices[:, :r]
        best_d = torch.gather(md, 1, order)
        best_i = torch.gather(mid, 1, order)
    return C.apply_missing(best_i, best_d, valid)


def pq_adc_gather(codes, luts, nbr_ids, *, ints=None, floats=None,
                  programs=None, dvec=None, valid=None):
    """Graph-expansion ADC scoring of each query's own neighbour rows.

    codes (N, M) uint8; luts (B, M, K) f32 or bf16; nbr_ids (B, M0) int32
    (-1 pad).  Without ``programs``: returns adc2 (B, M0) f32, +inf at -1
    ids.  With ``ints``, ``floats``, ``programs`` and ``dvec`` (B,) f32 (the
    filter mode the traversal uses): also evaluates each row's TD bit under
    the query's program and returns (dbar (B, M0) f32, td (B, M0) bool) with
    dbar = sqrt(max(adc2, 0)) + D * (1 - td) (Eq. 2), +inf / False at -1
    ids.  CPU tensors run ``pq_adc_gather_plain``; CUDA tensors launch the
    kernel.
    """
    if not C.on_cuda(luts):
        return pq_adc_gather_plain(codes, luts, nbr_ids, ints=ints,
                                   floats=floats, programs=programs,
                                   dvec=dvec, valid=valid)
    C.require_cuda(GATHER)
    dev = luts.device
    b, m, ksub = luts.shape
    m0 = nbr_ids.shape[1]
    n = codes.shape[0]
    _check_luts(GATHER, luts, b, m, dev)
    C.check(GATHER, "codes", codes, torch.uint8, (n, m), dev)
    C.check(GATHER, "nbr_ids", nbr_ids, torch.int32, (b, m0), dev)
    filt = programs is not None
    if filt:
        mi, mf = ints.shape[1], floats.shape[1]
        C.check(GATHER, "ints", ints, torch.int32, (n, mi), dev)
        C.check(GATHER, "floats", floats, torch.float32, (n, mf), dev)
        C.check(GATHER, "dvec", dvec, torch.float32, (b,), dev)
        w = C.check_programs(GATHER, programs, b, mi, mf, dev)
        args = (ints, floats, programs["valid"], programs["imask"],
                programs["flo"], programs["fhi"], dvec)
    else:
        mi = mf = w = 0
        args = (None,) * 7
    out_d = torch.empty((b, m0), dtype=torch.float32, device=dev)
    out_td = torch.empty((b, m0) if filt else (0,), dtype=torch.int32,
                         device=dev)
    if b * m0:
        status = _lib().pq_adc_gather_launch(
            C.ptr(nbr_ids), C.ptr(luts), int(luts.dtype == torch.bfloat16),
            C.ptr(codes), *(None if a is None else C.ptr(a) for a in args),
            b, m0, m, ksub, mi, mf, w, int(filt), C.ptr(out_d),
            C.ptr(out_td), C.stream_ptr(dev))
        check_status(GATHER, status)
        count_launch(GATHER)
    return _finish(out_d, out_td.to(torch.bool) if filt else None, valid)


def _finish(d, td, valid):
    d = torch.where(d >= C.BIG, float("inf"), d)
    if valid is not None:
        vmask = torch.as_tensor(valid, dtype=torch.bool,
                                device=d.device)[:, None]
        d = torch.where(vmask, d, float("inf"))
        if td is not None:
            td = td & vmask
    return d if td is None else (d, td)


def pq_adc_gather_plain(codes, luts, nbr_ids, *, ints=None, floats=None,
                        programs=None, dvec=None, valid=None):
    """The kernel's function in plain torch: gather the code rows, add the
    M LUT entries in subspace order, and in filter mode evaluate the TD bit
    and compose Eq. 2."""
    b, m, ksub = luts.shape
    safe = nbr_ids.clamp(min=0).long()
    cc = codes[safe].long()                               # (B, M0, M)
    flat = luts.reshape(b, m * ksub)
    adc = _adc_sum(lambda mm: flat.gather(1, cc[:, :, mm] + mm * ksub), m)
    invalid = nbr_ids < 0
    if programs is None:
        return _finish(torch.where(invalid, C.BIG, adc), None, valid)
    td = F.eval_program_gathered(programs, ints[safe], floats[safe])
    dist = torch.sqrt(torch.clamp(adc, min=0.0))
    dbar = dist + torch.where(td, 0.0, dvec[:, None])
    return _finish(torch.where(invalid, C.BIG, dbar), td & ~invalid, valid)
