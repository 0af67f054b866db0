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
from .. import check_status, count_launch, counted, library
from ...core import filters as F

TOPR, GATHER = "pq_adc_topr", "pq_adc_gather"
LUT_DTYPES = (torch.float32, torch.bfloat16)
_SCREEN_TILES = (16, 8, 4)       # queries per block of the 8-bit screen
QSUM_MAX = 32767                 # a pair's screen sum Q, at most


def screen_levels(m: int) -> int:
    """Levels of the kernel's 8-bit table entries at ``m`` subspaces:
    ``min(255, 32767 // m)``, so that the sum of a row's ``m`` entries fits
    a 16-bit lane with its top bit free (``csrc/pq_adc.cu``, "The
    screen")."""
    return 255 if m * 255 <= QSUM_MAX else QSUM_MAX // m


def _lib():
    lib = library(TOPR)
    if lib.pq_adc_topr_launch.argtypes is None:
        lib.pq_adc_topr_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
            + [ctypes.c_void_p] * 7)
        lib.pq_adc_topr_launch.restype = ctypes.c_int
        lib.pq_adc_gather_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3)
        lib.pq_adc_gather_launch.restype = ctypes.c_int
        lib.pq_adc_topr_smem_bytes.argtypes = [ctypes.c_int] * 8
        lib.pq_adc_topr_smem_bytes.restype = ctypes.c_size_t
        lib.pq_adc_screen_levels.argtypes = [ctypes.c_int]
        lib.pq_adc_precheck_probe.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
        for fn in (lib.pq_adc_max_r, lib.pq_adc_max_qt, lib.pq_adc_tile_rows,
                   lib.pq_adc_smem_limit, lib.pq_adc_screen_levels,
                   lib.pq_adc_precheck_probe):
            fn.restype = ctypes.c_int
    return lib


def _check_luts(name, luts, b, m, dev):
    if luts.dtype not in LUT_DTYPES:
        raise ValueError(f"{name}: luts has dtype {luts.dtype}, expected one "
                         f"of {LUT_DTYPES}")
    C.check(name, "luts", luts, luts.dtype, (b, m, None), dev)


def _query_tile(lib, b: int, m: int, ksub: int, r: int,
                prog: tuple[int, int, int]) -> tuple[int, bool]:
    """(queries per scan block, screened): the 8-bit screen with the
    widest query tile of 16, 8 or 4 whose table fits one block's shared
    memory beside its top-r lists, filter programs (``prog`` = (W, m_i,
    m_f)) and the kernel's static arrays (no wider than the batch needs);
    else the no-table scan, which computes every pair's exact key from the
    LUTs in global memory, with as many queries as its lists allow.  The
    limit is the current device's opt-in shared memory per block."""
    limit = lib.pq_adc_smem_limit()
    need = next((qt for qt in reversed(_SCREEN_TILES) if qt >= b),
                _SCREEN_TILES[0])
    for qt in _SCREEN_TILES:
        if qt <= need and lib.pq_adc_topr_smem_bytes(
                m, ksub, r, qt, 1, *prog) <= limit:
            return qt, True
    for qt in range(min(b, lib.pq_adc_max_qt()), 0, -1):
        if lib.pq_adc_topr_smem_bytes(m, ksub, r, qt, 0, *prog) <= limit:
            return qt, False
    raise AssertionError(f"{TOPR}: a top-{r} list of at most "
                         f"{lib.pq_adc_max_r()} entries always fits")


def _splits(q_tiles: int, n: int, sms: int, tile: int) -> int:
    """DB splits (one block per SM): of the counts that give at most two
    waves of blocks, the one whose last wave leaves the fewest SMs idle
    (the smallest on ties), with at least eight tiles of rows per split."""
    cap = max(1, min(-(-2 * sms // q_tiles), -(-n // (8 * tile)), 65535))

    def fill(s):
        blocks = q_tiles * s
        return blocks / (sms * -(-blocks // sms))
    return max(range(1, cap + 1), key=lambda s: (fill(s), -s))


def pq_adc_topr_work(codes, norms, ints, floats, luts, programs, *,
                     r: int = 40, valid=None, after=None, **_):
    """(FLOPs, bytes) of one call: the code rows, norms, attributes, LUTs,
    programs (the lane mask, the lower bound) read once, R ids and keys a
    query written once; one table add per (query, row, subspace)."""
    n, m = codes.shape
    b = luts.shape[0]
    return b * n * m, (C.nbytes(codes, norms, ints, floats, luts, programs,
                                valid, after) + b * r * 8)


@counted(TOPR, pq_adc_topr_work)
def pq_adc_topr(codes, norms, ints, floats, luts, programs, *, r: int = 40,
                valid=None, chunk: int = 8192, after=None, screen_counts=None,
                rescore_counts=None):
    """Fused compressed filtered top-R candidate scan.

    codes (N, M) uint8 (each < K); norms (N,) f32 (rows with norm +inf or
    >= BIG are padding and never returned); ints (N, m_i) int32, floats
    (N, m_f) f32; luts (B, M, K) f32 or bf16 from ``quant.adc.build_luts``;
    programs {valid (B, W) f32, imask (B, W, m_i) int64, flo/fhi (B, W,
    m_f) f32}; ``after`` an optional per-query lower bound (after_d (B,)
    f32, after_i (B,) int32): only pairs strictly after it in (distance,
    id) order are returned.  CPU tensors run ``pq_adc_topr_plain`` (scan
    chunk ``chunk``); CUDA tensors launch the kernel, in chained passes of
    its longest list when R is larger (``_common.chain_topk``).
    ``screen_counts`` and ``rescore_counts``, optional (B,) int32 CUDA
    tensors, get each query's count of pairs that passed the kernel's
    8-bit screen, and of pairs whose exact key it then computed, added to
    them (the no-table scan computes every pair's key and counts the pairs
    it passes on as the screen's).  Returns (ids (B, R), adc2 (B, R)).
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
    for label, cnt in (("screen_counts", screen_counts),
                       ("rescore_counts", rescore_counts)):
        if cnt is not None:
            C.check(TOPR, label, cnt, torch.int32, (b,), dev)
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
    qt, screened = _query_tile(lib, b, m, ksub, min(r, rmax), (w, mi, mf))
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
            C.ptr(luts), int(luts.dtype == torch.bfloat16), int(screened),
            C.ptr(codes), C.ptr(norms), C.ptr(ints), C.ptr(floats),
            C.ptr(programs["valid"]), C.ptr(programs["imask"]),
            C.ptr(programs["flo"]), C.ptr(programs["fhi"]), ad, ai, b, n, m,
            ksub, mi, mf, w, rr, qt, splits,
            None if screen_counts is None else C.ptr(screen_counts),
            None if rescore_counts is None else C.ptr(rescore_counts),
            C.ptr(part_d), C.ptr(part_i), C.ptr(out_d), C.ptr(out_i),
            C.stream_ptr(dev))
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
        best_d, best_i = C.stable_topk([best_d, dist], r, [best_i, ids])
    return C.apply_missing(best_i, best_d, valid)


def pq_adc_gather_work(codes, luts, nbr_ids, *, ints=None, floats=None,
                       programs=None, dvec=None, valid=None):
    """(FLOPs, bytes) of one call: each valid id's code row, one table entry
    per lookup (and its attributes in filter mode), the ids, programs, D
    and lane mask read once, the distances (and TD bytes) written once;
    one table add per (valid id, subspace)."""
    m = codes.shape[1]
    n = C.n_valid(nbr_ids)
    row = C.nbytes(codes[:1]) + m * luts.element_size()
    out = 4
    if programs is not None:
        row += C.nbytes(ints[:1], floats[:1])
        out += 1
    return n * m, (C.nbytes(nbr_ids, programs, dvec, valid)
                   + nbr_ids.numel() * out + n * row)


@counted(GATHER, pq_adc_gather_work)
def pq_adc_gather(codes, luts, nbr_ids, *, ints=None, floats=None,
                  programs=None, dvec=None, valid=None):
    """Graph-expansion ADC scoring of each query's own neighbour rows.

    codes (N, M) uint8; luts (B, M, K) f32 or bf16; nbr_ids (B, M0) int32 or
    int64 (-1 pad).  Without ``programs``: returns adc2 (B, M0) f32, +inf at
    -1 ids.  With ``ints``, ``floats``, ``programs`` and ``dvec`` (B,) f32
    (the filter mode the traversal uses): also evaluates each row's TD bit
    under the query's program and returns (dbar (B, M0) f32, td (B, M0)
    bool) with dbar = sqrt(max(adc2, 0)) + D * (1 - td) (Eq. 2), +inf /
    False at -1 ids.  CPU tensors run ``pq_adc_gather_plain``; CUDA tensors
    launch the kernel, which also applies the +inf / ``valid`` epilogue, so
    a CUDA call dispatches no torch op but its output allocations.
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
    C.check(GATHER, "nbr_ids", nbr_ids, C.id_dtype(nbr_ids), (b, m0), dev)
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
    lane_ok = C.lane_mask(GATHER, valid, b, dev)
    out_d = torch.empty((b, m0), dtype=torch.float32, device=dev)
    out_td = (torch.empty((b, m0), dtype=torch.bool, device=dev) if filt
              else None)
    if b * m0:
        status = _lib().pq_adc_gather_launch(
            C.ptr(nbr_ids), int(nbr_ids.dtype == torch.int64), C.ptr(luts),
            int(luts.dtype == torch.bfloat16), C.ptr(codes),
            *(None if a is None else C.ptr(a) for a in (*args, lane_ok)),
            b, m0, m, ksub, mi, mf, w, int(filt), C.ptr(out_d),
            None if out_td is None else C.ptr(out_td), C.stream_ptr(dev))
        check_status(GATHER, status)
        count_launch(GATHER, (b, m0))
    return (out_d, out_td) if filt else out_d


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
