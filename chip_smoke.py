#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port of FAVOR on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

  build    compile the CUDA kernels from repro_torch/csrc with nvcc (one
           process per source, all started together) and load them;
  kernels  each kernel at one card's deployment scale -- 4,000,000 rows x
           d = 128 f32 (favor-anns' 64M rows over its 16 model shards) with
           the paper schema's attributes and favor-anns' PQ codes (M = 32
           subspaces of K = 256 centroids), 1024 queries -- held against its
           plain PyTorch version and timed with CUDA events beside its bound
           (filtered_topk on the whole batch in both modes, with its TF32
           screen's candidates per query by scenario and the screen's own
           bound; filtered_topk at k = 100 and pq_adc_topr at R = 1600,
           chained passes, on a 64-query subset; the two gather kernels by
           graph replay after an L2 flush, after a clean L2 refill and --
           pq_adc_gather -- with warm LUTs, beside a one-element kernel's
           time under each, and a design bound counting 32-byte sectors);
  serve    FavorIndex.build on a synthetic paper dataset (HNSW M=16, host
           build) with favor-anns' QuantSpec (PQ m=32, nbits=8, rerank=8;
           the codebook trained on the card), then FavorIndex.query for
           batches of 1024 filtered queries over the six paper scenarios and
           a < 1 % filter, so both routes run, under three option sets: f32
           (the route of filtered_topk and gather_distance), favor-anns'
           own ``use_pq=True`` (pq_adc_topr + the exact re-rank on the
           brute route) and ``use_pq`` + ``graph_quant="pq"``
           (pq_adc_gather on the graph route).  Each pass resets the launch
           counters before it and reads them after it; results are checked
           against exact filtered ground truth (plain brute version on the
           card), against the port's own CPU path on a query subset, and an
           SQ index is checked on both compressed routes.  A bucketed pass
           (the f32 options plus ``batch=BatchSpec(...)``, after
           ``warmup``) must return the unbucketed f32 pass's ids and
           distances bit for bit, as must one bucketed ``use_pq`` +
           ``graph_quant="pq"`` batch;
  embedding_bag  the JAX package's ``embedding_bag`` entry point (its only
           path) at dlrm-rm2's vocabulary and width, both modes, held to
           its plain version bit for bit and timed beside
           ``torch.nn.functional.embedding_bag``;
  live     on the serve index: 2,048 upserts (256 replacing base ids) and
           1,024 deletes, a query batch (no deleted id, brute recall@10
           1.0 against exact ground truth over the live rows, graph recall
           within 0.02 of the f32 pass), ``merge()`` timed, and the batch
           again; the launches of each kernel for each step;
  widths   the graph route's two gather kernels at every (B, M) width the
           serve phase launched them at (each pass counts its launches by
           width), on the kernel phase's rows: held to their plain versions
           and timed beside their bounds, and launches x (ms - bound)
           summed over each histogram.

Then a ``kernels`` line, the card's name and power limit as nvidia-smi
reports them, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published rates of the H100 (NVIDIA data sheet, dense, at the full power
# limit), used for the bound of each kernel: f32 outside the tensor cores;
# TF32 on them for the bound of filtered_topk's screen.
# The shared-memory rate, for the bound of pq_adc_topr's 8-bit screen, is
# not on the data sheet: 32 banks x 4 bytes a clock per SM, times the SMs
# (132 SXM, 114 PCIe) and the data sheet's highest boost clock (1,980 MHz
# SXM, 1,755 MHz PCIe).
RATES = {"SXM": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12,
                 "tf32_flops": 495e12,
                 "smem_bytes_per_s": 128 * 132 * 1.98e9},
         "PCIe": {"hbm_bytes_per_s": 2.0e12, "f32_flops": 51e12,
                  "tf32_flops": 378e12,
                  "smem_bytes_per_s": 128 * 114 * 1.755e9}}
# kernel vs plain version: the kernel's 128-term dot is one FMA chain, the
# plain version's a cuBLAS / tree reduction, so distances differ in the last
# f32 bits of the squared form; ids must agree wherever distances are apart
RTOL = ATOL = 1e-5
K, EF, M0 = 10, 128, 32
K_LONG, R_LONG, LONG_SUB = 100, 1600, 64   # chained-pass checks (subset)
PQ_M, PQ_BITS, RERANK = 32, 8, 8   # favor-anns' QuantSpec
# recall bars of the compressed routes, two points as in the JAX package's
# own (tests/test_quant.py, tests/test_scoring.py): the compressed brute
# route and the SQ graph route against the f32 route; the PQ graph route
# against what its scorer can rank at all -- the exhaustive compressed scan
# with the same exact re-rank depth (PQ m=32 x 8 bits ranks this corpus'
# near neighbours too coarsely for the f32 bar)
RECALL_SLACK = 0.02
DB_ROWS = 4_000_000    # kernels phase: one card's share of favor-anns
SERVE_N = 16384        # serve phase: rows of the host-built HNSW index
BATCH = 1024           # queries per batch (favor-anns' serve batch)
REPEATS = 10           # timed kernel runs (median)
SERVE_REPEATS = 5      # timed query batches
SEED = 0
BAG_V, BAG_D = 1_000_000, 64   # dlrm-rm2's vocabulary and width
BAG_B, BAG_L = 65_536, 32      # bags per call, ids per bag (-1 tail)
BAG_ROUNDS = 5                 # timing rounds of kernel and library call
LIVE_UPSERT, LIVE_REPLACE, LIVE_DELETE = 2048, 256, 1024
BUCKETS = dict(min_bucket=8, max_bucket=1024)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, *, repeats: int, warmup: int = 2, flush=None) -> float:
    """Median milliseconds of ``fn()`` over ``repeats`` runs, each between
    two CUDA events after ``warmup`` untimed runs; ``flush()`` (untimed)
    runs before each timed run."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, *, repeats: int, flush) -> float:
    """Median device milliseconds of ``fn()`` captured once in a CUDA graph
    and replayed ``repeats`` times between two CUDA events, ``flush()``
    (untimed) before each replay: the kernel's own time, without the
    wrapper's host work, which a microsecond kernel would otherwise be
    timed by."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, repeats=repeats, warmup=1, flush=flush)


def count_torch_ops(fn) -> int:
    """Number of torch operator calls ``fn()`` dispatches: the host work of
    an eager loop, one op at a time (kernel launches through ctypes are not
    torch ops and are not counted)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n


def mixed_filters(F, schema, b: int) -> tuple[list, list]:
    """``b`` filters cycling over the six paper scenarios and a < 1 %
    filter; returns (filters, scenario names)."""
    scen = dict(F.paper_filters(schema))
    scen["tiny_lt1pct"] = F.And(F.Equality("i0", 3), F.Range("f0", 10, 12))
    names = list(scen)
    picked = [names[i % len(names)] for i in range(b)]
    return [scen[n] for n in picked], picked


def phase_kernels(dev, rates):
    import numpy as np
    import torch

    from repro_torch import kernels as Kn
    from repro_torch.core import filters as F
    from repro_torch.core import prefbf
    from repro_torch.core.router import compile_programs
    from repro_torch.kernels.filtered_topk import ops as ft
    from repro_torch.kernels.gather_distance import ops as gd
    from repro_torch.parity import topk_mismatch

    n, d, b = DB_ROWS, 128, BATCH
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    vecs = rng.standard_normal((n, d), dtype=np.float32)
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    schema = F.paper_schema()
    attrs = F.random_attributes(schema, n, seed=SEED + 1)
    padded = prefbf.pad_db(vecs, norms, attrs.ints, attrs.floats, 8192)
    pv, pn, pi, pf = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                      for a in padded)
    del vecs, padded
    qs = torch.as_tensor(rng.standard_normal((b, d), dtype=np.float32),
                         device=dev)
    flts, scen = mixed_filters(F, schema, b)
    progs = compile_programs(flts, schema, b, device=dev)
    dvec = torch.as_tensor(rng.uniform(0.5, 3.0, size=b).astype(np.float32),
                           device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mi, mf = attrs.ints.shape[1], attrs.floats.shape[1]
    rates_used = dict(rates)

    # -- filtered_topk: PreFBF mode through prefbf_topk (the brute route),
    #    and exclusion mode, each on the whole batch (the timed grid); then
    #    k = K_LONG (chained passes) on a subset; the screen's candidates ----
    out = {}
    errs = []
    for mode, exclude in (("prefbf", False), ("exclusion", True)):
        kid, kd = ft.filtered_topk(pv, pn, pi, pf, qs, progs, k=K, dvec=dvec,
                                   exclude=exclude)
        pid, pd = ft.filtered_topk_plain(pv, pn, pi, pf, qs, progs, k=K,
                                         dvec=dvec, exclude=exclude)
        m = topk_mismatch(pid.cpu().numpy(), pd.cpu().numpy(),
                          kid.cpu().numpy(), kd.cpu().numpy(), RTOL, ATOL)
        check(m["dist_mismatch"] == 0 and m["id_mismatch"] == 0,
              f"filtered_topk ({mode}) vs plain: {m}")
        check(int(kid.max()) < n, "filtered_topk returned a pad row")
        errs.append(m["max_abs_diff"])
        out[mode] = m
    sub = slice(0, LONG_SUB)
    sub_args = (qs[sub].clone(), {k: v[sub].clone() for k, v in progs.items()})
    kid, kd = ft.filtered_topk(pv, pn, pi, pf, *sub_args, k=K_LONG)
    pid, pd = ft.filtered_topk_plain(pv, pn, pi, pf, *sub_args, k=K_LONG)
    m = topk_mismatch(pid.cpu().numpy(), pd.cpu().numpy(), kid.cpu().numpy(),
                      kd.cpu().numpy(), RTOL, ATOL)
    check(m["dist_mismatch"] == 0 and m["id_mismatch"] == 0,
          f"filtered_topk (k={K_LONG}, chained) vs plain: {m}")
    errs.append(m["max_abs_diff"])
    out[f"prefbf_k{K_LONG}_first{LONG_SUB}"] = m
    # each of the grid's DB splits admits its first k rows (its threshold
    # starts at BIG), and no pair is screened twice
    lib = Kn.library("filtered_topk")
    splits = ft._splits(b, pv.shape[0], torch.cuda.get_device_properties(
        dev).multi_processor_count, lib.filtered_topk_query_tile(),
        lib.filtered_topk_tile_rows())
    cands, rescored = {}, {}
    names = np.asarray(scen)
    for mode, exclude in (("prefbf", False), ("exclusion", True)):
        counts = torch.zeros(b, dtype=torch.int32, device=dev)
        exact = torch.zeros(b, dtype=torch.int32, device=dev)
        ft.filtered_topk(pv, pn, pi, pf, qs, progs, k=K, dvec=dvec,
                         exclude=exclude, screen_counts=counts,
                         rescore_counts=exact)
        per, per_x = counts.cpu().numpy(), exact.cpu().numpy()
        check(int(per.min()) >= K * splits and int(per.max()) <= n,
              f"filtered_topk ({mode}): screen counts {int(per.min())}.."
              f"{int(per.max())} outside [k x {splits} splits, {n} rows]")
        check(int(per_x.min()) >= K and bool((per_x <= per).all()),
              f"filtered_topk ({mode}): exact re-scores {int(per_x.min())}"
              f"..{int(per_x.max())}: fewer than k, or above the screen's")
        for out_, v in ((cands, per), (rescored, per_x)):
            out_[mode] = {s: float(v[names == s].mean())
                          for s in dict.fromkeys(scen)}
            out_[mode]["all"] = float(v.mean())
            out_[mode]["total"] = int(v.sum())
    ms = cuda_ms(lambda: prefbf.prefbf_topk(pv, pn, pi, pf, qs, progs, k=K,
                                            chunk=8192),
                 repeats=REPEATS)
    ms_excl = cuda_ms(lambda: ft.filtered_topk(pv, pn, pi, pf, qs, progs,
                                               k=K, dvec=dvec, exclude=True),
                      repeats=REPEATS)
    plain_ms = cuda_ms(lambda: ft.filtered_topk_plain(pv, pn, pi, pf, qs,
                                                      progs, k=K, chunk=8192),
                       repeats=3, warmup=1)
    row_bytes = 4 * (d + 1 + mi + mf)
    prog_bytes = sum(v.numel() * v.element_size() for v in progs.values())
    ft_bytes = n * row_bytes + b * d * 4 + prog_bytes + b * K * 8
    # the design's own bound: every pair's dot on the TF32 tensor cores,
    # then this run's exact re-scores (one d-long f32 dot each); beside it
    # every pair's dot in f32 (the all-f32 design's bound) and the
    # screen alone
    ft_ops = 2 * b * n * d
    bytes_s = ft_bytes / rates["hbm_bytes_per_s"]

    def ft_ops_s(mode):
        return (ft_ops / rates["tf32_flops"]
                + 2 * d * rescored[mode]["total"] / rates["f32_flops"])
    ft_bound = 1e3 * max(bytes_s, ft_ops_s("prefbf"))
    ft_bound_excl = 1e3 * max(bytes_s, ft_ops_s("exclusion"))
    ft_bound_f32 = 1e3 * max(bytes_s, ft_ops / rates["f32_flops"])
    ft_bound_tf32 = 1e3 * max(bytes_s, ft_ops / rates["tf32_flops"])
    kernels = {"filtered_topk": {
        "name": "filtered_topk", "route": "cuda",
        "source": "src/repro_torch/csrc/filtered_topk.cu",
        "replaces": "src/repro/kernels/filtered_topk/kernel.py:109",
        "max_abs_err": max(errs), "ms": ms, "ms_exclusion": ms_excl,
        "plain_ms": plain_ms, "bound_ms": ft_bound,
        "bound_by": "operations" if ft_ops_s("prefbf") >= bytes_s else "bytes",
        "bound_ms_exclusion": ft_bound_excl,
        "bound_ms_f32_all_pairs": ft_bound_f32,
        "bound_ms_tf32_screen": ft_bound_tf32,
        "library_ms": None,
        "screen_candidates_per_query": cands,
        "exact_rescores_per_query": rescored,
        "splits": splits,
        "shape": {"B": b, "N": n, "d": d, "k": K, "m_i": mi, "m_f": mf,
                  "W": int(progs["valid"].shape[1])},
    }}

    # -- gather_distance: B x M0 random ids (about 10 % -1), in full --------
    ids = rng.integers(0, n, size=(b, M0)).astype(np.int32)
    ids[rng.random((b, M0)) < 0.1] = -1
    ids_t = torch.as_tensor(ids, device=dev)
    kd, ktd = gd.gather_distance(pv, pn, pi, pf, qs, ids_t, progs, dvec)
    pd, ptd = gd.gather_distance_plain(pv, pn, pi, pf, qs, ids_t, progs, dvec)
    fin = torch.isfinite(pd)
    check(bool(torch.equal(fin, torch.isfinite(kd))), "gather_distance -1 ids")
    diff = (kd[fin] - pd[fin]).abs()
    gd_err = float(diff.max()) if diff.numel() else 0.0
    check(bool((diff <= ATOL + RTOL * pd[fin].abs()).all()),
          f"gather_distance vs plain: max abs diff {gd_err}")
    check(bool(torch.equal(ktd, ptd)), "gather_distance TD bits vs plain")
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_         # rows of a real traversal come from HBM
    sweep = torch.ones(64 * 2**20, dtype=torch.uint8, device=dev)

    def clean():
        """L2 refilled with clean lines: ``flush`` leaves it dirty, and the
        next kernel pays for the write-back (``floor_ms``)."""
        sweep.sum()
    one = torch.zeros(1, device=dev)
    floors = {"floor_ms": graph_ms(lambda: one.fill_(1.0),
                                   repeats=2 * REPEATS, flush=flush),
              "floor_ms_clean": graph_ms(lambda: one.fill_(1.0),
                                         repeats=2 * REPEATS, flush=clean)}
    gd_call_ms = cuda_ms(lambda: gd.gather_distance(pv, pn, pi, pf, qs, ids_t,
                                                    progs, dvec),
                         repeats=2 * REPEATS, flush=flush)
    gd_ms = graph_ms(lambda: gd.gather_distance(pv, pn, pi, pf, qs, ids_t,
                                                progs, dvec),
                     repeats=2 * REPEATS, flush=flush)
    gd_clean_ms = graph_ms(lambda: gd.gather_distance(
        pv, pn, pi, pf, qs, ids_t, progs, dvec), repeats=2 * REPEATS,
        flush=clean)
    gd_plain_ms = graph_ms(lambda: gd.gather_distance_plain(
        pv, pn, pi, pf, qs, ids_t, progs, dvec), repeats=10, flush=flush)
    kernels["gather_distance"] = {
        "name": "gather_distance", "route": "cuda",
        "source": "src/repro_torch/csrc/gather_distance.cu",
        "replaces": "src/repro/kernels/gather_distance/kernel.py:63",
        "max_abs_err": gd_err, "ms": gd_ms, "ms_clean": gd_clean_ms,
        **floors, "call_ms": gd_call_ms, "plain_ms": gd_plain_ms,
        **gd_bounds(rates, ids_t, d, mi, mf, progs),
        "library_ms": None,
        "shape": {"B": b, "M0": M0, "N": n, "d": d,
                  "valid_ids": int((ids >= 0).sum())},
    }
    gathers = {"pv": pv, "pn": pn, "pi": pi, "pf": pf, "qs": qs,
               "progs": progs, "dvec": dvec, "ids": ids_t, "flush": flush,
               "clean": clean, "floors": floors}
    kernels.update(pq_kernels(dev, rates, rng, pn, pi, pf, qs, progs, dvec,
                              ids_t, n, flush, scen, gathers))
    emit({"phase": "kernels", "setup_s": setup_s, "rates": rates_used,
          **{name: {k: v for k, v in row.items() if k != "name"}
             for name, row in kernels.items()},
          "filtered_topk_vs_plain": out,
          "launches_outside_main_path": dict(Kn.launch_counts)})
    return kernels, gathers


def sector_bytes(nbytes: int) -> int:
    """Bytes a scattered read of ``nbytes`` moves: whole 32-byte sectors."""
    return 32 * -(-nbytes // 32)


def gd_bounds(rates, ids, d, mi, mf, progs) -> dict:
    """``gather_distance``'s bounds for the id block ``ids`` (B, M): the
    data sheet's (each valid id's row, norm and attributes, the ids, the
    queries, programs and D, dbar and the TD byte out) and the design's
    (the same, each scattered read in whole 32-byte sectors)."""
    b = ids.shape[0]
    n_valid = int((ids >= 0).sum())
    prog_bytes = sum(v.numel() * v.element_size() for v in progs.values())
    dense = (ids.numel() * ids.element_size() + b * (d + 1) * 4 + prog_bytes
             + ids.numel() * 5)
    scattered = n_valid * 4 * (d + 1 + mi + mf)
    design = n_valid * (sector_bytes(4 * d) + sector_bytes(4)
                        + sector_bytes(4 * mi) + sector_bytes(4 * mf))
    ops = 2 * n_valid * d
    ops_s = ops / rates["f32_flops"]
    bytes_s = (dense + scattered) / rates["hbm_bytes_per_s"]
    return {"bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "bound_ms_design": 1e3 * max(
                (dense + design) / rates["hbm_bytes_per_s"], ops_s)}


def pq_gather_bounds(rates, ids, codes, luts, mi, mf, progs) -> dict:
    """``pq_adc_gather``'s bounds for the id block ``ids`` (B, M0) against
    ``luts`` (B, M, K): the data sheet's (each valid id's code row and
    attributes, one table entry per lookup, the ids, programs and D, dbar
    and the TD byte out), and the design's: each scattered read in whole
    32-byte sectors, the tables as the 32-byte sectors the batch's lookups
    touch (counted from this run's ids and codes) -- and, warm, without
    the tables, which the traversal reads from L2 wave after wave."""
    import torch
    b = ids.shape[0]
    m, ksub = luts.shape[1], luts.shape[2]
    ok = ids >= 0
    n_valid = int(ok.sum())
    prog_bytes = sum(v.numel() * v.element_size() for v in progs.values())
    dense = ids.numel() * ids.element_size() + prog_bytes + b * 4 \
        + ids.numel() * 5
    scattered = n_valid * (m + luts.element_size() * m + 4 * (mi + mf))
    cc = codes[ids.clamp(min=0).long()].long()                # (B, M0, M)
    entry = (torch.arange(b, device=ids.device)[:, None, None] * m * ksub
             + torch.arange(m, device=ids.device) * ksub + cc)
    lut_sectors = int(torch.unique(
        entry[ok] * luts.element_size() // 32).numel())
    rows = n_valid * (sector_bytes(m) + sector_bytes(4 * mi)
                      + sector_bytes(4 * mf))
    ops = n_valid * m
    ops_s = ops / rates["f32_flops"]
    bytes_s = (dense + scattered) / rates["hbm_bytes_per_s"]
    hbm = rates["hbm_bytes_per_s"]
    return {"bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "bound_ms_design": 1e3 * max(
                (dense + rows + 32 * lut_sectors) / hbm, ops_s),
            "bound_ms_design_warm": 1e3 * max((dense + rows) / hbm, ops_s),
            "lut_sectors_touched": lut_sectors,
            "lut_sectors_total": b * m * ksub * luts.element_size() // 32}


def pq_kernels(dev, rates, rng, pn, pi, pf, qs, progs, dvec, ids_t, n,
               flush, scen, gathers):
    """pq_adc_topr (f32 LUTs, R = rerank * k) and pq_adc_gather (bf16
    LUTs, filter mode as the traversal calls it) over favor-anns' PQ codes
    of the kernel phase's rows: codes and centroids drawn from the seed,
    LUTs from the port's build_luts."""
    import numpy as np
    import torch

    from repro_torch.kernels.pq_adc import ops as pq
    from repro_torch.parity import topk_mismatch
    from repro_torch.quant.adc import build_luts

    b, ksub, r = qs.shape[0], 1 << PQ_BITS, RERANK * K
    n_pad, mi, mf = pn.shape[0], pi.shape[1], pf.shape[1]
    codes = torch.as_tensor(rng.integers(0, ksub, size=(n_pad, PQ_M),
                                         dtype=np.uint8), device=dev)
    cents = torch.as_tensor(rng.standard_normal(
        (PQ_M, ksub, qs.shape[1] // PQ_M), dtype=np.float32), device=dev)
    luts = build_luts(cents, qs)
    prog_bytes = sum(v.numel() * v.element_size() for v in progs.values())
    out = {}

    # -- pq_adc_topr: the whole batch against its plain version --------------
    kid, kd = pq.pq_adc_topr(codes, pn, pi, pf, luts, progs, r=r)
    t0 = time.perf_counter()
    pid, pd = pq.pq_adc_topr_plain(codes, pn, pi, pf, luts, progs, r=r)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rows = n_pad
    if plain_s > 60:                 # compare on the first 1M rows instead
        rows = 1_000_000
        kid, kd = pq.pq_adc_topr(codes[:rows], pn[:rows], pi[:rows],
                                 pf[:rows], luts, progs, r=r)
        pid, pd = pq.pq_adc_topr_plain(codes[:rows], pn[:rows], pi[:rows],
                                       pf[:rows], luts, progs, r=r)
    m = topk_mismatch(pid.cpu().numpy(), pd.cpu().numpy(), kid.cpu().numpy(),
                      kd.cpu().numpy(), RTOL, ATOL)
    check(m["dist_mismatch"] == 0 and m["id_mismatch"] == 0,
          f"pq_adc_topr vs plain: {m}")
    check(bool(torch.equal(kid, pid) and torch.equal(kd, pd)),
          "pq_adc_topr vs plain: not bit-identical")
    check(int(kid.max()) < n, "pq_adc_topr returned a pad row")
    # the 8-bit screen's candidates and exact re-scores per query: each DB
    # split passes every row until its list holds r rows that pass the
    # filter, and a pair is screened at most once
    qt, screened = pq._query_tile(pq._lib(), b, PQ_M, ksub, r, (
        int(progs["valid"].shape[1]), mi, mf))
    check(screened, f"pq_adc_topr: no 8-bit screen at M={PQ_M}, K={ksub}")
    splits = pq._splits(-(-b // qt), n_pad, torch.cuda.get_device_properties(
        dev).multi_processor_count, pq._lib().pq_adc_tile_rows())
    counts = torch.zeros(b, dtype=torch.int32, device=dev)
    exact = torch.zeros(b, dtype=torch.int32, device=dev)
    pq.pq_adc_topr(codes, pn, pi, pf, luts, progs, r=r,
                   screen_counts=counts, rescore_counts=exact)
    per, per_x = counts.cpu().numpy(), exact.cpu().numpy()
    check(int(per.min()) >= r * splits and int(per.max()) <= n,
          f"pq_adc_topr: screen counts {int(per.min())}..{int(per.max())} "
          f"outside [r x {splits} splits, {n} rows]")
    check(int(per_x.min()) >= r and bool((per_x <= per).all()),
          f"pq_adc_topr: exact re-scores {int(per_x.min())}.."
          f"{int(per_x.max())}: fewer than r, or above the screen's")
    names = np.asarray(scen)
    cands, rescored = {}, {}
    for out_, v in ((cands, per), (rescored, per_x)):
        out_.update({s: float(v[names == s].mean())
                     for s in dict.fromkeys(scen)})
        out_["all"] = float(v.mean())
        out_["total"] = int(v.sum())
    # R above the kernel's longest list: chained passes, on a subset
    sub = slice(0, LONG_SUB)
    sub_args = (luts[sub].clone(), {k: v[sub].clone() for k, v in progs.items()})
    lid, ld = pq.pq_adc_topr(codes, pn, pi, pf, *sub_args, r=R_LONG)
    qid, qd = pq.pq_adc_topr_plain(codes, pn, pi, pf, *sub_args, r=R_LONG)
    check(bool(torch.equal(lid, qid) and torch.equal(ld, qd)),
          f"pq_adc_topr (r={R_LONG}, chained) vs plain: not bit-identical")
    ms = cuda_ms(lambda: pq.pq_adc_topr(codes, pn, pi, pf, luts, progs, r=r),
                 repeats=REPEATS)
    plain_ms = cuda_ms(lambda: pq.pq_adc_topr_plain(codes, pn, pi, pf, luts,
                                                    progs, r=r),
                       repeats=3, warmup=1)
    topr_bytes = (n_pad * (PQ_M + 4 * (1 + mi + mf)) + luts.numel() * 4
                  + prog_bytes + b * r * 8)
    topr_ops = b * n * PQ_M            # one add per (query, row, subspace)
    # the design's own bound: one byte of the 8-bit table per (query, row,
    # subspace) at the shared-memory rate, then this run's exact re-scores
    # (M f32 adds each)
    design_s = (b * n * PQ_M / rates["smem_bytes_per_s"]
                + PQ_M * rescored["total"] / rates["f32_flops"])
    out["pq_adc_topr"] = {
        "name": "pq_adc_topr", "route": "cuda",
        "source": "src/repro_torch/csrc/pq_adc.cu",
        "replaces": "src/repro/kernels/pq_adc/kernel.py:172",
        "max_abs_err": m["max_abs_diff"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(topr_bytes / rates["hbm_bytes_per_s"],
                              topr_ops / rates["f32_flops"]),
        "bound_by": ("operations" if topr_ops / rates["f32_flops"]
                     >= topr_bytes / rates["hbm_bytes_per_s"] else "bytes"),
        "bound_ms_design": 1e3 * max(topr_bytes / rates["hbm_bytes_per_s"],
                                     design_s),
        "library_ms": None,
        "screen_candidates_per_query": cands,
        "exact_rescores_per_query": rescored,
        "query_tile": qt, "splits": splits,
        "compared_rows": rows, "identical_rows": m["identical_rows"],
        f"r{R_LONG}_first{LONG_SUB}_bit_identical": True,
        "shape": {"B": b, "N": n, "M": PQ_M, "K": ksub, "R": r,
                  "lut": "f32"},
    }

    # -- pq_adc_gather: B x M0 ids (about 10 % -1), bf16 LUTs, filter mode ---
    lb = luts.to(torch.bfloat16)

    def gather():
        return pq.pq_adc_gather(codes, lb, ids_t, ints=pi, floats=pf,
                                programs=progs, dvec=dvec)

    def gather_plain():
        return pq.pq_adc_gather_plain(codes, lb, ids_t, ints=pi, floats=pf,
                                      programs=progs, dvec=dvec)

    kd, ktd = gather()
    pd, ptd = gather_plain()
    fin = torch.isfinite(pd)
    check(bool(torch.equal(fin, torch.isfinite(kd))), "pq_adc_gather -1 ids")
    diff = (kd[fin] - pd[fin]).abs()
    g_err = float(diff.max()) if diff.numel() else 0.0
    check(bool((diff <= ATOL + RTOL * pd[fin].abs()).all()),
          f"pq_adc_gather vs plain: max abs diff {g_err}")
    check(bool(torch.equal(ktd, ptd)), "pq_adc_gather TD bits vs plain")
    check(bool(torch.equal(kd, pd)), "pq_adc_gather vs plain: not "
          "bit-identical")

    def warm():                   # a clean L2, then the tables read once
        gathers["clean"]()
        lb.sum()
    call_ms = cuda_ms(gather, repeats=2 * REPEATS, flush=flush)
    g_ms = graph_ms(gather, repeats=2 * REPEATS, flush=flush)
    g_clean_ms = graph_ms(gather, repeats=2 * REPEATS,
                          flush=gathers["clean"])
    g_warm_ms = graph_ms(gather, repeats=2 * REPEATS, flush=warm)
    g_plain_ms = graph_ms(gather_plain, repeats=10, flush=flush)
    out["pq_adc_gather"] = {
        "name": "pq_adc_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/pq_adc.cu",
        "replaces": "src/repro/kernels/pq_adc/kernel.py:127",
        "max_abs_err": g_err, "ms": g_ms, "ms_clean": g_clean_ms,
        "ms_warm_luts": g_warm_ms, **gathers["floors"], "call_ms": call_ms,
        "plain_ms": g_plain_ms,
        **pq_gather_bounds(rates, ids_t, codes, lb, mi, mf, progs),
        "library_ms": None,
        "shape": {"B": b, "M0": ids_t.shape[1], "N": n, "M": PQ_M,
                  "K": ksub, "valid_ids": int((ids_t >= 0).sum()),
                  "lut": "bf16"},
    }
    gathers.update(codes=codes, lb=lb, warm=warm)
    return out


def phase_embedding_bag(dev, rates):
    """The ``embedding_bag`` entry point, its kernel's only path, at
    dlrm-rm2's vocabulary and width: launch counters reset just before the
    two calls (sum, mean) and read just after; each output held to the
    plain version bit for bit; then kernel, plain version and
    ``torch.nn.functional.embedding_bag`` on the compacted (input, offsets)
    form timed with CUDA events."""
    import numpy as np
    import torch
    import torch.nn.functional as TF

    from repro_torch import kernels as Kn
    from repro_torch.kernels.embedding_bag import ops as eb

    rng = np.random.default_rng(SEED + 5)
    table = torch.as_tensor(rng.standard_normal((BAG_V, BAG_D),
                                                dtype=np.float32), device=dev)
    bags = rng.integers(0, BAG_V, size=(BAG_B, BAG_L)).astype(np.int32)
    cut = rng.integers(1, BAG_L + 1, size=BAG_B)   # random -1 tail per bag
    bags[np.arange(BAG_L)[None, :] >= cut[:, None]] = -1
    bags = torch.as_tensor(bags, device=dev)
    torch.cuda.synchronize()

    Kn.reset_launch_counts()
    outs = {mode: eb.embedding_bag(table, bags, mode=mode)
            for mode in ("sum", "mean")}
    torch.cuda.synchronize()
    launches = Kn.launch_counts["embedding_bag"]
    check(launches == 2, f"embedding_bag launched on its path: {launches}")

    valid = bags >= 0
    flat = bags[valid].long()                      # row-major: bag order
    offsets = torch.cumsum(valid.sum(dim=1), 0) - valid.sum(dim=1)
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    row = {"name": "embedding_bag", "route": "cuda",
           "source": "src/repro_torch/csrc/embedding_bag.cu",
           "replaces": "src/repro/kernels/embedding_bag/kernel.py:44",
           "launches": launches, "max_abs_err": 0.0}
    modes = {}
    for mode, got in outs.items():
        want = eb.embedding_bag_plain(table, bags, mode=mode)
        err = float((got - want).abs().max())
        row["max_abs_err"] = max(row["max_abs_err"], err)
        check(bool(torch.equal(got, want)),
              f"embedding_bag ({mode}) vs plain: max abs diff {err}")
        check(bool((got[~valid.any(dim=1)] == 0).all()),
              f"embedding_bag ({mode}): all-pad bags are 0")
        lib = TF.embedding_bag(flat, table, offsets, mode=mode)
        lib_err = float((lib - got).abs().max())
        check(bool(torch.allclose(lib, got, rtol=RTOL, atol=ATOL)),
              f"embedding_bag ({mode}) vs F.embedding_bag: {lib_err}")
        # device time of kernel and library call by CUDA-graph replay (L2
        # flushed), interleaved, BAG_ROUNDS medians each: the median of the
        # rounds is reported, and every round beside it; the eager call
        # (the wrapper's host work included) once
        kern, libr = [], []
        for _ in range(BAG_ROUNDS):
            kern.append(graph_ms(lambda: eb.embedding_bag(
                table, bags, mode=mode), repeats=2 * REPEATS,
                flush=scratch.zero_))
            libr.append(graph_ms(lambda: TF.embedding_bag(
                flat, table, offsets, mode=mode), repeats=2 * REPEATS,
                flush=scratch.zero_))
        modes[mode] = {
            "ms": statistics.median(kern), "ms_rounds": kern,
            "eager_ms": cuda_ms(lambda: eb.embedding_bag(
                table, bags, mode=mode), repeats=2 * REPEATS,
                flush=scratch.zero_),
            "plain_ms": cuda_ms(lambda: eb.embedding_bag_plain(
                table, bags, mode=mode), repeats=REPEATS, flush=scratch.zero_),
            "library_ms": statistics.median(libr), "library_ms_rounds": libr,
            "library_max_abs_diff": lib_err}
    n_valid = int(valid.sum())
    # each input read once: the ids, every distinct row the valid ids name
    # (a row named twice is read once), and the outputs written once
    n_rows = int(torch.unique(flat).numel())
    bag_bytes = bags.numel() * 4 + n_rows * BAG_D * 4 + BAG_B * BAG_D * 4
    bag_ops = n_valid * BAG_D                       # one f32 add per element
    bytes_ms = 1e3 * bag_bytes / rates["hbm_bytes_per_s"]
    ops_ms = 1e3 * bag_ops / rates["f32_flops"]
    row.update({"ms": modes["sum"]["ms"], "ms_mean": modes["mean"]["ms"],
                "eager_ms": modes["sum"]["eager_ms"],
                "eager_ms_mean": modes["mean"]["eager_ms"],
                "plain_ms": modes["sum"]["plain_ms"],
                "plain_ms_mean": modes["mean"]["plain_ms"],
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": modes["sum"]["library_ms"],
                "library_ms_mean": modes["mean"]["library_ms"],
                "shape": {"V": BAG_V, "d": BAG_D, "B": BAG_B, "L": BAG_L,
                          "valid_ids": n_valid, "distinct_rows": n_rows}})
    emit({"phase": "embedding_bag", **{k: v for k, v in row.items()
                                       if k != "name"}, "modes": modes})
    del table, bags, flat, scratch, outs
    torch.cuda.empty_cache()
    return row


def serve_pass(fi, opts, qs, flts, names, truth, label: str):
    """Drive ``FavorIndex.query`` under ``opts``: one counted batch (launch
    counters reset just before it, read just after it), timed repeats, and
    one untimed batch under an operator counter.  Returns the pass's line
    and the counted batch's result."""
    import numpy as np
    import torch

    from repro_torch import kernels as Kn

    b = len(qs)
    fi.query(qs[:64], flts[:64], opts)          # warm-up (not counted)
    torch.cuda.synchronize()
    Kn.reset_launch_counts()
    t0 = time.perf_counter()
    res = fi.query(qs, flts, opts)
    walls = [time.perf_counter() - t0]
    launches = dict(Kn.launch_counts)
    widths = {k: {f"{b}x{m}": c for (b, m), c in sorted(
        v.items(), key=lambda kv: -kv[1])}
        for k, v in Kn.launch_widths.items() if v}
    for _ in range(SERVE_REPEATS - 1):
        t0 = time.perf_counter()
        again = fi.query(qs, flts, opts)
        walls.append(time.perf_counter() - t0)
        check(bool((again.ids == res.ids).all()),
              f"{label}: query is deterministic")
    # host work per graph wave, counted on one untimed batch
    torch_ops = count_torch_ops(lambda: fi.query(qs, flts, opts))

    n = fi.index.n
    check(res.ids.shape == (b, K) and res.dists.shape == (b, K),
          f"{label}: result shapes")
    check(bool(np.isfinite(res.dists[res.ids >= 0]).all()),
          f"{label}: finite distances for every returned id")
    check(bool(((res.ids >= -1) & (res.ids < n)).all()),
          f"{label}: ids in range")
    gt_i, masks = truth
    for i in range(b):
        got = res.ids[i][res.ids[i] >= 0]
        check(bool(masks[names[i]][got].all()),
              f"{label}: query {i} returned a non-target row")
    rec = np.array([refimpl_recall(res.ids[i], gt_i[i]) for i in range(b)])
    brute = res.routed_brute
    check(brute.any() and (~brute).any(), f"{label}: both routes ran")
    names_a = np.asarray(names)
    per = {}
    for nm in dict.fromkeys(names):
        rows = names_a == nm
        br = brute[rows]
        per[nm] = {"queries": int(rows.sum()),
                   "p_true": float(masks[nm].mean()),
                   "p_hat": float(res.p_hat[rows].mean()),
                   "brute": int(br.sum()), "graph": int((~br).sum()),
                   "recall_at_10": float(rec[rows].mean()),
                   "recall_brute": (float(rec[rows & brute].mean())
                                    if br.any() else None),
                   "recall_graph": (float(rec[rows & ~brute].mean())
                                    if (~br).any() else None)}
    walls_ms = sorted(1e3 * w for w in walls)
    waves = int(res.waves[~brute].max())
    line = {
        "phase": "serve", "pass": label,
        "options": {k: (vars(v) if k == "batch" else v)
                    for k, v in vars(opts).items() if v is not None},
        "brute": int(brute.sum()), "graph": int((~brute).sum()),
        "launches": launches, "launch_widths": widths, "batch_ms": walls_ms,
        "p50_ms": float(np.percentile(walls_ms, 50)),
        "p99_ms": float(np.percentile(walls_ms, 99)),
        "qps": b / statistics.median(walls),
        "recall_at_10": {"brute": float(rec[brute].mean()),
                         "graph": float(rec[~brute].mean())},
        "per_scenario": per, "waves": waves,
        "torch_ops_per_wave": torch_ops / waves,
        "mean_hops": float(res.hops[~brute].mean()),
    }
    return line, res, rec


def cpu_check(fi, opts, qs, flts, res, label: str) -> dict:
    """The port's CPU path on a query subset, on the same graph, codebook
    and codes: identical p_hat and routes; brute rows at the kernel bar
    (under ``use_pq``: rows with a near-tie at the ADC candidate boundary R
    excluded and counted); graph rows >= 90 % identical."""
    import numpy as np
    import torch

    from repro_torch.core import FavorIndex
    from repro_torch.kernels.pq_adc import ops as pq
    from repro_torch.parity import topk_mismatch
    from repro_torch.quant.adc import build_luts

    brute = res.routed_brute
    cpu = FavorIndex(fi.index, fi.attrs, fi.spec, codebook=fi.codebook,
                     codes=(None if fi._codes is None else
                            fi._codes[:fi.index.n].cpu().numpy()),
                     device="cpu")
    sub = np.r_[np.nonzero(brute)[0][:16], np.nonzero(~brute)[0][:48]]
    sflts = [flts[i] for i in sub]
    rc = cpu.query(qs[sub], sflts, opts)
    check(bool((rc.p_hat == res.p_hat[sub]).all()), f"{label}: p_hat card == cpu")
    check(bool((rc.routed_brute == brute[sub]).all()),
          f"{label}: routes card == cpu")
    bs = rc.routed_brute
    keep = np.ones(int(bs.sum()), bool)
    if opts.use_pq:
        r = max(K, cpu.rerank * K)
        _, pn, pi, pf = cpu._pf
        luts = build_luts(cpu._cb_dev[0], torch.as_tensor(qs[sub][bs]))
        _, adc = pq.pq_adc_topr(cpu._codes, pn, pi, pf, luts,
                                cpu.compile_filters([sflts[i] for i in
                                                     np.nonzero(bs)[0]]),
                                r=r + 1)
        adc = adc.numpy().astype(np.float64)
        with np.errstate(invalid="ignore"):
            near = ~(adc[:, r] - adc[:, r - 1] > RTOL * adc[:, r - 1])
        keep = ~(near & np.isfinite(adc[:, r]))
    m = topk_mismatch(rc.ids[bs][keep], rc.dists[bs][keep],
                      res.ids[sub][bs][keep], res.dists[sub][bs][keep],
                      RTOL, ATOL)
    check(m["dist_mismatch"] == 0 and m["id_mismatch"] == 0,
          f"{label}: brute route card vs cpu: {m}")
    same_graph = float((rc.ids[~bs] == res.ids[sub][~bs]).all(axis=1).mean())
    check(same_graph >= 0.9,
          f"{label}: graph rows identical card vs cpu: {same_graph}")
    return {"queries": int(len(sub)), "graph_identical_rows": same_graph,
            "brute_rows_near_tie_excluded": int((~keep).sum()),
            "brute_identical_rows": m["identical_rows"],
            "brute_max_abs_diff": m["max_abs_diff"]}


def phase_serve(dev):
    import numpy as np
    import torch

    from repro_torch.core import (BuildSpec, FavorIndex, HnswParams,
                                  QuantSpec, SearchOptions)
    from repro_torch.core import filters as F
    from repro_torch.data import synthetic
    from repro_torch.kernels.filtered_topk import ops as ft

    n, d, b = SERVE_N, 128, BATCH
    vecs, attrs, schema = synthetic.make_paper_dataset(n, d, seed=SEED)
    spec = BuildSpec(hnsw=HnswParams(M=16, efc=100, seed=SEED),
                     quant=QuantSpec(kind="pq", m=PQ_M, nbits=PQ_BITS,
                                     rerank=RERANK))
    t0 = time.perf_counter()
    fi = FavorIndex.build(vecs, attrs, spec=spec)
    total_build_s = time.perf_counter() - t0
    check(fi.device.type == "cuda", "FavorIndex.build defaults to the card")
    check(fi._codes.device.type == "cuda" and fi.quantize == "pq",
          "codes on the card")
    qs = synthetic.make_queries(b, d, dataset_seed=SEED, seed=100)
    flts, names = mixed_filters(F, schema, b)

    # -- exact filtered ground truth: the plain brute version on the card ---
    progs = fi.compile_filters(flts)
    pv, pn, pi, pf = fi._pf
    gt_i, _ = ft.filtered_topk_plain(pv, pn, pi, pf,
                                     torch.as_tensor(qs, device=dev), progs,
                                     k=K)
    masks = {nm: F.eval_program(F.compile_filter(f, schema), attrs.ints,
                                attrs.floats).numpy()
             for nm, f in zip(names, flts)}
    truth = (gt_i.cpu().numpy(), masks)

    passes = {
        "f32": SearchOptions(k=K, ef=EF),
        "use_pq": SearchOptions(k=K, ef=EF, use_pq=True),
        "use_pq+graph_pq": SearchOptions(k=K, ef=EF, use_pq=True,
                                         graph_quant="pq"),
    }
    need = {"f32": ("filtered_topk", "gather_distance"),
            "use_pq": ("pq_adc_topr", "gather_distance"),
            "use_pq+graph_pq": ("pq_adc_topr", "pq_adc_gather")}
    lines, recs, results = {}, {}, {}
    for label, opts in passes.items():
        line, res, rec = serve_pass(fi, opts, qs, flts, names, truth, label)
        results[label] = res
        for kname in need[label]:
            check(line["launches"][kname] > 0,
                  f"{label}: {kname} launched on the main path: "
                  f"{line['launches']}")
        line["cpu_check"] = cpu_check(fi, opts, qs, flts, res, label)
        lines[label], recs[label] = line, (rec, res.routed_brute)
        if label != "use_pq+graph_pq":
            emit(line)

    # recall bars: f32 brute is exact; the compressed brute route within two
    # points of it; the graph route under use_pq is the f32 one
    rec32, br32 = recs["f32"]
    check(bool((rec32[br32] == 1.0).all()),
          f"f32 brute-route recall is 1.0 (got {rec32[br32].mean()})")
    for label in ("use_pq", "use_pq+graph_pq"):
        rec, br = recs[label]
        check(rec[br].mean() >= 1.0 - RECALL_SLACK,
              f"{label}: compressed brute recall {rec[br].mean()}")
    rec, br = recs["use_pq"]
    check(rec[~br].mean() >= rec32[~br32].mean() - RECALL_SLACK,
          f"use_pq: graph recall {rec[~br].mean()} vs f32 "
          f"{rec32[~br32].mean()}")
    # the PQ graph route against the exhaustive compressed scan that re-ranks
    # as deep (graph_rerank * k candidates), on the graph-routed queries
    rec, br = recs["use_pq+graph_pq"]
    gi = np.nonzero(~br)[0]
    depth = passes["use_pq+graph_pq"].search_config().graph_rerank
    ex = fi.query(qs[gi], [flts[i] for i in gi],
                  SearchOptions(k=K, ef=EF, use_pq=True, rerank=depth,
                                force="brute"))
    rec_ex = np.array([refimpl_recall(ex.ids[j], truth[0][i])
                       for j, i in enumerate(gi)])
    line = lines["use_pq+graph_pq"]
    line["pq_exhaustive_recall"] = {
        "rerank": depth, "all": float(rec_ex.mean()),
        "per_scenario": {nm: float(rec_ex[np.asarray(names)[gi] == nm].mean())
                         for nm in dict.fromkeys(np.asarray(names)[gi])}}
    emit(line)
    check(rec[~br].mean() >= rec_ex.mean() - RECALL_SLACK,
          f"use_pq+graph_pq: graph recall {rec[~br].mean()} vs the "
          f"exhaustive compressed scan's {rec_ex.mean()}")

    # -- SQ on both compressed routes, untimed ------------------------------
    sq = FavorIndex(fi.index, fi.attrs, BuildSpec(
        hnsw=spec.hnsw, quant=QuantSpec(kind="sq", rerank=RERANK)))
    sq_line = {"phase": "serve", "pass": "sq"}
    for label, opts in (("sq_use_pq", SearchOptions(k=K, ef=EF, use_pq=True)),
                        ("sq_graph", SearchOptions(k=K, ef=EF,
                                                   graph_quant="sq"))):
        res = sq.query(qs, flts, opts)
        rec = np.array([refimpl_recall(res.ids[i], truth[0][i])
                        for i in range(b)])
        br = res.routed_brute
        sq_line[label] = {"recall_brute": float(rec[br].mean()),
                          "recall_graph": float(rec[~br].mean())}
        check(rec[br].mean() >= 1.0 - RECALL_SLACK,
              f"{label}: brute recall {rec[br].mean()}")
        check(rec[~br].mean() >= rec32[~br32].mean() - RECALL_SLACK,
              f"{label}: graph recall {rec[~br].mean()}")
    emit(sq_line)
    bucketed_pass(fi, passes, results, lines, qs, flts, names, truth)
    emit({"phase": "serve", "pass": "build", "n": n, "d": d,
          "hnsw": {"M": 16, "M0": 32, "efc": 100},
          "quant": {"kind": "pq", "m": PQ_M, "nbits": PQ_BITS,
                    "rerank": RERANK},
          "build_s": fi.build_seconds,
          "quantize_s": total_build_s - fi.build_seconds,
          "batch": b, "k": K, "ef": EF})
    launches = {"f32": lines["f32"]["launches"],
                "use_pq": lines["use_pq"]["launches"],
                "use_pq+graph_pq": lines["use_pq+graph_pq"]["launches"]}
    # the graph route's gather launches by (B, M), on the pass of the main
    # path that runs each
    widths = {"gather_distance":
              lines["f32"]["launch_widths"].get("gather_distance", {}),
              "pq_adc_gather":
              lines["use_pq+graph_pq"]["launch_widths"].get("pq_adc_gather",
                                                            {})}
    phase_live(dev, fi, qs, flts, float(rec32[~br32].mean()))
    return launches, widths


def same_bits(a, b) -> bool:
    import numpy as np
    return bool(np.array_equal(a.ids, b.ids)
                and np.array_equal(a.dists.view(np.uint32),
                                   b.dists.view(np.uint32)))


def bucketed_pass(fi, passes, results, lines, qs, flts, names, truth):
    """The f32 options plus ``batch=BatchSpec(...)`` over the buckets the
    1024-query batch's estimate and route sub-batches reach, after
    ``warmup`` of those buckets: ids and distances bit for bit those of the
    unbucketed f32 pass, and once for ``use_pq`` + ``graph_quant="pq"``."""
    import numpy as np
    import torch

    from repro_torch.core import BatchSpec, router
    from repro_torch.core.batching import ShapeRegistry, warmup

    spec = BatchSpec(**BUCKETS)
    ref = results["f32"]
    b, nb = len(qs), int(ref.routed_brute.sum())
    ladder = tuple(sorted({spec.bucket_for(b), spec.bucket_for(b - nb),
                           spec.bucket_for(nb)}))
    opts = passes["f32"].with_(batch=spec)
    reg = ShapeRegistry()
    t0 = time.perf_counter()
    warmup(fi.backend, opts, buckets=ladder, registry=reg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_shapes = reg.compiled_shapes
    reg.reset_rows()         # the traffic's pad overhead, not warm-up's
    res = router.execute(fi.backend, qs, flts, opts, registry=reg)
    check(same_bits(res, ref), "bucketed f32 pass: ids and distances bit "
          "for bit the unbucketed pass's")
    check(bool((res.routed_brute == ref.routed_brute).all()
               and (res.hops == ref.hops).all()),
          "bucketed f32 pass: routes and hops as unbucketed")
    stats = reg.stats()
    line, res, _ = serve_pass(fi, opts, qs, flts, names, truth, "f32_bucketed")
    check(same_bits(res, ref), "bucketed f32 pass (timed batch): bit for "
          "bit the unbucketed pass's")
    q_opts = passes["use_pq+graph_pq"]
    rq = fi.query(qs, flts, q_opts.with_(batch=spec))
    check(same_bits(rq, results["use_pq+graph_pq"]),
          "bucketed use_pq+graph_pq batch: bit for bit the unbucketed one's")
    check(stats["compiled_shapes"] == warm_shapes,
          f"bucketed pass reached only warmed shapes: {stats}")
    line.update({
        "ladder": ladder, "warmup_s": warm_s, "registry": stats,
        "pad_overhead": stats["pad_overhead"],
        "same_launches_as_f32": line["launches"] == lines["f32"]["launches"],
        "same_waves_as_f32": line["waves"] == lines["f32"]["waves"],
        "bit_identical": {"f32": True, "use_pq+graph_pq": True}})
    emit(line)


def phase_live(dev, fi, qs, flts, f32_graph_recall: float):
    """Mutations on the serve index, then a query batch before and after
    ``merge()``: no deleted or replaced id returned, brute recall@10 1.0
    against exact filtered ground truth over the live rows (the plain brute
    version on the card), graph recall@10 within RECALL_SLACK of the f32
    pass's; launches of each kernel for each step."""
    import numpy as np
    import torch

    from repro_torch import kernels as Kn
    from repro_torch.core import SearchOptions
    from repro_torch.core import filters as F
    from repro_torch.data import synthetic
    from repro_torch.kernels.filtered_topk import ops as ft

    rng = np.random.default_rng(SEED + 9)
    n0, d, schema = fi.index.n, fi.index.dim, fi.schema
    new_v = synthetic.make_queries(LIVE_UPSERT, d, dataset_seed=SEED, seed=300)
    new_a = F.random_attributes(schema, LIVE_UPSERT, seed=SEED + 11)
    perm = rng.permutation(n0)
    replaced = perm[:LIVE_REPLACE]
    plain_n = LIVE_UPSERT - LIVE_REPLACE
    steps = {}

    Kn.reset_launch_counts()
    t0 = time.perf_counter()
    ids = np.concatenate([
        fi.upsert(new_v[:plain_n], new_a.ints[:plain_n],
                  new_a.floats[:plain_n]),
        fi.upsert(new_v[plain_n:], new_a.ints[plain_n:],
                  new_a.floats[plain_n:], replace=replaced)])
    check(bool((ids == n0 + np.arange(LIVE_UPSERT)).all()),
          "upsert ids are positional (base_n + slot)")
    del_delta = rng.choice(ids, LIVE_DELETE // 4, replace=False)
    del_base = perm[LIVE_REPLACE:LIVE_REPLACE + LIVE_DELETE - len(del_delta)]
    found = fi.delete(np.concatenate([del_base, del_delta]))
    torch.cuda.synchronize()
    check(found == LIVE_DELETE, f"delete found {found} of {LIVE_DELETE}")
    steps["mutate"] = {"s": time.perf_counter() - t0,
                       "launches": dict(Kn.launch_counts),
                       "live_stats": fi.live_stats()}
    dead = np.concatenate([replaced, del_base, del_delta])

    # exact filtered ground truth over the live rows: ids are positional,
    # so row i of the concatenation is id i before and after the merge
    all_v = np.concatenate([fi.index.vectors, new_v])
    all_i = np.concatenate([fi.attrs.ints, new_a.ints])
    all_f = np.concatenate([fi.attrs.floats, new_a.floats])
    norms = np.einsum("nd,nd->n", all_v, all_v).astype(np.float32)
    norms[dead] = np.inf
    db = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
          for a in (all_v, norms, all_i, all_f)]
    gt, _ = ft.filtered_topk_plain(*db, torch.as_tensor(qs, device=dev),
                                   fi.compile_filters(flts), k=K)
    gt = gt.cpu().numpy()
    masks = [F.eval_program(F.compile_filter(f, schema), all_i, all_f).numpy()
             for f in flts]
    opts = SearchOptions(k=K, ef=EF)

    def live_query(label):
        torch.cuda.synchronize()
        Kn.reset_launch_counts()
        t0 = time.perf_counter()
        res = fi.query(qs, flts, opts)
        wall = time.perf_counter() - t0
        launches = dict(Kn.launch_counts)
        check(not np.isin(res.ids, dead).any(),
              f"live {label}: a deleted or replaced id came back")
        check(all(masks[i][res.ids[i][res.ids[i] >= 0]].all()
                  for i in range(len(qs))),
              f"live {label}: a non-target row came back")
        rec = np.array([refimpl_recall(res.ids[i], gt[i])
                        for i in range(len(qs))])
        br = res.routed_brute
        check(bool((rec[br] == 1.0).all()),
              f"live {label}: brute recall@10 {rec[br].mean()} (want 1.0)")
        check(rec[~br].mean() >= f32_graph_recall - RECALL_SLACK,
              f"live {label}: graph recall@10 {rec[~br].mean()} vs the f32 "
              f"pass's {f32_graph_recall}")
        steps[label] = {"batch_ms": 1e3 * wall, "launches": launches,
                        "brute": int(br.sum()), "graph": int((~br).sum()),
                        "recall_at_10": {"brute": float(rec[br].mean()),
                                         "graph": float(rec[~br].mean())},
                        "waves": int(res.waves[~br].max())}

    live_query("query_before_merge")
    torch.cuda.synchronize()
    Kn.reset_launch_counts()
    t0 = time.perf_counter()
    out = fi.merge()
    torch.cuda.synchronize()
    steps["merge"] = {"s": time.perf_counter() - t0,
                      "launches": dict(Kn.launch_counts), **out}
    check(out["merged_slots"] == LIVE_UPSERT
          and fi.index.n == n0 + LIVE_UPSERT
          and fi.live_stats()["delta_rows"] == 0, f"merge: {out}")
    check(bool(np.array_equal(fi.index.vectors[n0:], new_v)
               and np.array_equal(fi.attrs.ints[n0:], new_a.ints)),
          "merged rows sit at their positional ids")
    live_query("query_after_merge")
    # every live upserted row is its own nearest neighbour, under its id
    keep = ids[~np.isin(ids, dead)][:64]
    own = fi.query(all_v[keep], F.TrueFilter(),
                   SearchOptions(k=K, ef=EF, force="brute"))
    check(bool((own.ids[:, 0] == keep).all()),
          "merged rows are found under their ids")
    # the compressed brute route on the re-encoded codes
    pq = fi.query(qs, flts, SearchOptions(k=K, ef=EF, use_pq=True))
    br = pq.routed_brute
    rec = np.array([refimpl_recall(pq.ids[i], gt[i]) for i in range(len(qs))])
    check(not np.isin(pq.ids, dead).any() and
          rec[br].mean() >= 1.0 - RECALL_SLACK,
          f"live use_pq after merge: brute recall {rec[br].mean()}")
    steps["use_pq_after_merge"] = {"recall_brute": float(rec[br].mean())}
    emit({"phase": "live", "upserts": LIVE_UPSERT, "replaced": LIVE_REPLACE,
          "deletes": LIVE_DELETE, "f32_graph_recall": f32_graph_recall,
          **steps})


def phase_widths(rates, kernels, gathers, widths, top: int = 3) -> None:
    """Both gather kernels at every (B, M) width the serve phase launched
    them at, on the kernel phase's rows and the first B queries and M ids
    of its batch: each held to its plain version (1e-5 and TD equal;
    ``pq_adc_gather`` bit for bit) and timed by graph replay with L2
    flushed, and with L2 refilled clean (``pq_adc_gather`` also with warm
    LUTs) beside its bounds at that width.  Adds to each kernel's row the launches x (ms - bound)
    summed over its histogram, and the ``top`` widths that carry most
    launches (with the eager call's time).  ``widths`` lists each kernel's
    widths busiest first."""
    import torch

    from repro_torch.kernels.gather_distance import ops as gd
    from repro_torch.kernels.pq_adc import ops as pq

    g = gathers
    d = g["qs"].shape[1]
    mi, mf = g["pi"].shape[1], g["pf"].shape[1]
    line = {"phase": "widths"}
    for kname, hist in widths.items():
        rows, loss, loss_design, loss_clean = [], 0.0, 0.0, 0.0
        for wkey, count in hist.items():
            b, m = (int(x) for x in wkey.split("x"))
            check(b <= g["qs"].shape[0] and m <= g["ids"].shape[1],
                  f"{kname}: width {wkey} exceeds the kernel phase's batch")
            qs = g["qs"][:b].contiguous()
            progs = {k: v[:b].contiguous() for k, v in g["progs"].items()}
            dvec = g["dvec"][:b].contiguous()
            ids = g["ids"][:b, :m].long()      # the traversal's id type
            if kname == "gather_distance":
                args = (g["pv"], g["pn"], g["pi"], g["pf"], qs, ids, progs,
                        dvec)
                kd, ktd = gd.gather_distance(*args)
                pd, ptd = gd.gather_distance_plain(*args)
                fin = torch.isfinite(pd)
                ok = (torch.equal(fin, torch.isfinite(kd))
                      and bool(((kd[fin] - pd[fin]).abs()
                                <= ATOL + RTOL * pd[fin].abs()).all()))
                bounds = gd_bounds(rates, ids, d, mi, mf, progs)

                def call(args=args):
                    return gd.gather_distance(*args)
                warm = None
            else:
                lb = g["lb"][:b].contiguous()
                kw = dict(ints=g["pi"], floats=g["pf"], programs=progs,
                          dvec=dvec)
                kd, ktd = pq.pq_adc_gather(g["codes"], lb, ids, **kw)
                pd, ptd = pq.pq_adc_gather_plain(g["codes"], lb, ids, **kw)
                ok = torch.equal(kd, pd)
                bounds = pq_gather_bounds(rates, ids, g["codes"], lb, mi, mf,
                                          progs)

                def call(lb=lb, ids=ids, kw=kw):
                    return pq.pq_adc_gather(g["codes"], lb, ids, **kw)

                def warm(lb=lb):
                    g["clean"]()
                    lb.sum()
            check(ok and bool(torch.equal(ktd, ptd)),
                  f"{kname} at {wkey} vs plain")
            row = {"width": wkey, "launches": count,
                   "ms": graph_ms(call, repeats=REPEATS, flush=g["flush"]),
                   "ms_clean": graph_ms(call, repeats=REPEATS,
                                        flush=g["clean"]),
                   **{k: v for k, v in bounds.items() if k.startswith(
                       "bound_ms")}}
            if warm is not None:
                row["ms_warm_luts"] = graph_ms(call, repeats=REPEATS,
                                               flush=warm)
            if len(rows) < top:        # the busiest widths: eager call too
                row["call_ms"] = cuda_ms(call, repeats=REPEATS,
                                         flush=g["flush"])
            loss += count * (row["ms"] - row["bound_ms"])
            loss_design += count * (row["ms"] - row["bound_ms_design"])
            loss_clean += count * (row["ms_clean"] - row["bound_ms"])
            rows.append(row)
        kernels[kname]["loss_ms_over_widths"] = loss
        kernels[kname]["loss_ms_over_widths_design"] = loss_design
        kernels[kname]["loss_ms_over_widths_clean"] = loss_clean
        kernels[kname]["top_widths"] = rows[:top]
        line[kname] = {"widths": rows, "loss_ms": loss,
                       "loss_ms_design": loss_design,
                       "loss_ms_clean": loss_clean,
                       "launches": sum(hist.values())}
    emit(line)


def refimpl_recall(found, truth_row) -> float:
    from repro_torch.core import refimpl
    return refimpl.recall_at_k(found, truth_row[truth_row >= 0], K)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import kernels as Kn
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    rates = RATES["PCIe"] if "PCIe" in name else RATES["SXM"]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = Kn.build_kernels()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in logs.items()}})

    kernels, gathers = phase_kernels(dev, rates)
    kernels["filtered_topk"]["ptxas"] = [
        ln.strip() for ln in logs.get("filtered_topk.cu", "").splitlines()
        if "registers" in ln or "spill" in ln]
    kernels["pq_adc_topr"]["ptxas"] = [
        ln.strip() for ln in logs.get("pq_adc.cu", "").splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    kernels["embedding_bag"] = phase_embedding_bag(dev, rates)
    launches, widths = phase_serve(dev)
    phase_widths(rates, kernels, gathers, widths)
    del gathers
    # each kernel's launches on the pass of the main path that runs it
    main_pass = {"filtered_topk": "f32", "gather_distance": "f32",
                 "pq_adc_topr": "use_pq", "pq_adc_gather": "use_pq+graph_pq"}
    for kname, pass_ in main_pass.items():
        kernels[kname]["launches"] = launches[pass_][kname]
    emit({"kernels": [{k: v for k, v in row.items() if k != "shape"}
                      for row in kernels.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
