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
           again; the launches of each kernel for each step; then an
           in-place edit of an attribute column and a scoped
           ``bump_version(("attributes",))``: the vectors' and neighbour
           lists' device tensors kept (``data_ptr``), both routes serving
           the edit, its time beside a full bump's;
  widths   the graph route's two gather kernels at every (B, M) width the
           serve phase launched them at (each pass counts its launches by
           width), on the kernel phase's rows: held to their plain versions
           and timed beside their bounds, and launches x (ms - bound)
           summed over each histogram;
  engine   the serving engine (``repro_torch.serving.ServeEngine``) over
           fresh copies of the serve index, saved before the live phase
           and loaded from disk, with favor-anns' options
           (``FavorServeConfig().search_options()``) and batch: 4 x 1024
           requests held bit for bit to ``FavorIndex.query`` under
           ``use_pq`` and ``use_pq`` + ``graph_quant="pq"`` (latency
           percentiles, QPS, host time per step beyond the query's, launch
           counts); obs fully on against off, bit for bit; one step under
           ``torch.profiler`` (the device's busy share, top device ops,
           ``favor/...`` ranges, longest idle gaps; the trace is kept,
           gzipped, in the directory ``FAVOR_TRACE_DIR`` names, when it is
           set); two pipelined steps finished in
           reverse order, one on another thread, against serial steps; and
           the live phase's mutation script through a background-merging
           engine until its one commit (no deleted or replaced id served,
           the result equal to a foreground merge's; merge and commit-stall
           seconds, step times during the merge and without one, the merge
           worker's launches);
  frontend the asyncio multi-tenant ``FrontEnd`` over a
           ``CachingBackend(CacheSpec())``-wrapped engine on a fresh copy of
           the serve index, favor-anns' batch, three tenants (weights 1 / 2
           / 4, one rate-limited): a burst of 3 x 1024 requests sent cold,
           then again (warm), under ``use_pq``, ``use_pq`` +
           ``graph_quant="pq"`` and f32, each served response held to
           ``FavorIndex.query`` bit for bit (candidate-block hits at 1e-5),
           warm to cold, sheds never reaching the engine; two executor
           slots against one; tenant isolation in ``by_scope``; the
           front-end's own overhead on single requests; and the live
           script through the warm f32 cache, held to an uncached engine.
           Per pass: each layer's hit rate, request p50 / p99, QPS, the
           pad fraction and each kernel's launches;
  sharded  ``ShardedBackend`` on a (1, SHARDS) mesh of the card (one
           process drives every cell; the shards share the card) over
           the serve index's rows, attributes and codebook, one host HNSW
           per shard: a 1024-query batch under each of the serve phase's
           three option sets, timed beside the serve index's
           LocalBackend, with recall@10 by route and each kernel's
           launches (one brute-scan launch per shard); the same backend on
           a CPU mesh (p_hat, routes, rows), the LocalBackend's f32 brute
           rows, a (2, SHARDS) mesh's bits, ``ServeEngine`` and
           ``CachingBackend`` over it against ``router.execute``; and the
           live script with a full merge (every shard rebuilt, headroom in
           the last) and an incremental one (only the last shard grows);
  models   the model zoo at its published widths, random weights from the
           seed: dlrm-rm2's retrieval_cand cell (1,000,000 items x 64, paper
           attributes, W = 8 programs, k = 100) through
           ``retrieval_topk_filtered``'s fused path (``filtered_topk``,
           chained passes) against its dot-scoring path at batch 1 and 512
           (ids equal outside near-ties, scores within 1e-4, launches
           counted); fm, wide-deep, dien and dlrm-rm2 forward in f32 at 512
           and 262,144 rows (finite, the first 64 rows against the CPU at
           1e-5); greedy bf16 generation (prefill, then decode steps each
           held to a prefill over the tokens so far) for gemma2-2b (26
           layers, 2 x 4,608-token prompts, past its 4,096 window) and
           olmoe-1b-7b (16 layers, 4 x 512) at full depth and qwen1.5-32b,
           command-r-plus-104b and arctic-480b at full width and cut depth
           (8, 4 and 1 layers); an f32 gemma2-2b of 2 layers against the
           CPU at 1e-4; gcn-cora at Cora's size and the molecule cell against
           the CPU at 1e-5;
  train    the port's training (``repro_torch.training``; no kernel is on
           this path): gemma2-2b at its published width and depth (26
           layers, d = 2304, vocabulary 256,000) in bf16 with f32 AdamW
           moments and remat, one 4,096-token sequence a step (train_4k's
           sequence; its batch of 256 belongs to a pod), TRAIN_STEPS steps
           on a fixed ``TokenPipeline`` batch: step ms, tokens/s, model
           TFLOP/s and its share of ``roofline.hw.PEAK_FLOPS_BF16``, peak
           GB, beside the meta dry run's count of the same step (losses
           and grad norms finite, the last loss below the first: hard);
           dlrm-rm2's train_batch (65,536 rows) and gcn-cora's
           full_graph_sm at full size (ms a step, rows/s, finite losses);
           the reduced gemma2-2b and dlrm-rm2 in f32 (TF32 off) against the
           port's CPU run, gradients and 3 SGDM steps within the CPU parity
           bars; and a checkpoint saved from CUDA tensors, restored onto the
           card, bit-equal to an uninterrupted run one step on;
  dryrun   favor-anns' ``serve_graph`` dry-run cell and its three perf
           variants (``launch.perf_run``'s favor experiments), each counted
           on one mesh cell's block of real tensors on the card at the
           published widths (4M rows x 64 queries; 1M rows for
           favor_n16m), from the seed: each record ok with waves > 0 and
           the count's ``gather_distance`` calls equal to the kernel's
           launches; the counted step's ids and distances equal to an
           uncounted run's; a small block (the CPU tests' size) counted
           the same on the card as on the CPU.  Times, waves, the roofline
           terms, each part's bytes and the peak memory are printed.

Then a ``kernels`` line (each kernel's ``frontend_launches`` over the
frontend phase's cold and warm pass, its ``sharded_launches`` per sharded
batch and ``filtered_topk``'s ``models_launches`` per retrieval batch
beside its other launch counts), the
card's name and power limit as nvidia-smi reports them, and as the last
line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

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
ENGINE_STEPS = 4       # engine phase: requests = ENGINE_STEPS x BATCH
ENGINE_TIMED = 3       # interleaved (query, engine step) timing pairs
PIPE_ROUNDS = 6        # serial / pipelined step pairs
MERGE_BASELINE_STEPS = 6   # steps with the delta unmerged, no merge running
MERGE_FRAC = 0.1       # merge_delta_frac: the live script's upserts are 12.5 %
MERGE_TIMEOUT_S = 300.0    # the background merge must commit within this
BUCKETS = dict(min_bucket=8, max_bucket=1024)
# frontend phase: three tenants (weights), one of them rate-limited
FE_TENANTS = {"bronze": 1.0, "silver": 2.0, "gold": 4.0}
FE_LIMITED, FE_RATE_QPS, FE_BURST = "bronze", 64.0, 256
FE_PER_TENANT = 1024   # the burst: 3 x 1024 requests
FE_COALESCE_MS = 2.0   # the engine's max_wait_ms
FE_PROBES = 16         # single requests timed for the front-end's overhead
SHARDS = 4             # sharded phase: model-axis extent of the card mesh
# models phase: dlrm-rm2's retrieval_cand cell (1M candidates x its
# embed_dim, k = 100, one W = 8 program a user) at batch 1 and serve_p99's
# 512; the recsys cells serve_p99 and serve_bulk; greedy LM serving:
# arch -> (layers, None = all; batch; prompt tokens; decode steps)
RETR_N, RETR_D, RETR_K, RETR_W = 1_000_000, 64, 100, 8
RETR_BATCHES = (1, 512)
RETR_NEAR_TIE = 1e-4   # the JAX package's own score bar
RS_BATCHES = (512, 262_144)
RS_CHECK_ROWS = 64
RS_TOL = GCN_TOL = 1e-5
LM_SERVE = {"gemma2-2b": (None, 2, 4608, 16),      # past its 4096 window
            "olmoe-1b-7b": (None, 4, 512, 16),
            "qwen1.5-32b": (8, 2, 256, 4),          # of 64 layers
            "command-r-plus-104b": (4, 2, 256, 4),  # of 64 layers
            "arctic-480b": (1, 2, 256, 4)}          # of 35 (27 GB of experts)
# bf16 decode against prefill on a model's first layer, relative RMS error
# of the logits: a wrong position, mask or cache slot gives unrelated
# logits (~1.4); bf16 rounding of the reference init's large q.k flips
# near-tied attention weights, so a correct decode sits above 0 too (and
# across layers the flips compound: see ``lm_serve``)
LM_DECODE_REL_RMS = 0.25
LM_F32, LM_F32_LAYERS, LM_F32_PROMPT, LM_F32_TOL = "gemma2-2b", 2, 64, 1e-4
MODELS_BUDGET_S = 180.0
# train phase: gemma2-2b at its published width and depth (bf16 params, f32
# AdamW moments, remat) on one train_4k sequence a step (its global batch of
# 256 sequences belongs to a 256-chip pod), TRAIN_STEPS steps on one fixed
# batch; dlrm-rm2's train_batch and gcn-cora's full_graph_sm at full size;
# the reduced gemma2-2b and dlrm-rm2 in f32 against the CPU; a checkpoint
# round trip on the card
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = "gemma2-2b", 4096, 1, 5
TRAIN_LR = 1e-3        # bf16 weights of ~0.02 move by ~lr a step, not < ulp
RS_TRAIN_ARCH, RS_TRAIN_STEPS, GCN_TRAIN_STEPS = "dlrm-rm2", 4, 10
TRAIN_CPU_STEPS, TRAIN_CPU_LR = 3, 1e-2
TRAIN_LM_TOL, TRAIN_RS_TOL = 1e-4, 1e-5   # the CPU parity bars
TRAIN_BUDGET_S = 150.0
DRYRUN_BUDGET_S = 60.0


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


def cpu_check(query, adc, res, qs, flts, opts, label: str) -> dict:
    """A CPU copy of the card's backend on a query subset (16 brute-routed,
    48 graph-routed), on the same graph(s), codebook and codes: identical
    p_hat and routes; brute rows at the kernel bar (under ``use_pq``: rows
    with a near-tie at the ADC candidate boundary R in any scan excluded and
    counted); graph rows >= 90 % identical.

    ``query(qs, flts, opts)`` answers on the CPU copy; ``adc`` is (rerank,
    compile(filters) -> CPU programs, [(codes, norms, ints, floats,
    centroids)] with one entry for each ``pq_adc_topr`` scan a brute query
    runs: one for the local index, one per shard)."""
    import numpy as np
    import torch

    from repro_torch.kernels.pq_adc import ops as pq
    from repro_torch.parity import topk_mismatch
    from repro_torch.quant.adc import build_luts

    t0 = time.perf_counter()
    brute = res.routed_brute
    sub = np.r_[np.nonzero(brute)[0][:16], np.nonzero(~brute)[0][:48]]
    sflts = [flts[i] for i in sub]
    rc = query(qs[sub], sflts, opts)
    check(bool((rc.p_hat.view(np.uint32)
                == res.p_hat[sub].view(np.uint32)).all()),
          f"{label}: p_hat card == cpu")
    check(bool((rc.routed_brute == brute[sub]).all()),
          f"{label}: routes card == cpu")
    bs = rc.routed_brute
    keep = np.ones(int(bs.sum()), bool)
    if opts.use_pq and bs.any():
        rerank, compile_programs, scans = adc
        r = max(K, (opts.rerank or rerank) * K)
        bq = torch.as_tensor(qs[sub][bs])
        progs = compile_programs([sflts[i] for i in np.nonzero(bs)[0]])
        for codes, norms, ints, floats, centroids in scans:
            _, d = pq.pq_adc_topr(codes, norms, ints, floats,
                                  build_luts(centroids, bq), progs, r=r + 1)
            d = d.numpy().astype(np.float64)
            with np.errstate(invalid="ignore"):
                near = ~(d[:, r] - d[:, r - 1] > RTOL * d[:, r - 1])
            keep &= ~(near & np.isfinite(d[:, r]))
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
            "brute_max_abs_diff": m["max_abs_diff"],
            "seconds": time.perf_counter() - t0}


def local_cpu_copy(fi):
    """``cpu_check``'s (query, adc) for a FavorIndex: the same graph,
    codebook and codes on the CPU."""
    from repro_torch.core import FavorIndex

    cpu = FavorIndex(fi.index, fi.attrs, fi.spec, codebook=fi.codebook,
                     codes=(None if fi._codes is None else
                            fi._codes[:fi.index.n].cpu().numpy()),
                     device="cpu")
    if cpu._codes is None:
        return cpu.query, None
    _, pn, pi, pf = cpu._pf
    return cpu.query, (cpu.rerank, cpu.compile_filters,
                       [(cpu._codes, pn, pi, pf, cpu._cb_dev[0])])


def phase_serve(dev, saved: Path):
    """The serve phase (module docstring); saves the index with
    ``FavorIndex.save`` under the path prefix ``saved`` before the live
    phase mutates it."""
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
    cpu_copy = local_cpu_copy(fi)
    lines, recs, results = {}, {}, {}
    for label, opts in passes.items():
        line, res, rec = serve_pass(fi, opts, qs, flts, names, truth, label)
        results[label] = res
        for kname in need[label]:
            check(line["launches"][kname] > 0,
                  f"{label}: {kname} launched on the main path: "
                  f"{line['launches']}")
        line["cpu_check"] = cpu_check(*cpu_copy, res, qs, flts, opts, label)
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
    # the engine phase serves fresh copies of this index, loaded from disk
    fi.save(str(saved))
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


def live_script(n0: int, d: int, schema) -> dict:
    """The live phase's mutation script over an index of ``n0`` base rows:
    LIVE_UPSERT new rows (the last LIVE_REPLACE of them replacing base
    ids), then LIVE_DELETE deletes (a quarter of them upserted rows).
    ``dead`` lists every id that must never come back."""
    import numpy as np

    from repro_torch.core import filters as F
    from repro_torch.data import synthetic

    rng = np.random.default_rng(SEED + 9)
    new_v = synthetic.make_queries(LIVE_UPSERT, d, dataset_seed=SEED, seed=300)
    new_a = F.random_attributes(schema, LIVE_UPSERT, seed=SEED + 11)
    perm = rng.permutation(n0)
    replaced = perm[:LIVE_REPLACE]
    ids = n0 + np.arange(LIVE_UPSERT)        # positional: base_n + slot
    del_delta = rng.choice(ids, LIVE_DELETE // 4, replace=False)
    del_base = perm[LIVE_REPLACE:LIVE_REPLACE + LIVE_DELETE - len(del_delta)]
    return {"vectors": new_v, "attrs": new_a, "replaced": replaced,
            "ids": ids, "deletes": np.concatenate([del_base, del_delta]),
            "dead": np.concatenate([replaced, del_base, del_delta])}


def apply_live_script(target, script):
    """Run ``script`` through ``target``'s ``upsert`` / ``delete`` (a
    FavorIndex or a ServeEngine); returns the upserted ids."""
    import numpy as np

    new_v, new_a = script["vectors"], script["attrs"]
    plain_n = LIVE_UPSERT - LIVE_REPLACE
    ids = np.concatenate([
        target.upsert(new_v[:plain_n], new_a.ints[:plain_n],
                      new_a.floats[:plain_n]),
        target.upsert(new_v[plain_n:], new_a.ints[plain_n:],
                      new_a.floats[plain_n:], replace=script["replaced"])])
    check(bool((ids == script["ids"]).all()),
          "upsert ids are positional (base_n + slot)")
    found = target.delete(script["deletes"])
    check(found == LIVE_DELETE, f"delete found {found} of {LIVE_DELETE}")
    return ids


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
    from repro_torch.kernels.filtered_topk import ops as ft

    n0, d, schema = fi.index.n, fi.index.dim, fi.schema
    script = live_script(n0, d, schema)
    new_v, new_a = script["vectors"], script["attrs"]
    steps = {}

    Kn.reset_launch_counts()
    t0 = time.perf_counter()
    ids = apply_live_script(fi, script)
    torch.cuda.synchronize()
    steps["mutate"] = {"s": time.perf_counter() - t0,
                       "launches": dict(Kn.launch_counts),
                       "live_stats": fi.live_stats()}
    dead = script["dead"]

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
    steps["scoped_bump"] = live_scoped_bump(fi, qs, flts)
    emit({"phase": "live", "upserts": LIVE_UPSERT, "replaced": LIVE_REPLACE,
          "deletes": LIVE_DELETE, "f32_graph_recall": f32_graph_recall,
          **steps})


def live_scoped_bump(fi, qs, flts) -> dict:
    """On the live phase's merged index: an in-place edit of the int
    column, then ``bump_version(("attributes",))`` re-uploads only the
    attribute arrays -- the vectors' and the neighbour lists' device
    tensors stay (``data_ptr``) -- and both routes serve the edit (every
    id returned passes its filter under the edited attributes); timed
    beside a full bump, which re-uploads everything."""
    import torch

    from repro_torch.core import SearchOptions
    from repro_torch.core import filters as F

    schema = fi.schema
    col = schema.int_index("i0")
    vocab = schema.int_columns[col].vocab
    keys = ("vectors", "neighbors0", "attrs_int")
    ptr = {k: fi.g[k].data_ptr() for k in keys}
    fi.attrs.ints[:, col] = (fi.attrs.ints[:, col] + 1) % vocab
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fi.bump_version(("attributes",))
    torch.cuda.synchronize()
    scoped_s = time.perf_counter() - t0
    kept = {k: fi.g[k].data_ptr() == ptr[k] for k in keys}
    check(kept == {"vectors": True, "neighbors0": True, "attrs_int": False},
          f"scoped bump: only the attribute arrays re-uploaded {kept}")
    masks = [F.eval_program(F.compile_filter(f, schema), fi.attrs.ints,
                            fi.attrs.floats).numpy() for f in flts]
    served = {}
    for force in ("brute", "graph"):
        res = fi.query(qs, flts, SearchOptions(k=K, ef=EF, force=force))
        check(all(masks[i][res.ids[i][res.ids[i] >= 0]].all()
                  for i in range(len(qs))),
              f"scoped bump: the {force} route serves the edited attributes")
        served[force] = int((res.ids >= 0).sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fi.bump_version()
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    check(fi.g["vectors"].data_ptr() != ptr["vectors"],
          "a full bump re-uploads the vectors")
    return {"scoped_attributes_ms": 1e3 * scoped_s,
            "full_ms": 1e3 * full_s, "kept_data_ptr": kept,
            "rows": fi.index.n, "ids_served": served,
            "card": nvidia_smi_line()}


def merged_intervals(spans) -> list:
    """Union of (start, end) intervals, sorted and merged."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(merged, a: float, b: float) -> float:
    """Length of ``merged`` intervals inside [a, b]."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in merged)


def trace_summary(events, window: str, top: int = 5) -> dict:
    """Read a ``torch.profiler`` chrome trace's events over the host range
    named ``window``: the device's busy share (union of kernel, memcpy and
    memset intervals over the window's wall time), the ``top`` device ops
    by total time, each ``favor/...`` host range's total time (and the
    device time inside it), and the ``top`` longest device-idle gaps with
    the innermost ``favor/...`` range and host op they fell in."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == window
           and e.get("cat") == "user_annotation"]
    if not win:
        return {"error": f"no {window} range in the trace"}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in ("kernel", "gpu_memcpy",
                                              "gpu_memset")
           and w0 <= float(e["ts"]) <= w1]
    merged = merged_intervals(
        (float(e["ts"]), min(w1, float(e["ts"]) + float(e["dur"])))
        for e in dev)
    favor = [e for e in xs if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("favor/")
             and e.get("name") != window and w0 <= float(e["ts"]) <= w1]
    ranges = {}
    for e in favor:
        a = float(e["ts"])
        b = a + float(e["dur"])
        row = ranges.setdefault(e["name"], {"ms": 0.0, "count": 0,
                                            "device_busy_ms": 0.0})
        row["ms"] += (b - a) / 1e3
        row["count"] += 1
        row["device_busy_ms"] += overlap_us(merged, a, b) / 1e3
    out = {"window_ms": (w1 - w0) / 1e3, "device_ops": len(dev),
           "favor_ranges": ranges}
    if not dev:
        out["busy_share"] = None
        out["note"] = "no device events in the trace: busy share not measured"
        return out
    busy = overlap_us(merged, w0, w1)
    out["busy_ms"] = busy / 1e3
    out["busy_share"] = busy / (w1 - w0)
    by_name = {}
    for e in dev:
        row = by_name.setdefault(e["name"], [0.0, 0])
        row[0] += float(e["dur"])
        row[1] += 1
    out["top_device_ops"] = [
        {"name": n[:120], "ms": t / 1e3, "count": c}
        for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])
        [:top]]
    cpu = [e for e in xs if e.get("cat") == "cpu_op"
           and w0 <= float(e["ts"]) <= w1]
    gaps = [(merged[0][0] - w0, w0, merged[0][0])]
    gaps += [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])]
    gaps.append((w1 - merged[-1][1], merged[-1][1], w1))
    gaps.sort(reverse=True)

    def innermost(pool, t):
        hit = [e for e in pool
               if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
        return max(hit, key=lambda e: float(e["ts"]))["name"] if hit else None

    out["idle_ms"] = (w1 - w0 - busy) / 1e3
    out["longest_idle_gaps"] = [
        {"ms": g / 1e3, "at_ms": (a - w0) / 1e3,
         "favor_range": innermost(favor, (a + b) / 2),
         "host_op": innermost(cpu, (a + b) / 2)}
        for g, a, b in gaps[:top]]
    return out


def load_serve(saved: Path):
    """A fresh copy of the serve index from its saved files, on the card."""
    from repro_torch.core import FavorIndex
    fi = FavorIndex.load(str(saved))
    check(fi.device.type == "cuda" and fi.quantize == "pq",
          "the saved serve index loads onto the card with its PQ codes")
    return fi


def responses_match_query(out, fi, qs, flts, opts, label: str) -> None:
    """Each response's ids, distance bits, route and p_hat equal
    ``FavorIndex.query`` on the same BATCH-row batches."""
    import numpy as np
    check(len(out) == len(qs), f"{label}: {len(out)} responses for "
          f"{len(qs)} requests")
    for lo in range(0, len(qs), BATCH):
        res = fi.query(qs[lo:lo + BATCH], flts[lo:lo + BATCH], opts)
        part = out[lo:lo + BATCH]
        ids = np.stack([r.ids for r in part])
        dists = np.stack([r.dists for r in part])
        brute = np.array([r.route == "brute" for r in part])
        p_hat = np.array([r.p_hat for r in part], np.float32)
        check(np.array_equal(ids, res.ids)
              and np.array_equal(dists.view(np.uint32),
                                 res.dists.view(np.uint32)),
              f"{label}: engine ids and distance bits == query's "
              f"(requests {lo}..{lo + len(part) - 1})")
        check(np.array_equal(brute, res.routed_brute)
              and np.array_equal(p_hat.view(np.uint32),
                                 res.p_hat.view(np.uint32)),
              f"{label}: engine routes and p_hat == query's")


def same_responses(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(x.ids, y.ids)
               and np.array_equal(x.dists.view(np.uint32),
                                  y.dists.view(np.uint32))
               and x.route == y.route for x, y in zip(a, b, strict=True))


def submit_all(eng, qs, flts) -> None:
    for i in range(len(qs)):
        eng.submit(qs[i], flts[i])


def engine_pass(fi, opts, qs, flts, label: str, obs=None) -> tuple:
    """ENGINE_STEPS x BATCH requests through a ServeEngine at favor-anns'
    batch, served with ``run()`` after one untimed warm-up step: the
    responses held to ``FavorIndex.query``; request-latency percentiles,
    steps, QPS and the launches of each kernel over the run; then
    ENGINE_TIMED interleaved (query, step) pairs on the same batches for
    the engine's host time per step beyond the query's own."""
    import numpy as np
    import torch

    from repro_torch import kernels as Kn
    from repro_torch.configs.favor_anns import FavorServeConfig
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(fi, opts, max_batch=FavorServeConfig.batch,
                      max_wait_ms=2.0, obs=obs)
    submit_all(eng, qs[:64], flts[:64])         # warm-up (not counted)
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    Kn.reset_launch_counts()
    t0 = time.perf_counter()
    submit_all(eng, qs, flts)
    out = eng.run()
    wall = time.perf_counter() - t0
    launches = dict(Kn.launch_counts)
    st = eng.stats
    latency = eng.latency_percentiles()
    responses_match_query(out, fi, qs, flts, opts, label)
    query_ms, step_ms, submit_ms = [], [], []
    for j in range(ENGINE_TIMED):
        lo = (j % ENGINE_STEPS) * BATCH
        bq, bf = qs[lo:lo + BATCH], flts[lo:lo + BATCH]
        t0 = time.perf_counter()
        fi.query(bq, bf, opts)
        query_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        submit_all(eng, bq, bf)
        t1 = time.perf_counter()
        step = eng.step(force=True)
        step_ms.append(1e3 * (time.perf_counter() - t1))
        submit_ms.append(1e3 * (t1 - t0))
        check(same_responses(step, out[lo:lo + BATCH]),
              f"{label}: a timed step returns the run's responses")
    extra = [s - q for s, q in zip(step_ms, query_ms)]
    line = {"requests": len(qs), "steps": st["batches"],
            "latency_ms": latency, "run_s": wall,
            "qps": len(qs) / wall, "launches": launches,
            "graph": st["graph"], "brute": st["brute"],
            "graph_waves_avg": st["graph_waves_avg"],
            "scorers": st["scorers"],
            "query_ms": query_ms, "step_ms": step_ms,
            "submit_ms_per_step": submit_ms,
            "host_ms_per_step_beyond_query": float(np.median(extra)),
            "host_ms_per_step_beyond_query_all": extra}
    return line, out, eng


def phase_engine(dev, saved: Path) -> dict:
    """The serving engine on the card over fresh copies of the serve index
    (loaded from ``saved``), at favor-anns' widths and options
    (``FavorServeConfig().search_options()``, ``max_batch`` its batch):

      1. engine vs query: ENGINE_STEPS x BATCH requests with the mixed
         filters under favor-anns' ``use_pq=True`` and again with
         ``graph_quant="pq"``; every response equals ``FavorIndex.query``
         on the same batches (ids, distance bits, route, p_hat);
      2. obs on vs off: full tracing, probes, shadows and profiler ranges
         give the same bits;
      3. one step under ``torch.profiler``: the device's busy share over
         the step's wall time, its top ops, the ``favor/...`` ranges and
         the longest idle gaps;
      4. pipelined steps: two ``begin_batch`` calls finished in reverse
         order, one from another thread, bit-identical to serial steps;
         the overlap they get;
      5. background merge: the live phase's mutation script through an
         engine with ``merge_background=True``, stepping until the
         controller commits: no deleted or replaced id ever returned, one
         commit, and the result equal to a foreground merge's.
    Returns each kernel's launches on the engine's main path."""
    import gzip
    import threading

    import numpy as np
    import torch

    from repro_torch.configs.favor_anns import FavorServeConfig
    from repro_torch.core import filters as F
    from repro_torch.core.options import ObsSpec
    from repro_torch.data import synthetic
    from repro_torch.obs import profiling
    from repro_torch.serving import ServeEngine

    cfg = FavorServeConfig()
    check((cfg.dim, cfg.m0, cfg.k, cfg.ef, cfg.batch, cfg.pq_m,
           cfg.pq_nbits, cfg.rerank) == (128, M0, K, EF, BATCH, PQ_M,
                                         PQ_BITS, RERANK),
          "the smoke's constants are favor-anns'")
    fi = load_serve(saved)
    n = ENGINE_STEPS * BATCH
    qs = synthetic.make_queries(n, fi.index.dim, dataset_seed=SEED, seed=200)
    flts, _ = mixed_filters(F, fi.schema, n)
    opts_pq = cfg.search_options()
    opts_gpq = cfg.search_options(graph_quant="pq")
    line = {"phase": "engine", "n": fi.index.n, "d": fi.index.dim,
            "max_batch": cfg.batch,
            "options": {k: v for k, v in vars(opts_pq).items()
                        if v is not None}}
    need = {"use_pq": ("pq_adc_topr", "gather_distance"),
            "use_pq+graph_pq": ("pq_adc_topr", "pq_adc_gather")}

    # -- 1. engine vs query --------------------------------------------------
    runs = {}
    for label, opts in (("use_pq", opts_pq), ("use_pq+graph_pq", opts_gpq)):
        pass_line, out, _ = engine_pass(fi, opts, qs, flts, label)
        for kname in need[label]:
            check(pass_line["launches"][kname] > 0,
                  f"engine {label}: {kname} launched: "
                  f"{pass_line['launches']}")
        check(pass_line["scorers"]["use_pallas"] is True,
              "the engine reports the hand kernels serving the routes")
        runs[label] = out
        line[label] = pass_line
    emit(dict(line, part="engine_vs_query"))

    # -- 2. obs on vs off ----------------------------------------------------
    spec = ObsSpec(trace_sample=1.0, probe_sample=1.0, shadow_sample=1.0,
                   kernel_annotations=True)
    try:
        obs_line, out, eng = engine_pass(fi, opts_pq, qs, flts, "obs",
                                         obs=spec)
    finally:
        profiling.set_kernel_annotations(False)
    check(same_responses(out, runs["use_pq"]),
          "obs on: the same responses, bit for bit, as obs off")
    snap = eng.obs.snapshot()
    err = snap["histograms"]["favor_estimator_abs_error"]["series"][""]
    text = eng.obs.prometheus_text()
    tr = eng.obs.tracer.traces[-1]
    obs_part = {
        "run_s": obs_line["run_s"], "run_s_obs_off": line["use_pq"]["run_s"],
        "steps": obs_line["steps"], "traces": len(eng.obs.tracer.traces),
        "stage_ms": tr.stage_ms(), "trace_attrs": tr.attrs,
        "estimator_probes": err["count"],
        "estimator_abs_error_mean": err["sum"] / max(err["count"], 1),
        "route_flips": snap["counters"][
            "favor_estimator_route_flips_total"]["series"],
        "route_confusion": snap["counters"]["favor_route_shadow_total"][
            "series"],
        "route_regret_s": snap["counters"][
            "favor_route_regret_seconds_total"]["series"],
        "prometheus_lines": len(text.splitlines())}
    steps_now = eng.stats["batches"]
    check(err["count"] == steps_now > 0
          and sum(obs_part["route_confusion"].values()) == steps_now,
          f"obs: one probe and one shadow per step ({steps_now}): "
          f"{obs_part}")
    emit({"phase": "engine", "part": "obs", **obs_part})

    # -- 3. one step under torch.profiler ------------------------------------
    from torch.profiler import ProfilerActivity, profile, record_function
    eng = ServeEngine(fi, opts_pq, max_batch=cfg.batch,
                      obs=ObsSpec(kernel_annotations=True, trace_sample=0.0))
    tmp = Path(tempfile.mkdtemp(prefix=".smoke-trace-", dir=ROOT))
    try:
        submit_all(eng, qs[:BATCH], flts[:BATCH])
        eng.step(force=True)                      # warm-up
        submit_all(eng, qs[:BATCH], flts[:BATCH])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("favor/engine_step"):
                step = eng.step(force=True)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        profiling.set_kernel_annotations(False)
        check(same_responses(step, runs["use_pq"][:BATCH]),
              "profiled step: the same responses")
        path = tmp / "engine_step_trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        prof_part = trace_summary(events, "favor/engine_step")
        prof_part["step_wall_ms_profiled"] = 1e3 * step_s
        prof_part["step_wall_ms_unprofiled"] = float(
            np.median(line["use_pq"]["step_ms"]))
        keep = os.environ.get("FAVOR_TRACE_DIR")
        if keep:
            Path(keep).mkdir(parents=True, exist_ok=True)
            with open(path, "rb") as src, gzip.open(
                    Path(keep) / "engine_step_trace.json.gz", "wb") as dst:
                shutil.copyfileobj(src, dst)
    finally:
        profiling.set_kernel_annotations(False)
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "engine", "part": "profile", **prof_part})

    # -- 4. pipelined steps --------------------------------------------------
    eng = ServeEngine(fi, opts_pq, max_batch=BATCH)
    submit_all(eng, qs[:64], flts[:64])
    eng.run()
    batches = [(qs[:BATCH], flts[:BATCH]), (qs[BATCH:2 * BATCH],
                                           flts[BATCH:2 * BATCH])]
    want = [runs["use_pq"][:BATCH], runs["use_pq"][BATCH:2 * BATCH]]
    rounds = []
    for _ in range(PIPE_ROUNDS):
        serial = []
        for (bq, bf), w in zip(batches, want):
            submit_all(eng, bq, bf)
            t0 = time.perf_counter()
            st = eng.begin_batch(force=True)
            t1 = time.perf_counter()
            got = eng.finish_batch(st)
            t2 = time.perf_counter()
            check(same_responses(got, w), "serial step: the run's responses")
            serial.append((1e3 * (t1 - t0), 1e3 * (t2 - t1)))
        for bq, bf in batches:
            submit_all(eng, bq, bf)
        held = []
        t0 = time.perf_counter()
        a = eng.begin_batch(force=True)
        t1 = time.perf_counter()
        b = eng.begin_batch(force=True)
        t2 = time.perf_counter()
        got_b = eng.finish_batch(b)
        worker = threading.Thread(target=lambda: held.append(
            eng.finish_batch(a)))
        worker.start()
        worker.join()
        t3 = time.perf_counter()
        check(len(held) == 1 and same_responses(held[0], want[0])
              and same_responses(got_b, want[1]),
              "pipelined steps finished in reverse order (one on another "
              "thread): bit-identical to serial steps")
        serial_ms = sum(sum(x) for x in serial)
        pipe_ms = 1e3 * (t3 - t0)
        rounds.append({"serial_begin_finish_ms": serial,
                       "serial_ms": serial_ms, "pipelined_ms": pipe_ms,
                       "begin_a_ms": 1e3 * (t1 - t0),
                       "begin_b_ms": 1e3 * (t2 - t1),
                       "overlap_ms": serial_ms - pipe_ms})
    overlap = [r["overlap_ms"] for r in rounds]
    emit({"phase": "engine", "part": "pipelined", "rounds": rounds,
          "overlap_ms_median": float(np.median(overlap)),
          "overlap_share_median": float(np.median(
              [r["overlap_ms"] / r["serial_ms"] for r in rounds]))})

    # -- 5. background merge -------------------------------------------------
    merge_part, merge_launches = engine_merge(saved, qs, flts, opts_pq)
    emit({"phase": "engine", "part": "background_merge", **merge_part})
    return {"pq_adc_topr": line["use_pq"]["launches"]["pq_adc_topr"],
            "gather_distance": line["use_pq"]["launches"]["gather_distance"],
            "pq_adc_gather":
                line["use_pq+graph_pq"]["launches"]["pq_adc_gather"],
            "filtered_topk": merge_launches.get("filtered_topk", 0)}


def engine_merge(saved: Path, qs, flts, opts) -> tuple:
    """Part 5 of the engine phase: the live script through a background-
    merging engine; MERGE_BASELINE_STEPS steps with the delta unmerged and
    no merge running, then ``merge_delta_frac`` set so the next step pokes
    the worker, and steps until it commits.  Returns the part's numbers and
    the serving thread's launches while the merge ran."""
    import threading

    import numpy as np
    import torch

    from repro_torch import kernels as Kn
    from repro_torch.configs.favor_anns import FavorServeConfig
    from repro_torch.serving import ServeEngine

    fi, fg = load_serve(saved), load_serve(saved)
    script = live_script(fi.index.n, fi.index.dim, fi.schema)
    dead = script["dead"]
    eng = ServeEngine(fi, opts, max_batch=FavorServeConfig.batch,
                      merge_background=True)   # worker idles: no trigger
    ctl = eng._merge_ctl
    apply_live_script(eng, script)
    served = [0]

    def serve_batch(j):
        lo = (j % ENGINE_STEPS) * BATCH
        submit_all(eng, qs[lo:lo + BATCH], flts[lo:lo + BATCH])
        t0 = time.perf_counter()
        out = eng.step(force=True)
        dt = 1e3 * (time.perf_counter() - t0)
        check(not any(np.isin(r.ids, dead).any() for r in out),
              "background merge: a deleted or replaced id came back")
        served[0] += 1
        return dt, out

    base_ms = [serve_batch(j)[0] for j in range(MERGE_BASELINE_STEPS)]
    # the commit's own time, beside the stall the engine records (which
    # also counts the wait for the engine lock an in-flight step holds)
    commit_s = []
    backend_commit = eng.backend.merge_commit

    def timed_commit(prep):
        t = time.perf_counter()
        try:
            return backend_commit(prep)
        finally:
            commit_s.append(time.perf_counter() - t)

    eng.backend.merge_commit = timed_commit
    torch.cuda.synchronize()
    Kn.reset_launch_counts()
    eng.merge_delta_frac = MERGE_FRAC      # crossed: the next finish pokes
    t0 = time.perf_counter()
    during, steps, j = [], [], 0
    while ctl.merges == 0 and time.perf_counter() - t0 < MERGE_TIMEOUT_S:
        active = eng._m_merge_active.value() > 0
        dt, _ = serve_batch(j)
        still = eng._m_merge_active.value() > 0
        steps.append({"ms": dt, "merge_active_at_start": active,
                      "merge_active_at_end": still})
        if active and still:
            during.append(dt)
        j += 1
    wait_s = time.perf_counter() - t0
    check(ctl.merges == 1 and ctl.stale == 0,
          f"background merge committed once ({ctl.merges}, stale "
          f"{ctl.stale}) within {MERGE_TIMEOUT_S} s")
    threads = {k: dict(v) for k, v in Kn.launch_threads.items()}
    worker = threads.get("favor-merge", {})
    serving = threads.get(threading.current_thread().name, {})
    check(worker.get("gather_distance", 0) > 0,
          f"the merge worker's waves ran gather_distance: {threads}")
    check(serving.get("filtered_topk", 0) > 0,
          f"the steps' delta scans ran filtered_topk: {threads}")
    after = [serve_batch(j)[1] for j in range(2)]
    st = eng.stats["mutations"]
    check(st["auto_merges"] == 1 and st["delta_rows"] == 0
          and st["base_rows"] == fi.index.n, f"merge stats: {st}")
    apply_live_script(fg, script)
    fg.merge()
    for j, out in enumerate(after):
        lo = j * BATCH
        res = fg.query(qs[lo:lo + BATCH], flts[lo:lo + BATCH], opts)
        ids = np.stack([r.ids for r in out])
        dists = np.stack([r.dists for r in out])
        check(np.array_equal(ids, res.ids)
              and np.array_equal(dists.view(np.uint32),
                                 res.dists.view(np.uint32)),
              "after the commit: a batch equals the foreground-merged "
              "index's, bit for bit")
    eng.close()
    part = {"upserts": LIVE_UPSERT, "replaced": LIVE_REPLACE,
            "deletes": LIVE_DELETE, "merge_delta_frac": MERGE_FRAC,
            "merge_s": eng._m_merge_s.sum(),
            "commit_stall_s": eng._m_merge_stall.sum(),
            "commit_s": commit_s,
            "wait_to_commit_s": wait_s, "steps_served": served[0],
            "steps_during_merge": len(during),
            "step_ms_during_merge": during, "steps_after_trigger": steps,
            "step_ms_no_merge": base_ms,
            "p50_ms_during_merge": (float(np.percentile(during, 50))
                                    if during else None),
            "p99_ms_during_merge": (float(np.percentile(during, 99))
                                    if during else None),
            "p50_ms_no_merge": float(np.percentile(base_ms, 50)),
            "p99_ms_no_merge": float(np.percentile(base_ms, 99)),
            "launches_by_thread": threads,
            "merge_worker_gather_distance": worker.get("gather_distance", 0)}
    return part, serving


def timed_frontend(eng, spec):
    """A ``FrontEnd`` over ``eng`` that keeps the wall seconds of every
    executor call of its engine (``serve_s``): the engine's step, which a
    request's front-end latency less its step time leaves over."""
    from repro_torch.serving import FrontEnd

    class Timed(FrontEnd):
        def _serve(self, batch):
            t0 = time.perf_counter()
            try:
                return super()._serve(batch)
            finally:
                self.serve_s.append(time.perf_counter() - t0)

    fe = Timed(eng, spec)
    fe.serve_s = []
    return fe


def fe_traffic(fi):
    """The frontend phase's burst: FE_PER_TENANT requests of each tenant,
    interleaved, over the mixed filters (queries, filters, tenants)."""
    from repro_torch.core import filters as F
    from repro_torch.data import synthetic
    n = len(FE_TENANTS) * FE_PER_TENANT
    qs = synthetic.make_queries(n, fi.index.dim, dataset_seed=SEED, seed=400)
    flts, _ = mixed_filters(F, fi.schema, n)
    names = list(FE_TENANTS)
    return qs, flts, [names[i % len(names)] for i in range(n)]


def fe_reference(fi, qs, flts, opts):
    """``FavorIndex.query`` over the burst in BATCH-row batches, as
    (ids, dists, routed_brute, p_hat) host arrays."""
    import numpy as np
    parts = [fi.query(qs[lo:lo + BATCH], flts[lo:lo + BATCH], opts)
             for lo in range(0, len(qs), BATCH)]
    return tuple(np.concatenate([getattr(r, k) for r in parts])
                 for k in ("ids", "dists", "routed_brute", "p_hat"))


async def fe_send(fe, qs, flts, tenants):
    """Submit the whole burst at once; returns each request's Response or
    its ``Overloaded``, and the wall seconds.  Any other exception
    fails the phase."""
    import asyncio

    from repro_torch.serving import Overloaded
    t0 = time.perf_counter()
    outs = await asyncio.gather(*[fe.submit(qs[i], flts[i], tenant=tenants[i])
                                  for i in range(len(qs))],
                                return_exceptions=True)
    wall = time.perf_counter() - t0
    for o in outs:
        if isinstance(o, BaseException) and not isinstance(o, Overloaded):
            raise o
    return outs, wall


def fe_hold(outs, ref, label: str) -> int:
    """Hold each served response to ``ref`` (ids, dists, routed_brute,
    p_hat; None rows skipped): routes and p_hat bit for bit, ids and
    distances bit for bit except on brute rows, which may come from a
    candidate block (the host's exact f32 scan): ids equal where distances
    are distinct, distances within RTOL / ATOL.  Returns how many rows took
    that exception."""
    import numpy as np

    from repro_torch.parity import topk_mismatch
    from repro_torch.serving import Overloaded
    ids, dists, brute, p_hat = ref
    inexact = 0
    for i, o in enumerate(outs):
        if isinstance(o, Overloaded) or ids[i] is None:
            continue
        check(o.route == ("brute" if brute[i] else "graph")
              and np.float32(o.p_hat).view(np.uint32)
              == np.float32(p_hat[i]).view(np.uint32),
              f"{label}: request {i}: route and p_hat bit for bit")
        if np.array_equal(o.ids, ids[i]) and np.array_equal(
                o.dists.view(np.uint32),
                np.asarray(dists[i], np.float32).view(np.uint32)):
            continue
        mm = topk_mismatch(ids[i][None], dists[i][None], o.ids[None],
                           o.dists[None], rtol=RTOL, atol=ATOL)
        check(o.route == "brute" and mm["dist_mismatch"] == 0
              and mm["id_mismatch"] == 0,
              f"{label}: request {i} ({o.route}) differs: {mm}")
        inexact += 1
    return inexact


def fe_rows(outs):
    """``outs`` as a reference: (ids, dists, routed_brute, p_hat) lists with
    None where the request was shed."""
    from repro_torch.serving import Overloaded
    keep = [None if isinstance(o, Overloaded) else o for o in outs]
    return ([None if o is None else o.ids for o in keep],
            [None if o is None else o.dists for o in keep],
            [None if o is None else o.route == "brute" for o in keep],
            [None if o is None else o.p_hat for o in keep])


def fe_summary(fe, outs, wall: float, launches: dict, tenants) -> dict:
    """One pass's numbers off the front-end's stats (reset before the
    pass): served / shed, request p50 / p99 and QPS, the front-end's own
    seconds (the pass's wall time less its engine steps, with one executor
    slot; with more, the steps' overlap: their sum less the wall), each
    cache layer's hit rate, the dispatches' mean batch and the router's
    pad fraction, the launches of each kernel."""
    import numpy as np

    from repro_torch.serving import Overloaded
    st = fe.stats
    served = [o for o in outs if not isinstance(o, Overloaded)]
    shed = [t for o, t in zip(outs, tenants) if isinstance(o, Overloaded)]
    check(all(o.reason == "rate_limit" for o in outs
              if isinstance(o, Overloaded))
          and set(shed) <= {FE_LIMITED},
          f"only {FE_LIMITED} sheds, on its rate limit")
    eng = st["engine"]
    check(eng["graph"] + eng["brute"] == len(served)
          == sum(t["served"] for t in st["tenants"].values()),
          f"shed requests never reach the engine: {eng['graph']} + "
          f"{eng['brute']} engine rows, {len(served)} served")
    lat = np.array([o.latency_s for o in served]) * 1e3
    cache = eng["cache"]
    steps = list(fe.serve_s)
    return {
        "requests": len(outs), "served": len(served), "shed": len(shed),
        "wall_s": wall, "qps": len(served) / wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "dispatches": st["coalesce"]["dispatches"],
        "mean_batch": st["coalesce"]["mean_batch"],
        "engine_step_s": steps,
        **({"frontend_s": wall - sum(steps)} if fe.spec.parallel_steps == 1
           else {"steps_overlap_s": sum(steps) - wall}),
        "pad_overhead": eng["batching"]["pad_overhead"],
        "graph": eng["graph"], "brute": eng["brute"],
        "hit_rate": {k: cache[k]["hit_rate"]
                     for k in ("selectivity", "candidates", "semantic")},
        "hits": {k: cache[k]["hits"]
                 for k in ("selectivity", "candidates", "semantic")},
        "misses": {k: cache[k]["misses"]
                   for k in ("selectivity", "candidates", "semantic")},
        "candidate_bypasses": cache["candidates"]["bypasses"],
        "candidates_composed": cache["candidates"]["composed"],
        "launches": launches,
        "tenants": {t: {k: v.get(k) for k in ("served", "shed_total",
                                              "p50_ms", "p99_ms")}
                    for t, v in st["tenants"].items()}}


def fe_stack(fi, opts, **spec_kw):
    """A fresh ``CachingBackend(CacheSpec())`` over ``fi``'s backend, a
    ``ServeEngine`` at favor-anns' batch and a timed ``FrontEnd`` with the
    phase's three tenants."""
    from repro_torch.cache import CachingBackend
    from repro_torch.configs.favor_anns import FavorServeConfig
    from repro_torch.core import CacheSpec, FrontEndSpec, TenantSpec
    from repro_torch.serving import ServeEngine
    cb = CachingBackend(fi.backend, CacheSpec())
    eng = ServeEngine(cb, opts, max_batch=FavorServeConfig.batch,
                      max_wait_ms=FE_COALESCE_MS)
    check(eng.stats["scorers"]["use_pallas"] is True
          and cb.device.type == "cuda",
          "the cached engine's routes run on the card")
    tenants = {t: TenantSpec(weight=w) for t, w in FE_TENANTS.items()}
    tenants[FE_LIMITED] = tenants[FE_LIMITED].with_(rate_qps=FE_RATE_QPS,
                                                     burst=FE_BURST)
    spec = FrontEndSpec(coalesce_ms=FE_COALESCE_MS, tenants=tenants,
                        **spec_kw)
    return cb, eng, timed_frontend(eng, spec)


async def fe_passes(fe, traffic) -> dict:
    """The cold pass and the warm pass of the burst, the counters and the
    launch counts zeroed before each and read after it."""
    import torch

    from repro_torch import kernels as Kn
    out = {}
    for name in ("cold", "warm"):
        fe.reset_stats()
        fe.serve_s.clear()
        torch.cuda.synchronize()
        Kn.reset_launch_counts()
        outs, wall = await fe_send(fe, *traffic)
        out[name] = (outs, fe_summary(fe, outs, wall, dict(Kn.launch_counts),
                                      traffic[2]))
    return out


def phase_frontend(dev, saved: Path) -> dict:
    """The asyncio multi-tenant ``FrontEnd`` over a ``CachingBackend``-
    wrapped engine on a fresh copy of the serve index, at favor-anns' batch:

      1. three option sets -- favor-anns' ``use_pq`` (the candidate layer
         bypasses), f32 (it admits and serves) and ``use_pq`` +
         ``graph_quant="pq"`` -- each with its own cache, engine and
         front-end, bucketed (``BUCKETS``): a burst of FE_TENANTS x
         FE_PER_TENANT requests sent cold, then again unchanged (warm).
         Every served response equals ``FavorIndex.query``'s for the same
         (query, filter) pair, bit for bit (brute rows served from a
         candidate block: ids where distances are distinct, distances
         within RTOL / ATOL); warm equals cold; only the rate-limited
         tenant sheds, and shed requests never reach the engine;
      2. ``parallel_steps=2`` (a fresh cache) returns the one-slot cold
         pass's bits;
      3. isolation: a pair sent by one tenant twice, then by another,
         counts a hit for the first and a miss for the second;
      4. the front-end's own overhead: FE_PROBES single requests, each
         latency less its engine step;
      5. with the f32 cache warm, the live script's upserts and deletes
         through the engine: no deleted or replaced id comes back, the
         results equal an uncached engine's after the same mutations, the
         cache counted one invalidation and its selectivity and candidate
         layers stayed warm (candidate hits composed with the live rows).
    Returns each kernel's launches over the cold and the warm pass of the
    option set that runs it."""
    import asyncio

    from repro_torch.configs.favor_anns import FavorServeConfig
    from repro_torch.core import BatchSpec

    fi = load_serve(saved)
    cfg = FavorServeConfig()
    traffic = fe_traffic(fi)
    qs, flts, _ = traffic
    # f32 last: its live part mutates the index
    opts = {"use_pq": cfg.search_options(batch=BatchSpec(**BUCKETS))}
    opts["use_pq+graph_pq"] = opts["use_pq"].with_(graph_quant="pq")
    opts["f32"] = opts["use_pq"].with_(use_pq=False)
    need = {"use_pq": ("pq_adc_topr", "gather_distance"),
            "f32": ("filtered_topk", "gather_distance"),
            "use_pq+graph_pq": ("pq_adc_topr", "pq_adc_gather")}
    head = {"phase": "frontend", "n": fi.index.n, "d": fi.index.dim,
            "max_batch": cfg.batch, "tenants": FE_TENANTS,
            "rate_limited": {FE_LIMITED: {"rate_qps": FE_RATE_QPS,
                                          "burst": FE_BURST}},
            "per_tenant": FE_PER_TENANT, "coalesce_ms": FE_COALESCE_MS,
            "buckets": BUCKETS}
    emit(dict(head, part="setup"))
    launches = {}
    for label, o in opts.items():
        ref = fe_reference(fi, qs, flts, o)
        cb, eng, fe = fe_stack(fi, o)

        async def run():
            passes = await fe_passes(fe, traffic)
            extra = {}
            if label == "use_pq":
                extra["isolation"] = await fe_isolation(fe, cb, qs, flts)
                extra["overhead"] = await fe_overhead(fe, fi)
            if label == "f32":
                extra["live"] = await fe_live(fe, eng, cb, fi, saved,
                                              traffic, o)
            await fe.close()
            return passes, extra

        passes, extra = asyncio.run(run())
        (cold, cold_line), (warm, warm_line) = passes["cold"], passes["warm"]
        exact = label != "f32"
        cold_line["inexact_rows"] = fe_hold(cold, ref, f"{label} cold")
        warm_line["inexact_rows"] = fe_hold(warm, fe_rows(cold),
                                            f"{label} warm vs cold")
        for line in (cold_line, warm_line):
            check(line["inexact_rows"] <= line["hits"]["candidates"]
                  and (not exact or line["inexact_rows"] == 0),
                  f"{label}: only candidate-block hits may differ in the "
                  f"last bits: {line['inexact_rows']} rows, "
                  f"{line['hits']['candidates']} hits")
        for kname in need[label]:
            check(cold_line["launches"][kname] > 0,
                  f"frontend {label}: {kname} launched on the cold pass: "
                  f"{cold_line['launches']}")
        check(warm_line["hits"]["semantic"] > 0
              and warm_line["misses"]["selectivity"] == 0,
              f"{label}: the warm pass hit the semantic layer, and the "
              f"selectivity layer on every semantic miss: "
              f"{warm_line['hits']}, {warm_line['misses']}")
        if label == "f32":
            check(warm_line["hits"]["candidates"] > 0,
                  "f32: the candidate layer served the warm brute rows")
        else:
            check(warm_line["hits"]["candidates"] == 0
                  and cold_line["candidate_bypasses"] > 0,
                  f"{label}: the compressed scan bypasses the candidate "
                  "layer")
        launches[label] = {"cold": cold_line["launches"],
                           "warm": warm_line["launches"]}
        emit(dict(head, part=label, options={
            k: v for k, v in vars(o).items() if v is not None and k != "batch"},
            cold=cold_line, warm=warm_line, **extra))
        if label == "use_pq":
            emit(dict(head, part="parallel_steps",
                      **fe_parallel(fi, o, traffic, cold)))
    return {"pq_adc_topr": launches["use_pq"],
            "gather_distance": launches["f32"],
            "filtered_topk": launches["f32"],
            "pq_adc_gather": launches["use_pq+graph_pq"]}


def fe_parallel(fi, opts, traffic, one) -> dict:
    """The cold pass again through ``parallel_steps=2`` (a fresh cache):
    the one-slot cold pass's bits, request for request."""
    import asyncio

    cb, eng, fe = fe_stack(fi, opts, parallel_steps=2)

    async def run():
        fe.reset_stats()
        outs, wall = await fe_send(fe, *traffic)
        line = fe_summary(fe, outs, wall, {}, traffic[2])
        await fe.close()
        return outs, line

    outs, line = asyncio.run(run())
    check(fe_hold(outs, fe_rows(one), "parallel_steps=2 vs 1") == 0,
          "parallel_steps=2: the one-slot cold pass's bits")
    return {"slots": 2, "cold": line}


async def fe_isolation(fe, cb, qs, flts) -> dict:
    """A fresh pair sent by the heaviest tenant twice, then by another: a
    miss and a hit for the first, a miss for the second (``by_scope``), and
    the same bits for all three."""
    import numpy as np

    from repro_torch.data import synthetic
    a, b = "gold", "silver"
    q = synthetic.make_queries(1, qs.shape[1], dataset_seed=SEED, seed=401)[0]
    sa, sb = cb.scope_id(a), cb.scope_id(b)

    def counts():
        by = cb.cache_stats()["semantic"]["by_scope"]
        return {s: (by.get(s, {}).get("hits", 0),
                    by.get(s, {}).get("misses", 0)) for s in (sa, sb)}

    c0 = counts()
    r = [await fe.submit(q, flts[0], tenant=t) for t in (a, a, b)]
    c1 = counts()
    delta = {t: (c1[s][0] - c0[s][0], c1[s][1] - c0[s][1])
             for t, s in ((a, sa), (b, sb))}
    check(delta == {a: (1, 1), b: (0, 1)},
          f"isolation: {a} miss then hit, {b} a miss: {delta}")
    check(all(np.array_equal(x.ids, r[0].ids) and np.array_equal(
        x.dists.view(np.uint32), r[0].dists.view(np.uint32)) for x in r),
          "isolation never changes the result")
    return {"scopes": {a: sa, b: sb}, "hits_misses": delta}


async def fe_overhead(fe, fi) -> dict:
    """FE_PROBES single requests, one at a time (fresh queries, a mixed
    filter each): each one's front-end latency less its engine step."""
    import numpy as np

    from repro_torch.core import filters as F
    from repro_torch.data import synthetic
    qs = synthetic.make_queries(FE_PROBES, fi.index.dim, dataset_seed=SEED,
                                seed=402)
    flts, _ = mixed_filters(F, fi.schema, FE_PROBES)
    over, lat = [], []
    for i in range(FE_PROBES):
        n0 = len(fe.serve_s)
        r = await fe.submit(qs[i], flts[i], tenant="silver")
        check(len(fe.serve_s) == n0 + 1, "one engine step per probe")
        lat.append(1e3 * r.latency_s)
        over.append(1e3 * (r.latency_s - fe.serve_s[-1]))
    return {"probes": FE_PROBES, "latency_ms": lat, "overhead_ms": over,
            "overhead_ms_median": float(np.median(over)),
            "step_ms_median": float(np.median(np.array(lat)
                                              - np.array(over)))}


async def fe_live(fe, eng, cb, fi, saved: Path, traffic, opts) -> dict:
    """The live script through the cached f32 engine with its cache warm,
    then the burst again; held to an uncached engine over a fresh copy of
    the index after the same mutations."""
    import numpy as np

    from repro_torch.configs.favor_anns import FavorServeConfig
    from repro_torch.serving import Overloaded, ServeEngine
    qs, flts, tenants = traffic
    script = live_script(fi.index.n, fi.index.dim, fi.schema)
    dead = script["dead"]
    sizes = {k: cb.cache_stats()[k]["size"]
             for k in ("selectivity", "candidates")}
    fe.reset_stats()
    fe.serve_s.clear()
    t0 = time.perf_counter()
    apply_live_script(eng, script)
    mutate_s = time.perf_counter() - t0
    outs, wall = await fe_send(fe, qs, flts, tenants)
    line = fe_summary(fe, outs, wall, {}, tenants)
    st = cb.cache_stats()
    check(st["invalidations"] == 1,
          f"the mutations invalidated the cache once: {st['invalidations']}")
    check(st["selectivity"]["misses"] == 0 and st["selectivity"]["size"]
          == sizes["selectivity"],
          f"a vectors-only bump leaves the selectivity layer warm: "
          f"{st['selectivity']}")
    check(st["candidates"]["hits"] > 0 and st["candidates"]["composed"] > 0
          and st["candidates"]["size"] >= sizes["candidates"],
          f"a vectors-only bump leaves the candidate layer warm (hits "
          f"composed with the live rows): {st['candidates']}")
    served = [i for i, o in enumerate(outs) if not isinstance(o, Overloaded)]
    check(not any(np.isin(outs[i].ids, dead).any() for i in served),
          "live: a deleted or replaced id came back")
    fg = load_serve(saved)
    apply_live_script(fg, script)
    plain = ServeEngine(fg, opts, max_batch=FavorServeConfig.batch)
    for i in served:
        plain.submit(qs[i], flts[i])
    ref_out = plain.run()
    ref = tuple([None] * len(outs) for _ in range(4))
    for i, r in zip(served, ref_out, strict=True):
        ref[0][i], ref[1][i] = r.ids, r.dists
        ref[2][i], ref[3][i] = r.route == "brute", r.p_hat
    inexact = fe_hold(outs, ref, "live vs uncached")
    check(inexact <= line["hits"]["candidates"],
          f"live: only candidate-block hits differ in the last bits "
          f"({inexact} rows)")
    line.update(mutate_s=mutate_s, inexact_rows=inexact,
                invalidations=st["invalidations"],
                upserts=LIVE_UPSERT, replaced=LIVE_REPLACE,
                deletes=LIVE_DELETE)
    return line

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


def sharded_copy(sh, mesh):
    """The same ShardedBackend's arrays, codebook and options on ``mesh``."""
    from repro_torch.core import ShardedBackend
    return ShardedBackend(mesh, sh.sharded, sh.schema, sel_cfg=sh.sel_cfg,
                          codebook=sh.codebook, rerank=sh.rerank)


def timed_batches(query, qs, flts, opts, label: str):
    """``query(qs, flts, opts)`` once counted (launch counters reset just
    before it, read just after it) and SERVE_REPEATS - 1 times more, each
    returning the same ids; after a 64-query warm-up.  Returns the counted
    result, its launches and the sorted batch times (ms)."""
    import numpy as np
    import torch

    from repro_torch import kernels as Kn

    query(qs[:64], flts[:64], opts)
    torch.cuda.synchronize()
    Kn.reset_launch_counts()
    t0 = time.perf_counter()
    res = query(qs, flts, opts)
    walls = [time.perf_counter() - t0]
    launches = dict(Kn.launch_counts)
    for _ in range(SERVE_REPEATS - 1):
        t0 = time.perf_counter()
        again = query(qs, flts, opts)
        walls.append(time.perf_counter() - t0)
        check(bool(np.array_equal(again.ids, res.ids)),
              f"{label}: the batch is deterministic")
    return res, launches, sorted(1e3 * w for w in walls)


def route_recall(res, truth) -> dict:
    import numpy as np
    rec = np.array([refimpl_recall(res.ids[i], truth[i])
                    for i in range(len(truth))])
    br = res.routed_brute
    return {"brute": float(rec[br].mean()), "graph": float(rec[~br].mean()),
            "brute_rows": int(br.sum()), "graph_rows": int((~br).sum())}


def sharded_cpu_copy(sh):
    """``cpu_check``'s (query, adc) for a ShardedBackend: the same arrays,
    codebook and options on a CPU mesh of the same shape."""
    import torch

    from repro_torch.core import router
    from repro_torch.core.distributed import make_mesh

    cpu = sharded_copy(sh, make_mesh((1, SHARDS), device="cpu"))

    def norms(cell):
        if "alive" not in cell:
            return cell["norms"]
        return torch.where(cell["alive"], cell["norms"], float("inf"))

    scans = [(c["codes"], norms(c), c["attrs_int"], c["attrs_float"],
              c["centroids"]) for c in cpu.db[0]]
    return ((lambda q, f, o: router.execute(cpu, q, f, o)),
            (cpu.rerank,
             lambda f: router.compile_programs(f, sh.schema, len(f),
                                               device="cpu"), scans))


def sharded_live(sh, qs, flts, opts) -> dict:
    """The live phase's script through the sharded backend, then a second,
    smaller round of upserts and deletes: no deleted or replaced id comes
    back (both routes, and ``use_pq`` brute), brute recall@10 is 1.0
    against exact ground truth over the live rows before ``merge()``,
    after the first (full: every shard rebuilt with headroom in the last)
    and after the second (incremental: only the last shard grows, and only
    its ``shard_versions`` entry moves)."""
    import numpy as np
    import torch

    from repro_torch import kernels as Kn
    from repro_torch.core import router
    from repro_torch.core import filters as F
    from repro_torch.data import synthetic
    from repro_torch.kernels.filtered_topk import ops as ft

    a = sh.sharded.arrays
    n0, d, schema = a["vectors"].shape[0], a["vectors"].shape[1], sh.schema
    base = (a["vectors"].copy(), a["attrs_int"].copy(),
            a["attrs_float"].copy())
    script = live_script(n0, d, schema)
    steps = {}
    t0 = time.perf_counter()
    apply_live_script(sh, script)
    steps["mutate_s"] = time.perf_counter() - t0
    more_n = LIVE_UPSERT // 4
    more_v = synthetic.make_queries(more_n, d, dataset_seed=SEED, seed=500)
    more_a = F.random_attributes(schema, more_n, seed=SEED + 13)
    rows = {"v": np.concatenate([base[0], script["vectors"], more_v]),
            "i": np.concatenate([base[1], script["attrs"].ints, more_a.ints]),
            "f": np.concatenate([base[2], script["attrs"].floats,
                                 more_a.floats])}
    dead = list(script["dead"])
    progs = None

    def serve(label, live_n):
        nonlocal progs
        norms = np.einsum("nd,nd->n", rows["v"][:live_n],
                          rows["v"][:live_n]).astype(np.float32)
        norms[np.asarray(dead, np.int64)] = np.inf
        db = [torch.as_tensor(np.ascontiguousarray(x), device=sh.device)
              for x in (rows["v"][:live_n], norms, rows["i"][:live_n],
                        rows["f"][:live_n])]
        if progs is None:
            progs = router.compile_programs(flts, schema, len(flts),
                                            device=sh.device)
        gt, _ = ft.filtered_topk_plain(
            *db, torch.as_tensor(qs, device=sh.device), progs, k=K)
        gt = gt.cpu().numpy()
        torch.cuda.synchronize()
        Kn.reset_launch_counts()
        t0 = time.perf_counter()
        res = router.execute(sh, qs, flts, opts)
        wall = time.perf_counter() - t0
        launches = dict(Kn.launch_counts)
        pq = router.execute(sh, qs, flts, opts.with_(use_pq=True))
        for r, what in ((res, "f32"), (pq, "use_pq")):
            check(not np.isin(r.ids, dead).any(),
                  f"sharded live {label} ({what}): a deleted or replaced id "
                  "came back")
        rec = route_recall(res, gt)
        check(rec["brute"] == 1.0,
              f"sharded live {label}: brute recall@10 {rec['brute']}")
        steps[label] = {"batch_ms": 1e3 * wall, "launches": launches,
                        "recall_at_10": rec,
                        "use_pq_recall_at_10": route_recall(pq, gt),
                        "shard_versions": list(sh.shard_versions())}

    serve("before_merge", n0 + LIVE_UPSERT)
    for label, live_n in (("full_merge", n0 + LIVE_UPSERT),
                          ("incremental_merge",
                           n0 + LIVE_UPSERT + more_n)):
        if label == "incremental_merge":
            ids = sh.upsert(more_v, more_a.ints, more_a.floats)
            check(bool((ids == n0 + LIVE_UPSERT + np.arange(more_n)).all()),
                  "sharded: upsert ids are positional after a merge")
            kept = script["ids"][~np.isin(script["ids"], script["dead"])]
            gone = np.r_[ids[:more_n // 8], kept[-(more_n // 8):]]
            found = sh.delete(gone)
            check(found == len(gone), f"sharded: delete found {found}")
            dead += list(gone)
        before = sh.shard_versions()
        torch.cuda.synchronize()
        Kn.reset_launch_counts()
        t0 = time.perf_counter()
        out = sh.merge()
        torch.cuda.synchronize()
        after = sh.shard_versions()
        steps[label] = {"merge_s": time.perf_counter() - t0,
                        "launches": dict(Kn.launch_counts), **out,
                        "capacity": int(sh.sharded.arrays["vectors"]
                                        .shape[0]),
                        "shard_rows": sh.sharded.shard_rows}
        incr = label == "incremental_merge"
        check(out["incremental"] == incr and sh.live_stats()["delta_rows"]
              == 0, f"sharded {label}: {out}")
        moved = [i for i, (x, y) in enumerate(zip(before, after)) if x != y]
        check(moved == ([SHARDS - 1] if incr else list(range(SHARDS))),
              f"sharded {label}: shard versions {before} -> {after}")
        serve(f"after_{label}", live_n)
    return steps


def phase_sharded(dev, saved: Path) -> dict:
    """The sharded backend on a (1, SHARDS) mesh of the card: the serve
    phase's rows, attributes and PQ codebook (from the saved index), one
    host HNSW per shard at the serve phase's parameters.

      1. one 1024-query batch of the mixed filters under f32, ``use_pq``
         and ``use_pq`` + ``graph_quant="pq"``, timed SERVE_REPEATS times,
         beside the same passes on the serve index's LocalBackend: recall@10
         by route against exact filtered ground truth, each kernel's
         launches per batch (one brute-scan launch per shard);
      2. each pass against the same backend on a CPU mesh (``cpu_check``:
         p_hat, routes, brute rows at the kernel bar with ``use_pq``'s ADC
         boundary near-ties excluded, graph rows >= 90 % identical); the
         f32 brute route against the LocalBackend over the same rows (ids
         outside ties, distances at the kernel bar); graph recall within
         0.1 of the LocalBackend's, ``use_pq`` brute recall within 0.02 of
         the sharded f32's;
      3. a (2, SHARDS) mesh on the same card: the same bits;
      4. ``ServeEngine`` over the sharded backend: 1024 requests with
         ``router.execute``'s bits; ``CachingBackend`` over it, cold and
         warm, with the uncached bits, finding the sharded corpus;
      5. the live script (``sharded_live``) with a full and an incremental
         merge.
    Returns each kernel's launches on the pass that runs it."""
    import numpy as np
    import torch

    from repro_torch import kernels as Kn
    from repro_torch.cache import CachingBackend
    from repro_torch.configs.favor_anns import FavorServeConfig
    from repro_torch.core import (BuildSpec, CacheSpec, HnswParams, QuantSpec,
                                  SearchOptions, ShardedBackend, router)
    from repro_torch.core import filters as F
    from repro_torch.core.distributed import make_mesh
    from repro_torch.data import synthetic
    from repro_torch.kernels.filtered_topk import ops as ft
    from repro_torch.parity import topk_mismatch
    from repro_torch.serving import ServeEngine

    t_phase = time.perf_counter()
    fi = load_serve(saved)
    vecs, attrs, schema = fi.index.vectors, fi.attrs, fi.schema
    n, d, b = vecs.shape[0], vecs.shape[1], BATCH
    spec = BuildSpec(hnsw=HnswParams(M=16, efc=100, seed=SEED),
                     quant=QuantSpec(kind="pq", m=PQ_M, nbits=PQ_BITS,
                                     rerank=RERANK))
    t0 = time.perf_counter()
    sh = ShardedBackend.build(vecs, attrs, make_mesh((1, SHARDS)), spec,
                              codebook=fi.codebook, seed=SEED)
    build_s = time.perf_counter() - t0
    check(sh.device.type == "cuda" and sh.sharded.n_shards == SHARDS
          and sh.quant == "pq", "the sharded backend lies on the card")
    emit({"phase": "sharded", "part": "build", "n": n, "d": d,
          "mesh": sh.mesh.shape, "shard_rows": sh.sharded.shard_rows,
          "sample_rows": sh.sharded.sample_rows, "build_s": build_s,
          "hnsw": {"M": 16, "M0": 32, "efc": 100}})
    qs = synthetic.make_queries(b, d, dataset_seed=SEED, seed=100)
    flts, names = mixed_filters(F, schema, b)
    progs = fi.compile_filters(flts)
    pv, pn, pi, pf = fi._pf
    gt, _ = ft.filtered_topk_plain(pv, pn, pi, pf,
                                   torch.as_tensor(qs, device=dev), progs,
                                   k=K)
    truth = gt.cpu().numpy()

    def sharded_query(q, f, o):
        return router.execute(sh, q, f, o)

    passes = {
        "f32": SearchOptions(k=K, ef=EF),
        "use_pq": SearchOptions(k=K, ef=EF, use_pq=True),
        "use_pq+graph_pq": SearchOptions(k=K, ef=EF, use_pq=True,
                                         graph_quant="pq"),
    }
    scan = {"f32": "filtered_topk", "use_pq": "pq_adc_topr",
            "use_pq+graph_pq": "pq_adc_topr"}
    gather = {"f32": "gather_distance", "use_pq": "gather_distance",
              "use_pq+graph_pq": "pq_adc_gather"}
    cpu_copy = sharded_cpu_copy(sh)
    results, lines = {}, {}
    for label, opts in passes.items():
        line = {"phase": "sharded", "part": label}
        for who, query in (("sharded", sharded_query), ("local", fi.query)):
            res, launches, walls = timed_batches(query, qs, flts, opts,
                                                 f"{who} {label}")
            line[who] = {"batch_ms": walls,
                         "p50_ms": float(np.percentile(walls, 50)),
                         "launches": launches,
                         "recall_at_10": route_recall(res, truth)}
            results[(who, label)] = res
        sl = line["sharded"]
        check(sl["launches"].get(scan[label], 0) == SHARDS,
              f"sharded {label}: one {scan[label]} launch per shard: "
              f"{sl['launches']}")
        check(sl["launches"].get(gather[label], 0) >= SHARDS,
              f"sharded {label}: {gather[label]} launched on every shard: "
              f"{sl['launches']}")
        sl["gather_launches_per_shard"] = (
            sl["launches"][gather[label]] / SHARDS)
        rs, rl = sl["recall_at_10"], line["local"]["recall_at_10"]
        check(rs["graph"] >= rl["graph"] - 0.1,
              f"sharded {label}: graph recall {rs['graph']} vs local "
              f"{rl['graph']}")
        line["cpu_check"] = cpu_check(*cpu_copy, results[("sharded", label)],
                                      qs, flts, opts, f"sharded {label}")
        lines[label] = line
        emit(line)
    rs32 = lines["f32"]["sharded"]["recall_at_10"]
    check(rs32["brute"] == 1.0, f"sharded f32 brute recall {rs32['brute']}")
    for label in ("use_pq", "use_pq+graph_pq"):
        rq = lines[label]["sharded"]["recall_at_10"]["brute"]
        check(rq >= rs32["brute"] - RECALL_SLACK,
              f"sharded {label}: brute recall {rq} vs f32 {rs32['brute']}")

    # f32 brute rows: the LocalBackend over the same rows
    forced = SearchOptions(k=K, ef=EF, force="brute")
    r_sh = router.execute(sh, qs, flts, forced)
    r_lo = fi.query(qs, flts, forced)
    m = topk_mismatch(r_lo.ids, r_lo.dists, r_sh.ids, r_sh.dists, RTOL, ATOL)
    check(m["dist_mismatch"] == 0 and m["id_mismatch"] == 0,
          f"sharded f32 brute vs the LocalBackend: {m}")
    extra = {"brute_vs_local": {
        **m, "ids_equal_rows": float((r_sh.ids == r_lo.ids).all(axis=1)
                                     .mean())}}

    # the data-axis split
    wide = sharded_copy(sh, make_mesh((2, SHARDS)))
    rw = router.execute(wide, qs, flts, passes["f32"])
    check(same_bits(rw, results[("sharded", "f32")])
          and bool((rw.p_hat == results[("sharded", "f32")].p_hat).all()),
          f"sharded: mesh (2, {SHARDS}) gives the (1, {SHARDS}) bits")
    del wide
    extra["mesh_2x_same_bits"] = True

    # the engine and the cache over the sharded backend
    opts = FavorServeConfig().search_options()
    eng = ServeEngine(sh, opts, max_batch=FavorServeConfig.batch,
                      max_wait_ms=2.0)
    torch.cuda.synchronize()
    Kn.reset_launch_counts()
    t0 = time.perf_counter()
    submit_all(eng, qs, flts)
    out = eng.run()
    wall = time.perf_counter() - t0
    launches = dict(Kn.launch_counts)
    responses_match_query(out, SimpleNamespace(query=sharded_query), qs,
                          flts, opts, "sharded engine")
    extra["engine"] = {"requests": len(out), "steps": eng.stats["batches"],
                       "run_s": wall, "qps": len(out) / wall,
                       "latency_ms": eng.latency_percentiles(),
                       "launches": launches}
    cb = CachingBackend(sh, CacheSpec())
    ref = router.execute(sh, qs, flts, opts)
    cold = router.execute(cb, qs, flts, opts)
    warm = router.execute(cb, qs, flts, opts)
    check(same_bits(cold, ref) and same_bits(warm, cold),
          "sharded cache: cold == uncached, warm == cold, bit for bit")
    check(cb._corpus() is not None
          and cb._corpus()[0].shape == sh.sharded.arrays["vectors"].shape,
          "sharded cache: the candidate layer finds the sharded corpus")
    st = cb.cache_stats()
    extra["cache"] = {layer: {c: int(st[layer][c]) for c in ("hits",
                                                             "misses")}
                      for layer in ("selectivity", "candidates", "semantic")}
    emit({"phase": "sharded", "part": "checks", **extra})

    emit({"phase": "sharded", "part": "live",
          **sharded_live(sh, qs, flts, passes["f32"])})
    emit({"phase": "sharded", "part": "done",
          "phase_s": time.perf_counter() - t_phase})
    return {"filtered_topk": lines["f32"]["sharded"]["launches"],
            "gather_distance": lines["f32"]["sharded"]["launches"],
            "pq_adc_topr": lines["use_pq"]["sharded"]["launches"],
            "pq_adc_gather": lines["use_pq+graph_pq"]["sharded"]["launches"]}


# ---------------------------------------------------------------------------
# The models phase: the model zoo at its published widths
# ---------------------------------------------------------------------------
def free_card() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def models_retrieval(dev) -> dict:
    """dlrm-rm2's ``retrieval_cand`` cell: RETR_N item embeddings of
    d = RETR_D with the paper schema's attributes, one W = 8 program per
    user, top RETR_K, at each of RETR_BATCHES users; the fused path
    (``filtered_topk``, chained passes at k = 100) against the
    dot-scoring path.  Returns the fused path's launches per batch
    (counts set to 0 just before its first call, read just after)."""
    import numpy as np
    import torch

    from repro_torch import kernels as Kn
    from repro_torch.core import filters as F
    from repro_torch.core.router import compile_programs
    from repro_torch.models.recsys import retrieval_topk_filtered
    from repro_torch.parity import tie_free

    schema = F.paper_schema()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    items = torch.randn(RETR_N, RETR_D, generator=gen, device=dev)
    at = F.random_attributes(schema, RETR_N, seed=SEED + 1)
    ai = torch.as_tensor(at.ints, device=dev)
    af = torch.as_tensor(at.floats, device=dev)
    launches = {}
    for b in RETR_BATCHES:
        users = torch.randn(b, RETR_D, generator=gen, device=dev)
        flts, names = mixed_filters(F, schema, b)
        progs = compile_programs(flts, schema, b, device=dev)
        check(progs["valid"].shape == (b, RETR_W), "retrieval: W = 8 programs")
        args = (users, items, progs, ai, af)
        torch.cuda.synchronize()
        Kn.reset_launch_counts()
        ids_k, sc_k = retrieval_topk_filtered(*args, k=RETR_K, use_kernel=True)
        torch.cuda.synchronize()
        counts = {k: v for k, v in Kn.launch_counts.items() if v}
        launches[f"b{b}"] = counts.get("filtered_topk", 0)
        check(launches[f"b{b}"] >= 1,
              f"retrieval b={b}: filtered_topk launched: {counts}")
        ids_d, sc_d = retrieval_topk_filtered(*args, k=RETR_K + 1)
        ref_i, ref_s = ids_d.cpu().numpy(), sc_d.cpu().numpy()
        got_i, got_s = ids_k.cpu().numpy(), sc_k.cpu().numpy()
        fin = np.isfinite(ref_s[:, :RETR_K])
        # the dot path names failing items at -inf, the fused path -1
        free = tie_free(ref_s, rtol=0.0, atol=RETR_NEAR_TIE)[:, :RETR_K] & fin
        differ = got_i != ref_i[:, :RETR_K]
        check(np.array_equal(fin, np.isfinite(got_s)),
              f"retrieval b={b}: the same entries are missing")
        err = float(np.abs(got_s[fin] - ref_s[:, :RETR_K][fin]).max())
        check(not (differ & free).any() and err <= RETR_NEAR_TIE,
              f"retrieval b={b}: {int((differ & free).sum())} ids differ "
              f"outside near-ties, max |score diff| {err}")
        ms_kernel = cuda_ms(lambda: retrieval_topk_filtered(
            *args, k=RETR_K, use_kernel=True), repeats=5, warmup=1)
        ms_dot = cuda_ms(lambda: retrieval_topk_filtered(*args, k=RETR_K),
                         repeats=3, warmup=1)
        emit({"phase": "models", "part": "retrieval", "batch": b,
              "n": RETR_N, "d": RETR_D, "k": RETR_K, "w": RETR_W,
              "filters": sorted(set(names)),
              "launches": counts, "fused_ms": ms_kernel, "dot_ms": ms_dot,
              "max_abs_score_diff": err,
              "near_tie_positions": int((fin & ~free).sum()),
              "near_tie_id_swaps": int((differ & fin & ~free).sum()),
              "passing_min": int(fin.sum(axis=1).min())})
        del args, progs, users, ids_k, sc_k, ids_d, sc_d
    del items, ai, af
    free_card()
    return launches


def rs_batch(psyn, arch: str, cfg, b: int) -> dict:
    """A recsys batch of ``b`` rows from the port's ``RecsysPipeline``."""
    if arch == "dien":
        pipe = psyn.RecsysPipeline(n_sparse=0, vocab=cfg.vocab, batch=b,
                                   seq_len=cfg.seq_len, seed=SEED)
    elif arch == "dlrm-rm2":
        pipe = psyn.RecsysPipeline(n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                                   batch=b, n_dense=cfg.n_dense, seed=SEED)
    else:
        pipe = psyn.RecsysPipeline(n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                                   batch=b, seed=SEED)
    return pipe(0)[0]


def models_recsys(dev) -> None:
    """fm, wide-deep, dien and dlrm-rm2 at their published configs in f32:
    forward at each of RS_BATCHES rows, finite, the first RS_CHECK_ROWS
    rows held to the port's CPU run of the same function on a CPU copy of
    the weights."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.data import synthetic as psyn
    from repro_torch.models import module as Mm
    from repro_torch.models import recsys as R

    models = {"fm": (R.FM, ("ids",)), "wide-deep": (R.WideDeep, ("ids",)),
              "dien": (R.DIEN, ("hist", "target")),
              "dlrm-rm2": (R.DLRM, ("dense", "ids"))}
    for arch, (cls, keys) in models.items():
        cfg = get_spec(arch).config
        t0 = time.perf_counter()
        model = cls(cfg, seed=SEED, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params = model.tree()
        on_cpu = _tree_cpu(params)
        line = {"phase": "models", "part": "recsys", "arch": arch,
                "params": Mm.param_count(params),
                "param_gb": Mm.param_bytes(params) / 1e9, "init_s": init_s,
                "batches": {}}
        for b in RS_BATCHES:
            batch = rs_batch(psyn, arch, cfg, b)
            ins = [torch.as_tensor(batch[k], device=dev) for k in keys]
            torch.cuda.reset_peak_memory_stats()
            out = model(*ins)
            torch.cuda.synchronize()
            check(out.shape == (b,) and bool(torch.isfinite(out).all()),
                  f"{arch} b={b}: finite logits of shape ({b},)")
            ref = type(model)._forward(
                on_cpu, cfg, *[torch.as_tensor(batch[k][:RS_CHECK_ROWS])
                               for k in keys])
            err = float((out[:RS_CHECK_ROWS].cpu() - ref).abs().max())
            check(torch.allclose(out[:RS_CHECK_ROWS].cpu(), ref, rtol=RS_TOL,
                                 atol=RS_TOL),
                  f"{arch} b={b}: first {RS_CHECK_ROWS} rows vs CPU, "
                  f"max |diff| {err}")
            ms = cuda_ms(lambda: model(*ins), repeats=3, warmup=1)
            line["batches"][b] = {
                "ms": ms, "rows_per_s": b / ms * 1e3,
                "max_abs_diff_vs_cpu": err,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            del ins, out
        emit(line)
        del model, params, on_cpu
        free_card()


def _tree_cpu(tree):
    return {k: _tree_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def decode_vs_prefill(params, cfg, seq, s: int, steps: int) -> dict:
    """Teacher-forced over ``seq`` (B, s + steps): prefill of the first
    ``s`` tokens, then ``steps`` decode steps, each step's logits against a
    prefill over the tokens so far.  Per step: the relative RMS error over
    the vocabulary (all rows, and row by row), max |diff| and the rows
    whose top-1 token agrees."""
    from repro_torch.models import transformer as T

    logits, caches = T.prefill(params, cfg, seq[:, :s], s + steps)
    out = {"rel_rms": [], "rel_rms_by_row": [], "max_abs": [], "top1": 0}
    for t in range(steps):
        logits, caches = T.decode_step(params, cfg, seq[:, s + t:s + t + 1],
                                       caches, s + t)
        ref, _ = T.prefill(params, cfg, seq[:, :s + t + 1], s + t + 1)
        diff = logits - ref
        out["rel_rms"].append(float(diff.norm() / ref.norm()))
        out["rel_rms_by_row"].append(
            [round(float(x), 4) for x in diff.norm(dim=-1) / ref.norm(dim=-1)])
        out["max_abs"].append(float(diff.abs().max()))
        out["top1"] += int((logits.argmax(-1) == ref.argmax(-1)).sum())
        del ref
    out["top1"] = f"{out['top1']}/{seq.shape[0] * steps}"
    return out


def lm_serve(dev, arch: str, layers, b: int, s: int, steps: int) -> dict:
    """Greedy generation at the published width in bf16 (depth cut to
    ``layers`` where given): prefill of ``b`` random prompts of ``s``
    tokens, then ``steps`` decode steps, timed.

    Decode against prefill (``decode_vs_prefill``, teacher-forced on the
    generated tokens), twice: on the model as served (printed), and on its
    first layer alone (the same full-width weights; hard, relative RMS at
    most LM_DECODE_REL_RMS at every step).  Across layers the comparison
    is chaotic under the reference's init: its attention logits are in the
    hundreds (``fan_in_init`` reads the head count as the fan-in of a
    (d, heads, head_dim) weight) and its bf16 einsums round them to steps
    of 2 or more there, so the ulp-level differences of a one-row and a
    many-row matmul flip attention weights by e^2 and more, and the flips
    compound from layer to layer.

    An MoE model's static capacity (capacity_factor 1.25) drops the pairs
    over it in a long prefill, and a decode of b <= 8 tokens drops none
    (its capacity is 8 either way), so prefill and decode agree only
    without drops: the generation runs with the capacity of no dropped
    pair (capacity_factor = n_experts / top_k, the same decode), and the
    config's own prefill is timed beside it with its dropped share."""
    import dataclasses

    import torch

    from repro_torch.configs import get_spec
    from repro_torch.models import module as Mm
    from repro_torch.models import moe as Moe
    from repro_torch.models import transformer as T

    full = get_spec(arch).config
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    t0 = time.perf_counter()
    lm = T.LanguageModel(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = lm.tree()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    line = {"phase": "models", "part": "lm", "arch": arch,
            "layers": cfg.n_layers, "published_layers": full.n_layers,
            "params": Mm.param_count(params),
            "param_gb": Mm.param_bytes(params) / 1e9, "init_s": init_s,
            "batch": b, "prompt": s, "steps": steps}
    gen_cfg = cfg
    if cfg.moe is not None:
        m = cfg.moe
        gen_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
        check(Moe.moe_capacity(b, m) == Moe.moe_capacity(b, gen_cfg.moe) >= b,
              f"{arch}: a decode step of {b} tokens drops no pair")
    T.prefill(params, gen_cfg, prompt, s + steps)            # warm-up
    if cfg.moe is not None:
        _, aux = T.forward_train(params, cfg, prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.prefill(params, cfg, prompt, s + steps)
        torch.cuda.synchronize()
        line["config_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        line["config_prefill_dropped_frac"] = float(aux["dropped_frac"])
        line["generation_capacity_factor"] = gen_cfg.moe.capacity_factor
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = T.prefill(params, gen_cfg, prompt, s + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), f"{arch}: finite prefill logits")
    seq, step_s = prompt, []
    for t in range(steps):
        tok = logits.argmax(-1)[:, None]
        seq = torch.cat([seq, tok], dim=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = T.decode_step(params, gen_cfg, tok, caches, s + t)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()),
              f"{arch}: finite logits at decode step {t}")
    line["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del caches, logits
    decode_s = sum(step_s)
    line.update({
        "prefill_ms": prefill_s * 1e3,
        "prefill_tokens_per_s": b * s / prefill_s,
        "decode_ms_per_step": [x * 1e3 for x in step_s],
        "decode_tokens_per_s": b * steps / decode_s,
        "decode_vs_prefill": decode_vs_prefill(params, gen_cfg, seq, s,
                                               steps)})
    one = {**params, "layers": _first_layer(params["layers"])}
    line["decode_vs_prefill_layer0"] = decode_vs_prefill(
        one, dataclasses.replace(gen_cfg, n_layers=1), seq, s, steps)
    emit(line)
    worst = max(line["decode_vs_prefill_layer0"]["rel_rms"])
    check(worst <= LM_DECODE_REL_RMS,
          f"{arch}: layer-0 decode vs prefill relative RMS {worst}")
    del lm, params, one, seq
    free_card()
    return line


def _first_layer(tree: dict) -> dict:
    """The stacked (L, ...) layer tree cut to its first layer (views)."""
    return {k: _first_layer(v) if isinstance(v, dict) else v[:1]
            for k, v in tree.items()}


def lm_f32_vs_cpu(dev) -> dict:
    """An f32 copy of LM_F32's arch at full width and LM_F32_LAYERS layers
    on a LM_F32_PROMPT-token prompt, TF32 off, against the port's CPU run
    on the same weights: prefill logits (LM_F32_TOL) and its bf16 caches
    (LM_F32_TOL plus one bf16 ulp: keys that differ in f32 may round to
    neighbouring bf16 values), then one decode step from the same caches
    on both sides (LM_F32_TOL)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_spec
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_spec(LM_F32).config,
                              n_layers=LM_F32_LAYERS)
    lm = T.LanguageModel(cfg, seed=SEED, dtype=torch.float32, device=dev)
    params = lm.tree()
    on_cpu = _tree_cpu(params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab, (2, LM_F32_PROMPT), generator=gen,
                           device=dev)
    lg, cg = lm.prefill(prompt, LM_F32_PROMPT + 1)
    lc, cc = T.prefill(on_cpu, cfg, prompt.cpu(), LM_F32_PROMPT + 1)
    flips, cache_err = 0, 0.0
    for key in ("k", "v"):
        a, c = cg[key].float().cpu(), cc[key].float()
        ulp = torch.exp2(torch.floor(torch.log2(c.abs())) - 7)
        excess = float(((a - c).abs() - ulp).max())
        check(excess <= LM_F32_TOL,
              f"{LM_F32} f32 {key} cache vs CPU: within {LM_F32_TOL} plus "
              f"one bf16 ulp (excess {excess})")
        flips += int((a != c).sum())
        cache_err = max(cache_err, float((a - c).abs().max()))
    tok = lc.argmax(-1)[:, None]
    same = {key: v.cpu().clone() for key, v in cg.items()}
    dg, _ = lm.decode_step(tok.to(dev), cg, LM_F32_PROMPT)
    dc, _ = T.decode_step(on_cpu, cfg, tok, same, LM_F32_PROMPT)
    errs = {"prefill": float((lg.cpu() - lc).abs().max()),
            "decode": float((dg.cpu() - dc).abs().max())}
    for name, (a, c) in {"prefill": (lg, lc), "decode": (dg, dc)}.items():
        check(torch.allclose(a.cpu(), c, rtol=LM_F32_TOL, atol=LM_F32_TOL),
              f"{LM_F32} f32 {name} vs CPU: max |diff| {errs[name]}")
    line = {"phase": "models", "part": "lm_f32_vs_cpu", "arch": LM_F32,
            "layers": LM_F32_LAYERS, "prompt": LM_F32_PROMPT,
            "max_abs_diff": errs, "cache_max_abs_diff": cache_err,
            "cache_entries_apart": flips,
            "cache_entries": int(cg["k"].numel() * 2), "tol": LM_F32_TOL}
    emit(line)
    del lm, params, on_cpu, cg, cc, same
    free_card()
    return line


def models_gcn(dev) -> None:
    """gcn-cora at Cora's size and the molecule cell's block-diagonal batch
    with a graph readout, each against the port's CPU run."""
    import dataclasses

    import torch

    from repro_torch.configs import get_spec
    from repro_torch.data import synthetic as psyn
    from repro_torch.models import gnn as G

    spec = get_spec("gcn-cora")
    cora, mol = spec.cell("full_graph_sm").meta, spec.cell("molecule").meta
    cases = {
        "full_graph_sm": (spec.config, psyn.make_random_graph(
            cora["n_nodes"], cora["n_edges"] // 2, cora["d_feat"],
            spec.config.n_classes, seed=SEED), {}),
        "molecule": (dataclasses.replace(
            spec.config, d_feat=mol["d_feat"], n_classes=2, readout="graph"),
            psyn.make_molecule_batch(mol["batch"], mol["n_nodes"],
                                     mol["n_edges"], mol["d_feat"], seed=SEED),
            {"n_graphs": mol["batch"]}),
    }
    for cell, (cfg, g, kw) in cases.items():
        model = G.GCN(cfg, seed=SEED, device=dev)
        keys = ("x", "edges", "deg")
        ins = [torch.as_tensor(g[k], device=dev) for k in keys]
        if kw:
            kw = {**kw, "graph_ids": torch.as_tensor(g["graph_ids"],
                                                     device=dev)}
        out = model(*ins, **kw)
        ref = G.gcn_forward(_tree_cpu(model.tree()), cfg,
                            *[torch.as_tensor(g[k]) for k in keys],
                            **{k: (v.cpu() if torch.is_tensor(v) else v)
                               for k, v in kw.items()})
        err = float((out.cpu() - ref).abs().max())
        check(bool(torch.isfinite(out).all()) and torch.allclose(
            out.cpu(), ref, rtol=GCN_TOL, atol=GCN_TOL),
            f"gcn {cell}: vs CPU, max |diff| {err}")
        emit({"phase": "models", "part": "gcn", "cell": cell,
              "nodes": int(g["x"].shape[0]),
              "edges_with_self_loops": int(g["edges"].shape[1]),
              "d_feat": cfg.d_feat, "out": list(out.shape),
              "max_abs_diff_vs_cpu": err,
              "ms": cuda_ms(lambda: model(*ins, **kw), repeats=10)})


def phase_models(dev) -> dict:
    """The model zoo at its published widths, random weights from SEED:
    the recsys retrieval layer on ``filtered_topk`` (dlrm-rm2's
    retrieval_cand cell at batch 1 and serve_p99's 512), the four recsys
    models' forward at serve_p99 and serve_bulk, greedy generation through
    ``prefill`` / ``decode_step`` for the five LMs (bf16; depth cut where
    one card's memory or the phase's budget needs it) plus an f32 copy of
    gemma2-2b against the CPU, and gcn-cora's Cora-size and molecule
    cells.  Returns ``filtered_topk``'s launches per retrieval batch."""
    t_phase = time.perf_counter()
    free_card()
    launches = models_retrieval(dev)
    models_recsys(dev)
    for arch, (layers, b, s, steps) in LM_SERVE.items():
        lm_serve(dev, arch, layers, b, s, steps)
    lm_f32_vs_cpu(dev)
    models_gcn(dev)
    emit({"phase": "models", "part": "done",
          "phase_s": time.perf_counter() - t_phase,
          "budget_s": MODELS_BUDGET_S})
    return launches


# ---------------------------------------------------------------------------
# The train phase: the port's training at published widths on the card
# ---------------------------------------------------------------------------
def _sync_s(fn):
    """Host seconds of ``fn()`` between two device syncs, and its result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def train_lm_full(dev) -> dict:
    """TRAIN_ARCH at its published width and depth: bf16 parameters, f32
    AdamW moments, ``remat`` (each layer recomputed in the backward pass),
    TRAIN_BATCH x TRAIN_SEQ tokens a step from ``TokenPipeline``, the same
    batch TRAIN_STEPS times.  Step ms (median of steps 2..), tokens/s, model
    TFLOP/s (6 N_active tokens / step s) and its share of the bf16 peak,
    the dry run's meta count of the same step, peak GB.  Hard: every loss
    and grad norm finite, the last loss below the first."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import synthetic as psyn
    from repro_torch.launch import cells as LC
    from repro_torch.launch import dryrun as LD
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import module as Mm
    from repro_torch.models import transformer as T
    from repro_torch.roofline import hw
    from repro_torch.training import optimizer as opt
    from repro_torch.training.step import make_train_step

    spec = get_spec(TRAIN_ARCH)
    cfg = spec.config
    check(cfg.remat and cfg.param_dtype == "bfloat16",
          f"{TRAIN_ARCH}: the published config trains bf16 with remat")
    # the dry run's count of this step (batch cut as here) on meta tensors
    cell = LC.build_lm_cell(spec, ShapeCell(
        "train_4k", "train", {"seq": TRAIN_SEQ, "batch": TRAIN_BATCH}),
        make_test_mesh(1, 1))
    t0 = time.perf_counter()
    cost, off_meta = LD.count_step(cell.step_fn, cell.args)
    count_s = time.perf_counter() - t0
    check(not any(d.startswith("cuda") for d in off_meta)
          and LD.off_meta_bytes(off_meta) == 0,
          f"the dry run allocated nothing: {off_meta}")
    del cell

    free_card()
    torch.cuda.reset_peak_memory_stats()
    init_s, (params, _) = _sync_s(lambda: Mm.init_with_axes(
        T.init_lm, SEED, cfg, dtype=torch.bfloat16, device=dev))
    ocfg = opt.OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=100)
    state = opt.init_opt_state(params, ocfg)
    batch = psyn.TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               batch=TRAIN_BATCH, seed=SEED)(0)[0]
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev)
    step = make_train_step(
        lambda p, b: T.lm_loss(p, cfg, b["tokens"], b["labels"]), ocfg)
    losses, norms, step_s = [], [], []
    for _ in range(TRAIN_STEPS):
        dt, (params, state, m) = _sync_s(lambda: step(
            params, state, {"tokens": tokens, "labels": labels}))
        step_s.append(dt)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(step_s[1:]) * 1e3
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    model_flops = 6.0 * cfg.active_param_count() * n_tok
    tflops = model_flops / (ms / 1e3) / 1e12
    line = {"phase": "train", "part": "lm", "arch": TRAIN_ARCH,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "params": Mm.param_count(params),
            "param_gb": Mm.param_bytes(params) / 1e9, "dtype": "bfloat16",
            "moments": "float32 AdamW", "remat": cfg.remat,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
            "init_s": init_s, "steps": TRAIN_STEPS, "loss": losses,
            "grad_norm": norms, "step_ms": [x * 1e3 for x in step_s],
            "step_ms_median_2_on": ms, "tokens_per_s": n_tok / (ms / 1e3),
            "model_tflops_per_s": tflops,
            "peak_bf16_share": tflops * 1e12 / hw.PEAK_FLOPS_BF16,
            "peak_gb": peak_gb,
            "dry_run": {"flops": cost.flops, "bytes": cost.bytes_accessed,
                        "model_flops": model_flops,
                        "useful_flops_frac": model_flops / cost.flops,
                        "t_compute_ms": cost.flops / hw.PEAK_FLOPS_BF16 * 1e3,
                        "t_memory_ms": cost.bytes_accessed / hw.HBM_BW * 1e3,
                        "count_s": count_s, "off_meta_ops": off_meta}}
    line["dry_run"]["measured_over_bound"] = ms / max(
        line["dry_run"]["t_compute_ms"], line["dry_run"]["t_memory_ms"])
    emit(line)
    check(all(map(math.isfinite, losses + norms)),
          f"{TRAIN_ARCH}: finite losses and grad norms {losses} {norms}")
    check(losses[-1] < losses[0],
          f"{TRAIN_ARCH}: the last loss below the first {losses}")
    del params, state, tokens, labels, step
    free_card()
    return line


def train_rs_gcn_full(dev) -> dict:
    """dlrm-rm2's train_batch (65,536 rows, its published tables) and
    gcn-cora's full_graph_sm (Cora's size) train steps in f32 under the
    cells' AdamW: ms a step (median after the first) and rows/s, finite
    losses."""
    import dataclasses

    import torch

    from repro_torch.configs import get_spec
    from repro_torch.data import synthetic as psyn
    from repro_torch.models import gnn as G
    from repro_torch.models import module as Mm
    from repro_torch.models import recsys as R
    from repro_torch.training import optimizer as opt
    from repro_torch.training.step import make_train_step

    out = {}
    spec = get_spec(RS_TRAIN_ARCH)
    cfg = spec.config
    rows = spec.cell("train_batch").meta["batch"]
    free_card()
    torch.cuda.reset_peak_memory_stats()
    params, _ = Mm.init_with_axes(R.init_dlrm, SEED, cfg, device=dev)
    b = rs_batch(psyn, RS_TRAIN_ARCH, cfg, rows)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    ocfg = opt.OptConfig(total_steps=10000)
    state = opt.init_opt_state(params, ocfg)
    step = make_train_step(lambda p, bb: R.dlrm_loss(
        p, cfg, bb["dense"], bb["ids"], bb["labels"]), ocfg)
    times, losses = [], []
    for _ in range(RS_TRAIN_STEPS):
        dt, (params, state, m) = _sync_s(lambda: step(params, state, batch))
        times.append(dt)
        losses.append(float(m["loss"]))
    ms = statistics.median(times[1:]) * 1e3
    out[RS_TRAIN_ARCH] = {
        "cell": "train_batch", "rows": rows,
        "params": Mm.param_count(params),
        "param_gb": Mm.param_bytes(params) / 1e9, "loss": losses,
        "step_ms": [x * 1e3 for x in times], "ms": ms,
        "rows_per_s": rows / (ms / 1e3),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(all(map(math.isfinite, losses)),
          f"{RS_TRAIN_ARCH} train_batch: finite losses {losses}")
    del params, state, batch, step
    free_card()

    gspec = get_spec("gcn-cora")
    cora = gspec.cell("full_graph_sm").meta
    gcfg = dataclasses.replace(gspec.config, d_feat=cora["d_feat"])
    g = psyn.make_random_graph(cora["n_nodes"], cora["n_edges"] // 2,
                               cora["d_feat"], gcfg.n_classes, seed=SEED)
    gb = {k: torch.as_tensor(v, device=dev) for k, v in g.items()}
    params, _ = Mm.init_with_axes(G.init_gcn, SEED, gcfg, device=dev)
    ocfg = opt.OptConfig(total_steps=1000)
    state = opt.init_opt_state(params, ocfg)
    step = make_train_step(lambda p, bb: G.gcn_loss(
        p, gcfg, bb["x"], bb["edges"], bb["deg"], bb["labels"], bb["mask"]),
        ocfg)
    times, losses = [], []
    for _ in range(GCN_TRAIN_STEPS):
        dt, (params, state, m) = _sync_s(lambda: step(params, state, gb))
        times.append(dt)
        losses.append(float(m["loss"]))
    ms = statistics.median(times[1:]) * 1e3
    out["gcn-cora"] = {"cell": "full_graph_sm", "nodes": cora["n_nodes"],
                       "edges_with_self_loops": int(g["edges"].shape[1]),
                       "loss": losses, "ms": ms,
                       "rows_per_s": cora["n_nodes"] / (ms / 1e3)}
    check(all(map(math.isfinite, losses)),
          f"gcn-cora full_graph_sm: finite losses {losses}")
    emit({"phase": "train", "part": "recsys_gcn", **out})
    del params, state, gb, step
    free_card()
    return out


def _max_rel(ref: dict, got: dict) -> dict:
    """{leaf path: max |got - ref| over max |ref|} (the CPU parity bar's
    form), ``got`` read to the CPU."""
    from repro_torch.training.checkpoint import _flatten
    from repro_torch.training.optimizer import tree_map
    return _flatten(tree_map(
        lambda r, g: float((g.cpu().double() - r.double()).abs().max() /
                           max(float(r.abs().max()), 1e-30)), ref, got))


def train_card_vs_cpu(dev) -> dict:
    """The reduced gemma2-2b and dlrm-rm2 in f32 (TF32 off) on the card and
    on the CPU from the same weights and batch: each gradient leaf within
    the CPU parity bar (1e-4 / 1e-5 of the leaf's max |g|), then
    TRAIN_CPU_STEPS SGDM steps, parameters within 1e-5."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.data import synthetic as psyn
    from repro_torch.models import module as Mm
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt
    from repro_torch.training.step import loss_and_grads, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm = get_spec(TRAIN_ARCH).reduced
    rs = get_spec(RS_TRAIN_ARCH).reduced
    cases = {
        TRAIN_ARCH: (T.init_lm, lm, lambda p, b: T.lm_loss(
            p, lm, b["tokens"], b["labels"]),
            psyn.TokenPipeline(vocab=lm.vocab, seq_len=64, batch=4,
                               seed=SEED)(0)[0], TRAIN_LM_TOL),
        RS_TRAIN_ARCH: (R.init_dlrm, rs, lambda p, b: R.dlrm_loss(
            p, rs, b["dense"], b["ids"], b["labels"]),
            rs_batch(psyn, RS_TRAIN_ARCH, rs, 256), TRAIN_RS_TOL),
    }
    out = {}
    for arch, (init, cfg, loss_fn, batch, tol) in cases.items():
        cpu_p, _ = Mm.init_with_axes(init, SEED, cfg, device="cpu")
        card_p = opt.tree_map(lambda t: t.to(dev, copy=True), cpu_p)
        cpu_b = {k: torch.as_tensor(v) for k, v in batch.items()}
        card_b = {k: v.to(dev) for k, v in cpu_b.items()}
        lc, _, gc = loss_and_grads(loss_fn, cpu_p, cpu_b)
        lg, _, gg = loss_and_grads(loss_fn, card_p, card_b)
        grad_rel = _max_rel(gc, gg)
        ocfg = opt.OptConfig(lr=TRAIN_CPU_LR, kind="sgdm", warmup_steps=1,
                             total_steps=10)
        step = make_train_step(loss_fn, ocfg)
        sc, sg = opt.init_opt_state(cpu_p, ocfg), opt.init_opt_state(card_p,
                                                                      ocfg)
        losses = []
        for _ in range(TRAIN_CPU_STEPS):
            cpu_p, sc, mc = step(cpu_p, sc, cpu_b)
            card_p, sg, mg = step(card_p, sg, card_b)
            losses.append((float(mc["loss"]), float(mg["loss"])))
        # rtol = atol = 1e-5: |card - cpu| - 1e-5 |cpu| at most 1e-5
        param_err = max(float(((g.cpu() - c).abs() - 1e-5 * c.abs()).max())
                        for c, g in zip(opt.tree_leaves(cpu_p),
                                        opt.tree_leaves(card_p)))
        out[arch] = {"loss_cpu": float(lc), "loss_card": float(lg),
                     "grad_max_rel": max(grad_rel.values()),
                     "grad_worst_leaf": max(grad_rel, key=grad_rel.get),
                     "grad_tol": tol, "sgdm_losses_cpu_card": losses,
                     "param_abs_err_beyond_rtol": param_err}
        check(max(grad_rel.values()) <= tol,
              f"{arch} card vs CPU gradients: {grad_rel}")
        check(param_err <= 1e-5,
              f"{arch} card vs CPU after {TRAIN_CPU_STEPS} SGDM steps: "
              f"excess {param_err}")
    emit({"phase": "train", "part": "card_vs_cpu", **out})
    free_card()
    return out


def train_checkpoint_round_trip(dev) -> dict:
    """The reduced gemma2-2b in f32 under AdamW on the card: two steps, the
    state saved from CUDA tensors (``training.checkpoint``), restored onto
    the card, one more step -- bit-equal to three uninterrupted steps
    (parameters, both moments, the step counter)."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.data import synthetic as psyn
    from repro_torch.models import module as Mm
    from repro_torch.models import transformer as T
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training.step import make_train_step

    cfg = get_spec(TRAIN_ARCH).reduced
    pipe = psyn.TokenPipeline(vocab=cfg.vocab, seq_len=64, batch=4, seed=SEED)
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    step = make_train_step(lambda p, b: T.lm_loss(
        p, cfg, torch.as_tensor(b["tokens"], device=dev),
        torch.as_tensor(b["labels"], device=dev)), ocfg)

    def fresh():
        p, _ = Mm.init_with_axes(T.init_lm, SEED, cfg, device=dev)
        return {"params": p, "opt": opt.init_opt_state(p, ocfg),
                "data_state": 0}

    def run(state, n):
        for _ in range(n):
            batch, state["data_state"] = pipe(state["data_state"])
            state["params"], state["opt"], _ = step(state["params"],
                                                    state["opt"], batch)
        return state

    straight = run(fresh(), 3)
    tmp = Path(tempfile.mkdtemp(prefix=".smoke-ckpt-", dir=ROOT))
    try:
        half = run(fresh(), 2)
        ckpt.save(str(tmp), 2, half)
        restored, meta = ckpt.restore(str(tmp),
                                      shardings=ckpt.device_tree(half))
        resumed = run(restored, 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a = opt.tree_leaves(straight["params"]) + opt.tree_leaves(
        straight["opt"].mu) + opt.tree_leaves(straight["opt"].nu)
    b = opt.tree_leaves(resumed["params"]) + opt.tree_leaves(
        resumed["opt"].mu) + opt.tree_leaves(resumed["opt"].nu)
    same = all(x.device == y.device and torch.equal(x, y)
               for x, y in zip(a, b))
    line = {"phase": "train", "part": "checkpoint", "arch": TRAIN_ARCH,
            "config": "reduced f32", "saved_step": meta["step"],
            "leaves": len(a), "bit_equal": same,
            "opt_step": int(resumed["opt"].step),
            "restored_device": str(opt.tree_leaves(
                restored["params"])[0].device)}
    emit(line)
    check(isinstance(resumed["opt"], opt.OptState) and same and
          int(resumed["opt"].step) == int(straight["opt"].step) == 3,
          "checkpoint round trip on the card: bit-equal to an "
          "uninterrupted run")
    free_card()
    return line


def phase_train(dev) -> dict:
    """The port's training on the card: TRAIN_ARCH at its published width
    and depth (bf16, AdamW, remat), dlrm-rm2's train_batch and gcn-cora's
    full_graph_sm at full size, the reduced gemma2-2b and dlrm-rm2 against
    the CPU, and a checkpoint round trip.  No kernel of the port is on this
    path."""
    t_phase = time.perf_counter()
    out = {"lm": train_lm_full(dev), "recsys_gcn": train_rs_gcn_full(dev),
           "card_vs_cpu": train_card_vs_cpu(dev),
           "checkpoint": train_checkpoint_round_trip(dev)}
    emit({"phase": "train", "part": "done",
          "phase_s": time.perf_counter() - t_phase,
          "budget_s": TRAIN_BUDGET_S})
    return out


# ---------------------------------------------------------------------------
# The dryrun phase: favor-anns' serve_graph cell counted on the card
# ---------------------------------------------------------------------------
def phase_dryrun(dev) -> dict:
    """favor-anns' ``serve_graph`` cell and its three perf variants
    (``launch.perf_run``'s favor_sample4k, favor_ccap256, favor_n16m),
    each counted on one mesh cell's block of real tensors on the card at
    the published widths (4M rows -- 1M for favor_n16m -- x 64 queries,
    d = 128, ef = 128) from the seed: record ok, waves > 0, the count's
    ``gather_distance`` calls > 0 and equal to the kernel's launches in
    the run (hard); the record's collective link bytes equal the analytic
    sum of the estimate's all-reduces and the merge's all-gathers at the
    block's queries and k over the production mesh's model axis of 16
    (hard); the counted step's ids and distances equal an uncounted run's
    of the same block (hard); a small block (the CPU tests' size: 1,024
    rows x 4 queries, d = 16), its data drawn on the host, counted the same
    on the card as on the CPU (hard); and one partitioned meta count of the
    reduced gemma2-2b ``train_4k`` cell on a fake (2, 4) process group:
    it counts, charges collectives, allocates nothing, and leaves no
    process group behind (hard)."""
    import dataclasses

    import torch

    from repro_torch import kernels as Kn
    from repro_torch.configs import get_spec
    from repro_torch.launch import cells as LC
    from repro_torch.launch import dryrun as LD
    from repro_torch.launch import perf_run as LP
    from repro_torch.launch.mesh import make_test_mesh

    t_phase = time.perf_counter()
    runs = {"serve_graph": None}
    runs.update({name: LP.EXPERIMENTS[name]["mk"]() for name in
                 ("favor_sample4k", "favor_ccap256", "favor_n16m")})
    out = {}
    for name, builder in runs.items():
        free_card()
        keep = {}
        Kn.reset_launch_counts()
        t0 = time.perf_counter()
        rec = LD.run_cell("favor-anns", "serve_graph", False,
                          builder=builder, device=dev, seed=SEED, keep=keep)
        wall = time.perf_counter() - t0
        launches = Kn.launch_counts["gather_distance"]
        check(rec["ok"], f"dryrun {name}: {rec.get('error')}")
        b, r = rec["block"], rec["roofline"]
        gd = rec["count"]["kernels"].get("gather_distance", {})
        line = {"phase": "dryrun", "run": name, "wall_s": wall,
                "make_s": rec["lower_s"], "count_s": rec["compile_s"],
                "block": b, "launches": dict(Kn.launch_counts),
                "t_compute_s": r["t_compute_s"],
                "t_memory_s": r["t_memory_s"], "bottleneck": r["bottleneck"],
                "flops": r["flops_per_dev"], "bytes": r["hbm_bytes_per_dev"],
                "count": rec["count"], "note": rec["note"]}
        check(b["waves"] > 0 and gd.get("calls", 0) > 0
              and launches == gd["calls"],
              f"dryrun {name}: waves {b['waves']}, gather_distance counted "
              f"{gd.get('calls')} against {launches} launches")
        # per device over the production mesh's model axis (16): the (q,)
        # f32 counts and the f32 size all-reduced, the (q, k) f32 distances
        # and int64 ids all-gathered
        prod = LD.make_production_mesh()
        g = dict(zip(prod.axis_names, prod.devices.shape))["model"]
        q, k = b["queries"], b["k"]
        want = (2 * (g - 1) / g * (4 * q + 4)) + (g - 1) * q * k * (4 + 8)
        line.update(t_collective_s=r["t_collective_s"],
                    coll_link_bytes=r["coll_link_bytes"],
                    coll_link_bytes_analytic=want,
                    collectives=r["collectives"])
        check(math.isclose(r["coll_link_bytes"], want, rel_tol=1e-12),
              f"dryrun {name}: link bytes {r['coll_link_bytes']} against "
              f"the analytic {want}")
        if name == "serve_graph":
            block, c = keep["block"], keep["count"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, dists = block.step_fn(*block.args)
            torch.cuda.synchronize()
            line["uncounted_step_s"] = time.perf_counter() - t0
            check(bool(torch.equal(ids, c.out[0])
                       and torch.equal(dists, c.out[1])),
                  "dryrun: the counted step's ids and distances equal an "
                  "uncounted run's")
            del block, c, ids, dists
        del keep
        emit(line)
        out[name] = line

    spec = get_spec("favor-anns")
    small = LC.favor_cell(dataclasses.replace(spec.reduced, batch=8),
                          "serve_graph", "graph", make_test_mesh())
    card, c_card, _ = LD.count_block(small, dev, SEED, data_device="cpu")
    cpu, c_cpu, _ = LD.count_block(small, "cpu", SEED)
    same = (c_card.cost == c_cpu.cost and c_card.kernels == c_cpu.kernels
            and card["count"]["parts"] == cpu["count"]["parts"]
            and card["block"]["waves"] == cpu["block"]["waves"])
    emit({"phase": "dryrun", "run": "small_block_card_vs_cpu",
          "block": {k: card["block"][k] for k in ("rows", "queries", "waves")},
          "card": {"flops": c_card.cost.flops,
                   "bytes": c_card.cost.bytes_accessed,
                   "parts": card["count"]["parts"]},
          "cpu": {"flops": c_cpu.cost.flops,
                  "bytes": c_cpu.cost.bytes_accessed,
                  "parts": cpu["count"]["parts"],
                  "waves": cpu["block"]["waves"]},
          "same": same})
    check(same, "dryrun: the card's count of the small block equals the "
          "CPU's")

    # the partitioned count: a reduced LM train cell on a fake (2, 4) group
    lm = get_spec("gemma2-2b")
    mesh = make_test_mesh()
    cell = LC.build_lm_cell(dataclasses.replace(lm, config=lm.reduced),
                            lm.cell("train_4k"), mesh)
    t0 = time.perf_counter()
    part = LD.count(cell.step_fn, cell.args, shardings=cell.in_shardings,
                    mesh=mesh)
    count_s = time.perf_counter() - t0
    left = torch.distributed.is_initialized()
    pc = part.cost
    emit({"phase": "dryrun", "run": "partitioned_reduced_lm_train",
          "mesh": "2x4", "torch": torch.__version__, "count_s": count_s,
          "flops": pc.flops, "bytes": pc.bytes_accessed,
          "coll_link_bytes": pc.coll_link_bytes,
          "collectives": pc.collectives, "temp_bytes": pc.temp_bytes,
          "argument_bytes": pc.argument_bytes,
          "replicated_ops": part.replicated, "split_by_rule": part.split,
          "off_meta_bytes": LD.off_meta_bytes(part.off_meta),
          "group_left": left})
    check(sum(pc.collectives["counts"].values()) > 0
          and pc.coll_link_bytes > 0,
          f"dryrun: the partitioned count charges collectives: "
          f"{pc.collectives}")
    check(LD.off_meta_bytes(part.off_meta) == 0,
          f"dryrun: the partitioned count allocated nothing: {part.off_meta}")
    check(not left, "dryrun: no process group outlives the count")
    del cell, part
    free_card()
    emit({"phase": "dryrun", "part": "done",
          "phase_s": time.perf_counter() - t_phase,
          "budget_s": DRYRUN_BUDGET_S, "card": nvidia_smi_line()})
    return out


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
    tmp = Path(tempfile.mkdtemp(prefix=".smoke-index-", dir=ROOT))
    try:
        saved = tmp / "serve"
        launches, widths = phase_serve(dev, saved)
        phase_widths(rates, kernels, gathers, widths)
        del gathers
        torch.cuda.empty_cache()
        engine_launches = phase_engine(dev, saved)
        frontend_launches = phase_frontend(dev, saved)
        sharded_launches = phase_sharded(dev, saved)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    models_launches = phase_models(dev)
    phase_train(dev)
    phase_dryrun(dev)
    # each kernel's launches on the pass of the main path that runs it, and
    # on the serving engine's run that drives it
    main_pass = {"filtered_topk": "f32", "gather_distance": "f32",
                 "pq_adc_topr": "use_pq", "pq_adc_gather": "use_pq+graph_pq"}
    for kname, pass_ in main_pass.items():
        kernels[kname]["launches"] = launches[pass_][kname]
        kernels[kname]["engine_launches"] = engine_launches[kname]
        kernels[kname]["frontend_launches"] = {
            p: frontend_launches[kname][p][kname] for p in ("cold", "warm")}
        kernels[kname]["sharded_launches"] = sharded_launches[kname][kname]
    kernels["filtered_topk"]["models_launches"] = models_launches
    emit({"kernels": [{k: v for k, v in row.items() if k != "shape"}
                      for row in kernels.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
