#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port of FAVOR on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

  build    compile the CUDA kernels from repro_torch/csrc with nvcc (one
           process per source, all started together) and load them;
  kernels  each kernel at one card's deployment scale -- 4,000,000 rows x
           d = 128 f32 (favor-anns' 64M rows over its 16 model shards) with
           the paper schema's attributes, 1024 queries -- held against its
           plain PyTorch version and timed with CUDA events beside its bound;
  serve    FavorIndex.build on a synthetic paper dataset (HNSW M=16, host
           build), then FavorIndex.query for a batch of 1024 filtered
           queries over the six paper scenarios and a < 1 % filter, so both
           routes run; launch counters show the batch went through both
           kernels; results are checked against exact filtered ground truth
           (plain brute version on the card) and against the port's own CPU
           path on a query subset.

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
# limit), used for the bound of each kernel: f32 outside the tensor cores.
RATES = {"SXM": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12},
         "PCIe": {"hbm_bytes_per_s": 2.0e12, "f32_flops": 51e12}}
# kernel vs plain version: the kernel's 128-term dot is one FMA chain, the
# plain version's a cuBLAS / tree reduction, so distances differ in the last
# f32 bits of the squared form; ids must agree wherever distances are apart
RTOL = ATOL = 1e-5
K, EF, M0 = 10, 128, 32
DB_ROWS = 4_000_000    # kernels phase: one card's share of favor-anns
SERVE_N = 16384        # serve phase: rows of the host-built HNSW index
BATCH = 1024           # queries per batch (favor-anns' serve batch)
REPEATS = 10           # timed kernel runs (median)
SERVE_REPEATS = 5      # timed query batches
SEED = 0


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
    flts, _ = mixed_filters(F, schema, b)
    progs = compile_programs(flts, schema, b, device=dev)
    dvec = torch.as_tensor(rng.uniform(0.5, 3.0, size=b).astype(np.float32),
                           device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mi, mf = attrs.ints.shape[1], attrs.floats.shape[1]
    rates_used = {"hbm_bytes_per_s": rates["hbm_bytes_per_s"],
                  "f32_flops": rates["f32_flops"]}

    # -- filtered_topk: PreFBF mode through prefbf_topk (the brute route),
    #    and exclusion mode; compared on a 64-query subset ----------------
    out = {}
    sub = slice(0, 64)
    sub_progs = {k: v[sub].contiguous() for k, v in progs.items()}
    errs = []
    for mode, exclude in (("prefbf", False), ("exclusion", True)):
        kid, kd = ft.filtered_topk(pv, pn, pi, pf, qs[sub].contiguous(),
                                   sub_progs, k=K, dvec=dvec[sub].contiguous(),
                                   exclude=exclude)
        pid, pd = ft.filtered_topk_plain(pv, pn, pi, pf, qs[sub], sub_progs,
                                         k=K, dvec=dvec[sub], exclude=exclude)
        m = topk_mismatch(pid.cpu().numpy(), pd.cpu().numpy(),
                          kid.cpu().numpy(), kd.cpu().numpy(), RTOL, ATOL)
        check(m["dist_mismatch"] == 0 and m["id_mismatch"] == 0,
              f"filtered_topk ({mode}) vs plain: {m}")
        if not exclude:
            check(int(kid.max()) < n, "filtered_topk returned a pad row")
        errs.append(m["max_abs_diff"])
        out[mode] = m
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
    ft_ops = 2 * b * n * d
    ft_bound = 1e3 * max(ft_bytes / rates["hbm_bytes_per_s"],
                         ft_ops / rates["f32_flops"])
    kernels = {"filtered_topk": {
        "name": "filtered_topk", "route": "cuda",
        "source": "src/repro_torch/csrc/filtered_topk.cu",
        "replaces": "src/repro/kernels/filtered_topk/kernel.py:109",
        "max_abs_err": max(errs), "ms": ms, "ms_exclusion": ms_excl,
        "plain_ms": plain_ms, "bound_ms": ft_bound,
        "bound_by": ("operations" if ft_ops / rates["f32_flops"]
                     >= ft_bytes / rates["hbm_bytes_per_s"] else "bytes"),
        "library_ms": None,
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
    gd_call_ms = cuda_ms(lambda: gd.gather_distance(pv, pn, pi, pf, qs, ids_t,
                                                    progs, dvec),
                         repeats=2 * REPEATS, flush=flush)
    gd_ms = graph_ms(lambda: gd.gather_distance(pv, pn, pi, pf, qs, ids_t,
                                                progs, dvec),
                     repeats=2 * REPEATS, flush=flush)
    gd_plain_ms = graph_ms(lambda: gd.gather_distance_plain(
        pv, pn, pi, pf, qs, ids_t, progs, dvec), repeats=10, flush=flush)
    n_valid = int((ids >= 0).sum())
    gd_bytes = (n_valid * row_bytes + ids.size * 4 + b * d * 4 + prog_bytes
                + b * 4 + ids.size * 8)
    gd_ops = 2 * n_valid * d
    gd_bound = 1e3 * max(gd_bytes / rates["hbm_bytes_per_s"],
                         gd_ops / rates["f32_flops"])
    kernels["gather_distance"] = {
        "name": "gather_distance", "route": "cuda",
        "source": "src/repro_torch/csrc/gather_distance.cu",
        "replaces": "src/repro/kernels/gather_distance/kernel.py:63",
        "max_abs_err": gd_err, "ms": gd_ms, "call_ms": gd_call_ms,
        "plain_ms": gd_plain_ms,
        "bound_ms": gd_bound,
        "bound_by": ("operations" if gd_ops / rates["f32_flops"]
                     >= gd_bytes / rates["hbm_bytes_per_s"] else "bytes"),
        "library_ms": None,
        "shape": {"B": b, "M0": M0, "N": n, "d": d, "valid_ids": n_valid},
    }
    emit({"phase": "kernels", "setup_s": setup_s, "rates": rates_used,
          "filtered_topk": {k: v for k, v in kernels["filtered_topk"].items()
                            if k != "name"} | {"vs_plain": out},
          "gather_distance": {k: v for k, v in
                              kernels["gather_distance"].items()
                              if k != "name"},
          "launches_outside_main_path": dict(Kn.launch_counts)})
    del pv, pn, pi, pf, scratch
    torch.cuda.empty_cache()
    return kernels


def phase_serve(dev):
    import numpy as np
    import torch

    from repro_torch import kernels as Kn
    from repro_torch.core import FavorIndex, HnswParams, SearchOptions
    from repro_torch.core import filters as F
    from repro_torch.core import refimpl
    from repro_torch.data import synthetic
    from repro_torch.kernels.filtered_topk import ops as ft
    from repro_torch.parity import topk_mismatch

    n, d, b = SERVE_N, 128, BATCH
    vecs, attrs, schema = synthetic.make_paper_dataset(n, d, seed=SEED)
    fi = FavorIndex.build(vecs, attrs, HnswParams(M=16, efc=100,
                                                  seed=SEED))
    check(fi.device.type == "cuda", "FavorIndex.build defaults to the card")
    qs = synthetic.make_queries(b, d, dataset_seed=SEED, seed=100)
    flts, names = mixed_filters(F, schema, b)
    opts = SearchOptions(k=K, ef=EF)

    fi.query(qs[:64], flts[:64], opts)          # warm-up (not counted)
    torch.cuda.synchronize()
    Kn.reset_launch_counts()
    t0 = time.perf_counter()
    res = fi.query(qs, flts, opts)
    first_s = time.perf_counter() - t0
    launches = dict(Kn.launch_counts)
    check(all(launches[k] > 0 for k in Kn.SOURCES),
          f"both kernels launched during query: {launches}")
    walls = [first_s]
    for _ in range(SERVE_REPEATS - 1):
        t0 = time.perf_counter()
        again = fi.query(qs, flts, opts)
        walls.append(time.perf_counter() - t0)
        check(bool((again.ids == res.ids).all()), "query is deterministic")

    # host work per graph wave, counted on one untimed batch
    torch_ops = count_torch_ops(lambda: fi.query(qs, flts, opts))

    # -- exact filtered ground truth: the plain brute version on the card ---
    progs = fi.compile_filters(flts)
    pv, pn, pi, pf = fi._pf
    gt_i, gt_d = ft.filtered_topk_plain(pv, pn, pi, pf,
                                        torch.as_tensor(qs, device=dev),
                                        progs, k=K)
    gt_i = gt_i.cpu().numpy()
    check(res.ids.shape == (b, K) and res.dists.shape == (b, K),
          "result shapes")
    check(bool(np.isfinite(res.dists[res.ids >= 0]).all()),
          "finite distances for every returned id")
    check(bool(((res.ids >= -1) & (res.ids < n)).all()), "ids in range")
    masks = {nm: F.eval_program(F.compile_filter(f, schema), attrs.ints,
                                attrs.floats).numpy()
             for nm, f in zip(names, flts)}
    for i in range(b):
        got = res.ids[i][res.ids[i] >= 0]
        check(bool(masks[names[i]][got].all()),
              f"query {i} returned a non-target row")
    per = {}
    names_a = np.asarray(names)
    for nm in dict.fromkeys(names):
        rows = np.nonzero(names_a == nm)[0]
        rec = [refimpl.recall_at_k(res.ids[i], gt_i[i][gt_i[i] >= 0], K)
               for i in rows]
        br = res.routed_brute[rows]
        per[nm] = {"queries": int(len(rows)),
                   "p_true": float(masks[nm].mean()),
                   "p_hat": float(res.p_hat[rows].mean()),
                   "brute": int(br.sum()), "graph": int((~br).sum()),
                   "recall_at_10": float(np.mean(rec))}
    brute = res.routed_brute
    rec_all = np.array([refimpl.recall_at_k(res.ids[i],
                                            gt_i[i][gt_i[i] >= 0], K)
                        for i in range(b)])
    check(brute.any() and (~brute).any(), "both routes ran")
    check(bool((rec_all[brute] == 1.0).all()),
          f"brute-route recall is 1.0 (got {rec_all[brute].mean()})")

    # -- the port's CPU path on a subset: same routes, same answers ---------
    cpu = FavorIndex(fi.index, fi.attrs, fi.spec, device="cpu")
    sub = np.r_[np.nonzero(brute)[0][:16], np.nonzero(~brute)[0][:48]]
    rc = cpu.query(qs[sub], [flts[i] for i in sub], opts)
    check(bool((rc.p_hat == res.p_hat[sub]).all()), "p_hat card == cpu")
    check(bool((rc.routed_brute == brute[sub]).all()), "routes card == cpu")
    bs = rc.routed_brute
    m = topk_mismatch(rc.ids[bs], rc.dists[bs], res.ids[sub][bs],
                      res.dists[sub][bs], RTOL, ATOL)
    check(m["dist_mismatch"] == 0 and m["id_mismatch"] == 0,
          f"brute route card vs cpu: {m}")
    same_graph = float((rc.ids[~bs] == res.ids[sub][~bs]).all(axis=1).mean())
    check(same_graph >= 0.9, f"graph rows identical card vs cpu: {same_graph}")

    walls_ms = sorted(1e3 * w for w in walls)
    out = {
        "phase": "serve", "n": n, "d": d, "hnsw": {"M": 16, "M0": 32,
                                                   "efc": 100},
        "build_s": fi.build_seconds, "batch": b, "k": K, "ef": EF,
        "brute": int(brute.sum()), "graph": int((~brute).sum()),
        "launches": launches,
        "batch_ms": walls_ms,
        "p50_ms": float(np.percentile(walls_ms, 50)),
        "p99_ms": float(np.percentile(walls_ms, 99)),
        "qps": b / statistics.median(walls),
        "recall_at_10": {"brute": float(rec_all[brute].mean()),
                         "graph": float(rec_all[~brute].mean())},
        "per_scenario": per,
        "waves": int(res.waves[~brute].max()),
        "torch_ops_per_wave": torch_ops / int(res.waves[~brute].max()),
        "mean_hops": float(res.hops[~brute].mean()),
        "cpu_check": {"queries": int(len(sub)),
                      "graph_identical_rows": same_graph,
                      "brute_max_abs_diff": m["max_abs_diff"]},
    }
    emit(out)
    return launches


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

    kernels = phase_kernels(dev, rates)
    launches = phase_serve(dev)
    for kname, row in kernels.items():
        row["launches"] = launches[kname]
    emit({"kernels": [{k: v for k, v in row.items() if k != "shape"}
                      for row in kernels.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
