#!/usr/bin/env python3
"""Time the port's compressed brute scans and its plain dots on one CUDA
card, so that two trees of the repository can be compared in one run:

    python3 tools/time_plain_scans.py [--src DIR] [--rows N] [--label NAME]

``repro_torch`` is imported from DIR (default: this checkout's ``src``), so
the script can time an older tree unpacked beside this one.  At favor-anns'
widths (d = 128, PQ M = 32 x K = 256 with rerank 8, 1024 queries with the
paper schema's filters, k = 10) over N rows (default 1,000,000, random
normal vectors and codes from a numpy seed) it times with CUDA events:

  build_luts        the per-query PQ tables of a 1024-query batch;
  pq_prefbf_topk    the ``use_pq`` brute route: tables, ``pq_adc_topr``,
                    exact re-rank;
  sq_prefbf_topk    the SQ brute route (plain torch: dequantize, dots,
                    filter, top-R merge per 8192-row chunk, re-rank);
  filtered_topk_plain  the f32 brute kernel's plain version.

Prints one JSON line: the median ms of each, a digest of each scan's ids
(equal digests: the same answers), and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path


def cuda_ms(fn, repeats: int) -> float:
    import torch
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def digest(t) -> str:
    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent
                                         / "src"))
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_plain_scans: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import kernels as Kn
    from repro_torch.core import filters as F
    from repro_torch.core import prefbf
    from repro_torch.core.router import compile_programs
    from repro_torch.kernels.filtered_topk import ops as ft
    from repro_torch.quant import adc

    dev = torch.device("cuda")
    Kn.build_kernels()
    n, d, b, k, m, ksub, rerank = args.rows, 128, 1024, 10, 32, 256, 8
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((n, d), dtype=np.float32)
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    schema = F.paper_schema()
    attrs = F.random_attributes(schema, n, seed=1)
    pv, pn, pi, pf = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                      for a in prefbf.pad_db(vecs, norms, attrs.ints,
                                             attrs.floats, 8192))
    rows = pv.shape[0]
    pq_codes = torch.as_tensor(rng.integers(0, ksub, size=(rows, m),
                                            dtype=np.uint8), device=dev)
    sq_codes = torch.as_tensor(rng.integers(0, 256, size=(rows, d),
                                            dtype=np.uint8), device=dev)
    lo = torch.as_tensor(vecs.min(axis=0), device=dev)
    scale = torch.as_tensor((vecs.max(axis=0) - vecs.min(axis=0)) / 255.0,
                            device=dev)
    cents = torch.as_tensor(rng.standard_normal((m, ksub, d // m),
                                                dtype=np.float32), device=dev)
    del vecs
    qs = torch.as_tensor(rng.standard_normal((b, d), dtype=np.float32),
                         device=dev)
    pool = list(F.paper_filters(schema, np.random.default_rng(2)).values())
    progs = compile_programs([pool[i % len(pool)] for i in range(b)], schema,
                             b, device=dev)
    torch.cuda.synchronize()

    pq_ids, _ = adc.pq_prefbf_topk(pq_codes, pn, pi, pf, qs, progs, cents, pv,
                                   k=k, rerank=rerank)
    sq_ids, _ = adc.sq_prefbf_topk(sq_codes, lo, scale, pn, pi, pf, qs, progs,
                                   pv, k=k, rerank=rerank)
    ft_ids, _ = ft.filtered_topk_plain(pv, pn, pi, pf, qs, progs, k=k)
    rep = args.repeats
    out = {
        "label": args.label, "src": args.src, "rows": n,
        "build_luts_ms": cuda_ms(lambda: adc.build_luts(cents, qs), 4 * rep),
        "pq_prefbf_topk_ms": cuda_ms(lambda: adc.pq_prefbf_topk(
            pq_codes, pn, pi, pf, qs, progs, cents, pv, k=k, rerank=rerank),
            rep),
        "sq_prefbf_topk_ms": cuda_ms(lambda: adc.sq_prefbf_topk(
            sq_codes, lo, scale, pn, pi, pf, qs, progs, pv, k=k,
            rerank=rerank), rep),
        "filtered_topk_plain_ms": cuda_ms(lambda: ft.filtered_topk_plain(
            pv, pn, pi, pf, qs, progs, k=k), rep),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "ids_digest": {"pq": digest(pq_ids), "sq": digest(sq_ids),
                       "f32_plain": digest(ft_ids)},
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0],
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
