#!/usr/bin/env python3
"""Hold the compressed brute route of a benchmark cell to the plain reference
of its semantics (``portbench/pq_reference.py``) on one CUDA card, at the
cell's full size:

    python3 tools/pq_cell_parity.py [--workload CELL] [--seed N]
        [--batches B] [--sample S] [--out PATH]

The cell's rows, attributes, query pool and filters are made as
``portbench/harness.py`` makes them (the configuration's ``data_seed``,
the run's ``--seed``); the port's index is loaded through
``portbench/program.make_index`` -- the codebook trained and the rows
encoded on the card -- over a graph with no edges, since the brute route
reads none.  ``B`` pool batches then go through ``Runner.dispatch`` /
``Runner.finish``, the timed path's calls, with the ``pq_adc_topr`` scan's
candidate lists kept.  The reference then encodes every row with the
port's centroids and, for ``S`` queries of each batch (drawn as the
harness draws its sample), builds its tables, scans, and re-ranks, in
blocks of queries on the card.  Compared: every row's code, and each
sampled query's candidate list (ids and ADC distances) and answer (ids and
exact distances), under the bounds of ``pq_reference``'s note.

Also reports the parts of the index's set-up (codebook training, encoding,
the whole load), the warm-up batch (the first build of the PQ kernels),
and the scan's time per batch (CUDA events around ``pq_adc_topr``).
Prints one JSON line; ``--out`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

BLOCK = 64          # queries per block of the reference's scan


def _timed(fn, log, key):
    """``fn`` with its synchronised wall time added to ``log[key]``."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        log[key] = log.get(key, 0.0) + time.perf_counter() - t
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="favor-anns-pq.lowsel.b1024")
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--sample", type=int, default=256)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this tool runs on the card", file=sys.stderr)
        return 2
    from portbench import data, harness, pq_reference as P, program, reference
    from repro_torch import quant
    from repro_torch.kernels.pq_adc import ops as pq_ops

    dev = torch.device("cuda", 0)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, cfg, trf = harness.find_cell(bench, args.workload, ROOT)
    if not cfg["search"].get("use_pq"):
        raise SystemExit(f"{args.workload}: its brute route is not compressed")
    parts = {}
    base = data.make_base(cfg, cfg["data_seed"], dev)
    pool_q, pool_specs, _ = harness.make_pool(cfg, trf, base, args.seed, dev)
    cols = harness.columns(cfg, base)
    n, m0 = cfg["n"], cfg["hnsw"]["M0"]
    no_edges = {"levels": [np.full((n, m0), -1, np.int32)],
                "node_level": np.zeros(n, np.int16), "entry_point": 0,
                "max_level": 0, "delta_d": 1.0}
    train, encode = quant.train_pq, quant.encode
    quant.train_pq = _timed(train, parts, "train_pq_s")
    quant.encode = _timed(encode, parts, "encode_s")
    try:
        fi = _timed(program.make_index, parts, "index_s")(
            cfg, base, no_edges, cfg["data_seed"], dev)
    finally:
        quant.train_pq, quant.encode = train, encode
    runner = program.Runner(fi, cfg)
    filters = [[program.to_filter(s) for s in specs] for specs in pool_specs]

    scans = []
    scan = pq_ops.pq_adc_topr

    def kept(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = scan(*a, **kw)
        ev[1].record()
        scans.append((out, ev))
        return out
    pq_ops.pq_adc_topr = kept
    try:
        _timed(lambda: runner.finish(runner.dispatch(pool_q[0], filters[0])),
               parts, "warmup_s")()
        scans.clear()
        outs = []
        for p in range(args.batches):
            out = runner.finish(runner.dispatch(pool_q[p], filters[p]))
            assert out["routed_brute"].all(), "a query took the graph route"
            outs.append(out)
    finally:
        pq_ops.pq_adc_topr = scan
    torch.cuda.synchronize()
    scan_ms = [ev[0].elapsed_time(ev[1]) for _, ev in scans]
    assert len(scans) == args.batches

    # -- the reference ------------------------------------------------------------
    cents = torch.as_tensor(fi.codebook.centroids, device=dev)
    got_codes = fi._codes[:n]
    del runner, fi
    torch.cuda.empty_cache()
    vec = base["vectors"]
    t = time.perf_counter()
    codes = P.encode(vec, cents)
    code_cmp = P.compare_codes(vec, cents, got_codes, codes)
    parts["reference_encode_s"] = time.perf_counter() - t
    del got_codes
    k, q = cfg["search"]["k"], cfg["quant"]
    r = max(k, q["rerank"] * k)
    totals, checked, passing = {}, 0, []
    t = time.perf_counter()
    for p, (out, ((cand_i, cand_d), _)) in enumerate(zip(outs, scans)):
        pos = harness.sample_positions(args.seed, p, trf["batch"],
                                       args.sample)
        for s in range(0, len(pos), BLOCK):
            sel = pos[s:s + BLOCK]
            qs = pool_q[p][torch.as_tensor(sel, device=dev)]
            mask = torch.stack([reference.eval_spec(pool_specs[p][i], cols)
                                for i in sel])
            passing += mask.sum(1).tolist()
            ref = P.search(vec, codes, cents, qs, mask, k, r)
            idx = torch.as_tensor(sel, device=dev)
            got = {"cand_i": cand_i[idx], "cand_d": cand_d[idx],
                   "ids": torch.as_tensor(out["ids"][sel]),
                   "dists": torch.as_tensor(out["dists"][sel])}
            cmp = P.compare_answers(vec, cents, codes, qs, mask, ref, got, k,
                                    tie_rows=code_cmp["tie_rows"])
            for key, v in cmp.items():
                totals[key] = (max(totals.get(key, 0.0), v)
                               if key == "ans_max_rel" else
                               totals.get(key, 0) + v)
            checked += len(sel)
    parts["reference_search_s"] = time.perf_counter() - t
    line = {"workload": args.workload, "seed": args.seed, "card": harness.card_line(),
            "torch": torch.__version__, "batches": args.batches,
            "checked": checked,
            "codes": {"rows": n, "differ": code_cmp["differ"],
                      "mismatch": code_cmp["mismatch"],
                      "tie_rows": int(len(code_cmp["tie_rows"]))},
            "answers": totals,
            "breaches": P.breaches({**totals,
                                    "mismatch": code_cmp["mismatch"]}),
            "passing": {"min": int(min(passing)), "max": int(max(passing)),
                        "mean": float(np.mean(passing))},
            "scan_ms": scan_ms, "setup": parts}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0 if line["breaches"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
