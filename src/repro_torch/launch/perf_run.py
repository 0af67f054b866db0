"""Run the perf variants (``perf.py``) through the port's dry run and
append each record to perf_results.json.

    PYTHONPATH=src python -m repro_torch.launch.perf_run [--exp NAME|all]
        [--out perf_results.json] [--multi] [--device cuda|cpu] [--seed 0]

The experiments and their hypotheses are the JAX package's, copied
unchanged: the hypotheses were written about TPU dry runs, and no number
in them is the H100's.  Each variant is counted partitioned on the
production mesh, so the collective term the olmoe and gcn hypotheses are
about is read from the port's own count (``roofline.t_collective_s``,
``roofline.collectives``).  The three favor-anns ``serve_graph``
experiments count one mesh cell's block on real tensors, on ``--device``
(the card unless ``cpu`` is given).
"""
import argparse
import json
import os
import time

from repro_torch.launch import dryrun as D
from repro_torch.launch import perf as P


EXPERIMENTS = {
    # --- hillclimb 1: gemma2-2b train_4k (worst meaningful roofline frac) ---
    "gemma_chunked": dict(
        arch="gemma2-2b", shape="train_4k",
        mk=lambda: P.lm_variant("gemma2-2b", "train_4k", attn_chunk=512),
        hypothesis="flash-style chunked attention removes the O(S^2) f32 "
                   "score tensors: memory term (dominant) drops; flops ~same"),
    "gemma_chunked_mb8": dict(
        arch="gemma2-2b", shape="train_4k",
        mk=lambda: P.lm_variant("gemma2-2b", "train_4k", attn_chunk=512,
                                microbatches=8),
        hypothesis="8x microbatch accumulation cuts live activation memory "
                   "~8x (memory_analysis temp bytes), roofline terms ~flat"),
    "gemma_prefill_chunked": dict(
        arch="gemma2-2b", shape="prefill_32k",
        mk=lambda: P.lm_variant("gemma2-2b", "prefill_32k", attn_chunk=2048),
        hypothesis="train_4k refuted the chunked-attention memory win (scores "
                   "were minor there); at S=32k the (2,4,2,32k,32k) f32 score "
                   "tensors ARE the temp memory (34GB/layer): chunking should "
                   "collapse temp bytes and the HLO memory term"),
    "olmoe_cf10": dict(
        arch="olmoe-1b-7b", shape="train_4k",
        mk=lambda: P.lm_variant("olmoe-1b-7b", "train_4k",
                                capacity_factor=1.0),
        hypothesis="(post-parser-fix: olmoe train is the most collective-"
                   "bound LM cell, tx=13.2s from dispatch all-gathers). "
                   "Capacity 1.25->1.0 shrinks the (E,C,d) expert buffers "
                   "and GEMMs 20%: tc/tm down ~10-20%; tx ~flat (the token "
                   "all-gather is capacity-independent) -- confirming the "
                   "a2a dispatch rewrite, not capacity, is the tx lever"),
    # --- hillclimb 2: gcn ogb_products (most collective-bound) --------------
    "gcn_bf16": dict(
        arch="gcn-cora", shape="ogb_products",
        mk=lambda: P.gnn_variant("gcn-cora", "ogb_products", bf16_msgs=True),
        hypothesis="bf16 message features halve the edge-psum all-reduce "
                   "bytes: collective term (dominant) ~2x down"),
    "gcn_bf16_prune": dict(
        arch="gcn-cora", shape="ogb_products",
        mk=lambda: P.gnn_variant("gcn-cora", "ogb_products", bf16_msgs=True,
                                 label_prune=0.08),
        hypothesis="final conv aggregates only edges into the ~8% labeled "
                   "nodes: the widest (n x 47) all-reduce shrinks ~12x; "
                   "combined with bf16 expect >4x total collective win"),
    # --- hillclimb 3: favor-anns serve_graph (paper's own technique) --------
    "favor_sample4k": dict(
        arch="favor-anns", shape="serve_graph",
        mk=lambda: P.favor_variant("favor-anns", "serve_graph",
                                   sample_rate=0.001),
        hypothesis="selectivity sample 1% -> 0.1% of shard rows (global n "
                    "~64k, rel-err ~4% at p=1%, Eq. 1): the batched "
                    "filter-program eval over the sample shrinks 10x; if the "
                    "memory term drops materially, estimation was the hog"),
    "favor_ccap256": dict(
        arch="favor-anns", shape="serve_graph",
        mk=lambda: P.favor_variant("favor-anns", "serve_graph",
                                   sample_rate=0.001, cand_cap=256),
        hypothesis="wider candidate pool (256 vs ef=128) raises per-step "
                   "merge traffic but should be minor vs visited/sample"),
    # diagnostic: if tm scales with the DB shard size, the memory term is an
    # HloCostAnalysis artifact (gathers charged the FULL operand) rather than
    # real per-step traffic
    "favor_n16m": dict(
        arch="favor-anns", shape="serve_graph",
        mk=lambda: P.favor_variant("favor-anns", "serve_graph", n=16_000_000),
        hypothesis="shrink the DB 4x: if t_memory drops ~4x the term is "
                   "dominated by whole-DB-array charges on gathers (cost-"
                   "model artifact), not by batch/step-proportional traffic"),
    "gcn_bf16_v2": dict(
        arch="gcn-cora", shape="ogb_products",
        mk=lambda: P.gnn_variant("gcn-cora", "ogb_products", bf16_msgs=True,
                                 bf16_end2end=True, label_prune=0.08),
        hypothesis="v1 refuted: the f32 convert sat between scatter and "
                   "all-reduce so XLA hoisted it. Keep hidden features bf16 "
                   "through relu/matmul so the collective must carry bf16: "
                   "expect ~2x on the remaining collective bytes"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default=None, help="experiment name or 'all'")
    ap.add_argument("--out", default="perf_results.json")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where a cell counted on real tensors runs "
                         "(default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    todo = ([args.exp] if args.exp and args.exp != "all" else list(EXPERIMENTS))
    for name in todo:
        e = EXPERIMENTS[name]
        if any(r["exp"] == name for r in results):
            print(f"[skip-done] {name}")
            continue
        print(f"[perf] {name}: {e['hypothesis'][:70]} ...", flush=True)
        t0 = time.perf_counter()
        rec = D.run_cell(e["arch"], e["shape"], args.multi,
                         builder=e["mk"](), device=args.device,
                         seed=args.seed)
        rec["exp"] = name
        rec["hypothesis"] = e["hypothesis"]
        rec["wall_s"] = time.perf_counter() - t0
        if rec["ok"]:
            r = rec["roofline"]
            print(f"   ok tc={r['t_compute_s']:.4f} tm={r['t_memory_s']:.4f} "
                  f"tx={r['t_collective_s']:.4f} bottleneck={r['bottleneck']} "
                  f"args={rec['memory']['argument_size_in_bytes']/2**30:.1f}GiB",
                  flush=True)
        else:
            print(f"   FAIL {rec['error']}", flush=True)
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
