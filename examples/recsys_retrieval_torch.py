"""FAVOR as the recsys retrieval layer on PyTorch (the retrieval_cand cell,
reduced): the counterpart of ``examples/recsys_retrieval.py`` for the port.

Scores a user vector against a candidate item corpus under attribute filters
(region/price/stock-style predicates), using:
  1. the factorized dot-scoring path (one matmul, the filter mask, a stable
     top-k),
  2. FAVOR's fused ``filtered_topk`` kernel (filter + distance + top-k) via
     the exact MIP->L2 augmentation reduction -- on the card the hand-written
     CUDA kernel, on the CPU its plain version,
  3. a FAVOR graph index over the item embeddings for sub-linear retrieval.

    PYTHONPATH=src python examples/recsys_retrieval_torch.py
    PYTHONPATH=src python examples/recsys_retrieval_torch.py --device cpu --n 4000
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import (BuildSpec, FavorIndex, HnswParams,
                              SearchOptions, compile_filter, paper_schema,
                              random_attributes, refimpl)
from repro_torch.core import filters as F
from repro_torch.core.router import compile_programs
from repro_torch.device import resolve_device
from repro_torch.models.recsys import retrieval_topk_filtered


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n", type=int, default=20000, help="candidate items")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--k", type=int, default=50)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n_items, d, k = args.n, args.dim, args.k
    rng = np.random.default_rng(0)
    items = rng.normal(size=(n_items, d)).astype(np.float32)
    schema = paper_schema()        # b0 = in_stock, i0 = category, f0 = price
    attrs = random_attributes(schema, n_items, seed=1)
    users = rng.normal(size=(4, d)).astype(np.float32)

    flt = F.And(F.Equality("b0", True),          # in stock
                F.Inclusion("i0", [2, 5, 7]),    # category in {2,5,7}
                F.Range("f0", 10.0, 80.0))       # price band
    progs = compile_programs(flt, schema, len(users), device=dev)  # W = 8
    ai = torch.as_tensor(attrs.ints, device=dev)
    af = torch.as_tensor(attrs.floats, device=dev)
    it = torch.as_tensor(items, device=dev)
    uv = torch.as_tensor(users, device=dev)

    t0 = time.perf_counter()
    ids_d, sc_d = retrieval_topk_filtered(uv, it, progs, ai, af, k=k)
    _sync(dev)
    print(f"dot-scoring path:        {time.perf_counter()-t0:.3f}s "
          f"(top score {float(sc_d[0, 0]):.3f}) on {dev}")

    before = kernels.launch_counts["filtered_topk"]
    t0 = time.perf_counter()
    ids_k, sc_k = retrieval_topk_filtered(uv, it, progs, ai, af, k=k,
                                          use_kernel=True)
    _sync(dev)
    launches = kernels.launch_counts["filtered_topk"] - before
    same = bool(torch.equal(ids_d, ids_k))
    print(f"fused filtered_topk:     {time.perf_counter()-t0:.3f}s "
          f"({launches} kernel launches"
          f"{'' if launches else ': plain version on the CPU'}; "
          f"identical ids: {same})")

    # graph path: L2 FAVOR index over L2-normalized items (cosine retrieval)
    items_n = items / np.linalg.norm(items, axis=1, keepdims=True)
    fi = FavorIndex.build(items_n, attrs,
                          spec=BuildSpec(hnsw=HnswParams(M=12, efc=60,
                                                         seed=2)),
                          device=dev)
    users_n = users / np.linalg.norm(users, axis=1, keepdims=True)
    # at p ~= 10% the result pool must reach ~k/p neighbors: ef >> 2k
    res = fi.query(users_n, flt, SearchOptions(k=k, ef=8 * k))
    # cosine ground truth under the same filter
    mask = F.eval_program(compile_filter(flt, schema), attrs.ints,
                          attrs.floats).numpy()
    overlap = []
    for i in range(len(users)):
        truth, _ = refimpl.bruteforce_filtered(items_n, mask, users_n[i], k)
        overlap.append(refimpl.recall_at_k(res.ids[i], truth, k))
    recall = float(np.mean(overlap))
    print(f"FAVOR graph retrieval:   recall@{k}={recall:.3f} "
          f"qps={res.qps:.1f} (p_hat={res.p_hat[0]:.3f}, "
          f"route={'brute' if res.routed_brute[0] else 'graph'})")
    return {"identical_ids": same, "kernel_launches": launches,
            "graph_recall": recall}


if __name__ == "__main__":
    main()
