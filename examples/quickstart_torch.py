"""Quickstart on PyTorch: build a FAVOR index and run hybrid vector+attribute
queries with the port (``repro_torch``), the counterpart of
``examples/quickstart.py``.

Construction is configured by a frozen ``BuildSpec``, each search batch by
a frozen ``SearchOptions``.  The index lives on ``--device`` (the CUDA card
by default; ``cpu`` runs the kernels' plain versions).

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --n 2000
"""
import argparse

import numpy as np

from repro_torch.core import (BuildSpec, FavorIndex, HnswParams, SearchOptions,
                              paper_filters)
from repro_torch.core import filters as F
from repro_torch.core import refimpl
from repro_torch.data import synthetic


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n", type=int, default=8000, help="DB rows")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--queries", type=int, default=64)
    args = ap.parse_args(argv)

    n, dim, nq = args.n, args.dim, args.queries
    print(f"building FAVOR index: {n} vectors x {dim} dims ...")
    vecs, attrs, schema = synthetic.make_paper_dataset(n, dim, seed=0)
    fi = FavorIndex.build(vecs, attrs,
                          spec=BuildSpec(hnsw=HnswParams(M=12, efc=60,
                                                         seed=0)),
                          device=args.device)
    print(f"  built in {fi.build_seconds:.1f}s  Delta_d={fi.delta_d:.4f} "
          f"(Eq. 5, recorded offline) on {fi.device}")

    queries = synthetic.make_queries(nq, dim)
    opts = SearchOptions(k=10, ef=96)
    recall = {}
    for name, flt in paper_filters(schema).items():
        res = fi.query(queries, flt, opts)
        mask = F.eval_program(F.compile_filter(flt, schema), attrs.ints,
                              attrs.floats).numpy()
        truth = [refimpl.bruteforce_filtered(vecs, mask, q, 10)[0]
                 for q in queries]
        rec = np.mean([refimpl.recall_at_k(res.ids[i], truth[i], 10)
                       for i in range(nq)])
        recall[name] = float(rec)
        route = "brute" if res.routed_brute.all() else (
            "graph" if not res.routed_brute.any() else "mixed")
        print(f"  {name:15s} p_hat={res.p_hat.mean():6.3f} route={route:6s} "
              f"recall@10={rec:.3f} qps={res.qps:8.1f}")

    # custom composite filter (Logic: AND of int equality and float range)
    custom = F.And(F.Equality("i0", 3), F.Range("f0", 20.0, 70.0))
    res = fi.query(queries[:8], custom, SearchOptions(k=5, ef=96))
    print("\ncustom filter results (ids):")
    print(res.ids)
    return recall


if __name__ == "__main__":
    main()
