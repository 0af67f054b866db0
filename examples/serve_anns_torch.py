"""End-to-end serving demo on PyTorch: the batched FAVOR engine under a
mixed workload, over the single-device and the sharded backend.

The counterpart of ``examples/serve_anns.py`` for the port
(``repro_torch``).  A stream of hybrid queries with heterogeneous filters
(and so heterogeneous selectivity) hits the batched engine; the
selectivity-driven selector routes each to PreFBF or the exclusion-distance
graph search.  It reports routing statistics, recall and latency
percentiles.

One unmodified ServeEngine drives either execution backend: the
single-device LocalBackend, then ShardedBackend with the DB split over
``--shards`` shards of a (1, S) mesh.  Every cell of the mesh is
``--device`` (the CUDA card by default; several shards then share it), so
the per-shard scans and traversals and the cross-shard merge all run there.

    PYTHONPATH=src python examples/serve_anns_torch.py
    PYTHONPATH=src python examples/serve_anns_torch.py --device cpu --n 2000
"""
import argparse

import numpy as np

from repro_torch.core import (BuildSpec, FavorIndex, HnswParams, LocalBackend,
                              SearchOptions, ShardedBackend, paper_filters)
from repro_torch.core import filters as F
from repro_torch.core import refimpl
from repro_torch.core.distributed import largest_divisor, make_mesh
from repro_torch.data import synthetic
from repro_torch.serving import ServeEngine


def drive(eng, workload, dim, n_requests, seed=0):
    rng = np.random.default_rng(seed)
    reqs = {}
    for i in range(n_requests):
        q = synthetic.make_queries(1, dim, seed=200 + i)[0]
        flt = workload[int(rng.integers(0, len(workload)))]
        rid = eng.submit(q, flt)
        reqs[rid] = (q, flt)
    responses = eng.run()
    return responses, reqs


def report(tag, eng, responses, reqs, vecs, attrs, schema, seed=0) -> float:
    print(f"[{tag}] done: {len(responses)} responses in "
          f"{eng.stats['batches']} batches")
    print(f"[{tag}] routing: graph={eng.stats['graph']} "
          f"brute={eng.stats['brute']}")
    pct = eng.latency_percentiles()
    print(f"[{tag}] latency ms: "
          + "  ".join(f"{k}={v:.1f}" for k, v in pct.items()))

    rng = np.random.default_rng(seed)
    sample = rng.choice(len(responses), min(32, len(responses)),
                        replace=False)
    recs = []
    for si in sample:
        r = responses[si]
        q, flt = reqs[r.rid]
        mask = F.eval_program(F.compile_filter(flt, schema), attrs.ints,
                              attrs.floats).numpy()
        truth, _ = refimpl.bruteforce_filtered(vecs, mask, q, 10)
        recs.append(refimpl.recall_at_k(r.ids[r.ids >= 0], truth, 10))
    rec = float(np.mean(recs))
    print(f"[{tag}] sampled recall@10 = {rec:.3f}")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of every mesh cell (default: the "
                         "CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--n", type=int, default=10000, help="DB rows")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--shards", type=int, default=4,
                    help="model-axis extent (rounded down to divide --n)")
    args = ap.parse_args(argv)

    n, dim = args.n, args.dim
    print(f"building index ({n} x {dim}) ...")
    vecs, attrs, schema = synthetic.make_paper_dataset(n, dim, seed=1)
    spec = BuildSpec(hnsw=HnswParams(M=12, efc=60, seed=1))
    opts = SearchOptions(k=10, ef=96)

    rng = np.random.default_rng(0)
    base = paper_filters(schema)
    workload = list(base.values()) + [
        F.And(F.Equality("i0", int(v)), F.Range("f0", lo, lo + 8.0))  # ~0.8%
        for v, lo in zip(rng.integers(0, 10, 4), rng.uniform(0, 90, 4))
    ]
    print(f"serving {args.requests} requests with {len(workload)} filter "
          "kinds ...")
    recall = {}

    # -- single-device backend -----------------------------------------------
    local = LocalBackend(FavorIndex.build(vecs, attrs, spec=spec,
                                          device=args.device))
    eng = ServeEngine(local, opts, max_batch=64)
    responses, reqs = drive(eng, workload, dim, args.requests)
    recall["local"] = report("local", eng, responses, reqs, vecs, attrs,
                             schema)

    # -- sharded backend (same engine, same options) -------------------------
    n_model = largest_divisor(n, args.shards)
    mesh = make_mesh((1, n_model), device=args.device)
    print(f"sharding DB {n_model}-way on the model axis of a mesh on "
          f"{mesh.first_device} ...")
    shard = ShardedBackend.build(vecs, attrs, mesh, spec, seed=1)
    eng = ServeEngine(shard, opts, max_batch=64)
    responses, reqs = drive(eng, workload, dim, args.requests, seed=1)
    recall["sharded"] = report(f"sharded x{n_model}", eng, responses, reqs,
                               vecs, attrs, schema, seed=1)
    return recall


if __name__ == "__main__":
    main()
